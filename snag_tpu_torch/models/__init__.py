import torch


def build_model(cfg, data, generator: torch.Generator):
    """Model dispatch (reference: SNAG_MMEA/main.py:58-75)."""
    if cfg.model_name == "MSNEA":
        raise NotImplementedError(
            "--model_name MSNEA (its own data path, TransE loss and "
            "device-side triple sampling) is not ported yet: ROADMAP A: MSNEA")
    from snag_tpu_torch.models import eva, mclea, meaformer, snag
    cls = {"SNAG": snag.SNAG, "MEAformer": meaformer.MEAformer,
           "MCLEA": mclea.MCLEA, "EVA": eva.EVA}[cfg.model_name]
    return cls.from_data(cfg, data, generator)
