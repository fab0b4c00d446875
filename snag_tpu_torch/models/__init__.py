import torch


def build_model(cfg, data, generator: torch.Generator):
    """Model dispatch (reference: SNAG_MMEA/main.py:58-75)."""
    from snag_tpu_torch.models import eva, mclea, meaformer, msnea, snag
    cls = {"SNAG": snag.SNAG, "MEAformer": meaformer.MEAformer,
           "MCLEA": mclea.MCLEA, "EVA": eva.EVA,
           "MSNEA": msnea.MSNEA}[cfg.model_name]
    return cls.from_data(cfg, data, generator)
