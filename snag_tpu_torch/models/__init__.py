import torch


def build_model(cfg, data, generator: torch.Generator):
    """Model dispatch (reference: SNAG_MMEA/main.py:58-75); SNAG only so far."""
    if cfg.model_name != "SNAG":
        raise NotImplementedError(f"--model_name {cfg.model_name} is not ported yet")
    from snag_tpu_torch.models.snag import SNAG
    return SNAG.from_data(cfg, data, generator)
