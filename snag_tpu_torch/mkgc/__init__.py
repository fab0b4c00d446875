"""MKGC, multi-modal knowledge graph completion: port of ``snag_tpu/mkgc``."""

from snag_tpu_torch.mkgc.config import MKGCConfig, build_mkgc_argparser  # noqa: F401
from snag_tpu_torch.mkgc.data import MKGCData, load_mkgc_data  # noqa: F401
from snag_tpu_torch.mkgc.model import MKGCModel  # noqa: F401
