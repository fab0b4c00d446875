"""Scalar metrics sink, the tensorboard-writer role of the reference
(SNAG_MMEA/main.py:283, 304-328 writes lr, per-term losses, modality
weights).

Port of ``snag_tpu/utils/metrics_writer.py``: one JSONL record per call,
which tensorboard or pandas can ingest; mirrored to tensorboard when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = osp.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:     # tensorboard is optional
            return
        self._tb = SummaryWriter(log_dir=osp.join(log_dir, "tensorboard"))

    def scalars(self, tag: str, values: Dict[str, float], step: int):
        rec = {"tag": tag, "step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in values.items()},
                                 int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
