"""Experiment harness: logger + dump-dir layout.

Port of ``snag_tpu/utils/logging.py`` (reference SNAG_MMEA/torchlight/logger.py:
elapsed-time formatter :17-42, exp initialisation + params dump :71-109,
dump path layout ``dump/<MMDD-exp_name>/<exp_id>/`` :111-139).  In a
process group (``--mesh_shape data:N``, JAX logging.py:45-73) rank 0 logs
as a single process does; another rank r logs to ``<file>.rank<r>`` and
puts only warnings on stderr, and only rank 0 writes ``params.json``.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import random
import string
import sys
import time
from datetime import datetime, timedelta


class ElapsedFormatter(logging.Formatter):
    """Prefix every record with wall time and time elapsed since start."""

    def __init__(self):
        super().__init__()
        self.start_time = time.time()

    def format(self, record):
        elapsed = timedelta(seconds=round(record.created - self.start_time))
        header = "%s - %s" % (time.strftime("%x %X"), elapsed)
        msg = record.getMessage().replace("\n", "\n" + " " * (len(header) + 3))
        return f"{header} - {msg}"


def process_rank() -> int:
    """This process's rank in its group, 0 outside one."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def create_logger(filepath: str | None = None,
                  name: str = "snag_tpu_torch") -> logging.Logger:
    """Console + optional file logger (torchlight/logger.py:24-58); rank
    r > 0 of a group logs to ``<filepath>.rank<r>`` and warnings to
    stderr."""
    rank = process_rank()
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = ElapsedFormatter()
    sh = logging.StreamHandler(sys.stdout if rank == 0 else sys.stderr)
    sh.setFormatter(fmt)
    if rank:
        sh.setLevel(logging.WARNING)
        filepath = filepath and f"{filepath}.rank{rank}"
    logger.addHandler(sh)
    if filepath:
        fh = logging.FileHandler(filepath, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_dump_path(cfg) -> str:
    """``<dump_path>/<MMDD-exp_name>/<exp_id>/`` (torchlight/logger.py:111-139)."""
    if not cfg.exp_name:
        raise ValueError("experiment name must be specified")
    sweep_dir = osp.join(cfg.dump_path,
                         f"{datetime.now().strftime('%m%d')}-{cfg.exp_name}")
    os.makedirs(sweep_dir, exist_ok=True)

    exp_id = cfg.exp_id
    if not exp_id:
        chars = string.ascii_lowercase + string.digits
        while True:
            exp_id = "".join(random.choice(chars) for _ in range(10))
            if not osp.isdir(osp.join(sweep_dir, exp_id)):
                break
    path = osp.join(sweep_dir, exp_id)
    os.makedirs(path, exist_ok=True)
    return path


def initialize_exp(cfg, logger_name: str = "snag_tpu_torch") -> logging.Logger:
    """Create dump dir, dump params JSON, reconstruct the launch command."""
    dump = get_dump_path(cfg)
    if process_rank() == 0:
        with open(osp.join(dump, "params.json"), "w") as f:
            json.dump({k: v for k, v in vars(cfg).items()
                       if not k.startswith("_")}, f, indent=2, default=str)
    logger = create_logger(osp.join(dump, "train.log"), name=logger_name)
    logger.info("============ Initialized logger ============")
    logger.info("\n".join(f"{k}: {v}" for k, v in sorted(vars(cfg).items())))
    logger.info(f"The experiment will be stored in {dump}\n")
    logger.info("Running command: %s" % " ".join(sys.argv))
    return logger
