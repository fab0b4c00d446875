"""MKGC entry point (reference CLI: SNAG_MKGC/readme.md:13-14).

    python -m snag_tpu_torch.cli.train_mkgc --data_choice DB15K --num_proj 2 \
        --joint_way Mformer_hd_graph --noise_ratio 0.2 --mask_ratio 0.7 \
        --noise_update epoch --num_hidden_layers 1 --num_attention_heads 2 \
        [--device cuda|cpu] [--mesh_shape data:N]

trains with early stopping on valid MRR and ends with a filtered test from
the best params; ``--only_test 1`` evaluates the ``--save_model``
snapshot of ``--exp_id`` instead.  The flags are those of
``scripts/run_base.sh``.  ``--mesh_shape data:N`` launches as
``cli.train_mmea`` does (``parallel.mesh.enter``).
"""

from __future__ import annotations

import sys
from typing import Optional

from snag_tpu_torch.mkgc.config import (build_mkgc_argparser,
                                        mkgc_config_from_args)
from snag_tpu_torch.mkgc.train import MKGCRunner
from snag_tpu_torch.parallel import mesh as mesh_mod
from snag_tpu_torch.utils.logging import create_logger
from snag_tpu_torch.utils.seed import set_seed


def main(argv=None) -> Optional[MKGCRunner]:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = mkgc_config_from_args(build_mkgc_argparser().parse_args(argv))
    run_here, own_group = mesh_mod.enter(
        mesh_mod.parse_mesh_shape(cfg.mesh_shape), cfg.device, main, argv)
    if not run_here:
        return None
    try:
        set_seed(cfg.random_seed)
        logger = create_logger(name="snag_tpu_torch.mkgc")
        runner = MKGCRunner(cfg, logger)
        metrics = runner.run()
        logger.info(f"final: {metrics}")
        return runner
    finally:
        mesh_mod.leave(own_group)


if __name__ == "__main__":
    main()
