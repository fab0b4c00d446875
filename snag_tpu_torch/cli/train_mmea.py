"""MMEA entry point (reference: SNAG_MMEA/main.py:502-529).

    python -m snag_tpu_torch.cli.train_mmea --model_name SNAG \
        --data_choice SYNTH --il ... [--device cuda|cpu] [--mesh_shape data:N]

trains SNAG (two stages, iterative learning, eval every --eval_epoch) and
ends with a full-rank test from the best weights and the top-3 retrieval
CSV.  With ``--only_test 1 [--model_name_save ckpt.pkl]`` it only embeds
every entity, runs the full-rank (CSLS) evaluation both ways, logs
Hits@1/10/50, MR and MRR, and writes the CSV.

``--mesh_shape data:N`` (``parallel.mesh.enter``): under torchrun or
SLURM each process joins the group as its rank (N must equal
``WORLD_SIZE``); started plainly, the command spawns N ranks (rank r on
``cuda:r`` over NCCL, or on the CPU over gloo with ``--device cpu``),
returns None and leaves the results to rank 0; ``data:1`` runs here in a
group of one.
"""

from __future__ import annotations

import sys
from typing import Optional

from snag_tpu_torch.config import (build_argparser, config_from_args,
                                   finalize_config)
from snag_tpu_torch.parallel import mesh as mesh_mod
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.utils.logging import initialize_exp
from snag_tpu_torch.utils.seed import set_seed


def main(argv=None) -> Optional[Runner]:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    cfg = finalize_config(config_from_args(args))
    run_here, own_group = mesh_mod.enter(
        mesh_mod.parse_mesh_shape(cfg.mesh_shape), cfg.device, main, argv)
    if not run_here:
        return None
    try:
        set_seed(cfg.random_seed)
        logger = initialize_exp(cfg)

        runner = Runner(cfg, logger)
        if cfg.model_name_save:
            runner.load_model(cfg.model_name_save)
        if cfg.only_test:
            runner.evaluate(last_epoch=True,
                            save_name=f"{cfg.exp_id}_only_test")
        else:
            runner.run()
        logger.info("done!")
        return runner
    finally:
        mesh_mod.leave(own_group)


if __name__ == "__main__":
    main()
