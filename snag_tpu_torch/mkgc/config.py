"""MKGC configuration: port of ``snag_tpu/mkgc/config.py``.

CLI contract (reference SNAG_MKGC/readme.md:13-14):
  run_base.sh GPU DATA num_proj use_intermediate joint_way noise_ratio
              mask_ratio noise_level num_hidden_layers num_attention_heads EXP_ID
Defaults (readme.md:38-48): EMB_DIM=128, NUM_BATCH=1024, MARGIN=12,
LR=LRG=1e-4, NEG_NUM=32, EPOCH=8000 (early stop), NOISE=1, POOL=1.

The port adds ``--device`` (a ``torch.device`` string, default ``cuda``;
asked for a card that torch cannot see, the runner raises).
``--mesh_shape data:N`` trains and evaluates on N ranks, one process a
GPU (``parallel/mesh.py``, ``cli/train_mkgc.py``);
``--compile_cache_dir`` is the JAX package's XLA cache, accepted and
unused.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

JOINT_WAYS = ["Mformer_hd_mean", "Mformer_hd_graph", "Mformer_weight",
              "atten_weight", "learnable_weight"]


@dataclass
class MKGCConfig:
    gpu: int = 0
    data_choice: str = "DB15K"
    data_path: str = "mkgc_data"
    exp_id: str = "K001"
    random_seed: int = 3407

    num_proj: int = 1                  # 1 shared / 2 per-purpose projections
    use_intermediate: int = 0
    joint_way: str = "Mformer_hd_mean"
    noise_ratio: float = 0.2
    mask_ratio: float = 0.7
    noise_update: str = "epoch"        # epoch | step  (noise_level)
    num_hidden_layers: int = 1
    num_attention_heads: int = 2

    emb_dim: int = 128
    num_batch: int = 1024              # batches per epoch (OpenKE-style)
    margin: float = 12.0
    lr: float = 1e-4                   # main model group
    lrg: float = 1e-4                  # fusion/generator group (LRG)
    neg_num: int = 32
    epoch: int = 8000
    add_noise: int = 1
    use_pool: int = 1
    pool_dim: int = 256                # pooled feature width when use_pool
    triple_order: str = "hrt"          # column order in triple files: hrt | htr (OpenKE)
    mesh_shape: str = ""               # "data:N": N ranks; empty = one

    intermediate_size: int = 512
    eval_epoch: int = 50
    early_stop_patience: int = 10      # non-improving evals before stop
    valid_max: int = 2000              # cap valid triples used for early stop
    log_every: int = 25

    checkpoint_every: int = 0          # save full train-state every N epochs
    checkpoint_dir: str = ""           # default <data_path>/<data_choice>/ckpt
    resume_from: str = ""              # checkpoint path to resume from
    only_test: int = 0                 # skip training; evaluate test only
    save_model: int = 0                # save best params at end of run
    # random-filled feature tables only when explicitly requested: a
    # typo'd data_path must fail loudly, not train on noise
    allow_missing_features: int = 0
    compile_cache_dir: str = ""        # JAX package only; unused here
    device: str = "cuda"               # torch device of the run

    # synthetic dataset knobs
    synth_ents: int = 200
    synth_rels: int = 16
    synth_triples: int = 1500
    synth_vis_dim: int = 64
    synth_txt_dim: int = 48


def build_mkgc_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("snag_tpu_torch MKGC trainer")
    d = MKGCConfig()
    helps = {"device": "torch device (default: cuda), e.g. cuda:1 or cpu",
             "compile_cache_dir": "JAX package only: persistent XLA compile "
                                  "cache; unused by the port",
             "mesh_shape": "data:N trains on N ranks, one process a GPU "
                           "(NCCL; gloo with --device cpu)"}
    for f in dataclasses.fields(MKGCConfig):
        kind = {"int": int, "float": float}.get(f.type, str)
        p.add_argument(f"--{f.name}", type=kind, default=getattr(d, f.name),
                       help=helps.get(f.name))
    return p


def mkgc_config_from_args(args: argparse.Namespace) -> MKGCConfig:
    known = {f.name for f in dataclasses.fields(MKGCConfig)}
    return MKGCConfig(**{k: v for k, v in vars(args).items() if k in known})
