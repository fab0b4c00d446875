"""Configuration system (PyTorch port of ``snag_tpu/config.py``).

Flag names, defaults, choices, and the derived-config rules mirror the
reference CLI contract (reference: SNAG_MMEA/config.py:16-141 for the flags,
:143-218 for the derivation pass and the ``--enable_sota`` preset ladder) so
that `run_snag.sh`-style invocations port 1:1.  The implementation is a plain
dataclass — a single typed source of truth consumed by data, model, train and
eval layers.  The port adds ``--device`` (a ``torch.device`` string; the
runner passes it down to every module).
"""

from __future__ import annotations

import argparse
import dataclasses
import os.path as osp
from dataclasses import dataclass
from typing import List, Optional

DATA_CHOICES = [
    "DBP15K", "DWY", "FBYG15K", "FBDB15K",
    "OEA_EN_FR_15K_V1", "OEA_EN_FR_15K_V2", "OEA_D_W_15K_V2",
    "OEA_EN_DE_15K_V1", "OEA_EN_DE_15K_V2", "OEA_D_W_15K_V1",
    "OEA_EN_FR_100K_V2", "OEA_EN_FR_100K_V1", "OEA_D_W_100K_V2",
    "OEA_D_W_100K_V1",
    # synthetic KG for tests / smoke runs (framework addition)
    "SYNTH",
]
MODEL_CHOICES = ["EVA", "MCLEA", "MSNEA", "MEAformer", "SNAG"]
SPLIT_CHOICES = ["dbp_wd_15k_V2", "dbp_wd_15k_V1", "zh_en", "ja_en", "fr_en", "norm"]

# Fixed modality order used across the framework.  The fusion input order
# matches the reference's ``[img, att, rel, gph, name, char]``
# (SNAG_MMEA/model/SNAG_tools.py:154); per-modality losses are logged in this
# order too.
MODALITIES = ("img", "att", "rel", "gph", "name", "char")


@dataclass
class Config:
    # ---- base (config.py:19-24) ----
    gpu: int = 0
    batch_size: int = 128
    epoch: int = 100
    save_model: int = 0
    only_test: int = 0
    enable_sota: bool = False

    # ---- experiment harness (config.py:27-32) ----
    no_tensorboard: bool = False
    exp_name: str = "EA_exp"
    dump_path: str = "dump/"
    # the JAX package's persistent XLA compilation cache; the port compiles
    # nothing through XLA and keeps the flag so both CLIs take the same flags
    compile_cache_dir: str = "/tmp/snag_tpu_compile_cache"
    exp_id: str = "001"
    random_seed: int = 42
    data_path: str = "mmkg"

    # ---- EA (config.py:35-56) ----
    data_choice: str = "DBP15K"
    data_rate: float = 0.3
    model_name: str = "EVA"
    model_name_save: str = ""
    workers: int = 8
    accumulation_steps: int = 1
    scheduler: str = "linear"  # linear | cos | fixed
    optim: str = "adamw"
    lr: float = 3e-5
    weight_decay: float = 1e-4
    adam_epsilon: float = 1e-8
    eval_epoch: int = 100
    margin: float = 1.0
    emb_dim: int = 1000
    adv_temp: float = 1.0
    contrastive_loss: int = 0
    clip: float = 1.0

    # ---- EVA (config.py:59-71) ----
    data_split: str = "fr_en"
    hidden_units: str = "128,128,128"
    dropout: float = 0.0
    attn_dropout: float = 0.0
    distance: int = 2
    csls: bool = False
    csls_k: int = 10
    il: bool = False
    semi_learn_step: int = 10
    il_start: int = 500
    unsup: bool = False
    unsup_k: int = 1000

    # ---- MCLEA (config.py:73-103) ----
    unsup_mode: str = "img"
    tau: float = 0.1
    tau2: float = 1.0
    alpha: float = 0.2
    with_weight: int = 1
    structure_encoder: str = "gat"  # gat | gcn
    ab_weight: float = 0.5
    projection: bool = False
    heads: str = "2,2"
    instance_normalization: bool = False
    attr_dim: int = 100
    img_dim: int = 100
    name_dim: int = 100
    char_dim: int = 100
    w_gcn: bool = True
    w_rel: bool = True
    w_attr: bool = True
    w_name: bool = True
    w_char: bool = True
    w_img: bool = True
    use_surface: int = 0
    inner_view_num: int = 6
    word_embedding: str = "glove"
    use_project_head: bool = False
    zoom: float = 0.1
    reduction: str = "mean"

    # ---- MEAformer (config.py:106-120) ----
    hidden_size: int = 100
    intermediate_size: int = 400
    num_attention_heads: int = 5
    num_hidden_layers: int = 2
    position_embedding_type: str = "absolute"
    use_intermediate: int = 1
    replay: int = 0
    neg_cross_kg: int = 0
    awloss: int = 0
    stage: int = 1
    ablation: int = -1
    adapt: str = "mlp"
    ratio: str = "1.0"
    stage_epoch: str = "250,0,0"

    # ---- noise (config.py:123-125) ----
    add_noise: int = 0
    noise_ratio: float = 0.1
    mask_ratio: float = 0.1

    il_stage_epoch: str = ""

    # ---- MSNEA (config.py:129-134) ----
    dim: int = 100
    neg_triple_num: int = 1
    # use_bert / use_attr_value are parsed-but-dead in the reference too:
    # declared at reference config.py:132,134 and read by NOTHING in the
    # repo (verified by exhaustive grep) — kept for CLI contract parity.
    use_bert: int = 0
    use_attr_value: int = 0

    # ---- framework additions (no reference equivalent) ----
    device: str = "cuda"             # torch device the runner places work on
    dtype: str = "float32"           # compute dtype for the encoder
    mesh_shape: str = ""             # "data:N": N ranks, one a GPU; "" = one
    jit_backend: Optional[str] = None
    profile_dir: str = ""            # torch.profiler trace output, "" = off
    log_every: int = 50
    remat: int = 0                   # rematerialize GNN activations (memory)
    # encode only the batch's entity rows in the train step (the graph
    # encoder still runs full-graph; projections/fusion/losses run at
    # (2B,...) instead of (N,...)) — gradient-identical to full encoding
    batch_encode: int = 1
    # SNAG: compute GMI's two joint ICLs from the shared per-modality
    # similarity blocks instead of explicit (B, M*d) joint embeddings
    # (losses/contrastive.snag_bundle_losses) — mathematically identical
    fused_snag_loss: int = 1
    checkpoint_every: int = 0        # save full train-state every N epochs
    resume_from: str = ""            # checkpoint path to resume
    # synthetic-dataset knobs (data_choice == SYNTH)
    synth_ents: int = 200
    synth_rels: int = 20
    synth_triples: int = 800
    synth_img_dim: int = 64

    # derived (filled by finalize_config)
    data_root: str = ""
    max_position_embeddings: int = 7
    total_steps: int = 0
    warmup_steps: int = 0
    modal_num: int = 6

    def n_units(self) -> List[int]:
        return [int(x) for x in self.hidden_units.strip().split(",")]

    def n_heads(self) -> List[int]:
        return [int(x) for x in self.heads.strip().split(",")]

    @property
    def joint_dim(self) -> int:
        """Width of the concatenated joint embedding (modal_num * hidden)."""
        return self.modal_num * self.hidden_size

    def active_modalities(self) -> List[str]:
        flags = {
            "img": self.w_img, "att": self.w_attr, "rel": self.w_rel,
            "gph": self.w_gcn, "name": self.w_name, "char": self.w_char,
        }
        return [m for m in MODALITIES if flags[m]]


def build_argparser() -> argparse.ArgumentParser:
    """Argparse mirror of the reference CLI (SNAG_MMEA/config.py:16-141)."""
    p = argparse.ArgumentParser("snag_tpu_torch MMEA trainer")
    d = Config()

    p.add_argument("--gpu", default=d.gpu, type=int)
    p.add_argument("--batch_size", default=d.batch_size, type=int)
    p.add_argument("--epoch", default=d.epoch, type=int)
    p.add_argument("--save_model", default=d.save_model, type=int, choices=[0, 1])
    p.add_argument("--only_test", default=d.only_test, type=int, choices=[0, 1])
    p.add_argument("--enable_sota", action="store_true", default=False)

    p.add_argument("--no_tensorboard", default=False, action="store_true")
    p.add_argument("--exp_name", default=d.exp_name, type=str)
    p.add_argument("--dump_path", default=d.dump_path, type=str)
    p.add_argument("--compile_cache_dir", default=d.compile_cache_dir,
                   type=str, help="JAX package only: persistent XLA compile "
                   "cache; unused by the port")
    p.add_argument("--exp_id", default=d.exp_id, type=str)
    p.add_argument("--random_seed", default=d.random_seed, type=int)
    p.add_argument("--data_path", default=d.data_path, type=str)

    p.add_argument("--data_choice", default=d.data_choice, type=str, choices=DATA_CHOICES)
    p.add_argument("--data_rate", type=float, default=d.data_rate)
    p.add_argument("--model_name", default=d.model_name, type=str, choices=MODEL_CHOICES)
    p.add_argument("--model_name_save", default="", type=str)
    p.add_argument("--workers", type=int, default=d.workers)
    p.add_argument("--accumulation_steps", type=int, default=d.accumulation_steps)
    p.add_argument("--scheduler", default=d.scheduler, type=str, choices=["linear", "cos", "fixed"])
    p.add_argument("--optim", default=d.optim, type=str, choices=["adamw", "adam"])
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--adam_epsilon", default=d.adam_epsilon, type=float)
    p.add_argument("--eval_epoch", default=d.eval_epoch, type=int)
    p.add_argument("--margin", default=d.margin, type=float)
    p.add_argument("--emb_dim", default=d.emb_dim, type=int)
    p.add_argument("--adv_temp", default=d.adv_temp, type=float)
    p.add_argument("--contrastive_loss", default=d.contrastive_loss, type=int, choices=[0, 1])
    p.add_argument("--clip", type=float, default=d.clip)

    p.add_argument("--data_split", default=d.data_split, type=str, choices=SPLIT_CHOICES)
    p.add_argument("--hidden_units", type=str, default=d.hidden_units)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--attn_dropout", type=float, default=d.attn_dropout)
    p.add_argument("--distance", type=int, default=d.distance, choices=[1, 2])
    p.add_argument("--csls", action="store_true", default=False)
    p.add_argument("--csls_k", type=int, default=d.csls_k)
    p.add_argument("--il", action="store_true", default=False)
    p.add_argument("--semi_learn_step", type=int, default=d.semi_learn_step)
    p.add_argument("--il_start", type=int, default=d.il_start)
    p.add_argument("--unsup", action="store_true", default=False)
    p.add_argument("--unsup_k", type=int, default=d.unsup_k)

    p.add_argument("--unsup_mode", type=str, default=d.unsup_mode, choices=["img", "name", "char"])
    p.add_argument("--tau", type=float, default=d.tau)
    p.add_argument("--tau2", type=float, default=d.tau2)
    p.add_argument("--alpha", type=float, default=d.alpha)
    p.add_argument("--with_weight", type=int, default=d.with_weight)
    p.add_argument("--structure_encoder", type=str, default=d.structure_encoder, choices=["gat", "gcn"])
    p.add_argument("--ab_weight", type=float, default=d.ab_weight)
    p.add_argument("--projection", action="store_true", default=False)
    p.add_argument("--heads", type=str, default=d.heads)
    p.add_argument("--instance_normalization", action="store_true", default=False)
    p.add_argument("--attr_dim", type=int, default=d.attr_dim)
    p.add_argument("--img_dim", type=int, default=d.img_dim)
    p.add_argument("--name_dim", type=int, default=d.name_dim)
    p.add_argument("--char_dim", type=int, default=d.char_dim)
    p.add_argument("--w_gcn", action="store_false", default=True)
    p.add_argument("--w_rel", action="store_false", default=True)
    p.add_argument("--w_attr", action="store_false", default=True)
    p.add_argument("--w_name", action="store_false", default=True)
    p.add_argument("--w_char", action="store_false", default=True)
    p.add_argument("--w_img", action="store_false", default=True)
    p.add_argument("--use_surface", type=int, default=d.use_surface)
    p.add_argument("--inner_view_num", type=int, default=d.inner_view_num)
    p.add_argument("--word_embedding", type=str, default=d.word_embedding, choices=["glove", "bert"])
    p.add_argument("--use_project_head", action="store_true", default=False)
    p.add_argument("--zoom", type=float, default=d.zoom)
    p.add_argument("--reduction", type=str, default=d.reduction, choices=["sum", "mean"])

    p.add_argument("--hidden_size", type=int, default=d.hidden_size)
    p.add_argument("--intermediate_size", type=int, default=d.intermediate_size)
    p.add_argument("--num_attention_heads", type=int, default=d.num_attention_heads)
    p.add_argument("--num_hidden_layers", type=int, default=d.num_hidden_layers)
    p.add_argument("--position_embedding_type", default=d.position_embedding_type, type=str)
    p.add_argument("--use_intermediate", type=int, default=d.use_intermediate)
    p.add_argument("--replay", type=int, default=d.replay)
    p.add_argument("--neg_cross_kg", type=int, default=d.neg_cross_kg)
    p.add_argument("--awloss", type=int, default=d.awloss)
    p.add_argument("--stage", type=int, default=d.stage, choices=[0, 1, 2])
    p.add_argument("--ablation", type=int, default=d.ablation, choices=[-1, 0, 1, 2, 3])
    p.add_argument("--adapt", type=str, default=d.adapt, choices=["mlp", "vae"])
    p.add_argument("--ratio", type=str, default=d.ratio)
    p.add_argument("--stage_epoch", type=str, default=d.stage_epoch)

    p.add_argument("--add_noise", type=int, default=d.add_noise, choices=[0, 1])
    p.add_argument("--noise_ratio", type=float, default=d.noise_ratio)
    p.add_argument("--mask_ratio", type=float, default=d.mask_ratio)
    p.add_argument("--il_stage_epoch", type=str, default=d.il_stage_epoch)

    p.add_argument("--dim", type=int, default=d.dim)
    p.add_argument("--neg_triple_num", type=int, default=d.neg_triple_num)
    p.add_argument("--use_bert", type=int, default=d.use_bert)
    p.add_argument("--use_attr_value", type=int, default=d.use_attr_value)

    # framework additions
    p.add_argument("--device", type=str, default=d.device,
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--dtype", type=str, default=d.dtype, choices=["float32", "bfloat16"])
    p.add_argument("--mesh_shape", type=str, default=d.mesh_shape,
                   help="data:N trains on N ranks, one process a GPU "
                        "(NCCL; gloo with --device cpu)")
    p.add_argument("--profile_dir", type=str, default=d.profile_dir)
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--remat", type=int, default=d.remat)
    p.add_argument("--batch_encode", type=int, default=d.batch_encode)
    p.add_argument("--fused_snag_loss", type=int, default=d.fused_snag_loss)
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    p.add_argument("--resume_from", type=str, default=d.resume_from)
    p.add_argument("--synth_ents", type=int, default=d.synth_ents)
    p.add_argument("--synth_rels", type=int, default=d.synth_rels)
    p.add_argument("--synth_triples", type=int, default=d.synth_triples)
    p.add_argument("--synth_img_dim", type=int, default=d.synth_img_dim)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known})


def finalize_config(cfg: Config, data_root: Optional[str] = None) -> Config:
    """Derived-config pass (reference: SNAG_MMEA/config.py:143-218).

    Applies the surface toggles, FB-dataset constraints, position-embedding
    sizing, and the ``--enable_sota`` preset ladder.  Returns a new Config.
    """
    cfg = dataclasses.replace(cfg)
    assert not (cfg.save_model and cfg.only_test)

    if data_root is None:
        data_root = osp.abspath(osp.join(osp.dirname(__file__), "..", "data"))
    cfg.data_root = data_root

    # surface flags toggle name/char modalities (config.py:151-156)
    if cfg.use_surface:
        cfg.w_name = True
        cfg.w_char = True
    else:
        cfg.w_name = False
        cfg.w_char = False

    # FB datasets: 4 views, no surface, norm split (config.py:158-166)
    if cfg.data_choice in ["FBYG15K", "FBDB15K"]:
        cfg.use_intermediate = 0
        cfg.data_split = "norm"
        cfg.inner_view_num = 4
        cfg.w_name = False
        cfg.w_char = False
        cfg.use_surface = 0
        data_split_name = f"{cfg.data_rate}_"
    else:
        data_split_name = f"{cfg.data_split}_"
        if cfg.w_name and cfg.w_char:
            data_split_name = f"{data_split_name}with_surface_"

    cfg.exp_id = f"{cfg.model_name}_{cfg.data_choice}_{data_split_name}{cfg.exp_id}"
    cfg.data_path = osp.join(cfg.data_root, cfg.data_path)
    cfg.dump_path = osp.join(cfg.data_path, cfg.dump_path)

    # MSNEA ties its hidden dim to attr_dim (config.py:192)
    cfg.dim = cfg.attr_dim

    # Mformer geometry (config.py:195-196)
    cfg.max_position_embeddings = cfg.inner_view_num + 1
    assert cfg.hidden_size == cfg.attr_dim, (
        f"hidden_size ({cfg.hidden_size}) must equal attr_dim ({cfg.attr_dim})")

    # --enable_sota preset ladder (config.py:198-217)
    if cfg.enable_sota:
        if cfg.il:
            cfg.eval_epoch = max(2, cfg.eval_epoch)
            cfg.weight_decay = max(0.0005, cfg.weight_decay)
            if cfg.data_rate > 0.5:
                cfg.weight_decay = max(0.001, cfg.weight_decay)
            if cfg.data_choice == "DBP15K":
                if not cfg.use_surface:
                    cfg.weight_decay = max(0.001, cfg.weight_decay)
                if cfg.model_name == "SNAG" and cfg.data_split in ["ja_en", "fr_en"]:
                    cfg.epoch = 1000
                    cfg.il_start = 500
        else:
            if cfg.data_choice == "DBP15K":
                if cfg.model_name == "SNAG" and cfg.data_split in ["ja_en", "fr_en"]:
                    cfg.epoch = 500
                else:
                    cfg.epoch = 250
            else:
                cfg.epoch = 250

    # number of modality tokens actually fed to fusion
    cfg.modal_num = len(cfg.active_modalities())
    return cfg
