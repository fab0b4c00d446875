#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``snag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
the exit code is non-zero:

1. the card's name and power limit (nvidia-smi) and the CUDA version;
2. build the six kernel sources of ``snag_tpu_torch/csrc/*.cu`` with nvcc
   for sm_90a (into the git-ignored ``build/kernels``), one nvcc each, in
   parallel;
3. each of the nine kernels against its plain-PyTorch twin on the card, at
   the shapes the bench geometry gives it (the twins of the two GAT kernels
   and of the segment sum, whose ``index_add_`` adds by atomics in a
   varying order on the card, run on CPU copies of the inputs), with max
   errors and two median
   times over 5 runs: ``ms``, one launch between two CUDA events
   (``median_ms``; under ~0.2 ms it also counts the wrapper's Python), and
   ``device_ms``, the device time of the kernel's own launches in one
   ``torch.profiler`` trace of the 5 calls, each call's summed (kernels
   only, named as in ``DEVICE_KERNELS``; a trace that lost every call's
   span on the card is taken again, three in all), beside its bound
   (bytes over 3.35 TB/s or flops over the rate of its route, the larger:
   the loss kernels, NT-Xent and mixture, at the 3xTF32 tensor-core rate
   of 495 / 3 TFLOP/s, whose limits 3xTF32 meets; the rank sweeps at fp32's 67
   TFLOP/s, as exact ranks need fp32 in a fixed order) and, where one
   PyTorch call computes the same function, that call's time; for both
   loss gradients (one
   kernel, ``csrc/gram_grad.cuh``) and both loss lse kernels (one kernel,
   ``csrc/gram_lse.cuh``) the executed and least TFLOP/s and a bitwise
   repeat, and the launch plans of NT-Xent's gradient and of both lse;
   both f32 gradients' wide body (``gram_grad_wide``, past what the
   main-path body's accumulator holds: NT-Xent's GMI6 of
   ``NTXENT_SHAPES``; the mixture's ``MIXTURE_WIDE``, M = 4 at d = 1,600,
   M = 1 at the cap + 8), against its twin with its plan (chunks, blocks a cluster, splits,
   blocks per SM), device ms, executed and least TFLOP/s, bound and
   share, and a bitwise repeat; at every shape of both gradients the
   sha256 of its outputs; for the rank sweeps (``csrc/rank_tile.cuh``), each launch over both
   directions as the evaluation runs it, the same, their registers and
   spills, and a column direction that must give the bits of the row
   direction of the launch on (y, x); for the two GAT kernels (a warp per
   CSR row) a bitwise repeat, the GB/s of the rows they gather, and the
   registers and spills of the instantiations at C = 300 and 1,200; for
   the weighted segment sum (a warp per CSR row too) the forward on the
   GCN's adjacency and the backward's launch on ``w_rev``, each with a
   bitwise repeat and its gathered GB/s, its registers and spills, and
   ``torch.sparse.mm`` as the library yardstick; then the seven bf16 entries
   (``--dtype bfloat16``: both GAT kernels, the NT-Xent and mixture lse and
   gradients, the weighted segment sum, on bf16 operands; both gradients and
   both lse on kernels of their own, ``csrc/gram_grad_bf16.cuh`` and
   ``csrc/gram_lse_bf16.cuh``, whose plans, registers and spills it
   prints; the mixture gradient with ``mixture_kpos_bf16``, each positive
   pair's K and W_tot rounded once from f64) against their
   bf16 twins on CPU copies at the main path's shapes (the GAT inputs
   above rounded to bf16, NT-Xent IIR, the mixture's full M = 4 batch),
   within 4e-3 x max |twin| per output, with bitwise repeats and the same
   timings, their bound at the bf16 dense rate of 989 TFLOP/s; the NT-Xent
   kernels also at the other families' shapes (M = 1: MEAformer's joint loss at
   d = 1,200, f32 and bf16; an MCLEA modality's padded last batch at
   d = 300) and both rank sweeps also at MCLEA's 300-wide joint; the bf16
   segment sum (``segment_bf16``) on the bench graph's bf16 adjacency, its
   forward and its backward's reverse-edge launch with each term rounded
   to bf16 and d_x written in bf16, against the twin on CPU copies within
   4e-3 x max |twin| (and rtol = atol = 1e-5: both sides add terms they
   form alike), with bitwise repeats and sha256 digests, its registers and
   spills, gathered GB/s, each launch's own bound, and
   ``torch.sparse.mm`` on the bf16 CSR adjacency where cuSPARSE takes it;
4. a small input through the port on the GPU and on the CPU (twins):
   embeddings and ranks must agree; then three deterministic train steps
   from the same init, with the fused loss, without it, and with the GCN
   encoder: losses and parameters must agree, and the fused and unfused
   losses too; then ``--dtype bfloat16``: step 0's loss and gradients and
   three steps' losses, GPU against CPU (``phase_train_small_bf16``);
5. serving: ``snag_tpu_torch.cli.train_mmea.main`` with ``--only_test 1``
   at the bench geometry (30,000 entities, 2 x 2 GAT at d = 300, CSLS k = 3,
   10,500 test pairs) from a seeded random init saved as a reference
   ``.pkl``; its three kernels must have launched and no twin may have run;
6. training: ``main`` at the same geometry with batch 3500, 12 epochs, IL
   from epoch 2 (promotion at epoch 9), noise 0.2/0.7 and the default fused
   loss; every f32 kernel but the weighted segment sum must have launched,
   no twin may have run, the losses must be finite and fall, promotion must
   add pairs and the final metrics lie in [0, 1]; then the same run with
   ``--dtype bfloat16`` (``train_bf16``: every bf16 entry and both rank
   sweeps launch, no f32 GAT or loss kernel, its warm step printed beside
   the f32 one) and bf16 serving from a seeded init (``slice_bf16``);
7. the GCN encoder (``--structure_encoder gcn``) at the same geometry:
   serving, then 6 training epochs; the segment sum, mixture, NT-Xent and
   rank kernels must have launched and the GAT kernels not; then the same
   with ``--dtype bfloat16`` (``gcn_bf16``): exactly the bf16 segment sum,
   the four bf16 loss entries and the two f32 rank sweeps launch;
8. the other families through ``main`` at the bench geometry with
   ``--model_name`` switched (``phase_families``): EVA (its GCN; serving
   from a seeded init, then 10 epochs with IL from epoch 2, promotion at
   epoch 9), MCLEA and MEAformer (``--tau 0.1 --tau2 4.0``, their presets'
   values; 6 epochs each), MEAformer with ``--replay 1`` (6 epochs; it
   must log "begin replay!" and feed valid replay negatives, whose count
   is printed) and MEAformer in bf16 (4 epochs); each run launches exactly
   its family's kernels (EVA: the segment sum and both rank sweeps; MCLEA
   and MEAformer: both f32 GAT kernels, both NT-Xent kernels and both rank
   sweeps, their bf16 entries in bf16), its losses are finite and fall
   and its metrics lie in [0, 1];
9. files: ``scripts/torch_gates.py`` exports the 30,000-entity DBP15K
   ja_en files of the quality gates and checks their digests against the
   JAX package's; ``main`` trains on them at the gates' geometry for 8
   epochs (IL from epoch 2, a checkpoint every 3 epochs, ``--save_model
   1``), a second run resumes from the epoch-5 checkpoint and must end
   with the same final metrics and a saved model equal tensor for tensor,
   and ``--only_test 1`` from the saved ``.pkl`` must give the same
   metrics; each run's kernels must have launched and no twin may have
   run;
10. MSNEA (``phase_msnea``): serving from a seeded init saved as the
   port's ``.pkl``, then 40 epochs at a fixed LR of 2e-3 (the JAX
   package's smoke horizon) through ``main``; each run launches exactly
   the two rank sweeps, and the final test MRR must beat the init's;
11. SNAG with ``--accumulation_steps 2 --attn_dropout 0.1``
   (``snag_accum_dropout``, 6 epochs, IL from epoch 2): training runs the
   dropped GAT on the weighted segment sum and never the GAT backward
   kernel, evaluation and mining the fused GAT forward, with both loss
   kernels' pairs and both rank sweeps; the optimizer's updates are half
   the micro-steps, and two copies of the trained model that take the same
   two micro-steps end with the same bits;
12. MKGC (``phase_mkgc``) through ``snag_tpu_torch.cli.train_mkgc.main`` at
   bench.py's geometry (bench.py:313-319: SYNTH with 12,800 entities, 256
   relations, 90,000 triples, features of 4,096 and 768 pooled to 256,
   ``emb_dim`` 128, ``num_proj`` 2, ``Mformer_hd_graph``, 1 x 2 fusion,
   32 negatives, noise 0.2 / 0.7): (a) ``--num_batch 64 --margin 1``
   (batches of 1,124, the all-entity fusion branch), 3 epochs and a valid
   eval with ``--save_model 1``, then a warm epoch's triples/s and ms a
   step, one step's kernel ms (``device_ms``) and the idle share, and the
   filtered valid eval (2,000 triples, both directions), median of 5; (b)
   ``run_base.sh``'s ``--num_batch 1024 --margin 12`` (batches of 70, the
   role-mixed branch), 1 epoch, then the same timings; (c) ``--only_test
   1`` from (a)'s snapshot gives (a)'s test metrics; (d) in both branches
   two copies of the model and its Adam state that take the same two
   steps end on the same bits, and two evaluations on the same ranks; (e)
   three deterministic steps on injected samples at the JAX test's size,
   GPU against CPU (losses rel 1e-4, parameters atol 1e-5); (f) the JAX
   test's 80-entity learning run reaches test MRR > 0.15.  MKGC reaches no
   TPU kernel: each run must launch no kernel of ours and no twin, every
   loss be finite and every metric lie in [0, 1];
13. parity (``phase_parity``), the paths that finish single-GPU MMEA
   parity: (a) the instantiations past the main path's shapes against
   their twins on CPU copies (over every 50th row of the bench graph),
   with bitwise repeats, ``ms``, ``device_ms``, bounds, gather roofs, the
   twins' ms on the card and ptxas registers and spills: both GAT
   kernels' wide path, f32 and bf16, at H = 8, C = 300 (``--heads 8,8``'s
   shape), H = 8, C = 1,536 and H = 2, C = 330, and sweep A's
   shared-memory lists at n = 10,500, d = 1,200, k = 20 (the list of 32),
   64 and 128 (the list of 128);
   (b) SNAG through ``main`` at the bench geometry with ``--distance 1
   --csls_k 20 --instance_normalization --heads 8,8 --profile_dir``, 4
   epochs: its GAT kernels' wide path and loss kernels launch and the rank
   sweeps do not (L1 runs in torch ops, as in JAX), the profiler's Chrome
   trace holds CUDA kernel events, and the trained model's L1 evaluation
   on the card agrees with the CPU path on 1,024 test pairs (ranks on >=
   99.9 % of queries); then the same heads in bf16, 3 epochs (the GAT
   kernels' bf16 wide path, the bf16 loss entries, both rank sweeps);
   then the f32 model served with CSLS k = 20 under L2 (sweep A's list of
   32), its ranks on all 10,500 test pairs held against the CPU's dense
   twin (>= 99.9 %); then f32 SNAG with every active modality 1,600 wide,
   2 epochs: both f32 gradients' wide body (counted apart,
   ``ntxent_grad_wide`` and ``mixture_grad_wide``) and the GAT kernels'
   wide path launch, the
   losses finite and falling; (c) 10,500 against 12,000 rows of width
   1,200 ranked on the card and on the CPU.  The wide and long-list launches are
   counted apart (``WIDE_KERNELS``); the kernels line holds them with the
   records of (a) at H = 8, C = 300 and k = 20.
14. mesh (``phase_mesh``), ``--mesh_shape data:N`` through the CLIs:
   SNAG at the bench geometry with IL, 3 epochs at batch 3,500: (a)
   ``data:1`` (a group of one over NCCL on the card) against the plain
   run: step losses, the trained weights' sha256 and the final ranks bit
   for bit, the six kernels of rows 1-6 (the GAT pair, the mixture pair,
   NT-Xent's) launched; (b) two ranks sharing the card over gloo
   (collectives through host memory), spawned, against (a) within the CPU
   tests' bounds (epoch losses rel 5e-3, weights rtol 2e-3 and atol 2e-5
   but for the attention's key bias, whose gradient is rounding noise;
   ranks of the sharded evaluation on >= 99.5 % of queries, MRR within
   1e-3), each rank launching exactly rows 1-6; (c) with two cards or
   more, two ranks over NCCL, one a card, held alike, else a line saying
   it was skipped; (d) MKGC at phase 12's geometry, 2 epochs:
   ``data:1`` against the plain CLI run bit for bit (64 batches), and in
   both negative branches, the all-entity fusion (64 batches of 1,124)
   and the role-mixed one (128 batches of 562, which fetches a step's
   rows), two ranks over gloo against one rank at their batch size, with
   the sharded filtered ranks against the one-rank evaluator.  (a)'s runs
   hold every feature table whole; each rank of (b), (c) and (d) asserts
   that it holds its ``Mesh.rows`` share of each table and no whole one.
   It prints the warm step ms of (a) plain and mesh and of (b) beside the
   card's name and power limit (no speed claim), and for (a)'s runs, each
   rank of (b) and (d) and (d)'s one-rank runs the bytes of the tables
   held, the start-up peak and the steady peak (``max_memory_allocated``
   less what was held before the run; the start-up peak up to the start
   of epoch 0, the steady one from epoch 1 to the end, with its largest
   in training, in evaluation and in mining apart) beside the card's name
   and power limit; each rank of (b) also the median ms of a step's fetch
   (``take_each`` of the rank's share of a batch of 3,500 links from
   every table in one call, 20 times between barriers) and of as many
   uniform ids, and each rank of (d)'s role-mixed branch that of a step's
   heads, tails and corruptions from both tables, each with the distinct
   ids another rank owns.
Phases 10, 11 and 13 run after phase 8, before phase 9; phase 12 runs
after them, and phase 14 last.

Before the per-kernel record it prints the script's wall time.  The line
before last is the per-kernel JSON record (launches summed over the runs
of phases 5-11, 13 and 14, as phase 12 launches none; ``bound_share`` is
``bound_ms / device_ms``); the
last line is ``{"ok": true, "device": {...}}``.
Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import csv
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 3408
REPS = 5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3  # H100 SXM TF32 tensor cores, 3 products
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
BF16_TOL = 4e-3                 # a bf16 kernel: max |err| / max |twin|

BENCH_ARGS = [
    "--model_name", "SNAG", "--data_choice", "SYNTH", "--data_rate", "0.3",
    "--random_seed", str(SEED), "--hidden_units", "300,300,300",
    "--heads", "2,2", "--attr_dim", "300", "--img_dim", "300",
    "--name_dim", "300", "--char_dim", "300", "--hidden_size", "300",
    "--intermediate_size", "400", "--num_attention_heads", "1",
    "--num_hidden_layers", "1", "--structure_encoder", "gat",
    "--use_surface", "0", "--inner_view_num", "4", "--csls", "--csls_k", "3",
    "--synth_ents", "30000", "--synth_rels", "2000",
    "--synth_triples", "150000", "--synth_img_dim", "2048",
]
SMALL_ARGS = [
    "--model_name", "SNAG", "--data_choice", "SYNTH", "--random_seed", "7",
    "--hidden_units", "64,64,64", "--heads", "2,2", "--attr_dim", "64",
    "--img_dim", "64", "--hidden_size", "64", "--intermediate_size", "128",
    "--num_attention_heads", "2", "--num_hidden_layers", "1",
    "--use_surface", "0", "--inner_view_num", "4", "--csls", "--csls_k", "3",
    "--synth_ents", "2000", "--synth_rels", "40", "--synth_triples", "8000",
    "--synth_img_dim", "128",
]
TRAIN_ARGS = [
    "--epoch", "12", "--il", "--il_start", "2", "--semi_learn_step", "1",
    "--eval_epoch", "4", "--batch_size", "3500", "--lr", "5e-4",
    "--scheduler", "cos", "--add_noise", "1", "--noise_ratio", "0.2",
    "--mask_ratio", "0.7",
]
GCN_TRAIN_ARGS = [
    "--epoch", "6", "--eval_epoch", "3", "--batch_size", "3500",
    "--lr", "5e-4", "--scheduler", "cos", "--add_noise", "1",
    "--noise_ratio", "0.2", "--mask_ratio", "0.7",
]
KERNELS = ("gat_attention", "rank_eval", "gat_bwd", "ntxent", "snag_loss",
           "tile_segment")
# each wrapper's launches by the names of their kernels on the card
# (substrings, as the profiler shows them); device_ms and profile_train.py
# sum these
DEVICE_KERNELS = {
    "gat_attention_fwd": ("gat_attention_fwd",),
    "gat_bwd": ("gat_bwd",),
    "rank_topk_mean": ("topk_mean_kernel", "topk_merge_kernel"),
    "rank_counts": ("ranks_kernel", "ranks_merge_kernel"),
    "ntxent_lse": ("ntxent_lse",),
    "ntxent_grad": ("ntxent_grad",),
    "ntxent_grad_wide": ("ntxent_grad_wide",),
    "mixture_lse": ("mixture_lse",),
    "mixture_grad": ("mixture_grad", "mixture_dbeta", "mixture_sum"),
    "mixture_grad_wide": ("mixture_grad_wide",),
    "weighted_segment_sum": ("weighted_segment_sum",),
    # the bf16 entries (--dtype bfloat16), named apart: "<f32 name>_bf16"
    "weighted_segment_sum_bf16": ("weighted_segment_sum_bf16",),
    "gat_attention_fwd_bf16": ("gat_attention_fwd_bf16",),
    "gat_bwd_bf16": ("gat_bwd_bf16",),
    "ntxent_lse_bf16": ("ntxent_lse_bf16",),
    "ntxent_grad_bf16": ("ntxent_grad_bf16",),
    "mixture_lse_bf16": ("mixture_lse_bf16",),
    "mixture_grad_bf16": ("mixture_grad_bf16", "mixture_dbeta_bf16",
                          "mixture_sum_bf16", "mixture_kpos_bf16"),
    # the instantiations past the main path's shapes, counted apart: both
    # GAT kernels' wide path (H > 4, or C past a warp's slices), sweep A's
    # lists in shared memory (CSLS k > 10) and both f32 gradients' wide
    # body (above; a profile matches the longest name first)
    "gat_attention_fwd_wide": ("gat_attention_fwd_wide",),
    "gat_attention_fwd_bf16_wide": ("gat_attention_fwd_bf16_wide",),
    "gat_bwd_wide": ("gat_bwd_wide",),
    "gat_bwd_bf16_wide": ("gat_bwd_bf16_wide",),
    "rank_topk_mean_long": ("long_topk_mean_kernel", "long_topk_merge_kernel"),
}
SERVING_KERNELS = {"gat_attention_fwd", "rank_topk_mean", "rank_counts"}
GAT_KERNELS = {"gat_attention_fwd", "gat_bwd"}
GAT_WIDE_KERNELS = {"gat_attention_fwd_wide", "gat_bwd_wide"}
GAT_BF16_WIDE_KERNELS = {"gat_attention_fwd_bf16_wide", "gat_bwd_bf16_wide"}
GRAD_WIDE_KERNELS = {"ntxent_grad_wide", "mixture_grad_wide"}
WIDE_KERNELS = GAT_WIDE_KERNELS | GAT_BF16_WIDE_KERNELS | GRAD_WIDE_KERNELS \
    | {"rank_topk_mean_long"}
SEGMENT_KERNEL = "weighted_segment_sum"
SEGMENT_BF16 = "weighted_segment_sum_bf16"
# the bf16 entries of the GAT configuration's path
BF16_KERNELS = {"gat_attention_fwd_bf16", "gat_bwd_bf16", "ntxent_lse_bf16",
                "ntxent_grad_bf16", "mixture_lse_bf16", "mixture_grad_bf16"}
RANK_KERNELS = {"rank_topk_mean", "rank_counts"}
# the bf16 GCN's: its segment sum, the four loss entries, the f32 rank sweeps
GCN_BF16_KERNELS = ({SEGMENT_BF16} | BF16_KERNELS | RANK_KERNELS) - {
    "gat_attention_fwd_bf16", "gat_bwd_bf16"}
BF16 = ["--dtype", "bfloat16"]
# the MCLEA and MEAformer presets' temperatures (scripts/run_mclea.sh,
# run_meaformer.sh)
FAMILY_ARGS = ["--tau", "0.1", "--tau2", "4.0"]
# MCLEA and MEAformer's kernels: the GAT, NT-Xent and rank kernels (their
# bf16 entries in bf16, with the f32 rank sweeps)
FAMILY_KERNELS = {"gat_attention_fwd", "gat_bwd", "ntxent_lse",
                  "ntxent_grad", "rank_topk_mean", "rank_counts"}
FAMILY_BF16_KERNELS = {"gat_attention_fwd_bf16", "gat_bwd_bf16",
                       "ntxent_lse_bf16", "ntxent_grad_bf16",
                       "rank_topk_mean", "rank_counts"}
WARM_STEP_MS = {}               # phase -> median warm step ms of its run
SERVED = {}                     # serving phase -> its first request's result
# MSNEA's training: the JAX package's learning horizon
# (tests/test_models_smoke.py:30-44, a fixed LR of 2e-3), cut to 40 epochs
MSNEA_TRAIN_ARGS = [
    "--epoch", "40", "--eval_epoch", "10", "--batch_size", "3500",
    "--lr", "2e-3", "--scheduler", "fixed", "--add_noise", "0",
]
# SNAG with gradient accumulation and GAT attention dropout: TRAIN_ARGS at
# 6 epochs (IL from epoch 2, so mining runs; no promotion)
ACCUM_DROPOUT_ARGS = ["--accumulation_steps", "2", "--attn_dropout", "0.1"]
# (name, M, B, d, valid rows) of the NT-Xent calls at the bench geometry:
# the default fused loss runs IIR only (4 modalities' hidden rows); with
# --fused_snag_loss 0 ECIA (shown with the padded last batch, 1,000 of 3,500
# rows valid) and GMI (the two 1200-wide joint paths) run too, and GMI6
# with --use_surface 1 (six modalities: 1800-wide joint rows); MEAformer's
# joint loss (M = 1 at 1,200) and an MCLEA modality's loss with the padded
# last batch (M = 1 at 300; MCLEA's joint loss has the same shape).  GMI6
# alone is past the main-path gradient's accumulator (d > 1,504): it takes
# the gradient's wide body.
NTXENT_SHAPES = (("IIR", 4, 3500, 300, 3500), ("ECIA", 4, 3500, 300, 1000),
                 ("GMI", 2, 3500, 1200, 3500), ("GMI6", 2, 3500, 1800, 3500),
                 ("MEAformer joint", 1, 3500, 1200, 3500),
                 ("MCLEA modality", 1, 3500, 300, 1000))
# (name, M, B, d, valid rows) of the mixture kernels: the bundle of a full
# training batch, the padded last batch, and six modalities
# (--use_surface 1)
MIXTURE_SHAPES = (("M4", 4, 3500, 300, 3500), ("M4 padded", 4, 3500, 300, 1000),
                  ("M6", 6, 3500, 300, 3500))
# (name, M, B, d) of the f32 mixture gradient past one modality's fit in
# its shared accumulator, on its wide body: the bundle of a training batch
# at width 1,600 (phase parity's SNAG_WIDE run), and one modality just
# past the cap (d = None: the cap + 8, read on the card)
MIXTURE_WIDE = (("M4 d1600", 4, 3500, 1600), ("M1 cap+8", 1, 3500, None))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cfg_from(argv):
    from snag_tpu_torch.config import (build_argparser, config_from_args,
                                       finalize_config)
    return finalize_config(config_from_args(build_argparser().parse_args(argv)))


def set_flag(args, flag, value):
    """``args`` with ``flag``'s value replaced by ``value``."""
    i = args.index(flag)
    return args[:i + 1] + [value] + args[i + 2:]


def gcn_args(args):
    """``args`` with the GCN structure encoder in place of the GAT."""
    return set_flag(args, "--structure_encoder", "gcn")


def family_args(name, *extra):
    """``BENCH_ARGS`` with ``--model_name name``: EVA with the GCN it
    always builds, MCLEA and MEAformer with their presets' temperatures."""
    args = set_flag(BENCH_ARGS, "--model_name", name)
    args = gcn_args(args) if name == "EVA" else args + FAMILY_ARGS
    return args + list(extra)


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over device memory's rate, or its flops over the
    peak of its route (fp32, or 3xTF32 for the loss kernels), whichever
    takes longer."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_flops = 1e3 * flops / flop_per_s
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def symmetric_gram_flops(m, n2, d):
    """(flops of the M Gram matrices K_m = z_m z_m^T, flops of the M
    products W_m z_m) at z (m, n2, d).  K_m and every channel built from it
    are symmetric, so a row-LSE needs K_m once per unordered pair of rows,
    each exp added to both its row's and its column's sum; W_m is not
    symmetric, so W_m z_m is a full product."""
    return m * n2 * (n2 + 1) * d, 2 * m * n2 * n2 * d


def row(name, err, ms, dev_ms, plain_ms, nbytes, flops, library_ms=None,
        flop_per_s=FP32_FLOP_PER_S):
    """One kernel's record for the JSON line: ``ms`` from ``median_ms``,
    ``device_ms`` from ``device_ms`` and the bound's share of it."""
    bound_ms, bound_by = bound(nbytes, flops, flop_per_s)
    return {"name": name, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "bound_share": bound_ms / dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kernel_stats():
    from snag_tpu_torch.ops import cuda as kernels
    return {name: (s.launches, s.twin_calls)
            for name, s in kernels.all_stats().items()}


def check_launches(phase, stats, expected):
    """Every kernel in ``expected`` launched, no other did, no twin ran."""
    for name, (launches, twin_calls) in stats.items():
        if (launches > 0) != (name in expected) or twin_calls != 0:
            raise AssertionError(f"{name}: {launches} launches, {twin_calls} "
                                 f"twin calls in {phase}")


def median_ms(fn) -> float:
    """Median of REPS single launches between two CUDA events: under ~0.2
    ms this also counts the wrapper's Python (``device_ms`` does not)."""
    import torch
    fn()                                       # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def is_kernel(ev, host_names=frozenset()) -> bool:
    """A profiler event that is a kernel on the card: device-side, not a
    copy or memset, and not a GPU user annotation (a span such as
    ``Optimizer.step#AdamW.step`` laid over kernels that are counted on
    their own).  An annotation is known by the event's flag where the
    installed torch has one, else by its name, which is also a host
    event's: no kernel is named like a host op."""
    from torch.autograd import DeviceType
    if ev.device_type != DeviceType.CUDA:
        return False
    if getattr(ev, "is_user_annotation", False) or ev.name in host_names:
        return False
    return not ev.name.startswith(("Memcpy", "Memset"))


def host_names(events) -> frozenset:
    from torch.autograd import DeviceType
    return frozenset(ev.name for ev in events
                     if ev.device_type == DeviceType.CPU)


CALL = "device_ms call "     # the record_function span of each traced call
# A profiler session loses the kernels of its first calls (on an H100
# with torch 2.11 most often the first one or two, within ~3 ms of its
# start; once every kernel of its 3 settling calls and 10 ms, and the
# first kernel of the first counted call), so each session first runs fn
# uncounted for at least SETTLE_S and 3 calls, and ends with 2 uncounted
# calls after the counted ones.
SETTLE_S = 0.05


class LostSession(RuntimeError):
    """A profiler session that recorded no span of a counted call on the
    card (none of its device events): on an H100 with torch 2.11 a
    session now and then loses them all."""


class PartialSession(RuntimeError):
    """A profiler session that recorded the spans of some counted calls on
    the card but not of all: seen on an H100 with torch 2.11 in a long
    process (every device event after the first one or two counted calls
    lost), while 75 sessions in a fresh process lost none.  Also a session
    whose record on the card begins inside its first counted call (no
    device event of the settling calls before it) and which holds fewer
    kernels in that call than in every other: it lost the session's start
    into that call."""


# the profiler's losses, which ``device_ms`` traces again: neither says
# anything of the kernel, whose calls ran to their end in every case
PROFILER_LOSSES = (LostSession, PartialSession)


def call_kernel_ms(events, names, calls) -> list:
    """Device ms of each of ``calls`` traced calls (each inside a
    ``record_function`` span named ``CALL`` + its index): the sum of the
    kernels named like ``names`` inside the span's GPU annotation, which
    the profiler lays, on the card's clock, over the kernels launched
    inside the span.  Raises unless every call has such kernels, as many
    as every other call."""
    from torch.autograd import DeviceType
    span = {int(ev.name[len(CALL):]): ev.time_range for ev in events
            if ev.name.startswith(CALL) and ev.device_type == DeviceType.CUDA}
    host = host_names(events)
    out = [0.0] * calls
    hits = [0] * calls
    for ev in events:
        if not (is_kernel(ev, host) and any(k in ev.name for k in names)):
            continue
        for r, t in span.items():
            if t.start <= ev.time_range.start <= t.end:
                out[r] += ev.device_time / 1e3
                hits[r] += 1
    if len(span) != calls or min(hits) == 0 or len(set(hits)) != 1:
        seen = sorted((round(ev.time_range.start, 1), ev.name[:40])
                      for ev in events if ev.device_type == DeviceType.CUDA)
        raise (LostSession if not span else PartialSession
               if len(span) != calls or _lost_start(span, hits, seen)
               else RuntimeError)(
            f"the profiler recorded no kernel named like {names} in a call, "
            f"or fewer than in another, of {calls}: kernels a call {hits}; "
            f"spans on the card "
            f"{sorted((r, t.start, t.end) for r, t in span.items())}; last "
            f"device events {seen[-24:]}")
    return out


def _lost_start(span, hits, seen) -> bool:
    """Whether the session's record on the card begins inside its first
    counted call (``seen``, its device events by start, holds none before
    that call's span, so the settling calls' kernels were all lost) and
    that call alone has fewer kernels than the others, which agree."""
    rest = set(hits[1:])
    return (0 in span and seen[0][0] >= round(span[0].start, 1)
            and len(rest) == 1 and hits[0] < rest.pop())


def traced_calls(fn, calls):
    """The profiler's events of ``calls`` calls of fn, each run to its end
    inside a ``record_function`` span ``CALL`` + its index, between the
    session's uncounted calls (``SETTLE_S``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def run():
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0, settled = time.perf_counter(), 0
        while settled < 3 or time.perf_counter() - t0 < SETTLE_S:
            run()
            settled += 1
        for r in range(calls):
            with record_function(f"{CALL}{r}"):
                run()
        run()
        run()
    return prof.events()


def device_ms(fn, names, trace=traced_calls, sessions=4,
              retry=PROFILER_LOSSES) -> float:
    """Median over REPS calls of fn, traced together, of each call's device
    time of its kernels named like ``names`` (a call's launches summed):
    the card's time alone, without the host's.  A session that raised one
    of ``retry`` (by default ``PROFILER_LOSSES``: it lost every counted
    span, or some) is traced again, ``sessions`` in all, and each retry is
    printed; any other shortfall (every span kept, a call's kernels not)
    raises at once."""
    for left in range(sessions - 1, -1, -1):
        try:
            return statistics.median(call_kernel_ms(trace(fn, REPS), names,
                                                    REPS))
        except retry as err:
            if not left:
                raise
            say("profiler", f"{type(err).__name__} timing {names[0]}: "
                f"traced again ({left} session(s) left)")


# ------------------------------------------------------------------ phases

def card_smi() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    print(card_smi())
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} | CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from snag_tpu_torch.ops.cuda._lib import load_library
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(load_library, KERNELS))
    say("build", f"{len(libs)} sources in {time.perf_counter() - t0:.1f} s")
    for built in libs:
        name = built.name
        usage = [ln.strip() for ln in built.compiler_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        (WORK / f"{name}.ptxas.txt").write_text(built.compiler_log)
        say("build", f"{name}: {built.build_seconds:.1f} s -> {built.path.name}")
        for ln in usage:
            say("build", f"  {ln}")


def gat_inputs(graph_np, c=300, h=2):
    """The bench graph on the card and seeded (x, s_src, s_dst) of the GAT
    forward; ``scripts/torch_grad_ab.py`` times the kernel on these."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    n = graph_np.n_nodes

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    return (graph_np.to_torch(dev), t(n, c), t(n, h), t(n, h))


def gat_bwd_inputs(graph_np, c=300, h=2):
    """The bench graph on the card and seeded (x, s_src, s_dst, G, r) of
    the GAT backward."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    n = graph_np.n_nodes

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    return (graph_np.to_torch(dev), t(n, c), t(n, h), t(n, h), t(n, h, c),
            t(n, h))


def on_cpu(twin, *args):
    """``twin`` on CPU copies of ``args`` (tensors and a DeviceGraph), its
    outputs moved back to the card: ``index_add_`` adds in a fixed order on
    the CPU and by atomics in a varying order on the card."""
    import torch
    from snag_tpu_torch.data.graph import DeviceGraph

    def cpu(a):
        if isinstance(a, DeviceGraph):
            return DeviceGraph(*(cpu(t) for t in a))
        return a.cpu() if isinstance(a, torch.Tensor) else a
    out = twin(*(cpu(a) for a in args))
    return tuple(o.to("cuda") for o in out)


def bf16_errors(label, got, want):
    """max |err| of each bf16 kernel output against its twin's; raises
    above ``BF16_TOL`` x max |twin| or on a non-finite value."""
    errs = []
    for i, (a, w) in enumerate(zip(got, want)):
        a, w = a.float(), w.float()
        e, scale = (a - w).abs().max().item(), w.abs().max().item()
        if not (a.isfinite().all() and e <= BF16_TOL * scale):
            raise AssertionError(f"{label} output {i}: max|err| {e} > "
                                 f"{BF16_TOL} x max|twin| {scale}")
        errs.append(e)
    return errs


def repeat_bitwise(fn, what):
    """fn's outputs, after checking that a second run gives the same bits."""
    import torch
    first, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(a is b or torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{what}: two runs differ")
    return first


def kernel_ptxas(lib, names):
    """(name<template ints>, registers, spill store bytes, spill load
    bytes) of each entry of ``lib`` whose mangled name holds one of
    ``names``, from the build's ptxas log."""
    out = []
    for entry, regs, st, ld in ptxas_usage(lib.compiler_log, names):
        m = re.search(r"\d([a-z_]+?_kernel)I(.*?)EEv", entry)
        name = (f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)', m.group(2)))}>"
                if m else plain_kernel_name(entry))
        out.append((name, regs, st, ld))
    return out


def plain_kernel_name(entry):
    """The ``..._kernel`` identifier of a mangled non-template entry (each
    name is its length, then its characters), or the entry itself."""
    i = 0
    while i < len(entry):
        m = re.match(r"\d+", entry[i:])
        if not m:
            i += 1
            continue
        start = i + len(m.group())
        ident = entry[start:start + int(m.group())]
        if ident.endswith("_kernel"):
            return ident
        i = start + len(ident)
    return entry


def gat_ptxas(lib, kernel):
    """``kernel_ptxas`` of ``kernel<H = 2, VEC = 4, G>`` at G = 3 (C = 300)
    and G = 10 (C = 1,200), and of any other entry of ``lib`` whose name
    holds ``_src_kernel`` (the backward's second pass)."""
    return kernel_ptxas(lib, (f"{kernel}ILi2ELi4ELi3E",
                              f"{kernel}ILi2ELi4ELi10E", "_src_kernelILi2E"))


def say_gat_ptxas(phase, lib, kernel):
    for name, regs, st, ld in gat_ptxas(lib, kernel):
        say(phase, f"ptxas {name}: {regs} registers, spill stores {st} B, "
            f"loads {ld} B")


def phase_gat(graph_np, bf16=False):
    """The GAT forward kernel against its index_add_ twin (on CPU copies)
    at the slice shapes, rtol = atol = 1e-5, with a bitwise repeat and the
    rate of its x gathers (E C 4 bytes over the kernel's time).  bf16: the
    bf16 entry on the same x rounded to bf16, within ``BF16_TOL`` x max of
    its bf16 twin, gathering E C 2 bytes."""
    import torch
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    stats = ga.STATS_BF16 if bf16 else ga.STATS
    label = "gat_bf16" if bf16 else "gat"
    say_gat_ptxas(label, ga._library(), f"{stats.name}_kernel")
    g, x, s_src, s_dst = gat_inputs(graph_np)
    if bf16:
        x = x.to(torch.bfloat16)
    (n, c), h, e = x.shape, s_src.shape[1], g.n_edges
    agg, rs = repeat_bitwise(lambda: ga.gat_attention_cuda(x, s_src, s_dst, g),
                             label)
    want_agg, want_rs = on_cpu(ga.gat_attention_twin, x, s_src, s_dst, g)
    if bf16:
        err_agg, err_rs = bf16_errors(label, (agg, rs), (want_agg, want_rs))
        limit = f"<= {BF16_TOL} x max"
    else:
        err_agg = (agg - want_agg).abs().max().item()
        err_rs = (rs - want_rs).abs().max().item()
        torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)
        limit = "rtol=atol=1e-5"
    ms = median_ms(lambda: ga.gat_attention_cuda(x, s_src, s_dst, g))
    dev = device_ms(lambda: ga.gat_attention_cuda(x, s_src, s_dst, g),
                    DEVICE_KERNELS[stats.name])
    plain = median_ms(lambda: ga.gat_attention_twin(x, s_src, s_dst, g))
    xb = x.element_size()
    say(label, f"N={n} E={e} C={c} H={h}: max|agg err| {err_agg:.3e}"
        f" max|rowsum err| {err_rs:.3e} ({limit}), bitwise repeat |"
        f" kernel {ms:.4f} ms, device {dev:.4f} ms "
        f"({e * c * xb / dev / 1e6:.1f} GB/s of x rows gathered) twin "
        f"{plain:.4f} ms")
    # in: x, s_src, s_dst, row_ptr, col; out: agg, rowsum
    return row(stats.name, max(err_agg, err_rs), ms, dev, plain,
               xb * n * c + 4 * (2 * n * h + n + 1 + e + n * h * c + n * h),
               2 * e * h * (c + 1))


def phase_gat_bwd(graph_np, bf16=False):
    """The GAT backward kernel against its index_add_ twin (on CPU copies)
    at the slice shapes, with a bitwise repeat and the rate of its G
    gathers (E H C 4 bytes over the kernel's time).  Per-edge dot products
    over C and the heads are summed in another order: rtol = atol = 1e-4.
    bf16: the bf16 entry on x and G rounded to bf16, within ``BF16_TOL`` x
    max of its bf16 twin per output, gathering E H C 2 bytes."""
    import torch
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    stats = gb.STATS_BF16 if bf16 else gb.STATS
    label = "gat_bwd_bf16" if bf16 else "gat_bwd"
    say_gat_ptxas(label, gb._library(),
                  f"{'gat_bwd_bf16' if bf16 else 'gat_bwd'}_rows_kernel")
    g, x, s_src, s_dst, g_agg, g_rs = gat_bwd_inputs(graph_np)
    if bf16:
        x, g_agg = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    (n, c), h, e = x.shape, s_src.shape[1], g.n_edges
    got = repeat_bitwise(lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg,
                                                      g_rs, g), label)
    want = on_cpu(gb.gat_backward_twin, x, s_src, s_dst, g_agg, g_rs, g)
    if bf16:
        errs = bf16_errors(label, got, want)
        limit = f"<= {BF16_TOL} x max"
    else:
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        limit = "rtol=atol=1e-4"
    ms = median_ms(lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg,
                                                g_rs, g))
    dev = device_ms(lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg,
                                                 g_rs, g),
                    DEVICE_KERNELS[stats.name])
    plain = median_ms(lambda: gb.gat_backward_twin(x, s_src, s_dst, g_agg,
                                                   g_rs, g))
    xb = x.element_size()
    say(label, f"N={n} E={e} C={c} H={h}: max|err| d_x "
        f"{errs[0]:.3e} d_s_src {errs[1]:.3e} d_s_dst {errs[2]:.3e} "
        f"({limit}), bitwise repeat | kernel {ms:.4f} ms, device "
        f"{dev:.4f} ms ({e * h * c * xb / dev / 1e6:.1f} GB/s of G rows "
        f"gathered) twin {plain:.4f} ms")
    # in: x, s_src, s_dst, G, r, row_ptr, col; out: d_x, d_s_src, d_s_dst
    return row(stats.name, max(errs), ms, dev, plain,
               xb * (2 * n * c + n * h * c) + 4 * (5 * n * h + n + 1 + e),
               4 * e * h * c)


def _eval_inputs(n, d):
    """Unit rows, the right side a noisy copy of the left.  The noise puts
    the gold cosine near 0.05, so ranks spread over the whole range
    instead of piling up at 0, and near-ties occur."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    l = rng.normal(size=(n, d)).astype(np.float32)
    r = l + 20.0 * rng.normal(size=(n, d)).astype(np.float32)
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    return (torch.as_tensor(l, device="cuda"), torch.as_tensor(r, device="cuda"))


def ptxas_usage(log: str, names):
    """(entry, registers, spill stores, spill loads) of each kernel entry
    in an ``-Xptxas -v`` log whose mangled name contains one of names."""
    out, entry, spills = [], None, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and "spill stores" in ln:
            parts = ln.replace(",", "").split()
            spills = (int(parts[parts.index("spill") - 2]),
                      int(parts[parts.index("loads") - 3]))
        elif entry and "Used" in ln and "registers" in ln:
            regs = int(ln.split("Used")[1].split()[0])
            if any(name in entry for name in names):
                out.append((entry, regs, *spills))
            entry, spills = None, (0, 0)
    return out


def phase_rank(n=10500, d=1200, k=3):
    """Both rank sweeps at the bench's eval shape, each over both
    directions in one launch as the evaluation runs them, against their
    plain versions (means and diagonal rtol = atol = 1e-5; ranks on
    >= 99.9 % of queries in each direction), each with a bitwise repeat,
    its launch plan, its registers and spills from the build log, and its
    executed (whole tiles) and least (2 n^2 d) TFLOP/s against fp32's 67;
    the fp32 cuBLAS product x @ y.T alone as context (it is not the
    sweeps' function); a launch's column direction against the row
    direction of the launch on (y, x), bit for bit; then the whole
    streaming evaluation against the dense twin (Hits/MRR within 1e-4)."""
    import torch
    from snag_tpu_torch.eval.ranking import result_from_ranks
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    x, y = _eval_inputs(n, d)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    flops = 2 * n * n * d
    for entry, regs, st, ld in ptxas_usage(rk._library().compiler_log,
                                          ("topk_", "ranks_")):
        # e.g. ..._12ranks_kernelILb1ELb1EEEv... -> ranks_kernel<1,1>
        m = re.search(r"\d((?:topk|ranks)\w*?_kernel)I(.*?)EEv", entry)
        name = (f"{m.group(1)}<{','.join(re.findall(r'L[bi](\d+)', m.group(2)))}>"
                if m else entry)
        say("rank", f"ptxas {name}: {regs} registers, spill stores {st} B, "
            f"loads {ld} B")

    def rates(ms, plan):
        return (f"{plan['executed_flops'] / ms / 1e9:.1f} executed, "
                f"{flops / ms / 1e9:.1f} least TFLOP/s of "
                f"{FP32_FLOP_PER_S / 1e12:.0f}; tile {plan['tile_rows']}x"
                f"{plan['tile_cols']}, {plan['splits']} splits, "
                f"{plan['blocks']} blocks, {plan['blocks_per_sm']} "
                f"block(s)/SM, {plan['waves']} waves (last "
                f"{plan['last_wave']:.3f} full), {plan['smem_bytes']} B "
                "shared")

    # sweep A, both directions, against its plain version
    got_a = repeat_bitwise(lambda: rk.topk_mean_both_cuda(x, y, xn, yn, k), "sweep A")
    want_a = rk.topk_mean_both_twin(x, y, xn, yn, k)
    err_a = max((a - b).abs().max().item() for a, b in zip(got_a, want_a))
    for a, b in zip(got_a, want_a):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    mean, diag, rr = got_a
    ms_a = median_ms(lambda: rk.topk_mean_both_cuda(x, y, xn, yn, k))
    dev_a = device_ms(lambda: rk.topk_mean_both_cuda(x, y, xn, yn, k),
                      DEVICE_KERNELS[rk.STATS_TOPK.name])
    plain_a = median_ms(lambda: rk.topk_mean_both_twin(x, y, xn, yn, k))
    say("rank", f"sweep A N={n} d={d} k={k}, both directions: max|mean/diag/"
        f"column mean err| {err_a:.3e} (rtol=atol=1e-5), bitwise repeat | "
        f"kernel {ms_a:.3f} ms, device {dev_a:.3f} ms "
        f"({rates(dev_a, rk.device_plan(x.device, n, d, 0, k))})"
        f" plain {plain_a:.3f} ms")

    # sweep B, both directions, fed the same CSLS terms
    got_b = repeat_bitwise(lambda: rk.rank_counts_both_cuda(x, y, xn, yn, mean, rr,
                                                    diag, True), "sweep B")
    want_b = rk.rank_counts_both_twin(x, y, xn, yn, mean, rr, diag, True)
    agree_b, err_b = 1.0, 0
    for got_c, want_c in ((got_b[0], want_b[0]), (got_b[2], want_b[2])):
        ranks, p_ranks = got_c.sum(dim=1), want_c.sum(dim=1)
        agree_b = min(agree_b, (ranks == p_ranks).float().mean().item())
        err_b = max(err_b, (ranks - p_ranks).abs().max().item())
    top3_agree = (got_b[1] == want_b[1]).all(dim=1).float().mean().item()
    del want_b
    ms_b = median_ms(lambda: rk.rank_counts_both_cuda(x, y, xn, yn, mean, rr,
                                                      diag, True))
    dev_b = device_ms(lambda: rk.rank_counts_both_cuda(x, y, xn, yn, mean, rr,
                                                       diag, True),
                      DEVICE_KERNELS[rk.STATS_RANKS.name])
    plain_b = median_ms(lambda: rk.rank_counts_both_twin(x, y, xn, yn, mean,
                                                         rr, diag, True))
    library = median_ms(lambda: x @ y.T)
    say("rank", f"sweep B, both directions: ranks equal on {agree_b:.6f} of "
        f"queries (the worse direction), top-3 on {top3_agree:.6f}, max|rank "
        f"diff| {err_b}, bitwise repeat | kernel {ms_b:.3f} ms, device "
        f"{dev_b:.3f} ms ({rates(dev_b, rk.device_plan(x.device, n, d, 1, 3))})"
        f" plain "
        f"{plain_b:.3f} ms | fp32 cuBLAS x @ y.T alone {library:.3f} ms "
        f"({flops / library / 1e9:.1f} TFLOP/s)")

    # a launch's column direction is the row direction on (y, x)
    rev_a = rk.topk_mean_cuda(y, x, yn, xn, k)
    rev_b = rk.rank_counts_cuda(y, x, yn, xn, rr, mean, diag, False)
    torch.cuda.synchronize()
    if not (torch.equal(rev_a[0], rr) and torch.equal(rev_a[1], diag)
            and torch.equal(rev_b[0], got_b[2])):
        raise AssertionError("a launch's column direction differs from the "
                             "row direction of the launch on (y, x)")
    say("rank", "column direction bit-identical to the row direction on "
        "(y, x): column means, diagonal, column counts")

    # the whole streaming evaluation against the dense twin.  cuBLAS and
    # the kernel sum the dot products in different orders, so a near-tie
    # may flip: ranks must agree on >= 99.9 % of queries and the metrics
    # within 1e-4
    got = rk.streaming_rank_eval(x, y, k, True, True)
    torch.cuda.synchronize()
    want = rk.eval_core(x, y, k, True, True)
    agree = min((got[0] == want[0]).float().mean().item(),
                (got[1] == want[1]).float().mean().item())
    t3 = (got[2].long() == want[2]).all(dim=1).float().mean().item()
    rg = result_from_ranks(got[0].cpu().numpy(), got[1].cpu().numpy(), None)
    rw = result_from_ranks(want[0].cpu().numpy(), want[1].cpu().numpy(), None)
    dm = max(abs(rg.mrr_l2r - rw.mrr_l2r), abs(rg.mrr_r2l - rw.mrr_r2l),
             float(abs(rg.acc_l2r - rw.acc_l2r).max()),
             float(abs(rg.acc_r2l - rw.acc_r2l).max()))
    ms_all = median_ms(lambda: rk.streaming_rank_eval(x, y, k, True, True))
    plain_all = median_ms(lambda: rk.eval_core(x, y, k, True, True))
    say("rank", f"full eval: ranks equal on {agree:.6f}, top-3 on {t3:.6f},"
        f" max|Hits/MRR diff| {dm:.2e}, MRR l2r {rg.mrr_l2r:.6f} (mean"
        f" rank {rg.mr_l2r:.1f}) | 2 launches of both directions "
        f"{ms_all:.3f} ms, dense twin {plain_all:.3f} ms")
    if agree < 0.999 or agree_b < 0.999 or dm > 1e-4:
        raise AssertionError(f"rank eval disagrees with its twin: {agree} "
                             f"{agree_b} {dm}")
    # sweep A: in x, y and their norms, out the row and column means and
    # the diagonal; sweep B: in the same, the CSLS terms and the diagonal,
    # out two int32 rank counts a direction and the top-3
    return [row(rk.STATS_TOPK.name, err_a, ms_a, dev_a, plain_a,
                4 * (2 * n * d + 5 * n), flops),
            row(rk.STATS_RANKS.name, float(err_b), ms_b, dev_b, plain_b,
                4 * (2 * n * d + 5 * n) + 4 * (2 * 2 * n + 3 * n), flops)]


def _ntxent_inputs(m, b, d, n_valid, seed):
    """Unit rows with near-copy positives, validity of the first n_valid
    pairs, row coefficients zero on invalid rows (as the loss folds them)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m, 2 * b)).astype(np.float32) * v
    coef /= max(n_valid, 1)
    return [torch.as_tensor(a, device="cuda") for a in (z, v, coef)]


def phase_ntxent(tau=0.1):
    """Both NT-Xent kernels against their dense twins at ``NTXENT_SHAPES``.
    lse: atol 1e-5 (rtol 1e-5); gradient: max |err| <= 1e-4 * max |twin|;
    two runs of either give the same bits.  Prints the plans (lse: tile,
    tile pairs, blocks per SM; gradient: feature chunks, ring depth, column
    splits, blocks per SM, and on the wide body its clusters), the
    fp32-equivalent TFLOP/s, executed (lse: every tile pair's T^2
    products; gradient: K once per feature chunk, or per cluster group on
    the wide body, then W z) and least (K once per unordered pair of rows,
    then W z for the gradient), the gradient's bound and share and the
    sha256 of its dz.  The JSON records: IIR, the only shape the default
    fused loss runs, and the wide body at GMI6."""
    import torch
    from snag_tpu_torch.ops.cuda import ntxent as nx
    err_lse = err_grad = 0.0
    for i, (label, m, b, d, n_valid) in enumerate(NTXENT_SHAPES):
        z, v, coef = _ntxent_inputs(m, b, d, n_valid, SEED + i)
        lse = nx.streaming_lse_cuda(z, v, tau)
        lse_again = nx.streaming_lse_cuda(z, v, tau)
        torch.cuda.synchronize()
        want = nx.streaming_lse_twin(z, v, tau)
        e_lse = (lse - want).abs().max().item()
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
        if not torch.equal(lse, lse_again):
            raise AssertionError(f"ntxent_lse {label}: two runs differ")
        dz = nx.ntxent_grad_cuda(z, want, coef, v, tau)
        again = nx.ntxent_grad_cuda(z, want, coef, v, tau)
        torch.cuda.synchronize()
        want_dz = nx.ntxent_grad_twin(z, want, coef, v, tau)
        e_dz = (dz - want_dz).abs().max().item()
        scale = want_dz.abs().max().item()
        if not (torch.isfinite(dz).all() and e_dz <= 1e-4 * scale):
            raise AssertionError(f"ntxent_grad {label}: max|err| {e_dz} > "
                                 f"1e-4 * max|twin| {scale}")
        if not torch.equal(dz, again):
            raise AssertionError(f"ntxent_grad {label}: two runs differ")
        plan = nx.grad_plan(m, 2 * b, d, z.device)
        lp = nx.lse_plan(m, 2 * b, d, z.device)
        ms = {"lse": median_ms(lambda: nx.streaming_lse_cuda(z, v, tau)),
              "lse_twin": median_ms(lambda: nx.streaming_lse_twin(z, v, tau)),
              "grad": median_ms(lambda: nx.ntxent_grad_cuda(
                  z, want, coef, v, tau)),
              "grad_twin": median_ms(lambda: nx.ntxent_grad_twin(
                  z, want, coef, v, tau)),
              "lse_dev": device_ms(lambda: nx.streaming_lse_cuda(z, v, tau),
                                   DEVICE_KERNELS[nx.STATS_LSE.name]),
              "grad_dev": device_ms(lambda: nx.ntxent_grad_cuda(
                  z, want, coef, v, tau), DEVICE_KERNELS[nx.STATS_GRAD.name])}
        n2 = 2 * b
        k_flops, wz_flops = symmetric_gram_flops(m, n2, d)
        executed = 2 * m * n2 * n2 * d * (plan["groups"] + 1)
        lse_executed = lse_executed_flops(lp, m, d)
        grad_bytes = 4 * (2 * m * n2 * d + 2 * m * n2 + n2)
        grad_bound = bound(grad_bytes, k_flops + wz_flops,
                           TF32X3_FLOP_PER_S)[0]
        if i == 0:
            first = [(nx.STATS_LSE.name, ms["lse"], ms["lse_dev"],
                      ms["lse_twin"], 4 * (m * n2 * d + n2 + m * n2), k_flops),
                     (nx.STATS_GRAD.name, ms["grad"], ms["grad_dev"],
                      ms["grad_twin"], grad_bytes, k_flops + wz_flops)]
        if plan["wide"]:
            wide = row(nx.STATS_GRAD_WIDE.name, e_dz, ms["grad"],
                       ms["grad_dev"], ms["grad_twin"], grad_bytes,
                       k_flops + wz_flops, flop_per_s=TF32X3_FLOP_PER_S)
        err_lse = max(err_lse, e_lse)
        err_grad = max(err_grad, e_dz)
        say("ntxent", f"{label} (M={m}, B={b}, d={d}, {n_valid} valid): "
            f"max|lse err| {e_lse:.3e} | max|dz err| {e_dz:.3e} of "
            f"max|dz| {scale:.3e} (bitwise repeats) | lse kernel "
            f"{ms['lse']:.3f} ms, device {ms['lse_dev']:.3f} ms "
            f"({lse_executed / ms['lse_dev'] / 1e9:.1f} executed, "
            f"{k_flops / ms['lse_dev'] / 1e9:.1f} least TFLOP/s; tile "
            f"{lp['tile']}, {lp['pairs']} pairs, {lp['blocks_per_sm']} "
            f"block(s)/SM) twin {ms['lse_twin']:.3f} ms | grad kernel "
            f"{ms['grad']:.3f} ms, device {ms['grad_dev']:.3f} ms "
            f"({executed / ms['grad_dev'] / 1e9:.1f} executed, "
            f"{(k_flops + wz_flops) / ms['grad_dev'] / 1e9:.1f} least "
            f"TFLOP/s; {f32_grad_plan_text(plan)}) bound {grad_bound:.3f} "
            f"ms, share {grad_bound / ms['grad_dev']:.3f}, twin "
            f"{ms['grad_twin']:.3f} ms | sha256 dz {sha256_of(dz)}")
        del z, v, coef, lse, lse_again, want, dz, again, want_dz
        torch.cuda.empty_cache()
    return [row(name, err, *rest, flop_per_s=TF32X3_FLOP_PER_S)
            for (name, *rest), err in zip(first, (err_lse, err_grad))] + [
                wide]


def f32_grad_plan_text(plan):
    """An f32 gradient's launch plan (``ntxent.grad_plan``,
    ``snag_loss.grad_plan``) for a log line."""
    text = (f"{plan['chunks']} chunk(s), depth {plan['depth']}, "
            f"{plan['splits']} split(s), {plan['blocks_per_sm']} block(s)/SM")
    if plan["wide"]:
        text = (f"wide body: {text}, clusters of {plan['cluster']} "
                f"({plan['q']} depth slice(s) a modality), {plan['groups']} "
                f"cluster group(s)")
    return text


def _mixture_inputs(m, b, d, n_valid, seed):
    """Unit rows with near-copy positives and one all-zero modality row,
    unit mixture coefficients, validity of the first n_valid pairs, channel
    coefficients zero on invalid rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, 2 * b, d)).astype(np.float32)
    z[:, b:] = z[:, :b] + 0.5 * z[:, b:]
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[min(1, m - 1), 5] = 0.0                       # an all-zero row
    alpha = np.abs(rng.normal(size=(2 * b, m))).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=1, keepdims=True)
    u = rng.uniform(0.2, 1.0, size=m).astype(np.float32)
    beta = u * u / np.sum(u * u)
    v = np.concatenate([np.arange(b) < n_valid] * 2).astype(np.float32)
    coef = rng.uniform(0.1, 1.0, size=(m + 2, 2 * b)).astype(np.float32) * v
    coef /= max(n_valid, 1)
    return [torch.as_tensor(a, device="cuda") for a in (z, alpha, beta, v, coef)]


def phase_mixture(tau=0.1):
    """Both mixture kernels against their dense twins at the bundle's
    shapes.  lse: atol 1e-5 (rtol 1e-5); dz, dalpha and dbeta: max |err| <=
    1e-4 * max |twin| each; two runs of either give the same bits.  Prints
    the lse's plan (tile, tile pairs, blocks per SM) and both kernels'
    fp32-equivalent TFLOP/s, executed (lse: every tile pair's T^2 products
    per modality; gradient: each group of modalities computes every K_m
    once, then its W z) and least (K_m once per unordered pair of rows, then
    W z for the gradient), and the sha256 of the gradient's outputs.  The
    JSON records: the full M = 4 batch, the main path's shape, and the
    wide body at M = 4, d = 1,600 (``_mixture_wide``)."""
    import torch
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    cap = sl._grad_cap(sl._library(), torch.device("cuda"))
    err_lse = err_grad = 0.0
    for i, (label, m, b, d, n_valid) in enumerate(MIXTURE_SHAPES):
        z, alpha, beta, v, coef = _mixture_inputs(m, b, d, n_valid, SEED + i)
        lse = sl.mixture_lse_cuda(z, alpha, beta, v, tau)
        lse_again = sl.mixture_lse_cuda(z, alpha, beta, v, tau)
        torch.cuda.synchronize()
        want = sl.mixture_lse_twin(z, alpha, beta, v, tau)
        e_lse = (lse - want).abs().max().item()
        if not torch.isfinite(lse).all():
            raise AssertionError(f"mixture_lse {label}: non-finite values")
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
        if not torch.equal(lse, lse_again):
            raise AssertionError(f"mixture_lse {label}: two runs differ")
        got = sl.mixture_grad_cuda(z, alpha, beta, want, coef, v, tau)
        again = sl.mixture_grad_cuda(z, alpha, beta, want, coef, v, tau)
        torch.cuda.synchronize()
        wants = sl.mixture_grad_twin(z, alpha, beta, want, coef, v, tau)
        errs = []
        for part, a, a2, w in zip(("dz", "dalpha", "dbeta"), got, again,
                                  wants):
            e, scale = (a - w).abs().max().item(), w.abs().max().item()
            if not (torch.isfinite(a).all() and e <= 1e-4 * scale):
                raise AssertionError(f"mixture_grad {label} {part}: max|err| "
                                     f"{e} > 1e-4 * max|twin| {scale}")
            if not torch.equal(a, a2):
                raise AssertionError(f"mixture_grad {label} {part}: two runs "
                                     "differ")
            errs.append(e)
        ms = {"lse": median_ms(lambda: sl.mixture_lse_cuda(
                  z, alpha, beta, v, tau)),
              "lse_twin": median_ms(lambda: sl.mixture_lse_twin(
                  z, alpha, beta, v, tau)),
              "grad": median_ms(lambda: sl.mixture_grad_cuda(
                  z, alpha, beta, want, coef, v, tau)),
              "grad_twin": median_ms(lambda: sl.mixture_grad_twin(
                  z, alpha, beta, want, coef, v, tau)),
              "lse_dev": device_ms(lambda: sl.mixture_lse_cuda(
                  z, alpha, beta, v, tau), DEVICE_KERNELS[sl.STATS_LSE.name]),
              "grad_dev": device_ms(lambda: sl.mixture_grad_cuda(
                  z, alpha, beta, want, coef, v, tau),
                  DEVICE_KERNELS[sl.STATS_GRAD.name])}
        n2 = 2 * b
        k_flops, wz_flops = symmetric_gram_flops(m, n2, d)
        mg, _ = sl.modality_group(m, d, cap)
        executed = 2 * n2 * n2 * d * (-(-m // mg) * m + m)
        rates = (f"{executed / ms['grad_dev'] / 1e9:.1f} executed, "
                 f"{(k_flops + wz_flops) / ms['grad_dev'] / 1e9:.1f} least")
        lp = sl.lse_plan(m, n2, d, z.device)
        lse_executed = lse_executed_flops(lp, m, d)
        if i == 0:
            # in z, alpha, beta, v (+ lse, coef); out lse (dz, dalpha, dbeta)
            first = [(sl.STATS_LSE.name, ms["lse"], ms["lse_dev"],
                      ms["lse_twin"],
                      4 * (m * n2 * d + n2 * m + m + n2 + (m + 2) * n2),
                      k_flops),
                     (sl.STATS_GRAD.name, ms["grad"], ms["grad_dev"],
                      ms["grad_twin"],
                      4 * (2 * m * n2 * d + 2 * n2 * m + 2 * m + n2
                           + 2 * (m + 2) * n2), k_flops + wz_flops)]
        err_lse = max(err_lse, e_lse)
        err_grad = max(err_grad, *errs)
        say("mixture", f"{label} (M={m}, B={b}, d={d}, {n_valid} valid): "
            f"max|lse err| {e_lse:.3e} | max|err| dz {errs[0]:.3e} dalpha "
            f"{errs[1]:.3e} dbeta {errs[2]:.3e} of max|twin| "
            f"{[round(w.abs().max().item(), 6) for w in wants]} (bitwise "
            f"repeats) | lse kernel {ms['lse']:.3f} ms, device "
            f"{ms['lse_dev']:.3f} ms ({lse_executed / ms['lse_dev'] / 1e9:.1f}"
            f" executed, {k_flops / ms['lse_dev'] / 1e9:.1f} least TFLOP/s; "
            f"tile "
            f"{lp['tile']}, {lp['pairs']} pairs, {lp['blocks_per_sm']} "
            f"block(s)/SM) twin {ms['lse_twin']:.3f} ms | grad kernel "
            f"{ms['grad']:.3f} ms, device {ms['grad_dev']:.3f} ms "
            f"({rates} TFLOP/s) twin {ms['grad_twin']:.3f} ms | sha256 "
            f"(dz, dalpha, dbeta) {sha256_of(*got)}")
        del z, alpha, beta, v, coef, lse, lse_again, want, got, again, wants
        torch.cuda.empty_cache()
    wide = _mixture_wide(cap, tau)
    return [row(name, err, *rest, flop_per_s=TF32X3_FLOP_PER_S)
            for (name, *rest), err in zip(first, (err_lse, err_grad))] + [
                wide]


def _mixture_wide(cap, tau):
    """The f32 mixture gradient at ``MIXTURE_WIDE``, past one modality's
    fit in its shared accumulator (``cap`` columns): its plan must take the
    wide body, dz, dalpha and dbeta lie within 1e-4 x max |twin| of the
    twin's (fed the twin's lse), and two runs give the same bits; with its
    plan, device ms, executed (each cluster group computes every K_m once)
    and least TFLOP/s, bound and share, the twin's ms on the card and the
    sha256 of its outputs.  Returns the kernels-line record of the first
    shape."""
    import torch
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    records = []
    for label, m, b, d in MIXTURE_WIDE:
        d = d or cap + 8
        z, alpha, beta, v, coef = _mixture_inputs(m, b, d, b, SEED + d)
        plan = sl.grad_plan(m, 2 * b, d, z.device)
        if not plan["wide"]:
            raise AssertionError(f"mixture_grad {label}: not on the wide "
                                 f"body at d = {d} ({plan})")
        lse = sl.mixture_lse_twin(z, alpha, beta, v, tau)
        fn = lambda: sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, tau)
        got = repeat_bitwise(fn, f"mixture_grad {label}")
        wants = sl.mixture_grad_twin(z, alpha, beta, lse, coef, v, tau)
        errs, worst = [], 0.0
        for part, a, w in zip(("dz", "dalpha", "dbeta"), got, wants):
            e, scale = (a - w).abs().max().item(), w.abs().max().item()
            if not (torch.isfinite(a).all() and e <= 1e-4 * scale):
                raise AssertionError(f"mixture_grad {label} {part}: max|err| "
                                     f"{e} > 1e-4 * max|twin| {scale}")
            errs.append(f"{part} {e:.3e} of {scale:.6f}")
            worst = max(worst, e)
        ms = median_ms(fn)
        dev = device_ms(fn, DEVICE_KERNELS[sl.STATS_GRAD_WIDE.name])
        twin = median_ms(lambda: sl.mixture_grad_twin(z, alpha, beta, lse,
                                                      coef, v, tau))
        n2 = 2 * b
        k_flops, wz_flops = symmetric_gram_flops(m, n2, d)
        executed = 2 * n2 * n2 * d * m * (plan["groups"] + 1)
        nbytes = 4 * (2 * m * n2 * d + 2 * n2 * m + 2 * m + n2
                      + 2 * (m + 2) * n2)
        least = bound(nbytes, k_flops + wz_flops, TF32X3_FLOP_PER_S)[0]
        say("mixture", f"{label} (M={m}, B={b}, d={d}, past the cap {cap}): "
            f"{f32_grad_plan_text(plan)} | max|err| {', '.join(errs)} (<= "
            f"1e-4 x max|twin|), bitwise repeat | grad {ms:.3f} ms, device "
            f"{dev:.3f} ms ({executed / dev / 1e9:.1f} executed, "
            f"{(k_flops + wz_flops) / dev / 1e9:.1f} least TFLOP/s) bound "
            f"{least:.3f} ms, share {least / dev:.3f}, twin {twin:.3f} ms | "
            f"sha256 (dz, dalpha, dbeta) {sha256_of(*got)}")
        records.append(row(sl.STATS_GRAD_WIDE.name, worst, ms, dev, twin,
                           nbytes, k_flops + wz_flops,
                           flop_per_s=TF32X3_FLOP_PER_S))
        del z, alpha, beta, v, coef, lse, got, wants
        torch.cuda.empty_cache()
    return records[0]


def plan_text(plan):
    """A gradient's launch plan (``ntxent.grad_plan``,
    ``snag_loss.grad_plan_bf16``) for a log line."""
    text = (f"{plan['chunks']} chunk(s), depth {plan['depth']}, "
            f"{plan['splits']} split(s), {plan['blocks_per_sm']} block(s)/SM")
    if "rows" in plan:
        text += (f", {plan['rows']} rows a block"
                 f"{', resident' if plan['resident'] else ', streamed'}, "
                 f"clusters of {plan['cluster']}")
    return text


def lse_plan_text(plan):
    """An lse kernel's launch plan (``ntxent.lse_plan``,
    ``snag_loss.lse_plan``) for a log line; the bf16 plan also has its
    persistent blocks, ring and warps."""
    text = (f"tile {plan['tile']}, {plan['pairs']} pairs, "
            f"{plan['blocks_per_sm']} block(s)/SM")
    if "blocks" in plan:
        text += (f", {plan['blocks']} persistent blocks of {plan['warps']} "
                 f"warps, {plan['depth']} slots of {plan['slab']} features")
    return text


def lse_executed_flops(plan, pair_channels, d):
    """The flops an lse kernel executes: every tile pair's T^2 products
    over d, for each K channel of a pair (NT-Xent's batches, the
    mixture's modalities)."""
    return 2 * pair_channels * plan["pairs"] * plan["tile"] ** 2 * d


def bf16_grad_k_products(plan, mix):
    """How many times the bf16 gradient computes each K_m: once per block
    where the rows stay resident (one chunk) or a cluster splits them, once
    per chunk where they stream."""
    if plan["resident"] or (not mix and plan["cluster"] > 1):
        return 1
    return plan["chunks"]


def phase_loss_bf16(tau=0.1):
    """The four bf16 loss entries against their bf16 twins on CPU copies
    at the main path's shapes: NT-Xent at IIR (M = 4, B = 3,500, d = 300)
    and the mixture at M = 4 with the full batch, on the inputs of the
    f32 phases with z rounded to bf16; also NT-Xent at MEAformer's joint
    shape (M = 1, d = 1,200).  Each output within ``BF16_TOL`` x max
    |twin|; two runs give the same bits.  Prints the plans and the
    TFLOP/s, executed and least, as the f32 phases do, and the registers
    and spills of the two gradient kernels (``csrc/gram_grad_bf16.cuh``);
    the bound is the bf16 dense rate; and the lse kernels' plans (persistent
    blocks over tile pairs, ``csrc/gram_lse_bf16.cuh``), registers and
    spills.  The mixture gradient reads each positive pair's K and W_tot
    from ``mixture_kpos_bf16`` (the exact dot, and W_tot in f64, each
    rounded once to bf16), as its twin does.  Returns the JSON records of
    the four kernels."""
    import torch
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    bf = torch.bfloat16
    for lib in (nx._library(), sl._library()):
        for name, regs, st, ld in kernel_ptxas(
                lib, ("grad_bf16", "lse_bf16", "kpos_bf16")):
            say("loss_bf16", f"ptxas {name}: {regs} registers, spill stores "
                f"{st} B, loads {ld} B")
    label, m, b, d, n_valid = NTXENT_SHAPES[0]
    z, v, coef = _ntxent_inputs(m, b, d, n_valid, SEED)
    z = z.to(bf)
    lse = repeat_bitwise(lambda: [nx.streaming_lse_cuda(z, v, tau)],
                         "ntxent_lse_bf16")[0]
    dz = repeat_bitwise(lambda: [nx.ntxent_grad_cuda(z, lse, coef, v, tau)],
                        "ntxent_grad_bf16")[0]
    e_lse, = bf16_errors("ntxent_lse_bf16", [lse], on_cpu(
        lambda *a: [nx.streaming_lse_twin(*a)], z, v, tau))
    e_dz, = bf16_errors("ntxent_grad_bf16", [dz], on_cpu(
        lambda *a: [nx.ntxent_grad_twin(*a)], z, lse, coef, v, tau))
    n2 = 2 * b
    k_flops, wz_flops = symmetric_gram_flops(m, n2, d)
    plan = nx.grad_plan(m, n2, d, z.device, bf)
    lp = nx.lse_plan(m, n2, d, z.device, bf)
    t = {"lse": median_ms(lambda: nx.streaming_lse_cuda(z, v, tau)),
         "lse_dev": device_ms(lambda: nx.streaming_lse_cuda(z, v, tau),
                              DEVICE_KERNELS[nx.STATS_LSE_BF16.name]),
         "lse_twin": median_ms(lambda: nx.streaming_lse_twin(z, v, tau)),
         "grad": median_ms(lambda: nx.ntxent_grad_cuda(z, lse, coef, v, tau)),
         "grad_dev": device_ms(lambda: nx.ntxent_grad_cuda(
             z, lse, coef, v, tau), DEVICE_KERNELS[nx.STATS_GRAD_BF16.name]),
         "grad_twin": median_ms(lambda: nx.ntxent_grad_twin(
             z, lse, coef, v, tau))}
    executed = 2 * m * n2 * n2 * d * (bf16_grad_k_products(plan, False) + 1)
    say("loss_bf16", f"ntxent {label} (M={m}, B={b}, d={d}): max|lse err| "
        f"{e_lse:.3e} | max|dz err| {e_dz:.3e} of max|dz| "
        f"{dz.abs().max().item():.3e} (<= {BF16_TOL} x max, bitwise repeats)"
        f" | lse kernel {t['lse']:.3f} ms, device {t['lse_dev']:.3f} ms "
        f"({lse_executed_flops(lp, m, d) / t['lse_dev'] / 1e9:.1f} executed, "
        f"{k_flops / t['lse_dev'] / 1e9:.1f} least TFLOP/s; "
        f"{lse_plan_text(lp)}) twin {t['lse_twin']:.3f} ms | grad kernel "
        f"{t['grad']:.3f} ms, device {t['grad_dev']:.3f} ms "
        f"({executed / t['grad_dev'] / 1e9:.1f} executed, "
        f"{(k_flops + wz_flops) / t['grad_dev'] / 1e9:.1f} least TFLOP/s; "
        f"{plan_text(plan)}) twin {t['grad_twin']:.3f} ms")
    rows = [row(nx.STATS_LSE_BF16.name, e_lse, t["lse"], t["lse_dev"],
                t["lse_twin"], 2 * m * n2 * d + 4 * (n2 + m * n2), k_flops,
                flop_per_s=BF16_FLOP_PER_S),
            row(nx.STATS_GRAD_BF16.name, e_dz, t["grad"], t["grad_dev"],
                t["grad_twin"], 2 * m * n2 * d + 4 * (m * n2 * d + 2 * m * n2
                                                      + n2),
                k_flops + wz_flops, flop_per_s=BF16_FLOP_PER_S)]
    del z, v, coef, lse, dz
    torch.cuda.empty_cache()
    # MEAformer's joint loss in bf16 (M = 1 at d = 1,200): held and timed,
    # not in the JSON record
    label, m, b, d, n_valid = next(s for s in NTXENT_SHAPES
                                   if s[0] == "MEAformer joint")
    z, v, coef = _ntxent_inputs(m, b, d, n_valid, SEED + 4)
    z = z.to(bf)
    lse = repeat_bitwise(lambda: [nx.streaming_lse_cuda(z, v, tau)],
                         "ntxent_lse_bf16")[0]
    dz = repeat_bitwise(lambda: [nx.ntxent_grad_cuda(z, lse, coef, v, tau)],
                        "ntxent_grad_bf16")[0]
    e_lse, = bf16_errors(f"ntxent_lse_bf16 {label}", [lse], on_cpu(
        lambda *a: [nx.streaming_lse_twin(*a)], z, v, tau))
    e_dz, = bf16_errors(f"ntxent_grad_bf16 {label}", [dz], on_cpu(
        lambda *a: [nx.ntxent_grad_twin(*a)], z, lse, coef, v, tau))
    plan = nx.grad_plan(m, 2 * b, d, z.device, bf)
    lp = nx.lse_plan(m, 2 * b, d, z.device, bf)
    lse_dev = device_ms(lambda: nx.streaming_lse_cuda(z, v, tau),
                        DEVICE_KERNELS[nx.STATS_LSE_BF16.name])
    grad_dev = device_ms(lambda: nx.ntxent_grad_cuda(z, lse, coef, v, tau),
                         DEVICE_KERNELS[nx.STATS_GRAD_BF16.name])
    say("loss_bf16", f"ntxent {label} (M={m}, B={b}, d={d}): max|lse err| "
        f"{e_lse:.3e} | max|dz err| {e_dz:.3e} of max|dz| "
        f"{dz.abs().max().item():.3e} (<= {BF16_TOL} x max, bitwise repeats)"
        f" | lse device {lse_dev:.3f} ms ({lse_plan_text(lp)}) | grad "
        f"device {grad_dev:.3f} ms ({plan_text(plan)})")
    del z, v, coef, lse, dz
    torch.cuda.empty_cache()
    first = None
    for i, (label, m, b, d, n_valid) in enumerate(MIXTURE_SHAPES[:1]):
        z, alpha, beta, v, coef = _mixture_inputs(m, b, d, n_valid, SEED + i)
        z = z.to(bf)
        lse = repeat_bitwise(lambda: [sl.mixture_lse_cuda(z, alpha, beta, v,
                                                          tau)],
                             "mixture_lse_bf16")[0]
        got = repeat_bitwise(lambda: sl.mixture_grad_cuda(
            z, alpha, beta, lse, coef, v, tau), "mixture_grad_bf16")
        e_lse, = bf16_errors("mixture_lse_bf16", [lse], on_cpu(
            lambda *a: [sl.mixture_lse_twin(*a)], z, alpha, beta, v, tau))
        errs = bf16_errors("mixture_grad_bf16", got, on_cpu(
            sl.mixture_grad_twin, z, alpha, beta, lse, coef, v, tau))
        t = {"lse": median_ms(lambda: sl.mixture_lse_cuda(
                 z, alpha, beta, v, tau)),
             "lse_dev": device_ms(lambda: sl.mixture_lse_cuda(
                 z, alpha, beta, v, tau),
                 DEVICE_KERNELS[sl.STATS_LSE_BF16.name]),
             "lse_twin": median_ms(lambda: sl.mixture_lse_twin(
                 z, alpha, beta, v, tau)),
             "grad": median_ms(lambda: sl.mixture_grad_cuda(
                 z, alpha, beta, lse, coef, v, tau)),
             "grad_dev": device_ms(lambda: sl.mixture_grad_cuda(
                 z, alpha, beta, lse, coef, v, tau),
                 DEVICE_KERNELS[sl.STATS_GRAD_BF16.name]),
             "grad_twin": median_ms(lambda: sl.mixture_grad_twin(
                 z, alpha, beta, lse, coef, v, tau))}
        n2 = 2 * b
        k_flops, wz_flops = symmetric_gram_flops(m, n2, d)
        # each modality's block computes its own K_m, which its cluster
        # shares
        plan = sl.grad_plan_bf16(m, n2, d, z.device)
        lp = sl.lse_plan(m, n2, d, z.device, bf)
        executed = 2 * n2 * n2 * d * m * (bf16_grad_k_products(plan, True) + 1)
        say("loss_bf16", f"mixture {label} (M={m}, B={b}, d={d}, {n_valid} "
            f"valid): max|lse err| {e_lse:.3e} | max|err| dz {errs[0]:.3e} "
            f"dalpha {errs[1]:.3e} dbeta {errs[2]:.3e} (<= {BF16_TOL} x max,"
            f" bitwise repeats) | lse kernel {t['lse']:.3f} ms, device "
            f"{t['lse_dev']:.3f} ms "
            f"({lse_executed_flops(lp, m, d) / t['lse_dev'] / 1e9:.1f} "
            f"executed, {k_flops / t['lse_dev'] / 1e9:.1f} least TFLOP/s; "
            f"{lse_plan_text(lp)}) twin {t['lse_twin']:.3f} ms | grad kernel "
            f"{t['grad']:.3f} ms, device {t['grad_dev']:.3f} ms "
            f"({executed / t['grad_dev'] / 1e9:.1f} executed, "
            f"{(k_flops + wz_flops) / t['grad_dev'] / 1e9:.1f} least "
            f"TFLOP/s; {plan_text(plan)}) twin {t['grad_twin']:.3f} ms")
        if first is None:
            # in z, alpha, beta, v (+ lse, coef); out lse (dz, dalpha, dbeta)
            first = [row(sl.STATS_LSE_BF16.name, e_lse, t["lse"],
                         t["lse_dev"], t["lse_twin"],
                         2 * m * n2 * d + 4 * (n2 * m + m + n2
                                               + (m + 2) * n2), k_flops,
                         flop_per_s=BF16_FLOP_PER_S),
                     row(sl.STATS_GRAD_BF16.name, max(errs), t["grad"],
                         t["grad_dev"], t["grad_twin"],
                         2 * m * n2 * d + 4 * (m * n2 * d + 2 * n2 * m + 2 * m
                                               + n2 + 2 * (m + 2) * n2),
                         k_flops + wz_flops, flop_per_s=BF16_FLOP_PER_S)]
        del z, alpha, beta, v, coef, lse, got
        torch.cuda.empty_cache()
    return rows + first


def segment_inputs(graph_np, c=300, h=1):
    """The bench graph on the card and seeded (x, e, e[rev], g_agg) of the
    weighted segment sum: e is the GCN's adjacency w as one head at h = 1,
    else seeded weights (E, h); the backward launch runs on g_agg (N, c)
    with e[rev].  ``scripts/torch_grad_ab.py`` times the kernel on these."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    n = graph_np.n_nodes
    g = graph_np.to_torch(dev)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, g_agg = t(n, c), t(n, c)
    e = (g.w[:, None] if h == 1 else torch.as_tensor(
        rng.uniform(0.1, 2.0, size=(g.n_edges, h)).astype(np.float32),
        device=dev))
    return g, x, e, e[g.rev].contiguous(), g_agg


def segment_ptxas(lib):
    """(name, registers, spill store bytes, spill load bytes) of
    ``weighted_segment_sum_kernel<HB, VEC, G>`` at <1, 4, 3> (C = 300, one
    head), <1, 1, 4> (single floats) and <4, 4, 4> (the most registers)."""
    return kernel_ptxas(lib, tuple(
        f"weighted_segment_sum_kernelILi{hb}ELi{vec}ELi{g}E"
        for hb, vec, g in ((1, 4, 3), (1, 1, 4), (4, 4, 4))))


def phase_segment(graph_np):
    """The weighted segment sum at the bench graph with the GCN's weights
    (H = 1): forward against its ``index_add_`` twin and the backward's
    reverse-edge launch (on ``w_rev``, which the GCN's backward uses)
    against the plain column reduction, rtol = atol = 1e-5, each with a
    bitwise repeat; the registers and spills of its instantiations, and the
    GB/s of the x rows it gathers (E C 4 bytes over its device time);
    ``torch.sparse.mm`` of the CSR adjacency with x, which computes the
    same aggregate, is the library yardstick."""
    import torch
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    for name, regs, st, ld in segment_ptxas(ts._library()):
        say("segment", f"ptxas {name}: {regs} registers, spill stores {st} "
            f"B, loads {ld} B")
    g, x, e, e_rev, g_agg = segment_inputs(graph_np)
    (n, c), m_e = x.shape, g.n_edges
    if not torch.equal(g.w_rev[:, None], e_rev):
        raise AssertionError("DeviceGraph.w_rev differs from w[rev]")
    e_rev = g.w_rev[:, None]
    names = DEVICE_KERNELS[ts.STATS.name]

    def fwd():
        return ts.weighted_segment_sum_cuda(x, e, g)

    def bwd():
        return ts.weighted_segment_sum_cuda(g_agg, e_rev, g)
    agg, rs = repeat_bitwise(fwd, "segment forward")
    d_x, _ = repeat_bitwise(bwd, "segment backward launch")
    want_agg, want_rs = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    want_dx = torch.zeros_like(x).cpu().index_add_(
        0, g.col.long().cpu(), (e * g_agg[g.row]).cpu()).cuda()
    errs = [(agg - want_agg).abs().max().item(),
            (rs - want_rs).abs().max().item(),
            (d_x[:, 0] - want_dx).abs().max().item()]
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_x[:, 0], want_dx, rtol=1e-5, atol=1e-5)
    adj = torch.sparse_csr_tensor(g.row_ptr, g.col, g.w, (n, n))
    lib = torch.sparse.mm(adj, x)
    torch.testing.assert_close(lib, agg[:, 0], rtol=1e-5, atol=1e-5)
    ms, ms_bwd = median_ms(fwd), median_ms(bwd)
    dev, dev_bwd = device_ms(fwd, names), device_ms(bwd, names)
    plain = median_ms(lambda: ts.weighted_segment_sum_twin(x, e, g))
    library = median_ms(lambda: torch.sparse.mm(adj, x))
    plan = ts.launch_plan(c, 1, 4)
    say("segment", f"N={n} E={m_e} C={c} H=1: max|err| agg "
        f"{errs[0]:.3e} rowsum {errs[1]:.3e} d_x {errs[2]:.3e} "
        f"(rtol=atol=1e-5), bitwise repeats | plan {plan} | kernel {ms:.4f}"
        f" ms, device {dev:.4f} ms ({m_e * c * 4 / dev / 1e6:.1f} GB/s of x "
        f"rows gathered) | backward launch {ms_bwd:.4f} ms, device "
        f"{dev_bwd:.4f} ms ({m_e * c * 4 / dev_bwd / 1e6:.1f} GB/s) | twin "
        f"{plain:.4f} ms torch.sparse.mm {library:.4f} ms")
    return row(ts.STATS.name, max(errs), ms, dev, plain,
               4 * (n * c + m_e + n + 1 + m_e + n * c + n), 2 * m_e * c,
               library)


def segment_bf16_ptxas(lib):
    """(label, registers, spill store bytes, spill load bytes) of
    ``weighted_segment_sum_bf16_kernel<HB, VEC, G, ROUND_TERM>`` at C = 300,
    one head, forward and ``round_term`` (<1, 4, 5>), at <1, 1, 5> (single
    bf16, C = 319) and <4, 4, 5> (the most registers)."""
    out = []
    for hb, vec, g, rt in ((1, 4, 5, 0), (1, 4, 5, 1), (1, 1, 5, 0),
                           (4, 4, 5, 1)):
        pattern = (f"weighted_segment_sum_bf16_kernelILi{hb}ELi{vec}ELi{g}"
                   f"ELb{rt}E")
        for _, regs, st, ld in kernel_ptxas(lib, (pattern,)):
            out.append((f"weighted_segment_sum_bf16_kernel<{hb},{vec},{g},"
                        f"{'true' if rt else 'false'}>", regs, st, ld))
    return out


def segment_bf16_inputs(graph_np):
    """``segment_inputs`` at C = 300, H = 1 in bf16: (graph, x, e, e[rev],
    g_agg) with e the bf16 adjacency ``w_bf16`` and e[rev] ``w_rev_bf16``,
    which the bf16 GCN's forward and backward take."""
    import torch
    g, x, e, e_rev, g_agg = segment_inputs(graph_np)
    bf = torch.bfloat16
    if not (torch.equal(g.w_bf16[:, None], e.to(bf))
            and torch.equal(g.w_rev_bf16[:, None], e_rev.to(bf))):
        raise AssertionError("DeviceGraph.w_bf16 or w_rev_bf16 differs from "
                             "w or w[rev] rounded to bf16")
    return g, x.to(bf), g.w_bf16[:, None], g.w_rev_bf16[:, None], g_agg.to(bf)


def sha256_of(*tensors) -> str:
    """The sha256 of the tensors' bytes (a bf16 tensor's bits)."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                 .numpy().tobytes())
    return h.hexdigest()


def phase_segment_bf16(graph_np):
    """The bf16 entry at the bench graph with the bf16 GCN's weights
    (H = 1): the forward and the backward's reverse-edge launch as the GCN
    runs it (on ``w_rev_bf16``, each term rounded to bf16, d_x written in
    bf16 and no rowsum) against the twin on CPU copies, within ``BF16_TOL``
    x max |twin| and rtol = atol = 1e-5 (sums of terms both sides form
    alike, in CSR order), each with a bitwise repeat and its sha256;
    registers and spills, the GB/s of the bf16 x rows it gathers (E C 2
    bytes over its device time), each launch's bound from its own bytes,
    and ``torch.sparse.mm`` on the bf16 CSR adjacency as the library
    yardstick where cuSPARSE takes bf16."""
    import torch
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    for name, regs, st, ld in segment_bf16_ptxas(ts._library()):
        say("segment_bf16", f"ptxas {name}: {regs} registers, spill stores "
            f"{st} B, loads {ld} B")
    g, x, e, e_rev, g_agg = segment_bf16_inputs(graph_np)
    (n, c), m_e = x.shape, g.n_edges
    names = DEVICE_KERNELS[ts.STATS_BF16.name]

    def fwd():
        return ts.weighted_segment_sum_cuda(x, e, g)

    def bwd():
        return ts.weighted_segment_sum_cuda(g_agg, e_rev, g, round_term=True,
                                            out_bf16=True)

    def twin_bwd(*args):
        return ts.weighted_segment_sum_twin(*args, round_term=True,
                                            out_bf16=True)[:1]
    got = repeat_bitwise(fwd, "segment_bf16 forward")
    got_bwd = repeat_bitwise(bwd, "segment_bf16 backward launch")
    want = on_cpu(ts.weighted_segment_sum_twin, x, e, g)
    want_bwd = on_cpu(twin_bwd, g_agg, e_rev, g)
    errs = bf16_errors("weighted_segment_sum_bf16", [*got, got_bwd[0]],
                       [*want, want_bwd[0]])
    for a, w in zip((*got, got_bwd[0]), (*want, want_bwd[0])):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    ms, ms_bwd = median_ms(fwd), median_ms(bwd)
    dev, dev_bwd = device_ms(fwd, names), device_ms(bwd, names)
    plain = median_ms(lambda: ts.weighted_segment_sum_twin(x, e, g))
    adj = torch.sparse_csr_tensor(g.row_ptr, g.col, g.w_bf16, (n, n))
    try:
        lib_out = torch.sparse.mm(adj, x)
        lib_err = (lib_out.float() - want[0][:, 0]).abs().max().item()
        library = median_ms(lambda: torch.sparse.mm(adj, x))
        lib_text = (f"torch.sparse.mm (bf16 CSR) {library:.4f} ms, max|err| "
                    f"{lib_err:.3e} (its output is bf16)")
    except (RuntimeError, NotImplementedError) as err:
        library = None
        lib_text = (f"torch.sparse.mm on the bf16 CSR adjacency raised: "
                    f"{str(err).splitlines()[0][:160]}")
    plan = ts.launch_plan(c, 1, 4, bf16=True)
    # x, e, row_ptr, col read once; agg and rowsum written once (forward),
    # d_x in bf16 (backward launch)
    nbytes = 2 * n * c + 2 * m_e + 4 * (n + 1) + 4 * m_e + 4 * n * c + 4 * n
    nbytes_bwd = 2 * n * c + 2 * m_e + 4 * (n + 1) + 4 * m_e + 2 * n * c
    bound_fwd, bound_bwd = (bound(b, 2 * m_e * c)[0]
                            for b in (nbytes, nbytes_bwd))
    say("segment_bf16", f"N={n} E={m_e} C={c} H=1: max|err| agg "
        f"{errs[0]:.3e} rowsum {errs[1]:.3e} backward d_x {errs[2]:.3e} "
        f"(limit {BF16_TOL} x max|twin|; rtol=atol=1e-5 held), bitwise "
        f"repeats | plan {plan} | twin {plain:.4f} ms | {lib_text}")
    say("segment_bf16", f"forward: kernel {ms:.4f} ms, device {dev:.4f} ms "
        f"({m_e * c * 2 / dev / 1e6:.1f} GB/s of bf16 x rows gathered), "
        f"bound {bound_fwd:.5f} ms ({nbytes / 1e6:.1f} MB), share "
        f"{bound_fwd / dev:.3f} | sha256 agg, rowsum {sha256_of(got[0])}, "
        f"{sha256_of(got[1])}")
    say("segment_bf16", f"backward launch (bf16 d_x, no rowsum): kernel "
        f"{ms_bwd:.4f} ms, device {dev_bwd:.4f} ms "
        f"({m_e * c * 2 / dev_bwd / 1e6:.1f} GB/s), bound {bound_bwd:.5f} ms "
        f"({nbytes_bwd / 1e6:.1f} MB), share {bound_bwd / dev_bwd:.3f} | "
        f"sha256 d_x {sha256_of(got_bwd[0])}")
    return row(ts.STATS_BF16.name, max(errs), ms, dev, plain, nbytes,
               2 * m_e * c, library)


def phase_small():
    """A small input through the port on the GPU and on the CPU (twins)."""
    import numpy as np
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.train.runner import Runner
    from snag_tpu_torch.utils.logging import create_logger
    out = {}
    data = None
    for device in ("cuda", "cpu"):
        cfg = cfg_from(SMALL_ARGS + ["--device", device, "--data_path",
                                     str(WORK / "small"), "--exp_name", "small"])
        if data is None:
            data = load_data(cfg)
        runner = Runner(cfg, create_logger(name=f"small_{device}"), data=data)
        joint, _ = runner._joint_emb()
        res = runner.evaluate(last_epoch=True, save_name=device)
        out[device] = (joint.cpu(), res)
    (jg, rg), (jc, rc) = out["cuda"], out["cpu"]
    err = (jg - jc).abs().max().item()
    agree = float(np.mean(rg.ranks_l2r == rc.ranks_l2r))
    say("small", f"{len(rg.ranks_l2r)} test pairs: max|joint_emb gpu-cpu| "
        f"{err:.3e}, ranks equal on {agree:.4f}, MRR gpu {rg.mrr_l2r:.6f} "
        f"cpu {rc.mrr_l2r:.6f}")
    torch.testing.assert_close(jg, jc, rtol=1e-4, atol=1e-4)
    if agree < 0.99 or abs(rg.mrr_l2r - rc.mrr_l2r) > 1e-3:
        raise AssertionError("GPU and CPU evaluation disagree")


def phase_train_small(label, extra):
    """Three deterministic train steps (no noise, no dropout) from the same
    init and batches on the GPU (kernels) and on the CPU (twins): losses
    within rel 1e-4, parameters within atol 1e-5.  All six modalities are
    active: with four, two weight_raw slots have a gradient that is zero
    in exact arithmetic and Adam turns its rounding noise into a step of
    either sign.  Returns the CPU losses."""
    import numpy as np
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.models.encoder import place_features
    from snag_tpu_torch.train.step import TrainStep
    cfg = cfg_from(SMALL_ARGS + ["--use_surface", "1", "--char_dim", "64",
                                 "--name_dim", "64", "--add_noise", "0",
                                 "--lr", "5e-4", "--scheduler", "cos",
                                 "--device", "cpu"] + extra)
    data = load_data(cfg)
    b = 128
    batches = []
    for k in range(0, 3 * b, b):      # the third batch is padded
        chunk = data.train_ill[k:k + b]
        links = np.zeros((b, 2), dtype=np.int64)
        links[:len(chunk)] = chunk
        batches.append((links, np.arange(b) < len(chunk)))
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, data, torch.Generator().manual_seed(SEED))
        model = model.to(device)
        feats = place_features(cfg, data, device)[0]
        graph = data.graph.to_torch(device)
        step = TrainStep(cfg, model, cfg.lr, 20, 3)
        losses = [step(torch.as_tensor(l, device=device),
                       torch.as_tensor(v, device=device), feats, graph,
                       epoch=0, deterministic=True)[0].item()
                  for l, v in batches]
        out[device] = (losses, {k: p.detach().cpu()
                                for k, p in model.state_dict().items()})
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    rel = max(abs(a - c) / abs(c) for a, c in zip(lg, lc))
    perr = max((pg[k] - pc[k]).abs().max().item() for k in pc)
    say("train_small", f"{label}: {data.ent_num} entities, 3 steps of {b}: "
        f"losses gpu {lg} cpu {lc} (max rel diff {rel:.2e}, limit 1e-4) | "
        f"max|param gpu-cpu| {perr:.2e} (limit 1e-5)")
    if rel > 1e-4 or perr > 1e-5:
        raise AssertionError(f"{label}: GPU and CPU training steps disagree")
    return lc


def phase_train_small_bf16():
    """``--dtype bfloat16``, fused loss, all six modalities: step 0's loss
    and every parameter gradient, then the losses of three deterministic
    steps, on the GPU (bf16 kernels) against the CPU (bf16 twins), at the
    limits of tests/test_torch_bf16.py: loss rel 1e-3, gradients max |err|
    <= 1e-2 x max |CPU| over each optimizer group, three losses rel 1e-2."""
    import copy
    import numpy as np
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.models.encoder import place_features
    from snag_tpu_torch.train.optim import param_label
    from snag_tpu_torch.train.step import TrainStep
    cfg = cfg_from(SMALL_ARGS + ["--use_surface", "1", "--char_dim", "64",
                                 "--name_dim", "64", "--add_noise", "0",
                                 "--lr", "5e-4", "--scheduler", "cos",
                                 "--fused_snag_loss", "1", "--device", "cpu"]
                   + BF16)
    data = load_data(cfg)
    b = 128
    batches = []
    for k in range(0, 3 * b, b):      # the third batch is padded
        chunk = data.train_ill[k:k + b]
        links = np.zeros((b, 2), dtype=np.int64)
        links[:len(chunk)] = chunk
        batches.append((links, np.arange(b) < len(chunk)))
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, data, torch.Generator().manual_seed(SEED))
        model = model.to(device)
        feats = place_features(cfg, data, device)[0]
        graph = data.graph.to_torch(device)
        links, valid = (torch.as_tensor(a, device=device) for a in batches[0])
        probe = copy.deepcopy(model)
        loss0, _ = probe(links, valid, feats, graph)
        loss0.backward()
        grads = {k: p.grad.detach().cpu() for k, p in
                 probe.named_parameters()}
        step = TrainStep(cfg, model, cfg.lr, 20, 3)
        losses = [step(torch.as_tensor(l, device=device),
                       torch.as_tensor(v, device=device), feats, graph,
                       epoch=0, deterministic=True)[0].item()
                  for l, v in batches]
        out[device] = (loss0.item(), grads, losses)
    (l0g, gg, lg), (l0c, gc, lc) = out["cuda"], out["cpu"]
    scale, err = {}, {}
    for k, w in gc.items():
        label = param_label(k)
        scale[label] = max(scale.get(label, 0.0), w.abs().max().item())
        err[label] = max(err.get(label, 0.0), (gg[k] - w).abs().max().item())
    rel0 = abs(l0g - l0c) / abs(l0c)
    rel = max(abs(a - c) / abs(c) for a, c in zip(lg, lc))
    say("train_small_bf16", f"{data.ent_num} entities, batch {b}: step-0 "
        f"loss gpu {l0g} cpu {l0c} (rel {rel0:.2e}, limit 1e-3) | gradients"
        f" max|gpu-cpu| / max|cpu| by group "
        f"{ {k: round(err[k] / scale[k], 6) for k in err} } (limit 1e-2) | "
        f"three steps' losses gpu {lg} cpu {lc} (max rel {rel:.2e}, limit "
        f"1e-2)")
    if rel0 > 1e-3 or rel > 1e-2 or any(err[k] > 1e-2 * scale[k]
                                         for k in err):
        raise AssertionError("bf16 GPU and CPU training steps disagree")


def phase_train_small_all():
    """The fused and the unfused loss, and the GCN encoder; the fused and
    unfused losses must agree within rel 1e-4."""
    fused = phase_train_small("fused loss", ["--fused_snag_loss", "1"])
    unfused = phase_train_small("unfused loss", ["--fused_snag_loss", "0"])
    phase_train_small("gcn", ["--structure_encoder", "gcn",
                              "--fused_snag_loss", "1"])
    rel = max(abs(a - c) / abs(c) for a, c in zip(fused, unfused))
    say("train_small", f"fused vs unfused losses: max rel diff {rel:.2e} "
        "(limit 1e-4)")
    if rel > 1e-4:
        raise AssertionError(f"fused and unfused losses differ: {fused} "
                             f"{unfused}")


def _seeded_checkpoint(args, data, name):
    """A seeded random init of the model ``args`` builds, saved as a
    reference ``.pkl``."""
    import torch
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.utils.import_reference import save_reference_checkpoint
    model = build_model(cfg_from(args + ["--device", "cpu"]), data,
                        torch.Generator().manual_seed(SEED))
    return save_reference_checkpoint(model, str(WORK / name))


def _serve(phase, args, pkl, expected, check=None):
    """``main`` with ``--only_test 1`` from ``pkl``; then a second request;
    then ``check(runner)`` if given.  Returns the launches of the first."""
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    argv = args + ["--only_test", "1", "--device", "cuda",
                   "--model_name_save", pkl, "--data_path",
                   str(WORK / phase), "--exp_name", f"chip_smoke_{phase}"]
    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernel_stats()
    cold = dict(runner.timings)
    res = runner.last_result
    n_test = len(runner.test_left)
    with open(runner.pred_path) as f:
        lines = list(csv.reader(f))
    runner.evaluate(last_epoch=True, save_name="warm")   # a second request
    warm = dict(runner.timings)
    metrics = [*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l]
    say(phase, f"{runner.data.ent_num} entities, {runner.graph.n_edges} "
        f"edges, {n_test} test pairs | first request: embed "
        f"{cold['embed_s']:.4f} s eval {cold['eval_s']:.4f} s | second: embed "
        f"{warm['embed_s']:.4f} s eval {warm['eval_s']:.4f} s | main() "
        f"{wall:.1f} s")
    say(phase, f"Hits@1/10/50 l2r {list(res.acc_l2r)} r2l "
        f"{list(res.acc_r2l)} MRR l2r {res.mrr_l2r:.6f} r2l "
        f"{res.mrr_r2l:.6f} | launches/twin calls {stats}")
    if (runner.data.ent_num, runner.graph.n_edges, n_test) != (30000, 329862, 10500):
        raise AssertionError(f"{phase} geometry differs from the bench geometry")
    SERVED[phase] = res
    if not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics):
        raise AssertionError(f"metrics out of range: {metrics}")
    if len(lines) != n_test + 1:
        raise AssertionError(f"top-3 CSV has {len(lines)} lines")
    check_launches(phase, stats, expected)
    if check is not None:
        check(runner)
    return {name: launches for name, (launches, _) in stats.items()}


def phase_slice(data):
    """Serving from a seeded init: the GAT forward and the rank kernels."""
    pkl = _seeded_checkpoint(BENCH_ARGS, data, "seeded_init.pkl")
    return _serve("slice", BENCH_ARGS, pkl, SERVING_KERNELS)


def _train(phase, argv, expected, promotion, check=None):
    """``main`` training run: losses finite and falling, metrics in [0, 1],
    IL promotion adding pairs when ``promotion``; the kernels of
    ``expected`` launched and no other; then ``check(runner)`` if given.
    Returns the launches."""
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    argv = argv + ["--device", "cuda", "--data_path", str(WORK / phase),
                   "--exp_name", f"chip_smoke_{phase}", "--no_tensorboard"]
    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernel_stats()
    losses = runner.loss_log.loss[1:]
    res = runner.last_result
    metrics = [*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l]
    steps = runner.step_ms
    # the first epoch's steps pay one-off start-up; the warm median is
    # taken over the steps after it
    per_epoch0 = -(-len(runner.data.train_ill) // runner.cfg.batch_size)
    warm = steps[per_epoch0:]
    say(phase, f"{len(losses)} epochs, {len(steps)} steps, main() "
        f"{wall:.1f} s | epoch losses {[round(x, 4) for x in losses]}")
    say(phase, f"promoted {runner.promoted} pairs, train pairs "
        f"{len(runner.data.train_ill)} -> {len(runner.train_ill)} | final "
        f"Hits@1/10/50 l2r {res.acc_l2r.tolist()} MRR l2r {res.mrr_l2r:.6f} "
        f"r2l {res.mrr_r2l:.6f}")
    WARM_STEP_MS[phase] = statistics.median(warm)
    say(phase, f"step ms (device, CUDA events): median warm "
        f"{WARM_STEP_MS[phase]:.3f} over {len(warm)} steps, first "
        f"{steps[0]:.3f} | launches/twin calls {stats}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if promotion and (not runner.promoted or sum(runner.promoted) <= 0):
        raise AssertionError(f"IL promotion added no pairs: {runner.promoted}")
    if not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics):
        raise AssertionError(f"metrics out of range: {metrics}")
    check_launches(phase, stats, expected)
    if check is not None:
        check(runner)
    return {name: launches for name, (launches, _) in stats.items()}


def f32_kernels():
    """The f32 kernels of the main path's shapes (the wide instantiations
    apart)."""
    from snag_tpu_torch.ops import cuda as kernels
    return (set(kernels.all_stats()) - BF16_KERNELS - {SEGMENT_BF16}
            - WIDE_KERNELS)


def phase_train():
    """The training path at the bench geometry through the CLI entry, with
    the default fused loss: every f32 kernel but the segment sum launches."""
    return _train("train", BENCH_ARGS + TRAIN_ARGS,
                  f32_kernels() - {SEGMENT_KERNEL}, promotion=True)


def phase_train_bf16():
    """The same training run with ``--dtype bfloat16``: every bf16 entry
    and both rank sweeps launch, no f32 GAT or loss kernel does."""
    launches = _train("train_bf16", BENCH_ARGS + TRAIN_ARGS + BF16,
                      BF16_KERNELS | RANK_KERNELS, promotion=True)
    say("train_bf16", f"median warm step: bf16 "
        f"{WARM_STEP_MS['train_bf16']:.3f} ms, f32 (phase train) "
        f"{WARM_STEP_MS['train']:.3f} ms")
    return launches


def phase_slice_bf16(data):
    """Serving a bf16 configuration from a seeded init: the bf16 GAT
    forward and the two f32 rank sweeps (the joint embedding is f32)."""
    args = BENCH_ARGS + BF16
    pkl = _seeded_checkpoint(args, data, "seeded_init_bf16.pkl")
    return _serve("slice_bf16", args, pkl,
                  {"gat_attention_fwd_bf16"} | RANK_KERNELS)


def phase_gcn(data):
    """The GCN encoder at the bench geometry: serving from a seeded init,
    then training; the segment sum, mixture, NT-Xent and rank kernels
    launch, the GAT kernels do not."""
    args = gcn_args(BENCH_ARGS)
    pkl = _seeded_checkpoint(args, data, "seeded_init_gcn.pkl")
    served = _serve("gcn_serve", args, pkl,
                    {SEGMENT_KERNEL, "rank_topk_mean", "rank_counts"})
    trained = _train("gcn_train", args + GCN_TRAIN_ARGS,
                     f32_kernels() - GAT_KERNELS, promotion=False)
    return {k: served[k] + trained[k] for k in served}


def phase_gcn_bf16(data):
    """The GCN encoder in bf16 at the bench geometry: serving from a seeded
    init (the bf16 segment sum and the f32 rank sweeps), then 6 training
    epochs (``GCN_BF16_KERNELS``): no GAT kernel, no f32 segment sum, no
    twin."""
    args = gcn_args(BENCH_ARGS) + BF16
    pkl = _seeded_checkpoint(args, data, "seeded_init_gcn_bf16.pkl")
    served = _serve("gcn_bf16_serve", args, pkl, {SEGMENT_BF16} | RANK_KERNELS)
    trained = _train("gcn_bf16_train", args + GCN_TRAIN_ARGS,
                     GCN_BF16_KERNELS, promotion=False)
    say("gcn_bf16_train", f"median warm step: bf16 "
        f"{WARM_STEP_MS['gcn_bf16_train']:.3f} ms, f32 (phase gcn_train) "
        f"{WARM_STEP_MS['gcn_train']:.3f} ms")
    return {k: served[k] + trained[k] for k in served}


def _replay_began(runner):
    """MEAformer ``--replay 1``: "begin replay!" in the run's log and valid
    replay negatives fed to later steps."""
    from snag_tpu_torch.utils.logging import get_dump_path
    log = (Path(get_dump_path(runner.cfg)) / "train.log").read_text()
    say("meaformer_replay", f"'begin replay!' logged: {'begin replay!' in log}"
        f" | valid replay negatives fed: {runner.replay_negatives} | "
        f"buffer entries set: {int((runner.replay_neg >= 0).sum())} of "
        f"{runner.replay_neg.numel()}")
    if "begin replay!" not in log or runner.replay_negatives <= 0:
        raise AssertionError("replay never began or fed no valid negative")


def phase_families(data):
    """EVA, MCLEA and MEAformer through ``main`` at the bench geometry:
    EVA serving from a seeded init and training with IL (the segment sum
    and both rank sweeps); MCLEA, MEAformer, MEAformer with ``--replay 1``
    (the GAT, NT-Xent and rank kernels) and MEAformer in bf16 (the bf16
    entries of the same, the f32 rank sweeps).  Returns the launches of
    each run."""
    eva = family_args("EVA")
    pkl = _seeded_checkpoint(eva, data, "seeded_init_eva.pkl")
    # TRAIN_ARGS at 10 epochs, the fewest that reach a promotion (epoch 9
    # with --semi_learn_step 1), evaluating every 3
    eva_train = set_flag(set_flag(TRAIN_ARGS, "--epoch", "10"),
                         "--eval_epoch", "3")
    runs = [_serve("eva_serve", eva, pkl, {SEGMENT_KERNEL} | RANK_KERNELS),
            _train("eva_train", eva + eva_train,
                   {SEGMENT_KERNEL} | RANK_KERNELS, promotion=True)]
    for phase, args, expected, check in (
            ("mclea_train", family_args("MCLEA"), FAMILY_KERNELS, None),
            ("meaformer_train", family_args("MEAformer"), FAMILY_KERNELS,
             None),
            ("meaformer_replay", family_args("MEAformer", "--replay", "1"),
             FAMILY_KERNELS, _replay_began),
            ("meaformer_bf16", family_args("MEAformer", *BF16),
             FAMILY_BF16_KERNELS, None)):
        epochs = "4" if phase == "meaformer_bf16" else "6"
        runs.append(_train(phase, args + set_flag(GCN_TRAIN_ARGS, "--epoch",
                                                  epochs),
                           expected, promotion=False, check=check))
    say("families", "median warm step ms: " + ", ".join(
        f"{p} {WARM_STEP_MS[p]:.3f}" for p in (
            "eva_train", "mclea_train", "meaformer_train", "meaformer_replay",
            "meaformer_bf16", "train")))
    return runs


def phase_msnea(data):
    """MSNEA at the bench geometry through ``main``: serving from a seeded
    init saved as the port's ``.pkl``, then 40 epochs at a fixed LR of
    2e-3; each run launches exactly the two rank sweeps (MSNEA has no graph
    encoder and no kernel of its own), the trained model's final test
    MRR must beat the seeded init's, and two identical steps (triple
    gathers with repeated rows in their backward) give the same bits."""
    args = set_flag(BENCH_ARGS, "--model_name", "MSNEA")
    pkl = _seeded_checkpoint(args, data, "seeded_init_msnea.pkl")
    served = _serve("msnea_serve", args, pkl, RANK_KERNELS)
    init_mrr = SERVED["msnea_serve"].mrr_l2r

    def learned(runner):
        mrr = runner.last_result.mrr_l2r
        say("msnea_train", f"final test MRR l2r {mrr:.6f} against the seeded "
            f"init's {init_mrr:.6f} | triple bank {runner.bank.n1} + "
            f"{runner.bank.n2} triples")
        if not mrr > init_mrr:
            raise AssertionError("MSNEA did not learn past its seeded init")
        _steps_repeat("msnea_train", runner, 1)
    trained = _train("msnea_train", args + MSNEA_TRAIN_ARGS, RANK_KERNELS,
                     promotion=False, check=learned)
    return {k: served[k] + trained[k] for k in served}


def _steps_repeat(phase, runner, micro_steps):
    """Two copies of the trained model take the same ``micro_steps`` at
    the run's step count (one update; dropout and MSNEA's triples drawn
    from the same streams) and must end with the same bits, and the
    update must move them."""
    import copy
    import torch
    from snag_tpu_torch.train.step import TrainStep, msnea_step
    step = runner.train_step
    b = runner.cfg.batch_size
    n = min(b, len(runner.train_ill))
    links = torch.zeros(b, 2, dtype=torch.int64, device=runner.device)
    links[:n] = torch.as_tensor(runner.train_ill[:n].astype("int64"))
    valid = torch.arange(b, device=runner.device) < n
    states = []
    for _ in range(2):
        model = copy.deepcopy(runner.model)
        twin = TrainStep(runner.cfg, model, runner._lr, step.total_steps,
                         step.warmup_steps)
        # the run's last cycle start: past the warmup, a whole cycle ahead
        twin.count = step.count - step.count % twin.every
        for _ in range(micro_steps):
            if runner.bank is not None:
                msnea_step(twin, runner.bank, links, valid, runner.feats,
                           runner.graph, runner.epoch)
            else:
                twin(links, valid, runner.feats, runner.graph, runner.epoch)
        states.append(model.state_dict())
    differ = [k for k in states[0] if not torch.equal(states[0][k],
                                                      states[1][k])]
    moved = [k for k in states[0] if not torch.equal(
        states[0][k], runner.model.state_dict()[k])]
    say(phase, f"two identical steps: {len(differ)} of {len(states[0])} "
        f"tensors differ, {len(moved)} moved by the update")
    if differ or not moved:
        raise AssertionError(f"two identical steps differ: {differ[:8]}")


def _accum_dropout_repeat(runner):
    """Gradient accumulation counts: the optimizer's updates are half the
    micro-steps (rounded down), AdamW's own step count too; then two
    identical steps of two micro-steps each (``_steps_repeat``)."""
    step = runner.train_step
    adam_steps = {int(st["step"]) for st in step.opt.state_dict()["state"]
                  .values()}
    say("snag_accum_dropout", f"micro-steps {step.count} (this stage), "
        f"optimizer updates {step.updates}, AdamW step counts {adam_steps}")
    if step.updates != step.count // 2 or adam_steps != {step.updates}:
        raise AssertionError("the updates are not half the micro-steps")
    _steps_repeat("snag_accum_dropout", runner, 2)


def phase_accum_dropout():
    """SNAG with ``--accumulation_steps 2 --attn_dropout 0.1`` through
    ``main``: training sums on the weighted segment sum (the dropped GAT)
    and never runs the GAT backward kernel; evaluation and mining run the
    fused GAT forward; both loss kernels' pairs and both rank sweeps."""
    expected = f32_kernels() - {"gat_bwd"}
    return _train("snag_accum_dropout",
                  BENCH_ARGS + set_flag(TRAIN_ARGS, "--epoch", "6")
                  + ACCUM_DROPOUT_ARGS, expected, promotion=False,
                  check=_accum_dropout_repeat)


# ---------------------------------------------------------------- parity
# (H, C) of the GAT kernels' wide instantiations held in phase parity: 8
# heads at 300 (the shape ``--heads 8,8`` trains at: each head the full
# width; its records go into the kernels line), 8 heads at 1,536 (float4
# slices past 1,280), 2 heads at 330 (past 320 single floats; the
# backward's 8-byte slices)
PARITY_GAT = ((8, 300), (8, 1536), (2, 330))
# sha256 of agg and of rowsum of the wide forward at (H, C, bf16) of
# PARITY_GAT on gat_bwd_inputs, as the body that walked column chunks and
# head groups apart gave them on an H100 (scripts/torch_grad_ab.py,
# sections gat_fwd_wide and gat_fwd_wide_bf16): every later body keeps them
PARITY_FWD_SHA256 = {
    (8, 300, False): (
        "5c631d9346bf9706929bad3c1361ac2ec14579e9712e66d2e8732e9b949c66de",
        "3f64cbc9d4457a88e5cf30539f7d0b0fab1cd9f44b1d0e627788af4e3dce7147"),
    (8, 1536, False): (
        "9ef251069aeef1f65f34408aa80ef56e2b7f4f9cab66dc306b01bbbd9ea99a2c",
        "cbe043d3252ae06bf6e54f462f9d51506e2d55e5ac5fe0e305c9e8ec03646102"),
    (2, 330, False): (
        "d467c72b47be38240949622bf89cbe5ef4e8cabc55d0a772ae6a5f89f26c4787",
        "48428a36f396a473bf476b4ff5b746ad7614f95d9f47a3314573046541f89a29"),
    (8, 300, True): (
        "e694c184e7eaf4811f312b41f3878deb396ae04bb42d17c6a400475e12eb31ec",
        "d6cd4a68ecdb07a43cfb253f85dc0cb05cd6b8e7b1ba96a426f5bf811e52b94d"),
    (8, 1536, True): (
        "b0cbe949e710a9d3200b1242d34e7199b229d2b71ad6ad61affe9381bac98b48",
        "e9ae1ddab902a96e5827818f6a27d6eb8daeab70c4d3c8955011e4886f9dad38"),
    (2, 330, True): (
        "feade361ab2f443eb202f57a24f4dea516348ff33f07a9401c0c610377dbb990",
        "d68832a2bef8cce30ff1d89f05a346495ff7eea7b161d2345c936a72a84d5d48"),
}
# sweep A's lists in shared memory: 20 takes the list of 32 (the served
# evaluation's k below), 64 and 128 the list of 128
PARITY_K = (20, 64, 128)
# one row in PARITY_ROW_STRIDE is held against the twin on CPU copies (the
# twins at H = 8, C = 1,536 gather (E, H, C) = 16 GB over the whole graph)
PARITY_ROW_STRIDE = 50
# the training of phase parity's SNAG run (with the flags it ports, set in
# phase_parity), cut to 4 epochs (the profiler traces epochs 2-3) and the
# final test alone (an L1 evaluation at 10,500 pairs takes ~7 s)
PARITY_ARGS = ["--epoch", "4", "--eval_epoch", "5", "--batch_size", "3500",
               "--lr", "5e-4", "--scheduler", "cos", "--add_noise", "1",
               "--noise_ratio", "0.2", "--mask_ratio", "0.7",
               "--save_model", "1"]
# test pairs of the trained model's evaluation held against the CPU path,
# cut from 10,500: L1 at 1,536 pairs took 42 s on the CPU in the chunked
# evaluator (4 distance matrices) and takes ~5 s at 1,024 in the dense one
# (1); the card runs both on them
PARITY_CPU_PAIRS = 1024
# left and right rows, width: the bench joint's
PARITY_UNEQUAL = (10500, 12000, 1200)
# phase parity's f32 SNAG run with every active modality 1,600 wide (the
# fused bundle at M = 4, d = 1,600: the mixture gradient in feature
# chunks; the GAT at C = 1,600 on its wide path), 2 epochs, the final test
WIDE_WIDTH = 1600
SNAG_WIDE_ARGS = ["--epoch", "2", "--eval_epoch", "3", "--batch_size",
                  "3500", "--lr", "5e-4", "--scheduler", "cos"]


def wide_width_args():
    """BENCH_ARGS with every modality, the GAT and the fusion at
    WIDE_WIDTH."""
    args = set_flag(BENCH_ARGS, "--hidden_units", ",".join([str(WIDE_WIDTH)] * 3))
    for flag in ("--attr_dim", "--img_dim", "--name_dim", "--char_dim",
                 "--hidden_size"):
        args = set_flag(args, flag, str(WIDE_WIDTH))
    return args


def _sub_graph(g, rows, both):
    """The edges of ``g`` (on the CPU) whose row is one of ``rows`` (and,
    with ``both``, whose column is): every edge the twins need for those
    rows' outputs.  The twins read row and col alone."""
    import torch
    keep = torch.zeros(g.n_nodes, dtype=torch.bool)
    keep[rows] = True
    row, col = g.row.cpu(), g.col.cpu()
    sel = keep[row] | (keep[col.long()] if both else False)
    return g._replace(n_edges=int(sel.sum()), row=row[sel], col=col[sel])


def _parity_gat(inputs, bf16):
    """One wide instantiation of both GAT kernels on the bench graph
    (``inputs``: ``gat_bwd_inputs``, f32, rounded to bf16 with ``bf16``)
    against the twins on CPU copies, over every PARITY_ROW_STRIDE-th row:
    rtol = atol = 1e-5 (forward) and 1e-4 (backward), bf16 within
    BF16_TOL x max |twin|; a bitwise repeat, ms, device_ms, its bound and
    the gather roof (the rows an edge gathers: x[j] for the forward, G[i]
    for the backward, once, at HBM_BYTES_PER_S), the twin's ms on the
    card, and the ptxas registers and spills of the instantiation.
    Returns the kernels-line records of the forward and the backward."""
    import torch
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    g, x, s_src, s_dst, g_agg, g_rs = inputs
    (n, c), h = x.shape, s_src.shape[1]
    if bf16:
        x, g_agg = x.to(torch.bfloat16), g_agg.to(torch.bfloat16)
    vec = ga.slice_width(c, x, g_agg)
    if not ga.wide(c, h, vec):
        raise AssertionError(f"H={h} C={c} is not a wide instantiation")
    e, xb = g.n_edges, x.element_size()
    rows = torch.arange(0, n, PARITY_ROW_STRIDE)
    sfx = "_bf16" if bf16 else ""
    records = []
    for kind in ("fwd", "bwd"):
        if kind == "fwd":
            name = f"gat_attention_fwd{sfx}_wide"
            fn = lambda: ga.gat_attention_cuda(x, s_src, s_dst, g)
            twin = lambda: ga.gat_attention_twin(x, s_src, s_dst, g)
            want = on_cpu(ga.gat_attention_twin, x, s_src, s_dst,
                          _sub_graph(g, rows, False))
            fvec, _ = ga.wide_slice_width(c, h, x)
            wp = ga.wide_plan(c, h, fvec, bf16)
            kernels = (f"gat_attention_fwd{sfx}_wide_kernelILi{wp['hb']}ELi"
                       f"{fvec}ELi{wp['gw']}E",)
            nbytes = xb * n * c + 4 * (2 * n * h + n + 1 + e + n * h * c + n * h)
            flops = 2 * e * h * (c + 1)
            plan = (f"vec={fvec} heads={wp['hn']} (of {wp['hb']}) groups="
                    f"{wp['gw']} warps={wp['warps']} row groups={wp['rows']} "
                    f"tile={wp['tile']} passes={wp['passes']} "
                    f"depth={wp['depth']} smem={wp['smem']}")
            gathered = e * c * xb
        else:
            name = f"gat_bwd{sfx}_wide"
            fn = lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
            twin = lambda: gb.gat_backward_twin(x, s_src, s_dst, g_agg, g_rs,
                                                g)
            want = on_cpu(gb.gat_backward_twin, x, s_src, s_dst, g_agg, g_rs,
                          _sub_graph(g, rows, True))
            bvec, _ = gb.backward_slice_width(c, h, x, g_agg)
            wp = gb.wide_plan(c, h, bvec)
            kernels = (f"gat_bwd{sfx}_wide_rows_kernelILi{bvec}ELi"
                       f"{wp['heads']}ELi{wp['gw']}E",
                       f"gat_bwd{sfx}_wide_sums_kernel")
            nbytes = xb * (2 * n * c + n * h * c) + 4 * (5 * n * h + n + 1 + e)
            flops = 4 * e * h * c
            plan = (f"vec={bvec} heads={wp['heads']} groups={wp['gw']} "
                    f"warps={wp['warps']} batch={wp['batch']} "
                    f"passes={wp['passes']}")
            gathered = e * h * c * xb
        got = repeat_bitwise(fn, f"parity {name} H={h} C={c}")
        if kind == "fwd":
            sha = tuple(sha256_of(t) for t in got)
            kept = PARITY_FWD_SHA256.get((h, c, bf16))
            if kept is not None and sha != kept:
                raise AssertionError(f"parity {name} H={h} C={c}: agg and "
                                     f"rowsum sha256 {sha}, not the kept "
                                     f"{kept}")
            say("parity", f"{name} H={h} C={c}: sha256 agg {sha[0][:16]} "
                f"rowsum {sha[1][:16]}, "
                f"{'the kept ones' if kept else 'none kept'}")
        got = [t[rows.to(t.device)] for t in got]
        want = [t[rows.to(t.device)] for t in want]
        if bf16:
            errs = bf16_errors(f"parity {name}", got, want)
            limit = f"<= {BF16_TOL} x max"
        else:
            tol = 1e-5 if kind == "fwd" else 1e-4
            errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=tol, atol=tol)
            limit = f"rtol=atol={tol:g}"
        del got, want
        ms = median_ms(fn)
        dev = device_ms(fn, DEVICE_KERNELS[name])
        plain = median_ms(twin)
        torch.cuda.empty_cache()
        rec = row(name, max(errs), ms, dev, plain, nbytes, flops)
        roof = gathered / HBM_BYTES_PER_S * 1e3
        lib = (ga if kind == "fwd" else gb)._library()
        regs = "; ".join(f"{k} {r} registers, spills {st}/{ld} B"
                         for k, r, st, ld in kernel_ptxas(lib, kernels))
        say("parity", f"{name} H={h} C={c} {plan}: {len(rows)} rows of {n} "
            f"against the twin, max|err| {max(errs):.3e} ({limit}), bitwise "
            f"repeat | kernel {ms:.4f} ms, device {dev:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
            f"{rec['bound_share']:.3f}, gather roof {roof:.4f} ms (share "
            f"{roof / dev:.3f}), twin on the card {plain:.4f} ms | {regs}")
        records.append(rec)
    return records


def _parity_rank(k, n=10500, d=1200):
    """Sweep A at k in a shared-memory list, both directions from one pass
    over x y^T, against its plain version (rtol = atol = 1e-5), bitwise
    repeat, ms, device_ms and its bound (2 n^2 d fp32 flops: the one
    product serves both directions), the plain version's ms, the scratch's
    bytes, the peak device memory of one call above what was held before
    it, and the registers and spills of the sweep and of its merges (the
    rows' and the columns').  Returns the kernels-line record."""
    import torch
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    x, y = _eval_inputs(n, d)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    fn = lambda: rk.topk_mean_both_cuda(x, y, xn, yn, k)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # a call's scratch is freed before the repeat takes its own
    got = repeat_bitwise(fn, f"parity sweep A k={k}")
    peak = torch.cuda.max_memory_allocated() - held
    want = rk.topk_mean_both_twin(x, y, xn, yn, k)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    del want
    ms = median_ms(fn)
    dev = device_ms(fn, DEVICE_KERNELS[rk.STATS_TOPK_LONG.name])
    plain = median_ms(lambda: rk.topk_mean_both_twin(x, y, xn, yn, k))
    rec = row(rk.STATS_TOPK_LONG.name, err, ms, dev, plain,
              4 * (2 * n * d + 5 * n), 2 * n * n * d)
    bound_ms, bound_by = rec["bound_ms"], rec["bound_by"]
    size = rk.list_len(k)
    plan = rk.device_plan(x.device, n, d, 0, k)
    scratch = 4 * (plan["splits"] * n * size + rk.col_scratch_floats(n, k))
    regs = "; ".join(
        f"{e} {r} registers, spills {st}/{ld} B"
        for e, r, st, ld in kernel_ptxas(
            rk._library(), (f"long_topk_mean_kernelILi{size}E",
                            f"long_topk_merge_kernelILi{size}E")))
    say("parity", f"rank_topk_mean k={k} (list {size} in shared memory, "
        f"{plan['smem_bytes']} B a block, {plan['blocks_per_sm']} block(s) "
        f"an SM, {plan['splits']} splits, both directions a launch) N={n} "
        f"d={d}: max|err| {err:.3e} (rtol=atol=1e-5), bitwise repeat | "
        f"kernel {ms:.3f} ms, device {dev:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}), share {bound_ms / dev:.3f}, plain version "
        f"{plain:.3f} ms | scratch {scratch} B, peak memory of a call "
        f"{peak} B | {regs}")
    return rec


def _chunked_both(el, er, **kw):
    """(ranks l2r, ranks r2l, top-3 l2r) of the chunked evaluator, the path
    ``full_rank_eval`` takes for L1 above L1_FULL_MAX and for sides of
    unequal size, on the tensors' device."""
    from snag_tpu_torch.eval.ranking import chunked_ranks_one_direction
    l2r, top3 = chunked_ranks_one_direction(el, er, with_top3=True, **kw)
    r2l, _ = chunked_ranks_one_direction(er, el, **kw)
    return l2r.cpu(), r2l.cpu(), top3.cpu()


def _agree(label, got, want, paired, floor=0.999):
    """Ranks of both directions (and the l2r top-3) equal on >= ``floor``
    of the queries whose gold lies on the other side (the first
    ``paired`` of each side): the devices' products and sums round in
    other orders, which can flip a near-tie.  A query past the other
    side's end ranks against its last row, as JAX's clamped gather does;
    that gold sits amid the distances, where near-ties are dense, so those
    queries are held to ranks within 10 of the other device's.  Returns
    the agreement on the paired queries."""
    agree = min((got[i][:paired] == want[i][:paired]).float().mean().item()
                for i in (0, 1))
    t3 = (got[2][:paired] == want[2][:paired]).all(dim=1).float().mean().item()
    far = max([(got[i][paired:] - want[i][paired:]).abs().max().item()
               for i in (0, 1) if len(got[i]) > paired] or [0])
    say("parity", f"{label}: ranks equal on {agree:.6f} of the paired "
        f"queries (the worse direction), top-3 on {t3:.6f}; queries past "
        f"the other side: max|rank diff| {far}")
    if agree < floor or t3 < floor or far > 10:
        raise AssertionError(f"{label}: card and CPU disagree ({agree}, "
                             f"{t3}, {far})")
    return agree


def phase_parity(data):
    """Phase parity: the paths that finish single-GPU MMEA parity with the
    JAX package.  (a) The new kernel instantiations against their twins
    (``_parity_gat``: both GAT kernels' wide paths, f32 and bf16, at
    ``PARITY_GAT``; ``_parity_rank``: sweep A's shared-memory lists at
    ``PARITY_K``).  (b) SNAG through ``main`` at the bench geometry with
    ``--distance 1 --csls --csls_k 20 --instance_normalization --heads 8,8
    --profile_dir``, 4 epochs: the losses finite and falling, the GAT (wide)
    and loss kernels launched and the rank sweeps not (L1 is torch ops, as
    in JAX), the profiler's Chrome trace written with CUDA kernel events,
    the trained model's L1 evaluation of ``PARITY_CPU_PAIRS`` test pairs by
    the card's dense and chunked paths against the CPU's dense path; the
    same heads in bf16, 3 epochs, under L2 with CSLS k = 3 (the bf16 wide
    path, the bf16 loss entries and both rank sweeps); then the f32 model
    served with ``--csls_k 20`` under L2 (``--only_test 1``), which runs
    sweep A's list of 32, its ranks held against the CPU's dense twin;
    then f32 SNAG with every active modality ``WIDE_WIDTH`` wide, 2 epochs
    (``snag_wide``): both f32 gradients' wide body launches
    (``ntxent_grad_wide`` for IIR's 1,600-wide rows, ``mixture_grad_wide``),
    the GAT kernels on their wide path, the losses finite and falling.  (c) One evaluation with sides of unequal size (``PARITY_UNEQUAL``) on
    the card against the CPU path.  Returns the launches of (b)'s runs and
    the kernels-line records of (a) at ``PARITY_GAT[0]`` and
    ``PARITY_K[0]``."""
    import numpy as np
    import torch
    from snag_tpu_torch.eval.ranking import full_rank_eval, l1_distances
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    from snag_tpu_torch.ops.cuda.rank_eval import eval_core
    from snag_tpu_torch.ops.fusion import l2norm
    t0 = time.perf_counter()
    records = []
    for h, c in PARITY_GAT:
        inputs = gat_bwd_inputs(data.graph, c=c, h=h)
        for bf16 in (False, True):
            recs = _parity_gat(inputs, bf16)
            if (h, c) == PARITY_GAT[0]:
                records += recs
        del inputs
        torch.cuda.empty_cache()
    for k in PARITY_K:
        rec = _parity_rank(k)
        if k == PARITY_K[0]:
            records.append(rec)
    t_kernels = time.perf_counter() - t0

    held = {}

    def check(runner):
        with open(runner.trace_path) as f:
            events = json.load(f)["traceEvents"]
        n_kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
        say("parity", f"profiler trace {runner.trace_path}: {len(events)} "
            f"events, {n_kernels} CUDA kernel events")
        if not n_kernels:
            raise AssertionError("the --profile_dir trace holds no kernel")
        with torch.no_grad():
            emb = l2norm(runner._joint_emb()[0])
        m = PARITY_CPU_PAIRS
        el, er = emb[runner.test_left[:m]], emb[runner.test_right[:m]]
        kw = dict(csls_k=20, use_csls=True, distance_kind=1)
        t1 = time.perf_counter()
        want = eval_core(el.cpu(), er.cpu(), 20, True, True,
                         distances=l1_distances)
        cpu_s = time.perf_counter() - t1
        dense = eval_core(el, er, 20, True, True, distances=l1_distances)
        chunked = _chunked_both(el, er, **kw)
        torch.cuda.synchronize()
        say("parity", f"the trained model's L1 CSLS k=20 evaluation on "
            f"{m} test pairs, the CPU's dense path {cpu_s:.1f} s:")
        _agree("  the card's dense path", [t.cpu() for t in dense], want, m)
        _agree("  the card's chunked path", chunked, want, m)
        say("parity", f"the trained model's L1 evaluation at "
            f"{len(runner.test_left)} test pairs on the card: eval "
            f"{runner.timings['eval_s']:.3f} s (host clock, synchronised)")
        cfg = runner.cfg
        held["pkl"] = str(Path(cfg.data_path) / cfg.model_name / "save"
                          / f"{cfg.exp_id}.pkl")

    args = set_flag(set_flag(BENCH_ARGS, "--heads", "8,8"), "--csls_k", "20")
    flags = ["--distance", "1", "--instance_normalization", "--profile_dir",
             str(WORK / "parity_trace")]
    expected = (f32_kernels() - {SEGMENT_KERNEL} - RANK_KERNELS
                - GAT_KERNELS | GAT_WIDE_KERNELS)
    runs = [_train("parity", args + flags + PARITY_ARGS, expected,
                   promotion=False, check=check)]
    # the same heads in bf16 (the GAT kernels' bf16 wide path), under L2
    # with CSLS k = 3
    bf16_args = set_flag(BENCH_ARGS, "--heads", "8,8")
    runs.append(_train(
        "parity_bf16", bf16_args + set_flag(PARITY_ARGS, "--epoch", "3")
        + BF16, (BF16_KERNELS - {"gat_attention_fwd_bf16", "gat_bwd_bf16"})
        | GAT_BF16_WIDE_KERNELS | RANK_KERNELS, promotion=False))
    if rk.list_len(20) <= rk.MAX_K:
        raise AssertionError("k = 20 should take sweep A's long list")
    def served(runner):
        with torch.no_grad():
            emb = l2norm(runner._joint_emb()[0])
        el, er = emb[runner.test_left], emb[runner.test_right]
        t1 = time.perf_counter()
        want = rk.streaming_rank_eval(el.cpu(), er.cpu(), 20, True, True)
        cpu_s = time.perf_counter() - t1
        got = rk.streaming_rank_eval(el, er, 20, True, True)
        _agree(f"the served L2 CSLS k=20 evaluation, {len(el)} test pairs "
               f"of width {el.shape[1]}: the card's sweeps against the "
               f"CPU's dense twin ({cpu_s:.1f} s)", [t.cpu() for t in got],
               want, len(el))

    runs.append(_serve("parity_serve", args + ["--instance_normalization"],
                       held["pkl"], {"gat_attention_fwd_wide",
                                     "rank_topk_mean_long", "rank_counts"},
                       check=served))
    # (d) f32 SNAG at width WIDE_WIDTH: both gradients' wide body
    runs.append(_train(
        "snag_wide", wide_width_args() + SNAG_WIDE_ARGS,
        (f32_kernels() - {SEGMENT_KERNEL} - GAT_KERNELS
         - {"ntxent_grad", "mixture_grad"}) | GAT_WIDE_KERNELS
        | GRAD_WIDE_KERNELS, promotion=False))
    t_runs = time.perf_counter() - t0 - t_kernels

    nl, nr, d = PARITY_UNEQUAL
    rng = np.random.default_rng(SEED + 2)
    l = rng.normal(size=(nl, d)).astype(np.float32)
    r = rng.normal(size=(nr, d)).astype(np.float32)
    r[:nl] = l + 0.5 * r[:nl]
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    el, er = torch.as_tensor(l, device="cuda"), torch.as_tensor(r, device="cuda")
    t1 = time.perf_counter()
    want = _chunked_both(el.cpu(), er.cpu(), csls_k=3, use_csls=True)
    cpu_s = time.perf_counter() - t1
    _agree(f"unequal sides {nl} x {nr} of {d}, L2 CSLS k=3, the card "
           f"against the CPU ({cpu_s:.1f} s)",
           _chunked_both(el, er, csls_k=3, use_csls=True), want, nl)
    ms = median_ms(lambda: full_rank_eval(el, er, csls_k=3, use_csls=True,
                                          with_top3=True))
    say("parity", f"unequal sides {nl} x {nr}: full_rank_eval on the card "
        f"{ms:.1f} ms (median of {REPS}, CUDA events) | phase wall "
        f"{time.perf_counter() - t0:.1f} s: kernels {t_kernels:.1f}, "
        f"training and serving {t_runs:.1f}")
    return runs, records


def _files_argv(root: Path, exp_id: str, *extra: str):
    """The gates' flags (``torch_gates.PARITY_FLAGS``) at 8 epochs with IL
    from epoch 2, on the files under ``root``."""
    import torch_gates
    flags = list(torch_gates.PARITY_FLAGS)
    for k, v in (("--epoch", "8"), ("--il_start", "2")):
        flags[flags.index(k) + 1] = v
    return flags + ["--random_seed", str(SEED), "--data_path",
                    str(root / "data"), "--dump_path", str(root / "dump"),
                    "--exp_name", "chip_smoke_files", "--exp_id", exp_id,
                    "--no_tensorboard", *extra]


def _files_run(label, argv, expected):
    """``main(argv)`` with the launch counts set to 0 just before it;
    returns (runner, launches), the kernels of ``expected`` launched and
    no other, no twin."""
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernel_stats()
    res = runner.last_result
    say("files", f"{label}: main() {wall:.1f} s | {_res_line(res)} | MRR "
        f"l2r {res.mrr_l2r!r} r2l {res.mrr_r2l!r} | launches/twin calls "
        f"{stats}")
    check_launches(f"files {label}", stats, expected)
    return runner, {name: launches for name, (launches, _) in stats.items()}


def _res_line(res):
    t1, t2, _ = res.acc_l2r
    return f"Res:[{t1}\t{t2}\t{res.mrr_l2r:.3f}]"


def _same_result(a, b):
    return (_res_line(a) == _res_line(b)
            and (a.mrr_l2r, a.mrr_r2l, a.mr_l2r, a.mr_r2l)
            == (b.mrr_l2r, b.mrr_r2l, b.mr_l2r, b.mr_r2l)
            and (a.acc_r2l == b.acc_r2l).all()
            and (a.ranks_l2r == b.ranks_l2r).all()
            and (a.top3_l2r == b.top3_l2r).all())


def phase_files():
    """The on-disk data path and train-state checkpoints at the gates'
    geometry: export (digests held against the JAX package's), train with
    checkpoints and ``--save_model``, resume from the last checkpoint,
    serve the saved ``.pkl``.  Returns the launches of the three runs."""
    import torch
    from snag_tpu_torch.utils.checkpoint import CHECKPOINT_NAME
    from snag_tpu_torch.utils.logging import get_dump_path
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_gates
    root = WORK / "files"
    t0 = time.perf_counter()
    digests = torch_gates.export(str(root))     # raises on a mismatch
    say("files", f"export + digests {time.perf_counter() - t0:.1f} s, all "
        f"{len(digests)} the JAX package's:")
    for line in torch_gates.digest_lines(digests):
        say("files", f"  {line}")

    train = f32_kernels() - {SEGMENT_KERNEL}
    ckpt_flags = ("--checkpoint_every", "3", "--save_model", "1")
    trained, launches = _files_run(
        "trained", _files_argv(root, "trained", *ckpt_flags), train)
    ckpt = str(Path(get_dump_path(trained.cfg)) / CHECKPOINT_NAME)
    epoch = torch.load(ckpt, weights_only=True)["epoch"]
    if epoch != 5:
        raise AssertionError(f"the last checkpoint is of epoch {epoch}, not 5")
    resumed, more = _files_run(
        "resumed from the epoch-5 checkpoint",
        _files_argv(root, "resumed", *ckpt_flags, "--resume_from", ckpt),
        train)
    launches = {k: launches[k] + more[k] for k in launches}
    saved = [torch.load(str(Path(r.cfg.data_path) / "SNAG" / "save" /
                            f"{r.cfg.exp_id}.pkl"), weights_only=True)
             for r in (trained, resumed)]
    differ = sorted(k for k in saved[0] if not torch.equal(saved[0][k],
                                                           saved[1][k]))
    say("files", f"saved models: {len(saved[0])} tensors, {len(differ)} "
        f"differ {differ[:8]}; final results equal: "
        f"{_same_result(trained.last_result, resumed.last_result)}")
    if differ or saved[0].keys() != saved[1].keys() or \
            not _same_result(trained.last_result, resumed.last_result):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    served, more = _files_run(
        "served from the saved .pkl",
        _files_argv(root, "served", "--only_test", "1", "--model_name_save",
                    trained.cfg.exp_id), SERVING_KERNELS)
    launches = {k: launches[k] + more[k] for k in launches}
    if not _same_result(trained.last_result, served.last_result):
        raise AssertionError("serving the saved model gives other metrics")
    return launches


# MKGC at bench.py's geometry (bench.py:313-319): DB15K-sized SYNTH
MKGC_ARGS = [
    "--data_choice", "SYNTH", "--emb_dim", "128", "--neg_num", "32",
    "--joint_way", "Mformer_hd_graph", "--num_proj", "2", "--add_noise", "1",
    "--noise_ratio", "0.2", "--mask_ratio", "0.7", "--use_pool", "1",
    "--pool_dim", "256", "--num_hidden_layers", "1",
    "--num_attention_heads", "2", "--synth_ents", "12800",
    "--synth_rels", "256", "--synth_triples", "90000",
    "--synth_vis_dim", "4096", "--synth_txt_dim", "768", "--random_seed", "7",
    "--log_every", "1000000000",
]
# (a): 64 batches of 1,125 triples, margin 1 (bench.py's throughput run,
# the all-entity fusion branch); (b): run_base.sh's NUM_BATCH 1024 and
# MARGIN 12, batches of 70 (the role-mixed branch)
MKGC_A = ["--num_batch", "64", "--margin", "1.0", "--epoch", "3",
          "--eval_epoch", "3", "--save_model", "1", "--exp_id", "mkgc_a"]
MKGC_B = ["--num_batch", "1024", "--margin", "12", "--epoch", "1",
          "--eval_epoch", "1000", "--exp_id", "mkgc_b"]
# the JAX package's learning run (tests/test_mkgc.py:15-50): 80 entities,
# 60 epochs, test MRR above 0.15
MKGC_LEARN = [
    "--data_choice", "SYNTH", "--emb_dim", "32", "--num_batch", "8",
    "--neg_num", "8", "--margin", "1.0", "--lr", "5e-3", "--lrg", "5e-3",
    "--epoch", "60", "--eval_epoch", "100", "--add_noise", "0",
    "--use_pool", "1", "--pool_dim", "32", "--num_hidden_layers", "1",
    "--num_attention_heads", "2", "--synth_ents", "80", "--synth_rels", "8",
    "--synth_triples", "600", "--random_seed", "7", "--log_every", "1000",
    "--joint_way", "Mformer_hd_mean", "--exp_id", "mkgc_learn",
]


def _mkgc_main(label, argv):
    """``cli.train_mkgc.main`` on the card with the launch counts set to
    0 just before it: MKGC reaches no TPU kernel, so no kernel of ours and
    no twin may run; every loss finite, every metric in [0, 1]."""
    import torch
    from snag_tpu_torch.cli.train_mkgc import main
    from snag_tpu_torch.ops import cuda as kernels
    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv + ["--device", "cuda", "--data_path",
                          str(WORK / "mkgc")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = kernel_stats()
    m = runner.last_metrics
    say("mkgc", f"{label}: {runner.data.ent_num} entities, "
        f"{len(runner.data.train)} train triples, batch {runner.batch_size},"
        f" {runner.step.count} steps, main() {wall:.1f} s | epoch losses "
        f"{[round(x, 5) for x in runner.losses]} | test {m}")
    check_launches(f"mkgc {label}", stats, set())
    if not all(math.isfinite(x) for x in runner.losses):
        raise AssertionError(f"non-finite losses {runner.losses}")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for k, v in m.items() if k != "mr"):
        raise AssertionError(f"metrics out of range: {m}")
    return runner


def _mkgc_speed(label, runner):
    """Warm training on the card: triples/s and wall ms a step over a
    whole epoch (host clock, synchronised), the kernel ms of one step
    (``device_ms`` over all its kernels) and the idle share 1 - kernel /
    wall."""
    import torch
    from snag_tpu_torch.mkgc.train import epoch_batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = runner.train_epoch(runner.epoch + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = len(runner.data.train) // runner.batch_size
    step_ms = 1e3 * dt / steps
    batches = iter(epoch_batches(runner.cfg, runner.train_triples,
                                 runner.epoch + 2, runner.batch_size))
    kernel_ms = device_ms(lambda: runner.step(next(batches), runner.feats),
                          ("",))
    say("mkgc", f"{label}: warm epoch {steps * runner.batch_size / dt:.1f} "
        f"triples/s, {step_ms:.3f} ms a step ({steps} steps, loss "
        f"{loss:.5f}) | kernels {kernel_ms:.3f} ms a step (device_ms), "
        f"idle share {1.0 - kernel_ms / step_ms:.4f}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")


def _mkgc_repeat(label, runner):
    """Two copies of the model and its Adam state take the same two steps
    (noise, corruptions and dropout from the same streams) and end on the
    same bits; two evaluations give the same ranks."""
    import copy
    import numpy as np
    import torch
    from snag_tpu_torch.mkgc.train import (MKGCStep, epoch_batches,
                                           filtered_ranks)
    batches = epoch_batches(runner.cfg, runner.train_triples, 0,
                            runner.batch_size)[:2]
    states = []
    for _ in range(2):
        model = copy.deepcopy(runner.model)
        step = MKGCStep(runner.cfg, model, runner.stats)
        step.opt.load_state_dict(copy.deepcopy(runner.step.opt.state_dict()))
        step.count = runner.step.count
        for pos in batches:
            step(pos, runner.feats)
        states.append(model.state_dict())
    differ = [k for k in states[0]
              if not torch.equal(states[0][k], states[1][k])]
    moved = [k for k in states[0]
             if not torch.equal(states[0][k], runner.model.state_dict()[k])]
    ranks = [filtered_ranks(runner.model, runner.feats, runner.data,
                            runner.data.valid[:runner.cfg.valid_max])
             for _ in range(2)]
    same = bool(np.array_equal(ranks[0], ranks[1]))
    say("mkgc", f"{label}: two identical steps: {len(differ)} of "
        f"{len(states[0])} tensors differ, {len(moved)} moved | two "
        f"evaluations of {len(ranks[0])} ranks equal: {same}")
    if differ or not moved or not same:
        raise AssertionError(f"MKGC is not repeatable: {differ[:8]}")


def _mkgc_gpu_cpu():
    """Three Adam steps from one init on injected samples, deterministic,
    on the card and on the CPU, at the JAX test's size, in both negative
    formulations (batch 40: all-entity fusion; 4: role-mixed), at
    run_base.sh's LR = LRG = 1e-4: losses within rel 1e-4, parameters
    within atol 1e-5."""
    import numpy as np
    import torch
    from snag_tpu_torch.mkgc.config import (build_mkgc_argparser,
                                            mkgc_config_from_args)
    from snag_tpu_torch.mkgc.data import load_mkgc_data
    from snag_tpu_torch.mkgc.model import MKGCModel
    from snag_tpu_torch.mkgc.train import MKGCStep, place_mkgc_features
    argv = set_flag(set_flag(MKGC_LEARN, "--lr", "1e-4"), "--lrg", "1e-4")
    cfg = mkgc_config_from_args(build_mkgc_argparser().parse_args(
        set_flag(argv, "--joint_way", "Mformer_hd_graph") + ["--num_proj",
                                                              "2"]))
    data = load_mkgc_data(cfg)
    rng = np.random.default_rng(SEED)
    for b in (40, 4):
        batches = [(data.train[s * b:(s + 1) * b].astype(np.int64),
                    rng.integers(0, data.ent_num, (b, cfg.neg_num)),
                    rng.random((b, cfg.neg_num)) < 0.5) for s in range(3)]
        out = {}
        for device in ("cuda", "cpu"):
            feats = place_mkgc_features(cfg, data, device)[0]
            model = MKGCModel(cfg, data.ent_num, data.rel_num,
                              int(feats.visual.shape[1]),
                              int(feats.textual.shape[1]),
                              torch.Generator().manual_seed(SEED)).to(device)
            step = MKGCStep(cfg, model)
            losses = [step(torch.as_tensor(pos, device=device), feats,
                           samples=(torch.as_tensor(r, device=device),
                                    torch.as_tensor(c, device=device)),
                           deterministic=True)[0].item()
                      for pos, r, c in batches]
            out[device] = (losses, {k: v.cpu() for k, v in
                                    model.state_dict().items()})
        (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
        rel = max(abs(a - c) / abs(c) for a, c in zip(lg, lc))
        perr = max((pg[k] - pc[k]).abs().max().item() for k in pc)
        say("mkgc", f"(e) GPU against CPU, 3 steps of {b}: losses gpu {lg} "
            f"cpu {lc} (max rel diff {rel:.2e}, limit 1e-4) | max|param "
            f"gpu-cpu| {perr:.2e} (limit 1e-5)")
        if rel > 1e-4 or perr > 1e-5:
            raise AssertionError("MKGC's GPU and CPU steps disagree")


def phase_mkgc():
    """MKGC through ``cli.train_mkgc.main`` on the card: (a) bench.py's
    throughput run with ``--save_model 1`` (3 epochs and a valid eval,
    then its warm triples/s and the filtered valid eval, median of 5);
    (b) run_base.sh's batching, 1 epoch, then its warm triples/s; (c)
    ``--only_test 1`` from (a)'s snapshot gives (a)'s test metrics; (d)
    two identical steps and two evaluations repeat bit for bit, in both
    branches; (e) GPU against CPU; (f) the JAX test's learning run."""
    from snag_tpu_torch.mkgc import model as mkgc_model
    if mkgc_model.ALL_ENT_FUSION != "auto":
        raise AssertionError("ALL_ENT_FUSION is forced")
    a = _mkgc_main("(a) bench, num_batch 64", MKGC_ARGS + MKGC_A)
    b_fuse = a.batch_size * (a.cfg.neg_num + 2) > 2 * a.data.ent_num
    times = []
    for _ in range(REPS + 1):
        t0 = time.perf_counter()
        m = a.evaluate("valid")
        times.append(1e3 * (time.perf_counter() - t0))
    say("mkgc", f"(a) all-entity fusion branch: {b_fuse} | filtered valid "
        f"eval of {min(len(a.data.valid), a.cfg.valid_max)} triples, both "
        f"directions: median {statistics.median(times[1:]):.3f} ms of "
        f"{REPS} after one ({times[0]:.3f} ms) | {m}")
    if not b_fuse:
        raise AssertionError("(a) does not take the all-entity branch")
    _mkgc_speed("(a)", a)
    _mkgc_repeat("(d) all-entity branch", a)
    served = _mkgc_main("(c) --only_test 1 from (a)'s snapshot",
                        MKGC_ARGS + MKGC_A[:-4] + ["--only_test", "1",
                                                   "--exp_id", "mkgc_a"])
    if served.last_metrics != a.last_metrics:
        raise AssertionError(f"--only_test gives {served.last_metrics}, "
                             f"training gave {a.last_metrics}")
    del a, served
    b = _mkgc_main("(b) run_base.sh, num_batch 1024", MKGC_ARGS + MKGC_B)
    if b.batch_size * (b.cfg.neg_num + 2) > 2 * b.data.ent_num:
        raise AssertionError("(b) does not take the role-mixed branch")
    _mkgc_speed("(b)", b)
    _mkgc_repeat("(d) role-mixed branch", b)
    del b
    _mkgc_gpu_cpu()
    learn = _mkgc_main("(f) the JAX test's learning run", MKGC_LEARN)
    if not learn.last_metrics["mrr"] > 0.15:
        raise AssertionError(f"MKGC did not learn: {learn.last_metrics}")


# phase 14: SNAG with IL at the bench geometry, 3 epochs
MESH_ARGS = BENCH_ARGS + [
    "--epoch", "3", "--il", "--il_start", "1", "--semi_learn_step", "1",
    "--eval_epoch", "1", "--batch_size", "3500", "--lr", "5e-4",
    "--scheduler", "cos", "--add_noise", "1", "--noise_ratio", "0.2",
    "--mask_ratio", "0.7", "--no_tensorboard"]
# rows 1-6 of PERF.md's kernel table, the kernels of a mesh rank's step
MESH_KERNELS = {"gat_attention_fwd", "gat_bwd", "mixture_lse", "mixture_grad",
                "ntxent_lse", "ntxent_grad"}
# MKGC at phase 12's geometry, 2 epochs: (a)'s batching (1,124 triples,
# the all-entity fusion branch), and batches of 562, whose 562 x (32 + 2)
# joints stay under 2 x 12,800 (the role-mixed branch, which fetches a
# step's rows of both tables)
MKGC_MESH = MKGC_ARGS + ["--num_batch", "64", "--margin", "1.0",
                         "--epoch", "2", "--eval_epoch", "2"]
MKGC_MESH_MIXED = MKGC_ARGS + ["--num_batch", "128", "--margin", "1.0",
                               "--epoch", "2", "--eval_epoch", "2"]
# the one parameter whose gradient is zero in exact arithmetic (a bias on
# every key moves a query's scores alike): Adam turns its rounding noise
# into steps of either sign, so its values are not compared across runs
NOISE_GRAD = "attention.self.key.bias"


def _state_digest(model) -> str:
    return sha256_of(*[v for _, v in sorted(model.state_dict().items())])


def _numpy_state(model):
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def _tables(feats, mesh):
    """Each feature table's placement, (kind, lo, hi, n, bytes held), kind
    "shard" or "whole"; raises unless every table is this rank's
    ``Mesh.rows`` share under a mesh of N > 1 ranks, and whole
    otherwise."""
    from snag_tpu_torch.parallel.mesh import RowShard
    out = {}
    for name, t in feats._asdict().items():
        if t is None:
            continue
        if isinstance(t, RowShard):
            out[name] = ("shard", t.lo, t.hi, t.n, t.local.nbytes)
        else:
            out[name] = ("whole", 0, t.shape[0], t.shape[0], t.nbytes)
        kind, lo, hi, n, _ = out[name]
        sharded = mesh is not None and mesh.world > 1
        if kind != ("shard" if sharded else "whole") or (
                sharded and ((lo, hi) != mesh.rows(n) or hi - lo >= n)):
            raise AssertionError(f"table {name}: {out[name][:4]} under "
                                 f"{mesh}")
    return out


class _MemoryMarks:
    """The device memory of one MMEA run through ``main`` in this
    process, less what was held before it: the start-up peak (up to the
    start of epoch 0) and the steady peak (from the start of epoch 1 to
    the end), and the steady peak's share in training epochs, in
    evaluations and in IL mining.  The peak is reset where each of these
    starts and ends, so that each span has its own and the steady one is
    the largest; the Runner's ``_profile`` (its epoch hook),
    ``train_epoch``, ``evaluate`` and ``_il_mine`` are wrapped for it."""
    SPANS = {"train_epoch": "train", "evaluate": "eval", "_il_mine": "mine"}

    def __enter__(self):
        import torch
        from snag_tpu_torch.train.runner import Runner
        self.orig = {name: getattr(Runner, name)
                     for name in ["_profile", *self.SPANS]}
        self.held = torch.cuda.memory_allocated()
        self.marks = {"steady": 0}
        torch.cuda.reset_peak_memory_stats()
        marks, held, orig = self.marks, self.held, self.orig
        self.steady = False

        def close(label):
            if self.steady:
                peak = torch.cuda.max_memory_allocated() - held
                marks[label] = max(marks.get(label, 0), peak)
                marks["steady"] = max(marks["steady"], peak)
            torch.cuda.reset_peak_memory_stats()

        def profile(runner, epoch):
            if epoch == 0:
                marks["startup"] = torch.cuda.max_memory_allocated() - held
            elif epoch == 1 and not self.steady:
                self.steady = True
                torch.cuda.reset_peak_memory_stats()
            return orig["_profile"](runner, epoch)

        def span(name, label):
            def run(runner, *args, **kwargs):
                close("other")
                try:
                    return orig[name](runner, *args, **kwargs)
                finally:
                    close(label)
            return run
        Runner._profile = profile
        for name, label in self.SPANS.items():
            setattr(Runner, name, span(name, label))
        self.close = close
        return self.marks

    def __exit__(self, *exc):
        from snag_tpu_torch.train.runner import Runner
        self.close("other")
        for name, fn in self.orig.items():
            setattr(Runner, name, fn)


def _time_fetch(mesh, tables, idxs, reps=20):
    """One fetch of rows ``idxs`` (a list of id tensors) of ``tables``,
    as a step makes it (``parallel.mesh.take_each``: every table and
    index set in one), timed ``reps`` times between barriers with the
    card synchronised: (median ms, bytes of the rows fetched, distinct ids
    another rank owns)."""
    import torch
    from snag_tpu_torch.parallel.mesh import take_each
    lo, hi = mesh.rows(tables[0].n)
    distinct = torch.unique(torch.cat([i.reshape(-1) for i in idxs]))
    remote = int(((distinct < lo) | (distinct >= hi)).sum())
    times = []
    for _ in range(reps):
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = take_each(mesh, tables, idxs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(times),
            sum(g.nbytes for row in got for g in row), remote)


def _fetch_ms(runner):
    """The fetch of one training step of an MMEA mesh rank's ``runner``:
    the rows of a batch of ``--batch_size`` links that this rank encodes,
    from every feature table, then as many ids drawn uniformly:
    {label: ``_time_fetch``'s record}."""
    import torch
    from snag_tpu_torch.models.encoder import batch_rows
    mesh = runner.mesh
    links = torch.as_tensor(runner.train_ill[:runner.cfg.batch_size].astype(
        "int64"), device=runner.device)
    rows = batch_rows(links)[0]
    local = rows[slice(*mesh.rows(rows.shape[0]))]
    uniform = torch.randint(0, runner.data.ent_num, local.shape,
                            device=runner.device,
                            generator=torch.Generator(runner.device)
                            .manual_seed(mesh.rank))
    tables = [t for t in runner.feats if t is not None]
    return {label: _time_fetch(mesh, tables, [ids])
            for label, ids in (("step", local), ("uniform", uniform))}


def _mkgc_fetch_ms(runner):
    """The fetch of one role-mixed MKGC step of a mesh rank's ``runner``:
    both tables' rows of this rank's share of a batch's heads, tails and
    corruptions (``MKGCModel._rows``'s fetch): {"step": record}."""
    mesh = runner.mesh
    b = runner.batch_size
    lo, hi = mesh.rows(b)
    pos = runner.train_triples[:b][lo:hi]
    rand_ent = runner.step.sample(b, runner.device)[0][lo:hi]
    return {"step": _time_fetch(mesh, list(runner.feats), [
        pos[:, 0], pos[:, 2], rand_ent.reshape(-1)])}


def _mmea_record(runner, marks):
    """What phase mesh compares of an MMEA run, with its tables and the
    device memory ``marks`` of ``_MemoryMarks``."""
    res = runner.last_result
    per_epoch0 = -(-len(runner.data.train_ill) // runner.cfg.batch_size)
    return {"losses": list(runner.loss_log.loss[1:]),
            "step_losses": list(runner.step_losses),
            "ranks": res.ranks_l2r, "mrr": (res.mrr_l2r, res.mrr_r2l),
            "digest": _state_digest(runner.model),
            "params": _numpy_state(runner.model),
            "step_ms": statistics.median(runner.step_ms[per_epoch0:]),
            "tables": _tables(runner.feats, runner.mesh), **marks,
            "stats": kernel_stats()}


def _say_memory(label, rec):
    """One line of a run's table bytes, its peaks and its fetch."""
    held = sum(t[4] for t in rec["tables"].values())
    spans = ", ".join(f"{k} {t[0]} {t[1]}:{t[2]} of {t[3]}"
                      for k, t in rec["tables"].items())
    fetch = "".join(
        f" | fetch, {label} ids: {nbytes} bytes, {remote} distinct ids "
        f"of another rank, median {ms:.3f} ms"
        for label, (ms, nbytes, remote) in rec.get("fetch", {}).items())
    parts = ", ".join(f"{k} {rec[k]}" for k in ("train", "eval", "mine",
                                                "other") if k in rec)
    say("mesh", f"{label}: tables held {held} bytes ({spans}) | start-up "
        f"peak {rec['startup']} bytes | steady peak {rec['steady']} bytes "
        f"(max_memory_allocated from epoch 1; by span: {parts}){fetch} | "
        f"{card_smi()}")


def _mkgc_epochs(argv, batch_size=None):
    """MKGC's runner built from ``argv``, 2 epochs at ``batch_size`` (the
    runner's own where None), then the valid split's filtered ranks
    through its evaluator and through the one-rank evaluator."""
    from snag_tpu_torch.mkgc.config import (build_mkgc_argparser,
                                            mkgc_config_from_args)
    from snag_tpu_torch.mkgc.train import (MKGCRunner, filtered_ranks,
                                           make_score_fn)
    from snag_tpu_torch.utils.logging import create_logger
    import torch
    cfg = mkgc_config_from_args(build_mkgc_argparser().parse_args(argv))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runner = MKGCRunner(cfg, create_logger(name="chip_smoke.mesh_mkgc"))
    startup = torch.cuda.max_memory_allocated() - held
    if batch_size is not None:
        runner.batch_size = batch_size
    losses = [runner.train_epoch(0)]
    torch.cuda.reset_peak_memory_stats()
    losses.append(runner.train_epoch(1))
    train = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    valid = runner.data.valid[:cfg.valid_max]
    ranks = filtered_ranks(runner.model, runner.feats, runner.data, valid,
                           score_fn=runner._score_fn)
    ranks_one = filtered_ranks(runner.model, runner.feats, runner.data,
                               valid, score_fn=make_score_fn(runner.model))
    evals = torch.cuda.max_memory_allocated() - held
    rec = {"losses": losses, "batch_size": runner.batch_size,
           "fused_all": runner.batch_size * (cfg.neg_num + 2)
           > 2 * runner.data.ent_num,
           "params": _numpy_state(runner.model), "ranks": ranks,
           "ranks_one": ranks_one,
           "tables": _tables(runner.feats, runner.mesh),
           "startup": startup, "steady": max(train, evals), "train": train,
           "eval": evals, "stats": kernel_stats()}
    if runner.mesh is not None and not rec["fused_all"]:
        rec["fetch"] = _mkgc_fetch_ms(runner)
    return rec


def _mesh_rank(kind, argv, out):
    """A spawned rank of phase mesh: the MMEA CLI (``kind`` "mmea") or
    MKGC's runner ("mkgc") on ``argv``, its record pickled to
    ``<out>.rank<r>.pkl``."""
    import pickle
    import torch
    import torch.distributed as dist
    from snag_tpu_torch.ops import cuda as kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_stats()
    if kind == "mmea":
        from snag_tpu_torch.cli.train_mmea import main
        with _MemoryMarks() as marks:
            runner = main(argv)
            torch.cuda.synchronize()
        rec = _mmea_record(runner, marks)
        rec["fetch"] = _fetch_ms(runner)
    else:
        rec = _mkgc_epochs(argv)
        torch.cuda.synchronize()
    with open(f"{out}.rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(rec, f)


def _spawn_ranks(label, kind, argv, backend, device):
    """Two ranks of ``_mesh_rank``; their records, rank 0 first."""
    import pickle
    from snag_tpu_torch.parallel import mesh as mesh_mod
    out = WORK / "mesh" / label
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mesh_mod.spawn(2, _mesh_rank, (kind, argv, str(out)), backend=backend,
                   device=device)
    recs = []
    for r in range(2):
        with open(f"{out}.rank{r}.pkl", "rb") as f:
            recs.append(pickle.load(f))
    say("mesh", f"{label}: two ranks over {backend}, spawned, "
        f"{time.perf_counter() - t0:.1f} s")
    return recs


def _max_param_err(got, want):
    """max |got - want| / (atol + rtol |want|) over the parameters but
    ``NOISE_GRAD``'s: at most 1 within rtol 2e-3, atol 2e-5."""
    import numpy as np
    return max(float((np.abs(got[k] - v) / (2e-5 + 2e-3 * np.abs(v))).max())
               for k, v in want.items() if not k.endswith(NOISE_GRAD))


def _check_ranks(label, recs, want, launches):
    """Two MMEA ranks against the one-rank record ``want``."""
    import numpy as np
    a, b = recs
    if a["step_losses"] != b["step_losses"] or a["digest"] != b["digest"] \
            or not np.array_equal(a["ranks"], b["ranks"]):
        raise AssertionError(f"{label}: the two ranks differ")
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                  want["losses"]))
    perr = _max_param_err(a["params"], want["params"])
    agree = float((a["ranks"] == want["ranks"]).mean())
    dmrr = max(abs(x - y) for x, y in zip(a["mrr"], want["mrr"]))
    say("mesh", f"{label}: epoch losses {a['losses']} against {want['losses']}"
        f" (max rel {rel:.2e}, limit 5e-3) | weights: max err / (2e-5 + "
        f"2e-3 |w|) {perr:.3f} (limit 1) | final ranks equal on "
        f"{agree:.4f} of queries, MRR diff {dmrr:.2e} | step ms rank 0 "
        f"{a['step_ms']:.3f}, rank 1 {b['step_ms']:.3f}")
    if rel > 5e-3 or perr > 1.0 or agree < 0.995 or dmrr > 1e-3:
        raise AssertionError(f"{label}: two ranks are not one")
    for r, rec in enumerate(recs):
        check_launches(f"mesh {label} rank {r}", rec["stats"], launches)
        _say_memory(f"{label} rank {r}", rec)
    return {name: n for name, (n, _) in a["stats"].items()}, a["step_ms"]


def _mesh_mmea(argv):
    """``cli.train_mmea.main`` on ``argv`` with the launch counts set to 0
    just before it: (the runner, its record)."""
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    kernels.reset_stats()
    with _MemoryMarks() as marks:
        runner = main(argv)
        torch.cuda.synchronize()
    return runner, _mmea_record(runner, marks)


def _mesh_mkgc(smi):
    """(d): MKGC ``data:1`` against the plain CLI run bit for bit, then,
    in both negative branches, two ranks over gloo against one rank at
    their batch size."""
    from snag_tpu_torch.cli.train_mkgc import main
    path = ["--device", "cuda", "--data_path", str(WORK / "mesh_mkgc")]
    runs = [main(MKGC_MESH + path + ["--exp_id", exp] + extra)
            for exp, extra in (("plain", []),
                               ("one", ["--mesh_shape", "data:1"]))]
    same = (runs[0].losses == runs[1].losses
            and runs[0].last_metrics == runs[1].last_metrics
            and _state_digest(runs[0].model) == _state_digest(runs[1].model))
    say("mesh", f"(d) MKGC data:1 against plain: losses {runs[1].losses}, "
        f"test {runs[1].last_metrics} | bit for bit: {same}")
    if not same:
        raise AssertionError("MKGC data:1 is not the plain run")
    del runs
    for branch, argv in (("all-entity", MKGC_MESH),
                         ("role-mixed", MKGC_MESH_MIXED)):
        _mesh_mkgc_branch(branch, argv, path, smi)


def _mesh_mkgc_branch(branch, argv, path, smi):
    """(d) in one negative branch: two ranks over gloo against one rank
    at their batch size."""
    label = f"(d) MKGC {branch}"
    recs = _spawn_ranks(f"{label} data:2", "mkgc", argv + [
        "--device", "cuda:0", "--data_path", str(WORK / "mesh_mkgc"),
        "--mesh_shape", "data:2"], "gloo", "cuda")
    want = _mkgc_epochs(argv + path, recs[0]["batch_size"])
    a = recs[0]
    if any(r["fused_all"] != (branch == "all-entity")
           for r in recs + [want]):
        raise AssertionError(f"{label}: another branch ran")
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                  want["losses"]))
    perr = _max_param_err(a["params"], want["params"])
    agree = min(float((r["ranks"] == r["ranks_one"]).mean()) for r in recs)
    say("mesh", f"{label}, two ranks over gloo, batch {a['batch_size']}: "
        f"epoch losses {a['losses']} against {want['losses']} (max rel "
        f"{rel:.2e}, limit 5e-3) | weights: max err / (2e-5 + 2e-3 |w|) "
        f"{perr:.3f} (limit 1) | sharded filtered ranks equal to the "
        f"one-rank evaluator's on {agree:.4f} (limit > 0.99) | {smi}")
    if (recs[0]["losses"] != recs[1]["losses"] or rel > 5e-3 or perr > 1.0
            or agree <= 0.99):
        raise AssertionError(f"{label}: two ranks are not one")
    _say_memory(f"{label}, one rank, this process", want)
    for r, rec in enumerate(recs):
        check_launches(f"mesh {label} rank {r}", rec["stats"], set())
        _say_memory(f"{label} rank {r}" + (
            " (all-entity fusion: no fetch)" if branch == "all-entity"
            else ""), rec)


def phase_mesh():
    """``--mesh_shape data:N`` on the card (the module docstring's phase
    14).  Returns the launches of (a)'s and (b)'s runs (rank 0's)."""
    import numpy as np
    import torch
    smi = card_smi()
    t0 = time.perf_counter()

    def argv(label, *extra):
        return MESH_ARGS + ["--data_path", str(WORK / f"mesh_{label}"),
                            "--exp_name", f"chip_smoke_mesh_{label}",
                            *extra]

    plain, want = _mesh_mmea(argv("plain", "--device", "cuda"))
    one, got = _mesh_mmea(argv("one", "--device", "cuda", "--mesh_shape",
                               "data:1"))
    if one.mesh is None or one.mesh.world != 1:
        raise AssertionError(f"(a) ran without its mesh: {one.mesh}")
    same = (got["step_losses"] == want["step_losses"]
            and got["digest"] == want["digest"]
            and np.array_equal(got["ranks"], want["ranks"]))
    say("mesh", f"(a) data:1 over NCCL against the plain run: "
        f"{len(got['step_losses'])} step losses, weights sha256 "
        f"{got['digest'][:16]}, {len(got['ranks'])} final ranks | bit for "
        f"bit: {same} | promoted {one.promoted}, MRR l2r {got['mrr'][0]:.6f}")
    if not same:
        raise AssertionError("data:1 is not the plain run")
    expected = f32_kernels() - {SEGMENT_KERNEL}
    check_launches("mesh (a) plain", want["stats"], expected)
    check_launches("mesh (a) data:1", got["stats"], expected)
    _say_memory("(a) plain", want)
    _say_memory("(a) data:1", got)
    if not MESH_KERNELS <= expected:
        raise AssertionError("rows 1-6 are not all on the path")
    launches = [{k: n for k, (n, _) in rec["stats"].items()}
                for rec in (want, got)]
    del plain, one

    b_launches, b_ms = _check_ranks("(b) data:2 gloo, one card",
                                    _spawn_ranks(
        "(b) data:2 gloo", "mmea", argv("gloo", "--device", "cuda:0",
                                        "--mesh_shape", "data:2"),
        "gloo", "cuda"), want, MESH_KERNELS)
    launches.append(b_launches)
    if torch.cuda.device_count() >= 2:
        launches.append(_check_ranks("(c) data:2 NCCL, two cards",
                                     _spawn_ranks(
            "(c) data:2 nccl", "mmea", argv("nccl", "--device", "cuda",
                                            "--mesh_shape", "data:2"),
            "nccl", "cuda"), want, MESH_KERNELS)[0])
    else:
        say("mesh", f"(c) NCCL with one rank a card: skipped, "
            f"{torch.cuda.device_count()} card visible")
    say("mesh", f"warm step ms (median, CUDA events): (a) plain "
        f"{want['step_ms']:.3f}, (a) data:1 {got['step_ms']:.3f}, (b) two "
        f"ranks sharing the card, rank 0 {b_ms:.3f} | {smi} | not a speed "
        "claim")
    _mesh_mkgc(smi)
    say("mesh", f"phase mesh {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from snag_tpu_torch.data.dataset import load_data

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    data = load_data(cfg_from(BENCH_ARGS + ["--device", "cpu"]))
    rows = [phase_gat(data.graph), phase_gat_bwd(data.graph)]
    rows += phase_rank()
    phase_rank(d=300)               # MCLEA's joint width; its rows not kept
    rows += phase_ntxent()
    rows += phase_mixture()
    rows.append(phase_segment(data.graph))
    rows += [phase_gat(data.graph, bf16=True),
             phase_gat_bwd(data.graph, bf16=True)]
    rows += phase_loss_bf16()
    rows.append(phase_segment_bf16(data.graph))
    phase_small()
    phase_train_small_all()
    phase_train_small_bf16()
    runs = [phase_slice(data), phase_train(), phase_train_bf16(),
            phase_slice_bf16(data), phase_gcn(data), phase_gcn_bf16(data)]
    runs += phase_families(data)
    runs += [phase_msnea(data), phase_accum_dropout()]
    parity_runs, parity_rows = phase_parity(data)
    runs += parity_runs
    rows += parity_rows
    del data
    runs.append(phase_files())
    phase_mkgc()
    runs += phase_mesh()

    meta = {
        "gat_attention_fwd": ("snag_tpu_torch/csrc/gat_attention.cu",
                              "snag_tpu/ops/pallas/gat_attention.py:116"),
        "gat_bwd": ("snag_tpu_torch/csrc/gat_bwd.cu",
                    "snag_tpu/ops/pallas/gat_bwd.py:159"),
        "rank_topk_mean": ("snag_tpu_torch/csrc/rank_eval.cu",
                           "snag_tpu/ops/pallas/rank_eval.py:177"),
        "rank_counts": ("snag_tpu_torch/csrc/rank_eval.cu",
                        "snag_tpu/ops/pallas/rank_eval.py:202"),
        "ntxent_lse": ("snag_tpu_torch/csrc/gram_lse.cuh",
                       "snag_tpu/ops/pallas/ntxent_kernel.py:162"),
        "ntxent_grad": ("snag_tpu_torch/csrc/gram_grad.cuh",
                        "snag_tpu/ops/pallas/ntxent_kernel.py:191"),
        "mixture_lse": ("snag_tpu_torch/csrc/gram_lse.cuh",
                        "snag_tpu/ops/pallas/snag_loss_kernel.py:231"),
        "mixture_grad": ("snag_tpu_torch/csrc/gram_grad.cuh",
                         "snag_tpu/ops/pallas/snag_loss_kernel.py:259"),
        SEGMENT_KERNEL: ("snag_tpu_torch/csrc/tile_segment.cu",
                         "snag_tpu/ops/pallas/tile_segment.py:242"),
    }
    # each bf16 entry: the same source and TPU kernel as its f32 one, but
    # for the gradients, which have a kernel of their own
    meta.update({f"{name}_bf16": meta[name] for name in (
        "gat_attention_fwd", "gat_bwd", "ntxent_lse", "mixture_lse",
        SEGMENT_KERNEL)})
    meta.update({f"{name}_bf16": ("snag_tpu_torch/csrc/gram_grad_bf16.cuh",
                                  meta[name][1])
                 for name in ("ntxent_grad", "mixture_grad")})
    # the wide instantiations: their kernel's source and TPU kernel
    meta.update({name: meta[name[:-len("_wide")]] for name in WIDE_KERNELS
                 if name.endswith("_wide")})
    meta["rank_topk_mean_long"] = meta["rank_topk_mean"]
    kernels = [{"name": r["name"], "route": "cuda",
                "source": meta[r["name"]][0], "replaces": meta[r["name"]][1],
                "launches": sum(run[r["name"]] for run in runs),
                **{k: r[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "bound_share", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
               for r in rows]
    if {k["name"] for k in kernels} != set(meta) or \
            not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel is missing or never launched: "
                             f"{kernels}")
    say("done", f"chip_smoke.py wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
