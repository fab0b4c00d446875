#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``snag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
the exit code is non-zero:

1. the card's name and power limit (nvidia-smi) and the CUDA version;
2. build the four kernel sources of ``snag_tpu_torch/csrc/*.cu`` with nvcc
   for sm_90a (into the git-ignored ``build/kernels``), one nvcc each, in
   parallel;
3. each of the six kernels against its plain-PyTorch twin on the card, at
   the shapes the bench geometry gives it, with max errors and median times
   (CUDA events, 5 runs);
4. a small input through the port on the GPU and on the CPU (twins):
   embeddings and ranks must agree; then three deterministic train steps
   from the same init: losses and parameters must agree;
5. serving: ``snag_tpu_torch.cli.train_mmea.main`` with ``--only_test 1``
   at the bench geometry (30,000 entities, 2 x 2 GAT at d = 300, CSLS k = 3,
   10,500 test pairs) from a seeded random init saved as a reference
   ``.pkl``; its three kernels must have launched and no twin may have run;
6. training: ``main`` at the same geometry with batch 3500, 12 epochs, IL
   from epoch 2 (promotion at epoch 9), noise 0.2/0.7 and
   ``--fused_snag_loss 0``; all six kernels must have launched, no twin may
   have run, the losses must be finite and fall, promotion must add pairs
   and the final metrics lie in [0, 1].

The line before last is the per-kernel JSON record (launches from the
training run); the last line is ``{"ok": true, "device": {...}}``.  Needs
CUDA; exits non-zero without it.
"""

from __future__ import annotations

import csv
import json
import math
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
    "--mask_ratio", "0.7", "--fused_snag_loss", "0",
]
KERNELS = ("gat_attention", "rank_eval", "gat_bwd", "ntxent")
SERVING_KERNELS = ("gat_attention_fwd", "rank_topk_mean", "rank_counts")
# (name, M, B, d, valid rows) of the NT-Xent calls of one training step at
# the bench geometry: IIR and ECIA over the 4 modalities' hidden / encoder
# rows, GMI over the two 1200-wide joint paths; ECIA is shown with the
# padded last batch (1,000 of 3,500 rows valid)
NTXENT_SHAPES = (("IIR", 4, 3500, 300, 3500), ("ECIA", 4, 3500, 300, 1000),
                 ("GMI", 2, 3500, 1200, 3500))


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cfg_from(argv):
    from snag_tpu_torch.config import (build_argparser, config_from_args,
                                       finalize_config)
    return finalize_config(config_from_args(build_argparser().parse_args(argv)))


def median_ms(fn) -> float:
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


# ------------------------------------------------------------------ phases

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
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


def phase_gat(graph_np):
    import numpy as np
    import torch
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    n, c, h = graph_np.n_nodes, 300, 2
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    g = graph_np.to_torch(dev)
    x = torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32), device=dev)
    s_src = torch.as_tensor(rng.normal(size=(n, h)).astype(np.float32), device=dev)
    s_dst = torch.as_tensor(rng.normal(size=(n, h)).astype(np.float32), device=dev)
    agg, rs = ga.gat_attention_cuda(x, s_src, s_dst, g)
    torch.cuda.synchronize()
    want_agg, want_rs = ga.gat_attention_twin(x, s_src, s_dst, g)
    err_agg = (agg - want_agg).abs().max().item()
    err_rs = (rs - want_rs).abs().max().item()
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rs, want_rs, rtol=1e-5, atol=1e-5)
    ms = median_ms(lambda: ga.gat_attention_cuda(x, s_src, s_dst, g))
    plain = median_ms(lambda: ga.gat_attention_twin(x, s_src, s_dst, g))
    say("gat", f"N={n} E={g.n_edges} C={c} H={h}: max|agg err| {err_agg:.3e}"
        f" max|rowsum err| {err_rs:.3e} (rtol=atol=1e-5) | kernel {ms:.4f} ms"
        f" twin {plain:.4f} ms")
    return {"name": ga.STATS.name, "max_abs_err": max(err_agg, err_rs),
            "ms": ms, "plain_ms": plain}


def phase_gat_bwd(graph_np):
    """The GAT backward kernel against its index_add_ twin at the slice
    shapes.  Per-edge dot products over C and the heads are summed in
    another order: rtol = atol = 1e-4."""
    import numpy as np
    import torch
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    n, c, h = graph_np.n_nodes, 300, 2
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    g = graph_np.to_torch(dev)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, s_src, s_dst, g_agg, g_rs = t(n, c), t(n, h), t(n, h), t(n, h, c), t(n, h)
    got = gb.gat_backward_cuda(x, s_src, s_dst, g_agg, g_rs, g)
    torch.cuda.synchronize()
    want = gb.gat_backward_twin(x, s_src, s_dst, g_agg, g_rs, g)
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    ms = median_ms(lambda: gb.gat_backward_cuda(x, s_src, s_dst, g_agg,
                                                g_rs, g))
    plain = median_ms(lambda: gb.gat_backward_twin(x, s_src, s_dst, g_agg,
                                                   g_rs, g))
    say("gat_bwd", f"N={n} E={g.n_edges} C={c} H={h}: max|err| d_x "
        f"{errs[0]:.3e} d_s_src {errs[1]:.3e} d_s_dst {errs[2]:.3e} "
        f"(rtol=atol=1e-4) | kernel {ms:.4f} ms twin {plain:.4f} ms")
    return {"name": gb.STATS.name, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain}


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


def phase_rank(n=10500, d=1200, k=3):
    import torch
    from snag_tpu_torch.eval.ranking import result_from_ranks
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    x, y = _eval_inputs(n, d)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)

    # sweep A against its plain version
    mean, diag = rk.topk_mean_cuda(x, y, xn, yn, k)
    torch.cuda.synchronize()
    p_mean, p_diag = rk.topk_mean_twin(x, y, xn, yn, k)
    err_a = max((mean - p_mean).abs().max().item(),
                (diag - p_diag).abs().max().item())
    torch.testing.assert_close(mean, p_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(diag, p_diag, rtol=1e-5, atol=1e-5)
    ms_a = median_ms(lambda: rk.topk_mean_cuda(x, y, xn, yn, k))
    plain_a = median_ms(lambda: rk.topk_mean_twin(x, y, xn, yn, k))
    say("rank", f"sweep A N={n} d={d} k={k}: max|mean/diag err| {err_a:.3e}"
        f" (rtol=atol=1e-5) | kernel {ms_a:.3f} ms plain {plain_a:.3f} ms")

    # sweep B against its plain version, fed the same CSLS terms
    rr, _ = rk.topk_mean_cuda(y, x, yn, xn, k)
    counts, top3 = rk.rank_counts_cuda(x, y, xn, yn, mean, rr, diag, True)
    torch.cuda.synchronize()
    p_counts, p_top3 = rk.rank_counts_twin(x, y, xn, yn, mean, rr, diag, True)
    ranks, p_ranks = counts.sum(dim=1), p_counts.sum(dim=1)
    agree_b = (ranks == p_ranks).float().mean().item()
    err_b = (ranks - p_ranks).abs().max().item()
    top3_agree = (top3 == p_top3).all(dim=1).float().mean().item()
    ms_b = median_ms(lambda: rk.rank_counts_cuda(x, y, xn, yn, mean, rr,
                                                 diag, True))
    plain_b = median_ms(lambda: rk.rank_counts_twin(x, y, xn, yn, mean, rr,
                                                    diag, True))
    say("rank", f"sweep B: ranks equal on {agree_b:.6f} of queries, top-3 on"
        f" {top3_agree:.6f}, max|rank diff| {err_b} | kernel {ms_b:.3f} ms"
        f" plain {plain_b:.3f} ms")

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
        f" rank {rg.mr_l2r:.1f}) |"
        f" 4 sweeps {ms_all:.3f} ms dense twin {plain_all:.3f} ms")
    if agree < 0.999 or agree_b < 0.999 or dm > 1e-4:
        raise AssertionError(f"rank eval disagrees with its twin: {agree} "
                             f"{agree_b} {dm}")
    return [{"name": rk.STATS_TOPK.name, "max_abs_err": err_a, "ms": ms_a,
             "plain_ms": plain_a},
            {"name": rk.STATS_RANKS.name, "max_abs_err": float(err_b),
             "ms": ms_b, "plain_ms": plain_b}]


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
    """Both NT-Xent kernels against their dense twins at the three (M, B, d)
    shapes of a training step.  lse: atol 1e-5 (rtol 1e-5); gradient:
    max |err| <= 1e-4 * max |twin|.  The ms of the JSON record are the sums
    over the three shapes, i.e. one full-batch training step's calls."""
    import torch
    from snag_tpu_torch.ops.cuda import ntxent as nx
    err_lse = err_grad = 0.0
    tot = {"lse": 0.0, "lse_twin": 0.0, "grad": 0.0, "grad_twin": 0.0}
    for i, (label, m, b, d, n_valid) in enumerate(NTXENT_SHAPES):
        z, v, coef = _ntxent_inputs(m, b, d, n_valid, SEED + i)
        lse = nx.streaming_lse_cuda(z, v, tau)
        torch.cuda.synchronize()
        want = nx.streaming_lse_twin(z, v, tau)
        e_lse = (lse - want).abs().max().item()
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
        dz = nx.ntxent_grad_cuda(z, want, coef, v, tau)
        torch.cuda.synchronize()
        want_dz = nx.ntxent_grad_twin(z, want, coef, v, tau)
        e_dz = (dz - want_dz).abs().max().item()
        scale = want_dz.abs().max().item()
        if not e_dz <= 1e-4 * scale:
            raise AssertionError(f"ntxent_grad {label}: max|err| {e_dz} > "
                                 f"1e-4 * max|twin| {scale}")
        ms = {"lse": median_ms(lambda: nx.streaming_lse_cuda(z, v, tau)),
              "lse_twin": median_ms(lambda: nx.streaming_lse_twin(z, v, tau)),
              "grad": median_ms(lambda: nx.ntxent_grad_cuda(
                  z, want, coef, v, tau)),
              "grad_twin": median_ms(lambda: nx.ntxent_grad_twin(
                  z, want, coef, v, tau))}
        for k in tot:
            tot[k] += ms[k]
        err_lse = max(err_lse, e_lse)
        err_grad = max(err_grad, e_dz)
        say("ntxent", f"{label} (M={m}, B={b}, d={d}, {n_valid} valid): "
            f"max|lse err| {e_lse:.3e} | max|dz err| {e_dz:.3e} of "
            f"max|dz| {scale:.3e} | lse kernel {ms['lse']:.3f} ms twin "
            f"{ms['lse_twin']:.3f} ms | grad kernel {ms['grad']:.3f} ms twin "
            f"{ms['grad_twin']:.3f} ms")
        del z, v, coef, lse, want, dz, want_dz
        torch.cuda.empty_cache()
    return [{"name": nx.STATS_LSE.name, "max_abs_err": err_lse,
             "ms": tot["lse"], "plain_ms": tot["lse_twin"]},
            {"name": nx.STATS_GRAD.name, "max_abs_err": err_grad,
             "ms": tot["grad"], "plain_ms": tot["grad_twin"]}]


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


def phase_train_small():
    """Three deterministic train steps (no noise, no dropout) from the same
    init and batches on the GPU (kernels) and on the CPU (twins): losses
    within rel 1e-4, parameters within atol 1e-5.  All six modalities are
    active: with four, two weight_raw slots have a gradient that is zero
    in exact arithmetic and Adam turns its rounding noise into a step of
    either sign."""
    import numpy as np
    import torch
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.models.encoder import prepare_features
    from snag_tpu_torch.train.step import TrainStep
    cfg = cfg_from(SMALL_ARGS + ["--use_surface", "1", "--char_dim", "64",
                                 "--name_dim", "64", "--add_noise", "0",
                                 "--fused_snag_loss", "0", "--lr", "5e-4",
                                 "--scheduler", "cos", "--device", "cpu"])
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
        feats = prepare_features(cfg, data, device)
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
    say("train_small", f"{data.ent_num} entities, 3 steps of {b}: losses gpu "
        f"{lg} cpu {lc} (max rel diff {rel:.2e}, limit 1e-4) | max|param "
        f"gpu-cpu| {perr:.2e} (limit 1e-5)")
    if rel > 1e-4 or perr > 1e-5:
        raise AssertionError("GPU and CPU training steps disagree")


def phase_slice(data):
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.ops import cuda as kernels
    from snag_tpu_torch.utils.import_reference import save_reference_checkpoint

    cfg = cfg_from(BENCH_ARGS + ["--device", "cpu"])
    model = build_model(cfg, data, torch.Generator().manual_seed(SEED))
    pkl = save_reference_checkpoint(model, str(WORK / "seeded_init.pkl"))
    del model
    argv = BENCH_ARGS + ["--only_test", "1", "--device", "cuda",
                         "--model_name_save", pkl, "--data_path",
                         str(WORK / "slice"), "--exp_name", "chip_smoke"]

    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {name: (s.launches, s.twin_calls)
             for name, s in kernels.all_stats().items()}
    cold = dict(runner.timings)
    res = runner.last_result
    n_test = len(runner.test_left)
    with open(runner.pred_path) as f:
        lines = list(csv.reader(f))
    runner.evaluate(last_epoch=True, save_name="warm")   # a second request
    warm = dict(runner.timings)
    metrics = [*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l]
    say("slice", f"{runner.data.ent_num} entities, {runner.graph.n_edges} "
        f"edges, {n_test} test pairs | first request: embed "
        f"{cold['embed_s']:.4f} s eval {cold['eval_s']:.4f} s | second: embed "
        f"{warm['embed_s']:.4f} s eval {warm['eval_s']:.4f} s | main() "
        f"{wall:.1f} s")
    say("slice", f"Hits@1/10/50 l2r {list(res.acc_l2r)} r2l "
        f"{list(res.acc_r2l)} MRR l2r {res.mrr_l2r:.6f} r2l "
        f"{res.mrr_r2l:.6f} | launches/twin calls {stats}")
    if (runner.data.ent_num, runner.graph.n_edges, n_test) != (30000, 329862, 10500):
        raise AssertionError("slice geometry differs from the bench geometry")
    if not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics):
        raise AssertionError(f"metrics out of range: {metrics}")
    if len(lines) != n_test + 1:
        raise AssertionError(f"top-3 CSV has {len(lines)} lines")
    # serving runs the forward and eval kernels; the training kernels
    # must stay idle, and no twin may run
    for name, (launches, twin_calls) in stats.items():
        if (launches > 0) != (name in SERVING_KERNELS) or twin_calls != 0:
            raise AssertionError(f"{name}: {launches} launches, "
                                 f"{twin_calls} twin calls in the slice")


def phase_train():
    """The training path at the bench geometry through the CLI entry."""
    import torch
    from snag_tpu_torch.cli.train_mmea import main
    from snag_tpu_torch.ops import cuda as kernels
    argv = BENCH_ARGS + TRAIN_ARGS + [
        "--device", "cuda", "--data_path", str(WORK / "train"),
        "--exp_name", "chip_smoke_train", "--no_tensorboard"]
    kernels.reset_stats()
    t0 = time.perf_counter()
    runner = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {name: (s.launches, s.twin_calls)
             for name, s in kernels.all_stats().items()}
    losses = runner.loss_log.loss[1:]
    res = runner.last_result
    metrics = [*res.acc_l2r, *res.acc_r2l, res.mrr_l2r, res.mrr_r2l]
    steps = runner.step_ms
    # the first epoch's steps pay one-off start-up; the warm median is
    # taken over the steps after it
    per_epoch0 = -(-len(runner.data.train_ill) // runner.cfg.batch_size)
    warm = steps[per_epoch0:]
    say("train", f"{len(losses)} epochs, {len(steps)} steps, main() "
        f"{wall:.1f} s | epoch losses {[round(x, 4) for x in losses]}")
    say("train", f"promoted {runner.promoted} pairs, train pairs "
        f"{len(runner.data.train_ill)} -> {len(runner.train_ill)} | final "
        f"Hits@1/10/50 l2r {res.acc_l2r.tolist()} MRR l2r {res.mrr_l2r:.6f} "
        f"r2l {res.mrr_r2l:.6f}")
    say("train", f"step ms (device, CUDA events): median warm "
        f"{statistics.median(warm):.3f} over {len(warm)} steps, first "
        f"{steps[0]:.3f} | launches/twin calls {stats}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not runner.promoted or sum(runner.promoted) <= 0:
        raise AssertionError(f"IL promotion added no pairs: {runner.promoted}")
    if not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics):
        raise AssertionError(f"metrics out of range: {metrics}")
    for name, (launches, twin_calls) in stats.items():
        if launches <= 0 or twin_calls != 0:
            raise AssertionError(f"{name}: {launches} launches, "
                                 f"{twin_calls} twin calls in training")
    return {name: launches for name, (launches, _) in stats.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from snag_tpu_torch.data.dataset import load_data

    phase_device()
    phase_build()
    data = load_data(cfg_from(BENCH_ARGS + ["--device", "cpu"]))
    rows = [phase_gat(data.graph), phase_gat_bwd(data.graph)]
    rows += phase_rank()
    rows += phase_ntxent()
    phase_small()
    phase_train_small()
    phase_slice(data)
    del data
    launches = phase_train()

    meta = {
        "gat_attention_fwd": ("snag_tpu_torch/csrc/gat_attention.cu",
                              "snag_tpu/ops/pallas/gat_attention.py:116"),
        "gat_bwd": ("snag_tpu_torch/csrc/gat_bwd.cu",
                    "snag_tpu/ops/pallas/gat_bwd.py:159"),
        "rank_topk_mean": ("snag_tpu_torch/csrc/rank_eval.cu",
                           "snag_tpu/ops/pallas/rank_eval.py:177"),
        "rank_counts": ("snag_tpu_torch/csrc/rank_eval.cu",
                        "snag_tpu/ops/pallas/rank_eval.py:202"),
        "ntxent_lse": ("snag_tpu_torch/csrc/ntxent.cu",
                       "snag_tpu/ops/pallas/ntxent_kernel.py:162"),
        "ntxent_grad": ("snag_tpu_torch/csrc/ntxent.cu",
                        "snag_tpu/ops/pallas/ntxent_kernel.py:191"),
    }
    kernels = [{"name": r["name"], "route": "cuda",
                "source": meta[r["name"]][0], "replaces": meta[r["name"]][1],
                "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
