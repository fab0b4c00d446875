#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``snag_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and
the exit code is non-zero:

1. the card's name and power limit (nvidia-smi) and the CUDA version;
2. build the three kernels from ``snag_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a (into the git-ignored ``build/kernels``);
3. each kernel against its plain-PyTorch twin on the card, at the slice
   shapes, with max errors and median times (CUDA events, 5 runs);
4. a small input through the port on the GPU and on the CPU (twins):
   embeddings and ranks must agree;
5. the slice: ``snag_tpu_torch.cli.train_mmea.main`` with ``--only_test 1``
   at the bench geometry (30,000 entities, 2 x 2 GAT at d = 300, CSLS k = 3,
   10,500 test pairs) from a seeded random init saved as a reference
   ``.pkl``; every kernel must have launched and no twin may have run.

The line before last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import csv
import json
import math
import statistics
import subprocess
import sys
import time
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
    for name in ("gat_attention", "rank_eval"):
        built = load_library(name)
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
    for name, (launches, twin_calls) in stats.items():
        if launches <= 0 or twin_calls != 0:
            raise AssertionError(f"{name}: {launches} launches, "
                                 f"{twin_calls} twin calls in the slice")
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
    rows = [phase_gat(data.graph)]
    rows += phase_rank()
    phase_small()
    launches = phase_slice(data)

    meta = {
        "gat_attention_fwd": ("snag_tpu_torch/csrc/gat_attention.cu",
                              "snag_tpu/ops/pallas/gat_attention.py:116"),
        "rank_topk_mean": ("snag_tpu_torch/csrc/rank_eval.cu",
                           "snag_tpu/ops/pallas/rank_eval.py:177"),
        "rank_counts": ("snag_tpu_torch/csrc/rank_eval.cu",
                        "snag_tpu/ops/pallas/rank_eval.py:202"),
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
