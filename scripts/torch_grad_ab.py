#!/usr/bin/env python3
"""The loss kernels (both gradients and both lse), the two rank sweeps,
the two GAT kernels and the weighted segment sum of a checkout of the
PyTorch port, timed and fingerprinted on one NVIDIA GPU.

    python3 scripts/torch_grad_ab.py [--root DIR] [--out FILE] [--against FILE]
                                     [--changed SECTION ...]

Imports ``snag_tpu_torch`` from DIR (default: this checkout), builds its
kernels there, and on ``chip_smoke.py``'s inputs runs

* ``mixture_grad_cuda`` at ``chip_smoke.MIXTURE_SHAPES``: the sha256 of
  the bytes of dz, dalpha and dbeta, and the median ms of 5 runs;
  ``mixture_lse_cuda`` there: the sha256 of lse and the median ms; and
  the f32 gradient past one modality's fit in its accumulator
  (``chip_smoke.MIXTURE_WIDE``, section ``mixture_grad_wide``: the wide
  body, or a parent's feature chunks), or the error a checkout that
  refused the shape raised;
* ``ntxent_grad_cuda`` at ``chip_smoke.NTXENT_SHAPES``: the sha256 of dz
  and the median ms, or the error the wrapper raised, in section
  ``ntxent_grad``, or ``ntxent_grad_wide`` where the checkout's plan
  takes the wide body (GMI6, past the main-path body's accumulator);
  ``streaming_lse_cuda`` there: the sha256 of lse and the median ms;
* the rank sweeps at ``chip_smoke._eval_inputs(10500, 1200)``:
  ``topk_mean_cuda`` (sha256 of mean and diag) for each direction at
  k = 3 and for l2r at k = 1; ``rank_counts_cuda`` (sha256 of counts and
  top-3) for l2r with CSLS, of counts for r2l with CSLS and for l2r
  without; the median ms of each; and, where the checkout has them,
  ``topk_mean_both_cuda`` and ``rank_counts_both_cuda`` (both directions
  in one launch): their median ms, and it fails unless their outputs have
  the digests of the one-direction records they reproduce.  In a checkout
  whose every launch does both directions, the one-direction calls return
  the row direction of such a launch and take its time.  Where the checkout
  has sweep A's long lists, ``topk_mean_both_cuda`` at each k of
  ``LONG_KS`` (CSLS k > 10): the sha256 of mean, diag and mean_cols and
  the median ms, records ``A both k<k>``;
* the GAT kernels on the bench graph (``chip_smoke.BENCH_ARGS``: 30,000
  nodes, 329,862 edges) with ``chip_smoke.gat_inputs`` and
  ``gat_bwd_inputs`` at C = 300, H = 2 (float4 slices), C = 30, H = 1 and
  C = 319, H = 2 (single floats): ``gat_attention_cuda`` (sha256 of agg and
  of rowsum) and ``gat_backward_cuda`` (sha256 of d_x, d_s_src and
  d_s_dst), each with its median ms, and the registers and spills of the
  kernels (``chip_smoke.gat_ptxas``) where this process built them; and
  the forward's wide path at ``chip_smoke.PARITY_GAT`` on
  ``gat_bwd_inputs``, f32 and bf16 (sections ``gat_fwd_wide`` and
  ``gat_fwd_wide_bf16``: sha256 of agg and of rowsum, the median times,
  and the wide kernels' registers and spills);
* the weighted segment sum on the bench graph with
  ``chip_smoke.segment_inputs``: ``weighted_segment_sum_cuda`` on the
  GCN's adjacency at C = 300, H = 1 and its backward launch on g_agg with
  w[rev], then on C = 30, H = 1 (adjacency), C = 319, H = 2 and C = 64,
  H = 5 (seeded weights): the sha256 of agg and of rowsum and the median
  ms, and the kernel's registers and spills (``chip_smoke.segment_ptxas``);
* where the checkout has them, the bf16 entries (``--dtype bfloat16``) on
  the same inputs rounded to bf16: both GAT kernels at C = 300, H = 2 and
  C = 319, H = 2, ``mixture_lse_cuda`` and ``mixture_grad_cuda`` at the
  first two ``MIXTURE_SHAPES`` (the gradient fed the bf16 lse), and
  ``streaming_lse_cuda`` and ``ntxent_grad_cuda`` at ``NTXENT_SHAPES``,
  and the weighted segment sum at the segment shapes above (the bf16
  adjacency at H = 1, its backward launch with ``round_term`` on
  ``w_rev`` in bf16 and g_agg in bf16), each output's sha256 and the
  median times, in sections named ``<section>_bf16``, with the bf16
  segment kernel's registers and spills (``chip_smoke.segment_bf16_ptxas``).

Every median ms comes twice: ``ms`` (``chip_smoke.median_ms``, one launch
between two CUDA events, which under ~0.2 ms also counts the wrapper's
Python) and ``device_ms`` (``chip_smoke.device_ms``, the profiler's device
time of the kernels the call launched, named as in
``chip_smoke.DEVICE_KERNELS``).  Both timers come from this checkout's
``chip_smoke.py``, whichever ``--root`` is timed.

It prints one JSON line with the card's name and power limit, and writes it
to FILE.  With ``--against`` it fails unless every digest equals that of
an earlier run's FILE: the check that two builds compute the same bits;
it also prints each record's ``device_ms`` in both runs.  ``--changed``
names the sections (e.g. ``mixture_lse_bf16``) whose bits a change is
meant to move: their digests are still compared and reported, but a
difference there does not fail the run.
A section the earlier run does not have at all (the bf16 sections against
a checkout without bf16 entries) is reported and skipped.
Run each checkout in its own process (two packages of one name cannot
share one), in turns on one card: A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAU = 0.1


def digest(*tensors) -> str:
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:        # numpy has no bf16: its bits
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    ap.add_argument("--against")
    ap.add_argument("--changed", nargs="*", default=[], choices=SECTIONS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_grad_ab: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # chip_smoke (inputs, shapes, timing) from this checkout, the package
    # from --root
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "package": str(Path(nx.__file__).parents[2]),
           "card": card}
    out.update(loss_records(cs, nx, sl))
    out["rank"] = rank_records(cs, rk)
    from snag_tpu_torch.data.dataset import load_data
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    out.update(gat_records(cs, graph))
    out["segment"] = segment_records(cs, graph)
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    out["ptxas"]["segment"] = ptxas_records(cs.segment_ptxas(ts._library()))
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    if hasattr(ga, "STATS_BF16"):
        out.update(bf16_records(cs, nx, sl, graph))
    if hasattr(ts, "STATS_BF16"):
        out["segment_bf16"] = segment_bf16_records(cs, graph)
        out["ptxas"]["segment_bf16"] = ptxas_records(
            cs.segment_bf16_ptxas(ts._library()))
    out.update(gat_wide_records(cs, graph))
    out["ptxas"]["gat_fwd_wide"] = ptxas_records(cs.kernel_ptxas(
        ga._library(), ("gat_attention_fwd_wide_kernel",
                        "gat_attention_fwd_bf16_wide_kernel")))

    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    if args.against:
        other = json.loads(Path(args.against).read_text())
        same = True
        for kind in SECTIONS:
            if kind in out and kind not in other:
                print(f"{kind}: not in {other['root']}, skipped")
                continue
            for label, rec in out.get(kind, {}).items():
                if "sha256" not in rec:
                    continue
                if "error" in other.get(kind, {}).get(label, {}):
                    print(f"{kind} {label}: {other['root']} raised, not "
                          "compared")
                    continue
                theirs = other.get(kind, {}).get(label, {}).get("sha256")
                ok = rec["sha256"] == theirs
                same &= ok or kind in args.changed
                verdict = ("bit-identical" if ok else
                           "MISSING in" if theirs is None else
                           "DIFFERENT (--changed)" if kind in args.changed
                           else "DIFFERENT")
                print(f"{kind} {label}: {verdict} to {other['root']}")
        for kind in SECTIONS:
            for label, rec in out.get(kind, {}).items():
                theirs = other.get(kind, {}).get(label, {})
                if "device_ms" in rec and "device_ms" in theirs:
                    print(f"{kind} {label}: device_ms {theirs['device_ms']:.4f}"
                          f" ({other['root']}) -> {rec['device_ms']:.4f}")
        if not same:
            return 1
    return 0


# CSLS k of the long-list records: the lists of 32 (11, 20) and 128
LONG_KS = (11, 20, 33, 64, 128)
SECTIONS = ("mixture_grad", "mixture_lse", "ntxent_lse", "ntxent_grad",
            "rank", "gat_fwd", "gat_bwd", "segment", "gat_fwd_wide")
SECTIONS += tuple(f"{k}_bf16" for k in SECTIONS if k != "rank")
SECTIONS += ("ntxent_grad_wide", "mixture_grad_wide")


def ptxas_records(rows):
    return [{"entry": name, "registers": regs, "spill_stores": st,
             "spill_loads": ld} for name, regs, st, ld in rows]


def timed(cs, fn, kernel):
    """The two median times of fn, whose launches are ``kernel``'s."""
    return {"ms": cs.median_ms(fn),
            "device_ms": cs.device_ms(fn, cs.DEVICE_KERNELS[kernel])}


def segment_records(cs, graph):
    """The weighted segment sum on the bench graph: one digest per output,
    and the median times under the shape's label."""
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    out = {}
    for label, c, h in (("C300 H1", 300, 1), ("C30 H1", 30, 1),
                        ("C319 H2", 319, 2), ("C64 H5", 64, 5)):
        g, x, e, e_rev, g_agg = cs.segment_inputs(graph, c, h)
        runs = [(label, lambda: ts.weighted_segment_sum_cuda(x, e, g))]
        if label == "C300 H1":
            runs.append(("C300 H1 backward", lambda: (
                ts.weighted_segment_sum_cuda(g_agg, e_rev, g))))
        for name, fn in runs:
            for part, t in zip(("agg", "rowsum"), fn()):
                out[f"{name} {part}"] = {"sha256": digest(t)}
            out[name] = timed(cs, fn, ts.STATS.name)
        del g, x, e, e_rev, g_agg
    return out


def segment_bf16_records(cs, graph):
    """The bf16 entry of the weighted segment sum on ``segment_records``'
    inputs rounded to bf16: one digest per output, and the median times."""
    import torch
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    bf = torch.bfloat16
    out = {}
    for label, c, h in (("C300 H1", 300, 1), ("C30 H1", 30, 1),
                        ("C319 H2", 319, 2), ("C64 H5", 64, 5)):
        g, x, e, e_rev, g_agg = cs.segment_inputs(graph, c, h)
        x, e, e_rev, g_agg = (t.to(bf) for t in (x, e, e_rev, g_agg))
        runs = [(label, lambda: ts.weighted_segment_sum_cuda(x, e, g))]
        if label == "C300 H1":
            runs.append(("C300 H1 backward", lambda: (
                ts.weighted_segment_sum_cuda(g_agg, e_rev, g,
                                             round_term=True))))
        for name, fn in runs:
            for part, t in zip(("agg", "rowsum"), fn()):
                out[f"{name} {part}"] = {"sha256": digest(t)}
            out[name] = timed(cs, fn, ts.STATS_BF16.name)
        del g, x, e, e_rev, g_agg
    return out


def gat_records(cs, graph):
    """Both GAT kernels on the bench graph: one digest per output, and the
    median times under the shape's label."""
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    out = {"gat_fwd": {}, "gat_bwd": {}}
    for label, c, h in (("C300 H2", 300, 2), ("C30 H1", 30, 1),
                        ("C319 H2", 319, 2)):
        fwd_in = cs.gat_inputs(graph, c, h)
        bwd_in = cs.gat_bwd_inputs(graph, c, h)
        fwd = (lambda: ga.gat_attention_cuda(*fwd_in[1:], fwd_in[0]),
               ("agg", "rowsum"), out["gat_fwd"], ga.STATS.name)
        bwd = (lambda: gb.gat_backward_cuda(*bwd_in[1:], bwd_in[0]),
               ("d_x", "d_s_src", "d_s_dst"), out["gat_bwd"], gb.STATS.name)
        for fn, names, rec, kernel in (fwd, bwd):
            for name, t in zip(names, fn()):
                rec[f"{label} {name}"] = {"sha256": digest(t)}
            rec[label] = timed(cs, fn, kernel)
    out["ptxas"] = {
        kind: ptxas_records(cs.gat_ptxas(lib, kernel))
        for kind, lib, kernel in (
            ("gat_fwd", ga._library(), "gat_attention_fwd_kernel"),
            ("gat_bwd", gb._library(), "gat_bwd_rows_kernel"))}
    return out


def gat_wide_records(cs, graph):
    """The GAT forward's wide path at ``chip_smoke.PARITY_GAT`` on
    ``gat_bwd_inputs``' x, s_src and s_dst, f32 and bf16: one digest per
    output, and the median times under the shape's label."""
    import torch
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    out = {"gat_fwd_wide": {}, "gat_fwd_wide_bf16": {}}
    for h, c in cs.PARITY_GAT:
        g, x, s_src, s_dst, _, _ = cs.gat_bwd_inputs(graph, c=c, h=h)
        label = f"H{h} C{c}"
        for kind, xs, stats in (
                ("gat_fwd_wide", x, ga.STATS_WIDE),
                ("gat_fwd_wide_bf16", x.to(torch.bfloat16),
                 ga.STATS_BF16_WIDE)):
            fn = (lambda xs=xs: ga.gat_attention_cuda(xs, s_src, s_dst, g))
            for name, t in zip(("agg", "rowsum"), fn()):
                out[kind][f"{label} {name}"] = {"sha256": digest(t)}
            out[kind][label] = timed(cs, fn, stats.name)
        del g, x, s_src, s_dst
        torch.cuda.empty_cache()
    return out


def bf16_records(cs, nx, sl, graph):
    """The bf16 entries: one digest per output, and the median times."""
    import torch
    from snag_tpu_torch.ops.cuda import gat_attention as ga
    from snag_tpu_torch.ops.cuda import gat_bwd as gb
    bf = torch.bfloat16
    out = {k: {} for k in SECTIONS if k.endswith("_bf16")
           and k not in ("segment_bf16", "gat_fwd_wide_bf16")}
    for label, c, h in (("C300 H2", 300, 2), ("C319 H2", 319, 2)):
        g, x, s_src, s_dst = cs.gat_inputs(graph, c, h)
        _, xb, sb, db, g_agg, g_rs = cs.gat_bwd_inputs(graph, c, h)
        x, xb, g_agg = x.to(bf), xb.to(bf), g_agg.to(bf)
        for fn, names, kind, kernel in (
                (lambda: ga.gat_attention_cuda(x, s_src, s_dst, g),
                 ("agg", "rowsum"), "gat_fwd_bf16", ga.STATS_BF16.name),
                (lambda: gb.gat_backward_cuda(xb, sb, db, g_agg, g_rs, g),
                 ("d_x", "d_s_src", "d_s_dst"), "gat_bwd_bf16",
                 gb.STATS_BF16.name)):
            for name, t in zip(names, fn()):
                out[kind][f"{label} {name}"] = {"sha256": digest(t)}
            out[kind][label] = timed(cs, fn, kernel)
    for i, (label, m, b, d, n_valid) in enumerate(cs.MIXTURE_SHAPES[:2]):
        z, alpha, beta, v, coef = cs._mixture_inputs(m, b, d, n_valid,
                                                     cs.SEED + i)
        z = z.to(bf)
        lse = sl.mixture_lse_cuda(z, alpha, beta, v, TAU)
        out["mixture_lse_bf16"][label] = {"sha256": digest(lse), **timed(
            cs, lambda: sl.mixture_lse_cuda(z, alpha, beta, v, TAU),
            sl.STATS_LSE_BF16.name)}
        got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU)
        out["mixture_grad_bf16"][label] = {"sha256": digest(*got), **timed(
            cs, lambda: sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v,
                                             TAU), sl.STATS_GRAD_BF16.name)}
        del z, alpha, beta, v, coef, lse, got
        torch.cuda.empty_cache()
    for i, (label, m, b, d, n_valid) in enumerate(cs.NTXENT_SHAPES):
        z, v, coef = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED + i)
        z = z.to(bf)
        lse = nx.streaming_lse_cuda(z, v, TAU)
        out["ntxent_lse_bf16"][label] = {"sha256": digest(lse), **timed(
            cs, lambda: nx.streaming_lse_cuda(z, v, TAU),
            nx.STATS_LSE_BF16.name)}
        dz = nx.ntxent_grad_cuda(z, lse, coef, v, TAU)
        out["ntxent_grad_bf16"][label] = {"sha256": digest(dz), **timed(
            cs, lambda: nx.ntxent_grad_cuda(z, lse, coef, v, TAU),
            nx.STATS_GRAD_BF16.name)}
        del z, v, coef, lse, dz
        torch.cuda.empty_cache()
    return out


def loss_records(cs, nx, sl):
    import torch
    out = {"mixture_grad": {}, "ntxent_grad": {}, "mixture_lse": {},
           "ntxent_lse": {}, "ntxent_grad_wide": {}, "mixture_grad_wide": {}}
    for i, (label, m, b, d, n_valid) in enumerate(cs.MIXTURE_SHAPES):
        z, alpha, beta, v, coef = cs._mixture_inputs(m, b, d, n_valid,
                                                     cs.SEED + i)
        lse = sl.mixture_lse_twin(z, alpha, beta, v, TAU)
        got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU)
        out["mixture_grad"][label] = {"sha256": digest(*got), **timed(
            cs, lambda: sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v,
                                             TAU), sl.STATS_GRAD.name)}
        got = sl.mixture_lse_cuda(z, alpha, beta, v, TAU)
        out["mixture_lse"][label] = {"sha256": digest(got), **timed(
            cs, lambda: sl.mixture_lse_cuda(z, alpha, beta, v, TAU),
            sl.STATS_LSE.name)}
        del z, alpha, beta, v, coef, lse, got
        torch.cuda.empty_cache()

    cap = sl._grad_cap(sl._library(), torch.device("cuda"))
    for label, m, b, d in cs.MIXTURE_WIDE:
        d = d or cap + 8
        z, alpha, beta, v, coef = cs._mixture_inputs(m, b, d, b, cs.SEED + d)
        lse = sl.mixture_lse_twin(z, alpha, beta, v, TAU)
        fn = (lambda: sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v,
                                           TAU))
        try:
            got = fn()
        except ValueError as e:
            out["mixture_grad_wide"][label] = {"error": str(e)}
        else:
            out["mixture_grad_wide"][label] = {
                "sha256": digest(*got), **timed(cs, fn, sl.STATS_GRAD.name)}
            del got
        del z, alpha, beta, v, coef, lse
        torch.cuda.empty_cache()

    for i, (label, m, b, d, n_valid) in enumerate(cs.NTXENT_SHAPES):
        z, v, coef = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED + i)
        lse = nx.streaming_lse_cuda(z, v, TAU)
        out["ntxent_lse"][label] = {"sha256": digest(lse), **timed(
            cs, lambda: nx.streaming_lse_cuda(z, v, TAU), nx.STATS_LSE.name)}
        lse = nx.streaming_lse_twin(z, v, TAU)
        wide = nx.grad_plan(m, 2 * b, d, z.device).get("wide")
        kind = "ntxent_grad_wide" if wide else "ntxent_grad"
        try:
            dz = nx.ntxent_grad_cuda(z, lse, coef, v, TAU)
        except ValueError as e:
            out[kind][label] = {"error": str(e)}
            continue
        out[kind][label] = {"sha256": digest(dz), **timed(
            cs, lambda: nx.ntxent_grad_cuda(z, lse, coef, v, TAU),
            nx.STATS_GRAD.name)}
        del z, v, coef, lse, dz
        torch.cuda.empty_cache()
    return out


def rank_records(cs, rk, n=10500, d=1200):
    """Both sweeps at the bench's eval shape, in the calls of ``two_sweeps``
    (each direction's CSLS terms from its own sweep A)."""
    import torch
    x, y = cs._eval_inputs(n, d)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    out = {}

    def sweep(label):
        return (rk.STATS_TOPK if label.startswith("A") else rk.STATS_RANKS).name

    def record(label, fn):
        got = [t for t in fn() if t is not None]
        out[label] = {"sha256": digest(*got), **timed(cs, fn, sweep(label))}
        return got

    mean_l, diag_l = record("A l2r k3", lambda: rk.topk_mean_cuda(
        x, y, xn, yn, 3))
    mean_r, diag_r = record("A r2l k3", lambda: rk.topk_mean_cuda(
        y, x, yn, xn, 3))
    _, diag_1 = record("A l2r k1", lambda: rk.topk_mean_cuda(x, y, xn, yn, 1))
    record("B l2r csls top3", lambda: rk.rank_counts_cuda(
        x, y, xn, yn, mean_l, mean_r, diag_l, True))
    record("B r2l csls", lambda: rk.rank_counts_cuda(
        y, x, yn, xn, mean_r, mean_l, diag_r, False))
    record("B l2r", lambda: rk.rank_counts_cuda(
        x, y, xn, yn, None, None, diag_1, False))
    if hasattr(rk, "topk_mean_both_cuda"):
        # both directions in one launch must give the bits above: their
        # digests go under the labels they reproduce
        both = {"A both k3": (lambda: rk.topk_mean_both_cuda(
                    x, y, xn, yn, 3), ("A l2r k3", (0, 1)), ("A r2l k3", (2, 1))),
                "B both csls top3": (lambda: rk.rank_counts_both_cuda(
                    x, y, xn, yn, mean_l, mean_r, diag_l, True),
                    ("B l2r csls top3", (0, 1)), ("B r2l csls", (2,)))}
        for label, (fn, *parts) in both.items():
            got = fn()
            out[label] = timed(cs, fn, sweep(label))
            for name, idx in parts:
                if digest(*[got[i] for i in idx]) != out[name]["sha256"]:
                    raise AssertionError(f"{label} differs from {name}")
    if hasattr(rk, "STATS_TOPK_LONG"):
        # sweep A's lists in shared memory (CSLS k > 10): mean, diag and
        # mean_cols of one call
        for k in LONG_KS:
            fn = (lambda k=k: rk.topk_mean_both_cuda(x, y, xn, yn, k))
            out[f"A both k{k}"] = {"sha256": digest(*fn()), **timed(
                cs, fn, rk.STATS_TOPK_LONG.name)}
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
