#!/usr/bin/env python3
"""The weighted segment sum of a checkout of the PyTorch port, timed
closely on one NVIDIA GPU.

    python3 scripts/torch_segment_ab.py ROOT

Imports ``snag_tpu_torch`` from ROOT (a checkout, or a copy of one with
other kernel constants), builds its kernels there, and on the bench graph
(``chip_smoke.BENCH_ARGS``: 30,000 nodes, 329,862 edges) with
``chip_smoke.segment_inputs`` runs ``weighted_segment_sum_cuda`` at
C = 300, H = 1 (the GCN's adjacency) and its backward launch on g_agg with
w[rev], then at C = 30, H = 1, C = 319, H = 2 and C = 64, H = 5; then
its bf16 entry, ``weighted_segment_sum_bf16``, on the same inputs rounded
to bf16 (records "bf16 ..."): the forward at every shape, and at C = 300
the bf16 GCN's backward launch (``round_term``), whose d_x is bf16: the
launch with ``out_bf16`` where ROOT's wrapper has it, else its f32 agg
cast to bf16 (the cast's kernel not timed), so that the digests compare
like for like.  For each it prints the first 12 hex digits of the sha256
of each output, the median of 5 ``chip_smoke.device_ms`` readings (each
itself the median of 5 calls) and their least and greatest, and the
kernels' registers and spills where this process built them, as one JSON
line.  Run each checkout in its own process, in turns on one card (A, B,
B, A).
"""

import inspect
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_segment_ab: torch.cuda is not available; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke as cs
    from torch_segment_phases import ptxas
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.ops.cuda import tile_segment as ts
    if not ts.__file__.startswith(root):
        raise RuntimeError(f"imported {ts.__file__}, not from {root}")
    graph = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"])).graph
    out = {"root": sys.argv[1]}
    for label, c, h in (("C300 H1", 300, 1), ("C30 H1", 30, 1),
                        ("C319 H2", 319, 2), ("C64 H5", 64, 5)):
        g, x, e, e_rev, g_agg = cs.segment_inputs(graph, c, h)
        runs = [(label, lambda: ts.weighted_segment_sum_cuda(x, e, g))]
        if c == 300:
            runs.append(("bwd", lambda: ts.weighted_segment_sum_cuda(
                g_agg, e_rev, g)))
        timed(cs, out, runs, ts.STATS.name)
    bf = torch.bfloat16
    out_bf16 = "out_bf16" in inspect.signature(
        ts.weighted_segment_sum_cuda).parameters
    for label, c, h in (("C300 H1", 300, 1), ("C30 H1", 30, 1),
                        ("C319 H2", 319, 2), ("C64 H5", 64, 5)):
        g, x, e, e_rev, g_agg = cs.segment_inputs(graph, c, h)
        x, e, e_rev, g_agg = (t.to(bf) for t in (x, e, e_rev, g_agg))
        runs = [(f"bf16 {label}", lambda: ts.weighted_segment_sum_cuda(
            x, e, g))]
        if c == 300 and out_bf16:
            runs.append(("bf16 bwd", lambda: ts.weighted_segment_sum_cuda(
                g_agg, e_rev, g, round_term=True, out_bf16=True)[:1]))
        elif c == 300:
            runs.append(("bf16 bwd", lambda: (ts.weighted_segment_sum_cuda(
                g_agg, e_rev, g, round_term=True)[0].to(bf),)))
        timed(cs, out, runs, ts.STATS_BF16.name)
    out["ptxas"] = cs.segment_ptxas(ts._library())
    out["ptxas_bf16"] = ptxas(cs, ts._library())
    print(json.dumps(out))
    return 0


def timed(cs, out, runs, kernel):
    """Each run's outputs' short digests and its device ms, into out."""
    from torch_grad_ab import digest
    for name, fn in runs:
        reps = [cs.device_ms(fn, cs.DEVICE_KERNELS[kernel]) for _ in range(5)]
        out[name] = {"sha": [digest(o)[:12] for o in fn()],
                     "device_ms": statistics.median(reps),
                     "spread": [min(reps), max(reps)]}


if __name__ == "__main__":
    sys.exit(main())
