#!/usr/bin/env python3
"""The weighted segment sum of a checkout of the PyTorch port, timed
closely on one NVIDIA GPU.

    python3 scripts/torch_segment_ab.py ROOT

Imports ``snag_tpu_torch`` from ROOT (a checkout, or a copy of one with
other kernel constants), builds its kernels there, and on the bench graph
(``chip_smoke.BENCH_ARGS``: 30,000 nodes, 329,862 edges) with
``chip_smoke.segment_inputs`` runs ``weighted_segment_sum_cuda`` at
C = 300, H = 1 (the GCN's adjacency) and its backward launch on g_agg with
w[rev], then at C = 30, H = 1, C = 319, H = 2 and C = 64, H = 5.  For
each it prints the first 12 hex digits of the sha256 of agg and rowsum,
the median of 5 ``chip_smoke.device_ms`` readings (each itself the median
of 5 calls) and their least and greatest, and the kernel's registers and
spills where this process built it, as one JSON line.  Run each checkout
in its own process, in turns on one card (A, B, B, A).
"""

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
    from torch_grad_ab import digest
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
        for name, fn in runs:
            sha = digest(*fn())
            reps = [cs.device_ms(fn, cs.DEVICE_KERNELS[ts.STATS.name])
                    for _ in range(5)]
            out[name] = {"sha": sha[:12], "device_ms": statistics.median(reps),
                         "spread": [min(reps), max(reps)]}
    out["ptxas"] = cs.segment_ptxas(ts._library())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
