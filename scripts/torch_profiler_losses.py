#!/usr/bin/env python3
"""How often a profiler session loses device events, on one NVIDIA GPU.

    python3 scripts/torch_profiler_losses.py [--sessions 60] [--after_phases]
                                             [--out FILE]

Traces ``chip_smoke.device_ms``'s session (``chip_smoke.traced_calls``:
REPS counted calls, each in its ``record_function`` span, between
uncounted ones) ``--sessions`` times for each of two kernels at phase
``loss_bf16``'s MEAformer joint shape (M = 1, B = 3,500, d = 1,200 in
bf16): the NT-Xent gradient (~4 ms a call) and its lse (~0.2 ms), and
classifies each session as ``chip_smoke.call_kernel_ms`` does: ok,
``LostSession`` (no counted span on the card), ``PartialSession`` (some
spans, not all) or another shortfall.  With ``--after_phases`` it first
runs the phases that precede ``loss_bf16`` in ``chip_smoke.main`` (a long
process, as the smoke is when it reaches them).

Prints, and writes to FILE, one JSON object: the card's name and power
limit, the counts by outcome for each kernel, and for each session that
was not ok its outcome, the kernels seen and the ends of its host and
device events (us from the session's start).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def classify(events, names) -> dict:
    from torch.autograd import DeviceType
    try:
        cs.call_kernel_ms(events, names, cs.REPS)
        out = "ok"
    except cs.PROFILER_LOSSES as err:
        out = type(err).__name__
    except RuntimeError:
        out = "other"
    host = cs.host_names(events)
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    return {"out": out,
            "kernels": sum(cs.is_kernel(e, host)
                           and any(k in e.name for k in names) for e in gpu),
            "host_end_us": max((e.time_range.end for e in cpu), default=-1),
            "device_end_us": max((e.time_range.end for e in gpu),
                                 default=-1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=60)
    ap.add_argument("--after_phases", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profiler_losses: this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if args.after_phases:
        from snag_tpu_torch.data.dataset import load_data
        cs.phase_device()
        cs.phase_build()
        data = load_data(cs.cfg_from(cs.BENCH_ARGS + ["--device", "cpu"]))
        cs.phase_gat(data.graph)
        cs.phase_gat_bwd(data.graph)
        cs.phase_rank()
        cs.phase_rank(d=300)
        cs.phase_ntxent()
        cs.phase_mixture()
        cs.phase_segment(data.graph)
        cs.phase_gat(data.graph, bf16=True)
        cs.phase_gat_bwd(data.graph, bf16=True)
        del data
    before = time.perf_counter() - t0
    from snag_tpu_torch.ops.cuda import ntxent as nx
    _, m, b, d, n_valid = next(s for s in cs.NTXENT_SHAPES
                               if s[0] == "MEAformer joint")
    z, v, coef = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED + 4)
    z = z.to(torch.bfloat16)
    lse = nx.streaming_lse_cuda(z, v, 0.1)
    timed = {nx.STATS_GRAD_BF16.name:
             lambda: nx.ntxent_grad_cuda(z, lse, coef, v, 0.1),
             nx.STATS_LSE_BF16.name: lambda: nx.streaming_lse_cuda(z, v, 0.1)}
    counts = {name: {} for name in timed}
    lost = []
    for i in range(args.sessions):
        for name, fn in timed.items():
            rec = classify(cs.traced_calls(fn, cs.REPS),
                           cs.DEVICE_KERNELS[name])
            counts[name][rec["out"]] = counts[name].get(rec["out"], 0) + 1
            if rec["out"] != "ok":
                lost.append({"kernel": name, "session": i, **rec})
    result = {"card": smi, "sessions": args.sessions,
              "after_phases": args.after_phases,
              "seconds_before": round(before, 1), "counts": counts,
              "not_ok": lost}
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
