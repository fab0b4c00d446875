#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its device time.

    python3 profile_train.py [--dtype bfloat16] [--model_name NAME]
                             [--replay 1] [--accum_dropout 1]

Builds the ``chip_smoke.py`` training configuration (the bench geometry:
30,000 entities, batch 3500, GAT 300 x 2 x 2, the default fused loss,
noise 0.2 / 0.7) through ``Runner``, runs three epochs untraced, then
traces two more with ``torch.profiler``; then the same with the GCN
structure encoder (``chip_smoke.gcn_args``).  For each it prints:

* the traced wall time per step, the kernels' device time, and the device's
  busy and idle shares of the wall time.  Kernel time counts kernels only
  (``chip_smoke.is_kernel``): GPU user annotations such as
  ``Optimizer.step#AdamW.step``, spans laid over kernels counted on their
  own, are left out and printed apart, as are copies and memsets;
* device ms per step by kind: each hand-written kernel of the port
  (``chip_smoke.DEVICE_KERNELS``: the mixture and NT-Xent gradient and
  lse, the GAT backward and forward, the weighted segment sum; each bf16
  entry, ``weighted_segment_sum_bf16`` among them, a kind apart), cuBLAS
  GEMMs and everything else (elementwise, index, reduce, optimizer);
* the 15 kernels with the most device time;
* the median step of the untraced epochs after the first (CUDA events,
  ``step_ms``).

With ``--dtype bfloat16`` it profiles both configurations, the GAT and
then the GCN, in bf16; the bf16 entries are kinds of their own.
With ``--model_name EVA``, ``MCLEA``, ``MEAformer`` or ``MSNEA`` it
profiles that family alone at the same geometry
(``chip_smoke.family_args``: EVA on its GCN, MCLEA and MEAformer on the
GAT with their presets' temperatures, MSNEA with no graph encoder), in
bf16 too with ``--dtype bfloat16`` and with MEAformer's replay under
``--replay 1``.  ``--accum_dropout 1`` adds ``chip_smoke``'s
``--accumulation_steps 2 --attn_dropout 0.1`` (a step is then a
micro-step) and profiles the GAT configuration alone, whose training
sums the dropped attention on the weighted segment sum.

Needs one NVIDIA GPU; exits non-zero without it.  Scratch data goes to the
git-ignored ``build/profile_train``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import (ACCUM_DROPOUT_ARGS, BENCH_ARGS, DEVICE_KERNELS,
                        TRAIN_ARGS, cfg_from, family_args, gcn_args,
                        host_names, is_kernel)

ROOT = Path(__file__).resolve().parent
WARM_EPOCHS = 3
TRACED_EPOCHS = 2
# (label, substring of the kernel name), first match wins: the longest
# substrings first, so that a bf16 entry ("mixture_grad_bf16") is not
# taken for its f32 one ("mixture_grad")
KINDS = tuple(sorted(((label, key) for label, keys in DEVICE_KERNELS.items()
                      for key in keys), key=lambda lk: -len(lk[1]))) + (
    ("cuBLAS GEMM", "gemm"), ("cuBLAS GEMM", "xmma"))


def kind_of(name: str) -> str:
    return next((label for label, key in KINDS if key in name), "other")


def profile_config(label: str, args) -> None:
    """Train ``args`` untraced, then traced, and print the block."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from snag_tpu_torch.train.runner import Runner
    from snag_tpu_torch.utils.logging import create_logger

    cfg = cfg_from(args + TRAIN_ARGS + [
        "--device", "cuda", "--data_path", str(ROOT / "build" / "profile_train"),
        "--exp_name", f"profile_train_{label}", "--no_tensorboard"])
    runner = Runner(cfg, create_logger(name=f"profile_train_{label}"))
    for epoch in range(WARM_EPOCHS):
        runner.epoch = epoch
        runner.train_epoch()
    torch.cuda.synchronize()
    # the first epoch's steps pay one-off start-up
    per_epoch = -(-len(runner.train_ill) // cfg.batch_size)
    warm = runner.step_ms[per_epoch:]
    n_untraced = len(runner.step_ms)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for epoch in range(TRACED_EPOCHS):
            runner.epoch = epoch
            runner.train_epoch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = len(runner.step_ms) - n_untraced

    events = prof.events()
    host = host_names(events)
    by_name, apart = {}, {}
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        table = by_name if is_kernel(ev, host) else apart
        ms, count = table.get(ev.name, (0.0, 0))
        table[ev.name] = (ms + ev.device_time / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0.0:
        raise RuntimeError("the profiler recorded no kernel time")
    by_kind = {}
    for name, (ms, _) in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms

    print(f"[{label}] traced {steps} steps: wall {wall_ms:.3f} ms "
          f"({wall_ms / steps:.3f} ms/step), kernel time {busy_ms:.3f} ms "
          f"({busy_ms / steps:.3f} ms/step), busy share "
          f"{busy_ms / wall_ms:.4f}, idle share {1.0 - busy_ms / wall_ms:.4f}")
    print(f"[{label}] median warm step, untraced (CUDA events): "
          f"{statistics.median(warm):.3f} ms over {len(warm)} steps")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:20s} {ms / steps:9.3f} ms/step  "
              f"{ms / busy_ms:.4f} of kernel time")
    for name, (ms, count) in sorted(apart.items(), key=lambda kv: -kv[1][0]):
        print(f"  not counted: {ms / steps:9.3f} ms/step {count / steps:6.1f}"
              f"/step {name[:80]}")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms / steps:10.3f} ms/step {count / steps:6.1f}/step "
              f"{name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--model_name", default="SNAG",
                        choices=("SNAG", "EVA", "MCLEA", "MEAformer",
                                 "MSNEA"))
    parser.add_argument("--replay", default="0", choices=("0", "1"))
    parser.add_argument("--accum_dropout", default="0", choices=("0", "1"))
    args = parser.parse_args()
    bf16 = ["--dtype", "bfloat16"] if args.dtype == "bfloat16" else []
    suffix = "_bf16" if bf16 else ""
    extra = ACCUM_DROPOUT_ARGS if args.accum_dropout == "1" else []
    if extra:
        suffix += "_accum_dropout"
    if args.model_name != "SNAG":
        replay = ["--replay", "1"] if args.replay == "1" else []
        label = args.model_name.lower() + ("_replay" if replay else "")
        profile_config(label + suffix,
                       family_args(args.model_name, *replay, *bf16, *extra))
        return 0
    profile_config("gat" + suffix, BENCH_ARGS + bf16 + extra)
    if extra:
        return 0
    torch.cuda.empty_cache()
    profile_config("gcn" + suffix, gcn_args(BENCH_ARGS) + bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
