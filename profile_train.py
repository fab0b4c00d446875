#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its device time.

    python3 profile_train.py

Builds the ``chip_smoke.py`` training configuration (the bench geometry:
30,000 entities, batch 3500, GAT 300 x 2 x 2, the default fused loss,
noise 0.2 / 0.7) through ``Runner``, runs three epochs untraced, then
traces two more with ``torch.profiler`` and prints:

* the traced wall time per step, the kernels' device time, and the device's
  busy and idle shares of the wall time;
* device ms per step by kind: the mixture gradient and lse kernels, the
  NT-Xent gradient and lse kernels, the GAT backward and forward kernels,
  cuBLAS GEMMs and everything else (elementwise, index, reduce,
  optimizer);
* the 15 kernels with the most device time;
* the median step of the untraced epochs after the first (CUDA events,
  ``step_ms``).

Needs one NVIDIA GPU; exits non-zero without it.  Scratch data goes to the
git-ignored ``build/profile_train``.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WARM_EPOCHS = 3
TRACED_EPOCHS = 2
# (label, substring of the kernel name), first match wins; the two
# instantiations of csrc/gram_grad.cuh are named apart
# (mixture_grad_kernel, ntxent_grad_mma_kernel and ntxent_grad_sum_kernel)
KINDS = (("mixture_grad", "mixture_grad"), ("mixture_lse", "mixture_lse"),
         ("mixture_grad", "mixture_dbeta"), ("mixture_grad", "mixture_sum"),
         ("ntxent_grad", "ntxent_grad"), ("ntxent_lse", "ntxent_lse"),
         ("gat_bwd", "gat_bwd"), ("gat_attention_fwd", "gat_attention_fwd"),
         ("cuBLAS GEMM", "gemm"), ("cuBLAS GEMM", "xmma"))


def kind_of(name: str) -> str:
    return next((label for label, key in KINDS if key in name), "other")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BENCH_ARGS, TRAIN_ARGS, cfg_from
    from snag_tpu_torch.train.runner import Runner
    from snag_tpu_torch.utils.logging import create_logger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_from(BENCH_ARGS + TRAIN_ARGS + [
        "--device", "cuda", "--data_path", str(ROOT / "build" / "profile_train"),
        "--exp_name", "profile_train", "--no_tensorboard"])
    runner = Runner(cfg, create_logger(name="profile_train"))
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

    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.device_time / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    by_kind = {}
    for name, (ms, _) in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms

    print(f"traced {steps} steps: wall {wall_ms:.3f} ms "
          f"({wall_ms / steps:.3f} ms/step), kernel time {busy_ms:.3f} ms, "
          f"busy share {busy_ms / wall_ms:.4f}, "
          f"idle share {1.0 - busy_ms / wall_ms:.4f}")
    print(f"median warm step, untraced (CUDA events): "
          f"{statistics.median(warm):.3f} ms over {len(warm)} steps")
    for label, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {label:18s} {ms / steps:9.3f} ms/step  "
              f"{ms / busy_ms:.4f} of kernel time")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:15]:
        print(f"{ms / steps:10.3f} ms/step {count / steps:6.1f}/step "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
