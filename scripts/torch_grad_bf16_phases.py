#!/usr/bin/env python3
"""Where the bf16 gradient kernel's warps spend their cycles, on one NVIDIA
GPU.

    python3 scripts/torch_grad_bf16_phases.py

Copies ``snag_tpu_torch`` to ``build/grad_phases/`` and adds ``clock64``
counters to that copy of ``csrc/gram_grad_bf16.cuh`` (the checkout's own
kernel is not touched), then runs ``ntxent_grad_bf16`` at NT-Xent IIR (4,
3500, 300) and MEAformer's joint shape (1, 3500, 1,200) and
``mixture_grad_bf16`` at M = 4 on ``chip_smoke.py``'s inputs, and prints,
per shape, each phase's share of the warps' summed cycles:

* ``wait``: waiting for a ring slot (``cp.async`` wait and the block's
  barrier); ``issue``: issuing the next slot's 16-byte copies;
* ``K``: the K products; ``cluster``: publishing K (the mixture) or W
  (NT-Xent in chunks) to the cluster, its barrier, and the reads of the
  other blocks' shared memory;
* ``W``: the weights, their exps and the bf16 fragments; ``pair``: the
  barrier of a strip's two warps; ``Wz``: the W z products;

and the cycles per warp.  The counters cost registers and issue slots, so
the shares, not the times, are the result.  It prints one JSON line per
shape with the card's name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "grad_phases"
PHASES = ("wait", "issue", "K", "cluster", "W", "pair", "Wz")
HEADER = "snag_tpu_torch/csrc/gram_grad_bf16.cuh"

# (anchor in the kernel, its replacement): c[0..6] the phases above, c[7]
# the warps that reported
PATCHES = [
    ("namespace {\nnamespace grad16 {",
     "__device__ unsigned long long g_phase[8];\nnamespace {\nnamespace grad16 {"),
    ("""  auto next = [&]() -> const __nv_bfloat16* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();
    issue();""",
     """  unsigned long long c[7] = {0, 0, 0, 0, 0, 0, 0};
  auto next = [&]() -> const __nv_bfloat16* {
    const long long q0 = clock64();
    cp_async_wait_dyn(depth - 2);
    __syncthreads();
    const long long q1 = clock64();
    issue();
    c[0] += q1 - q0;
    c[1] += clock64() - q1;"""),
    ("""  for (int ct = ct0; rc > 1 && ct < ct1; ++ct) {
    float k[2][4];""",
     """  for (int ct = ct0; rc > 1 && ct < ct1; ++ct) {
    const long long p0 = clock64();
    const unsigned long long pw = c[0] + c[1];
    float k[2][4];"""),
    ("""    const __nv_bfloat16* zt = next();
    uint32_t* wxc""",
     """    const __nv_bfloat16* zt = next();
    const long long p1 = clock64();
    c[2] += (p1 - p0) - (c[0] + c[1] - pw);
    uint32_t* wxc"""),
    ("""    cluster_sync();
    const uint32_t wr =""",
     """    const long long p2 = clock64();
    c[4] += p2 - p1;
    cluster_sync();
    const uint32_t wr ="""),
    ("""    wz_tile(zt + 8 * fa, w, ntw, acc);
  }
  // no block leaves""",
     """    const long long p3 = clock64();
    c[3] += p3 - p2;
    wz_tile(zt + 8 * fa, w, ntw, acc);
    c[6] += clock64() - p3;
  }
  // no block leaves"""),
    ("""      zt = next();
      k_tile(rows_res + a_off * Z_STRIDE, Z_STRIDE,
             zt + 8 * CN8 * wp * Z_STRIDE, Z_STRIDE, d16, k);""",
     """      zt = next();
      const long long qk = clock64();
      k_tile(rows_res + a_off * Z_STRIDE, Z_STRIDE,
             zt + 8 * CN8 * wp * Z_STRIDE, Z_STRIDE, d16, k);
      asm volatile("" ::: "memory");
      c[2] += clock64() - qk;"""),
    ("""    uint32_t* w_xt = MIX ?""",
     """    const long long qx = clock64();
    uint32_t* w_xt = MIX ?"""),
    ("""    uint32_t* wx = w_xt + strip * 4 * 4 * 32 + lane;""",
     """    const long long q3 = clock64();
    c[3] += q3 - qx;
    uint32_t* wx = w_xt + strip * 4 * 4 * 32 + lane;"""),
    ("""    asm volatile("bar.sync %0, %1;" :: "r"(1 + strip), "r"(32 * PARTS)
                 : "memory");""",
     """    const long long q4 = clock64();
    asm volatile("bar.sync %0, %1;" :: "r"(1 + strip), "r"(32 * PARTS)
                 : "memory");
    const long long q5 = clock64();
    c[4] += q4 - q3;
    c[5] += q5 - q4;"""),
    ("""    wz_tile(zt + 8 * fa, w, ntw, acc);
  }
  // MIX: no block leaves""",
     """    wz_tile(zt + 8 * fa, w, ntw, acc);
    c[6] += clock64() - q5;
  }
  // MIX: no block leaves"""),
    ("""  if (MIX) cluster_sync();
  cp_async_wait<0>();""",
     """  if (MIX) cluster_sync();
  cp_async_wait<0>();
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) atomicAdd(&g_phase[i], c[i]);
    atomicAdd(&g_phase[7], 1ull);
  }"""),
]
READ = """

extern "C" int phase_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "snag_tpu_torch", COPY / "snag_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = COPY / HEADER
    text = header.read_text()
    for anchor, new in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {HEADER}:\n{anchor}")
        text = text.replace(anchor, new)
    header.write_text(text)
    for name in ("ntxent.cu", "snag_loss.cu"):
        src = COPY / "snag_tpu_torch" / "csrc" / name
        src.write_text(src.read_text() + READ)


def measure() -> int:
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(COPY))
    import torch
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    if not torch.cuda.is_available():
        print("torch_grad_bf16_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    bf = torch.bfloat16

    def shares(lib, fn):
        out = (ctypes.c_ulonglong * 8)()
        fn()
        lib.phase_read(out)                 # drop the first call's counts
        fn()
        if lib.phase_read(out):
            raise RuntimeError("phase_read failed")
        total = sum(out[:7])
        return {n: round(out[i] / total, 4) for i, n in enumerate(PHASES)} | {
            "cycles_per_warp": round(total / max(out[7], 1))}

    for label, m, b, d, n_valid in (("IIR", 4, 3500, 300, 3500),
                                    ("MEAformer joint", 1, 3500, 1200, 3500)):
        z, v, coef = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED)
        z = z.to(bf)
        lse = nx.streaming_lse_cuda(z, v, 0.1)
        rec = shares(nx._library().lib,
                     lambda: nx.ntxent_grad_cuda(z, lse, coef, v, 0.1))
        print(json.dumps({"kernel": "ntxent_grad_bf16", "shape": label,
                          "card": card, **rec}), flush=True)
    z, alpha, beta, v, coef = cs._mixture_inputs(4, 3500, 300, 3500, cs.SEED)
    z = z.to(bf)
    lse = sl.mixture_lse_cuda(z, alpha, beta, v, 0.1)
    rec = shares(sl._library().lib, lambda: sl.mixture_grad_cuda(
        z, alpha, beta, lse, coef, v, 0.1))
    print(json.dumps({"kernel": "mixture_grad_bf16", "shape": "M4",
                      "card": card, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        sys.exit(measure())
    make_copy()
    sys.exit(subprocess.run([sys.executable, __file__, "--measure"]).returncode)
