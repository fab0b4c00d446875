#!/usr/bin/env python3
"""Where the bf16 lse kernel's warps spend their cycles, on one NVIDIA GPU.

    python3 scripts/torch_lse_bf16_phases.py [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/lse_phases/`` and adds ``clock64`` counters to that copy of the
bf16 lse kernel (``csrc/gram_lse_bf16.cuh``, or, in a checkout from before
it, the bf16 path of ``csrc/gram_lse.cuh``; DIR's own sources are not
touched), then runs ``mixture_lse_bf16`` at M = 4 and ``ntxent_lse_bf16``
at NT-Xent IIR (4, 3500, 300) and MEAformer's joint shape (1, 3500, 1,200)
on ``chip_smoke.py``'s inputs rounded to bf16, and prints, per shape, each
phase's share of the warps' summed cycles:

* ``wait``: waiting for a ring slot (its copies' completion and the
  block's barrier); ``issue``: issuing the next slot's copies (every
  thread's ``cp.async`` in the parent's kernel, thread 0's two tensor
  copies a slot in this checkout's);
* ``mma``: the K products (fragment loads, ``mma.sync``, the fp32 adds);
* ``exp``: the exps and the row and column sums in registers and across
  lanes (and, for the mixture, the running sums of mix_a and mix_f);
* ``write``: the barriers around the sums across warps and the partial
  writes;
* ``prologue``: from the kernel's start (or a new tile pair's, where the
  block walks pairs) to its first product: pair decoding, the first
  copies and their wait;

and the cycles per warp.  The counters cost registers and issue slots, so
the shares, not the times, are the result.  An anchor that does not match
the kernel exits naming it.  It prints one JSON line per shape with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "lse_phases"
PHASES = ("wait", "issue", "mma", "exp", "write", "prologue")
COUNTERS = """
__device__ unsigned long long g_phase[8];
"""
REPORT = """
  if (threadIdx.x % 32 == 0) {
    for (int i = 0; i < 6; ++i) atomicAdd(&g_phase[i], c[i]);
    atomicAdd(&g_phase[7], 1ull);
  }"""

# The parent's kernel: gram_lse.cuh, one template for f32 and bf16 (both
# instantiations carry the counters; the bf16 entries are measured).
# (anchor, replacement); c[0..5] the phases above, g_phase[7] the warps
PATCHES_SHARED = ("snag_tpu_torch/csrc/gram_lse.cuh", [
    ("namespace {\nnamespace lse {", COUNTERS + "namespace {\nnamespace lse {"),
    ("""    float* red_r, float* red_c, float* __restrict__ part_row,
    float* __restrict__ part_col) {""",
     """    float* red_r, float* red_c, float* __restrict__ part_row,
    float* __restrict__ part_col, unsigned long long (&cc)[6]) {
  const long long e0 = clock64();"""),
    ("""  __syncthreads();
  for (int k = threadIdx.x; k < 2 * T; k += THREADS) {""",
     """  const long long e1 = clock64();
  cc[3] += e1 - e0;
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * T; k += THREADS) {"""),
    ("""      part_col[k - T] = s;
    }
  }
  __syncthreads();
}""",
     """      part_col[k - T] = s;
    }
  }
  __syncthreads();
  cc[4] += clock64() - e1;
}"""),
    ("""  extern __shared__ __align__(16) float smem[];
  Op* ring = reinterpret_cast<Op*>(smem);""",
     """  const long long t_entry = clock64();
  unsigned long long c[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) float smem[];
  Op* ring = reinterpret_cast<Op*>(smem);"""),
    ("""  auto next = [&](int q) -> const Op* {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    issue(q + DEPTH - 1);""",
     """  auto next = [&](int q) -> const Op* {
    const long long q0 = clock64();
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    const long long q1 = clock64();
    issue(q + DEPTH - 1);
    c[q == 0 ? 5 : 0] += q1 - q0;
    c[1] += clock64() - q1;"""),
    ("""  for (int q = 0; q < DEPTH - 1; ++q) issue(q);""",
     """  for (int q = 0; q < DEPTH - 1; ++q) issue(q);
  c[5] += clock64() - t_entry;"""),
    ("""                    p + (size_t)ti * n2 + col0);""",
     """                    p + (size_t)ti * n2 + col0, c);"""),
    ("""    for (int s = 0; s < ks; ++s) k_step<T>(next(m * ks + s), acc);""",
     """    for (int s = 0; s < ks; ++s) {
      const Op* buf = next(m * ks + s);
      const long long qk = clock64();
      k_step<T>(buf, acc);
      asm volatile("" ::: "memory");
      c[2] += clock64() - qk;
    }"""),
    ("""    write(acc, MIX ? m : batch);
    if (MIX) {""",
     """    write(acc, MIX ? m : batch);
    const long long qm = clock64();
    if (MIX) {"""),
    ("""            mix_f[i][j][e] = fmaf(bm, k, mix_f[i][j][e]);
          }
    }""",
     """            mix_f[i][j][e] = fmaf(bm, k, mix_f[i][j][e]);
          }
    }
    c[3] += clock64() - qm;"""),
    ("""  cp_async_wait<0>();
}""", """  cp_async_wait<0>();""" + REPORT + "\n}"),
])

# This checkout's kernel: gram_lse_bf16.cuh, persistent blocks that walk
# tile pairs
PATCHES_BF16 = ("snag_tpu_torch/csrc/gram_lse_bf16.cuh", [
    ("namespace {\nnamespace lse16 {",
     COUNTERS + "namespace {\nnamespace lse16 {"),
    ("""    int nc, bool diag, float l2_tau, float* red) {""",
     """    int nc, bool diag, float l2_tau, float* red,
    unsigned long long (&cc)[6]) {
  const long long e0 = clock64();"""),
    ("""      if (g == 0) red[(WC + warp % WR) * T + frag_col<WR, WC>(j, c)] = s;
    }
}""",
     """      if (g == 0) red[(WC + warp % WR) * T + frag_col<WR, WC>(j, c)] = s;
    }
  cc[3] += clock64() - e0;
}"""),
    ("""    int tiles, int n2, int ti, int tj, int nr, int nc, bool diag) {""",
     """    int tiles, int n2, int ti, int tj, int nr, int nc, bool diag,
    unsigned long long (&cc)[6]) {
  const long long e1 = clock64();"""),
    ("""  __syncthreads();            // red is free again
}""",
     """  __syncthreads();            // red is free again
  cc[4] += clock64() - e1;
}"""),
    ("""  extern __shared__ __align__(16) unsigned char smem16[];""",
     """  long long t_mark = clock64();
  bool first = true;
  unsigned long long c[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) unsigned char smem16[];"""),
    ("""  auto next = [&]() -> const unsigned char* {
    mbar_wait(bars + cslot, cphase);
    __syncthreads();
    issue();""",
     """  auto next = [&]() -> const unsigned char* {
    const long long q0 = clock64();
    mbar_wait(bars + cslot, cphase);
    __syncthreads();
    const long long q1 = clock64();
    issue();
    if (first) c[5] += q1 - t_mark;
    else c[0] += q1 - q0;
    first = false;
    c[1] += clock64() - q1;"""),
    # a pair's start and its first wait count as its prologue
    ("""  for (long long w = w0; w < w1; ++w) {
    int batch, ti, tj;""",
     """  for (long long w = w0; w < w1; ++w) {
    if (w > w0) {
      t_mark = clock64();
      first = true;
    }
    int batch, ti, tj;"""),
    ("""        k_slab<WR, WC>(buf, min(KS16, d16 - KS16 * s), acc);""",
     """        const long long qk = clock64();
        k_slab<WR, WC>(buf, min(KS16, d16 - KS16 * s), acc);
        asm volatile("" ::: "memory");
        c[2] += clock64() - qk;"""),
    ("""                        red + k * (WR + WC) * T);""",
     """                        red + k * (WR + WC) * T, c);"""),
    ("""                       n2, ti, tj, nr, nc, diag);""",
     """                       n2, ti, tj, nr, nc, diag, c);"""),
    ("""      sums(acc, MIX ? m : 0);
""",
     """      sums(acc, MIX ? m : 0);
      const long long qm = clock64();
"""),
    ("""              mix_f[i][j][e] = fmaf(bm, k, f0);
            }
      }""",
     """              mix_f[i][j][e] = fmaf(bm, k, f0);
            }
      }
      c[3] += clock64() - qm;"""),
    ("""}  // gram_lse_bf16""", REPORT + "\n}  // gram_lse_bf16"),
])

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


def make_copy(root: Path) -> str:
    """The patched copy of root's package under COPY; returns the header
    that carries the counters."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(root / "snag_tpu_torch", COPY / "snag_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name, patches = PATCHES_BF16
    if not (COPY / name).exists():
        name, patches = PATCHES_SHARED
    header = COPY / name
    text = header.read_text()
    for anchor, new in patches:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {name}:\n{anchor}")
        text = text.replace(anchor, new)
    header.write_text(text)
    for src in ("ntxent.cu", "snag_loss.cu"):
        path = COPY / "snag_tpu_torch" / "csrc" / src
        path.write_text(path.read_text() + READ)
    return name


def measure(header: str) -> int:
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(COPY))
    import torch
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    if not torch.cuda.is_available():
        print("torch_lse_bf16_phases: needs an NVIDIA GPU", file=sys.stderr)
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
        total = sum(out[:6])
        return {n: round(out[i] / total, 4) for i, n in enumerate(PHASES)} | {
            "cycles_per_warp": round(total / max(out[7], 1))}

    def say(kernel, label, rec):
        print(json.dumps({"kernel": kernel, "shape": label, "header": header,
                          "card": card, **rec}), flush=True)

    z, alpha, beta, v, _ = cs._mixture_inputs(4, 3500, 300, 3500, cs.SEED)
    z = z.to(bf)
    say("mixture_lse_bf16", "M4", shares(sl._library().lib, lambda: (
        sl.mixture_lse_cuda(z, alpha, beta, v, 0.1))))
    for label, m, b, d, n_valid in (("IIR", 4, 3500, 300, 3500),
                                    ("MEAformer joint", 1, 3500, 1200, 3500)):
        z, v, _ = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED)
        z = z.to(bf)
        say("ntxent_lse_bf16", label, shares(nx._library().lib, lambda: (
            nx.streaming_lse_cuda(z, v, 0.1))))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        sys.exit(measure(sys.argv[2]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    header = make_copy(Path(ap.parse_args().root).resolve())
    sys.exit(subprocess.run([sys.executable, __file__, "--measure",
                             header]).returncode)
