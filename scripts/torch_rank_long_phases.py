#!/usr/bin/env python3
"""Where sweep A's warps spend their cycles at CSLS k > 10, on one NVIDIA GPU.

    python3 scripts/torch_rank_long_phases.py [--root DIR]

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/rank_long_phases/`` and adds ``clock64`` counters to that copy of
``csrc/rank_tile.cuh`` (the tile product's loop) and ``csrc/rank_eval.cu``
(the sweep's epilogues; DIR's own sources are not touched), then runs
``topk_mean_both_cuda`` on ``chip_smoke._eval_inputs(10500, 1200)`` at k in
``KS``: k = 10 (``topk_mean_kernel``, lists in registers, the column pass
over a tile of similarities in shared memory: the yardstick of the product
with a light epilogue) and k = 20, 64 and 128 (``long_topk_mean_kernel``,
lists of 32 and 128 in shared memory).  It prints each phase's share of the
sweep's warps' summed cycles (lane 0 of every warp, every launch of the
call):

* ``wait``: the ring's wait for the thread's own copies of a slice;
* ``barrier``: the block's barriers, a slice's and a tile's (the wait for
  the slowest warp, whose epilogue or copies hold the others);
* ``fma``: a slice's next copies issued and its multiply-adds;
* ``epilogue``: the tile's epilogue, of which
  * ``dist``: the distances and similarities (k = 10: also the register
    lists' inserts and the similarity tile's writes);
  * ``col``: the column direction (k = 10: the pass over the similarity
    tile, its barrier included; the new long kernel: each column's 96
    similarities written to the scratch; the parent's long kernel: none,
    it runs the sweep again on (y, x));
  * ``check``: a row's compares against its list's last entry and the
    vote that follows;
  * ``insert``: the list upkeep after that vote (the parent's one value at
    a time; the new kernel's appends), merges apart;
  * ``merge``: the new kernel's network merges of a full buffer;
* ``other``: the rest (the ring's prologue, the end's merges and writes),

and the cycles a warp.  The counters cost registers and issue slots, and
the marks pin values that the compiler would otherwise schedule across
them, so the shares, not the times, are the result.  From DIR's unpatched
build it also prints, per k, the device ms of the sweep's launches, of its
merge kernels (the parent's long lists: both directions'; the new: the
rows' and the columns', and the columns' alone), of the whole call, and
the sweep's registers and spills.  An anchor that does not match the
source exits naming it.  One JSON line per k, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "rank_long_phases"
TILE = "snag_tpu_torch/csrc/rank_tile.cuh"
SOURCE = "snag_tpu_torch/csrc/rank_eval.cu"
KS = (10, 20, 64, 128)
N, D = 10500, 1200
# g_phase slots: the loop's 0-3, the epilogue's 4-8, 14 total, 15 warps
LOOP = ("wait", "barrier", "fma", "epilogue")
EPI = ("dist", "col", "check", "insert", "merge")

COUNTERS = """
__device__ unsigned long long g_phase[16];
__device__ __forceinline__ long long phase_mark() {
  asm volatile("" ::: "memory");
  return clock64();
}
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
"""
PIN_ACC = """#pragma unroll
    for (int r_ = 0; r_ < TM; ++r_)
#pragma unroll
      for (int c_ = 0; c_ < TN; ++c_) pin(acc[r_][c_]);
"""
# (anchor, replacement) in rank_tile.cuh: the loop of sweep_tiles
PATCHES_TILE = [
    ('#include "tile_mma.cuh"\n', '#include "tile_mma.cuh"\n' + COUNTERS),
    ("""  int tile = t0, k = 0;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    // slice it has landed for every thread, and every thread is done with
    // the slot that the next copy overwrites (it - 1's)
    __syncthreads();
""", """  int tile = t0, k = 0;
  unsigned long long pc[4] = {0, 0, 0, 0};
  for (int it = 0; it < steps; ++it) {
    const long long tw0 = phase_mark();
    cp_async_wait<STAGES - 2>();
    const long long tw1 = phase_mark();
    pc[0] += tw1 - tw0;
    __syncthreads();
    long long tw2 = phase_mark();
    pc[1] += tw2 - tw1;
"""),
    ("""    mul_slice(smem + (it % STAGES) * SLICE, tx, ty, acc);
    if (last) {
""", """    mul_slice(smem + (it % STAGES) * SLICE, tx, ty, acc);
""" + PIN_ACC + """    {
      const long long tw3 = phase_mark();
      pc[2] += tw3 - tw2;
      tw2 = tw3;
    }
    if (last) {
"""),
    ("""      __syncthreads();
      epi(acc, col0, static_cast<const float*>(cv));
""", """      __syncthreads();
      const long long tw4 = phase_mark();
      pc[1] += tw4 - tw2;
      epi(acc, col0, static_cast<const float*>(cv));
      pc[3] += phase_mark() - tw4;
"""),
    ("""  cp_async_wait<0>();
}
""", """  cp_async_wait<0>();
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < 4; ++i) atomicAdd(&g_phase[i], pc[i]);
}
"""),
]

ENTRY = """  const long long t_entry = clock64();
  unsigned long long cyc[5] = {0, 0, 0, 0, 0};
"""
REPORT = """  {
    const unsigned long long total = clock64() - t_entry;
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < 5; ++i) atomicAdd(&g_phase[4 + i], cyc[i]);
      atomicAdd(&g_phase[14], total);
      atomicAdd(&g_phase[15], 1ull);
    }
  }
"""
PLACE = """  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const Place p = place(n, splits);
"""

# topk_mean_kernel (k <= 10), the same in the parent and in this checkout
PATCHES_SHORT = [
    ("  float* sims = smem + SMEM_BYTES / 4;  // BM x BN similarities\n"
     + PLACE,
     "  float* sims = smem + SMEM_BYTES / 4;  // BM x BN similarities\n"
     + PLACE + ENTRY),
    ("""      [&](const float (&acc)[TM][TN], int col0, const float* cv) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int tc = tile_col(tx, c);
      const int gc = col0 + tc;
      if (gc >= n) continue;
""", """      [&](const float (&acc)[TM][TN], int col0, const float* cv) {
    const long long te0 = phase_mark();
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int tc = tile_col(tx, c);
      const int gc = col0 + tc;
      if (gc >= n) continue;
"""),
    ("""    __syncthreads();
    const int gc = col0 + threadIdx.x;
    if (threadIdx.x < BN && gc < n) {
      float ctop[K];
""", """#pragma unroll
    for (int r_ = 0; r_ < TM; ++r_)
#pragma unroll
      for (int q_ = 0; q_ < K; ++q_) pin(top[r_][q_]);
    const long long te1 = phase_mark();
    cyc[0] += te1 - te0;
    __syncthreads();
    const int gc = col0 + threadIdx.x;
    if (threadIdx.x < BN && gc < n) {
      float ctop[K];
"""),
    ("""      for (int q = 0; q < K; ++q) out[q] = ctop[q];
    }
  });
""", """      for (int q = 0; q < K; ++q) out[q] = ctop[q];
    }
    cyc[1] += phase_mark() - te1;
  });
"""),
    ("""      for (int q = 0; q < K; ++q) out[q] = top[r][q];
    }
  }
}
""", """      for (int q = 0; q < K; ++q) out[q] = top[r][q];
    }
  }
""" + REPORT + "}\n"),
]

# The parent's long lists: half_topk (a value at a time), one direction a
# launch
PATCHES_PARENT = [
    ("""__device__ __forceinline__ void half_topk(float* list, const float (&v)[N],
                                          int h) {
""", """__device__ __forceinline__ void half_topk(float* list, const float (&v)[N],
                                          int h,
                                          unsigned long long* cyc = nullptr) {
"""),
    ("""  float last = list[K - 1];
  unsigned pend = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v[c] > last) pend |= 1u << c;
  while (__any_sync(0xffffffffu, pend != 0)) {
""", """  const long long tq = phase_mark();
  float last = list[K - 1];
  unsigned pend = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v[c] > last) pend |= 1u << c;
  bool any_ = __any_sync(0xffffffffu, pend != 0);
  const long long tw = phase_mark();
  if (cyc) cyc[2] += tw - tq;
  while (any_) {
"""),
    ("""    last = list[K - 1];
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (!(v[c] > last)) pend &= ~(1u << c);
  }
}
""", """    last = list[K - 1];
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (!(v[c] > last)) pend &= ~(1u << c);
    any_ = __any_sync(0xffffffffu, pend != 0);
  }
  if (cyc) cyc[3] += phase_mark() - tw;
}
"""),
    ("  float* lists = smem + SMEM_BYTES / 4;  // BM x K\n" + PLACE,
     "  float* lists = smem + SMEM_BYTES / 4;  // BM x K\n" + PLACE + ENTRY),
    ("""      float sim[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int tc = tile_col(tx, c);
""", """      const long long te0 = phase_mark();
      float sim[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int tc = tile_col(tx, c);
"""),
    ("""      half_topk<K>(lists + (ty * TM + r) * K, sim, tx);
""", """#pragma unroll
      for (int c_ = 0; c_ < TN; ++c_) pin(sim[c_]);
      cyc[0] += phase_mark() - te0;
      half_topk<K>(lists + (ty * TM + r) * K, sim, tx, cyc);
"""),
    ("""      out[tx + 16 * j] = lists[(ty * TM + r) * K + tx + 16 * j];
  }
}
""", """      out[tx + 16 * j] = lists[(ty * TM + r) * K + tx + 16 * j];
  }
""" + REPORT + "}\n"),
]

# This checkout's long lists: a threshold, candidates and network merges
# (offer), both directions from one pass
PATCHES_NEW = [
    ("""                                      float& thr, const float (&v)[N],
                                      int lane) {
""", """                                      float& thr, const float (&v)[N],
                                      int lane,
                                      unsigned long long* cyc = nullptr) {
"""),
    ("""  unsigned pend = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v[c] > thr) pend |= 1u << c;
  while (__any_sync(0xffffffffu, pend != 0)) {
""", """  const long long tq = phase_mark();
  unsigned pend = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (v[c] > thr) pend |= 1u << c;
  bool any_ = __any_sync(0xffffffffu, pend != 0);
  const long long tw = phase_mark();
  if (cyc) cyc[2] += tw - tq;
  while (any_) {
"""),
    ("""    if (__any_sync(0xffffffffu, count == K)) {
      thr = merge_candidates<K, L>(list, buf, count, lane);
""", """    if (__any_sync(0xffffffffu, count == K)) {
      const long long tm = phase_mark();
      thr = merge_candidates<K, L>(list, buf, count, lane);
      if (cyc) cyc[4] += phase_mark() - tm;
"""),
    ("""        if (!(v[c] > thr)) pend &= ~(1u << c);
    }
  }
}
""", """        if (!(v[c] > thr)) pend &= ~(1u << c);
    }
    any_ = __any_sync(0xffffffffu, pend != 0);
  }
  if (cyc) cyc[3] += phase_mark() - tw;
}
"""),
    ("  float* lists = smem + SMEM_BYTES / 4;  // BM x 2K: a row's list, then buf\n"
     + PLACE,
     "  float* lists = smem + SMEM_BYTES / 4;  // BM x 2K: a row's list, then buf\n"
     + PLACE + ENTRY),
    ("    float sim[TM][TN];\n",
     "    const long long te0 = phase_mark();\n    float sim[TM][TN];\n"),
    ("""#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc < n)
""", """#pragma unroll
    for (int r_ = 0; r_ < TM; ++r_)
#pragma unroll
      for (int c_ = 0; c_ < TN; ++c_) pin(sim[r_][c_]);
    const long long te1 = phase_mark();
    cyc[0] += te1 - te0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tile_col(tx, c);
      if (gc < n)
"""),
    ("""#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float* list = lists + (ty * TM + r) * 2 * K;
      offer<K, 16>(list, list + K, count[r], thr[r], sim[r], tx);
    }
  });
""", """    cyc[1] += phase_mark() - te1;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float* list = lists + (ty * TM + r) * 2 * K;
      offer<K, 16>(list, list + K, count[r], thr[r], sim[r], tx, cyc);
    }
  });
"""),
    ("""    for (int j = 0; j < K / 16; ++j) out[tx + 16 * j] = list[tx + 16 * j];
  }
}
""", """    for (int j = 0; j < K / 16; ++j) out[tx + 16 * j] = list[tx + 16 * j];
  }
""" + REPORT + "}\n"),
]

READ = """

extern "C" int phase_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  unsigned long long zero[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def apply(path: Path, sets) -> None:
    text = path.read_text()
    for name, patches in sets:
        for anchor, new in patches:
            if text.count(anchor) != 1:
                raise SystemExit(f"anchor not found once in {path.name} "
                                 f"({name}):\n{anchor}")
            text = text.replace(anchor, new)
    path.write_text(text)


def make_copy(root: Path) -> str:
    """The patched copy of root's package under COPY; returns which long
    body it took (the parent's half_topk or this checkout's offer)."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(root / "snag_tpu_torch", COPY / "snag_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    apply(COPY / TILE, [("tile loop", PATCHES_TILE)])
    src = COPY / SOURCE
    body = ("half_topk" if "void half_topk(" in src.read_text()
            else "offer")
    apply(src, [("k <= 10", PATCHES_SHORT),
                (body, PATCHES_PARENT if body == "half_topk" else PATCHES_NEW)])
    src.write_text(src.read_text() + READ)
    return body


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def measure(package: Path, what: str) -> int:
    """In a process of its own: the phase shares (``what`` = the long
    body, package = the patched copy) or the device ms and registers
    (``what`` = "times", package = the checkout)."""
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(package))
    import torch
    from snag_tpu_torch.ops.cuda import rank_eval as rk
    if not torch.cuda.is_available():
        print("torch_rank_long_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_name()
    built = rk._library()
    x, y = cs._eval_inputs(N, D)
    xn, yn = torch.sum(x * x, dim=1), torch.sum(y * y, dim=1)
    for k in KS:
        size = rk.list_len(k)
        long = size > rk.MAX_K
        sweep = "long_topk_mean_kernel" if long else "topk_mean_kernel"
        merge = "long_topk_merge_kernel" if long else "topk_merge_kernel"

        def fn():
            return rk.topk_mean_both_cuda(x, y, xn, yn, k)
        rec = {"k": k, "list": size, "n": N, "d": D, "card": card,
               "package": str(package)}
        if what == "times":
            rec["device_ms"] = cs.device_ms(fn, (sweep, merge))
            rec["sweep_device_ms"] = cs.device_ms(fn, (sweep,))
            rec["merge_device_ms"] = cs.device_ms(fn, (merge,))
            if long and "void offer(" in (package / SOURCE).read_text():
                rec["col_merge_device_ms"] = cs.device_ms(
                    fn, (f"{merge}<{size}, 96>",))
            rec["ptxas"] = [
                {"entry": e, "registers": r, "spill_stores": s,
                 "spill_loads": ld}
                for e, r, s, ld in cs.kernel_ptxas(
                    built, (f"{sweep}ILi{size}E", f"{merge}ILi{size}E"))]
        else:
            out = (ctypes.c_ulonglong * 16)()
            fn()
            built.lib.phase_read(out)       # drop the first call's counts
            fn()
            if built.lib.phase_read(out):
                raise RuntimeError("phase_read failed")
            total = out[14]
            named = {p: out[i] / total for i, p in enumerate(LOOP)}
            named.update({p: out[4 + i] / total for i, p in enumerate(EPI)})
            named["insert"] -= named["merge"]   # insert's cycles hold merge's
            named["epilogue_other"] = named["epilogue"] - sum(
                named[p] for p in EPI)
            named["other"] = 1.0 - sum(named[p] for p in LOOP)
            rec |= {"patched": what,
                    **{p: round(v, 4) for p, v in named.items()},
                    "cycles_per_warp": round(total / max(out[15], 1))}
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        sys.exit(measure(Path(sys.argv[2]), sys.argv[3]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    root = Path(ap.parse_args().root).resolve()
    body = make_copy(root)
    rc = subprocess.run([sys.executable, __file__, "--measure", str(COPY),
                         body]).returncode
    rc2 = subprocess.run([sys.executable, __file__, "--measure", str(root),
                          "times"]).returncode
    sys.exit(rc or rc2)
