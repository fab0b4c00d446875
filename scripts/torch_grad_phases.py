#!/usr/bin/env python3
"""Where the f32 loss gradient's warps spend their cycles, on one NVIDIA GPU.

    python3 scripts/torch_grad_phases.py [--root DIR]
    python3 scripts/torch_grad_phases.py --ab DIR [DIR ...] [--pairs N]
    python3 scripts/torch_grad_phases.py --widths DIR [DIR ...] [--pairs N]
    python3 scripts/torch_grad_phases.py --measure DIR phases|times|widths

Copies DIR's ``snag_tpu_torch`` (default: this checkout's) to
``build/grad_f32_phases/`` and adds ``clock64`` counters to that copy of
``csrc/gram_grad.cuh`` (DIR's own sources are not touched): to the
main-path body (``gram_grad``) and, where DIR has it, to the wide body
(``gram_grad_wide``).  It then runs ``ntxent_grad_cuda`` and
``mixture_grad_cuda`` on ``chip_smoke.py``'s inputs at ``SHAPES`` (the
main path's IIR; MEAformer's joint loss and the unfused GMI at d = 1,200,
which keep the main-path body at one block an SM; and the wide shapes,
past that body's accumulator: GMI6 at d = 1,800, the mixture at M = 4,
d = 1,600 and at M = 1 just past the cap) and prints, per shape, each
phase's share of the warps' summed cycles:

* ``K``: the K products, with their hi/lo splits;
* ``W``: the weights, their exps (and the mixtures' sums over K_m; in
  the wide body with the reads of the K partials from the cluster);
* ``Wz``: the W z products and the accumulator's read-modify-write;
* ``wait``: waiting on the cp.async ring (``cp.async.wait_group``);
* ``barrier``: the block's barriers;
* ``issue``: issuing the next ring slot's copies;
* ``cluster``: the wide body's exchanges: publishing its K partial, the
  cluster barrier and the copy of W from the rows' owners;
* ``other``: the rest of the column-tile loop,

with the cycles a warp.  The counters cost registers and issue slots, so
the shares, not the times, are the result.  Then, from DIR's unpatched
build (``times``), each shape's plan and device ms
(``chip_smoke.device_ms``).  One JSON line per shape and part, with the
card's name and power limit.  An anchor that does not match exits naming
it; the wide body's anchors are tried only where DIR has that body.

``--ab`` times ``SHAPES`` (``times``) and ``--widths`` the f32 NT-Xent
gradient (``ntxent_grad_cuda``) at ``WIDTHS``, B = 3,500, each for every
DIR in its own process, the DIRs in turns ``--pairs`` times (A B A B ...:
two packages of one name cannot share a process); both print each
shape's plan in each DIR, every run's device ms (``chip_smoke.device_ms``
of both bodies' kernels) and their medians.  Where the main-path body
hands the gradient to the wide body was read from ``--widths``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "grad_f32_phases"
HEADER = "snag_tpu_torch/csrc/gram_grad.cuh"
PHASES = ("K", "W", "Wz", "wait", "barrier", "issue", "cluster")
TAU = 0.1
# (label, kernel, M, B, d)
SHAPES = (("IIR", "ntxent", 4, 3500, 300),
          ("MEAformer joint", "ntxent", 1, 3500, 1200),
          ("GMI", "ntxent", 2, 3500, 1200),
          ("GMI6", "ntxent", 2, 3500, 1800),
          ("M4 d1600", "mixture", 4, 3500, 1600),
          ("M1 d1512", "mixture", 1, 3500, 1512))

# (M, d) of the width sweep: M = 1 is MEAformer's joint loss, M = 2 the
# unfused GMI; the main-path body runs one block an SM past 352 columns and
# its accumulator holds up to 1,504 (H100)
WIDTHS = tuple((1, d) for d in (384, 576, 800, 1000, 1200, 1400, 1504,
                                1512)) + tuple((2, d) for d in (800, 1200,
                                                                1504, 1512))
SWEEP_B = 3500

COUNTERS = ("namespace {\n\nconstexpr int MAX_MOD = 6;",
            "__device__ unsigned long long g_phase[9];\n"
            "namespace {\n\nconstexpr int MAX_MOD = 6;")
# c[0 .. 6] the phases above, c[7] the loop's cycles; g_phase[8] counts
# the warps that reported
REPORT = """
  c[7] = clock64() - q_start;
  if (lane == 0) {
    for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[i], c[i]);
    atomicAdd(&g_phase[8], 1ull);
  }
"""
# the main-path body (gram_grad)
MAIN = [
    ("""  auto next = [&]() -> const float* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();
    issue();""",
     """  unsigned long long c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  auto next = [&]() -> const float* {
    const long long q0 = clock64();
    cp_async_wait_dyn(depth - 2);
    const long long q1 = clock64();
    __syncthreads();
    const long long q2 = clock64();
    issue();
    c[3] += q1 - q0;
    c[4] += q2 - q1;
    c[5] += clock64() - q2;"""),
    ("""  for (int q = 0; q < depth - 1; ++q) issue();

  for (int col0 = ct0 * COLS;""",
     """  for (int q = 0; q < depth - 1; ++q) issue();
  const long long q_start = clock64();

  for (int col0 = ct0 * COLS;"""),
    ("      for (int s = 0; s < ks; ++s) k_step(next(), kacc);",
     """      for (int s = 0; s < ks; ++s) {
        const float* kb_ = next();
        const long long qk = clock64();
        k_step(kb_, kacc);
        c[0] += clock64() - qk;
      }"""),
    ("""    int gc[4];
    bool okc[4];
    float v_c[4];""",
     """    const long long qw = clock64();
    int gc[4];
    bool okc[4];
    float v_c[4];"""),
    ("""    // this block's modalities: the weight into shared memory (the next""",
     """    c[1] += clock64() - qw;
    // this block's modalities: the weight into shared memory (the next"""),
    ("""      if (mi > 0) __syncthreads();   // every warp is done with the last W
      float da[2], db;""",
     """      {
        const long long qb = clock64();
        if (mi > 0) __syncthreads();
        c[4] += clock64() - qb;
      }
      const long long qw2 = clock64();
      float da[2], db;"""),
    ("""      }
      for (int p0 = 0; p0 < ntiles; p0 += PASS_TILES) {""",
     """      }
      c[1] += clock64() - qw2;
      for (int p0 = 0; p0 < ntiles; p0 += PASS_TILES) {"""),
    ("""        for (int s = 0; s < Z_STEPS; ++s) z_step(next(), w, s, cnt, part);
        add_part(accs + mi * acc_floats, p0, cnt, part);""",
     """        for (int s = 0; s < Z_STEPS; ++s) {
          const float* zb_ = next();
          const long long qz = clock64();
          z_step(zb_, w, s, cnt, part);
          c[2] += clock64() - qz;
        }
        const long long qa = clock64();
        add_part(accs + mi * acc_floats, p0, cnt, part);
        c[2] += clock64() - qa;"""),
    ("""  cp_async_wait<0>();
  __syncthreads();

  // split 0 writes dz (and dalpha), split s > 0 its partials (the scratch""",
     REPORT + """  cp_async_wait<0>();
  __syncthreads();

  // split 0 writes dz (and dalpha), split s > 0 its partials (the scratch"""),
]
# the wide body (gram_grad_wide), where the checkout has it
WIDE_MARK = "gram_grad_wide("
WIDE = [
    ("""  auto next = [&]() -> const float* {
    cp_async_wait_dyn(depth - 2);
    __syncthreads();    // the wide body's ring
    issue();""",
     """  unsigned long long c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  auto next = [&]() -> const float* {
    const long long q0 = clock64();
    cp_async_wait_dyn(depth - 2);
    const long long q1 = clock64();
    __syncthreads();
    const long long q2 = clock64();
    issue();
    c[3] += q1 - q0;
    c[4] += q2 - q1;
    c[5] += clock64() - q2;"""),
    ("""  // the loop: K of tile it, then W and W z of tile it - 1
  for (int it = 0; it <= n_tiles; ++it) {""",
     """  const long long q_start = clock64();
  for (int it = 0; it <= n_tiles; ++it) {"""),
    ("""      for (int s = k_lo; s < k_hi; ++s) k_step(next(), kacc);""",
     """      for (int s = k_lo; s < k_hi; ++s) {
        const float* kb_ = next();
        const long long qk = clock64();
        k_step(kb_, kacc);
        c[0] += clock64() - qk;
      }"""),
    ("""      // publish the K partial""",
     """      const long long qp = clock64();
      // publish the K partial"""),
    ("""              make_float2(kacc[nt][2 * h], kacc[nt][2 * h + 1]);
    }""",
     """              make_float2(kacc[nt][2 * h], kacc[nt][2 * h + 1]);
      c[6] += clock64() - qp;
    }"""),
    ("""    // the weights of tile it - 1's share of rows""",
     """    const long long qw = clock64();
    // the weights of tile it - 1's share of rows"""),
    ("""    // every block's K partials of tile it and W of tile it - 1 published
    cluster_barrier();""",
     """    c[1] += clock64() - qw;
    const long long qs = clock64();
    cluster_barrier();"""),
    ("""      // W z of tile it - 1 over the chunk's features""",
     """      c[6] += clock64() - qs;
      // W z of tile it - 1 over the chunk's features"""),
    ("""        for (int s = 0; s < Z_STEPS; ++s) z_step(next(), w, s, cnt, part);
        add_part(acc, p0, cnt, part);""",
     """        for (int s = 0; s < Z_STEPS; ++s) {
          const float* zb_ = next();
          const long long qz = clock64();
          z_step(zb_, w, s, cnt, part);
          c[2] += clock64() - qz;
        }
        const long long qa = clock64();
        add_part(acc, p0, cnt, part);
        c[2] += clock64() - qa;"""),
    ("""  // no block leaves while another may read its shared memory
  cluster_barrier();""",
     REPORT + """  cluster_barrier();"""),
]
READ = """

extern "C" int phase_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 9);
  const unsigned long long zero[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def patch(text: str, patches) -> str:
    for anchor, new in patches:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {HEADER}:\n{anchor}")
        text = text.replace(anchor, new)
    return text


def make_copy(root: Path) -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(root / "snag_tpu_torch", COPY / "snag_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = COPY / HEADER
    text = header.read_text()
    wide = WIDE_MARK in text
    text = patch(patch(text, [COUNTERS]), MAIN + (WIDE if wide else []))
    header.write_text(text)
    for name in ("ntxent.cu", "snag_loss.cu"):
        src = COPY / "snag_tpu_torch" / "csrc" / name
        src.write_text(src.read_text() + READ)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def calls(cs, nx, sl):
    """(label, kernel, plan, fn, library) of each shape on chip_smoke's
    inputs, the gradient fed its twin's lse."""
    import torch
    for label, kernel, m, b, d in SHAPES:
        if kernel == "ntxent":
            z, v, coef = cs._ntxent_inputs(m, b, d, b, cs.SEED)
            lse = nx.streaming_lse_twin(z, v, TAU)
            fn = (lambda z=z, lse=lse, coef=coef, v=v:
                  nx.ntxent_grad_cuda(z, lse, coef, v, TAU))
            plan = nx.grad_plan(m, 2 * b, d, z.device)
            yield label, "ntxent_grad", plan, fn, nx._library()
        else:
            z, alpha, beta, v, coef = cs._mixture_inputs(m, b, d, b, cs.SEED)
            lse = sl.mixture_lse_twin(z, alpha, beta, v, TAU)
            fn = (lambda z=z, alpha=alpha, beta=beta, lse=lse, coef=coef, v=v:
                  sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU))
            plan = sl.grad_plan(m, 2 * b, d, z.device)
            yield label, "mixture_grad", plan, fn, sl._library()
        torch.cuda.empty_cache()


def measure(root: str, part: str) -> int:
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_grad_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    if part == "widths":
        for m, d in WIDTHS:
            z, v, coef = cs._ntxent_inputs(m, SWEEP_B, d, SWEEP_B, cs.SEED)
            lse = nx.streaming_lse_twin(z, v, TAU)
            ms = cs.device_ms(lambda: nx.ntxent_grad_cuda(z, lse, coef, v, TAU),
                              cs.DEVICE_KERNELS["ntxent_grad"])
            print(json.dumps({"part": part, "shape": f"M{m} d{d}",
                              "card": name, "root": root, "device_ms": ms,
                              "plan": nx.grad_plan(m, 2 * SWEEP_B, d,
                                                   z.device)}), flush=True)
            del z, v, coef, lse
            torch.cuda.empty_cache()
        return 0
    for label, kernel, plan, fn, built in calls(cs, nx, sl):
        rec = {"part": part, "kernel": kernel, "shape": label, "card": name,
               "root": root, "plan": plan}
        if part == "phases":
            out = (ctypes.c_ulonglong * 9)()
            fn()
            built.lib.phase_read(out)        # drop the first call's counts
            fn()
            if built.lib.phase_read(out):
                raise RuntimeError("phase_read failed")
            total = max(out[7], 1)
            rec.update({n: round(out[i] / total, 4)
                        for i, n in enumerate(PHASES)})
            rec["other"] = round(1 - sum(out[:7]) / total, 4)
            rec["cycles_per_warp"] = round(total / max(out[8], 1))
            rec["warps"] = out[8]
        else:
            # the kernel's names match both bodies' launches
            rec["device_ms"] = cs.device_ms(fn, cs.DEVICE_KERNELS[kernel])
        print(json.dumps(rec), flush=True)
    return 0


def turns(roots, pairs: int, part: str) -> int:
    """``--measure ROOT part`` of each root, in turns; then per shape each
    root's plan, device ms of every run, and median."""
    runs, shapes = {}, []
    for turn in range(pairs):
        for root in roots:
            out = subprocess.run(
                [sys.executable, __file__, "--measure", root, part],
                capture_output=True, text=True)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode:
                print(json.dumps({"part": part, "root": root, "turn": turn,
                                  "rc": out.returncode}))
                return out.returncode
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    if rec["shape"] not in shapes:
                        shapes.append(rec["shape"])
                    runs.setdefault((rec["shape"], root), []).append(rec)
    for shape in shapes:
        row = {"part": part, "shape": shape,
               "card": runs[(shape, roots[0])][0]["card"]}
        for root in roots:
            recs = runs[(shape, root)]
            ms = [r["device_ms"] for r in recs]
            row[root] = {"plan": recs[0]["plan"], "device_ms": ms,
                         "median": statistics.median(ms)}
        print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--measure", nargs=2, metavar=("DIR", "PART"))
    ap.add_argument("--ab", nargs="+", metavar="DIR")
    ap.add_argument("--widths", nargs="+", metavar="DIR")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if args.measure:
        return measure(*args.measure)
    for part, roots in (("times", args.ab), ("widths", args.widths)):
        if roots:
            return turns([str(Path(r).resolve()) for r in roots], args.pairs,
                         part)
    root = Path(args.root).resolve()
    make_copy(root)
    rc = subprocess.run([sys.executable, __file__, "--measure", str(COPY),
                         "phases"]).returncode
    return rc or subprocess.run([sys.executable, __file__, "--measure",
                                 str(root), "times"]).returncode


if __name__ == "__main__":
    sys.exit(main())
