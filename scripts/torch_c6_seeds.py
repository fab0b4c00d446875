#!/usr/bin/env python3
"""How often an input seed puts the bf16 mixture gradient over its limit
(ROADMAP C6), on one NVIDIA GPU.

    python3 scripts/torch_c6_seeds.py [--seeds 200] [--first SEED] [--out FILE]

For each seed s of ``chip_smoke.SEED`` (or ``--first``) .. that + seeds - 1
it makes ``chip_smoke._mixture_inputs(4, 3500, 300, 3500, s)`` with z in
bf16 (the ``loss_bf16`` phase's M4 inputs at its own seed for s =
``SEED``), runs ``mixture_lse_cuda`` and ``mixture_grad_cuda`` (the bf16
entries) and holds dz, dalpha and dbeta against ``mixture_grad_twin`` on
the card, fed the kernel's lse, as ``chip_smoke.bf16_errors`` does:
max |err| / max |twin| against ``chip_smoke.BF16_TOL`` (4e-3).  The twin
runs on the card here (it has no atomics: cuBLAS products and dense
reductions, TF32 off) to keep 200 seeds inside a few minutes;
``chip_smoke.py`` runs it on CPU copies.

At every seed whose dz misses the limit against either twin, and at the
few seeds nearest to it, it also runs the twin on CPU copies and an f64
evaluation with the same rounding points (K of the bf16 rows exact in
f64; each modality's own K, where W_m, dalpha and dbeta read it, and W_tot
rounded once to bf16, ``snag_loss.round_bf16_once``, at the positive pairs
as both sides read it, ``snag_loss.positive_w``; W_tot z in f64), and
prints the kernel's, the card twin's and the CPU twin's max |err| against
it, each over max |f64|: the side far from the f64 value is the one whose
rounding moved.  It also counts the own-channel K entries whose bf16
rounding differs between the twin and f64, and those of them at a row's
positive partner, where both sides read ``positive_k``.  At a seed that
misses it names the entry that moved: the row of dz (modality m, row r)
whose kernel and twin values differ most, the multiple c of z_m[pos(r)]
that best fits that difference (one bf16 ulp of W_tot at the positive
column, if that entry flipped), the fit's residual, and the f64 W_tot
there, its bf16 ulp and its distance from the nearest rounding boundary
in ulps.

Prints one JSON line with the card's name and power limit, the count of
misses and the seeds; writes it to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
M, B, D = 4, 3500, 300
TAU = 0.1
NEAREST = 5          # seeds nearest the limit also checked against f64


def f64_reference(z, alpha, beta, lse, coef, v, tau):
    """(dz, dalpha, dbeta) of ``mixture_grad_twin``'s formulas in f64, with
    its bf16 rounding points: K exact, own-channel K and W_tot rounded to
    bf16 (at the positive pairs W_tot is ``snag_loss.positive_w``, the
    same f64 formula rounded once); and the own-channel K rounded to bf16,
    and W_tot before its rounding."""
    import torch
    from snag_tpu_torch.ops.cuda.snag_loss import positive_w, round_bf16_once
    f8 = torch.float64
    inv_tau = 1.0 / tau
    zd = z.to(f8)
    m, n2, _ = z.shape
    alpha, beta, lse, coef, v = (t.to(f8) for t in (alpha, beta, lse, coef, v))
    k = torch.einsum("mrd,mcd->mrc", zd, zd)
    mix_a = torch.einsum("rm,cm,mrc->rc", alpha, alpha, k)
    mix_f = torch.einsum("m,mrc->rc", beta, k)
    k_b = round_bf16_once(k).to(f8)
    s = torch.cat([k_b, mix_a[None], mix_f[None]]) * inv_tau
    del mix_a, mix_f, k
    rows = torch.arange(n2, device=z.device)
    half = n2 // 2
    pos = torch.where(rows < half, rows + half, rows - half)
    onehot = (rows[None, :] == pos[:, None]).to(f8)
    neq = (~torch.eye(n2, dtype=torch.bool, device=z.device)).to(f8)
    p_row = torch.exp(torch.clamp(s - lse[:, :, None], max=0.0))
    p_col = torch.exp(torch.clamp(s - lse[:, None, :], max=0.0))
    del s
    coef_r, coef_c = coef[:, :, None], coef[:, None, :]
    w = (neq[None] * (coef_r * p_row * v[None, None, :]
                      + p_col * coef_c * v[None, :, None])
         - onehot[None] * (coef_r + coef_c)) * inv_tau
    del p_row, p_col
    w_a, w_f = w[m], w[m + 1]
    aa = alpha.T[:, :, None] * alpha.T[:, None, :]
    w_tot_exact = w[:m] + w_a[None] * aa + w_f[None] * beta[:, None, None]
    w_tot = round_bf16_once(w_tot_exact).to(f8)
    # at the positive pairs, the value both sides read (positive_w)
    kpos = k_b[:, rows, pos].to(torch.float32)
    w_tot[:, rows, pos] = positive_w(z, *(t.to(torch.float32) for t in (
        alpha, beta, lse, coef, v)), tau, kpos).to(f8)
    dz = torch.bmm(w_tot, zd)
    dalpha = torch.einsum("rc,cm,mrc->rm", w_a, alpha, k_b)
    dbeta = 0.5 * torch.einsum("rc,mrc->m", w_f, k_b)
    return (dz, dalpha, dbeta), k_b, w_tot_exact


def moved_entry(dz_kernel, dz_twin, z, w_tot_exact):
    """The row of dz whose kernel and twin values differ most, and how
    well one changed W_tot entry at its positive column explains it."""
    import torch
    from snag_tpu_torch.ops.cuda.snag_loss import positive_rows
    diff = (dz_kernel.double() - dz_twin.double())
    m, r = divmod(int(diff.abs().amax(dim=2).argmax().item()), diff.shape[1])
    p = int(positive_rows(diff.shape[1], "cpu")[r])
    delta, zp = diff[m, r], z[m, p].double()
    c = (delta @ zp / (zp @ zp)).item()
    resid = ((delta - c * zp).norm() / delta.norm()).item()
    w = w_tot_exact[m, r, p].item()
    bits = torch.tensor([w], dtype=torch.float32).view(torch.int32)
    lo = (bits & ~0xFFFF).view(torch.float32).item()        # toward zero
    ulp = abs((((bits & ~0xFFFF) + 0x10000).view(torch.float32).item()) - lo)
    return {"modality": m, "row": r, "positive": p, "c": c,
            "fit_residual": resid, "w_tot_f64": w, "bf16_ulp": ulp,
            "ulps_from_boundary": abs(abs(w - lo) / ulp - 0.5)}


def rel_errs(got, want):
    """max |err| / max |want| of each output."""
    return [((a.double() - w.double()).abs().max()
             / w.double().abs().max()).item() for a, w in zip(got, want)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--out")
    ap.add_argument("--first", type=int, default=None,
                    help="the first seed (default chip_smoke.SEED)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_c6_seeds: torch.cuda is not available; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    records = []
    first = cs.SEED if args.first is None else args.first
    for seed in range(first, first + args.seeds):
        z, alpha, beta, v, coef = cs._mixture_inputs(M, B, D, B, seed)
        z = z.to(torch.bfloat16)
        lse = sl.mixture_lse_cuda(z, alpha, beta, v, TAU)
        got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU)
        twin = sl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
        errs = rel_errs(got, twin)
        records.append({"seed": seed, "dz": errs[0], "dalpha": errs[1],
                        "dbeta": errs[2]})
        del z, alpha, beta, v, coef, lse, got, twin
        torch.cuda.empty_cache()
    sweep_s = time.perf_counter() - t0
    limit = cs.BF16_TOL
    misses = [r for r in records if r["dz"] > limit]
    other = [r for r in records if max(r["dalpha"], r["dbeta"]) > limit]
    nearest = sorted(records, key=lambda r: -r["dz"])[:NEAREST]
    for r in {id(r): r for r in misses + nearest}.values():
        z, alpha, beta, v, coef = cs._mixture_inputs(M, B, D, B, r["seed"])
        z = z.to(torch.bfloat16)
        lse = sl.mixture_lse_cuda(z, alpha, beta, v, TAU)
        got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU)
        twin = sl.mixture_grad_twin(z, alpha, beta, lse, coef, v, TAU)
        ref, k_b, w_exact = f64_reference(z, alpha, beta, lse, coef, v, TAU)
        r["kernel_vs_f64"] = rel_errs(got, ref)
        r["twin_vs_f64"] = rel_errs(twin, ref)
        if r["dz"] > cs.BF16_TOL:
            r["moved"] = moved_entry(got[0], twin[0], z, w_exact)
        del twin, ref, w_exact
        torch.cuda.empty_cache()
        cpu = cs.on_cpu(sl.mixture_grad_twin, z, alpha, beta, lse, coef, v,
                        TAU)
        r["cpu_twin_dz"] = rel_errs(got, cpu)[0]
        ref, _, _ = f64_reference(z, alpha, beta, lse, coef, v, TAU)
        r["cpu_twin_vs_f64"] = rel_errs(cpu, ref)
        del cpu, ref
        # own-channel K: where the twin's f32 K rounds to another bf16
        # value than the exact K does; none may be at a positive partner,
        # where the twin reads positive_k
        k_twin = nx.gram(z).to(torch.bfloat16).to(torch.float64)
        rows = torch.arange(z.shape[1], device=z.device)
        pos = sl.positive_rows(z.shape[1], z.device)
        k_twin[:, rows, pos] = sl.positive_k(z).to(torch.float64)
        flips = k_twin != k_b
        r["own_k_flips"] = int(flips.sum().item())
        r["own_k_flips_at_positives"] = int(flips[:, rows, pos].sum().item())
        del z, alpha, beta, v, coef, lse, got, k_b, k_twin
        torch.cuda.empty_cache()
        print(json.dumps(r), flush=True)
    out = {"card": card, "shape": {"M": M, "B": B, "d": D}, "tau": TAU,
           "limit": limit, "seeds": [first, first + args.seeds - 1],
           "n_seeds": len(records), "dz_misses": len(misses),
           "dz_miss_seeds": [r["seed"] for r in misses],
           "dalpha_or_dbeta_misses": [r["seed"] for r in other],
           "max_dz": max(r["dz"] for r in records),
           "median_dz": sorted(r["dz"] for r in records)[len(records) // 2],
           "checked": [r for r in records if "kernel_vs_f64" in r],
           "sweep_s": sweep_s, "wall_s": time.perf_counter() - t0}
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
