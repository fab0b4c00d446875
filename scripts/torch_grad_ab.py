#!/usr/bin/env python3
"""The loss kernels of a checkout of the PyTorch port (both gradients and
both lse), timed and fingerprinted on one NVIDIA GPU.

    python3 scripts/torch_grad_ab.py [--root DIR] [--out FILE] [--against FILE]

Imports ``snag_tpu_torch`` from DIR (default: this checkout), builds its
kernels there, and on ``chip_smoke.py``'s inputs runs

* ``mixture_grad_cuda`` at ``chip_smoke.MIXTURE_SHAPES``: the sha256 of
  the bytes of dz, dalpha and dbeta, and the median ms of 5 runs (CUDA
  events); ``mixture_lse_cuda`` there: the sha256 of lse and the median ms;
* ``ntxent_grad_cuda`` at ``chip_smoke.NTXENT_SHAPES``: the sha256 of dz
  and the median ms, or the error the wrapper raised; ``streaming_lse_cuda``
  there: the sha256 of lse and the median ms.

It prints one JSON line with the card's name and power limit, and writes
it to FILE.  With ``--against`` it fails unless the mixture digests equal
those of an earlier run's FILE: the check that two builds compute the same
bits.  Run each checkout in its own process (two packages of one name
cannot share one), in turns on one card: A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAU = 0.1


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_grad_ab: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # chip_smoke (inputs, shapes, timing) from this checkout, the package
    # from --root
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))
    from snag_tpu_torch.ops.cuda import ntxent as nx
    from snag_tpu_torch.ops.cuda import snag_loss as sl
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": args.root, "package": str(Path(nx.__file__).parents[2]),
           "card": card, "mixture_grad": {}, "ntxent_grad": {},
           "mixture_lse": {}, "ntxent_lse": {}}

    for i, (label, m, b, d, n_valid) in enumerate(cs.MIXTURE_SHAPES):
        z, alpha, beta, v, coef = cs._mixture_inputs(m, b, d, n_valid,
                                                     cs.SEED + i)
        lse = sl.mixture_lse_twin(z, alpha, beta, v, TAU)
        got = sl.mixture_grad_cuda(z, alpha, beta, lse, coef, v, TAU)
        ms = cs.median_ms(lambda: sl.mixture_grad_cuda(z, alpha, beta, lse,
                                                       coef, v, TAU))
        out["mixture_grad"][label] = {"sha256": digest(*got), "ms": ms}
        got = sl.mixture_lse_cuda(z, alpha, beta, v, TAU)
        ms = cs.median_ms(lambda: sl.mixture_lse_cuda(z, alpha, beta, v, TAU))
        out["mixture_lse"][label] = {"sha256": digest(got), "ms": ms}
        del z, alpha, beta, v, coef, lse, got
        torch.cuda.empty_cache()

    for i, (label, m, b, d, n_valid) in enumerate(cs.NTXENT_SHAPES):
        z, v, coef = cs._ntxent_inputs(m, b, d, n_valid, cs.SEED + i)
        lse = nx.streaming_lse_cuda(z, v, TAU)
        ms = cs.median_ms(lambda: nx.streaming_lse_cuda(z, v, TAU))
        out["ntxent_lse"][label] = {"sha256": digest(lse), "ms": ms}
        lse = nx.streaming_lse_twin(z, v, TAU)
        try:
            dz = nx.ntxent_grad_cuda(z, lse, coef, v, TAU)
        except ValueError as e:
            out["ntxent_grad"][label] = {"error": str(e)}
            continue
        ms = cs.median_ms(lambda: nx.ntxent_grad_cuda(z, lse, coef, v, TAU))
        out["ntxent_grad"][label] = {"sha256": digest(dz), "ms": ms}
        del z, v, coef, lse, dz
        torch.cuda.empty_cache()

    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    if args.against:
        other = json.loads(Path(args.against).read_text())
        for label, rec in out["mixture_grad"].items():
            same = rec["sha256"] == other["mixture_grad"][label]["sha256"]
            print(f"mixture_grad {label}: "
                  f"{'bit-identical' if same else 'DIFFERENT'} to "
                  f"{other['root']}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
