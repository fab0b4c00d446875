#!/usr/bin/env python3
"""The JAX package's committed quality gates, run by the PyTorch port on
one NVIDIA GPU.

    python3 scripts/torch_gates.py export
    python3 scripts/torch_gates.py parity --seed 3408 [--variant il40]
    python3 scripts/torch_gates.py canon --run c1|c2|c3
    (either with --dtype bfloat16)

``export`` writes the 30,000-entity DBP15K ja_en files of
``scripts/parity_15k.py`` (:91-100) with the port's exporter and prints a
sha256 of each text file and one of the image dict (each key as int64
bytes, then its row as float32 bytes, in the dict's order; the pickle's
own bytes depend on the numpy version).  ``parity`` and ``canon`` export
if needed, refuse files whose digests differ from ``DIGESTS`` (the JAX
package's export of the same arguments), and run
``snag_tpu_torch.cli.train_mmea`` on the card:

* ``parity``: ``parity_15k.py``'s 12-epoch protocol (its ``FLAGS``, and
  ``--variant il40`` for 40 epochs), logged as ``ours_<seed>.log`` or
  ``ours_il40_<seed>.log``;
* ``canon``: the canonical command of ``tests/data/canon15k/c1_cold.log.gz``
  (``--enable_sota``: epoch 1000, il_start 500, eval every 2 epochs; a
  checkpoint every 100 epochs; seed 3408): ``c1`` logs ``c1_cold.log``,
  ``c2`` the same run again as ``c2_repeat.log``; ``c3`` sends SIGTERM
  once the epoch-599 checkpoint is saved (``c3_killed.log``) and resumes
  from it (``c3_resumed.log``).

``--dtype bfloat16`` passes the JAX package's main-path dtype through to
the trainer and puts ``bf16_`` before the log's name (``ours_bf16_3408.log``,
``bf16_c1_cold.log``); the JAX package's committed gate logs are f32.

Each log starts with the card's name and power limit (nvidia-smi) and the
data digests, and ends with the run's wall time.  Data and run dumps go
under ``--root`` (default ``build/torch_gates``), logs under ``--logs``
(default: the root).  The port only: nothing of the JAX package is
imported.  On an H100 at 700 W the 12-epoch runs take ~25 s each, il40
~30 s, and each canonical run ~3 minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import os.path as osp
import pickle
import re
import signal
import subprocess
import sys
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# scripts/parity_15k.py:91-100
GEOMETRY = dict(n_ents=30000, n_rels=100, n_triples=120000, img_dim=300,
                seed=0, noise=1.2, mirror_p=0.4, unalignable_frac=0.35,
                img_coverage=1.0)
# the JAX package's export of GEOMETRY (numpy 2.0.2)
DIGESTS = {
    "ent_ids_1": "0f28be48bd51970e944ae68aeb21deed76232a23b828d3b14756c00739ea7eb0",
    "ent_ids_2": "e0a08c1bfff062abc6713123823af75dbe2c99001ebc73742c67438cc6120b07",
    "ill_ent_ids": "93670e86ddb214710db4c9a788b522b31c411cc8993af3cb925b1f9b88ed1d53",
    "training_attrs_1": "3dc16d8488b5988dd329354d82af1997092145e3bf2abdf0e8ae569372a59215",
    "training_attrs_2": "09b03077cc9786616dec98bd82a701923090e7c85a87bef05096b5ba441d5fc6",
    "triples_1": "8828c5c77dc0a38f72c3052d5158b3d79a4fcd6d67e249f6f287af94d9ae9631",
    "triples_2": "935c9aea8de02d84876c95137e42b01e0d9e2c77f728a6f2d63a0d894a1631e8",
    "img_dict (30000)": "3b814e3ffafa6f26fcca5b5534716dff12e81a82f34442faffe24b5d669b420f",
}

# scripts/parity_15k.py:48-66 and :76, with the port's --device
PARITY_FLAGS = [
    "--gpu", "0", "--model_name", "SNAG", "--data_choice", "DBP15K",
    "--data_split", "ja_en", "--data_rate", "0.3",
    "--epoch", "12", "--eval_epoch", "4", "--lr", "5e-4",
    "--hidden_units", "300,300,300", "--batch_size", "3500",
    "--csls", "--csls_k", "3", "--scheduler", "cos",
    "--attr_dim", "300", "--img_dim", "300", "--name_dim", "300",
    "--char_dim", "300", "--hidden_size", "300",
    "--intermediate_size", "400",
    "--tau", "0.1", "--tau2", "4.0", "--structure_encoder", "gat",
    "--num_attention_heads", "1", "--num_hidden_layers", "1",
    "--use_surface", "0", "--use_intermediate", "1",
    "--add_noise", "1", "--noise_ratio", "0.2", "--mask_ratio", "0.7",
    "--weight_decay", "0.001",
    "--il", "--il_start", "6", "--semi_learn_step", "1",
    "--device", "cuda",
]
VARIANTS = {"": {}, "il40": {"--epoch": "40"}}

# the "Running command" of tests/data/canon15k/c1_cold.log.gz, with the
# port's --device; --enable_sota turns epoch 1500 / il_start 250 /
# eval_epoch 1 into 1000 / 500 / 2
CANON_FLAGS = [
    "--gpu", "0", "--eval_epoch", "1", "--model_name", "SNAG",
    "--data_choice", "DBP15K", "--data_split", "ja_en", "--data_rate", "0.3",
    "--epoch", "1500", "--lr", "5e-4", "--hidden_units", "300,300,300",
    "--batch_size", "3500", "--semi_learn_step", "5", "--csls",
    "--csls_k", "3", "--random_seed", "3408", "--exp_name", "canon15k",
    "--workers", "1", "--accumulation_steps", "1", "--scheduler", "cos",
    "--attr_dim", "300", "--img_dim", "300", "--name_dim", "300",
    "--char_dim", "300", "--hidden_size", "300", "--intermediate_size", "400",
    "--tau", "0.1", "--tau2", "4.0", "--structure_encoder", "gat",
    "--num_attention_heads", "1", "--num_hidden_layers", "1",
    "--use_surface", "0", "--use_intermediate", "1", "--replay", "0",
    "--il", "--il_start", "250", "--enable_sota", "--add_noise", "1",
    "--noise_ratio", "0.2", "--mask_ratio", "0.7", "--checkpoint_every", "100",
    "--no_tensorboard", "--device", "cuda",
]
CANON_RUNS = {"c1": ("C1", "c1_cold.log"), "c2": ("C2", "c2_repeat.log"),
              "c3": ("C3", "c3_killed.log")}
CHECKPOINT_EVERY = 100
KILL_AFTER_EPOCH = 599
SAVED_RE = re.compile(r"checkpoint saved to (\S+)")


def data_digests(data_root: str) -> dict:
    """sha256 of each text file of the DBP15K ja_en split and of the image
    dict (each key as int64 bytes, then its row as float32 bytes)."""
    import numpy as np
    split = osp.join(data_root, "DBP15K", "ja_en")
    out = {}
    for name in sorted(os.listdir(split)):
        with open(osp.join(split, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    with open(osp.join(data_root, "pkls", "ja_en_GA_id_img_feature_dict.pkl"),
              "rb") as f:
        img = pickle.load(f)
    h = hashlib.sha256()
    for k, row in img.items():
        h.update(np.int64(k).tobytes())
        h.update(np.asarray(row, dtype=np.float32).tobytes())
    out[f"img_dict ({len(img)})"] = h.hexdigest()
    return out


def digest_lines(digests: dict) -> list:
    return [f"{name:<17}{d}" for name, d in digests.items()]


def export(root: str) -> dict:
    """Export GEOMETRY under ``<root>/data`` unless it is there; returns
    the digests, raising if any differs from DIGESTS."""
    sys.path.insert(0, REPO)
    from snag_tpu_torch.data.export_reference import export_reference_format
    data_root = osp.join(root, "data")
    if not osp.exists(osp.join(data_root, "DBP15K", "ja_en", "ill_ent_ids")):
        t0 = time.time()
        export_reference_format(data_root, **GEOMETRY)
        print(f"exported the 30K-entity KG to {data_root} in "
              f"{time.time() - t0:.1f} s", flush=True)
    digests = data_digests(data_root)
    for line in digest_lines(digests):
        print(line, flush=True)
    if digests != DIGESTS:
        bad = sorted(k for k in set(digests) | set(DIGESTS)
                     if digests.get(k) != DIGESTS.get(k))
        raise SystemExit(f"exported files differ from the JAX package's "
                         f"export in {bad}: refusing to train on them")
    return digests


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def run_logged(argv: list, log: str, header: list,
               kill_after_saves: int = 0) -> tuple:
    """Run the trainer with ``argv``, its output after ``header`` into
    ``log``; with ``kill_after_saves``, SIGTERM it once that many
    checkpoints are saved.  Returns (exit code, last checkpoint path)."""
    os.makedirs(osp.dirname(log) or ".", exist_ok=True)
    cmd = [sys.executable, "-m", "snag_tpu_torch.cli.train_mmea", *argv]
    saves, last = 0, None
    t0 = time.time()
    with open(log, "w") as f:
        for line in header + [f"running: {' '.join(cmd)}"]:
            f.write(line + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:
                f.write(line)
                m = SAVED_RE.search(line)
                if m:
                    saves, last = saves + 1, m.group(1)
                    f.flush()
                    if saves == kill_after_saves:
                        proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        f.write(f"wall {time.time() - t0:.1f} s, exit code {rc}\n")
    print(f"{log}: exit code {rc}, wall {time.time() - t0:.1f} s", flush=True)
    return rc, last


def header(digests: dict) -> list:
    return [f"card: {card()}"] + digest_lines(digests)


def dtype_flags(dtype: str) -> tuple:
    """(trainer flags, log-name prefix) of ``--dtype``."""
    if dtype == "float32":
        return [], ""
    return ["--dtype", dtype], "bf16_"


def parity(root: str, logs: str, seed: int, variant: str,
           dtype: str = "float32") -> None:
    digests = export(root)
    flags = list(PARITY_FLAGS)
    for k, v in VARIANTS[variant].items():
        flags[flags.index(k) + 1] = v
    extra, prefix = dtype_flags(dtype)
    tag = prefix + (f"{variant}_" if variant else "")
    argv = flags + extra + ["--random_seed", str(seed),
                    "--data_path", osp.join(root, "data"), "--workers", "1",
                    "--exp_name", "p15k", "--exp_id", f"T{tag}{seed}",
                    "--no_tensorboard", "--dump_path", osp.join(root, "dump")]
    rc, _ = run_logged(argv, osp.join(logs, f"ours_{tag}{seed}.log"),
                       header(digests))
    if rc:
        raise SystemExit(rc)


def canon(root: str, logs: str, run: str, dtype: str = "float32") -> None:
    digests = export(root)
    exp_id, name = CANON_RUNS[run]
    extra, prefix = dtype_flags(dtype)
    exp_id, name = prefix + exp_id, prefix + name
    argv = CANON_FLAGS + extra + ["--exp_id", exp_id,
                          "--data_path", osp.join(root, "data"),
                          "--dump_path", osp.join(root, "dump")]
    kill = KILL_AFTER_EPOCH + 1 if run == "c3" else 0
    rc, ckpt = run_logged(argv, osp.join(logs, name), header(digests),
                          kill_after_saves=kill // CHECKPOINT_EVERY)
    if run != "c3":
        if rc:
            raise SystemExit(rc)
        return
    if rc != -signal.SIGTERM or ckpt is None:
        raise SystemExit(f"c3: the run was not killed after its epoch-"
                         f"{KILL_AFTER_EPOCH} checkpoint (exit code {rc})")
    rc, _ = run_logged(argv + ["--resume_from", ckpt],
                       osp.join(logs, f"{prefix}c3_resumed.log"),
                       header(digests))
    if rc:
        raise SystemExit(rc)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stage", choices=["export", "parity", "canon"])
    p.add_argument("--seed", type=int, default=3408)
    p.add_argument("--variant", default="", choices=sorted(VARIANTS))
    p.add_argument("--run", default="c1", choices=sorted(CANON_RUNS))
    p.add_argument("--root", default=osp.join(REPO, "build", "torch_gates"))
    p.add_argument("--logs", default="")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    a = p.parse_args()
    root = osp.abspath(a.root)
    logs = osp.abspath(a.logs or a.root)
    if a.stage == "export":
        export(root)
    elif a.stage == "parity":
        parity(root, logs, a.seed, a.variant, a.dtype)
    else:
        canon(root, logs, a.run, a.dtype)


if __name__ == "__main__":
    main()
