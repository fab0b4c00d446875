"""Build and load the package's CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>_<hash>.so`` beside the
package at first use, and loaded with ``ctypes``.  The hash covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelStats:
    """Launch count of one kernel and the count of CPU calls that its
    wrapper answered with the plain-PyTorch twin instead."""
    name: str
    launches: int = 0
    twin_calls: int = 0


@dataclass
class BuiltLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    build_seconds: float          # 0.0 when an up-to-date build was loaded
    compiler_log: str = field(default="", repr=False)


_LOADED: Dict[str, BuiltLibrary] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "snag_tpu_torch are built from source at first use")


def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)
    built = BuiltLibrary(name=name, path=so, lib=ctypes.CDLL(str(so)),
                         build_seconds=seconds, compiler_log=log)
    built.lib.snag_error_string.argtypes = [ctypes.c_int]
    built.lib.snag_error_string.restype = ctypes.c_char_p
    _LOADED[name] = built
    return built


def check(lib: BuiltLibrary, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.lib.snag_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_suffix(dtype: torch.dtype, what: str) -> str:
    """The name suffix of the C entries of ``what`` for operands of
    ``dtype``: "" for float32, "_bf16" for bfloat16; raises on another."""
    if dtype == torch.float32:
        return ""
    if dtype == torch.bfloat16:
        return "_bf16"
    raise TypeError(f"operands of dtype {dtype}: the {what} take float32 "
                    "or bfloat16")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device) -> None:
    """The checks every kernel wrapper makes before passing a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it where its data does not start on a
    16-byte boundary (kernels that stage rows by 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
