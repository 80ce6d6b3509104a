"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled at first
use into ``_build/lib<name>-<hash>.so``, where ``<hash>`` covers the source
and the compiler flags, so an edited source rebuilds and an unchanged one is
loaded as built.  Every pointer and the stream cross as ``ctypes.c_void_p``;
every launch function returns ``cudaGetLastError()``, which :func:`check`
turns into an exception.

Flags: ``sm_90a`` (Hopper), ``-O3``, IEEE division and square root, and no
FMA contraction (``-fmad=false``), so that the kernels round like the plain
PyTorch versions they are checked against; ``--use_fast_math`` is never
used, since its approximate division and sqrt could turn the NaN of an
indefinite downdate into a finite value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
    "-prec-div=true", "-prec-sqrt=true",
)

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()
build_seconds: dict = {}   # name -> nvcc wall seconds in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the CUDA "
        "kernels of adaptive_mcmc_tpu_torch cannot be built"
    )


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        _LIBS[name] = ctypes.CDLL(str(lib_path))
        return _LIBS[name]


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of library ``name``, typed once: returns
    int (a CUDA error code)."""
    key = (name, symbol)
    if key not in _FUNCS:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
