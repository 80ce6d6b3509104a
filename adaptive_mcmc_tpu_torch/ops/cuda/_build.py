"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled at first
use into ``_build/lib<name>-<hash>.so``.  ``<hash>`` (:func:`source_digest`)
covers the source, every header it includes with quotes (``common.cuh``),
and the compiler flags, so an edited source or header rebuilds and an
unchanged one is loaded as built.  :func:`build` compiles several libraries
at once, one nvcc process each.  Every pointer and the stream cross as
``ctypes.c_void_p``; every launch function returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.  ptxas's report of each
kernel (registers, stack frame, spills) is kept beside the library as
``lib<name>-<hash>.ptxas.txt``; :func:`ptxas_summary` condenses it.

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
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
    "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v",
)
# Flags of one library beside NVCC_FLAGS.  K1 instantiates three kernels for
# each d up to 32; nvcc optimises them on all cores at once (the code it
# makes is the same).
EXTRA_FLAGS = {"chol_update": ("--split-compile", "0")}
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.RLock()
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


def _sources(src: Path) -> list:
    """``src`` and every header it includes with quotes, recursively, each
    once, in include order."""
    out, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return out


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(src.stem, ())


def source_digest(src: Path) -> str:
    """Hash of ``src``, the local headers it includes and the nvcc flags:
    the key of its built library."""
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(_flags(src)).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(CSRC / f'{name}.cu')}.so"


def _compile(nvcc: str, name: str, lib: Path):
    """One nvcc run into ``lib``; returns an error message or None."""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    src = CSRC / f"{name}.cu"
    cmd = [nvcc, *_flags(src), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        return (f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return None


def build(*names: str) -> None:
    """Compile each library of ``names`` that is not built yet, one nvcc
    process each, all started together; raises if any build fails."""
    with _LOCK:
        todo = [(n, _lib_path(n)) for n in names]
        todo = [(n, lib) for n, lib in todo if not lib.exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with ThreadPoolExecutor(len(todo)) as pool:
            errors = list(pool.map(lambda job: _compile(nvcc, *job), todo))
        failed = [e for e in errors if e]
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    with _LOCK:
        if name not in _LIBS:
            build(name)
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
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


def ptr(t):
    """A tensor's device address for a ``ctypes.c_void_p`` argument, or
    None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def layout(name: str, tag: str, chains: int | None = None) -> tuple:
    """(lanes per chain, threads per block, blocks resident per SM) of the
    kernel behind ``<name>_layout_<tag>`` (the occupancy calculator on the
    current device): the sweep of ``<name>_<tag>`` for K2 and K3.  K1
    (``chol_update``) picks its layout from the chain count, so its entry
    points take ``chains``: tag ``d<n>`` is the chains-first kernel at
    ``d = n``, ``cl_d<n>`` the chains-last one.  Raises on failure."""
    lead = [] if chains is None else [ctypes.c_int]
    fn = function(name, f"{name}_layout_{tag}",
                  lead + [ctypes.POINTER(ctypes.c_int)] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    args = ([] if chains is None else [chains]) + [ctypes.byref(v)
                                                   for v in out]
    check(fn(*args), f"{name}_layout_{tag}")
    return tuple(v.value for v in out)


def ptxas_summary(name: str) -> list:
    """One line per kernel of library ``name`` from ptxas's report of its
    build (the mangled name, registers, stack frame and spill bytes); empty
    if the library was not built with the report."""
    report = _lib_path(name).with_suffix(".ptxas.txt")
    return parse_ptxas(report.read_text()) if report.exists() else []


def parse_ptxas(text: str) -> list:
    """The per-kernel lines of :func:`ptxas_summary` from ``-Xptxas -v``
    output."""
    out, entry, frame = [], None, None
    for line in text.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            entry, frame = m.group(1), None
        elif (m := _PTXAS_FRAME.search(line)) and entry:
            frame = m.groups()
        elif (m := _PTXAS_REGS.search(line)) and entry and frame:
            out.append(f"{entry}: {m.group(1)} registers, {frame[0]}-byte "
                       f"stack frame, {frame[1]} bytes spill stores, "
                       f"{frame[2]} bytes spill loads")
            entry = None
    return out
