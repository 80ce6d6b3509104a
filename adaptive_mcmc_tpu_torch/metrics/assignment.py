"""Linear sum assignment for the exact 1-1 Wasserstein coupling (PyTorch).

Counterpart of ``adaptive_mcmc_tpu/metrics/assignment.py``, with its three
backends behind one dispatch:

* ``native``: the port's copy of the Hungarian solver (``csrc/lsap.cpp``),
  compiled with the host C++ compiler into ``_build/liblsap-<digest>.so`` at
  first use (``<digest>`` covers the source, the flags and the compiler's
  version) and called through ctypes.  Exact, on the host.
* ``scipy``: ``scipy.optimize.linear_sum_assignment`` (exact).
* the ε-auction (:func:`auction_assignment`, :func:`auction_assignment_batch`):
  Bertsekas's auction with ε-scaling and block bidding, on the device of
  the cost.  The mean assigned cost is within ε_final of the exact 1-1
  Wasserstein (ε_final = range / (2n) by default).

The JAX round is gather- and scatter-free because the TPU serialises both.
Here a round (``ops/cuda/auction.py``) is one launch of a hand-written
kernel on a CUDA device and the plain PyTorch round on the CPU, with the
same bits: the first ``block`` unassigned rows of each instance, in
ascending order, bid; each column takes its highest bid, the lowest row
among equal ones, and its previous owner returns to the pool.  A round
reads nothing on the host and makes no shape that depends on data.  So on
a CUDA device blocks of ``ROUNDS_PER_GRAPH`` rounds replay from a CUDA
graph (one per block width and solve), and the host reads the count of
unassigned rows only between blocks; rounds after it reaches 0 are
no-ops, since no row bids.  ``eager=True`` launches the same rounds from a
Python loop.

Spans and counters (``utils.profiling``): ``auction.solve`` per solve and
``auction.level`` per ε level, ``graph.capture`` around a block's capture;
``auction.rounds``, ``auction.kernel_rounds`` (the kernel's launches in
each block, graph replays included: all the rounds on a CUDA device, none
on the CPU), ``graph.replays``
and ``host.reads`` (the count of unassigned rows between blocks, and the
final check).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from adaptive_mcmc_tpu_torch.infer.mcmc import _HostRead, _NoHostRead
from adaptive_mcmc_tpu_torch.ops.cuda import CapturedLaunches
from adaptive_mcmc_tpu_torch.ops.cuda import auction as kernel
from adaptive_mcmc_tpu_torch.utils import profiling

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parents[1]
LSAP_SOURCE = _PKG / "csrc" / "lsap.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-funroll-loops", "-fPIC", "-std=c++17", "-shared")
# rounds replayed from one CUDA graph; the host reads the number of
# unassigned rows between two blocks
ROUNDS_PER_GRAPH = 32

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None
# the ε levels of the last auction solve: (ε, rounds run, rounds in which
# an instance still had an unassigned row, the most over the batch)
last_levels: list = []


# ---------------------------------------------------------------------------
# The exact host solvers.
# ---------------------------------------------------------------------------

def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (looked for $CXX, g++, c++): "
                       "the native assignment solver cannot be built")


def lsap_library_path(cxx: str) -> Path:
    """Where the solver built by ``cxx`` lives: keyed by the source, the
    flags and the compiler's version, so that another compiler rebuilds."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(LSAP_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode() + b"\0" + version.encode())
    return BUILD_DIR / f"liblsap-{h.hexdigest()[:16]}.so"


def _build_lsap() -> ctypes.CDLL:
    cxx = _cxx()
    lib = lsap_library_path(cxx)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(LSAP_SOURCE)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {LSAP_SOURCE.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    dll = ctypes.CDLL(str(lib))
    dll.lsap_solve_f64.restype = ctypes.c_int
    dll.lsap_solve_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64)]
    return dll


def load_native() -> ctypes.CDLL:
    """The native solver, built at first use; raises RuntimeError (the
    same one on every later call) where it cannot be built or loaded."""
    global _LIB, _LIB_ERROR
    with _LOCK:
        if _LIB is None and _LIB_ERROR is None:
            try:
                _LIB = _build_lsap()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _LIB_ERROR = f"native LSAP solver unavailable: {e}"
        if _LIB is None:
            raise RuntimeError(_LIB_ERROR)
        return _LIB


def linear_sum_assignment(cost, solver: str = "auto") -> np.ndarray:
    """Exact minimum-cost row -> column assignment of ``cost`` (nr, nc),
    nr <= nc, on the host: returns the column of each row (int64).
    ``solver``: "auto" (native, else SciPy), "native" (raises where the
    library is missing) or "scipy"."""
    if solver not in ("auto", "native", "scipy"):
        raise ValueError(f"unknown solver {solver!r}")
    if isinstance(cost, Tensor):
        cost = cost.detach().cpu().numpy()
    cost = np.ascontiguousarray(np.asarray(cost, dtype=np.float64))
    nr, nc = cost.shape
    if solver in ("auto", "native"):
        try:
            lib = load_native()
        except RuntimeError:
            if solver == "native":
                raise
            lib = None
        if lib is not None:
            out = np.empty(nr, dtype=np.int64)
            rc = lib.lsap_solve_f64(
                nr, nc, cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc == 0:
                return out
            if solver == "native":
                raise RuntimeError(f"native LSAP solver refused a "
                                   f"{nr} x {nc} cost (nr <= nc is needed)")
    from scipy.optimize import linear_sum_assignment as scipy_lsap

    _, col = scipy_lsap(cost)
    return col.astype(np.int64)


# ---------------------------------------------------------------------------
# The ε-auction (Bertsekas 1988) with ε-scaling, batched.
# ---------------------------------------------------------------------------

def _block_tier(left: int, block: int, rounds_per_call: int):
    """Block width and rounds per chunk for ``left`` unassigned rows (the
    most over the batch): wide while everyone bids, then 128, then 16 for
    the endgame, where a few rows fight price wars for thousands of rounds.
    The host re-tiers after each chunk."""
    if left > 128:
        return block, min(64, rounds_per_call)
    if left > 16:
        return min(128, block), min(1_024, rounds_per_call)
    return min(16, block), min(32_768, rounds_per_call)


class _Auction:
    """The buffers and the rounds of one auction over ``benefit`` (B, n, m).
    ``row_to_col`` has one more slot per instance than rows: a sink for the
    lanes of the plain round's scatters that write nothing.  The kernel's
    scratch is allocated here, once."""

    def __init__(self, benefit: Tensor, prices: Tensor, eager: bool):
        B, n, m = benefit.shape
        dev = benefit.device
        self.benefit = benefit.contiguous()
        self.prices = prices.clone(memory_format=torch.contiguous_format)
        self.col_owner = torch.full((B, m), -1, dtype=torch.int64,
                                    device=dev)
        self.row_to_col = torch.full((B, n + 1), -1, dtype=torch.int64,
                                     device=dev)
        self.eps = torch.zeros((), device=dev)
        self.live = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.scratch = kernel.new_scratch(B, n, m, dev)
        self.eager = eager
        self.graphs: dict = {}
        self.checked = False

    def reset(self, eps: float) -> None:
        """An empty assignment at ``eps``; the prices stay."""
        self.col_owner.fill_(-1)
        self.row_to_col.fill_(-1)
        self.eps.fill_(eps)
        self.live.zero_()

    def unassigned(self) -> Tensor:
        return self.row_to_col[:, :-1] < 0

    def left(self) -> int:
        """The most unassigned rows of any instance (a host read)."""
        profiling.count("host.reads")
        return int(self.unassigned().sum(dim=1).max())

    def round(self, block: int) -> None:
        """One round (``ops/cuda/auction.py``): the first ``block``
        unassigned rows of each instance bid on their best column at its
        second-best margin plus ε; each column takes its highest bid (the
        lowest row among equal ones) and its previous owner returns to the
        pool."""
        kernel.auction_round(self.benefit, self.prices, self.row_to_col,
                             self.col_owner, self.eps, self.live, block,
                             self.scratch)

    def _rounds(self, k: int, block: int) -> None:
        for _ in range(k):
            self.round(block)

    def _block(self, k: int, block: int) -> None:
        """``k`` rounds at ``block``: eagerly, or from the graph of this
        width, captured after its first eager run."""
        if not self.checked:
            try:
                with _NoHostRead():
                    self.round(block)
            except _HostRead as e:
                raise RuntimeError(f"the auction round cannot be captured "
                                   f"into a CUDA graph: {e}") from e
            self.checked = True
            self._rounds(k - 1, block)
            return
        if self.eager or not self.benefit.is_cuda:
            self._rounds(k, block)
            return
        captured = self.graphs.get((k, block))
        if captured is None:
            self._rounds(k, block)
            with profiling.span("graph.capture", label="auction", rounds=k,
                                block=block), CapturedLaunches() as rec:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._rounds(k, block)
            self.graphs[(k, block)] = (graph, rec)
            return
        graph, rec = captured
        graph.replay()
        rec.replayed()
        profiling.count("graph.replays")

    def chunk(self, rounds: int, block: int) -> int:
        """Up to ``rounds`` rounds at ``block``, in blocks of
        ``ROUNDS_PER_GRAPH``; stops at the end of the block in which the
        last row was assigned.  Returns the rounds run."""
        done = 0
        while done < rounds:
            k = min(ROUNDS_PER_GRAPH, rounds - done)
            launched = kernel.launches
            self._block(k, block)
            profiling.count("auction.rounds", k)
            # the kernel's launches in the block: eager ones and, per
            # replay, those its graph recorded
            profiling.count("auction.kernel_rounds",
                            kernel.launches - launched)
            done += k
            if self.left() == 0:
                break
        return done


def _solve(costs: Tensor, eps_final, scaling_factor: float, max_rounds: int,
           block: int, rounds_per_call: int, prices_init, eager: bool,
           single: bool):
    """ε-scaled auction over ``costs`` (B, n, m) sharing one ε schedule;
    returns (row -> column (B, n) int64, prices (B, m))."""
    B, n, m = costs.shape
    if n > m:
        raise ValueError(f"the auction needs n <= m, got {n} x {m}")
    with profiling.span("auction.solve", B=B, n=n,
                        warm=prices_init is not None):
        return _levels(costs, eps_final, scaling_factor, max_rounds, block,
                       rounds_per_call, prices_init, eager, single)


def _levels(costs: Tensor, eps_final, scaling_factor: float,
            max_rounds: int, block: int, rounds_per_call: int, prices_init,
            eager: bool, single: bool):
    """:func:`_solve`'s ε levels."""
    global last_levels
    B, n, m = costs.shape
    rng = float(torch.max(costs) - torch.min(costs))
    if not math.isfinite(rng):
        raise ValueError("the auction needs finite costs: the cost "
                         "matrix holds a NaN or an infinity")
    if eps_final is None:
        # mean assigned cost within range / (2n) of optimal
        eps_final = max(rng, 1e-6) / (2.0 * n)
    if prices_init is None:
        eps = max(rng / 2.0, eps_final)
        prices = torch.zeros((B, m), device=costs.device)
    else:
        # ε-CS holds from any prices with an empty assignment, so a warm
        # start keeps the bound; one backup level absorbs a poor one
        eps = eps_final * scaling_factor
        p0 = torch.as_tensor(prices_init, dtype=torch.float32)
        p0 = p0.to(costs.device).reshape(-1, m)
        prices = p0.repeat(-(-B // p0.shape[0]), 1)[:B]
    auction = _Auction(-costs, prices, eager)
    levels = []
    while True:
        with profiling.span("auction.level", eps=eps):
            auction.reset(eps)
            spent = run = 0
            while spent < max_rounds:
                left = auction.left()
                if left == 0:
                    break
                blk, rounds = _block_tier(left, block, rounds_per_call)
                run += auction.chunk(rounds, blk)
                spent += rounds
            levels.append((eps, run, int(auction.live.max())))
            last_levels = levels
            if eps <= eps_final:
                incomplete = auction.unassigned().any(dim=1)
                profiling.count("host.reads")
                if bool(incomplete.any()):
                    what = (f"{int(auction.unassigned().sum())} rows "
                            "unassigned" if single else
                            f"{int(incomplete.sum())} instances incomplete")
                    raise RuntimeError(
                        f"auction exhausted max_rounds={max_rounds} at "
                        f"eps_final with {what}: raise max_rounds or use "
                        f"the Hungarian solver for this instance")
                return auction.row_to_col[:, :-1].clone(), auction.prices
        eps = max(eps / scaling_factor, eps_final)


def auction_assignment(cost, eps_final: Optional[float] = None,
                       scaling_factor: float = 10.0,
                       max_rounds: int = 4_000_000, block: int = 1024,
                       rounds_per_call: int = 8_192, prices_init=None,
                       return_prices: bool = False, eager: bool = False):
    """ε-scaled auction on the device of ``cost`` (n, m), n <= m.  Returns
    row -> column (n,), or (row -> column, prices (m,)) with
    ``return_prices``.  The total cost is within n · ε_final of optimal.

    ``prices_init`` (m,) warm-starts the column duals: from any prices with
    an empty assignment the auction keeps ε-complementary slackness, so the
    bound holds; sweeps against one fixed reference set reuse the last
    solve's prices and skip the cold ε schedule.  Raises RuntimeError where
    ``max_rounds`` runs out at ε_final."""
    cost = torch.as_tensor(cost, dtype=torch.float32)
    col, prices = _solve(cost[None], eps_final, scaling_factor, max_rounds,
                         block, rounds_per_call, prices_init, eager, True)
    return (col[0], prices[0]) if return_prices else col[0]


def auction_assignment_batch(costs, eps_final: Optional[float] = None,
                             scaling_factor: float = 10.0,
                             max_rounds: int = 4_000_000, block: int = 1024,
                             rounds_per_call: Optional[int] = None,
                             prices_init=None, return_prices: bool = False,
                             eager: bool = False):
    """ε-scaled auction over a batch ``costs`` (B, n, m) sharing one ε
    schedule: the instances run their rounds in lockstep, the widest
    instance picks the block width, and one that finishes early no-ops.
    Returns row -> column (B, n), or (row -> column, prices (B, m)).

    ``prices_init`` (B0, m) warm-starts the duals of each instance; its
    rows are tiled or cut to B (all instances solve against one reference
    set).  ε_final uses the largest cost range of the batch, so every
    instance keeps at least the single-instance bound."""
    costs = torch.as_tensor(costs, dtype=torch.float32)
    if rounds_per_call is None:
        rounds_per_call = 32_768
    col, prices = _solve(costs, eps_final, scaling_factor, max_rounds, block,
                         rounds_per_call, prices_init, eager, False)
    return (col, prices) if return_prices else col
