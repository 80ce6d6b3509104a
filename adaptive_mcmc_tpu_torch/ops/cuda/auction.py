"""The ε-auction's round as one kernel: its wrapper and its plain version.

The round of ``metrics/assignment.py``'s batched auction, over B instances
at once, in place on the auction's buffers: ``benefit`` (B, n, m) with
n <= m, ``prices`` (B, m), ``row_to_col`` (B, n + 1) (the last slot of each
instance a sink that stays -1), ``col_owner`` (B, m), ``eps`` (a 0-d
tensor) and ``live`` (B,).  The first ``block`` unassigned rows of each
instance bid on their best column at its second-best margin plus ε; each
column takes its highest bid (the lowest row among equal ones), and its
previous owner returns to the pool.

Replaces no TPU kernel (the JAX package's round is gather- and
scatter-free XLA).  The CUDA source is ``csrc/auction.cu``; its header says
how a round is laid out and what bounds it.  Dispatch depends on the
tensor's device alone: a CPU tensor runs the plain PyTorch round
(:func:`auction_round_reference`), a CUDA tensor launches the kernel or
raises.  The two give the same bits after every round.  The kernel's
scratch (:func:`new_scratch`) is the caller's, allocated once per auction
and checked on either device.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_mcmc_tpu_torch.ops.cuda import _build

Tensor = torch.Tensor

WARPS_PER_BLOCK = 8          # csrc/auction.cu kWarps
RESIDENT_WARPS_PER_SM = 64   # sm_90
launches = 0
_SMS: dict = {}


def auction_round_reference(benefit: Tensor, prices: Tensor,
                            row_to_col: Tensor, col_owner: Tensor,
                            eps: Tensor, live: Tensor, block: int) -> None:
    """Plain version of one round, in place.  The bidders come from a
    cumsum compaction (no host read, no shape that depends on data); each
    takes its first best column and the best other value, bids; a column's
    best bid comes from ``scatter_reduce("amax")`` and its lowest tied row
    from an ``amin`` over the rows whose bid equals it."""
    B, n, m = benefit.shape
    dev = benefit.device
    un = row_to_col[:, :-1] < 0                              # (B, n)
    live += un.any(dim=1)
    pos = torch.cumsum(un, dim=1) - 1
    slot = torch.where(un & (pos < block), pos, block)
    idx = torch.full((B, block + 1), n, dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, torch.arange(n, device=dev).expand(B, n))
    idx = idx[:, :block]                 # ascending, padded with n
    valid = idx < n
    safe = torch.clamp_max(idx, n - 1)
    vals = torch.gather(benefit, 1, safe[:, :, None].expand(B, block, m))
    vals -= prices[:, None, :]                               # (B, K, m)
    v1, j1 = torch.max(vals, dim=2)      # j1: the first best column
    vals.scatter_(2, j1[:, :, None], float("-inf"))
    v2 = torch.amax(vals, dim=2)
    bid = torch.gather(prices, 1, j1) + (v1 - v2) + eps
    bid = bid.masked_fill(~valid, float("-inf"))
    win_bid = torch.full((B, m), float("-inf"), device=dev) \
        .scatter_reduce_(1, j1, bid, "amax")
    got = torch.isfinite(win_bid)
    tied = bid == torch.gather(win_bid, 1, j1)
    win_row = torch.full((B, m), n, dtype=torch.int64, device=dev) \
        .scatter_reduce_(1, j1, torch.where(tied, idx, n), "amin")
    win_row = torch.where(got, win_row, n)
    prev = col_owner
    displaced = got & (prev >= 0) & (prev != win_row)
    row_to_col.scatter_(1, torch.where(displaced, prev, n), -1)
    won = valid & (torch.gather(win_row, 1, j1) == idx)
    row_to_col.scatter_(1, torch.where(won, idx, n),
                        torch.where(won, j1, -1))
    col_owner.copy_(torch.where(got, win_row, prev))
    prices.copy_(torch.where(got, win_bid, prices))


def new_scratch(B: int, n: int, m: int, device) -> tuple:
    """The kernel's scratch for B instances of n x m: each column's best
    key (B, m) and each instance's count of blocks done (B,), zero between
    rounds, and a record (row, column, bid) per bidder slot (B, n, 3)."""
    return (torch.zeros((B, m), dtype=torch.int64, device=device),
            torch.empty((B, n, 3), dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=torch.int32, device=device))


def warps_per_bidder(B: int, bidders: int, m: int, sms: int) -> int:
    """Warps that read one bidding row: more while the round's B · bidders
    rows leave the card idle, up to a block's eight, so that the endgame's
    few bidders do not wait on one warp each; the round's warps stay within
    half of the card's resident warps, and each warp keeps at least 128
    columns (one float4 a lane).  In a trial of 1, 2, 4 and 8 warps at
    n = m = 625 and 10000, blocks 1024, 128 and 16 on an H100, its pick
    came within 8% of the fastest at B = 8 and within 2% at B = 1
    (PERF.md section 6)."""
    g = 1
    while g < WARPS_PER_BLOCK:
        wider = 2 * g
        if (2 * B * bidders * wider > sms * RESIDENT_WARPS_PER_SM
                or m < 128 * wider):
            return g
        g = wider
    return g


def _check_args(benefit, prices, row_to_col, col_owner, eps, live, block,
                scratch) -> tuple:
    """(B, n, m) of well-formed arguments, or raises."""
    if benefit.dim() != 3:
        raise ValueError(f"benefit must be (B, n, m), got "
                         f"{tuple(benefit.shape)}")
    B, n, m = benefit.shape
    if not 1 <= n <= m:
        raise ValueError(f"the auction needs 1 <= n <= m, got {n} x {m}")
    if int(block) < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    want = {"benefit": ((B, n, m), torch.float32),
            "prices": ((B, m), torch.float32),
            "row_to_col": ((B, n + 1), torch.int64),
            "col_owner": ((B, m), torch.int64),
            "eps": ((), torch.float32),
            "live": ((B,), torch.int64),
            "keys": ((B, m), torch.int64),
            "slots": ((B, n, 3), torch.int32),
            "done": ((B,), torch.int32)}
    keys, slots, done = scratch
    got = dict(benefit=benefit, prices=prices, row_to_col=row_to_col,
               col_owner=col_owner, eps=eps, live=live, keys=keys,
               slots=slots, done=done)
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} of shape {shape}, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != benefit.device:
            raise ValueError("every argument must be on benefit's device")
    return B, n, m


def launch_round(benefit: Tensor, prices: Tensor, row_to_col: Tensor,
                 col_owner: Tensor, eps: Tensor, live: Tensor, block: int,
                 scratch: tuple) -> None:
    """One round through the kernel; the arguments are checked before the
    library is loaded.  CUDA tensors only."""
    global launches
    B, n, m = _check_args(benefit, prices, row_to_col, col_owner, eps, live,
                          block, scratch)
    if not benefit.is_cuda:
        raise ValueError(f"the auction kernel takes CUDA tensors, got "
                         f"{benefit.device}")
    dev = benefit.device
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    K = min(int(block), n)
    fn = _build.function(
        "auction", "auction_round",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    keys, slots, done = scratch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(benefit.data_ptr(), prices.data_ptr(), row_to_col.data_ptr(),
             col_owner.data_ptr(), eps.data_ptr(), live.data_ptr(),
             keys.data_ptr(), slots.data_ptr(), done.data_ptr(), B, n, m, K,
             warps_per_bidder(B, K, m, _SMS[dev]), stream)
    _build.check(err, "auction_round")
    launches += 1


def auction_round(benefit: Tensor, prices: Tensor, row_to_col: Tensor,
                  col_owner: Tensor, eps: Tensor, live: Tensor, block: int,
                  scratch: tuple) -> None:
    """One round, in place: the kernel for CUDA tensors, the plain version
    (which leaves ``scratch`` alone) for CPU tensors."""
    if benefit.is_cuda:
        launch_round(benefit, prices, row_to_col, col_owner, eps, live,
                     block, scratch)
        return
    _check_args(benefit, prices, row_to_col, col_owner, eps, live, block,
                scratch)
    auction_round_reference(benefit, prices, row_to_col, col_owner, eps,
                            live, block)
