"""Low-latency (barrier-free) all-gather for small messages.

Counterpart of ``triton_distributed_tpu/ops/collectives/low_latency.py``:
``ll_all_gather_workspace`` (:55), ``ll_all_gather`` (:139) and
``ll_all_gather_op`` (:190). The hand-written kernel of
``csrc/collectives.cu`` replaces ``_ll_ag_kernel`` (:62); the plain
version is the concatenation of the shards (:func:`all_gather_plain`).

The workspace (:class:`LLWorkspace`) is a symmetric allocation ``[2
phases, n sources, m_per, L]`` a rank and the rank's own arrival and ACK
flags, zeroed once; the caller threads it through the calls with a phase
counter that goes up by one a call, as in JAX. A call pushes the shard
into every peer's persistent slot ``p = phase % 2``, copies its own shard
out, waits the ``n - 1`` arrivals of slot ``p``, assembles and ACKs every
producer. There is no entry and no trailing barrier: the flags carry the
caller's counter instead of a launch epoch, so an arrival reads ``phase +
1``, and a producer overwrites a peer's slot ``p`` only once that peer's
ACK for ``p`` reads ``phase - 1`` (the ACK of the use at ``phase - 2``).
``barrier_free=False`` is JAX's entry-barrier variant (an entry barrier
instead of the ACK wait; the ACKs are still written, so the two may
alternate on one workspace). ``barrier_free=None`` means True on the card,
as JAX's default on its device.

A phase that does not advance by one on its workspace raises
``ValueError``: on the card its waits would never be met. On one card the
launches of one stream never overlap, so the ACK wait never blocks there;
what the card can show of the discipline is the flag values it leaves
behind (:func:`ll_flags` against :func:`ll_expected_flags`).

On the card each warp runs the discipline for one sub-piece of its
block's piece of the shard, with its own arrival and ACK flags at device
scope (one launch covers every co-located rank): the n - 1 pushes, flags
and copies of a warp go out at once, and the own copy runs while the
arrivals travel. The grid is ~``_launch.RING_BLOCK_BYTES`` of a rank's
work a block, fixed with the flags when the workspace is made.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives import _launch
from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    all_gather_plain,
)
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)


@dataclasses.dataclass
class LLWorkspace:
    """The persistent state of one low-latency gather site: ``slots``
    (``[2, n, m_per, lanes]`` a rank), ``flags`` (``n`` barrier flags,
    then arrivals ``[2, n, blocks, RING_WARPS]`` and ACKs of the same
    shape a rank), the grid fixed for its flags, and the last phase run
    (-1: none)."""

    slots: object    # SymmBuffer
    flags: object    # SymmBuffer of int64 (read as uint64 on the device)
    m_per: int
    lanes: int
    dtype: torch.dtype
    blocks: int
    phase: int = -1


def ll_flag_count(n: int, blocks: int) -> int:
    """Flags a rank: the barrier's n, then an arrival and an ACK flag a
    (slot, peer, block, warp)."""
    return n + 4 * n * blocks * _launch.RING_WARPS


def ll_grid(n: int, shard_bytes: int, dtype: torch.dtype) -> int:
    """The card's grid a rank: ~RING_BLOCK_BYTES of a rank's work a block
    (its shard pushed to n - 1 slots, n shards copied out)."""
    return _launch.blocks(_launch.LOW_LATENCY, 0, dtype, n,
                          (2 * n - 1) * shard_bytes, None,
                          _launch.RING_BLOCK_BYTES)


def ll_all_gather_workspace(ctx, m_per: int, lanes: int,
                            dtype: torch.dtype = torch.float32,
                            blocks_per_rank: int | None = None
                            ) -> LLWorkspace:
    """A fresh workspace for ``[m_per, lanes]`` shards of ``dtype`` over
    the context's ranks, zeroed; its grid ``blocks_per_rank`` (default: 1
    on the CPU, :func:`ll_grid` on the card)."""
    n = ctx.tp
    blocks = 1 if blocks_per_rank is None else int(blocks_per_rank)
    if blocks_per_rank is None and device_initiable(ctx) and n > 1:
        shard = m_per * lanes * torch.empty((), dtype=dtype).element_size()
        blocks = ll_grid(n, shard, dtype)
    return LLWorkspace(
        ctx.symm_empty((2, n, m_per, lanes), dtype, zero=True),
        ctx.symm_empty((ll_flag_count(n, blocks),), torch.int64, zero=True),
        int(m_per), int(lanes), dtype, blocks)


def _advance(ws: LLWorkspace, phase) -> int:
    phase = int(phase)
    if phase != ws.phase + 1:
        raise ValueError(
            f"phase {phase} on a workspace whose last phase was {ws.phase}: "
            "each call advances the phase by one (a skipped or repeated "
            "phase would wait forever on the card)")
    return phase


def _check_workspace(xs: list[torch.Tensor], ws: LLWorkspace, ctx) -> None:
    """The shards are what ``ws`` was made for: its rank count, shape and
    dtype (its slots and the kernel's byte count are sized by them)."""
    n_ws = ws.flags.data.shape[0]
    if n_ws != ctx.tp:
        raise ValueError(f"a workspace of {n_ws} ranks for tp={ctx.tp}")
    if (tuple(xs[0].shape) != (ws.m_per, ws.lanes)
            or xs[0].dtype != ws.dtype):
        raise ValueError(
            f"x is {tuple(xs[0].shape)} {xs[0].dtype}; the workspace takes "
            f"{(ws.m_per, ws.lanes)} {ws.dtype}")


def ll_all_gather_kernel(xs: list[torch.Tensor], ws: LLWorkspace, phase,
                         ctx, barrier_free: bool = True, *, out=None
                         ) -> list[torch.Tensor]:
    """One cooperative launch of the low-latency kernel over all ranks at
    ``phase`` (advancing ``ws``)."""
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    _check_workspace(xs, ws, ctx)
    outs = _launch.outputs("out", (n * ws.m_per, ws.lanes), ws.dtype, ctx,
                           out)
    phase = _advance(ws, phase)
    ck.LL_ALL_GATHER(rank_ptrs(xs), rank_ptrs(outs),
                     ws.slots.table.data_ptr(), ws.flags.table.data_ptr(), n,
                     x0.numel() * x0.element_size(), phase,
                     int(bool(barrier_free)), ws.blocks, ck.stream_ptr(x0))
    ws.phase = phase
    return outs


def ll_all_gather(xs: list[torch.Tensor], ws: LLWorkspace, phase, ctx,
                  barrier_free: bool | None = None
                  ) -> tuple[list[torch.Tensor], LLWorkspace]:
    """Gather the ranks' ``[m_per, lanes]`` shards into ``[n * m_per,
    lanes]`` on every rank through the persistent workspace ``ws`` at the
    caller's ``phase`` (the last phase plus one). Returns ``(outs, ws)``,
    as JAX returns the updated workspace. On the CPU the plain version."""
    check_ranks("x", xs, ctx, ndim=2)
    _check_workspace(xs, ws, ctx)
    if barrier_free is None:
        barrier_free = device_initiable(ctx)
    if ctx.tp > 1 and device_initiable(ctx):
        return ll_all_gather_kernel(xs, ws, phase, ctx, barrier_free), ws
    ws.phase = _advance(ws, phase)
    return all_gather_plain(xs), ws


def ll_all_gather_op(x: torch.Tensor, steps: int, ctx) -> torch.Tensor:
    """Host-level form: ``steps`` back-to-back gathers of ``x [n * m_per,
    lanes]`` (sharded along its leading dim) on one workspace; returns the
    last call's ``[n, n * m_per, lanes]`` (row r = rank r's copy)."""
    xs = ctx.shard(x, 0)
    ws = ll_all_gather_workspace(ctx, xs[0].shape[0], xs[0].shape[1],
                                 x.dtype)
    out = None
    for s in range(int(steps)):
        out, ws = ll_all_gather(xs, ws, s, ctx)
    return torch.stack(out)


def ll_flags(ws: LLWorkspace) -> dict[str, torch.Tensor]:
    """The workspace's flags as read back: ``arrivals[r, p, src, g, w]``
    (src's sub-piece (g, w) arrived in rank r's slot p) and ``acks[r, p, c,
    g, w]`` (consumer c took rank r's sub-piece (g, w) from its slot p),
    each the phase + 1 of the last call that set it."""
    data = ws.flags.data
    n, g, w = data.shape[0], ws.blocks, _launch.RING_WARPS
    body = data[:, n:ll_flag_count(n, g)].reshape(n, 2, 2, n, g, w)
    return {"arrivals": body[:, 0], "acks": body[:, 1]}


def ll_expected_flags(ws: LLWorkspace) -> torch.Tensor:
    """What the discipline leaves in both flag kinds after the calls up to
    ``ws.phase``: at ``[r, p, c, g, w]``, the last phase of slot p plus one
    (0 if slot p was never used) for every peer c, and 0 at c = r."""
    n, g = ws.flags.data.shape[0], ws.blocks
    want = torch.zeros((n, 2, n, g, _launch.RING_WARPS), dtype=torch.int64)
    for p in range(2):
        last = ws.phase - ((ws.phase - p) % 2)
        if last >= 0:
            want[:, p] = last + 1
    for r in range(n):
        want[r, :, r] = 0
    return want
