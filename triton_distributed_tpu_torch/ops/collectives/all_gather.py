"""AllGather over co-located ranks.

Counterpart of ``triton_distributed_tpu/ops/collectives/all_gather.py``:
``AllGatherMethod`` and ``all_gather`` (:245). ``XLA`` is the plain
version, a concatenation of the shards (XLA's own ``all_gather``); the
hand-written kernels of ``csrc/collectives.cu`` are ``PALLAS_FULL_MESH``
(replacing ``_full_mesh_kernel`` :146), ``PALLAS_RING`` (``_ring_kernel``
:49) and ``PALLAS_BIDIR_RING`` (``_bidir_ring_kernel`` :93: each shard's
top half travels right, its bottom half left). The rings flag each warp's
sub-piece of a hop at device scope (:func:`gather_flags`). They move
bytes only, so the plain version of every method is the same
concatenation.

AUTO is the JAX dispatch (:257-269): on the card the full mesh for n <= 2
or up to 64 KB a shard, else the bidirectional ring, which becomes the
ring when a shard has fewer than 2 rows (:279); on the CPU ``XLA``, as the
JAX AUTO does off the TPU. ``PALLAS_PULL`` (``_pull_kernel`` :182,
``pull_window`` :245) is the receiver-driven gather: no entry barrier,
each rank reads its peers' shards itself, ``min(max(window, 1), n - 1)``
peers at a time (:215); AUTO never takes it, as in JAX.

:func:`all_gather_torus_2d` (:408, replacing ``_torus_2d_kernel`` :328)
gathers over both axes of a ``dp x tp`` context in one launch of all its
ranks, rank-major slots ``(d * tp + t) * m_per`` (the JAX ``(gx * ny +
gy)`` order with ``ax = "dp"``). :func:`all_gather_op` (:443) is the
host-level form.
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives import _launch
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)

_FULL_MESH_MAX_BYTES = 64 * 1024


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    PALLAS_RING = "pallas_ring"
    PALLAS_BIDIR_RING = "pallas_bidir_ring"
    PALLAS_FULL_MESH = "pallas_full_mesh"
    PALLAS_PULL = "pallas_pull"


# Kernel of each ported method: (C kind, launch counter, site).
_KERNELS = {
    AllGatherMethod.PALLAS_FULL_MESH: (0, ck.ALL_GATHER, "all_gather"),
    AllGatherMethod.PALLAS_RING: (1, ck.ALL_GATHER_RING, "all_gather_ring"),
    AllGatherMethod.PALLAS_BIDIR_RING: (2, ck.ALL_GATHER_BIDIR_RING,
                                        "all_gather_bidir_ring"),
}


def all_gather_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's ``[n * m_per, ...]``: the shards in rank order."""
    full = torch.cat(xs, dim=0)
    return [full] + [full.clone() for _ in xs[1:]]


def gather_flags(kind: int, n: int, blocks: int) -> int:
    """Flags a rank of a gather kernel's launch: the entry barrier's n,
    then the full mesh's one a (source, block), or the rings' one a (hop,
    block, warp): each block's piece of a hop is ``RING_WARPS`` flagged
    sub-pieces (split over the two directions in the bidir ring)."""
    if kind == 0:
        return n + n * blocks
    return n + (n - 1) * blocks * _launch.RING_WARPS


def _gather_kernel(method: AllGatherMethod, xs, ctx,
                   blocks_per_rank: int | None, out=None
                   ) -> list[torch.Tensor]:
    """One cooperative launch of ``method``'s kernel over all ranks: the
    full mesh ~BLOCK_BYTES of a shard a block, the rings
    ~RING_BLOCK_BYTES; ``out`` (per rank ``[n * m_per, ...]``) receives
    the result when given."""
    kind, kernel, site = _KERNELS[method]
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    outs = _launch.outputs("out", (n * x0.shape[0], *x0.shape[1:]),
                           x0.dtype, ctx, out)
    shard_bytes = x0.numel() * x0.element_size()
    half_bytes = (x0.shape[0] // 2) * (shard_bytes // max(x0.shape[0], 1))
    blocks = _launch.blocks(
        _launch.ALL_GATHER, kind, x0.dtype, n, shard_bytes, blocks_per_rank,
        _launch.BLOCK_BYTES if kind == 0 else _launch.RING_BLOCK_BYTES)
    fs = site_flags(ctx, site, gather_flags(kind, n, blocks))
    kernel(kind, rank_ptrs(xs), rank_ptrs(outs), fs.flags.table.data_ptr(),
           n, shard_bytes, half_bytes, next_epoch(fs), int(blocks),
           ck.stream_ptr(x0))
    return outs


def all_gather_pull(xs: list[torch.Tensor], ctx, window: int = 2, *,
                    out=None) -> list[torch.Tensor]:
    """The pull kernel: every rank reads its peers' shards into its own
    output, ``min(max(window, 1), n - 1)`` peers at a time, with no entry
    barrier. ``out`` (per rank ``[n * m_per, ...]``) receives the result
    when given."""
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    outs = _launch.outputs("out", (n * x0.shape[0], *x0.shape[1:]),
                           x0.dtype, ctx, out)
    w = min(max(int(window), 1), n - 1)
    return _launch.move(ck.ALL_GATHER_PULL, _launch.PULL, "all_gather_pull",
                        xs, outs, ctx, w, 0,
                        work_bytes=n * x0.numel() * x0.element_size(),
                        min_blocks=w)


def all_gather_full_mesh(xs: list[torch.Tensor], ctx,
                         blocks_per_rank: int | None = None
                         ) -> list[torch.Tensor]:
    """The full-mesh kernel: every rank puts its shard into every rank's
    output. ``blocks_per_rank`` overrides the default grid (a grid that
    cannot be co-resident raises)."""
    return _gather_kernel(AllGatherMethod.PALLAS_FULL_MESH, xs, ctx,
                          blocks_per_rank)


def all_gather_ring(xs: list[torch.Tensor], ctx,
                    blocks_per_rank: int | None = None, *,
                    out=None) -> list[torch.Tensor]:
    """The ring kernel: n - 1 steps, each forwarding one shard right."""
    return _gather_kernel(AllGatherMethod.PALLAS_RING, xs, ctx,
                          blocks_per_rank, out)


def all_gather_bidir_ring(xs: list[torch.Tensor], ctx,
                          blocks_per_rank: int | None = None, *,
                          out=None) -> list[torch.Tensor]:
    """The bidirectional ring kernel: each shard's first ``m_per // 2``
    rows go right, the rest left."""
    return _gather_kernel(AllGatherMethod.PALLAS_BIDIR_RING, xs, ctx,
                          blocks_per_rank, out)


def auto_method(nbytes: int, n: int) -> AllGatherMethod:
    """The JAX AUTO on the device (``all_gather.py:257-269``) for a shard
    of ``nbytes`` over ``n`` ranks."""
    if n <= 2 or nbytes <= _FULL_MESH_MAX_BYTES:
        return AllGatherMethod.PALLAS_FULL_MESH
    return AllGatherMethod.PALLAS_BIDIR_RING


def all_gather(xs: list[torch.Tensor], ctx,
               method: AllGatherMethod = AllGatherMethod.AUTO,
               pull_window: int = 2) -> list[torch.Tensor]:
    """Gather the ranks' shards ``xs[r] [m_per, ...]`` along the leading
    dim: every rank gets ``[n * m_per, ...]``. Takes and returns one
    tensor per rank; ``pull_window`` paces ``PALLAS_PULL``. A kernel
    method on the CPU takes the plain version."""
    check_ranks("x", xs, ctx)
    if ctx.tp == 1:
        return list(xs)
    n, m_per = ctx.tp, xs[0].shape[0]
    if method == AllGatherMethod.AUTO:
        method = (auto_method(xs[0].numel() * xs[0].element_size(), n)
                  if device_initiable(ctx) else AllGatherMethod.XLA)
    if method == AllGatherMethod.PALLAS_BIDIR_RING and (m_per < 2 or n <= 2):
        method = AllGatherMethod.PALLAS_RING  # halves degenerate (:279)
    if method == AllGatherMethod.XLA or not device_initiable(ctx):
        return all_gather_plain(xs)
    if method == AllGatherMethod.PALLAS_PULL:
        return all_gather_pull(xs, ctx, pull_window)
    return _gather_kernel(method, xs, ctx, None)


def all_gather_op(x: torch.Tensor, ctx,
                  method: AllGatherMethod = AllGatherMethod.AUTO,
                  pull_window: int = 2) -> torch.Tensor:
    """Host-level form: ``x [n * m_per, ...]`` sharded along its leading
    dim over the ranks; returns ``[n, n * m_per, ...]`` (row r = rank r's
    gathered copy)."""
    return torch.stack(all_gather(ctx.shard(x, 0), ctx, method, pull_window))


def all_gather_torus_2d_kernel(xs: list[torch.Tensor], ctx, *, out=None
                               ) -> list[torch.Tensor]:
    """One cooperative launch of the torus kernel over every rank of the
    ``dp x tp`` context (its :meth:`~triton_distributed_tpu_torch.runtime.
    mesh.DistContext.flat` tables and flags)."""
    world = ctx.flat()
    x0 = xs[0]
    _launch.check_operands("x", xs, world, elementwise=False)
    n = world.tp
    outs = _launch.outputs("out", (n * x0.shape[0], *x0.shape[1:]),
                           x0.dtype, world, out)
    return _launch.move(ck.ALL_GATHER_TORUS_2D, _launch.TORUS,
                        "all_gather_torus_2d", xs, outs, world, ctx.tp, n,
                        work_bytes=n * x0.numel() * x0.element_size())


def all_gather_torus_2d(xs: list[torch.Tensor], ctx,
                        axes: tuple[str, str] = ("dp", "tp")
                        ) -> list[torch.Tensor]:
    """Gather over both axes of a ``dp x tp`` context in one kernel:
    ``xs`` holds one ``[m_per, ...]`` shard per global rank (``d * tp +
    t``); every rank gets ``[dp * tp * m_per, ...]`` in that order. Only
    ``axes=("dp", "tp")`` (the JAX default, rank-major slots) is taken."""
    if tuple(axes) != ("dp", "tp"):
        raise ValueError(f"axes {axes!r}: the port takes ('dp', 'tp'), "
                         "its rank order")
    check_ranks("x", xs, ctx.flat())
    if xs[0].dim() < 2:
        raise ValueError("all_gather_torus_2d needs >= 2-D input")
    if ctx.world == 1:
        return list(xs)
    if not device_initiable(ctx):
        return all_gather_plain(xs)  # the shards in global rank order
    return all_gather_torus_2d_kernel(xs, ctx)
