"""ReduceScatter over co-located ranks.

Counterpart of ``triton_distributed_tpu/ops/collectives/reduce_scatter.py``:
``ReduceScatterMethod`` and ``reduce_scatter`` (:319). Each rank holds
``[n * m_per, ...]`` partial sums; rank r gets the reduced chunk r
``[m_per, ...]``. The hand-written kernels of ``csrc/collectives.cu``:

- ``ONE_SHOT`` (``_one_shot_rs_kernel`` :150): chunk p goes straight to
  rank p, which sums the n contributions in f32 in source-rank order and
  rounds once;
- ``PALLAS_RING`` (``_ring_rs_kernel`` :59): n - 1 hops, chunk me-1-s
  sent right at step s, the running sum rounded to the dtype at every
  hop (``bufs[s] + x`` in the dtype, :81);
- ``PALLAS_BIDIR_RING`` (``_bidir_ring_rs_kernel`` :89): the same with
  the rows from ``m_per // 2`` on reduced by a counter-clockwise ring;
- ``PALLAS_RING_HBM`` (``_ring_rs_hbm_kernel`` :191): the ring's
  arithmetic over row tiles of at most 1 MB, each tile flagged. On the
  card it launches the ring's kernel: the rings flag one sub-piece a warp
  (:func:`scatter_flags`), finer than those tiles, so each sub-piece's
  next hop already starts as soon as it lands.

Every kernel flags one sub-piece a warp and keeps every flag at device
scope (one launch covers every co-located rank), the rings running both
directions at once, with a grid of ~``_launch.RING_BLOCK_BYTES`` of a
rank's work a block (:func:`scatter_grid`).

``XLA`` is the plain psum-scatter: the partials summed in f32 in rank
order and rounded once (the one-shot's arithmetic). Each kernel's plain
version below repeats its order and roundings.

AUTO is the JAX dispatch (:332-342): on the card ONE_SHOT up to 256 KB of
partials, BIDIR_RING up to 4 MB (``VMEM_COMM_MAX_BYTES``), else
RING_HBM; BIDIR_RING becomes RING for n <= 2 or odd or single-row chunks
(:409-414). On the CPU AUTO takes ``XLA``, as the JAX AUTO does off the
TPU, and a kernel method takes its plain version.
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

_RS_ONE_SHOT_MAX_BYTES = 256 * 1024
# The JAX package's VMEM_COMM_MAX_BYTES (ops/common.py:36): where its AUTO
# hands the ring over to the HBM-slot ring.
_RS_RING_MAX_BYTES = 4 * 1024 * 1024


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    ONE_SHOT = "one_shot"
    PALLAS_RING = "pallas_ring"
    PALLAS_BIDIR_RING = "pallas_bidir_ring"
    PALLAS_RING_HBM = "pallas_ring_hbm"


# Kernel of each method: (C kind, launch counter, site).
_KERNELS = {
    ReduceScatterMethod.ONE_SHOT: (0, ck.REDUCE_SCATTER_ONE_SHOT,
                                   "reduce_scatter_one_shot"),
    ReduceScatterMethod.PALLAS_RING: (1, ck.REDUCE_SCATTER_RING,
                                      "reduce_scatter_ring"),
    ReduceScatterMethod.PALLAS_BIDIR_RING: (2, ck.REDUCE_SCATTER_BIDIR_RING,
                                            "reduce_scatter_bidir_ring"),
    ReduceScatterMethod.PALLAS_RING_HBM: (3, ck.REDUCE_SCATTER_RING_HBM,
                                          "reduce_scatter_ring_hbm"),
}


def _chunks(xs: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """``xs[r]`` split into its n chunks: ``[r][c]``."""
    n = len(xs)
    return [list(torch.chunk(x, n, dim=0)) for x in xs]


def reduce_scatter_one_shot_plain(xs: list[torch.Tensor]
                                  ) -> list[torch.Tensor]:
    """Rank c's chunk: every rank's chunk c summed in f32 in rank order,
    rounded once (ONE_SHOT, and the XLA method)."""
    ch = _chunks(xs)
    out = []
    for c in range(len(xs)):
        acc = ch[0][c].to(torch.float32)
        for r in range(1, len(xs)):
            acc = acc + ch[r][c].to(torch.float32)
        out.append(acc.to(xs[0].dtype))
    return out


def reduce_scatter_ring_plain(xs: list[torch.Tensor],
                              half: int | None = None) -> list[torch.Tensor]:
    """The rings' arithmetic: chunk c's rows below ``half`` (all of them
    by default: PALLAS_RING and PALLAS_RING_HBM) summed clockwise, rank
    c+1 first, then c+2, ..., c; the rows from ``half`` on (the bidir
    ring's counter-clockwise half) from rank c-1 down to c. The running
    sum is rounded to the dtype at every hop."""
    n = len(xs)
    ch = _chunks(xs)
    m_per = ch[0][0].shape[0]
    half = m_per if half is None else int(half)
    out = []
    for c in range(n):
        cw = ch[(c + 1) % n][c][:half]
        ccw = ch[(c - 1) % n][c][half:]
        for j in range(2, n + 1):
            cw = cw + ch[(c + j) % n][c][:half]
            ccw = ccw + ch[(c - j) % n][c][half:]
        out.append(torch.cat([cw, ccw], dim=0))
    return out


def scatter_flags(kind: int, n: int, blocks: int) -> int:
    """Flags a rank of a reduce-scatter launch of C ``kind`` over ``blocks``
    a rank: the barrier's ``n``, then the one-shot's one a (source, block,
    warp), or the rings' one a (direction, hop, block, warp): each block's
    piece is ``RING_WARPS`` flagged sub-pieces (the bidirectional ring's
    half each way)."""
    return n + (n if kind == 0 else n - 1) * blocks * _launch.RING_WARPS


def scatter_grid(kind: int, dtype: torch.dtype, n: int, chunk_bytes: int,
                 blocks_per_rank: int | None = None) -> int:
    """Blocks a rank of C ``kind``: ~RING_BLOCK_BYTES of a rank's work a
    block (``_launch.blocks``): a chunk for the rings; for the one-shot 2n
    chunks, its n chunks read (n - 1 pushed out) and the n contributions
    summed. A sweep on an H100 put the one-shot's best grid there: 24
    blocks a rank at [48, 2048] bf16, n = 2 and 4."""
    work = 2 * n * chunk_bytes if kind == 0 else chunk_bytes
    return _launch.blocks(_launch.REDUCE_SCATTER, kind, dtype, n, work,
                          blocks_per_rank, _launch.RING_BLOCK_BYTES)


def reduce_scatter_kernel(method: ReduceScatterMethod, xs, ctx, *,
                          blocks_per_rank: int | None = None,
                          lag: tuple = (-1, 0)) -> list[torch.Tensor]:
    """One cooperative launch of ``method``'s kernel over all ranks.
    ``lag`` = (rank, ns) lags that rank's blocks before their first put
    (the straggler fixture of ``all_reduce``)."""
    kind, kernel, site = _KERNELS[method]
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=True)
    m_per = x0.shape[0] // n
    cols = x0[0].numel()
    cnt = m_per * cols
    half = (m_per // 2 if kind == 2 else m_per) * cols
    out = torch.empty((n, m_per, *x0.shape[1:]), dtype=x0.dtype,
                      device=ctx.device)
    outs = [out[r] for r in range(n)]
    blocks = scatter_grid(kind, x0.dtype, n, cnt * x0.element_size(),
                          blocks_per_rank)
    ws = ctx.workspace(site, (n if kind == 0 else n - 1, cnt), x0.dtype)
    fs = site_flags(ctx, site, scatter_flags(kind, n, blocks))
    kernel(kind, ck.DTYPE_CODES[x0.dtype], rank_ptrs(xs), rank_ptrs(outs),
           ws.table.data_ptr(), fs.flags.table.data_ptr(), n, cnt, half,
           next_epoch(fs), int(blocks), lag[0], lag[1], ck.stream_ptr(x0))
    return outs


def auto_method(nbytes: int) -> ReduceScatterMethod:
    """The JAX AUTO on the device (:332-342) for ``nbytes`` of partials a
    rank."""
    if nbytes <= _RS_ONE_SHOT_MAX_BYTES:
        return ReduceScatterMethod.ONE_SHOT
    if nbytes <= _RS_RING_MAX_BYTES:
        return ReduceScatterMethod.PALLAS_BIDIR_RING
    return ReduceScatterMethod.PALLAS_RING_HBM


def reduce_scatter(xs: list[torch.Tensor], ctx,
                   method: ReduceScatterMethod = ReduceScatterMethod.AUTO,
                   *, lag: tuple = (-1, 0)) -> list[torch.Tensor]:
    """Sum the ranks' ``xs[r] [n * m_per, ...]`` and scatter the rows:
    rank r gets the reduced chunk r. Takes and returns one tensor per
    rank; ``lag`` is the straggler fixture's (rank, ns), for the ring
    kernels on the card."""
    check_ranks("x", xs, ctx)
    n = ctx.tp
    if n == 1:
        return list(xs)
    if method == ReduceScatterMethod.AUTO:
        method = (auto_method(xs[0].numel() * xs[0].element_size())
                  if device_initiable(ctx) else ReduceScatterMethod.XLA)
    if method == ReduceScatterMethod.XLA:
        return reduce_scatter_one_shot_plain(xs)
    if xs[0].dim() < 2:
        raise ValueError("the reduce-scatter kernels need >= 2-D input")
    if xs[0].shape[0] % n:
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by tp={n}")
    m_per = xs[0].shape[0] // n
    if method == ReduceScatterMethod.PALLAS_BIDIR_RING and (
            m_per < 2 or m_per % 2 or n <= 2):
        method = ReduceScatterMethod.PALLAS_RING  # :409-414
    if not device_initiable(ctx):
        if method == ReduceScatterMethod.ONE_SHOT:
            return reduce_scatter_one_shot_plain(xs)
        half = (m_per // 2 if method == ReduceScatterMethod.PALLAS_BIDIR_RING
                else None)
        return reduce_scatter_ring_plain(xs, half)
    return reduce_scatter_kernel(method, xs, ctx, lag=lag)
