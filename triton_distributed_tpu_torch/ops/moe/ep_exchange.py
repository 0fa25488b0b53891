"""The expert-parallel exchange of packed rows, and the row codec.

Counterpart of ``triton_distributed_tpu/ops/moe/ep_exchange.py``:
``ep_exchange`` (:181), ``pack_rows`` (:262), ``unpack_row`` (:277),
``_to_u8`` / ``_from_u8`` and ``EP_BLOCK_ROWS``. Segment ``p`` of rank
``me``'s ``[n, C, R]`` uint8 rows goes to segment ``me`` of rank ``p``;
only the first ``splits[p]`` rows move, and the receiver holds
``recv_counts[s]`` valid rows in segment ``s``. Rows past a count are not
written (the JAX contract, :32-33): callers mask by count, as
``ep_a2a`` does.

On the card the hand-written kernel (``csrc/all_to_all.cu``,
``ep_exchange``) replaces ``_ep_exchange_kernel`` (:81). It reads
``splits`` and ``recv_counts`` from the device, as the TPU kernel
scalar-prefetches them: no host read of a count, so a MoE layer adds no
sync. The JAX kernel moves 32-row blocks (``EP_BLOCK_ROWS``); the card
moves the exact rows, so that constant has no counterpart.
The JAX straggler arguments become ``straggler_rank`` /
``straggle_nanos``, a lag argument of the launch. On the CPU the plain
version (:func:`ep_exchange_plain`) writes POISON bytes (0xFF: NaN in
every float view, -1 as an int32) into every row past a source's count,
so a caller that forgets the mask shows NaN.

Packed rows are byte-identical to JAX's: the parts' little-endian bytes
in order (payload, then f32 scale, then int32 expert id), zero-padded to
a multiple of 128 bytes.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives._launch import lag
from triton_distributed_tpu_torch.ops.collectives.all_to_all import (
    exchange_blocks,
)
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)

ROW_ALIGN = 128
POISON = 0xFF


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Bitcast any-dtype ``[..., d]`` to uint8 ``[..., d * itemsize]``."""
    if x.dtype == torch.uint8:
        return x
    return x.contiguous().view(torch.uint8)


def _from_u8(u8: torch.Tensor, dtype: torch.dtype, d: int) -> torch.Tensor:
    """Inverse of :func:`_to_u8` for the leading ``d * itemsize`` bytes."""
    it = torch.empty((), dtype=dtype).element_size()
    return u8[..., :d * it].contiguous().view(dtype)


def pack_rows(parts: list[torch.Tensor]) -> tuple[torch.Tensor, list[int]]:
    """Pack per-row arrays (same leading shape) into 128-byte-aligned
    uint8 rows. Returns ``(rows_u8, byte_offsets)``: the start of each
    part, for :func:`unpack_row`."""
    chunks = [_to_u8(p) for p in parts]
    offsets, off = [], 0
    for ch in chunks:
        offsets.append(off)
        off += ch.shape[-1]
    pad = (-off) % ROW_ALIGN
    if pad:
        chunks.append(torch.zeros((*chunks[0].shape[:-1], pad),
                                  dtype=torch.uint8,
                                  device=chunks[0].device))
    return torch.cat(chunks, dim=-1), offsets


def unpack_row(rows_u8: torch.Tensor, offset: int, dtype: torch.dtype,
               d: int) -> torch.Tensor:
    """Slice one packed part back out (see :func:`pack_rows`)."""
    it = torch.empty((), dtype=dtype).element_size()
    return _from_u8(rows_u8[..., offset:offset + d * it], dtype, d)


def _valid_rows(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """``[n, cap]`` bool: row i of segment s is below ``counts[s]``."""
    rows = torch.arange(cap, device=counts.device, dtype=torch.int32)
    return rows[None, :] < counts.to(torch.int32)[:, None]


def ep_exchange_plain(rows: list[torch.Tensor], splits: list[torch.Tensor]
                      ) -> list[torch.Tensor]:
    """Rank p's ``[n, C, R]``: segment s is rows ``[0, splits[s][p])`` of
    rank s's segment p, POISON past that count (no host read)."""
    n, c, r = rows[0].shape
    outs = []
    for p in range(n):
        seg = torch.stack([rows[s][p] for s in range(n)])      # [n, C, R]
        cnt = torch.stack([splits[s][p] for s in range(n)])    # [n]
        keep = _valid_rows(cnt, c)[..., None]
        outs.append(torch.where(keep, seg, torch.full_like(seg, POISON)))
    return outs


def ep_exchange_kernel(rows, splits, recv_counts, ctx, *,
                       straggler_rank: int | None = None,
                       straggle_nanos: int = 0,
                       out: list[torch.Tensor] | None = None
                       ) -> list[torch.Tensor]:
    """One cooperative launch of the EP exchange over all ranks. ``out``
    (one ``[n, C, R]`` uint8 tensor a rank) receives the rows; fresh
    ones by default. Rows past a count keep what ``out`` held."""
    n = ctx.tp
    _, c, r = rows[0].shape
    for i in range(n):
        ck.check_cuda_operand(f"rows[{i}]", rows[i], ctx.device, torch.uint8,
                              3)
        for name, t in (("splits", splits[i]),
                        ("recv_counts", recv_counts[i])):
            ck.check_cuda_operand(f"{name}[{i}]", t, ctx.device, torch.int32,
                                  1)
            if t.shape[0] != n:
                raise ValueError(f"{name}[{i}] has {t.shape[0]} entries for "
                                 f"n={n}")
    if out is None:
        buf = torch.empty((n, n, c, r), dtype=torch.uint8, device=ctx.device)
        out = [buf[i] for i in range(n)]
    else:
        check_ranks("out", out, ctx, torch.uint8)
        for i, t in enumerate(out):
            ck.check_cuda_operand(f"out[{i}]", t, ctx.device, torch.uint8, 3)
    blocks = exchange_blocks(1, n, n * c * r)
    # The barrier, one flag a (source, block), and the lag's start flags.
    fs = site_flags(ctx, "ep_exchange", n + 2 * n * blocks)
    lag_rank, lag_ns = lag(straggler_rank, straggle_nanos)
    ck.EP_EXCHANGE(rank_ptrs(rows), rank_ptrs(out), rank_ptrs(splits),
                   rank_ptrs(recv_counts), fs.flags.table.data_ptr(), n, c, r,
                   next_epoch(fs), blocks, lag_rank, lag_ns,
                   ck.stream_ptr(rows[0]))
    return out


def ep_exchange(rows: list[torch.Tensor], splits: list[torch.Tensor],
                recv_counts: list[torch.Tensor], ctx, *,
                straggler_rank: int | None = None,
                straggle_nanos: int = 0) -> list[torch.Tensor]:
    """The push all-to-all of packed uint8 rows: ``rows[me] [n, C, R]``
    (R a multiple of 128), ``splits[me] [n]`` int32 rows really sent to
    each rank (<= C), ``recv_counts[me] [n]`` int32 rows each rank sends
    here. Returns one ``[n, C, R]`` a rank whose segment ``s`` holds
    ``recv_counts[s]`` valid rows; the rest must be masked."""
    check_ranks("rows", rows, ctx)
    if rows[0].dtype != torch.uint8:
        raise ValueError(f"ep_exchange moves packed uint8 rows, got "
                         f"{rows[0].dtype}")
    if rows[0].dim() != 3 or rows[0].shape[0] != ctx.tp:
        raise ValueError(f"rows must be [n={ctx.tp}, C, R], got "
                         f"{tuple(rows[0].shape)}")
    if rows[0].shape[2] % ROW_ALIGN:
        raise ValueError(f"packed row width {rows[0].shape[2]} must be "
                         f"lane-aligned ({ROW_ALIGN})")
    if not device_initiable(ctx):
        return ep_exchange_plain(rows, splits)
    return ep_exchange_kernel(rows, splits, recv_counts, ctx,
                              straggler_rank=straggler_rank,
                              straggle_nanos=straggle_nanos)
