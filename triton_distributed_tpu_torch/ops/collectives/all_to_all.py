"""AllToAll over co-located ranks: the dense equal-chunk exchange.

Counterpart of ``triton_distributed_tpu/ops/collectives/all_to_all.py``:
``all_to_all`` (:65) and ``all_to_all_op`` (:102). Chunk ``i`` of rank
``me``'s ``[n * m_per, ...]`` lands at rank ``i``'s chunk ``me``. The
plain version (:func:`all_to_all_plain`) is the chunk transpose of the
per-rank list; the hand-written kernel (:func:`all_to_all_kernel`,
``csrc/all_to_all.cu``) replaces ``_a2a_kernel`` (:35): it moves bytes
only, so it is bitwise the plain version.

``method``: ``"pallas"`` the kernel, ``"xla"`` the plain version,
``"auto"`` the kernel on the card at every size (the JAX AUTO hands
payloads over ``VMEM_COMM_MAX_BYTES`` to XLA only because its kernel is
VMEM-resident; the card has no such ceiling) and the plain version on
the CPU. A kernel method on the CPU takes the plain version.
"""

from __future__ import annotations

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

METHODS = ("auto", "xla", "pallas")
_capacity: dict = {}


def exchange_blocks(counts: int, n: int, work_bytes: int) -> int:
    """The grid a rank takes in the exchange kernels of
    ``csrc/all_to_all.cu`` (``counts`` 0 dense, 1 EP): ~64 KB of
    ``work_bytes`` a block, at most what stays co-resident over n ranks."""
    if counts not in _capacity:
        _capacity[counts] = ck.coresident_blocks(
            "all_to_all", "tdt_all_to_all_capacity", counts)
    want = max(1, -(-int(work_bytes) // _launch.BLOCK_BYTES))
    return max(1, min(want, _capacity[counts] // n, _launch.MAX_BLOCKS))


def all_to_all_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Rank p's ``[n * m_per, ...]``: chunk p of every rank, in rank
    order."""
    n = len(xs)
    chunks = [torch.chunk(x, n, dim=0) for x in xs]
    return [torch.cat([chunks[r][p] for r in range(n)]) for p in range(n)]


def all_to_all_kernel(xs: list[torch.Tensor], ctx) -> list[torch.Tensor]:
    """One cooperative launch of the exchange kernel over all ranks."""
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    out = torch.empty((n, *x0.shape), dtype=x0.dtype, device=ctx.device)
    outs = [out[r] for r in range(n)]
    chunk_bytes = x0.numel() * x0.element_size() // n
    blocks = exchange_blocks(0, n, n * chunk_bytes)
    fs = site_flags(ctx, "all_to_all", n + n * blocks)
    ck.ALL_TO_ALL(rank_ptrs(xs), rank_ptrs(outs), fs.flags.table.data_ptr(),
                  n, chunk_bytes, next_epoch(fs), blocks, ck.stream_ptr(x0))
    return outs


def all_to_all(xs: list[torch.Tensor], ctx, method: str = "auto"
               ) -> list[torch.Tensor]:
    """Exchange equal chunks: row-chunk ``i`` of rank ``me``'s ``xs[me]
    [n * m_per, ...]`` lands at rank ``i``'s row-chunk ``me``. Takes and
    returns one tensor per rank."""
    if method not in METHODS:
        raise ValueError(f"unknown all_to_all method {method!r}; {METHODS}")
    check_ranks("x", xs, ctx)
    n = ctx.tp
    if n == 1:
        return list(xs)
    if xs[0].shape[0] % n:
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by axis size "
                         f"{n}")
    if method == "xla" or not device_initiable(ctx):
        return all_to_all_plain(xs)
    if xs[0].dim() < 2:
        raise ValueError("the all_to_all kernel needs >= 2-D input")
    return all_to_all_kernel(xs, ctx)


def all_to_all_op(x: torch.Tensor, ctx, method: str = "auto"
                  ) -> torch.Tensor:
    """Host-level form: ``x [n, n * m_per, ...]`` (row i = rank i's
    sends); returns ``[n, n * m_per, ...]`` (row i = rank i's receives)."""
    if x.shape[0] != ctx.tp:
        raise ValueError(f"leading dim {x.shape[0]} != tp={ctx.tp}")
    xs = [x[r].to(ctx.device).contiguous() for r in range(ctx.tp)]
    return torch.stack(all_to_all(xs, ctx, method))
