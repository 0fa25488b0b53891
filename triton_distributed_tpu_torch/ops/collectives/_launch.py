"""The shared launch of the collectives of ``csrc/collectives.cu``: operand
checks, the co-resident grid, the site's flags and symmetric workspace."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.common import rank_ptrs

# Families of tdt_collective_capacity.
ALL_GATHER, REDUCE_SCATTER, ALL_REDUCE, MOVE, LOW_LATENCY = 0, 1, 2, 3, 4
# Kinds of tdt_move_launch (family MOVE).
SHIFT, BROADCAST, PULL, TORUS = 0, 1, 2, 3
# Bytes a block moves, about: small messages take few blocks.
BLOCK_BYTES = 64 << 10
# The block of the kernels that flag one sub-piece a warp (8 a block): the
# ring all-gathers and reduce-scatters (~2 KB a warp and hop, so a hop is a
# few round trips of a warp's loads), the one-shot reduce-scatter, the
# doubling all-reduce and the low-latency gather.
RING_BLOCK_BYTES = 16 << 10
RING_WARPS = 8  # csrc/collectives.cu kRingWarps
MAX_BLOCKS = 132
_capacity: dict = {}


def capacity(family: int, kind: int, dtype: torch.dtype) -> int:
    """Blocks of the kernel that can be co-resident on the card (the most
    one cooperative launch takes)."""
    key = (family, kind, dtype)
    if key not in _capacity:
        _capacity[key] = ck.coresident_blocks(
            "collectives", "tdt_collective_capacity", family, kind,
            ck.DTYPE_CODES.get(dtype, 0))
    return _capacity[key]


def blocks(family: int, kind: int, dtype: torch.dtype, n: int,
           work_bytes: int, blocks_per_rank: int | None = None,
           block_bytes: int = BLOCK_BYTES) -> int:
    """The grid a rank takes: ~``block_bytes`` of ``work_bytes`` a block,
    at most what stays co-resident over n ranks (an explicit
    ``blocks_per_rank`` is passed on as it is; a grid that cannot be
    co-resident is refused by the launch)."""
    if blocks_per_rank is not None:
        return int(blocks_per_rank)
    want = max(1, -(-int(work_bytes) // int(block_bytes)))
    return max(1, min(want, capacity(family, kind, dtype) // n, MAX_BLOCKS))


def check_operands(name: str, xs, ctx, elementwise: bool) -> None:
    """One tensor a rank, all of rank 0's shape (the kernels move rank 0's
    byte count from every rank), on the context's device, contiguous and
    16-byte aligned; the element kernels also need a dtype they take and
    rows (leading-dim slices) of whole 16-byte vectors."""
    if len(xs) != ctx.tp:
        raise ValueError(f"{name}: {len(xs)} tensors for tp={ctx.tp}")
    x0 = xs[0]
    for r, t in enumerate(xs):
        ck.check_cuda_operand(f"{name}[{r}]", t, ctx.device, x0.dtype)
        if t.shape != x0.shape:
            raise ValueError(f"{name}[{r}] is {tuple(t.shape)}; rank 0's is "
                             f"{tuple(x0.shape)}")
    if not elementwise:
        return
    if x0.dtype not in ck.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x0.dtype} not supported")
    if x0.dim() < 2:
        raise ValueError(f"{name}: the kernels take >= 2-D rows, got "
                         f"{tuple(x0.shape)}")
    row_bytes = x0[0].numel() * x0.element_size()
    if row_bytes % 16:
        raise ValueError(
            f"{name}: rows of {row_bytes} bytes; the kernels move whole "
            "16-byte vectors")


def lag(straggler_rank: int | None, straggler_nanos: int) -> tuple:
    """The lag arguments of a launch: (rank, ns), rank -1 for none."""
    if straggler_rank is None or not straggler_nanos:
        return -1, 0
    return int(straggler_rank), int(straggler_nanos)


def outputs(name: str, shape, dtype, ctx, out=None) -> list[torch.Tensor]:
    """One output of ``shape`` per rank: views of one fresh allocation, or
    the caller's ``out`` (checked: a test pre-fills it, say with NaN, to
    show that the kernel writes every byte)."""
    n = ctx.tp
    if out is None:
        buf = torch.empty((n, *shape), dtype=dtype, device=ctx.device)
        return [buf[r] for r in range(n)]
    if len(out) != n:
        raise ValueError(f"{name}: {len(out)} outputs for tp={n}")
    for r, t in enumerate(out):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}[{r}] is {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        ck.check_cuda_operand(f"{name}[{r}]", t, ctx.device)
    return list(out)


def move(kernel, kind: int, site: str, xs, outs, ctx, arg: int,
         flags_per_block: int, work_bytes: int,
         blocks_per_rank: int | None = None, min_blocks: int = 1) -> list:
    """One cooperative launch of a byte mover of ``tdt_move_launch`` over
    the context's ranks: ``kind``'s kernel, its argument, the site's
    flags (``n`` for the barrier plus ``flags_per_block`` a block) and a
    grid of ~BLOCK_BYTES of ``work_bytes`` a block, at least
    ``min_blocks`` (an explicit ``blocks_per_rank`` is passed on as it
    is)."""
    n = ctx.tp
    x0 = xs[0]
    g = blocks(MOVE, kind, x0.dtype, n, work_bytes, blocks_per_rank)
    if blocks_per_rank is None:
        g = max(g, min_blocks)
    fs = site_flags(ctx, site, n + flags_per_block * g)
    kernel(kind, rank_ptrs(xs), rank_ptrs(outs), fs.flags.table.data_ptr(),
           n, x0.numel() * x0.element_size(), int(arg), next_epoch(fs),
           int(g), ck.stream_ptr(x0))
    return outs
