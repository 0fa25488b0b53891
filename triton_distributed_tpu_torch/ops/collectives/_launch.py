"""The shared launch of the collectives of ``csrc/collectives.cu``: operand
checks, the co-resident grid, the site's flags and symmetric workspace."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck

# Families of tdt_collective_capacity.
ALL_GATHER, REDUCE_SCATTER, ALL_REDUCE = 0, 1, 2
# Bytes a block moves, about: small messages take few blocks.
BLOCK_BYTES = 64 << 10
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
           work_bytes: int, blocks_per_rank: int | None = None) -> int:
    """The grid a rank takes: ~BLOCK_BYTES of ``work_bytes`` a block, at
    most what stays co-resident over n ranks (an explicit
    ``blocks_per_rank`` is passed on as it is; a grid that cannot be
    co-resident is refused by the launch)."""
    if blocks_per_rank is not None:
        return int(blocks_per_rank)
    want = max(1, -(-int(work_bytes) // BLOCK_BYTES))
    return max(1, min(want, capacity(family, kind, dtype) // n, MAX_BLOCKS))


def check_operands(name: str, xs, ctx, elementwise: bool) -> None:
    """Every rank's tensor on the context's device, contiguous and 16-byte
    aligned; the element kernels also need a dtype they take and rows
    (leading-dim slices) of whole 16-byte vectors."""
    x0 = xs[0]
    for r, t in enumerate(xs):
        ck.check_cuda_operand(f"{name}[{r}]", t, ctx.device, x0.dtype)
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
