"""AllReduce over co-located ranks.

Counterpart of ``triton_distributed_tpu/ops/collectives/all_reduce.py``:
``AllReduceMethod``, ``get_auto_allreduce_method`` (:68-75) and
``all_reduce`` (:176). The hand-written kernels of ``csrc/collectives.cu``:

- ``ONE_SHOT`` (``_one_shot_kernel`` :78): every rank puts its copy into
  every peer's slot, then sums the n copies in f32 in rank order and
  rounds once, so every rank's output is bitwise the same;
- ``DOUBLING`` (``_doubling_kernel`` :113, n a power of two): log2 n
  rounds; in round k a rank sends its running f32 sum rounded to the
  dtype to partner ``me ^ 2^k`` and adds the partner's rounded value to
  its own unrounded sum (:138-146), so at n = 4 the ranks may differ by
  an ulp. On the card each warp runs the rounds for its own sub-piece on
  its own device-scope flags, its running sum in registers, over a grid
  of ~``_launch.RING_BLOCK_BYTES`` of x a block (:func:`reduce_grid`);
- ``TWO_SHOT`` (:249-275): ``reduce_scatter`` (BIDIR_RING up to 4 MB,
  else RING_HBM) then ``all_gather`` (BIDIR_RING); both legs demote to
  their single rings at n <= 2.

``XLA`` is the plain psum: the copies summed in f32 in rank order, rounded
once. The lagging-rank fixture ``_straggle_entry`` (:151), an identity
``pallas_call`` in which one rank lags, has no launch of its own: on one
stream a separate launch cannot skew a later launch's entry, so
``straggler_rank``/``straggler_nanos`` go into the launch of the
one-shot and doubling kernels and of TWO_SHOT's reduce-scatter leg, whose
lagging rank's blocks spin before their first put.

AUTO is the JAX dispatch, with one difference on the card: TWO_SHOT over
rows that do not split n ways takes the ONE_SHOT kernel at every size,
where JAX hands payloads over 256 KB to ``psum`` (:251-260) because its
one-shot stages n copies in VMEM; the card has no such limit (ROADMAP
queue 3 item 2). On the CPU AUTO takes ``XLA``, as the JAX AUTO does off
the TPU, and a kernel method takes its plain version.
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
from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    AllGatherMethod,
    all_gather,
)
from triton_distributed_tpu_torch.ops.collectives.reduce_scatter import (
    ReduceScatterMethod,
    reduce_scatter,
)
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)

_ONE_SHOT_MAX_BYTES = 256 * 1024
_DOUBLING_MAX_BYTES = 1024 * 1024
# The JAX package's VMEM_COMM_MAX_BYTES: TWO_SHOT's reduce-scatter leg
# takes the HBM-slot ring above it.
_TWO_SHOT_RING_MAX_BYTES = 4 * 1024 * 1024


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    DOUBLING = "doubling"


# Kernel of each method: (C kind, launch counter, site).
_KERNELS = {
    AllReduceMethod.ONE_SHOT: (0, ck.ALL_REDUCE_ONE_SHOT,
                               "all_reduce_one_shot"),
    AllReduceMethod.DOUBLING: (1, ck.ALL_REDUCE_DOUBLING,
                               "all_reduce_doubling"),
}


def get_auto_allreduce_method(nbytes: int, n: int) -> AllReduceMethod:
    if nbytes <= _ONE_SHOT_MAX_BYTES:
        return AllReduceMethod.ONE_SHOT
    if nbytes <= _DOUBLING_MAX_BYTES and n & (n - 1) == 0:
        return AllReduceMethod.DOUBLING
    return AllReduceMethod.TWO_SHOT


def all_reduce_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The copies summed in f32 in rank order, rounded once; one copy per
    rank (ONE_SHOT, and the XLA method)."""
    acc = xs[0].to(torch.float32)
    for x in xs[1:]:
        acc = acc + x.to(torch.float32)
    out = acc.to(xs[0].dtype)
    return [out] + [out.clone() for _ in xs[1:]]


def all_reduce_doubling_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The butterfly: in round k every rank adds partner ``r ^ 2^k``'s
    running sum rounded to the dtype to its own f32 sum."""
    n = len(xs)
    if n & (n - 1):
        raise ValueError(f"DOUBLING needs a power-of-two rank count, got {n}")
    accs = [x.to(torch.float32) for x in xs]
    k = 1
    while k < n:
        sent = [a.to(xs[0].dtype) for a in accs]
        accs = [a + sent[r ^ k].to(torch.float32)
                for r, a in enumerate(accs)]
        k *= 2
    return [a.to(xs[0].dtype) for a in accs]


def reduce_flags(kind: int, n: int, blocks: int) -> int:
    """Flags a rank of an all-reduce launch of C ``kind`` over ``blocks`` a
    rank: the barrier's ``n``, then the one-shot's one a (source, block),
    or the doubling's one a (round, block, warp): each block's piece is
    ``RING_WARPS`` flagged sub-pieces."""
    if kind == 0:
        return n + n * blocks
    return n + (n.bit_length() - 1) * blocks * _launch.RING_WARPS


def reduce_grid(kind: int, dtype: torch.dtype, n: int, nbytes: int,
                blocks_per_rank: int | None = None) -> int:
    """Blocks a rank of C ``kind`` (``_launch.blocks``): ~BLOCK_BYTES of x a
    block for the one-shot, ~RING_BLOCK_BYTES for the doubling."""
    return _launch.blocks(
        _launch.ALL_REDUCE, kind, dtype, n, nbytes, blocks_per_rank,
        _launch.BLOCK_BYTES if kind == 0 else _launch.RING_BLOCK_BYTES)


def all_reduce_kernel(method: AllReduceMethod, xs, ctx, *,
                      blocks_per_rank: int | None = None,
                      lag: tuple = (-1, 0)) -> list[torch.Tensor]:
    """One cooperative launch of the ONE_SHOT or DOUBLING kernel."""
    kind, kernel, site = _KERNELS[method]
    n = ctx.tp
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=True)
    numel = x0.numel()
    out = torch.empty((n, *x0.shape), dtype=x0.dtype, device=ctx.device)
    outs = [out[r] for r in range(n)]
    blocks = reduce_grid(kind, x0.dtype, n, numel * x0.element_size(),
                         blocks_per_rank)
    slots = n if kind == 0 else n.bit_length() - 1
    ws = ctx.workspace(site, (slots, numel), x0.dtype)
    fs = site_flags(ctx, site, reduce_flags(kind, n, blocks))
    kernel(kind, ck.DTYPE_CODES[x0.dtype], rank_ptrs(xs), rank_ptrs(outs),
           ws.table.data_ptr(), fs.flags.table.data_ptr(), n, numel,
           next_epoch(fs), int(blocks), lag[0], lag[1], ck.stream_ptr(x0))
    return outs


def all_reduce(xs: list[torch.Tensor], ctx,
               method: AllReduceMethod = AllReduceMethod.AUTO, *,
               straggler_rank: int | None = None,
               straggler_nanos: int = 500_000) -> list[torch.Tensor]:
    """Sum the ranks' ``xs[r]``; every rank gets the sum. Takes and
    returns one tensor per rank. ``straggler_rank`` lags that rank's
    puts by ``straggler_nanos`` on the card (the stress fixture)."""
    check_ranks("x", xs, ctx)
    n = ctx.tp
    if n == 1:
        return list(xs)
    x0 = xs[0]
    nbytes = x0.numel() * x0.element_size()
    if method == AllReduceMethod.AUTO:
        method = (get_auto_allreduce_method(nbytes, n)
                  if device_initiable(ctx) and x0.dim() >= 2
                  else AllReduceMethod.XLA)
    if method == AllReduceMethod.XLA:
        return all_reduce_plain(xs)
    if x0.dim() < 2:
        raise ValueError("the all-reduce kernels need >= 2-D input")
    if method == AllReduceMethod.DOUBLING and n & (n - 1):
        raise ValueError(f"DOUBLING needs a power-of-two rank count, got {n}")
    if method == AllReduceMethod.TWO_SHOT and x0.shape[0] % n:
        method = AllReduceMethod.ONE_SHOT  # :251-260 (see the module doc)
    lag = _launch.lag(straggler_rank, straggler_nanos)
    if method == AllReduceMethod.TWO_SHOT:
        rs = (ReduceScatterMethod.PALLAS_BIDIR_RING
              if nbytes <= _TWO_SHOT_RING_MAX_BYTES
              else ReduceScatterMethod.PALLAS_RING_HBM)
        reduced = reduce_scatter(xs, ctx, rs, lag=lag)
        return all_gather(reduced, ctx, AllGatherMethod.PALLAS_BIDIR_RING)
    if not device_initiable(ctx):
        return (all_reduce_plain(xs) if method == AllReduceMethod.ONE_SHOT
                else all_reduce_doubling_plain(xs))
    return all_reduce_kernel(method, xs, ctx, lag=lag)
