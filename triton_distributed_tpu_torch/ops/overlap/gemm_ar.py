"""GEMM + AllReduce over co-located ranks: the TP decode o-proj / FC2.

Counterpart of ``triton_distributed_tpu/ops/overlap/gemm_ar.py``
(:84-381): ``GemmARMethod``, ``gemm_ar`` and ``gemm_ar_op``. ``ONE_SHOT``
is the hand-written kernel of ``csrc/overlap.cu`` (replacing
``_gemm_ar_one_shot_kernel`` :84): each rank's partial rounded to the
input dtype, put to every rank's slot, summed in rank order in f32, so
every rank's output is bitwise the same. ``TWO_SHOT`` is ``gemm_rs``
(single ring: the chunk is one row tile) followed by ``all_gather``'s
AUTO (:279: the full mesh at n <= 2, the bidirectional ring above 64 KB
a shard at n > 2).
In bf16 the kernel multiplies on the tensor cores (mma.sync) and cuts
each 64-column tile's K into 512-row atoms, summed in atom order in f32 and
rounded once before the put (the traced build spreads the atoms over the
rank's blocks), so the result depends neither on the grid nor
on which build ran. f32 keeps the FMA tile.
``XLA`` is the plain version, the counterpart of ``psum(a @ b)``:
per-rank products rounded to the input dtype, summed in rank order in
f32.

AUTO on the card: ONE_SHOT up to 512 KB of output, as in JAX (:252-264);
above it TWO_SHOT when ``m % n == 0``, else ONE_SHOT. JAX takes XLA above
``VMEM_COMM_MAX_BYTES`` (4 MB) and when ``m % n != 0``, because its
kernels stage in VMEM; the CUDA kernels have no such limit, and on the
card a kernel never hands over to the plain version. On the CPU AUTO
takes XLA, as the JAX AUTO does off the TPU.

``trace=True`` (ONE_SHOT only, :84-199, :247-258) also returns each
rank's device ring ``[num_j+1, 3, 8]`` int32 in the megakernel tracer's
format, ``num_j = N / tile_n``: per iteration s a produce row (AR_SEND,
column group s), a reduce row (AR_WAIT, group s-1) and at s = num_j the
drain (BARRIER), stamped with JAX's logical ticks; decode it with
``obs.kernel_trace.decode_trace(strict=False)``. ``GemmARConfig``'s
``tile_n`` (JAX's default from ``create_gemm_ar_context``,
``pick_tile(N)``) sets the column group; on the card it must be a
multiple of the kernel's 64-column tile. JAX's ``acc_dtype`` has no
counterpart: the kernels accumulate in f32.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import torch

from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    AllGatherMethod,
    all_gather,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    pick_tile,
)
from triton_distributed_tpu_torch.ops.overlap import _launch
from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
    GemmRSConfig,
    gemm_rs,
)

_ONE_SHOT_MAX_BYTES = 512 * 1024


class GemmARMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"


# The ring's opcodes (megakernel/task.py TaskType) and record width.
_AR_SEND, _AR_WAIT, _BARRIER = 12, 13, 9
_TRACE_INTS = 8


@dataclasses.dataclass(frozen=True)
class GemmARConfig:
    """``tile_n``: the columns of one grid iteration of the traced
    ONE_SHOT (its ring has ``N / tile_n + 1`` iterations)."""

    tile_n: int = 512


def create_gemm_ar_context(m: int, n_out: int, k_loc: int,
                           dtype=torch.bfloat16,
                           tile_n: int | None = None) -> GemmARConfig:
    return GemmARConfig(tile_n=pick_tile(n_out) if tile_n is None
                        else tile_n)


def _num_j(n_out: int, config: GemmARConfig) -> int:
    tile_n = min(config.tile_n, n_out)
    if n_out % tile_n:
        raise ValueError(f"n_out={n_out} not divisible by tile_n={tile_n}")
    return n_out // tile_n


def gemm_ar_ring_plain(n: int, num_j: int) -> torch.Tensor:
    """The rings the traced ONE_SHOT writes, ``[n, num_j+1, 3, 8]`` int32:
    JAX's logical clock (0 at iteration 0, one tick a begin, mid and end)
    over the produce, reduce and drain rows in execution order; rows an
    iteration does not run stay zero (unwritten)."""
    ring = torch.zeros((n, num_j + 1, 3, _TRACE_INTS), dtype=torch.int32)
    for r in range(n):
        clk = 0
        for s in range(num_j + 1):
            if s < num_j:
                ring[r, s, 0] = torch.tensor(
                    [s, _AR_SEND, 0, s, clk + 1, clk + 3, clk + 2, 1])
                clk += 3
            if s > 0:
                ring[r, s, 1] = torch.tensor(
                    [s, _AR_WAIT, 0, s - 1, clk + 1, clk + 3, clk + 2, 1])
                clk += 3
            if s == num_j:
                ring[r, s, 2] = torch.tensor(
                    [s, _BARRIER, 0, 0, clk + 1, clk + 2, 0, 1])
                clk += 2
    return ring


def _sum_in_rank_order(parts: list[torch.Tensor]) -> torch.Tensor:
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(parts[0].dtype)


def gemm_ar_plain(a: list[torch.Tensor], b: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The plain version: each rank's ``a[r] @ b[r]`` rounded to the
    input dtype, summed over ranks in rank order in f32, rounded; one
    copy per rank."""
    out = _sum_in_rank_order([x @ w for x, w in zip(a, b)])
    return [out] + [out.clone() for _ in a[1:]]


@functools.lru_cache(maxsize=None)
def plan(n: int, m: int, n_out: int, k: int, dtype: torch.dtype,
         tile_n: int | None = None, blocks: int | None = None
         ) -> tuple[int, int, int, int]:
    """(work items a rank, blocks a rank, flags a rank, workspace elements
    a rank) of a one-shot launch; with ``tile_n``, the traced build's (its
    items are a column group's). ``blocks``: the caller's blocks a rank,
    else one an item and at most every co-resident one. f32 (the FMA
    tile): an item is a tile of 16 or 64 rows by 64 columns; flags: the
    barrier's n (traced: and the rank-local count's two words), then one a
    (source, tile); workspace: the n slots. bf16 (the split-K tile,
    ``overlap.cu`` gemm_ar_mma_kernel): K is cut into atoms of
    ``_launch.AR_ATOM`` rows. The untraced build's item is a whole tile,
    its atoms summed in one block's registers; the traced build's items
    are single atoms, so its iterations spread over the rank's blocks,
    with a flag a block and iteration before the put flags and the f32
    atom partials after the slots. Both sum a tile's atoms in atom order,
    so the traced outputs are bitwise the untraced ones, whatever the
    grid."""
    bm = _launch.tile_rows(m)
    tiles_m, tiles_n = -(-m // bm), -(-n_out // _launch.BN)
    tiles = tiles_m * tiles_n
    bf16 = dtype == torch.bfloat16
    atoms = -(-k // _launch.AR_ATOM) if bf16 else 1
    items = tiles_m * (tile_n // _launch.BN) * atoms if tile_n else tiles
    if blocks is None:
        kind = "gemm_ar_traced" if tile_n else "gemm_ar"
        blocks = _launch.grid(items, _launch.capacity(
            kind, dtype, m <= _launch.SMALL_M), n)
    if not tile_n:
        return items, blocks, n + n * tiles, n * m * n_out
    if not bf16:
        return items, blocks, n + 2 + n * tiles, n * m * n_out
    return (items, blocks, n + 2 + (n_out // tile_n) * blocks + n * tiles,
            n * m * n_out + 2 * atoms * tiles * bm * _launch.BN)


def gemm_ar_one_shot(a, b, ctx, blocks_per_rank: int | None = None
                     ) -> list[torch.Tensor]:
    """The one-shot kernel: one cooperative launch over all ranks."""
    _launch.check_operands("gemm_ar", ctx, a, b)
    n = ctx.tp
    m, k = a[0].shape
    n_out = b[0].shape[1]
    dt = a[0].dtype
    items, blocks, flags, ws = plan(n, m, n_out, k, dt,
                                    blocks=blocks_per_rank)
    out = torch.empty((n, m, n_out), dtype=dt, device=ctx.device)
    outs = [out[r] for r in range(n)]
    _launch.launch(ck.GEMM_AR, "gemm_ar", ctx, a, b, outs, (ws,), m, items,
                   flags, (m, n_out, k, 0), blocks)
    return outs


def gemm_ar_traced(a, b, ctx, tile_n: int,
                   blocks_per_rank: int | None = None) -> tuple:
    """The traced one-shot kernel: one cooperative launch over all ranks
    in ``N / tile_n + 1`` iterations. Returns (per-rank outputs, rings
    ``[n, num_j+1, 3, 8]`` int32)."""
    _launch.check_operands("gemm_ar", ctx, a, b)
    n = ctx.tp
    m, k = a[0].shape
    n_out = b[0].shape[1]
    if tile_n % _launch.BN or n_out % tile_n:
        raise ValueError(
            f"gemm_ar trace: tile_n={tile_n} must be a multiple of "
            f"{_launch.BN} dividing N={n_out}")
    num_j = n_out // tile_n
    dt = a[0].dtype
    # A group's items (tiles_m x tile_n / 64 tiles, bf16: by K atoms) are
    # the blocks' work in each iteration; the grid and the flag layout
    # take the one block count.
    items, blocks, flags, ws = plan(n, m, n_out, k, dt, tile_n,
                                    blocks_per_rank)
    out = torch.empty((n, m, n_out), dtype=dt, device=ctx.device)
    outs = [out[r] for r in range(n)]
    ring = torch.zeros((n, num_j + 1, 3, _TRACE_INTS), dtype=torch.int32,
                       device=ctx.device)
    _launch.launch(ck.GEMM_AR_TRACED, "gemm_ar_traced", ctx, a, b, outs,
                   (ws,), m, items, flags, (m, n_out, k, 0), blocks,
                   aux=[ring[r] for r in range(n)], arg=tile_n)
    return outs, ring


def gemm_ar(a: list[torch.Tensor], b: list[torch.Tensor], ctx,
            method: GemmARMethod = GemmARMethod.AUTO,
            trace: bool = False, config: GemmARConfig | None = None):
    """``psum(a[r] @ b[r])`` on every rank: ``a[r] [M, k_loc]`` (column
    shard), ``b[r] [k_loc, N]`` (row shard) → one ``[M, N]`` per rank.
    At n == 1 it is the plain product, as in JAX. ``trace=True``
    (``method=ONE_SHOT`` only) returns ``(outputs, rings [n, num_j+1, 3,
    8])``; at n == 1 the ring is all zeros (no kernel ran)."""
    check_ranks("a", a, ctx, ndim=2)
    check_ranks("b", b, ctx, dtype=a[0].dtype, ndim=2)
    n = ctx.tp
    m, k_loc = a[0].shape
    n_out = b[0].shape[1]
    config = config or create_gemm_ar_context(m, n_out, k_loc, a[0].dtype)
    if trace and method is not GemmARMethod.ONE_SHOT:
        raise ValueError(
            "trace=True requires method=ONE_SHOT (the ring rides the fused "
            "kernel; XLA/TWO_SHOT paths have no device ring)")
    if n == 1:
        out = [a[0] @ b[0]]
        if trace:
            return out, torch.zeros((1, _num_j(n_out, config) + 1, 3,
                                     _TRACE_INTS), dtype=torch.int32,
                                    device=ctx.device)
        return out
    if trace:
        num_j = _num_j(n_out, config)
        if not device_initiable(ctx):
            return gemm_ar_plain(a, b), gemm_ar_ring_plain(n, num_j)
        return gemm_ar_traced(a, b, ctx, n_out // num_j)
    if method == GemmARMethod.AUTO:
        out_bytes = m * n_out * a[0].element_size()
        if not device_initiable(ctx):
            method = GemmARMethod.XLA
        elif out_bytes > _ONE_SHOT_MAX_BYTES and m % n == 0:
            method = GemmARMethod.TWO_SHOT
        else:
            method = GemmARMethod.ONE_SHOT
    if method == GemmARMethod.XLA:
        return gemm_ar_plain(a, b)
    if method == GemmARMethod.TWO_SHOT:
        reduced = gemm_rs(a, b, ctx, config=GemmRSConfig())
        return all_gather(reduced, ctx, AllGatherMethod.AUTO)
    if not device_initiable(ctx):
        return gemm_ar_plain(a, b)
    return gemm_ar_one_shot(a, b, ctx)


def gemm_ar_op(a: torch.Tensor, b: torch.Tensor, ctx,
               method: GemmARMethod = GemmARMethod.AUTO,
               config: GemmARConfig | None = None, trace: bool = False):
    """Host-level wrapper: ``a [M, K]`` split by columns over the ranks,
    ``b [K, N]`` by rows; returns the summed ``[M, N]`` (rank 0's copy;
    every rank holds the same), and with ``trace=True`` the per-rank
    rings ``[n, num_j+1, 3, 8]`` beside it."""
    got = gemm_ar(ctx.shard(a, 1), ctx.shard(b, 0), ctx, method,
                  trace=trace, config=config)
    if trace:
        return got[0][0], got[1]
    return got[0]
