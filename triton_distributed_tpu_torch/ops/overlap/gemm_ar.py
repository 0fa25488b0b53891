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
``XLA`` is the plain version, the counterpart of ``psum(a @ b)``:
per-rank products rounded to the input dtype, summed in rank order in
f32.

AUTO on the card: ONE_SHOT up to 512 KB of output, as in JAX (:252-264);
above it TWO_SHOT when ``m % n == 0``, else ONE_SHOT. JAX takes XLA above
``VMEM_COMM_MAX_BYTES`` (4 MB) and when ``m % n != 0``, because its
kernels stage in VMEM; the CUDA kernels have no such limit, and on the
card a kernel never hands over to the plain version. On the CPU AUTO
takes XLA, as the JAX AUTO does off the TPU. JAX's ``GemmARConfig`` and
``create_gemm_ar_context`` (``tile_n``, ``acc_dtype``) have no
counterpart: the kernel's tile is fixed and it accumulates in f32.
``trace=True`` (the ONE_SHOT device ring) is not ported (ROADMAP queue 2
row 7).
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    AllGatherMethod,
    all_gather,
)
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
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


def gemm_ar_one_shot(a, b, ctx, blocks_per_rank: int | None = None
                     ) -> list[torch.Tensor]:
    """The one-shot kernel: one cooperative launch over all ranks."""
    _launch.check_operands("gemm_ar", ctx, a, b)
    n = ctx.tp
    m, k = a[0].shape
    n_out = b[0].shape[1]
    bm = _launch.tile_rows(m)
    tiles = -(-m // bm) * -(-n_out // _launch.BN)
    out = torch.empty((n, m, n_out), dtype=a[0].dtype, device=ctx.device)
    outs = [out[r] for r in range(n)]
    _launch.launch("gemm_ar", ctx, a, b, outs, (n, m, n_out), m, tiles,
                   n + n * tiles, (m, n_out, k, 0), blocks_per_rank)
    return outs


def gemm_ar(a: list[torch.Tensor], b: list[torch.Tensor], ctx,
            method: GemmARMethod = GemmARMethod.AUTO,
            trace: bool = False) -> list[torch.Tensor]:
    """``psum(a[r] @ b[r])`` on every rank: ``a[r] [M, k_loc]`` (column
    shard), ``b[r] [k_loc, N]`` (row shard) → one ``[M, N]`` per rank.
    At n == 1 it is the plain product, as in JAX."""
    if trace:
        raise NotImplementedError(
            "gemm_ar(trace=True), the one-shot kernel's device ring, is "
            "not ported yet (ROADMAP queue 2 row 7)")
    check_ranks("a", a, ctx, ndim=2)
    check_ranks("b", b, ctx, dtype=a[0].dtype, ndim=2)
    n = ctx.tp
    m = a[0].shape[0]
    if n == 1:
        return [a[0] @ b[0]]
    if method == GemmARMethod.AUTO:
        out_bytes = m * b[0].shape[1] * a[0].element_size()
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
               method: GemmARMethod = GemmARMethod.AUTO) -> torch.Tensor:
    """Host-level wrapper: ``a [M, K]`` split by columns over the ranks,
    ``b [K, N]`` by rows; returns the summed ``[M, N]`` (rank 0's copy;
    every rank holds the same)."""
    return gemm_ar(ctx.shard(a, 1), ctx.shard(b, 0), ctx, method)[0]
