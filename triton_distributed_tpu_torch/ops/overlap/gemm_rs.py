"""GEMM + ReduceScatter over co-located ranks: the TP prefill o-proj / FC2.

Counterpart of ``triton_distributed_tpu/ops/overlap/gemm_rs.py``:
``GemmRSConfig``, ``create_gemm_rs_context`` (:94-113, with the bidir
halving of ``tile_m``) and ``gemm_rs``. On the card it is the
hand-written ring kernel of ``csrc/overlap.cu`` (replacing
``_gemm_rs_kernel`` :116); on the CPU its plain version
:func:`gemm_rs_plain`, which follows the same ring order.

The ring: at step s rank ``me`` computes its partial of chunk
``(me-1-s) mod n`` (the clockwise ring; with ``bidir`` the chunk's rows
from ``half_m = (num_i // 2) * tile_m`` on ride the counter-clockwise
ring, chunk ``(me+1+s) mod n``, ``a_chunk`` :171), adds the sum that
arrived from its neighbour, rounds to the wire dtype and forwards it;
step n-1 yields its own chunk. So chunk c sums its partials in the
order c+1, c+2, ..., c (counter-clockwise rows: c-1, c-2, ..., c), each
hop rounded: at bf16 that is a different function from a sum in rank
order.

The options of JAX's config: ``wire_dtype`` (:61-75) rounds each hop's
sum to the wire dtype and only the last step to the input dtype (JAX's
``separate_final``); the kernel takes ``float8_e4m3fn``, ``bfloat16``
and the input dtype itself. An e4m3 hop gives NaN where the rounded sum
passes +-448 (|x| > 464), as the JAX cast gives under ``ml_dtypes``:
torch's own cast saturates, so :func:`round_to_wire` masks the overflow.
``force_kernel`` (:85) runs the ring at n = 1: step 0 is the last step,
the product rounded once (:293-297).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    matmul_f32,
    pick_stage_tile,
)
from triton_distributed_tpu_torch.ops.overlap import _launch

# e4m3's largest finite value, and the magnitude past which a value rounds
# (to nearest even) beyond it: the tie at 464 rounds down to 448.
E4M3_MAX = 448.0
E4M3_OVERFLOW = 464.0
# The wire dtypes of a narrow ring (the kernel's W builds).
NARROW_WIRES = (torch.float8_e4m3fn, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class GemmRSConfig:
    """The ring's shape: ``tile_m`` (None → the whole ``m_per``) and
    ``bidir`` set the split between the two rings (:func:`ring_split`).
    ``wire_dtype``: the dtype of each hop's payload (None: the input
    dtype). ``force_kernel``: run the ring at n = 1 too. JAX's ``tile_n``
    and ``acc_dtype`` have no counterpart: the kernel's column tile is
    fixed and it accumulates in f32."""

    tile_m: int | None = None
    bidir: bool = True
    wire_dtype: torch.dtype | None = None
    force_kernel: bool = False


_RS_STAGE_BUDGET = 8 * 1024 * 1024


def create_gemm_rs_context(m: int, k_loc: int, dtype=torch.bfloat16,
                           n_ranks: int = 8, bidir: bool = True
                           ) -> GemmRSConfig:
    itemsize = torch.empty((), dtype=dtype).element_size()
    m_per = max(m // max(n_ranks, 1), 1)
    tile_m = pick_stage_tile(m_per, k_loc * itemsize, _RS_STAGE_BUDGET)
    if bidir and tile_m == m_per and m_per % 2 == 0 and m_per >= 16:
        tile_m //= 2
    return GemmRSConfig(tile_m=max(tile_m, 1), bidir=bidir)


def ring_split(m_per: int, config: GemmRSConfig) -> int:
    """``half_m``: the chunk rows below it ride the clockwise ring, the
    rest the counter-clockwise one (``m_per`` for the single ring). The
    bidirectional ring needs an even row-tile count, as in JAX."""
    tile_m = min(config.tile_m or m_per, m_per)
    if m_per % tile_m:
        raise ValueError(f"m_per={m_per} not divisible by tile_m={tile_m}")
    num_i = m_per // tile_m
    if config.bidir and num_i % 2 == 0 and num_i >= 2:
        return (num_i // 2) * tile_m
    return m_per


def round_to_wire(x: torch.Tensor, wire: torch.dtype) -> torch.Tensor:
    """``x`` (f32) rounded to ``wire`` to nearest even, back in f32. e4m3
    gives NaN where the rounded value passes +-448 (|x| > 464) or x is
    NaN, as ``ml_dtypes`` (and so the JAX reference) does."""
    if wire != torch.float8_e4m3fn:
        return x.to(wire).to(torch.float32)
    y = x.clamp(-E4M3_MAX, E4M3_MAX).to(wire).to(torch.float32)
    return torch.where(x.abs() <= E4M3_OVERFLOW, y,
                       torch.full_like(y, float("nan")))


def check_wire(wire: torch.dtype | None, dtype: torch.dtype) -> None:
    """The wire dtypes the ring takes: the input dtype, or a narrower one
    of :data:`NARROW_WIRES`."""
    if wire in (None, dtype):
        return
    if wire not in NARROW_WIRES or wire.itemsize >= dtype.itemsize:
        raise NotImplementedError(
            f"gemm_rs wire_dtype={wire} over {dtype} inputs is not ported: "
            "the ring takes float8_e4m3fn, bfloat16 (over float32 inputs) "
            "or the input dtype (ROADMAP queue 2 row 8)")


def gemm_rs_plain(a: list[torch.Tensor], b: list[torch.Tensor],
                  half_m: int | None = None,
                  wire_dtype: torch.dtype | None = None
                  ) -> list[torch.Tensor]:
    """The plain version, in the ring's order: chunk c's rows below
    ``half_m`` sum the partials of ranks c+1, c+2, ..., c, the rest of
    ranks c-1, c-2, ..., c; each partial in f32, each hop's sum rounded
    to the wire dtype (None: the input dtype), the last one to the input
    dtype. Returns rank r's chunk ``[M/n, N]`` per rank."""
    n = len(a)
    m = a[0].shape[0]
    m_per = m // n
    half_m = m_per if half_m is None else half_m
    dt = a[0].dtype
    wire = wire_dtype or dt
    outs = []
    for c in range(n):
        parts = []
        for rows, step in ((slice(0, half_m), 1), (slice(half_m, m_per), -1)):
            if rows.start >= rows.stop:
                continue
            acc = None
            for s in range(n):
                r = (c + step * (1 + s)) % n
                p = matmul_f32(a[r][c * m_per + rows.start:
                                    c * m_per + rows.stop], b[r])
                acc = p if acc is None else p + acc
                acc = (acc.to(dt).to(torch.float32) if s == n - 1
                       else round_to_wire(acc, wire))
            parts.append(acc.to(dt))
        outs.append(torch.cat(parts, dim=0))
    return outs


def plan(n: int, m_per: int, n_out: int, dtype: torch.dtype
         ) -> tuple[int, int]:
    """(tiles a step, flags a rank) of a ring launch: the barrier's n,
    then one a tile of each ring direction's forwarding steps."""
    _, tiles = _launch.tiles("gemm_rs", dtype, m_per, n_out)
    return tiles, n + 2 * (n - 1) * tiles


def gemm_rs_ring(a, b, ctx, half_m: int, blocks_per_rank: int | None = None,
                 wire_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """The ring kernel: one cooperative launch over all ranks (at n = 1
    the one-rank ring), each hop on ``wire_dtype`` (None: the input
    dtype)."""
    _launch.check_operands("gemm_rs", ctx, a, b)
    check_wire(wire_dtype, a[0].dtype)
    n = ctx.tp
    m, k = a[0].shape
    n_out = b[0].shape[1]
    m_per = m // n
    wire = None if n == 1 or wire_dtype == a[0].dtype else wire_dtype
    kernel = (ck.GEMM_RS_N1 if n == 1 else
              ck.GEMM_RS_WIRE_E4M3 if wire == torch.float8_e4m3fn else
              ck.GEMM_RS_WIRE_BF16 if wire == torch.bfloat16 else ck.GEMM_RS)
    tiles, flags = plan(n, m_per, n_out, a[0].dtype)
    out = torch.empty((n, m_per, n_out), dtype=a[0].dtype, device=ctx.device)
    outs = [out[r] for r in range(n)]
    # n = 1 exchanges nothing: a token workspace.
    ws_shape = (n - 1, m_per, n_out) if n > 1 else (1, 1, 8)
    _launch.launch(kernel, "gemm_rs", ctx, a, b, outs, ws_shape, m_per,
                   tiles, flags, (m, n_out, k, half_m),
                   blocks_per_rank, wire=wire)
    return outs


def gemm_rs(a: list[torch.Tensor], b: list[torch.Tensor], ctx,
            config: GemmRSConfig | None = None) -> list[torch.Tensor]:
    """``reduce_scatter(a[r] @ b[r])``: ``a[r] [M, k_loc]`` (column
    shard), ``b[r] [k_loc, N]`` (row shard) → rank r's reduced row chunk
    ``[M/n, N]``. At n == 1 it is the plain product, as in JAX."""
    check_ranks("a", a, ctx, ndim=2)
    check_ranks("b", b, ctx, dtype=a[0].dtype, ndim=2)
    n = ctx.tp
    m, k_loc = a[0].shape
    if m % n:
        raise ValueError(f"M={m} not divisible by tp={n}")
    config = config or create_gemm_rs_context(m, k_loc, a[0].dtype,
                                              n_ranks=n)
    check_wire(config.wire_dtype, a[0].dtype)
    if n == 1 and not config.force_kernel:
        return [a[0] @ b[0]]
    half_m = ring_split(m // n, config)
    if not device_initiable(ctx):
        return gemm_rs_plain(a, b, half_m, config.wire_dtype)
    return gemm_rs_ring(a, b, ctx, half_m, wire_dtype=config.wire_dtype)


def gemm_rs_op(a: torch.Tensor, b: torch.Tensor, ctx,
               config: GemmRSConfig | None = None) -> torch.Tensor:
    """Host-level wrapper: ``a [M, K]`` split by columns over the ranks,
    ``b [K, N]`` by rows; returns the summed ``[M, N]`` (the ranks'
    chunks in order)."""
    return torch.cat(gemm_rs(ctx.shard(a, 1), ctx.shard(b, 0), ctx, config))
