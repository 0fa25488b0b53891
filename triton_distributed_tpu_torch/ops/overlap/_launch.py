"""The shared launch of the GEMM+collective kernels
(``csrc/overlap.cu``): tile geometry, the co-resident grid, the site's
symmetric workspace and flags, one cooperative launch."""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.common import rank_ptrs

# The kernels' tiles (overlap.cu): the FMA tile, 64 columns of 16 rows
# when the GEMM has at most SMALL_M (decode), else 64; the bf16 builds of
# ag_gemm and gemm_rs above SMALL_M rows take the wgmma tile, WG_BM x WG_BN.
BN = 64
WG_BM = WG_BN = 128
SMALL_M = 16
WGMMA_KINDS = ("gemm_rs", "ag_gemm", "ag_gemm_adaptive")
# ag_gemm's put row tile (overlap.cu kPutRows): a chunk is put, and flagged,
# 16 rows at a time whatever the GEMM tile.
PUT_ROWS = 16
# gemm_ar's bf16 build (overlap.cu kArAtom): K in atoms of AR_ATOM rows,
# whatever the grid.
AR_ATOM = 512
# overlap.cu `Kind`: the three kernels and the builds of their options
# (the adaptive ag_gemm, the traced gemm_ar).
KINDS = {"gemm_ar": 0, "gemm_rs": 1, "ag_gemm": 2, "ag_gemm_adaptive": 3,
         "gemm_ar_traced": 4}
_capacity: dict = {}


def tile_rows(m: int) -> int:
    return SMALL_M if m <= SMALL_M else 64


def tile(kind: str, dtype: torch.dtype, m: int) -> tuple[int, int]:
    """The (rows, columns) tile of ``kind``'s build at ``dtype`` for a GEMM
    of ``m`` rows."""
    if kind in WGMMA_KINDS and dtype == torch.bfloat16 and m > SMALL_M:
        return WG_BM, WG_BN
    return tile_rows(m), BN


def tiles(kind: str, dtype: torch.dtype, m: int, n_out: int
          ) -> tuple[int, int]:
    """(row tiles, tiles) of ``kind``'s GEMM of ``m`` rows by ``n_out``
    columns: a step's work items."""
    bm, bn = tile(kind, dtype, m)
    tiles_m = -(-m // bm)
    return tiles_m, tiles_m * -(-n_out // bn)


def grid(tiles_: int, capacity_: int, n: int) -> int:
    """Blocks a rank: at most one a tile, and at most what stays
    co-resident for the n ranks of the launch."""
    return max(1, min(tiles_, capacity_ // n))


def capacity(kind: str, dtype: torch.dtype, small: bool,
             wire: torch.dtype | None = None) -> int:
    key = (kind, dtype, small, wire)
    if key not in _capacity:
        _capacity[key] = ck.coresident_blocks(
            "overlap", "tdt_overlap_capacity", KINDS[kind],
            ck.DTYPE_CODES[dtype], int(small),
            ck.WIRE_CODES[wire or dtype])
    return _capacity[key]


def check_operands(kind, ctx, a, b):
    """Device, dtype, contiguity and the kernels' 16-byte vectors: K and
    N multiples of 8 (an e4m3 wire is read and written 4 elements at a
    time, so its rows need no more)."""
    dt = a[0].dtype
    if dt not in ck.DTYPE_CODES:
        raise ValueError(f"{kind}: dtype {dt} not supported")
    for r in range(ctx.tp):
        ck.check_cuda_operand(f"a[{r}]", a[r], ctx.device, dt, 2)
        ck.check_cuda_operand(f"b[{r}]", b[r], ctx.device, dt, 2)
    k, n_out = b[0].shape
    if k % 8 or n_out % 8 or a[0].shape[1] % 8:
        raise ValueError(
            f"{kind}: K={k} and N={n_out} must be multiples of 8 (16-byte "
            "vectors)")


def launch(kernel, kind: str, ctx, a, b, outs, ws_shape, m_tile: int,
           tiles: int, flags: int, dims: tuple,
           blocks_per_rank: int | None = None, *, wire=None, aux=None,
           arg: int = 0, lag: tuple = (-1, 0), delay_ns: int = 0) -> None:
    """One cooperative launch of ``kind`` over the context's ranks,
    counted on ``kernel`` (a :class:`~triton_distributed_tpu_torch.ops.
    cuda_kernels.CudaKernel`). ``m_tile`` is the GEMM's row count that
    picks the tile (M, m_per or the chunk), ``tiles`` the work items a
    rank's blocks share (the grid takes at most that many, and at most
    what stays co-resident), ``flags`` the flags a rank needs, ``dims``
    (M, N, K, half_m). ``wire``: gemm_rs's wire dtype (the workspace's;
    None: the input dtype). ``aux``: per-rank int32 outputs of the option
    builds; ``arg``: the traced gemm_ar's tile_n; ``lag`` (rank, ns) and
    ``delay_ns``: ag_gemm's lag fixtures. Each kind keeps its own
    workspace and flags (the site), so the builds of one kernel never
    read each other's flags."""
    n = ctx.tp
    dt = a[0].dtype
    small = m_tile <= SMALL_M
    if blocks_per_rank is None:
        blocks_per_rank = grid(tiles, capacity(kind, dt, small, wire), n)
    ws = ctx.workspace(kind, ws_shape, wire or dt)
    fs = site_flags(ctx, kind, flags)
    M, N, K, half_m = dims
    kernel(
        KINDS[kind], ck.DTYPE_CODES[dt], int(small),
        ck.WIRE_CODES[wire or dt], rank_ptrs(a), rank_ptrs(b),
        rank_ptrs(outs), None if aux is None else rank_ptrs(aux),
        ws.table.data_ptr(), fs.flags.table.data_ptr(), n, int(M), int(N),
        int(K), int(half_m), int(arg), next_epoch(fs), int(lag[0]),
        int(lag[1]), int(delay_ns), int(blocks_per_rank),
        ck.stream_ptr(a[0]))
