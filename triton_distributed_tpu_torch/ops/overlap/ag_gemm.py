"""AllGather + GEMM over co-located ranks: the TP prefill QKV / FC1.

Counterpart of ``triton_distributed_tpu/ops/overlap/ag_gemm.py``:
``AGGemmConfig`` and ``ag_gemm`` (:298). On
the card it is the hand-written kernel of ``csrc/overlap.cu`` (replacing
``_ag_gemm_kernel`` :163): each rank puts its row chunk to every peer and
computes chunk ``(me + s) mod n`` at step s, its own first, writing rows
at their global position. Each output row is one dot product, so the
chunk order changes only when the rows are ready, never their values;
the JAX wrapper un-permutes its step-major rows, the kernel writes them
in place. The arrival-adaptive pick (``adaptive_pick`` :128) is not
ported (ROADMAP queue 2 row 9): the port keeps the ring order. JAX's
tile fields (``tile_n``, ``tile_m``, ``acc_dtype``) and
``create_ag_gemm_context`` have no counterpart: the kernel's tile is
fixed and it accumulates in f32.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
)
from triton_distributed_tpu_torch.ops.overlap import _launch


@dataclasses.dataclass(frozen=True)
class AGGemmConfig:
    """``adaptive``: JAX's arrival-adaptive chunk pick, refused until
    ported (ROADMAP queue 2 row 9)."""

    adaptive: bool | None = None


def ag_gemm_plain(a: list[torch.Tensor], b: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The plain version: every rank's ``cat(a) @ b[r]``, rounded to the
    input dtype."""
    full = torch.cat(a, dim=0)
    return [full @ w for w in b]


def ag_gemm_kernel(a, b, ctx, blocks_per_rank: int | None = None
                   ) -> list[torch.Tensor]:
    """The kernel: one cooperative launch over all ranks."""
    _launch.check_operands("ag_gemm", ctx, a, b)
    n = ctx.tp
    m_per, k = a[0].shape
    n_loc = b[0].shape[1]
    bm = _launch.tile_rows(m_per)
    tiles_m = -(-m_per // bm)
    tiles = tiles_m * -(-n_loc // _launch.BN)
    out = torch.empty((n, n * m_per, n_loc), dtype=a[0].dtype,
                      device=ctx.device)
    outs = [out[r] for r in range(n)]
    _launch.launch("ag_gemm", ctx, a, b, outs, (n, m_per, k), m_per, tiles,
                   n + n * tiles_m, (m_per, n_loc, k, 0), blocks_per_rank)
    return outs


def ag_gemm(a: list[torch.Tensor], b: list[torch.Tensor], ctx,
            config: AGGemmConfig | None = None) -> list[torch.Tensor]:
    """``all_gather(a) @ b[r]``: ``a[r] [m_per, K]`` (row shard),
    ``b[r] [K, n_loc]`` (column shard) → ``[n * m_per, n_loc]`` per rank,
    rows in global order."""
    check_ranks("a", a, ctx, ndim=2)
    check_ranks("b", b, ctx, dtype=a[0].dtype, ndim=2)
    if a[0].shape[1] != b[0].shape[0]:
        raise ValueError(
            f"K mismatch {tuple(a[0].shape)} @ {tuple(b[0].shape)}")
    config = config or AGGemmConfig()
    if config.adaptive:
        raise NotImplementedError(
            "ag_gemm's arrival-adaptive pick is not ported yet (ROADMAP "
            "queue 2 row 9); the port keeps ring order")
    if ctx.tp == 1:
        return [a[0] @ b[0]]
    if not device_initiable(ctx):
        return ag_gemm_plain(a, b)
    return ag_gemm_kernel(a, b, ctx)

