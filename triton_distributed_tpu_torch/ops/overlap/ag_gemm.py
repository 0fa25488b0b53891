"""AllGather + GEMM over co-located ranks: the TP prefill QKV / FC1.

Counterpart of ``triton_distributed_tpu/ops/overlap/ag_gemm.py``:
``AGGemmConfig`` (:94-101), ``adaptive_pick`` (:128) and ``ag_gemm``
(:298). On the card it is the hand-written kernel of ``csrc/overlap.cu``
(replacing ``_ag_gemm_kernel`` :163): each rank puts its row chunk to
every peer and computes one chunk a step, its own first, writing rows at
their global position. Each output row is one dot product, so the chunk
order changes only when the rows are ready, never their values; the JAX
wrapper un-permutes its step-major rows by the realized order (:394), the
kernel writes them in place.

The order: ring order ``(me + s) mod n``, or with ``adaptive`` the
arrival-adaptive pick (:func:`adaptive_pick_plain` is its rule): at each
step boundary the first unprocessed chunk whose bytes have all landed,
else the first unprocessed one. ``adaptive=None`` resolves to on where
the kernels run (:func:`device_initiable`), as JAX resolves it to
``_on_tpu`` (:329-332); on the CPU the plain version computes every
chunk at once. JAX's tile fields (``tile_n``, ``tile_m``, ``acc_dtype``)
and ``create_ag_gemm_context`` have no counterpart: the kernel's tile is
fixed and it accumulates in f32.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives._launch import lag
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
)
from triton_distributed_tpu_torch.ops.overlap import _launch

# JAX's for_correctness delay (maybe_delay(200_000), ag_gemm.py:229).
FOR_CORRECTNESS_NS = 200_000


@dataclasses.dataclass(frozen=True)
class AGGemmConfig:
    """``adaptive``: the arrival-adaptive chunk pick (None: on where the
    kernels run). The race fixtures of JAX (:97-101): ``for_correctness``
    delays every rank's puts by 200 us; ``straggler_rank`` lags that rank
    ``straggler_nanos`` after the entry barrier, before its puts."""

    adaptive: bool | None = None
    for_correctness: bool = False
    straggler_rank: int | None = None
    straggler_nanos: int = 500_000


def resolve_adaptive(config: AGGemmConfig, ctx) -> bool:
    """The pick a call makes: ``config.adaptive``, or where it is None,
    on where the kernels run (JAX: on the TPU)."""
    if config.adaptive is None:
        return device_initiable(ctx)
    return bool(config.adaptive)


def adaptive_pick_plain(done, landed, me: int, n: int) -> int:
    """The host form of ``adaptive_pick``: the first chunk of ``me+1 ..
    me+n-1`` (mod n) that is not ``done`` and has ``landed``, else the
    first that is not ``done``. ``done`` and ``landed`` are indexable by
    chunk (truthy values)."""
    ready = first = -1
    for off in range(1, n):
        c = (me + off) % n
        if done[c]:
            continue
        if first < 0:
            first = c
        if ready < 0 and landed[c]:
            ready = c
    return ready if ready >= 0 else first


def ag_gemm_plain(a: list[torch.Tensor], b: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The plain version: every rank's ``cat(a) @ b[r]``, rounded to the
    input dtype."""
    full = torch.cat(a, dim=0)
    return [full @ w for w in b]


def plan(n: int, m_per: int, n_loc: int, dtype: torch.dtype
         ) -> tuple[int, int, int]:
    """(put row tiles, tiles a step, flags a rank) of a launch: the flags
    are the barrier's n, one a put row tile (``PUT_ROWS`` rows) of each
    source, and the adaptive build's claim word and publish flag of each
    step (the ring build's site is the same size)."""
    puts = -(-m_per // _launch.PUT_ROWS)
    _, tiles = _launch.tiles("ag_gemm", dtype, m_per, n_loc)
    return puts, tiles, n + n * puts + 2 * n


def ag_gemm_kernel(a, b, ctx, blocks_per_rank: int | None = None, *,
                   adaptive: bool = False,
                   straggler_rank: int | None = None,
                   straggler_nanos: int = 0,
                   for_correctness: bool = False) -> tuple:
    """One cooperative launch over all ranks, of the ring-order build or
    (``adaptive``) the arrival-adaptive one: (per-rank outputs, the
    realized order ``[n, n]`` int32, row r = the chunk rank r computed at
    each step)."""
    _launch.check_operands("ag_gemm", ctx, a, b)
    n = ctx.tp
    m_per, k = a[0].shape
    n_loc = b[0].shape[1]
    _, tiles, flags = plan(n, m_per, n_loc, a[0].dtype)
    out = torch.empty((n, n * m_per, n_loc), dtype=a[0].dtype,
                      device=ctx.device)
    outs = [out[r] for r in range(n)]
    order = torch.full((n, n), -1, dtype=torch.int32, device=ctx.device)
    kernel, kind = ((ck.AG_GEMM_ADAPTIVE, "ag_gemm_adaptive") if adaptive
                    else (ck.AG_GEMM, "ag_gemm"))
    _launch.launch(kernel, kind, ctx, a, b, outs, (n, m_per, k), m_per,
                   tiles, flags, (m_per, n_loc, k, 0),
                   blocks_per_rank, aux=[order[r] for r in range(n)],
                   lag=lag(straggler_rank, straggler_nanos),
                   delay_ns=FOR_CORRECTNESS_NS if for_correctness else 0)
    return outs, order


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
    if ctx.tp == 1:
        return [a[0] @ b[0]]
    if not device_initiable(ctx):
        return ag_gemm_plain(a, b)
    return ag_gemm_kernel(
        a, b, ctx, adaptive=resolve_adaptive(config, ctx),
        straggler_rank=config.straggler_rank,
        straggler_nanos=config.straggler_nanos,
        for_correctness=config.for_correctness)[0]
