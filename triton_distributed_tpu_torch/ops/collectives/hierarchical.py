"""Two-level collectives over a ``dp x tp`` context.

Counterpart of ``triton_distributed_tpu/ops/collectives/hierarchical.py``:
``all_gather_2d`` (:40), ``reduce_scatter_2d`` (:60), ``all_reduce_2level``
(:81), ``all_gather_2d_op`` (:99) and ``all_reduce_2level_op`` (:119).
The JAX package stages the inner (ICI) level through its Pallas kernels
and the outer (DCN) level through XLA collectives, and writes no kernel of
its own here; neither does the port. The inner stage runs the port's tp
collectives in each dp group (``ctx.group(d)``: the kernels on the card,
picked by their AUTO unless ``inner_method`` says otherwise); the outer
stage is plain torch across the groups: a concatenation in dp order, or a
sum folded in dp order.

Every function takes and returns one tensor per global rank ``d * tp +
t`` (dp-major, the JAX mesh's ``outer * n_in + inner``).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    AllGatherMethod,
    all_gather,
)
from triton_distributed_tpu_torch.ops.collectives.reduce_scatter import (
    ReduceScatterMethod,
    reduce_scatter,
)


def _groups(name: str, xs, ctx) -> list[list[torch.Tensor]]:
    """``xs`` (one tensor per global rank) split by dp group."""
    if len(xs) != ctx.world:
        raise ValueError(f"{name}: {len(xs)} tensors for dp x tp = "
                         f"{ctx.world}")
    tp = ctx.tp
    return [list(xs[d * tp:(d + 1) * tp]) for d in range(ctx.dp)]


def _fold(parts: list[torch.Tensor]) -> torch.Tensor:
    """The outer sum: the groups' values added in dp order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def all_gather_2d(xs: list[torch.Tensor], ctx, *,
                  inner_method: AllGatherMethod = AllGatherMethod.AUTO
                  ) -> list[torch.Tensor]:
    """Two-stage all-gather: rank ``(d, t)``'s ``[m_per, ...]`` shard of an
    array laid out dp-major; every rank gets the whole ``[dp * tp * m_per,
    ...]``. Stage 1 gathers inside each dp group, stage 2 concatenates
    the groups' gathers in dp order."""
    ys = [all_gather(g, ctx.group(d), inner_method)
          for d, g in enumerate(_groups("x", xs, ctx))]
    return [torch.cat([ys[e][t] for e in range(ctx.dp)])
            for _ in range(ctx.dp) for t in range(ctx.tp)]


def reduce_scatter_2d(xs: list[torch.Tensor], ctx, *,
                      inner_method: ReduceScatterMethod =
                      ReduceScatterMethod.AUTO) -> list[torch.Tensor]:
    """Two-stage reduce-scatter: every rank's ``[M, ...]`` summed over both
    axes; rank ``(d, t)`` gets chunk ``t * dp + d`` of ``M / (dp * tp)``
    rows (inner-major, as in JAX). Stage 1 reduce-scatters inside each dp
    group, stage 2 sums chunk t over the groups in dp order and splits it
    dp ways."""
    ys = [reduce_scatter(g, ctx.group(d), inner_method)
          for d, g in enumerate(_groups("x", xs, ctx))]
    dp = ctx.dp
    if ys[0][0].shape[0] % dp:
        raise ValueError(f"rows {ys[0][0].shape[0]} a tp chunk not "
                         f"divisible by dp={dp}")
    parts = [torch.chunk(_fold([ys[d][t] for d in range(dp)]), dp)
             for t in range(ctx.tp)]
    return [parts[t][d].contiguous() for d in range(dp)
            for t in range(ctx.tp)]


def all_reduce_2level(xs: list[torch.Tensor], ctx) -> list[torch.Tensor]:
    """Two-level all-reduce: reduce-scatter inside each dp group (AUTO),
    the chunks summed over the groups in dp order, then all-gathered
    inside each group (AUTO). Every rank gets the sum."""
    groups = _groups("x", xs, ctx)
    ys = [reduce_scatter(g, ctx.group(d), ReduceScatterMethod.AUTO)
          for d, g in enumerate(groups)]
    z = [_fold([ys[d][t] for d in range(ctx.dp)]) for t in range(ctx.tp)]
    out = []
    for d in range(ctx.dp):
        out += all_gather(z, ctx.group(d), AllGatherMethod.AUTO)
    return out


def all_gather_2d_op(x: torch.Tensor, ctx) -> torch.Tensor:
    """Host-level form: ``x [dp * tp * m_per, ...]`` sharded dp-major over
    the ranks; returns ``[dp * tp, dp * tp * m_per, ...]`` (row r = rank
    r's copy)."""
    if x.shape[0] % ctx.world:
        raise ValueError(f"rows {x.shape[0]} not divisible by dp x tp = "
                         f"{ctx.world}")
    xs = [c.to(ctx.device).contiguous()
          for c in torch.chunk(x, ctx.world, dim=0)]
    return torch.stack(all_gather_2d(xs, ctx))


def all_reduce_2level_op(x: torch.Tensor, ctx) -> torch.Tensor:
    """Host-level form: ``x [dp * tp, ...]`` (row r = rank r's addend);
    returns ``[dp * tp, ...]`` (row r = rank r's sum)."""
    if x.shape[0] != ctx.world:
        raise ValueError(f"leading dim {x.shape[0]} != dp x tp = "
                         f"{ctx.world}")
    xs = [x[r].to(ctx.device).contiguous() for r in range(ctx.world)]
    return torch.stack(all_reduce_2level(xs, ctx))
