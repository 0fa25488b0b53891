"""MoE layer, tensor-parallel over co-located ranks.

Counterpart of ``triton_distributed_tpu/layers/tp_moe.py``: the four modes
of ``tp_moe_fwd`` (:45-97). Every rank holds its column shard of every
expert (``w1 [E, d, 2 f_loc]`` as ``[gate_loc | up_loc]``, ``w2 [E, f_loc,
d]``) and the replicated router; it routes all tokens, runs the grouped
SwiGLU over its columns and combines, giving a partial ``[T, d]`` that the
ranks sum. At tp=1 (one parameter dict, one tensor, or lists of one) no
collective runs, as in JAX over a one-device axis. At tp=n the caller
passes one parameter shard and one activation per rank, as
``layers/tp_mlp.py`` does:

- ``pallas``: ``x`` is each rank's sequence shard ``[t_loc, d]``:
  ``all_gather`` (AUTO) of the tokens, then ``reduce_scatter`` (AUTO) of
  the partials, the hand-written kernels on the card;
- ``xla``: the same with a concatenation and the JAX ``psum_scatter`` of
  the f32 partials (:92-94): summed in f32 in rank order, rounded once;
- ``pallas_ar``: ``x`` is each rank's copy of the replicated ``[T, d]``;
  ``all_reduce`` (AUTO) of the partials;
- ``xla_ar``: ``psum(part.astype(f32)).astype(dtype)`` (:96);
- ``ring``: ``x`` is each rank's sequence shard; the token chunks and
  their f32 partials circulate (``ops/moe/ring_moe.py``, :63-73).
"""

from __future__ import annotations

from typing import TypedDict

import torch

from triton_distributed_tpu_torch.layers.tp_mlp import ranked, unranked
from triton_distributed_tpu_torch.ops.collectives import (
    AllGatherMethod,
    all_gather,
    all_reduce,
    reduce_scatter,
)
from triton_distributed_tpu_torch.ops.moe.grouped_gemm import grouped_ffn
from triton_distributed_tpu_torch.ops.moe.ring_moe import moe_ffn_ring
from triton_distributed_tpu_torch.ops.moe.routing import (
    moe_combine,
    moe_sort,
    router_topk,
)

MODES = ("xla", "xla_ar", "pallas", "pallas_ar", "ring")


class TPMoEParams(TypedDict):
    """One MoE layer's parameters on one rank (the JAX ``TPMoEParams``
    shard); a model stacks each leaf over its layers."""

    w_router: torch.Tensor  # [d, E] replicated
    w1: torch.Tensor        # [E, d, 2 f_loc]  gate | up fused per expert
    w2: torch.Tensor        # [E, f_loc, d]


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown MoE mode {mode!r}; modes: {MODES}")


def moe_partial(params: TPMoEParams, x: torch.Tensor, k: int,
                norm_topk_prob: bool = True) -> torch.Tensor:
    """One rank's ``[T, d]`` in ``x``'s dtype: each token through its
    top-``k`` experts' SwiGLU over the rank's columns, weighted by its
    gate weights (at tp=1 the layer's output)."""
    route = router_topk(x, params["w_router"], k,
                        norm_topk_prob=norm_topk_prob)
    st = moe_sort(route, params["w1"].shape[0])
    h = grouped_ffn(x[st.token_ids.long()], params["w1"], params["w2"],
                    st.group_sizes)
    return moe_combine(h, st, x.shape[0])


def _psum_f32(parts: list[torch.Tensor]) -> torch.Tensor:
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc


def tp_moe_fwd(params, x, k: int, *, mode: str = "xla",
               norm_topk_prob: bool = True, ctx=None):
    """The routed-expert FFN of ``x [T, d]`` (tp=1) or of one activation
    per rank (tp=n; see the module doc for each mode's layout)."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    if len(xs) == 1:
        return unranked([moe_partial(ps[0], xs[0], k, norm_topk_prob)],
                        single)
    if mode == "ring":
        return moe_ffn_ring(xs, [p["w_router"] for p in ps],
                            [p["w1"] for p in ps], [p["w2"] for p in ps], k,
                            norm_topk_prob=norm_topk_prob)
    seq = mode in ("pallas", "xla")
    if seq:
        full = all_gather(xs, ctx, AllGatherMethod.AUTO if mode == "pallas"
                          else AllGatherMethod.XLA)
    else:
        full = xs
    parts = [moe_partial(p, t, k, norm_topk_prob) for p, t in zip(ps, full)]
    if mode == "pallas":
        return reduce_scatter(parts, ctx)
    if mode == "pallas_ar":
        return all_reduce(parts, ctx)
    total = _psum_f32(parts)
    dt = parts[0].dtype
    if mode == "xla":
        return [c.to(dt) for c in torch.chunk(total, len(parts), dim=0)]
    out = total.to(dt)
    return [out] + [out.clone() for _ in parts[1:]]
