"""SwiGLU MLP, tensor-parallel over co-located ranks.

Counterpart of ``triton_distributed_tpu/layers/tp_mlp.py``: the four
modes of ``tp_mlp_fwd`` (:56-95). At tp=1 (one parameter dict, one
tensor) every mode is two plain GEMMs around an f32 SiLU·mul. At tp=n
the caller passes one parameter shard and one activation per rank:

- ``pallas``: ``x`` is each rank's sequence shard ``[m_per, d]``;
  ``ag_gemm`` (FC1) → SiLU·mul → ``gemm_rs`` (FC2) returns the sequence
  shard (the hand-written kernels on the card);
- ``xla``: the same with plain torch collectives: all-gather (a
  concatenation), the GEMMs, a psum-scatter of the f32 partials;
- ``pallas_ar`` / ``xla_ar``: ``x`` is each rank's copy of the
  replicated ``[m, d]``; local GEMMs, then ``gemm_ar`` (AUTO) or the
  plain psum of the rounded partials: every rank gets its own copy.

Parameters are a dict ``{"w1": [d, 2*ff_loc] (gate_loc | up_loc),
"w2": [ff_loc, d]}`` per rank (at tp=1 ``ff_loc = ff``). The helpers
below are the collective seams both layers share.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_distributed_tpu_torch.ops.common import matmul_f32
from triton_distributed_tpu_torch.ops.overlap import (
    GemmARMethod,
    ag_gemm,
    ag_gemm_plain,
    gemm_ar,
    gemm_rs,
)

MODES = ("xla", "xla_ar", "pallas", "pallas_ar")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")


def ranked(params, x):
    """``(per-rank params, per-rank activations, single)``: a dict and a
    tensor are the one rank of tp=1, lists are one entry per rank."""
    if isinstance(x, torch.Tensor):
        return [params], [x], True
    return list(params), list(x), False


def unranked(vals: list, single: bool):
    return vals[0] if single else vals


def _silu_mul(h: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(h, 2, dim=-1)
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(h.dtype)


def reduce_ar(a: list, b: list, mode: str, ctx) -> list:
    """The row-parallel GEMM of a replicated layout, summed over ranks:
    ``gemm_ar`` in the pallas modes, the plain psum of the rounded
    partials in the xla modes (the JAX ``psum(part.astype(dtype))``).
    One rank: the plain product."""
    if len(a) == 1:
        return [a[0] @ b[0]]
    method = GemmARMethod.AUTO if mode.startswith("pallas") \
        else GemmARMethod.XLA
    return gemm_ar(a, b, ctx, method=method)


def gather_gemm(x: list, w: list, mode: str, ctx) -> list:
    """All-gather of the row-sharded activations times each rank's
    column shard: ``ag_gemm`` (pallas) or a concatenation and a GEMM
    (xla)."""
    if len(x) == 1:
        return [x[0] @ w[0]]
    if mode == "pallas":
        return ag_gemm(x, w, ctx)
    return ag_gemm_plain(x, w)


def gemm_scatter(a: list, b: list, mode: str, ctx) -> list:
    """Row-parallel GEMM reduce-scattered over the rows: ``gemm_rs``
    (pallas) or the f32 partials summed and split, rounded once (xla:
    ``psum_scatter`` of the f32 ``dot``)."""
    if len(a) == 1:
        return [a[0] @ b[0]]
    if mode == "pallas":
        return gemm_rs(a, b, ctx)
    total = matmul_f32(a[0], b[0])
    for x, w in zip(a[1:], b[1:]):
        total = total + matmul_f32(x, w)
    return [c.to(a[0].dtype) for c in torch.chunk(total, len(a), dim=0)]


def tp_mlp_fwd(params, x, *, mode: str = "xla", ctx=None):
    """``down(silu(x @ gate) * (x @ up))`` for ``x [M, d]`` (tp=1) or one
    activation per rank (tp=n; see the module doc for each mode's
    layout). Each GEMM accumulates in f32 and rounds to ``x.dtype``."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    w1 = [p["w1"] for p in ps]
    w2 = [p["w2"] for p in ps]
    if mode in ("xla", "pallas"):
        h = [_silu_mul(t) for t in gather_gemm(xs, w1, mode, ctx)]
        return unranked(gemm_scatter(h, w2, mode, ctx), single)
    h = [_silu_mul(t @ w) for t, w in zip(xs, w1)]
    return unranked(reduce_ar(h, w2, mode, ctx), single)
