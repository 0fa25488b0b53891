"""Ring MoE: the token chunks and their partial outputs circulate.

Counterpart of ``triton_distributed_tpu/ops/moe/ring_moe.py``
(``moe_ffn_ring``): the tensor-parallel MoE FFN with the activations kept
sequence-sharded. Each rank holds a column shard of every expert; a
(token chunk, f32 accumulator) pair visits every rank, each adding its
partial over its columns, and after n hops the accumulator is home with
every rank's contribution. JAX moves the pairs with ``lax.ppermute`` (an
XLA collective, no Pallas kernel); here a hop is a rotation of the
per-rank lists: rank i's pair goes to rank i + 1.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.moe.grouped_gemm import grouped_ffn
from triton_distributed_tpu_torch.ops.moe.routing import (
    moe_combine,
    moe_sort,
    router_topk,
)


def _contribution(tok: torch.Tensor, w_router, w1, w2, k: int,
                  norm_topk_prob: bool) -> torch.Tensor:
    """One rank's partial FFN output for a token chunk (over its column
    shard), rounded to the chunk's dtype."""
    route = router_topk(tok, w_router, k, norm_topk_prob=norm_topk_prob)
    st = moe_sort(route, w_router.shape[1])
    out_rows = grouped_ffn(tok[st.token_ids.long()], w1, w2, st.group_sizes)
    return moe_combine(out_rows, st, tok.shape[0])


def _hop(vals: list) -> list:
    """The ppermute i -> i + 1: rank r receives rank r - 1's value."""
    return vals[-1:] + vals[:-1]


def moe_ffn_ring(xs, w_router, w1, w2, k: int, *,
                 norm_topk_prob: bool = True) -> list[torch.Tensor]:
    """``xs[r] [t_loc, d]`` rank r's token chunk, ``w_router[r] [d, E]``
    (rank r's copy of the router), ``w1[r] [E, d, 2 f_loc]`` (gate | up
    column shard) and ``w2[r] [E, f_loc, d]``: ``[t_loc, d]`` a rank, the
    full FFN of its own tokens."""
    n = len(xs)

    def contrib(r, tok):
        return _contribution(tok, w_router[r], w1[r], w2[r], k,
                             norm_topk_prob).to(torch.float32)

    tok = list(xs)
    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
           for x in xs]
    # n - 1 full hops (tokens and accumulator), then a last local
    # contribution and an accumulator-only hop home.
    for _ in range(n - 1):
        acc = [a + contrib(r, t) for r, (a, t) in enumerate(zip(acc, tok))]
        tok, acc = _hop(tok), _hop(acc)
    acc = [a + contrib(r, t) for r, (a, t) in enumerate(zip(acc, tok))]
    return [a.to(x.dtype) for a, x in zip(_hop(acc), xs)]
