"""MoE layer at tp=1.

Counterpart of ``triton_distributed_tpu/layers/tp_moe.py``: the
``xla``/``xla_ar`` branches of ``tp_moe_fwd`` (:45-97), which at tp=1
route, sort, run the grouped SwiGLU over every expert and combine, with
no collective (the all-gather, psum and psum-scatter run over a
one-device axis and drop out). The ``ring`` and ``pallas*`` modes use
the multi-rank MoE exchanges, which wait for the multi-GPU slice
(ROADMAP queue 1, item 11).
"""

from __future__ import annotations

from typing import TypedDict

import torch

from triton_distributed_tpu_torch.ops.moe.grouped_gemm import grouped_ffn
from triton_distributed_tpu_torch.ops.moe.routing import (
    moe_combine,
    moe_sort,
    router_topk,
)

MODES = ("xla", "xla_ar")


class TPMoEParams(TypedDict):
    """One MoE layer's parameters (the JAX ``TPMoEParams`` at tp=1); a
    model stacks each leaf over its layers."""

    w_router: torch.Tensor  # [d, E]
    w1: torch.Tensor        # [E, d, 2f]  gate | up fused per expert
    w2: torch.Tensor        # [E, f, d]


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise NotImplementedError(
            f"MoE mode {mode!r} is not ported: 'ring' and the pallas modes "
            "run the multi-rank MoE exchanges, which come with the "
            "multi-GPU slice (ROADMAP queue 1, item 11); use 'xla'"
        )


def tp_moe_fwd(params: TPMoEParams, x: torch.Tensor, k: int, *,
               mode: str = "xla", norm_topk_prob: bool = True
               ) -> torch.Tensor:
    """``x [T, d]`` → ``[T, d]`` in ``x``'s dtype: each token through its
    top-``k`` experts' SwiGLU FFN, weighted by its gate weights."""
    check_mode(mode)
    route = router_topk(x, params["w_router"], k,
                        norm_topk_prob=norm_topk_prob)
    st = moe_sort(route, params["w1"].shape[0])
    h = grouped_ffn(x[st.token_ids.long()], params["w1"], params["w2"],
                    st.group_sizes)
    return moe_combine(h, st, x.shape[0])
