"""Grouped (expert-batched) GEMM.

Counterpart of ``triton_distributed_tpu/ops/moe/grouped_gemm.py``
(``grouped_gemm`` :17, ``grouped_ffn`` :30), which is
``jax.lax.ragged_dot`` outside any Pallas kernel. Here it is one
``torch.matmul`` per expert segment of the sorted rows: the segment
sizes are read to the host once per call (one sync per MoE layer), and
only the experts that received rows run. Each product accumulates in f32
and rounds to the input dtype, as ``ragged_dot`` with an f32 accumulator
followed by ``astype`` does. ``SEGMENTS`` counts the segment GEMMs run
(each is a launch on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Segment GEMMs run since import (two per routed expert of a grouped_ffn).
SEGMENTS = 0


def _sizes(group_sizes) -> list[int]:
    if isinstance(group_sizes, torch.Tensor):
        return group_sizes.tolist()
    return [int(n) for n in group_sizes]


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes
                 ) -> torch.Tensor:
    """``out[i] = x[i] @ w[group_of_row(i)]`` for rows ``x [M, d]``
    sorted by group, ``w [E, d, f]`` and ``group_sizes [E]`` (a tensor or
    a host list, summing to M): ``[M, f]`` in ``x``'s dtype."""
    global SEGMENTS
    out = x.new_empty((x.shape[0], w.shape[2]))
    off = 0
    for e, n in enumerate(_sizes(group_sizes)):
        if n:
            out[off:off + n] = x[off:off + n] @ w[e]
            SEGMENTS += 1
            off += n
    return out


def grouped_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                group_sizes) -> torch.Tensor:
    """SwiGLU expert FFN over expert-sorted rows ``x [M, d]`` with
    ``w1 [E, d, 2f]`` (gate | up fused per expert) and ``w2 [E, f, d]``:
    ``[M, d]``, not yet combined. SiLU·up runs in f32 and rounds to the
    model dtype."""
    sizes = _sizes(group_sizes)
    h = grouped_gemm(x, w1, sizes)
    gate, up = torch.chunk(h, 2, dim=-1)
    act = (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(x.dtype)
    return grouped_gemm(act, w2, sizes)
