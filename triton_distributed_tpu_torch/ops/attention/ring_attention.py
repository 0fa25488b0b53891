"""Ring attention: the K/V chunks circulate, each rank merges partials.

Counterpart of ``triton_distributed_tpu/ops/attention/ring_attention.py``
(``ring_attention`` :28). The sequence is sharded over the ranks in rank
order; at step i rank ``me`` holds the chunk of rank ``me - i`` (JAX moves
it with ``lax.ppermute``, an XLA collective: here a rotation of the
per-rank lists) and attends its q rows over it with
:func:`~triton_distributed_tpu_torch.ops.attention.flash_attention.
flash_attention` (non-causal, with LSE; the own chunk causal), and the n
partials merge by :func:`~triton_distributed_tpu_torch.ops.attention.
flash_decode.lse_combine` in step order. Under ``causal`` a later rank's
chunk is a weight-0 partial (O = 0, LSE = -inf), as JAX selects it; the
port does not compute what JAX computes and then discards. The kernels
are the ported ``flash_attention`` ones (``csrc/flash_attention.cu``).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.attention.flash_attention import (
    flash_attention,
)
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    lse_combine,
)


def ring_attention(qs, ks, vs, *, causal: bool = True,
                   sm_scale: float | None = None) -> list[torch.Tensor]:
    """``qs[r] [hq, s_loc, hd]``, ``ks[r]``/``vs[r] [hkv, s_loc, hd]``
    rank r's shards: ``[hq, s_loc, hd]`` a rank in q's dtype."""
    n = len(qs)
    hd = qs[0].shape[2]
    if sm_scale is None:
        sm_scale = hd**-0.5
    outs = []
    for me, q in enumerate(qs):
        o_parts, lse_parts = [], []
        for i in range(n):
            src = (me - i) % n  # the rank whose chunk arrived at step i
            if causal and src > me:
                o_parts.append(torch.zeros(q.shape, dtype=torch.float32,
                                           device=q.device))
                lse_parts.append(torch.full(q.shape[:2], -float("inf"),
                                            dtype=torch.float32,
                                            device=q.device))
                continue
            o, lse = flash_attention(
                q[None], ks[src][None], vs[src][None],
                causal=causal and src == me, sm_scale=sm_scale,
                return_lse=True)
            o_parts.append(o[0].to(torch.float32))
            lse_parts.append(lse[0])
        o, _ = lse_combine(torch.stack(o_parts), torch.stack(lse_parts),
                           part_axis=0)
        outs.append(o.to(q.dtype))
    return outs
