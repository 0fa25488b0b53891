"""Sequence-parallel GQA flash-decode attention layer.

Counterpart of ``triton_distributed_tpu/layers/sp_flash_decode.py``
(``sp_append_kv``, ``sp_decode_attention``): the KV cache is sharded over
the context's ranks along the sequence in rank order (``[B, hkv, s_loc,
hd]`` a rank); the new token's K/V is written by the rank that owns
position ``kv_len``, then
:func:`~triton_distributed_tpu_torch.ops.attention.flash_decode.
distributed_flash_decode` attends and merges. JAX returns new cache
arrays; the port writes the caches in place (a decode step would
otherwise copy the whole cache) and returns them.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    distributed_flash_decode,
)


def sp_append_kv(caches, new, kv_len) -> list[torch.Tensor]:
    """Write ``new [B, h, hd]`` (replicated) at GLOBAL position
    ``kv_len[b]`` of the sharded ``caches[r] [B, h, s_loc, hd]``: a no-op
    on every rank but the owner of that position. In place, with no host
    read of ``kv_len``; returns ``caches``."""
    b, _, s_loc, _ = caches[0].shape
    for r, c in enumerate(caches):
        lens = torch.as_tensor(kv_len, device=c.device)
        local = lens.to(torch.long) - r * s_loc
        owner = (local >= 0) & (local < s_loc)
        at = torch.clamp(local, 0, s_loc - 1)
        rows = torch.arange(b, device=c.device)
        c[rows, :, at] = torch.where(owner[:, None, None], new.to(c.dtype),
                                     c[rows, :, at])
    return caches


def sp_decode_attention(qs, k_new, v_new, k_caches, v_caches, kv_len, ctx, *,
                        sm_scale: float | None = None, chunk_k: int = 256,
                        method: str = "xla"):
    """One SP decode-attention step: append the new token's K/V (``[B,
    hkv, hd]``, replicated) to the owner's shard, then the
    distributed split-KV attention at ``kv_len + 1``. ``qs[r] [B, hq, hd]``
    is rank r's copy of q, ``kv_len [B]`` int32 the GLOBAL lengths before
    the append. Returns ``(o [B, hq, hd] a rank, k_caches, v_caches)``."""
    sp_append_kv(k_caches, k_new, kv_len)
    sp_append_kv(v_caches, v_new, kv_len)
    lens = torch.as_tensor(kv_len, device=qs[0].device).to(torch.int32) + 1
    o = distributed_flash_decode(qs, k_caches, v_caches, lens, ctx,
                                 sm_scale=sm_scale, chunk_k=chunk_k,
                                 method=method)
    return o, k_caches, v_caches
