"""Dense KV cache.

Counterpart of ``triton_distributed_tpu/models/kv_cache.py``:
``k/v [L, B, Hkv, S_max, hd]`` plus ``kv_len [B]``. The JAX cache is an
immutable pytree threaded through donated programs; this one is written
in place by the model and returned, so call sites read alike.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, Hkv, S_max, hd]
    v: torch.Tensor
    kv_len: torch.Tensor  # [B] int32 — tokens currently cached


def init_cache(
    cfg: ModelConfig,
    batch_size: int,
    device,
    max_length: int | None = None,
) -> KVCache:
    s_max = max_length or cfg.max_length
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, s_max, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        kv_len=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )
