"""Dense KV cache.

Counterpart of ``triton_distributed_tpu/models/kv_cache.py``:
``k/v [L, B, Hkv, S_max, hd]`` plus ``kv_len [B]``. The JAX cache is an
immutable pytree threaded through donated programs; this one is written
in place by the model and returned, so call sites read alike.

At tp=n the cache is head-sharded: ``k/v [n, L, B, hkv_loc, S_max,
hd]``, each rank's ``[L, B, hkv_loc, S_max, hd]`` contiguous
(:meth:`KVCache.rank` is its view, the tp=1 layout the kernels take);
``kv_len`` is shared, as the JAX package replicates it.
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

    @property
    def tp(self) -> int:
        return 1 if self.k.dim() == 5 else int(self.k.shape[0])

    def rank(self, r: int) -> "KVCache":
        """Rank ``r``'s shard as a tp=1 cache (views; kv_len shared)."""
        if self.tp == 1:
            return self
        return KVCache(k=self.k[r], v=self.v[r], kv_len=self.kv_len)


def init_cache(
    cfg: ModelConfig,
    batch_size: int,
    device,
    max_length: int | None = None,
    tp: int = 1,
) -> KVCache:
    s_max = max_length or cfg.max_length
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads // tp, s_max,
             cfg.head_dim)
    if tp > 1:
        shape = (tp, *shape)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        kv_len=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )
