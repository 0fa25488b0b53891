"""Model configs: ``ModelConfig`` and the Qwen3 presets.

Counterpart of ``triton_distributed_tpu/models/config.py``; the same
fields and presets (Qwen3 dense and Qwen3-MoE), with ``dtype`` a
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_name: str = "Qwen/Qwen3-8B"
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_layers: int = 36
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = False
    # MoE (0 experts = dense).
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    # Renormalize the top-k router weights to sum to 1 (the HF
    # Qwen3MoeConfig field: the Qwen3-MoE checkpoints set it true, the HF
    # default is false).
    norm_topk_prob: bool = True
    max_length: int = 4096
    dtype: torch.dtype = torch.bfloat16
    # KV-cache storage: None (full width, ``dtype``) or "int8" (int8
    # codes + per-page-per-head f32 scales). An engine's explicit
    # ``kv_dtype`` knob wins over this.
    kv_dtype: str | None = None


# Architecture presets (numbers from the public HF Qwen3 and Qwen3-MoE
# configs).
_PRESETS: dict[str, dict] = {
    "Qwen/Qwen3-0.6B": dict(
        hidden_size=1024, intermediate_size=3072, num_layers=28,
        num_q_heads=16, num_kv_heads=8, head_dim=128,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-1.7B": dict(
        hidden_size=2048, intermediate_size=6144, num_layers=28,
        num_q_heads=16, num_kv_heads=8, head_dim=128,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-4B": dict(
        hidden_size=2560, intermediate_size=9728, num_layers=36,
        num_q_heads=32, num_kv_heads=8, head_dim=128,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-8B": dict(
        hidden_size=4096, intermediate_size=12288, num_layers=36,
        num_q_heads=32, num_kv_heads=8, head_dim=128,
    ),
    "Qwen/Qwen3-32B": dict(
        hidden_size=5120, intermediate_size=25600, num_layers=64,
        num_q_heads=64, num_kv_heads=8, head_dim=128,
    ),
    "Qwen/Qwen3-30B-A3B": dict(
        hidden_size=2048, intermediate_size=6144, num_layers=48,
        num_q_heads=32, num_kv_heads=4, head_dim=128,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    ),
    # Tiny configs for tests / CPU runs.
    "tiny": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_q_heads=8, num_kv_heads=4, head_dim=32, max_length=128,
        dtype=torch.float32,
    ),
    "tiny-moe": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_q_heads=8, num_kv_heads=4, head_dim=32, max_length=128,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
        dtype=torch.float32,
    ),
}


def get_config(model_name: str, **overrides) -> ModelConfig:
    if model_name not in _PRESETS:
        raise ValueError(
            f"unknown model {model_name!r}; presets: {sorted(_PRESETS)}"
        )
    fields = dict(_PRESETS[model_name])
    fields.update(overrides)
    return ModelConfig(model_name=model_name, **fields)
