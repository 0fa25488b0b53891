"""Rotary position embeddings (RoPE), rotate-half with f32 math.

Counterpart of ``triton_distributed_tpu/ops/attention/rope.py``.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 1e6,
               device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] (Qwen3 default theta=1e6)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,          # [..., S, head_dim] or [..., head_dim]
    positions: torch.Tensor,  # [..., S] or [...] integer absolute positions
    theta: float = 1e6,
) -> torch.Tensor:
    """Rotate-half RoPE (HF convention: first/second half pairing)."""
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv  # [..., hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
