"""Qwen3-MoE at tp=1.

Counterpart of ``triton_distributed_tpu/models/qwen_moe.py``: the dense
:class:`Qwen3` with every layer's MLP replaced by the top-k routed expert
FFN (``layers/tp_moe.py``), the same parameter layout (``mlp.{w_router
[L, d, E], w1 [L, E, d, 2f] (gate | up per expert), w2 [L, E, f, d]}``),
and ``load_hf_moe_state_dict`` for HF ``Qwen3MoeForCausalLM`` names
(``mlp.gate.weight``, ``mlp.experts.N.{gate,up,down}_proj.weight``).
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.tp_moe import tp_moe_fwd
from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.models.qwen import (
    Qwen3,
    _np32,
    load_hf_state_dict,
)


class Qwen3MoE(Qwen3):
    """Qwen3 with routed-expert MLPs, on one device."""

    def __init__(self, cfg: ModelConfig, *, device=None, ctx=None,
                 tp: int | None = None):
        if not cfg.num_experts:
            raise ValueError("Qwen3MoE needs cfg.num_experts > 0")
        super().__init__(cfg, device=device, ctx=ctx, tp=tp)
        if self.tp != 1:
            raise NotImplementedError(
                "Qwen3MoE at tp>1 needs the expert-parallel exchange, which "
                "is not ported yet (ROADMAP queue 1, item 11: EP)")

    def _mlp_fwd(self, mlp_params: list, h: list, mode: str):
        return [tp_moe_fwd(p, t, self.cfg.num_experts_per_tok, mode=mode,
                           norm_topk_prob=self.cfg.norm_topk_prob)
                for p, t in zip(mlp_params, h)]

    def init_params(self, seed: int = 0) -> dict:
        """Random init on the model's device from a ``torch.Generator``
        seeded with ``seed``, with the scales of the JAX ``init_params``
        (router, gate and up ``d^-1/2``, down ``f^-1/2``, the other
        projections fan_in^-1/2, embed 0.02, norms 1). Each weight is
        allocated in the model dtype and drawn in place, layer by layer
        (``normal_`` at the scale), so the peak is the weights' own bytes:
        61.1 GB at Qwen3-30B-A3B in bf16, with no f32 copy."""
        cfg = self.cfg
        hd, d, L = cfg.head_dim, cfg.hidden_size, cfg.num_layers
        e, f = cfg.num_experts, cfg.moe_intermediate_size
        dev, dt = self.device, cfg.dtype
        g = torch.Generator(device=dev).manual_seed(int(seed))

        def rnd(*shape, scale):
            w = torch.empty(shape, dtype=dt, device=dev)
            for part in (w if len(shape) > 2 else (w,)):
                part.normal_(0.0, scale, generator=g)
            return w

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * hd
        params = {
            "embed": rnd(cfg.vocab_size, d, scale=0.02),
            "layers": {
                "ln1": ones(L, d),
                "attn": {
                    "wqkv": rnd(L, d, qkv, scale=d**-0.5),
                    "wo": rnd(L, cfg.num_q_heads * hd, d,
                              scale=(cfg.num_q_heads * hd) ** -0.5),
                    "q_norm": ones(L, hd), "k_norm": ones(L, hd),
                },
                "ln2": ones(L, d),
                "mlp": {
                    "w_router": rnd(L, d, e, scale=d**-0.5),
                    "w1": rnd(L, e, d, 2 * f, scale=d**-0.5),
                    "w2": rnd(L, e, f, d, scale=f**-0.5),
                },
            },
            "norm": ones(d),
            "lm_head": rnd(d, cfg.vocab_size, scale=d**-0.5),
        }
        return self.set_params(params)


def load_hf_moe_state_dict(cfg: ModelConfig, state: dict) -> dict:
    """Map an HF Qwen3-MoE state dict (numpy arrays or tensors, torch
    layout ``weight [out, in]``) to the port's parameter dict with the
    MoE MLP leaves."""
    L, e = cfg.num_layers, cfg.num_experts
    d = cfg.hidden_size
    # The dense loader maps everything but the MLP; it is handed
    # placeholder dense MLP weights, replaced below.
    dense_state = dict(state)
    zero = np.zeros((1, d), np.float32)  # torch layout [out, in]
    for i in range(L):
        p = f"model.layers.{i}.mlp."
        dense_state[p + "gate_proj.weight"] = zero
        dense_state[p + "up_proj.weight"] = zero
        dense_state[p + "down_proj.weight"] = zero.T
    params = load_hf_state_dict(cfg, dense_state)

    def get(name):
        return _np32(state[name])

    routers, w1s, w2s = [], [], []
    for i in range(L):
        p = f"model.layers.{i}.mlp."
        routers.append(get(p + "gate.weight").T)  # [d, E]
        gates = np.stack([get(p + f"experts.{j}.gate_proj.weight").T
                          for j in range(e)])    # [E, d, f]
        ups = np.stack([get(p + f"experts.{j}.up_proj.weight").T
                        for j in range(e)])
        w1s.append(np.concatenate([gates, ups], axis=-1))  # [E, d, 2f]
        w2s.append(np.stack([get(p + f"experts.{j}.down_proj.weight").T
                             for j in range(e)]))  # [E, f, d]
    params["layers"]["mlp"] = {
        "w_router": np.stack(routers), "w1": np.stack(w1s),
        "w2": np.stack(w2s),
    }
    return params
