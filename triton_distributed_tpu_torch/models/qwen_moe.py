"""Qwen3-MoE, over one or more co-located ranks.

Counterpart of ``triton_distributed_tpu/models/qwen_moe.py``: the dense
:class:`Qwen3` with every layer's MLP replaced by the top-k routed expert
FFN (``layers/tp_moe.py``), the same parameter layout (``mlp.{w_router
[L, d, E], w1 [L, E, d, 2f] (gate | up per expert), w2 [L, E, f, d]}``),
and ``load_hf_moe_state_dict`` for HF ``Qwen3MoeForCausalLM`` names
(``mlp.gate.weight``, ``mlp.experts.N.{gate,up,down}_proj.weight``).

At tp=n the experts are tensor-parallel, as in the JAX ``TPMoE``
(``layers/tp_moe.py:124-130``): each rank holds every expert's columns
``[gate_r | up_r]`` of ``w1`` and rows of ``w2``, and the router
replicated (:func:`~triton_distributed_tpu_torch.models.qwen.shard_leaf`).
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
    shard_leaf,
    shard_params,
)


class Qwen3MoE(Qwen3):
    """Qwen3 with routed-expert MLPs over the ranks of a
    :class:`DistContext` (one by default)."""

    def __init__(self, cfg: ModelConfig, *, device=None, ctx=None,
                 tp: int | None = None):
        if not cfg.num_experts:
            raise ValueError("Qwen3MoE needs cfg.num_experts > 0")
        super().__init__(cfg, device=device, ctx=ctx, tp=tp)

    def _mlp_fwd(self, mlp_params: list, h: list, mode: str):
        return tp_moe_fwd(mlp_params, h, self.cfg.num_experts_per_tok,
                          mode=mode, norm_topk_prob=self.cfg.norm_topk_prob,
                          ctx=self.ctx)

    def init_params(self, seed: int = 0):
        """Random init on the model's device from a ``torch.Generator``
        seeded with ``seed``, with the scales of the JAX ``init_params``
        (router, gate and up ``d^-1/2``, down ``f^-1/2``, the other
        projections fan_in^-1/2, embed 0.02, norms 1). Each weight is
        drawn in the model dtype, one layer at a time (``normal_`` at the
        scale) into a one-layer buffer whose rank parts
        (:func:`shard_leaf`) are copied into each rank's stacked shard.
        The draws are the same at every tp, so a tp=n model holds the
        shards of the tp=1 model of the same seed, and the peak is the
        weights' own bytes plus one layer of one leaf (61.1 GB at
        Qwen3-30B-A3B in bf16; at tp=n the replicated embedding n times),
        with no f32 copy and no unsharded model."""
        cfg = self.cfg
        hd, d, L, n = cfg.head_dim, cfg.hidden_size, cfg.num_layers, self.tp
        e, f = cfg.num_experts, cfg.moe_intermediate_size
        dev, dt = self.device, cfg.dtype
        g = torch.Generator(device=dev).manual_seed(int(seed))
        qw = cfg.num_q_heads * hd

        def rnd(path, *shape, scale, layered=True):
            """Leaf ``path`` ([L, *shape], or ``shape`` itself when not
            ``layered``) as its n rank parts."""
            buf = torch.empty(shape, dtype=dt, device=dev)
            out = None
            for i in range(L if layered else 1):
                buf.normal_(0.0, scale, generator=g)
                parts = shard_leaf(path, buf, n, qw)
                if not layered:
                    return [p.clone() for p in parts]
                if out is None:
                    out = [torch.empty((L, *p.shape), dtype=dt, device=dev)
                           for p in parts]
                for o, p in zip(out, parts):
                    o[i].copy_(p)
            return out

        def ones(*shape):
            return [torch.ones(shape, dtype=dt, device=dev)
                    for _ in range(n)]

        qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * hd
        embed = rnd(("embed",), cfg.vocab_size, d, scale=0.02, layered=False)
        ln1 = ones(L, d)
        wqkv = rnd(("attn", "wqkv"), d, qkv, scale=d**-0.5)
        wo = rnd(("attn", "wo"), qw, d, scale=qw**-0.5)
        q_norm, k_norm, ln2 = ones(L, hd), ones(L, hd), ones(L, d)
        w_router = rnd(("mlp", "w_router"), d, e, scale=d**-0.5)
        w1 = rnd(("mlp", "w1"), e, d, 2 * f, scale=d**-0.5)
        w2 = rnd(("mlp", "w2"), e, f, d, scale=f**-0.5)
        norm = ones(d)
        lm_head = rnd(("lm_head",), d, cfg.vocab_size, scale=d**-0.5,
                      layered=False)
        shards = [{
            "embed": embed[r],
            "layers": {
                "ln1": ln1[r],
                "attn": {"wqkv": wqkv[r], "wo": wo[r], "q_norm": q_norm[r],
                         "k_norm": k_norm[r]},
                "ln2": ln2[r],
                "mlp": {"w_router": w_router[r], "w1": w1[r], "w2": w2[r]},
            },
            "norm": norm[r],
            "lm_head": lm_head[r],
        } for r in range(n)]
        return self.set_params(shards[0] if n == 1 else shards)


def load_hf_moe_state_dict(cfg: ModelConfig, state: dict, tp: int = 1):
    """Map an HF Qwen3-MoE state dict (numpy arrays or tensors, torch
    layout ``weight [out, in]``) to the port's parameter dict with the
    MoE MLP leaves; at ``tp=n`` the list of per-rank shards
    (:func:`shard_params`), the JAX ``load_hf_moe_state_dict(cfg, state,
    n)``'s layout."""
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
    return params if tp == 1 else shard_params(params, tp, cfg)
