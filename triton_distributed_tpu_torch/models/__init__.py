"""Models + serving of the PyTorch port.

``AutoLLM.from_pretrained`` builds a preset with random weights from a
seed (no checkpoint download is possible on the card's host). Loading a
local HF checkpoint directory needs ``safetensors``, which that host
lacks, so it waits (ROADMAP queue 1, item 4c); :func:`load_hf_state_dict`
maps an already-loaded state dict and needs no files
(:func:`load_hf_moe_state_dict` a Qwen3-MoE one).
"""

from __future__ import annotations

import os

from triton_distributed_tpu_torch.models.config import (  # noqa: F401
    ModelConfig,
    get_config,
)
from triton_distributed_tpu_torch.models.continuous import (  # noqa: F401
    ContinuousEngine,
    Request,
    RequestError,
    RequestFailedError,
    RequestResult,
)
from triton_distributed_tpu_torch.models.engine import Engine  # noqa: F401
from triton_distributed_tpu_torch.models.kv_cache import (  # noqa: F401
    KVCache,
    init_cache,
)
from triton_distributed_tpu_torch.models.paged_kv_cache import (  # noqa: F401
    PoolAuditError,
    audit_pool,
)
from triton_distributed_tpu_torch.models.prefix_cache import (  # noqa: F401
    PrefixCache,
)
from triton_distributed_tpu_torch.models.qwen import (  # noqa: F401
    Qwen3,
    load_hf_state_dict,
    params_from_jax,
    q8_params_from_jax,
    shard_params,
    unshard_params,
)
from triton_distributed_tpu_torch.models.qwen_moe import (  # noqa: F401
    Qwen3MoE,
    load_hf_moe_state_dict,
)


class AutoLLM:
    """Model factory by preset name."""

    @staticmethod
    def from_pretrained(name_or_path: str, *, device=None, seed: int = 0,
                        ctx=None, tp: int | None = None,
                        **overrides) -> Qwen3:
        """A Qwen3 preset (``tiny``, ``Qwen/Qwen3-0.6B`` ...; a preset
        with experts, ``tiny-moe`` or ``Qwen/Qwen3-30B-A3B``, builds
        :class:`Qwen3MoE`) with random weights from ``seed``, on ``cuda``
        unless ``device`` says otherwise, over ``tp`` co-located ranks (or
        the ranks of ``ctx``, a ``DistContext``); the shards of the tp=1
        model of the same seed."""
        if os.path.isdir(name_or_path):
            raise NotImplementedError(
                "loading a local HF checkpoint directory needs safetensors "
                "and is not ported yet (ROADMAP queue 1, item 4c); use "
                "load_hf_state_dict on a loaded state dict"
            )
        cfg = get_config(name_or_path, **overrides)
        model = (Qwen3MoE if cfg.num_experts else Qwen3)(
            cfg, device=device, ctx=ctx, tp=tp)
        model.init_params(seed)
        return model
