"""SwiGLU MLP at tp=1.

Counterpart of ``triton_distributed_tpu/layers/tp_mlp.py``: the
``xla``/``xla_ar`` branches of ``tp_mlp_fwd``, which at tp=1 are two
plain GEMMs around an f32 SiLU·mul (the all-gather, psum and
reduce-scatter run over a one-device axis and drop out). The
``pallas``/``pallas_ar`` modes call the overlapped GEMM+collective
kernels (ag_gemm/gemm_rs/gemm_ar), which wait for the multi-GPU slice
(ROADMAP queue 1).

Parameters are a dict ``{"w1": [d, 2*d_ff] (gate | up), "w2": [d_ff, d]}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("xla", "xla_ar")


def _silu_mul(h: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(h, 2, dim=-1)
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(h.dtype)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise NotImplementedError(
            f"mode {mode!r} is not ported: the pallas modes use the "
            "overlapped GEMM+collective kernels, which come with the "
            "multi-GPU slice (ROADMAP queue 1, item 11); use 'xla'"
        )


def tp_mlp_fwd(params: dict, x: torch.Tensor, *, mode: str = "xla"):
    """``x [M, d]`` → ``[M, d]``: down(silu(x @ gate) * (x @ up)). Each
    GEMM accumulates in f32 and rounds to ``x.dtype``."""
    check_mode(mode)
    h = _silu_mul(x @ params["w1"])
    return h @ params["w2"]
