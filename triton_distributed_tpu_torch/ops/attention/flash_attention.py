"""Causal/GQA flash attention (prefill) and its plain version.

Counterpart of ``triton_distributed_tpu/ops/attention/flash_attention.py``:
same layout (``q [B, Hq, Sq, D]``, ``k/v [B, Hkv, Sk, D]``), the same
``kv_offset`` (absolute position of ``q[..., 0, :]`` in the kv sequence)
and the same optional base-e LSE. On a CUDA tensor :func:`flash_attention`
launches the hand-written kernel (``csrc/flash_attention.cu``) or raises;
on a CPU tensor it runs :func:`mha_reference`, the plain version. In bf16
at head_dim 128 over model-dtype K/V (causal or non-causal, with or
without a bias) the kernel multiplies on the tensor cores (wgmma, TMA-fed
K/V); every other build runs its products on the FMA pipes.

With ``k_scale``/``v_scale`` the K/V operands are int8 codes with one
f32 scale per ``block_k`` keys per kv head (the chunk-prefill path over
an int8 pool sets ``block_k = page``): the kernel is
``flash_attention_int8``, and the plain version dequantizes with the
scales repeated ``block_k`` times, as the JAX portable path does.

With ``bias`` (``[Sq, Sk]`` f32, shared by every batch row and head) the
scaled scores get the bias added before the causal mask: the draft-tree
ancestor mask of a speculative tree verify (0 visible, -1e30 masked).
The kernel is ``flash_attention_bias``.

``causal=False`` (every row sees every column below ``Sk``; ``kv_offset``
is ignored) is the cold partial of a sharded long-context slot's prefill
chunk: the cold window's bias masks the bucket's tail past ``s_cold``.
The kernels are ``flash_attention_cold`` (model-dtype K/V) and
``flash_attention_cold_int8`` (int8 codes + scales), each with or
without a bias. A causal call with both a bias and int8 scales is on no
serving path: on a CUDA tensor it raises ``ValueError``.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck

_NEG_INF = -1e30
HEAD_DIMS = (32, 128)  # the presets' head dims (tiny, Qwen3)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    kv_offset: int = 0,
    return_lse: bool = False,
    block_k: int = 128,
    k_scale: torch.Tensor | None = None,  # [B, Hkv, Sk/block_k] f32
    v_scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,     # [Sq, Sk] f32 additive score bias
):
    """Returns ``o [B, Hq, Sq, D]`` (q.dtype), plus ``lse [B, Hq, Sq]``
    f32 when ``return_lse``. ``Sq``/``Sk`` need not be tile multiples.
    ``block_k`` is the scale granularity of int8 K/V (keys per scale);
    the kernel's own tiling does not depend on it."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if sm_scale is None:
        sm_scale = d**-0.5
    kv_offset = int(kv_offset)
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    block_k = min(int(block_k), sk)
    if quant and sk % block_k:
        raise ValueError(f"kv length {sk} not a multiple of block_k "
                         f"{block_k}")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if quant and tuple(sc.shape) != (b, hkv, sk // block_k):
            raise ValueError(
                f"{name} shape {tuple(sc.shape)} != per-block layout "
                f"{(b, hkv, sk // block_k)} (block_k={block_k})"
            )
    if bias is not None and tuple(bias.shape) != (sq, sk):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(sq, sk)}")
    if q.device.type == "cpu":
        if quant:
            k = k.to(torch.float32) * k_scale.repeat_interleave(
                block_k, dim=-1)[..., None]
            v = v.to(torch.float32) * v_scale.repeat_interleave(
                block_k, dim=-1)[..., None]
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             kv_offset=kv_offset, return_lse=return_lse,
                             bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in ck.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not f32/bf16")
    ck.check_cuda_operand("q", q, q.device, q.dtype, 4)
    for name, t in (("k", k), ("v", v)):
        ck.check_cuda_operand(name, t, q.device,
                              torch.int8 if quant else q.dtype, 4)
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            ck.check_cuda_operand(name, sc, q.device, torch.float32, 3)
    if bias is not None:
        ck.check_cuda_operand("bias", bias, q.device, torch.float32, 2)
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if min(b, hq, sq, sk) < 1 or kv_offset < 0:
        raise ValueError("flash_attention: empty shape or negative kv_offset")
    if causal and quant and bias is not None:
        raise ValueError("flash_attention: a causal call takes a bias or "
                         "int8 scales, not both")
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    bias_ptr = None if bias is None else bias.data_ptr()
    if not causal and quant:
        ck.FLASH_ATTENTION_COLD_INT8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), bias_ptr, o.data_ptr(), lse_ptr,
            b, hq, hkv, sq, sk, d, block_k, float(sm_scale),
            ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
        )
    elif not causal:
        ck.FLASH_ATTENTION_COLD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, o.data_ptr(),
            lse_ptr, b, hq, hkv, sq, sk, d, float(sm_scale),
            ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
        )
    elif quant:
        ck.FLASH_ATTENTION_INT8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), o.data_ptr(), lse_ptr,
            b, hq, hkv, sq, sk, d, kv_offset, block_k, float(sm_scale),
            ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
        )
    elif bias is not None:
        ck.FLASH_ATTENTION_BIAS(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse_ptr, b, hq, hkv, sq, sk, d, kv_offset,
            float(sm_scale), ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
        )
    else:
        ck.FLASH_ATTENTION(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            b, hq, hkv, sq, sk, d, kv_offset, float(sm_scale),
            ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
        )
    return (o, lse) if return_lse else o


def mha_reference(
    q, k, v, *, causal=True, sm_scale=None, kv_offset: int = 0,
    return_lse: bool = False, bias=None,
):
    """Plain attention in f32 (full softmax, no tiling): the plain version
    of :func:`flash_attention`, ``bias [Sq, Sk]`` added to the scaled
    scores before the causal mask (no mask when ``causal`` is False)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if sm_scale is None:
        sm_scale = d**-0.5
    k = k.repeat_interleave(hq // hkv, dim=1).to(torch.float32)
    v = v.repeat_interleave(hq // hkv, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * sm_scale
    if bias is not None:
        s = s + bias.to(torch.float32)[None, None]
    if causal:
        rows = kv_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, _NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    # softmax subtracts the row max before exp: a row whose scores are
    # all -1e30 (a fully masked cold partial) averages V, as the kernels
    # do, where exp(s - lse) would lose log(Sk) against 1e30 and sum it.
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)
    if return_lse:
        return o, lse
    return o
