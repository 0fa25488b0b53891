"""The megakernel's task bodies as plain PyTorch: the kernel's plain version.

Counterpart of ``triton_distributed_tpu/megakernel/kernels.py``. There
each task type is a Pallas body inside one ``pallas_call``; here each is
a PyTorch function over the same f32 decode state (``x``, ``h``,
``qkv``, ``ao``, ``mlp``), rounding exactly where the JAX kernel
rounds: every GEMM casts its f32 input to the weight dtype and
accumulates in f32 (``_stream_cols``' ``x_f32.astype(wdtype)``), new
K/V rows leave in the cache dtype, and the state between tasks stays
f32. :func:`mega_decode_plain` walks a packed task table in order for
``nsteps`` steps, as the kernel does.

This is what the CPU runs (``device="cpu"``), what the tests hold
against the JAX package, and what ``chip_smoke.py`` holds the CUDA
kernel (``csrc/megakernel.cu``) against on the card. With a card
present the serving path never runs it.

Bodies this slice runs: EMBED, NORM, QKV_PROJ, ATTN (dense and paged,
with the in-launch band and the own-token merge), O_PROJ, FC1, FC2,
ALLREDUCE at tp=1 and LM_HEAD (single-step logits; multi-step running
argmax over the real vocab, first occurrence on ties, the winner fed to
the next step's EMBED, and the first stop-token step under ``eos``).
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.registry import register_task
from triton_distributed_tpu_torch.megakernel.task import TaskType
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    pages_to_dense,
)


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Per-lane inverse frequencies ``[head_dim]`` f32, the angle table of
    the JAX kernel's ``_make_rope``: lane i uses frequency
    ``i mod head_dim/2`` (the angle repeats per half). The kernel and its
    plain version take this one table, so their angles agree exactly."""
    half = np.arange(head_dim, dtype=np.float32) % np.float32(head_dim // 2)
    inv = np.float32(1.0) / (np.float32(theta) ** (
        np.float32(2.0) * half / np.float32(head_dim)))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


class MegaState:
    """The decode state the bodies read and write: the operands, the f32
    scratch between tasks, and the outputs."""

    def __init__(self, dims, fuse_norms: bool, weights, kc, vc, page_table,
                 kv_len, tokens, stop_tok, inv_freq):
        B, d = dims.batch, dims.d
        dev = kv_len.device
        self.dims, self.fuse_norms, self.w = dims, fuse_norms, weights
        self.wdtype = weights.wqkv.dtype
        self.kc, self.vc, self.page_table = kc, vc, page_table
        self.kv_len = kv_len.long()
        self.stop_tok = stop_tok
        self.inv_freq = inv_freq.to(dev, torch.float32)
        self.step = 0
        f32 = dict(dtype=torch.float32, device=dev)
        self.x = torch.zeros((B, d), **f32)
        self.h = torch.zeros((B, d), **f32)
        self.qkv = torch.zeros((B, dims.qkv_loc), **f32)
        self.ao = torch.zeros((B, dims.o_k), **f32)
        self.mlp = torch.zeros((B, dims.f_loc), **f32)
        self.tok = tokens.long()
        NS, L, hkv, hd = dims.nsteps, dims.num_layers, dims.hkv_loc, \
            dims.head_dim
        rows = (NS, L, B, hkv, hd)
        self.logits = torch.zeros((B, dims.v_loc), **f32)
        self.knew = torch.zeros(rows, dtype=kc.dtype, device=dev)
        self.vnew = torch.zeros(rows, dtype=vc.dtype, device=dev)
        self.toks = torch.zeros((NS, B), dtype=torch.int32, device=dev)
        self.stop_step = torch.full((B,), NS, dtype=torch.int32, device=dev)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMS-norm, ``x * rsqrt(mean(x²) + eps) * w``."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * w.to(torch.float32)


def _gemm(st: MegaState, x_f32: torch.Tensor, w: torch.Tensor):
    """``x [B, K] @ w [K, N]``: the input rounds to the weight dtype, the
    products accumulate in f32 (the JAX kernel's streamed GEMMs)."""
    return x_f32.to(st.wdtype).to(torch.float32) @ w.to(torch.float32)


def _normed_input(st: MegaState, layer: int, which: int) -> torch.Tensor:
    """The consumer's [B, d] f32 input: the NORM task's ``h``, or with
    fused norms the norm of ``x`` computed inline (which: 0 = ln1/qkv,
    1 = ln2/fc1, 2 = final/lm_head)."""
    if not st.fuse_norms:
        return st.h
    eps = st.dims.rms_eps
    if which == 0:
        return _rms(st.x, st.w.ln1[layer], eps)
    if which == 1:
        return _rms(st.x, st.w.ln2[layer], eps)
    return _rms(st.x, st.w.normf, eps)


@register_task(TaskType.EMBED)
def embed_body(st: MegaState, layer: int, arg0: int) -> None:
    """x ← embed[tok]: the launch's tokens at step 0, the previous step's
    argmax after it."""
    st.x = st.w.embed[st.tok].to(torch.float32)


@register_task(TaskType.NORM)
def norm_body(st: MegaState, layer: int, arg0: int) -> None:
    w = (st.w.ln1[layer], st.w.ln2[layer], st.w.normf)[arg0]
    st.h = _rms(st.x, w, st.dims.rms_eps)


@register_task(TaskType.QKV_PROJ)
def qkv_body(st: MegaState, layer: int, arg0: int) -> None:
    st.qkv = _gemm(st, _normed_input(st, layer, 0), st.w.wqkv[layer])


def _headnorm(t: torch.Tensor, w: torch.Tensor, eps: float):
    return t * torch.rsqrt(torch.mean(t * t, dim=-1, keepdim=True)
                           + eps) * w.to(torch.float32)


def _rope(t: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """``t * cos + rotate_half(t) * sin`` over the full lane width, the
    JAX kernel's roll-and-sign form."""
    half = t.shape[-1] // 2
    rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * torch.cos(ang) + rot * torch.sin(ang)


@register_task(TaskType.ATTN)
def attn_body(st: MegaState, layer: int, arg0: int) -> None:
    """QK-norm, rope at ``kv_len + step``, then one softmax over the
    cached rows (``< kv_len``), the launch's own earlier rows (the band:
    steps ``< step``, read back in the cache dtype) and the token's own
    K/V (f32). The new rows leave through ``knew``/``vnew``; the cache is
    not written."""
    dims = st.dims
    B, hq, hkv, hd = dims.batch, dims.hq_loc, dims.hkv_loc, dims.head_dim
    g = hq // hkv
    eps = dims.rms_eps
    qkv = st.qkv
    q = qkv[:, : hq * hd].reshape(B, hq, hd)
    k = qkv[:, hq * hd: (hq + hkv) * hd].reshape(B, hkv, hd)
    v = qkv[:, (hq + hkv) * hd:].reshape(B, hkv, hd)
    pos = (st.kv_len + st.step).to(torch.float32)
    ang = pos[:, None, None] * st.inv_freq[None, None, :]  # [B, 1, hd]
    q = _rope(_headnorm(q, st.w.qn[layer], eps), ang) * hd ** -0.5
    k = _rope(_headnorm(k, st.w.kn[layer], eps), ang)
    st.knew[st.step, layer] = k.to(st.knew.dtype)
    st.vnew[st.step, layer] = v.to(st.vnew.dtype)

    if st.page_table is None:
        kc, vc = st.kc[layer], st.vc[layer]  # [B, hkv, S, hd]
    else:
        kc = pages_to_dense(st.kc[layer], st.page_table)
        vc = pages_to_dense(st.vc[layer], st.page_table)
    qg = q.reshape(B, hkv, g, hd)
    s_c = torch.einsum("bhgd,bhsd->bhgs", qg, kc.to(torch.float32))
    valid = (torch.arange(kc.shape[2], device=q.device)[None, :]
             < st.kv_len[:, None])  # [B, S]
    s_c = torch.where(valid[:, None, None, :], s_c, float("-inf"))
    kb = st.knew[: st.step, layer].to(torch.float32)  # [step, B, hkv, hd]
    vb = st.vnew[: st.step, layer].to(torch.float32)
    s_b = torch.einsum("bhgd,sbhd->bhgs", qg, kb)
    s_s = torch.einsum("bhgd,bhd->bhg", qg, k)[..., None]
    s = torch.cat([s_c, s_b, s_s], dim=-1)
    p = torch.softmax(s, dim=-1)
    S, n_b = kc.shape[2], kb.shape[0]
    o = (torch.einsum("bhgs,bhsd->bhgd", p[..., :S], vc.to(torch.float32))
         + torch.einsum("bhgs,sbhd->bhgd", p[..., S:S + n_b], vb)
         + p[..., -1:] * v[:, :, None, :])
    st.ao = o.reshape(B, hq * hd)


@register_task(TaskType.O_PROJ)
def o_proj_body(st: MegaState, layer: int, arg0: int) -> None:
    st.h = _gemm(st, st.ao, st.w.wo[layer])


@register_task(TaskType.FC1)
def fc1_body(st: MegaState, layer: int, arg0: int) -> None:
    """silu(h @ gate) · (h @ up) over the fused ``[d, gate | up]``
    weight."""
    gu = _gemm(st, _normed_input(st, layer, 1), st.w.w1[layer])
    gate, up = gu[:, : st.dims.f_loc], gu[:, st.dims.f_loc:]
    st.mlp = gate * torch.sigmoid(gate) * up


@register_task(TaskType.FC2)
def fc2_body(st: MegaState, layer: int, arg0: int) -> None:
    st.h = _gemm(st, st.mlp, st.w.w2[layer])


@register_task(TaskType.ALLREDUCE)
def allreduce_body(st: MegaState, layer: int, arg0: int) -> None:
    """``x += psum(h)``; at tp=1 the psum is ``h`` itself."""
    st.x = st.x + st.h


def _multi_step_tail(st: MegaState, row: torch.Tensor) -> None:
    """Publish this step's winners: the next EMBED's tokens and the
    per-step token output; under ``eos`` stamp each row's FIRST step
    whose winner is its stop token (``nsteps`` = never)."""
    st.tok = row.long()
    st.toks[st.step] = row.to(torch.int32)
    if st.dims.eos:
        ns = st.dims.nsteps
        hit = row.long() == st.stop_tok.long()
        prev = (torch.full_like(st.stop_step, ns) if st.step == 0
                else st.stop_step)
        st.stop_step = torch.where(hit & (prev == ns),
                                   torch.full_like(prev, st.step), prev)


def takes_argmax(dims) -> bool:
    """Multi-step builds (``nsteps > 1``, or any build that names its real
    vocab, as ``build_multi`` does even at ``nsteps = 1``) take the argmax
    in the LM head; single-step builds leave it to the host."""
    return dims.nsteps > 1 or dims.v_real > 0


@register_task(TaskType.LM_HEAD)
def lm_head_body(st: MegaState, layer: int, arg0: int) -> None:
    """Logits over the padded vocab; in multi-step builds the argmax over
    the real columns (``< v_real``: the zero pad columns would beat
    negative logits), first occurrence on ties, feeds the next step."""
    dims = st.dims
    st.logits = _gemm(st, _normed_input(st, layer, 2), st.w.lm_head)
    if takes_argmax(dims):
        v_real = min(dims.v_real or dims.v_loc, dims.v_loc)
        cols = torch.arange(dims.v_loc, device=st.logits.device)
        masked = torch.where(cols[None, :] < v_real, st.logits,
                             float("-inf"))
        best = masked.max(dim=-1, keepdim=True).values
        first = torch.where(masked == best, cols[None, :],
                            dims.v_loc).min(dim=-1).values
        _multi_step_tail(st, first)


def mega_decode_plain(dims, fuse_norms: bool, table: np.ndarray, weights,
                      kc, vc, page_table, kv_len, tokens, stop_tok=None,
                      inv_freq=None):
    """Walk the packed ``table [T, 8]`` for ``dims.nsteps`` steps over one
    :class:`MegaState`. Returns ``(logits [B, v_loc] f32 of the last
    step, knew, vnew [NS, L, B, hkv, hd], toks [NS, B] int32, stop_step
    [B] int32)``; ``toks`` is zeros in single-step builds (the host
    takes the argmax of the logits) and ``stop_step`` all ``nsteps``
    without ``eos``."""
    from triton_distributed_tpu_torch.megakernel.registry import get_body

    if inv_freq is None:
        inv_freq = rope_inv_freq(dims.head_dim, dims.rope_theta,
                                 kv_len.device)
    st = MegaState(dims, fuse_norms, weights, kc, vc, page_table, kv_len,
                   tokens, stop_tok, inv_freq)
    rows = [(TaskType(int(r[0])), int(r[1]), int(r[2]))
            for r in np.asarray(table)]
    bodies = [(get_body(t), layer, arg0) for t, layer, arg0 in rows]
    for step in range(dims.nsteps):
        st.step = step
        for body, layer, arg0 in bodies:
            body(st, layer, arg0)
    return st.logits, st.knew, st.vnew, st.toks, st.stop_step
