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
ALLREDUCE and LM_HEAD (single-step logits; multi-step running argmax
over the real vocab, first occurrence on ties, the winner fed to the
next step's EMBED, and the first stop-token step under ``eos``). At tp=n
> 1 (:func:`mega_decode_plain_tp`) one state a rank is walked in
lockstep, task by task: BARRIER has nothing to wait for, ALLREDUCE and
AR_SEND/AR_WAIT fold every rank's partial into ``x`` in rank order, and
the LM head's per-rank candidates (over each rank's real columns) are
reduced in rank order with a strict ``>``, the JAX bodies' exchanges; an
MoE graph's experts are expert-parallel there (rank r runs experts
``r·E_loc ..``) and A2A_WAIT folds every rank's two combine partials.
Under ``sampled`` the argmax runs over ``logits + noise[step]`` (the
Gumbel-max trick; the logits output stays clean), and under
``filtered`` over the top-k/top-p keep-set of each row
(``sampling.filtered_winner_plain``). RING_POLL stamps the published
doorbell into its trace record. The prefill graph
(:func:`mega_prefill_plain`) adds LOAD_X (the embedded prompt rows in)
and ATTN_PREFILL (causal attention over the S prompt rows), and its
LM_HEAD projects only the last real row; at tp > 1
(:func:`mega_prefill_plain_tp`) the n rank states walk it in lockstep, its
ALLREDUCE folding the ranks' ``[S, d]`` partials in rank order.

The MoE graph (``dims.moe``) replaces each layer's FC1/FC2/ALLREDUCE with
MOE_GATE (f32 router logits over the normed ``h``, softmax over the
experts, the top k with ties to the lowest expert index, as the JAX
body's max-and-retire loop picks them, optional renormalisation, into
the combine weights ``moe_w [E, B]``),
one MOE_FFN per local expert (SwiGLU FFN of every row, FC2's f32 sums
scaled per row by the combine weight of the global expert ``rank·E_loc +
arg0`` and added into ``moe_acc [B, d]``) and the combine: the last
expert's ``arg1 = 1`` hands ``moe_acc`` to ALLREDUCE, or, under
``overlap_ar``, A2A_SEND phase 0 parks the first half's sum in ``a2buf``
and restarts ``moe_acc``, phase 1 parks the rest in ``cbuf`` and A2A_WAIT
folds ``acc = x; acc = acc + a2buf[r] + cbuf[r]`` for every rank r in
order (the JAX body's interleaved order; at tp=1 ``x + a2buf + cbuf``).
An expert whose combine weight is 0 for every row is skipped: its terms
are exactly 0.

Under ``dims.trace`` every (step, task) writes a ``[task_id, opcode,
layer, arg0, begin, end, mid, flag]`` record (``task.TR_*``) on a
logical clock: one tick at every begin, ALLREDUCE's mid and every end,
counted across the launch's steps, as the JAX kernel's ``trace_tick``
does under interpret. So the plain ring equals the JAX ring bit for
bit; the CUDA kernel stamps ``clock64()`` ticks instead.
"""

from __future__ import annotations

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel.registry import register_task
from triton_distributed_tpu_torch.megakernel.task import (
    TR_BEGIN,
    TR_END,
    TR_FLAG,
    TR_LAYER,
    TR_MID,
    TR_OPCODE,
    TR_SLOT,
    TR_TASK_ID,
    TRACE_INTS,
    TaskType,
)
from triton_distributed_tpu_torch.models.sampling import filtered_winner_plain
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    pages_to_dense,
    scales_to_dense,
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
                 kv_len, tokens, stop_tok, inv_freq, k_scale=None,
                 v_scale=None, noise=None, sampcfg=None, ring_state=None,
                 x0=None, n_tasks: int = 0, gate_hook=None, moe_route=None,
                 moe_x=None):
        B, d = dims.batch, dims.d
        dev = kv_len.device
        self.dims, self.fuse_norms, self.w = dims, fuse_norms, weights
        self.mdtype = weights.embed.dtype  # the model (compute) dtype
        self.kc, self.vc, self.page_table = kc, vc, page_table
        self.k_scale, self.v_scale = k_scale, v_scale
        self.noise, self.sampcfg = noise, sampcfg
        self.ring_state, self.x0 = ring_state, x0
        self.kv_len = kv_len.long()
        self.stop_tok = stop_tok
        self.inv_freq = inv_freq.to(dev, torch.float32)
        self.step = 0
        self.t = 0  # the task's position in the table
        # The trace ring [NS, T, 8] (host int32) and its logical clock.
        self.ring = (np.zeros((dims.nsteps, n_tasks, TRACE_INTS), np.int32)
                     if dims.trace else None)
        self.clk = 0
        f32 = dict(dtype=torch.float32, device=dev)
        self.x = torch.zeros((B, d), **f32)
        self.h = torch.zeros((B, d), **f32)
        self.qkv = torch.zeros((B, dims.qkv_loc), **f32)
        self.ao = torch.zeros((B, dims.o_k), **f32)
        self.mlp = torch.zeros((B, dims.f_loc), **f32)
        if dims.moe:
            self.moe_w = torch.zeros((dims.num_experts, B), **f32)
            self.moe_acc = torch.zeros((B, d), **f32)
            self.a2buf = torch.zeros((B, d), **f32)
            self.cbuf = torch.zeros((B, d), **f32)
        self.arg1 = 0  # the running task's header arg1
        # Cross-rank state (tp > 1: ``mega_decode_plain_tp`` sets it): this
        # rank's index, the lockstep group of every rank's state, its real
        # vocab columns, AR_SEND's staged partial, the LM head's (value,
        # global index) candidate, and the dropped partial of a negative
        # control (``_drops``).
        self.rank, self.group = 0, [self]
        self.v_real = rank_v_real(dims, 0)
        self.sent = self.cand = self.drop = None
        self.gate_hook = gate_hook
        self.moe_route, self.moe_x = moe_route, moe_x
        self.tok = tokens.long()
        NS, L, hkv, hd = dims.nsteps, dims.num_layers, dims.hkv_loc, \
            dims.head_dim
        # Prefill writes one row per prompt position, [L, hkv, S, hd].
        rows = (L, hkv, B, hd) if dims.prefill else (NS, L, B, hkv, hd)
        self.logits = torch.zeros((1 if dims.prefill else B, dims.v_loc),
                                  **f32)
        self.knew = torch.zeros(rows, dtype=self.mdtype, device=dev)
        self.vnew = torch.zeros(rows, dtype=self.mdtype, device=dev)
        self.toks = torch.zeros((NS, B), dtype=torch.int32, device=dev)
        self.stop_step = torch.full((B,), NS, dtype=torch.int32, device=dev)


def _tick(st: MegaState) -> int:
    """One read of the logical trace clock."""
    st.clk += 1
    return st.clk


def _trace_mid(st: MegaState, value: int | None = None) -> None:
    """Stamp the current task's ``mid`` column: a clock tick, or
    ``value`` (RING_POLL's observed doorbell). A no-op untraced."""
    if st.ring is not None:
        st.ring[st.step, st.t, TR_MID] = _tick(st) if value is None else value


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMS-norm, ``x * rsqrt(mean(x²) + eps) * w``."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * w.to(torch.float32)


def _gemm(st: MegaState, x_f32: torch.Tensor, w: torch.Tensor,
          scale: torch.Tensor | None):
    """``x [B, K] @ w [K, N]``: the input rounds to the model dtype, the
    products accumulate in f32 (the JAX kernel's streamed GEMMs); under
    ``wq8`` the f32 product times the per-column ``scale [1, N]``."""
    out = x_f32.to(st.mdtype).to(torch.float32) @ w.to(torch.float32)
    return out if scale is None else out * scale


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
    st.qkv = _gemm(st, _normed_input(st, layer, 0), st.w.wqkv[layer],
                   _layer_scale(st.w.sc_qkv, layer))


def _layer_scale(sc, layer: int):
    """A per-layer ``[L, 1, N]`` scale plane's ``[1, N]`` row (None
    without ``wq8``)."""
    return None if sc is None else sc[layer]


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
    if st.k_scale is not None:  # int8 pool: dequantize per page and head
        page = st.kc.shape[3]
        kc = kc.to(torch.float32) * scales_to_dense(
            st.k_scale[layer], st.page_table, page)[..., None]
        vc = vc.to(torch.float32) * scales_to_dense(
            st.v_scale[layer], st.page_table, page)[..., None]
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
    st.h = _gemm(st, st.ao, st.w.wo[layer],
                 _layer_scale(st.w.sc_o, layer))


@register_task(TaskType.FC1)
def fc1_body(st: MegaState, layer: int, arg0: int) -> None:
    """silu(h @ gate) · (h @ up) over the fused ``[d, gate | up]``
    weight."""
    gu = _gemm(st, _normed_input(st, layer, 1), st.w.w1[layer],
               _layer_scale(st.w.sc_w1, layer))
    gate, up = gu[:, : st.dims.f_loc], gu[:, st.dims.f_loc:]
    st.mlp = gate * torch.sigmoid(gate) * up


@register_task(TaskType.FC2)
def fc2_body(st: MegaState, layer: int, arg0: int) -> None:
    st.h = _gemm(st, st.mlp, st.w.w2[layer],
                 _layer_scale(st.w.sc_w2, layer))


def _drops(st: MegaState, layer: int, r: int, phase=None) -> bool:
    """Whether the negative control ``st.drop`` leaves rank r's partial out
    of this exchange: ``(layer, r)`` drops it from every exchange of that
    layer (ALLREDUCE, AR_WAIT and both A2A phases), ``(layer, r, phase)``
    from that A2A phase (0 or 1) only."""
    d = st.drop
    return (d is not None and tuple(d[:2]) == (layer, r)
            and (len(d) == 2 or d[2] == phase))


def _fold(st: MegaState, layer: int, parts: list) -> torch.Tensor:
    """``x + parts[0] + ... + parts[n-1]``, in rank order in f32 (the JAX
    bodies' ``acc += cbuf[r]``), so every rank folds to the same bits;
    at tp=1 ``x + h``. ``st.drop`` (:func:`_drops`) leaves a rank's
    partial out (a negative control)."""
    acc = st.x
    for r, part in enumerate(parts):
        if not _drops(st, layer, r):
            acc = acc + part
    return acc


@register_task(TaskType.ALLREDUCE)
def allreduce_body(st: MegaState, layer: int, arg0: int) -> None:
    """``x += psum(h)``: every rank's ``h`` (the lockstep group's, each
    rank's task already run) folded in rank order; at tp=1 the psum is
    ``h`` itself. The trace's phase mark falls between the exchange and
    the fold, as in the JAX body."""
    _trace_mid(st)
    st.x = _fold(st, layer, [g.h for g in st.group])


@register_task(TaskType.AR_SEND)
def ar_send_body(st: MegaState, layer: int, arg0: int) -> None:
    """The split all-reduce's send (``overlap_ar``, tp > 1): stage ``h``
    as this rank's partial, then the phase mark (the puts in flight)."""
    st.sent = st.h
    _trace_mid(st)


@register_task(TaskType.AR_WAIT)
def ar_wait_body(st: MegaState, layer: int, arg0: int) -> None:
    """The split all-reduce's wait: the phase mark (where the JAX body
    has fired the next weight stream's tile 0; the CUDA kernel has no
    such prefetch), then ``x`` plus every rank's staged partial in rank
    order."""
    _trace_mid(st)
    st.x = _fold(st, layer, [g.sent for g in st.group])


@register_task(TaskType.BARRIER)
def barrier_body(st: MegaState, layer: int, arg0: int) -> None:
    """The cross-rank barrier: the lockstep walk runs every rank's task
    before the next, so there is nothing to wait for."""


@register_task(TaskType.MOE_GATE)
def moe_gate_body(st: MegaState, layer: int, arg0: int) -> None:
    """Router: f32 logits of the normed input (the NORM task's ``h``, or
    under fused norms ``x`` normed inline and left in ``h`` for the
    experts), softmax over the experts, the top ``k`` by a stable
    descending sort (the JAX body's max-and-retire loop: ties to the
    lowest expert index), renormalised under ``norm_topk``, into the
    combine weights ``moe_w [E, B]`` (0 where unrouted); ``moe_acc``
    restarts at 0."""
    dims = st.dims
    if st.gate_hook is not None:
        st.gate_hook.enter(st, layer)
    if st.moe_route is not None:
        st.moe_x[st.step, layer] = st.x
    h_in = _normed_input(st, layer, 1)
    if st.fuse_norms:
        st.h = h_in
    logits = h_in @ st.w.wrouter[layer].to(torch.float32)  # [B, E]
    p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    p = p / p.sum(dim=-1, keepdim=True)
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    cw = torch.zeros_like(p).scatter_(1, idx[:, :dims.moe_top_k],
                                      vals[:, :dims.moe_top_k])
    if dims.norm_topk:
        cw = cw / cw.sum(dim=-1, keepdim=True)
    if st.gate_hook is not None:
        cw = st.gate_hook.route(st.step, layer, p, cw)
    st.moe_w = cw.T.contiguous()
    if st.moe_route is not None:
        st.moe_route[st.step, layer] = st.moe_w
    st.moe_acc = torch.zeros_like(st.moe_acc)


@register_task(TaskType.MOE_FFN)
def moe_ffn_body(st: MegaState, layer: int, arg0: int) -> None:
    """Local expert ``arg0``'s SwiGLU FFN over every row of the normed
    ``h`` (this rank's ``w1``/``w2`` row ``arg0``), FC2's f32 sums times
    each row's combine weight of the global expert ``rank·E_loc + arg0``
    added into ``moe_acc``; skipped when no row routes to it (its terms
    are 0). ``arg1 = 1`` (the last expert without ``overlap_ar``) then
    hands ``moe_acc`` to the ALLREDUCE task through ``h``."""
    cw = st.moe_w[st.rank * st.dims.experts_loc + arg0]  # [B]
    if bool((cw != 0).any()):
        gu = _gemm(st, st.h, st.w.w1[layer, arg0], None)
        gate, up = gu[:, : st.dims.f_loc], gu[:, st.dims.f_loc:]
        st.mlp = gate * torch.sigmoid(gate) * up
        y = _gemm(st, st.mlp, st.w.w2[layer, arg0], None)
        st.moe_acc = st.moe_acc + y * cw[:, None]
    if st.arg1 == 1:
        st.h = st.moe_acc.clone()


@register_task(TaskType.A2A_SEND)
def a2a_send_body(st: MegaState, layer: int, arg0: int) -> None:
    """The split combine's send: phase 0 stages this rank's partial over
    its first half of the local experts in ``a2buf`` and restarts
    ``moe_acc``; phase 1 stages the rest in ``cbuf`` (the JAX body's puts
    of each to every peer: the lockstep walk's peers read them from the
    group). The trace's phase mark follows, as in the JAX body."""
    if arg0 == 0:
        st.a2buf = st.moe_acc.clone()
        st.moe_acc = torch.zeros_like(st.moe_acc)
    else:
        st.cbuf = st.moe_acc.clone()
    _trace_mid(st)


@register_task(TaskType.A2A_WAIT)
def a2a_wait_body(st: MegaState, layer: int, arg0: int) -> None:
    """The split combine's wait: the phase mark (where the JAX body has
    fired the next weight stream's tile 0; the CUDA kernel has no such
    prefetch), then ``acc = x; acc = acc + a2buf[r] + cbuf[r]`` for every
    rank r in order, the JAX body's fold (at tp=1 ``x + a2buf + cbuf``)."""
    _trace_mid(st)
    acc = st.x
    for r, g in enumerate(st.group):
        if not _drops(st, layer, r, 0):
            acc = acc + g.a2buf
        if not _drops(st, layer, r, 1):
            acc = acc + g.cbuf
    st.x = acc


@register_task(TaskType.RING_POLL)
def ring_poll_body(st: MegaState, layer: int, arg0: int) -> None:
    """Stamp the published work-ring doorbell (``ring_state[0]``) into
    this task's trace record: the proof that the round ran against the
    ring state the host published for it."""
    if st.ring_state is not None:
        _trace_mid(st, int(st.ring_state[0]))


@register_task(TaskType.LOAD_X)
def load_x_body(st: MegaState, layer: int, arg0: int) -> None:
    """Prefill entry: ``x <- x0``, the embedded prompt rows (gathered by
    the caller, as the JAX package gathers outside the kernel)."""
    st.x = st.x0.to(torch.float32)


@register_task(TaskType.ATTN_PREFILL)
def attn_prefill_body(st: MegaState, layer: int, arg0: int) -> None:
    """Causal self-attention over the S prompt rows: per kv head, K =
    rope(headnorm(k)) at positions 0..S-1 in f32, written to ``knew``
    (``vnew`` the V rows) in the model dtype; per q head one causal
    softmax over the S rows with the f32 K and V, not the rounded
    copies (the JAX body scores with its f32 ``kh``)."""
    dims = st.dims
    S, hq, hkv, hd = dims.batch, dims.hq_loc, dims.hkv_loc, dims.head_dim
    g = hq // hkv
    eps = dims.rms_eps
    qkv = st.qkv
    pos = torch.arange(S, device=qkv.device, dtype=torch.float32)
    ang = pos[:, None] * st.inv_freq[None, :]  # [S, hd]: row r at pos r

    def heads(c0, n):  # [n, S, hd]
        return qkv[:, c0 * hd:(c0 + n) * hd].reshape(S, n, hd).transpose(
            0, 1)

    q = _rope(_headnorm(heads(0, hq), st.w.qn[layer], eps), ang) * hd ** -0.5
    k = _rope(_headnorm(heads(hq, hkv), st.w.kn[layer], eps), ang)
    v = heads(hq + hkv, hkv)
    st.knew[layer] = k.to(st.knew.dtype)
    st.vnew[layer] = v.to(st.vnew.dtype)
    s = torch.einsum("hgqd,hkd->hgqk", q.reshape(hkv, g, S, hd), k)
    idx = torch.arange(S, device=qkv.device)
    s = torch.where(idx[None, :] <= idx[:, None], s, -1e30)
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    o = torch.einsum("hgqk,hkd->hgqd", p, v) / p.sum(dim=-1, keepdim=True)
    st.ao = o.reshape(hq, S, hd).transpose(0, 1).reshape(S, hq * hd)


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


def rank_v_real(dims, r: int) -> int:
    """Rank ``r``'s real (unpadded) vocab columns: ``clip(V - r·v_loc, 0,
    v_loc)`` with V the real vocab (``v_real``, or every column), the JAX
    LM head's ``v_real`` at tp > 1; at tp=1 ``min(v_real, v_loc)``."""
    total = dims.v_real or dims.n_ranks * dims.v_loc
    return min(max(total - r * dims.v_loc, 0), dims.v_loc)


def takes_argmax(dims) -> bool:
    """Multi-step builds (``nsteps > 1``, or any build that names its real
    vocab, as ``build_multi`` does even at ``nsteps = 1``) take the argmax
    in the LM head; single-step builds leave it to the host."""
    return dims.nsteps > 1 or dims.v_real > 0


@register_task(TaskType.LM_HEAD)
def lm_head_body(st: MegaState, layer: int, arg0: int) -> None:
    """Logits over the padded vocab; in multi-step builds the argmax over
    the real columns (``< v_real``: the zero pad columns would beat
    negative logits), first occurrence on ties, feeds the next step.
    ``sampled`` adds this step's noise to the argmax's scores (not to
    the logits); ``filtered`` takes the winner over each row's keep-set
    once the whole row has landed."""
    dims = st.dims
    x_in = _normed_input(st, layer, 2)
    if dims.prefill:  # only the last real prompt row, kv_len[0] - 1
        x_in = x_in.index_select(0, st.kv_len[:1] - 1)
    st.logits = _gemm(st, x_in, st.w.lm_head, st.w.sc_lm)
    if takes_argmax(dims):
        v_real = st.v_real
        if dims.filtered:
            _multi_step_tail(st, filtered_winner_plain(
                st.logits, st.noise[st.step], st.sampcfg, v_real))
            return
        score = (st.logits + st.noise[st.step] if dims.sampled
                 else st.logits)
        cols = torch.arange(dims.v_loc, device=st.logits.device)
        masked = torch.where(cols[None, :] < v_real, score,
                             float("-inf"))
        best = masked.max(dim=-1, keepdim=True).values
        first = torch.where(masked == best, cols[None, :],
                            dims.v_loc).min(dim=-1).values
        if len(st.group) > 1:  # the cross-rank exchange follows
            st.cand = (best[:, 0], first + st.rank * dims.v_loc)
            return
        _multi_step_tail(st, first)


def _lm_exchange(states: list) -> None:
    """The LM head's cross-rank argmax (tp > 1, after every rank's LM head
    ran): the ranks' (value, global index) candidates reduced in rank
    order with a strict ``>``, so a tie goes to the lower rank (its
    indices are the lower ones: the first occurrence), as the JAX body
    reduces them; every rank takes the same winner."""
    bv, bi = states[0].cand
    for st in states[1:]:
        v, i = st.cand
        upd = v > bv
        bv, bi = torch.where(upd, v, bv), torch.where(upd, i, bi)
    for st in states:
        _multi_step_tail(st, bi)


def mega_decode_plain(dims, fuse_norms: bool, table: np.ndarray, weights,
                      kc, vc, page_table, kv_len, tokens, stop_tok=None,
                      inv_freq=None, k_scale=None, v_scale=None, noise=None,
                      sampcfg=None, ring_state=None, gate_hook=None,
                      moe_route=None, moe_x=None):
    """Walk the packed ``table [T, 8]`` for ``dims.nsteps`` steps over one
    :class:`MegaState`. Returns ``(logits [B, v_loc] f32 of the last
    step, knew, vnew [NS, L, B, hkv, hd] in the model dtype, toks [NS, B]
    int32, stop_step [B] int32)``; ``k_scale``/``v_scale [L, P, Hkv]``
    are an int8 pool's scales (None for a full-width cache); ``noise
    [NS, B, v_loc]`` f32 (``sampled``) and ``sampcfg [B, 4]`` f32
    (``filtered``) steer the argmax; ``toks`` is zeros in single-step
    builds (the host takes the argmax of the logits) and ``stop_step``
    all ``nsteps`` without ``eos``. Under ``dims.ring`` the RING_POLL
    task reads ``ring_state [4]`` int32 (``WorkRing.publish``); under
    ``dims.trace`` the trace ring ``[NS, T, 8]`` int32 is returned
    sixth. ``gate_hook`` (optional) is a check's window on each MOE_GATE:
    its ``enter(st, layer)`` runs first (it may read and replace the
    residual ``st.x``) and its ``route(step, layer, probs [B, E], cw [B,
    E]) -> cw`` after the routing (it returns the combine weights to use,
    and may plant a fault there). ``moe_route [NS, L, E, B]`` and ``moe_x
    [NS, L, B, d]`` f32 (optional, together) receive every gate's combine
    weights and the residual rows it read, as the kernel's."""
    if inv_freq is None:
        inv_freq = rope_inv_freq(dims.head_dim, dims.rope_theta,
                                 kv_len.device)
    table = np.asarray(table)
    st = MegaState(dims, fuse_norms, weights, kc, vc, page_table, kv_len,
                   tokens, stop_tok, inv_freq, k_scale, v_scale, noise,
                   sampcfg, ring_state, n_tasks=len(table),
                   gate_hook=gate_hook, moe_route=moe_route,
                   moe_x=moe_x)
    _walk([st], table)
    out = (st.logits, st.knew, st.vnew, st.toks, st.stop_step)
    if dims.trace:
        out += (torch.from_numpy(st.ring).to(kv_len.device),)
    return out


def mega_decode_plain_tp(dims, fuse_norms: bool, table: np.ndarray,
                         weights: list, kc: list, vc: list, page_table,
                         kv_len, tokens, stop_tok=None, inv_freq=None,
                         ring_state=None, drop_partial=None,
                         info: dict | None = None, gate_hook=None,
                         moe_route=None, moe_x=None):
    """The plain version of a decode graph over ``dims.n_ranks = n``
    ranks: one :class:`MegaState` a rank (its weight shards ``weights[r]``
    (an MoE graph's: its E/n experts, expert-parallel) and cache shard
    ``kc[r]``, ``vc[r]``; the page table, ``kv_len``, ``tokens``,
    ``stop_tok`` and ``ring_state`` shared), walked in lockstep task by
    task, so every exchange is a plain sum over the ranks' partials in
    rank order and the LM head's argmax a reduction over the ranks'
    candidates. Returns ``(logits [B, n·v_loc] f32, knew, vnew [n, NS, L,
    B, hkv, hd], toks [NS, B], stop_step [B])`` and, under ``dims.trace``,
    the rings ``[n, NS, T, 8]`` (one logical clock a rank); ``info``
    (optional) receives each rank's ``toks``, ``stop_step`` and final
    ``x`` (stacked on a rank axis). ``drop_partial`` ``(layer, r)`` leaves
    rank r's partial out of that layer's exchanges on every rank, ``(layer,
    r, phase)`` only its A2A partial of that phase (negative controls).
    An MoE graph takes ``mega_decode_plain``'s ``gate_hook`` (called on
    every rank's state) and ``moe_route [n, NS, L, E, B]`` / ``moe_x [n,
    NS, L, B, d]`` (each rank's records)."""
    n = dims.n_ranks
    if inv_freq is None:
        inv_freq = rope_inv_freq(dims.head_dim, dims.rope_theta,
                                 kv_len.device)
    table = np.asarray(table)
    states = [MegaState(dims, fuse_norms, weights[r], kc[r], vc[r],
                        page_table, kv_len, tokens, stop_tok, inv_freq,
                        ring_state=ring_state, n_tasks=len(table),
                        gate_hook=gate_hook,
                        moe_route=None if moe_route is None else moe_route[r],
                        moe_x=None if moe_x is None else moe_x[r])
              for r in range(n)]
    for r, st in enumerate(states):
        st.rank, st.group, st.drop = r, states, drop_partial
        st.v_real = rank_v_real(dims, r)
    _walk(states, table)
    if info is not None:
        info.update({k: torch.stack([getattr(st, k) for st in states])
                     for k in ("toks", "stop_step", "x")})
    out = (torch.cat([st.logits for st in states], dim=1),
           torch.stack([st.knew for st in states]),
           torch.stack([st.vnew for st in states]), states[0].toks,
           states[0].stop_step)
    if dims.trace:
        out += (torch.from_numpy(np.stack([st.ring for st in states])).to(
            kv_len.device),)
    return out


def _walk(states: list, table: np.ndarray) -> None:
    """Run the table's bodies for ``dims.nsteps`` steps over the ranks'
    states in lockstep (each task on every rank before the next task);
    under ``dims.trace`` stamp each task's record: header columns, then
    begin, the body (which may stamp mid), end and flag. At tp > 1 a
    multi-step LM head is followed by the cross-rank argmax."""
    from triton_distributed_tpu_torch.megakernel.registry import get_body

    bodies = [(get_body(TaskType(int(r[0]))), int(r[1]), int(r[2]),
               int(r[3])) for r in table]
    dims = states[0].dims
    exchange = len(states) > 1 and takes_argmax(dims)
    for step in range(dims.nsteps):
        for t, (body, layer, arg0, arg1) in enumerate(bodies):
            for st in states:
                st.step, st.t, st.arg1 = step, t, arg1
                ring = st.ring
                if ring is None:
                    body(st, layer, arg0)
                    continue
                rec = ring[step, t]
                rec[TR_TASK_ID] = table[t, 4]
                rec[TR_OPCODE] = table[t, 0]
                rec[TR_LAYER] = layer
                rec[TR_SLOT] = arg0
                rec[TR_BEGIN] = _tick(st)
                body(st, layer, arg0)
                rec[TR_END] = _tick(st)
                rec[TR_FLAG] = 1
            if exchange and int(table[t, 0]) == TaskType.LM_HEAD:
                _lm_exchange(states)


def mega_prefill_plain(dims, fuse_norms: bool, table: np.ndarray, weights,
                       x0: torch.Tensor, true_len: torch.Tensor,
                       inv_freq=None):
    """Walk the prefill ``table`` once over the S prompt rows ``x0 [S, d]``
    (the embedded prompt, model dtype). ``true_len`` ``[1]`` int32 is the
    real prompt length. Returns ``(logits [1, v_loc] f32 of row
    true_len - 1, knew, vnew [L, hkv, S, hd] in the model dtype)``."""
    if inv_freq is None:
        inv_freq = rope_inv_freq(dims.head_dim, dims.rope_theta, x0.device)
    st = MegaState(dims, fuse_norms, weights, None, None, None, true_len,
                   torch.zeros(1, dtype=torch.int32, device=x0.device), None,
                   inv_freq, x0=x0)
    _walk([st], np.asarray(table))
    return st.logits, st.knew, st.vnew


def mega_prefill_plain_tp(dims, fuse_norms: bool, table: np.ndarray,
                          weights: list, x0: torch.Tensor,
                          true_len: torch.Tensor, inv_freq=None,
                          drop_partial=None, info: dict | None = None):
    """The prefill ``table`` over ``dims.n_ranks = n`` ranks: one state a
    rank (its weight shards ``weights[r]``; the embedded prompt ``x0 [S,
    d]`` and ``true_len`` shared) walked in lockstep, each ALLREDUCE the
    ranks' ``[S, d]`` f32 partials folded in rank order. Returns
    ``(logits [1, n·v_loc] f32 of row true_len - 1 (rank r's columns from
    r·v_loc), knew, vnew [n, L, hkv, S, hd])``; ``drop_partial = (layer,
    r)`` and ``info`` (each rank's final ``x [n, S, d]``) as in
    :func:`mega_decode_plain_tp`."""
    n = dims.n_ranks
    if inv_freq is None:
        inv_freq = rope_inv_freq(dims.head_dim, dims.rope_theta, x0.device)
    states = [MegaState(dims, fuse_norms, weights[r], None, None, None,
                        true_len, torch.zeros(1, dtype=torch.int32,
                                              device=x0.device), None,
                        inv_freq, x0=x0) for r in range(n)]
    for r, st in enumerate(states):
        st.rank, st.group, st.drop = r, states, drop_partial
    _walk(states, np.asarray(table))
    if info is not None:
        info["x"] = torch.stack([st.x for st in states])
    return (torch.cat([st.logits for st in states], dim=1),
            torch.stack([st.knew for st in states]),
            torch.stack([st.vnew for st in states]))
