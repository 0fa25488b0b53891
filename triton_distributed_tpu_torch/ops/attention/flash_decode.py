"""GQA decode attention: dense and paged, plus their plain versions.

Counterpart of ``triton_distributed_tpu/ops/attention/flash_decode.py``.
:func:`flash_decode` (dense ``[B, Hkv, S, D]`` cache in ``chunk_k``
chunks) and :func:`paged_flash_decode` (page pool through a page table)
launch the hand-written kernel of ``csrc/flash_decode.cu`` on a CUDA
tensor or raise; on a CPU tensor they run :func:`gqa_decode_reference`
(over :func:`pages_to_dense` for the paged form), the plain version.
The kernel computes the TPU kernel's per-chunk (O, LSE) partials and
merges them with :func:`lse_combine`'s arithmetic in a second kernel.

:func:`paged_flash_decode` with ``k_scale``/``v_scale`` reads an int8
pool (``paged_flash_decode_int8``: per-page scales folded in after QK^T
and after P·V); its plain version dequantizes through the table with
:func:`scales_to_dense`. :func:`flash_decode` with ``k_scale``/``v_scale``
reads int8 codes with one scale per ``chunk_k`` keys per kv head
(``flash_decode_int8``: the cold partial of a sharded long-context
slot's decode over an int8 pool); its plain version dequantizes with the
scales repeated ``chunk_k`` times. A sequence with ``kv_len <= 0``
attends nothing: O = 0 and LSE ~ -1e30 (weight 0 in
:func:`lse_combine`), as the TPU kernel's skipped chunks give.

:func:`distributed_flash_decode` (``flash_decode.py:424``) runs the
decode over a cache sequence-sharded over the context's ranks: each rank
attends its slice (this module's kernels), then the partial (O, LSE) are
gathered and merged by :func:`lse_combine` (:func:`_gather_merge`,
``:404``): ``method="pallas"`` packs them into one ``[B*Hq, D+1]`` f32
row a head and gathers it with the all-gather AUTO (the hand-written
all-gather kernels on the card, rows of any byte width), ``"xla"``
stacks the ranks' partials. A rank with no local key for a row gives
O = 0, LSE ~ -1e30: weight 0 in the merge (its all-masked guard).
:func:`distributed_flash_decode_2level` (``:467``) merges within each dp
group of a ``dp x tp`` context first, then across the groups (plain).
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives.all_gather import (
    all_gather,
)

_NEG_INF = -1e30
# The (head_dim, q/kv group) values of the presets (tiny; Qwen3 0.6B-32B):
# each is a template instance of the kernel.
HEAD_DIMS = (32, 128)
GROUPS = (2, 4, 8)
MAX_CHUNK = 256


def lse_combine(o_parts: torch.Tensor, lse_parts: torch.Tensor,
                part_axis: int = 0):
    """Merge partial attention outputs by log-sum-exp weighting.
    ``o_parts [..., P, ..., d]`` f32 with partials on ``part_axis``;
    ``lse_parts`` matching without d. Returns (o, lse) reduced over P."""
    m = torch.amax(lse_parts, dim=part_axis, keepdim=True)
    m = torch.clamp(m, min=_NEG_INF)  # all-masked guard
    w = torch.exp(lse_parts - m)
    den = torch.sum(w, dim=part_axis)
    o = torch.sum(o_parts * w[..., None], dim=part_axis) / torch.clamp(
        den[..., None], min=1e-30
    )
    lse = torch.squeeze(m, part_axis) + torch.log(torch.clamp(den, min=1e-30))
    return o, lse


def _check_decode_operands(name, q, k, v, kv_len, chunk, extra=(),
                           kv_dtype=None):
    """The checks every decode launch makes; K/V have q's dtype unless
    ``kv_dtype`` says otherwise (int8 codes)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in ck.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not f32/bf16")
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    ck.check_cuda_operand("q", q, q.device, q.dtype, 3)
    ck.check_cuda_operand("k", k, q.device, kv_dtype, 4)
    ck.check_cuda_operand("v", v, q.device, kv_dtype, 4)
    ck.check_cuda_operand("kv_len", kv_len, q.device, torch.int32, 1)
    for ename, t in extra:
        ck.check_cuda_operand(ename, t, q.device, torch.int32, 2)
    if v.shape != k.shape or k.shape[3] != d or kv_len.shape[0] != b:
        raise ValueError(f"{name}: shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} kv_len{tuple(kv_len.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv not in GROUPS:
        raise ValueError(f"{name}: q/kv head ratio {hq}/{hkv} not in "
                         f"{GROUPS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} not in [1, {MAX_CHUNK}]")


def _decode_buffers(q, hkv: int, n_chunks: int, return_lse: bool):
    """Output, optional LSE, and the kernel's per-chunk partial scratch
    (``[B*Hkv, n_chunks, group, D]`` O and ``[B*Hkv, n_chunks, group]``
    LSE, f32)."""
    b, hq, d = q.shape
    dev = q.device
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=dev)
           if return_lse else None)
    o_part = torch.empty((b * hkv, n_chunks, hq // hkv, d),
                         dtype=torch.float32, device=dev)
    lse_part = torch.empty((b * hkv, n_chunks, hq // hkv),
                           dtype=torch.float32, device=dev)
    return o, lse, o_part, lse_part


def _as_lengths(kv_len, b: int, device) -> torch.Tensor:
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(kv_len, (b,)).contiguous()


def flash_decode(
    q: torch.Tensor,        # [B, Hq, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,  # [B, Hkv, S, D]
    kv_len,                 # [B] int32 — valid context length per sequence
    *,
    sm_scale: float | None = None,
    chunk_k: int = 256,
    return_lse: bool = False,
    k_scale: torch.Tensor | None = None,  # [B, Hkv, S/chunk_k] f32
    v_scale: torch.Tensor | None = None,
):
    """Single-token GQA decode attention over a (padded) dense cache.
    Returns ``o [B, Hq, D]`` (q.dtype) and, with ``return_lse``,
    ``lse [B, Hq]`` f32. With ``k_scale``/``v_scale`` the caches hold
    int8 codes and each ``chunk_k`` block of keys has its own scale."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if sm_scale is None:
        sm_scale = d**-0.5
    chunk_k = min(chunk_k, s)
    if s % chunk_k:
        raise ValueError(f"cache len {s} not divisible by chunk_k {chunk_k}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if quant and tuple(sc.shape) != (b, hkv, s // chunk_k):
            raise ValueError(
                f"{name} shape {tuple(sc.shape)} != per-chunk layout "
                f"{(b, hkv, s // chunk_k)} (chunk_k={chunk_k})"
            )
    kv_len = _as_lengths(kv_len, b, q.device)
    if q.device.type == "cpu":
        if quant:
            k_cache = k_cache.to(torch.float32) * k_scale.repeat_interleave(
                chunk_k, dim=-1)[..., None]
            v_cache = v_cache.to(torch.float32) * v_scale.repeat_interleave(
                chunk_k, dim=-1)[..., None]
        return gqa_decode_reference(q, k_cache, v_cache, kv_len,
                                    sm_scale=sm_scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check_decode_operands("flash_decode", q, k_cache, v_cache, kv_len,
                           chunk_k, kv_dtype=torch.int8 if quant else None)
    o, lse, o_part, lse_part = _decode_buffers(q, hkv, s // chunk_k,
                                               return_lse)
    ptrs = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()]
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            ck.check_cuda_operand(name, sc, q.device, torch.float32, 3)
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    kernel = ck.FLASH_DECODE_INT8 if quant else ck.FLASH_DECODE
    kernel(
        *ptrs, kv_len.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        o_part.data_ptr(), lse_part.data_ptr(),
        b, hkv, hq // hkv, d, chunk_k, s // chunk_k, float(sm_scale),
        ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
    )
    return (o, lse) if return_lse else o


def paged_flash_decode(
    q: torch.Tensor,           # [B, Hq, D]
    k_pages: torch.Tensor,     # [P, Hkv, page, D] — page pool (one layer)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, pages_per_seq] int32
    kv_len,                    # [B] int32 — valid context length
    *,
    sm_scale: float | None = None,
    return_lse: bool = False,
    k_scale: torch.Tensor | None = None,  # [P, Hkv] f32 — int8 pool scales
    v_scale: torch.Tensor | None = None,
):
    """Single-token GQA decode attention straight over a paged KV pool:
    block ``ci`` of sequence ``b`` is pool page ``page_table[b, ci]``, and
    no dense gather materializes on the kernel path. With
    ``k_scale``/``v_scale`` the pools hold int8 codes and each page's
    scale is read through the same table entry as the page."""
    b, hq, d = q.shape
    p, hkv, page, _ = k_pages.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if sm_scale is None:
        sm_scale = d**-0.5
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if quant and tuple(sc.shape) != (p, hkv):
            raise ValueError(
                f"{name} shape {tuple(sc.shape)} != per-page layout "
                f"{(p, hkv)}"
            )
    kv_len = _as_lengths(kv_len, b, q.device)
    if q.device.type == "cpu":
        k_d = pages_to_dense(k_pages, page_table)
        v_d = pages_to_dense(v_pages, page_table)
        if quant:
            k_d = k_d.to(torch.float32) * scales_to_dense(
                k_scale, page_table, page)[..., None]
            v_d = v_d.to(torch.float32) * scales_to_dense(
                v_scale, page_table, page)[..., None]
        return gqa_decode_reference(q, k_d, v_d, kv_len, sm_scale=sm_scale,
                                    return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    _check_decode_operands("paged_flash_decode", q, k_pages, v_pages, kv_len,
                           page, extra=(("page_table", page_table),),
                           kv_dtype=torch.int8 if quant else None)
    if page_table.shape[0] != b:
        raise ValueError(f"page_table rows {page_table.shape[0]} != batch {b}")
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            ck.check_cuda_operand(name, sc, q.device, torch.float32, 2)
    o, lse, o_part, lse_part = _decode_buffers(q, hkv, page_table.shape[1],
                                               return_lse)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        ptrs += [k_scale.data_ptr(), v_scale.data_ptr()]
    kernel = ck.PAGED_FLASH_DECODE_INT8 if quant else ck.PAGED_FLASH_DECODE
    kernel(
        *ptrs, page_table.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        o_part.data_ptr(), lse_part.data_ptr(),
        b, hkv, hq // hkv, d, page, page_table.shape[1], float(sm_scale),
        ck.DTYPE_CODES[q.dtype], ck.stream_ptr(q),
    )
    return (o, lse) if return_lse else o


def pages_to_dense(pages: torch.Tensor, page_table: torch.Tensor):
    """Gather a page pool ``[..., P, H, page, d]`` into a dense
    ``[..., B, H, S, d]`` view through the table (a copy)."""
    b, pps = page_table.shape
    ax = pages.dim() - 4
    g = torch.index_select(pages, ax, page_table.reshape(-1).long())
    lead = pages.shape[:ax]
    h, page, d = pages.shape[-3:]
    g = g.reshape(*lead, b, pps, h, page, d).transpose(-4, -3)
    return g.reshape(*lead, b, h, pps * page, d)


def scales_to_dense(scales: torch.Tensor, page_table: torch.Tensor,
                    page: int) -> torch.Tensor:
    """Per-position dequant scales matching a :func:`pages_to_dense`
    view: ``[..., P, H] → [..., B, H, S]`` through the table (every
    position of a page shares its page's scale)."""
    b, pps = page_table.shape
    ax = scales.dim() - 2
    g = torch.index_select(scales, ax, page_table.reshape(-1).long())
    g = g.reshape(*scales.shape[:ax], b, pps, scales.shape[-1])
    return g.transpose(-2, -1).repeat_interleave(page, dim=-1)


def gqa_decode_reference(
    q, k_cache, v_cache, kv_len, *, sm_scale=None, return_lse=False
):
    """Plain decode attention in f32 over a dense cache: the plain
    version of every decode kernel. A row with ``kv_len <= 0`` attends
    nothing and gets O = 0 (its LSE stays the all-masked ~-1e30), the
    kernels' and the TPU kernel's result for an empty context."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    if sm_scale is None:
        sm_scale = d**-0.5
    k = k_cache.repeat_interleave(hq // hkv, dim=1).to(torch.float32)
    v = v_cache.repeat_interleave(hq // hkv, dim=1).to(torch.float32)
    s_ = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32), k) * sm_scale
    kv_len = _as_lengths(kv_len, b, q.device)
    mask = torch.arange(s, device=q.device)[None, None, :] < kv_len[:, None,
                                                                     None]
    s_ = torch.where(mask, s_, torch.full_like(s_, _NEG_INF))
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p, v)
    o = torch.where((kv_len > 0)[:, None, None], o,
                    torch.zeros_like(o)).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s_, dim=-1)
    return o


def _gather_merge(os_, lses, ctx, method: str):
    """Gather the ranks' partials ``os_[r] [B, Hq, D]`` f32 and ``lses[r]
    [B, Hq]`` and merge them by log-sum-exp: ``(o, lse)`` lists, one a
    rank. ``pallas`` packs each rank's partials into one ``[B*Hq, D+1]``
    payload for the all-gather AUTO; ``xla`` stacks them."""
    b, hq, d = os_[0].shape
    n = len(os_)
    if method == "pallas":
        flats = [torch.cat([o.reshape(b * hq, d), lse.reshape(b * hq, 1)],
                           dim=1).contiguous() for o, lse in zip(os_, lses)]
        outs = []
        for g in all_gather(flats, ctx):
            g = g.reshape(n, b * hq, d + 1)
            outs.append(lse_combine(g[..., :d].reshape(n, b, hq, d),
                                    g[..., d].reshape(n, b, hq), 0))
        return [o for o, _ in outs], [lse for _, lse in outs]
    if method != "xla":
        raise ValueError(f"unknown merge method {method!r}")
    o, lse = lse_combine(torch.stack(os_), torch.stack(lses), 0)
    return [o] + [o.clone() for _ in os_[1:]], \
        [lse] + [lse.clone() for _ in lses[1:]]


def _local_partials(qs, k_shards, v_shards, kv_len, ranks, *, sm_scale,
                    chunk_k, k_scale, v_scale):
    """Each rank's split-KV partial over its slice: global rank ``ranks[i]``
    covers positions ``[r * s_loc, (r + 1) * s_loc)``."""
    s_loc = k_shards[0].shape[2]
    os_, lses = [], []
    for i, r in enumerate(ranks):
        q = qs[i]
        glob = _as_lengths(kv_len, q.shape[0], q.device)
        local = torch.clamp(glob - r * s_loc, 0, s_loc).to(torch.int32)
        o, lse = flash_decode(
            q, k_shards[i], v_shards[i], local, sm_scale=sm_scale,
            chunk_k=chunk_k, return_lse=True,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i])
        os_.append(o.to(torch.float32))
        lses.append(lse)
    return os_, lses


def distributed_flash_decode(qs, k_shards, v_shards, kv_len, ctx, *,
                             sm_scale: float | None = None,
                             chunk_k: int = 256, method: str = "xla",
                             k_scale=None, v_scale=None):
    """Decode attention over a cache sequence-sharded over the context's
    ranks in rank order: ``qs[r] [B, Hq, D]`` (each rank's copy of the
    replicated q), ``k_shards[r]``/``v_shards[r] [B, Hkv, S_loc, D]``,
    ``kv_len [B]`` int32 GLOBAL lengths;
    ``k_scale[r]``/``v_scale[r] [B, Hkv, S_loc/chunk_k]`` f32 switch the
    local pass to int8 slices. Returns ``[B, Hq, D]`` a rank (q's dtype)."""
    n = ctx.tp
    os_, lses = _local_partials(qs, k_shards, v_shards, kv_len, range(n),
                                sm_scale=sm_scale, chunk_k=chunk_k,
                                k_scale=k_scale, v_scale=v_scale)
    if n == 1:
        return [os_[0].to(qs[0].dtype)]
    merged, _ = _gather_merge(os_, lses, ctx, method)
    return [o.to(qs[0].dtype) for o in merged]


def distributed_flash_decode_2level(qs, k_shards, v_shards, kv_len, ctx, *,
                                    sm_scale: float | None = None,
                                    chunk_k: int = 256, method: str = "xla",
                                    k_scale=None, v_scale=None):
    """The same over a ``dp x tp`` context, the cache sharded in global
    rank order ``d * tp + t`` (one tensor a global rank): the partials
    merge within each dp group (``method``), then once across the groups
    (plain)."""
    tp, dp = ctx.tp, ctx.dp
    if len(qs) != ctx.world:
        raise ValueError(f"q: {len(qs)} tensors for dp x tp = {ctx.world}")
    os_, lses = _local_partials(qs, k_shards, v_shards, kv_len,
                                range(ctx.world), sm_scale=sm_scale,
                                chunk_k=chunk_k, k_scale=k_scale,
                                v_scale=v_scale)
    o_sl, lse_sl = [], []
    for d in range(dp):
        sl = slice(d * tp, (d + 1) * tp)
        if tp == 1:
            o, lse = os_[sl], lses[sl]
        else:
            o, lse = _gather_merge(os_[sl], lses[sl], ctx.group(d), method)
        o_sl += o
        lse_sl += lse
    outs = []
    for r in range(ctx.world):
        t = r % tp
        group = [d * tp + t for d in range(dp)]
        o, _ = lse_combine(torch.stack([o_sl[i] for i in group]),
                           torch.stack([lse_sl[i] for i in group]), 0)
        outs.append(o.to(qs[r].dtype))
    return outs
