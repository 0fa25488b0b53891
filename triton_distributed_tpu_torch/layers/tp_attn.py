"""Attention layer (GQA + RoPE + QK-norm), tensor-parallel over co-located
ranks.

Counterpart of ``triton_distributed_tpu/layers/tp_attn.py``:
``tp_attn_prefill`` (:88-128), ``tp_attn_prefill_paged_chunk`` (:131),
``tp_attn_decode`` (:517-566) and ``tp_attn_decode_paged`` (:568), and at
tp=1 the sharded long-context slot's ``tp_attn_prefill_paged_chunk_cold``
and ``tp_attn_decode_sharded`` (a resident paged partial and a
cold-window partial merged by ``lse_combine``).

At tp=1 a function takes one parameter dict, one activation and one
cache: every head is local, the projections are plain GEMMs and the
collectives drop out. At tp=n it takes one parameter shard, one
activation and one cache (or pool) shard per rank, each rank holding
``hq_loc = hq/n`` query and ``hkv_loc = hkv/n`` KV heads; the per-rank
work (QKV, QK-norm, rope, the KV append and attention over the rank's
own cache shard, through the port's hand-written attention kernels) runs
in a loop over ranks, the body of the JAX ``shard_map``, and the
projections that cross ranks go through the collective seams of
``layers/tp_mlp.py``:

- ``tp_attn_prefill`` (modes ``pallas`` / ``xla``): activations are
  sequence-sharded; QKV is ``ag_gemm`` (xla: all-gather, GEMM), the
  o-proj ``gemm_rs`` (xla: psum-scatter of the f32 partials);
- the chunk and decode functions (``pallas_ar`` / ``xla_ar``, and
  ``pallas`` / ``xla`` alike): activations are replicated, each rank
  holding its own copy; the o-proj is ``gemm_ar`` (xla: the plain psum of
  the rounded partials) and writes every rank's copy.

The JAX functions take a donated cache and return the updated one; here
the KV caches/pools (and an int8 pool's scales) are updated IN PLACE and
still returned, so call sites read alike. The paged functions take an
int8 pool's ``k_scale``/``v_scale`` as the JAX ones do: the writes go
through :func:`quantized_row_scatter` and the attention reads the codes
through the int8 kernels. The chunk path takes the tree-speculation
``rope_pos``/``attn_bias``.

Parameters are a dict per rank ``{"wqkv": [d, (hq_loc + 2*hkv_loc) * hd]
(q | k | v), "wo": [hq_loc * hd, d], "q_norm": [hd], "k_norm": [hd]}``
(norms may be None).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.layers.tp_mlp import (
    check_mode,
    gather_gemm,
    gemm_scatter,
    ranked,
    reduce_ar,
    unranked,
)
from triton_distributed_tpu_torch.ops.attention.flash_attention import (
    flash_attention,
)
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    flash_decode,
    lse_combine,
    paged_flash_decode,
    pages_to_dense,
)
from triton_distributed_tpu_torch.ops.attention.rope import apply_rope


def _rms_head(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6):
    if scale is None:
        return x
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.to(torch.float32)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TPAttnDims:
    """Static head geometry (at tp=1 the local shard is every head)."""

    hq_loc: int
    hkv_loc: int
    head_dim: int
    rope_theta: float = 1e6

    def split_qkv(self, qkv: torch.Tensor):
        """``[..., qkv_loc] → q [..., hq, hd], k/v [..., hkv, hd]``."""
        hd = self.head_dim
        q, k, v = torch.split(
            qkv, [self.hq_loc * hd, self.hkv_loc * hd, self.hkv_loc * hd],
            dim=-1,
        )
        lead = qkv.shape[:-1]
        return (
            q.reshape(*lead, self.hq_loc, hd),
            k.reshape(*lead, self.hkv_loc, hd),
            v.reshape(*lead, self.hkv_loc, hd),
        )


def _qkv(params, x, dims, positions, qkv=None):
    """``x [S, d]`` → QKV GEMM (or the given ``qkv [S, qkv_loc]``) →
    split → QK-norm → rope at ``positions``; returns q, k, v as
    ``[h, S, hd]``."""
    q, k, v = dims.split_qkv(x @ params["wqkv"] if qkv is None else qkv)
    q = _rms_head(q, params.get("q_norm"))
    k = _rms_head(k, params.get("k_norm"))
    q = apply_rope(q.transpose(0, 1), positions, dims.rope_theta)
    k = apply_rope(k.transpose(0, 1), positions, dims.rope_theta)
    return q, k, v.transpose(0, 1)  # [h, S, hd]


def _o_flat(o: torch.Tensor, dims, dtype) -> torch.Tensor:
    """``o [h, S, hd]`` → ``[S, h * hd]`` in ``dtype``."""
    s = o.shape[1]
    return o.transpose(0, 1).reshape(s, dims.hq_loc * dims.head_dim).to(dtype)


def _o_proj(params, o: torch.Tensor, dims, dtype) -> torch.Tensor:
    """``o [h, S, hd]`` → ``[S, d]`` (one rank)."""
    return _o_flat(o, dims, dtype) @ params["wo"]


def _shards(v, single: bool, n: int) -> list:
    """A per-rank argument as a list (None → None for every rank)."""
    if single:
        return [v]
    return [None] * n if v is None else list(v)


def tp_attn_prefill(params, x, dims: TPAttnDims, *, mode: str = "xla",
                    ctx=None):
    """Prefill one full sequence, causal from position 0. tp=1: ``x
    [S, d]``; tp=n: each rank's sequence shard ``[S/n, d]``. Returns
    ``(out, k, v)``: the output in ``x``'s layout and each rank's cache
    entries ``k/v [hkv_loc, S, hd]``."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    qkv = gather_gemm(xs, [p["wqkv"] for p in ps], mode, ctx)
    s = qkv[0].shape[0]
    pos = torch.arange(s, device=xs[0].device)
    o_flat, ks, vs = [], [], []
    for p, t in zip(ps, qkv):
        q, k, v = _qkv(p, None, dims, pos, qkv=t)
        o = flash_attention(
            q[None].contiguous(), k[None].contiguous(), v[None].contiguous(),
            causal=True,
        )[0]
        o_flat.append(_o_flat(o, dims, xs[0].dtype))
        ks.append(k)
        vs.append(v)
    out = gemm_scatter(o_flat, [p["wo"] for p in ps], mode, ctx)
    return (unranked(out, single), unranked(ks, single),
            unranked(vs, single))


def tp_attn_prefill_paged_chunk(
    params,
    x,                         # [C, d] — one chunk of ONE sequence
    k_pages,                   # [P, hkv, page, hd] — this layer's pool
    v_pages,
    table_row: torch.Tensor,   # [pages_per_seq] int32 — the sequence's pages
    q_offset: int,             # tokens already cached
    dims: TPAttnDims,
    *,
    kv_pages: int | None = None,
    mode: str = "xla_ar",
    ctx=None,
    k_scale=None,              # [P, hkv] f32 — int8 pool scales
    v_scale=None,
    q_end: int | None = None,             # absolute end of the REAL rows
    rope_pos: torch.Tensor | None = None,   # [C] int — rope positions (tree)
    attn_bias: torch.Tensor | None = None,  # [C, S_kv] f32 additive mask
):
    """Chunked-prefill step over the paged pool: QKV for ``C`` suffix
    tokens, rope at absolute positions ``q_offset + i``, KV scattered
    through the page table (written in place), then flash attention of
    the chunk's queries against the whole cached context (prefix pages +
    the chunk) through ``kv_offset = q_offset``. Final-chunk right-padding
    that runs past the table's capacity is routed to the trash page 0.
    The gather is bounded to ``kv_pages`` table entries. At tp=n ``x``,
    the pools and the scales are per-rank lists (each rank's copy of the
    replicated chunk, its own pool shard) and the o-proj sums over ranks
    into every rank's copy.

    On an int8 pool the scatter quantizes the chunk's rows, and rows at
    or past ``q_end`` (the chunk's right-padding) go to the trash page 0,
    offset 0: a pad row would otherwise grow, or at offset 0 seed, a real
    page's scale. The attention reads the codes with the per-page scales
    gathered through the same table entries (``block_k = page``).

    ``rope_pos``/``attn_bias`` serve the tree-speculation verify chunk:
    rows are draft-tree nodes in DFS storage order, roped at
    ``rope_pos[i] = q_offset + depth_i`` while the KV scatter keeps the
    storage positions ``q_offset + i`` (an accepted branch's rows later
    move to their linear positions unchanged: K/V depend only on the
    token and its rope position). ``attn_bias`` (0 visible / -1e30
    masked over the gathered view, sliced to its width here) keeps
    sibling branches out of each other's softmax.
    Returns ``(out [C, d], k_pages, v_pages, k_scale, v_scale)``."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    n = len(ps)
    kps, vps = _shards(k_pages, single, n), _shards(v_pages, single, n)
    kss, vss = _shards(k_scale, single, n), _shards(v_scale, single, n)
    o_flat = [
        _chunk_local(ps[r], xs[r], kps[r], vps[r], table_row, q_offset, dims,
                     kv_pages, kss[r], vss[r], q_end, rope_pos, attn_bias)
        for r in range(n)
    ]
    out = reduce_ar(o_flat, [p["wo"] for p in ps], mode, ctx)
    return unranked(out, single), k_pages, v_pages, k_scale, v_scale


def _chunk_local(params, x, k_pages, v_pages, table_row, q_offset, dims,
                 kv_pages, k_scale, v_scale, q_end, rope_pos, attn_bias):
    """One rank's chunk step up to the o-proj: ``o_flat [C, hq*hd]``."""
    c = x.shape[0]
    page = k_pages.shape[2]
    pps = table_row.shape[0]
    pos = q_offset + torch.arange(c, device=x.device)  # storage positions
    q, k, v = _qkv(params, x, dims, pos if rope_pos is None else rope_pos)

    valid = pos < pps * page
    slot_page = torch.clamp(pos // page, 0, pps - 1)
    pids = torch.where(valid, table_row.long()[slot_page], 0)
    offs = torch.where(valid, pos % page, 0)
    gather_row = table_row if kv_pages is None else table_row[:kv_pages]
    if k_scale is not None:
        # Imported here, as in the JAX package: models/ imports this
        # module, so a top-level import would be circular.
        from triton_distributed_tpu_torch.models.paged_kv_cache import (
            quantized_row_scatter,
        )

        real = valid if q_end is None else valid & (pos < q_end)
        pids = torch.where(real, pids, 0)
        offs = torch.where(real, offs, 0)
        # The real rows (positions [q_offset, end)) fill the table's
        # pages from q_offset // page on; every other row goes to page 0.
        # The host knows these bounds, so the scatter re-quantizes each
        # touched page once instead of once per row.
        end = min(q_offset + c, pps * page,
                  q_offset + c if q_end is None else int(q_end))
        touched = table_row[q_offset // page:-(-end // page)].long()
        if end <= q_offset:
            touched = touched[:0]
        if end < q_offset + c:
            touched = torch.cat([touched, touched.new_zeros(1)])
        quantized_row_scatter(k_pages, k_scale, k.transpose(0, 1), pids,
                              offs, touched)
        quantized_row_scatter(v_pages, v_scale, v.transpose(0, 1), pids,
                              offs, touched)
        cols = gather_row.long()
        scales = {"k_scale": k_scale[cols].T[None].contiguous(),
                  "v_scale": v_scale[cols].T[None].contiguous(),
                  "block_k": page}
    else:
        k_pages[pids, :, offs, :] = k.transpose(0, 1).to(k_pages.dtype)
        v_pages[pids, :, offs, :] = v.transpose(0, 1).to(v_pages.dtype)
        scales = {}

    k_dense = pages_to_dense(k_pages, gather_row[None])  # [1, h, S_kv, hd]
    v_dense = pages_to_dense(v_pages, gather_row[None])
    if attn_bias is not None:
        scales["bias"] = attn_bias[:, : k_dense.shape[2]].contiguous()
    o = flash_attention(q[None].contiguous(), k_dense, v_dense, causal=True,
                        kv_offset=q_offset, **scales)[0]
    return _o_flat(o, dims, x.dtype)


def cold_mask(c: int, s_bucket: int, s_cold: int, device) -> torch.Tensor:
    """The cold partial's ``[C, S_bucket]`` f32 bias: 0 on the ``s_cold``
    valid cold columns, -1e30 on the bucket's tail past them."""
    cols = torch.arange(s_bucket, device=device)
    row = torch.where(cols < int(s_cold), 0.0, -1e30).to(torch.float32)
    return row[None].expand(c, s_bucket).contiguous()


def _merge_partials(o_cold, lse_cold, o_res, lse_res):
    """``lse_combine`` of the cold and resident attention partials."""
    o, _ = lse_combine(
        torch.stack([o_cold.to(torch.float32), o_res.to(torch.float32)]),
        torch.stack([lse_cold, lse_res]),
        part_axis=0,
    )
    return o


def tp_attn_prefill_paged_chunk_cold(
    params: dict,
    x: torch.Tensor,           # [C, d] — one chunk of ONE sequence
    k_pages: torch.Tensor,     # [P, hkv, page, hd] — this layer's pool
    v_pages: torch.Tensor,
    table_row: torch.Tensor,   # [budget_pages] int32 — the RESIDENT row
    k_cold: torch.Tensor,      # [hkv, S_bucket, hd] — demoted-page window
    v_cold: torch.Tensor,
    s_cold: int,               # valid cold tokens (<= S_bucket)
    q_offset: int,             # ABSOLUTE chunk start position
    dims: TPAttnDims,
    *,
    mode: str = "xla_ar",
    k_scale: torch.Tensor | None = None,   # [P, hkv] f32 — int8 pool scales
    v_scale: torch.Tensor | None = None,
    ks_cold: torch.Tensor | None = None,   # [hkv, S_bucket/page] f32
    vs_cold: torch.Tensor | None = None,
    q_end: int | None = None,              # absolute end of the REAL rows
    cold_bias: torch.Tensor | None = None,  # [C, S_bucket] (cold_mask)
):
    """Chunked-prefill step of a SHARDED long-context slot. Its history
    is split between ``s_cold`` demoted tokens (a read-only dense window
    in the pool dtype with per-page scales, absolute positions ``[0,
    s_cold)``) and the resident pages of ``table_row`` at LOCAL positions
    (absolute position − ``s_cold``). The chunk's queries rope at
    ABSOLUTE positions and its K/V rows are written at local ones (rows
    outside the resident window, the final chunk's padding, go to the
    trash page 0). Attention is two partials merged by ``lse_combine``:
    the resident view, causal at the local offset, and the cold window,
    non-causal, every row seeing every cold column below ``s_cold``
    (``cold_bias`` masks the bucket's tail; built here when not given).
    With ``s_cold == 0`` the cold partial is fully masked and the merge
    returns the resident partial (weight 1 against 0).
    Returns ``(out [C, d], k_pages, v_pages, k_scale, v_scale)``, the
    pool written in place."""
    check_mode(mode)
    c = x.shape[0]
    page = k_pages.shape[2]
    n_res = table_row.shape[0]
    s_cold, q_offset = int(s_cold), int(q_offset)
    pos = q_offset + torch.arange(c, device=x.device)  # absolute
    q, k, v = _qkv(params, x, dims, pos)

    lpos = pos - s_cold
    valid = (lpos >= 0) & (lpos < n_res * page)
    pids = torch.where(
        valid, table_row.long()[torch.clamp(lpos // page, 0, n_res - 1)], 0)
    offs = torch.where(valid, lpos % page, 0)
    if k_scale is not None:
        from triton_distributed_tpu_torch.models.paged_kv_cache import (
            quantized_row_scatter,
        )

        real = valid if q_end is None else valid & (pos < int(q_end))
        pids = torch.where(real, pids, 0)
        offs = torch.where(real, offs, 0)
        # The real rows' local positions [lo, hi) fill the row's pages
        # from lo // page on; every other row goes to the trash page 0.
        hi = q_offset + c if q_end is None else min(q_offset + c, int(q_end))
        lo = max(q_offset - s_cold, 0)
        hi = min(hi - s_cold, n_res * page)
        touched = table_row[lo // page:-(-hi // page)].long() if hi > lo \
            else table_row[:0].long()
        if hi - lo < c:
            touched = torch.cat([touched, touched.new_zeros(1)])
        quantized_row_scatter(k_pages, k_scale, k.transpose(0, 1), pids,
                              offs, touched)
        quantized_row_scatter(v_pages, v_scale, v.transpose(0, 1), pids,
                              offs, touched)
        cols = table_row.long()
        res_scales = {"k_scale": k_scale[cols].T[None].contiguous(),
                      "v_scale": v_scale[cols].T[None].contiguous(),
                      "block_k": page}
        cold_scales = {"k_scale": ks_cold[None], "v_scale": vs_cold[None],
                       "block_k": page}
    else:
        k_pages[pids, :, offs, :] = k.transpose(0, 1).to(k_pages.dtype)
        v_pages[pids, :, offs, :] = v.transpose(0, 1).to(v_pages.dtype)
        res_scales = cold_scales = {}

    q = q[None].contiguous()
    k_dense = pages_to_dense(k_pages, table_row[None])  # [1, h, S_res, hd]
    v_dense = pages_to_dense(v_pages, table_row[None])
    o_res, lse_res = flash_attention(
        q, k_dense, v_dense, causal=True, kv_offset=q_offset - s_cold,
        return_lse=True, **res_scales)
    if cold_bias is None:
        cold_bias = cold_mask(c, k_cold.shape[1], s_cold, x.device)
    o_cold, lse_cold = flash_attention(
        q, k_cold[None], v_cold[None], causal=False, bias=cold_bias,
        return_lse=True, **cold_scales)
    o = _merge_partials(o_cold, lse_cold, o_res, lse_res)[0]
    return (_o_proj(params, o, dims, x.dtype), k_pages, v_pages, k_scale,
            v_scale)


def tp_attn_decode_sharded(
    params: dict,
    x: torch.Tensor,           # [1, d] — the slot's new token
    k_pages: torch.Tensor,     # [P, hkv, page, hd] (updated in place)
    v_pages: torch.Tensor,
    table_row: torch.Tensor,   # [budget_pages] int32 — the RESIDENT row
    kv_len_loc: int,           # tokens in the resident region
    k_cold: torch.Tensor,      # [hkv, S_bucket, hd] — demoted-page window
    v_cold: torch.Tensor,
    s_cold: int,               # valid cold tokens (<= S_bucket)
    dims: TPAttnDims,
    *,
    mode: str = "xla_ar",
    k_scale: torch.Tensor | None = None,   # [P, hkv] f32 — int8 pool scales
    v_scale: torch.Tensor | None = None,
    ks_cold: torch.Tensor | None = None,   # [hkv, S_bucket/page] f32
    vs_cold: torch.Tensor | None = None,
):
    """Decode step of ONE sharded long-context slot: the new token ropes
    at its ABSOLUTE position ``s_cold + kv_len_loc`` and appends at its
    LOCAL resident position ``kv_len_loc``; attention is
    :func:`paged_flash_decode` over the resident pages and
    :func:`flash_decode` over the cold window (``chunk_k = page``, with
    the window's per-page scales on an int8 pool), merged by
    ``lse_combine``. Returns ``(out [1, d], k_pages, v_pages, k_scale,
    v_scale)``, the pool written in place."""
    check_mode(mode)
    page = k_pages.shape[2]
    kv_len_loc, s_cold = int(kv_len_loc), int(s_cold)
    pos = torch.full((1,), s_cold + kv_len_loc, dtype=torch.int32,
                     device=x.device)
    q, k, v = _decode_qkv(params, x, pos, dims)  # [1, h, hd]
    pid = table_row[kv_len_loc // page:kv_len_loc // page + 1].long()
    off = kv_len_loc % page
    if k_scale is not None:
        from triton_distributed_tpu_torch.models.paged_kv_cache import (
            quantized_row_scatter,
        )

        offs = torch.full_like(pid, off)
        quantized_row_scatter(k_pages, k_scale, k, pid, offs)
        quantized_row_scatter(v_pages, v_scale, v, pid, offs)
        cold_scales = {"k_scale": ks_cold[None], "v_scale": vs_cold[None]}
    else:
        k_pages[pid, :, off, :] = k.to(k_pages.dtype)
        v_pages[pid, :, off, :] = v.to(v_pages.dtype)
        cold_scales = {}
    q = q.contiguous()
    o_res, lse_res = paged_flash_decode(
        q, k_pages, v_pages, table_row[None], kv_len_loc + 1,
        return_lse=True, k_scale=k_scale, v_scale=v_scale)
    o_cold, lse_cold = flash_decode(
        q, k_cold[None], v_cold[None], s_cold, chunk_k=page,
        return_lse=True, **cold_scales)
    o = _merge_partials(o_cold, lse_cold, o_res, lse_res)
    out = o.reshape(1, dims.hq_loc * dims.head_dim).to(x.dtype) @ params["wo"]
    return out, k_pages, v_pages, k_scale, v_scale


def _decode_qkv(params, x, kv_len, dims):
    q, k, v = dims.split_qkv(x @ params["wqkv"])  # [B, h, hd]
    q = _rms_head(q, params.get("q_norm"))
    k = _rms_head(k, params.get("k_norm"))
    q = apply_rope(q, kv_len[:, None], dims.rope_theta)
    k = apply_rope(k, kv_len[:, None], dims.rope_theta)
    return q, k, v


def tp_attn_decode(
    params,
    x,                      # [B, d] — one new token per sequence
    k_cache,                # [B, hkv, S_max, hd] (updated in place)
    v_cache,
    kv_len: torch.Tensor,   # [B] int32 — tokens already in cache
    dims: TPAttnDims,
    *,
    mode: str = "xla_ar",
    ctx=None,
):
    """Decode step over a dense cache: QKV → rope at position ``kv_len``
    → cache append at ``kv_len[b]`` → flash decode → O-proj (summed over
    ranks at tp=n, where ``x`` and the caches are per-rank lists).
    Returns ``(out [B, d], k_cache, v_cache)``."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    n = len(ps)
    kcs, vcs = _shards(k_cache, single, n), _shards(v_cache, single, n)
    o_flat = []
    for p, t, kc, vc in zip(ps, xs, kcs, vcs):
        b = t.shape[0]
        q, k, v = _decode_qkv(p, t, kv_len, dims)
        # Clamped like the JAX dynamic_update_slice the append mirrors.
        pos = torch.clamp(kv_len.long(), 0, kc.shape[2] - 1)
        rows = torch.arange(b, device=t.device)
        kc[rows, :, pos, :] = k.to(kc.dtype)
        vc[rows, :, pos, :] = v.to(vc.dtype)
        o = flash_decode(q.contiguous(), kc, vc, kv_len + 1)
        o_flat.append(o.reshape(b, dims.hq_loc * dims.head_dim).to(t.dtype))
    out = reduce_ar(o_flat, [p["wo"] for p in ps], mode, ctx)
    return unranked(out, single), k_cache, v_cache


def tp_attn_decode_paged(
    params,
    x,                         # [B, d] — one new token per sequence
    k_pages,                   # [P, hkv, page, hd] (updated in place)
    v_pages,
    page_table: torch.Tensor,  # [B, pages_per_seq] int32
    kv_len: torch.Tensor,      # [B] int32
    dims: TPAttnDims,
    *,
    mode: str = "xla_ar",
    ctx=None,
    k_scale=None,              # [P, hkv] f32 — int8 pool scales
    v_scale=None,
):
    """Decode step over the paged pool: the append goes through the page
    table for EVERY row (an inactive slot has kv_len 0 and a zeroed table
    row, so it writes the trash page 0, offset 0), then
    :func:`paged_flash_decode` reads the pool directly. On an int8 pool
    (``k_scale``/``v_scale`` given) the append is ONE batched
    :func:`quantized_row_scatter` over all B rows and the decode reads
    the codes with their scales. At tp=n ``x``, the pools and the scales
    are per-rank lists; the page table and kv_len are shared. Returns
    ``(out [B, d], k_pages, v_pages, k_scale, v_scale)``."""
    check_mode(mode)
    ps, xs, single = ranked(params, x)
    n = len(ps)
    kps, vps = _shards(k_pages, single, n), _shards(v_pages, single, n)
    kss, vss = _shards(k_scale, single, n), _shards(v_scale, single, n)
    o_flat = []
    for r in range(n):
        t, kp, vp, ks, vs = xs[r], kps[r], vps[r], kss[r], vss[r]
        b = t.shape[0]
        page = kp.shape[2]
        q, k, v = _decode_qkv(ps[r], t, kv_len, dims)
        pos = kv_len.long()
        col = torch.clamp(pos // page, 0, page_table.shape[1] - 1)
        pids = page_table.long()[torch.arange(b, device=t.device), col]
        if ks is not None:
            from triton_distributed_tpu_torch.models.paged_kv_cache import (
                quantized_row_scatter,
            )

            quantized_row_scatter(kp, ks, k, pids, pos % page)
            quantized_row_scatter(vp, vs, v, pids, pos % page)
        else:
            kp[pids, :, pos % page, :] = k.to(kp.dtype)
            vp[pids, :, pos % page, :] = v.to(vp.dtype)
        o = paged_flash_decode(q.contiguous(), kp, vp, page_table,
                               kv_len + 1, k_scale=ks, v_scale=vs)
        o_flat.append(o.reshape(b, dims.hq_loc * dims.head_dim).to(t.dtype))
    out = reduce_ar(o_flat, [p["wo"] for p in ps], mode, ctx)
    return unranked(out, single), k_pages, v_pages, k_scale, v_scale
