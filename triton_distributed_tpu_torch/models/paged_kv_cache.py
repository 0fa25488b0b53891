"""Paged KV cache: fixed-size pages + per-sequence page tables.

Counterpart of ``triton_distributed_tpu/models/paged_kv_cache.py``. The
pool is one tensor per K/V, ``[L, num_pages, Hkv, page, hd]``; the page
table and the free list are control-plane state. Page 0 is reserved as
the trash page that inactive slots and out-of-table pad rows write to.

The JAX writers take a donated cache and return a new one; these write
the pool IN PLACE and return the cache, so call sites read alike.

At tp=n the pool is head-sharded: ``[n, L, num_pages, hkv_loc, page,
hd]`` (scales ``[n, L, num_pages, hkv_loc]``), each rank's ``[L,
num_pages, hkv_loc, page, hd]`` contiguous, the shape the attention
kernels take (:meth:`PagedKVCache.rank` is its view). The page table and
``kv_len`` are shared, as the JAX package replicates them; the page
allocator and the radix tree do not change.
:func:`copy_page` copies the page's contents (never aliases).

``kv_dtype="int8"`` stores int8 codes plus ONE symmetric f32 scale per
(layer, page, kv head), ``x ≈ code * scale`` with ``scale = amax / 127``
over the page's (page, hd) block. A write at page offset 0 sets the
scale absolutely (a fresh page has no valid prior rows, and a recycled
page's stale scale must not survive); later writes grow it by max and
re-quantize the stored codes under the grown scale. The attention
kernels dequantize in registers, so full-width KV never materializes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    pages_to_dense,
    scales_to_dense,
)


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor     # [L, P, Hkv, page_size, hd]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [B, pages_per_seq] int32 — page ids
    kv_len: torch.Tensor      # [B] int32
    # Per-page-per-head dequantization scales [L, P, Hkv] f32, present
    # iff the pool stores int8 codes.
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def tp(self) -> int:
        return 1 if self.k_pages.dim() == 5 else int(self.k_pages.shape[0])

    @property
    def page_size(self) -> int:
        return int(self.k_pages.shape[-2])

    @property
    def num_pages(self) -> int:
        return int(self.k_pages.shape[-4])

    def rank(self, r: int) -> "PagedKVCache":
        """Rank ``r``'s pool shard as a tp=1 cache (views; the page table
        and kv_len shared)."""
        if self.tp == 1:
            return self
        return dataclasses.replace(
            self, k_pages=self.k_pages[r], v_pages=self.v_pages[r],
            k_scale=None if self.k_scale is None else self.k_scale[r],
            v_scale=None if self.v_scale is None else self.v_scale[r])


KV_DTYPES = (None, "int8")
_Q_MAX = 127.0
# Scales are amax * (1/127) in f32: the JAX package's writers run under
# jit, where XLA compiles ``amax / 127`` to that product, so the port's
# scales (and hence codes) match the JAX engines' bit for bit.
_INV_Q_MAX = 1.0 / _Q_MAX
# Safe-division floor: an all-zero page has amax 0 and scale 0; dividing
# by the floor maps 0 to 0 instead of NaN.
_SCALE_EPS = 1e-30


def resolve_kv_dtype(kv_dtype: str | None, cfg: ModelConfig) -> str | None:
    """The KV storage mode: the explicit knob, else ``cfg.kv_dtype``;
    anything but None or "int8" raises ``ValueError``."""
    resolved = kv_dtype if kv_dtype is not None else cfg.kv_dtype
    if resolved not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype={resolved!r} unsupported; expected None or 'int8'"
        )
    return resolved


def page_scales(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-page-per-head scale of ``x [..., page, hd]``: amax
    over the trailing (page, hd) block / 127, f32."""
    return torch.amax(x.to(torch.float32).abs(), dim=(-2, -1)) * _INV_Q_MAX


def quantize_page(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x [..., page, hd]`` under ``scale [...]`` (int8,
    round half to even, clipped symmetric at ±127)."""
    s = torch.clamp(scale, min=_SCALE_EPS)[..., None, None]
    q = torch.round(x.to(torch.float32) / s)
    return torch.clamp(q, -_Q_MAX, _Q_MAX).to(torch.int8)


def dequantize_page(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_page` (f32)."""
    return q.to(torch.float32) * scale[..., None, None]


def quantize_pages(pages: torch.Tensor):
    """One-shot pool quantization (tests, benches): ``[..., page, hd]``
    → ``(int8 codes, per-page-per-head scales [...])``."""
    scale = page_scales(pages)
    return quantize_page(pages, scale), scale


def quantized_row_scatter(pages, scales, rows, pids, offs, touched=None):
    """Scatter ``rows [C, H, hd]`` into a ONE-LAYER int8 pool ``pages
    [P, H, page, hd]`` at ``(pids[c], offs[c])``, in place: grow each
    touched page's ``scales [P, H]`` to cover its new rows (reset, not
    grown, when a row lands at page offset 0), re-quantize the touched
    pages' stored codes under the grown scales, then write the rows as
    int8. Returns ``(pages, scales)``.

    THE one implementation of the scale protocol: the chunk-prefill
    scatter and the decode append (``layers/tp_attn.py``) both call it,
    and :func:`append_n` runs it over every layer at once
    (:func:`_row_scatter_layers`, the JAX package's layer vmap).
    Duplicate ``pids`` (several rows in one page, trash-page fan-in) are
    safe: the scale min/max are reductions, and duplicate re-quantized
    pages are identical. ``touched`` (default ``pids``) lists the pages
    to re-quantize, and must hold exactly the distinct values of
    ``pids`` (repeats allowed): a chunk's rows fall in a few pages the
    caller knows, and re-quantizing one copy per page instead of one per
    row leaves the same codes.

    No host sync: the JAX version skips the re-quantization when no
    touched scale moved (``lax.cond``); here the skip is a device-side
    ``torch.where`` on the same condition, so the codes match the JAX
    package's bit for bit without the host ever reading a value.
    """
    _row_scatter_layers(pages[None], scales[None], rows[None], pids, offs,
                        touched)
    return pages, scales


def _row_scatter_layers(pages, scales, rows, pids, offs, touched=None):
    """:func:`quantized_row_scatter` over a leading layer axis, in place:
    ``pages [L, P, H, page, hd]``, ``scales [L, P, H]``, ``rows [L, C, H,
    hd]`` and one ``(pids, offs)`` for every layer. Each layer is its own
    protocol instance (the JAX ``vmap``): its re-quantization is skipped
    when none of ITS touched scales moved. The layers are flattened into
    one ``[L * P]`` page axis (``view``: the pool must be contiguous, so
    the writes land in it)."""
    n_l, n_p, h = scales.shape
    rows = rows.to(torch.float32).reshape(-1, h, rows.shape[-1])
    pids = pids.long()
    touched = pids if touched is None else touched.long()
    base = torch.arange(n_l, device=pids.device)[:, None] * n_p
    flat_p = (base + pids[None]).reshape(-1)       # [L*C]
    flat_t = (base + touched[None]).reshape(-1)    # [L*T]
    flat_o = offs.long().repeat(n_l)
    flat_sc = scales.view(n_l * n_p, h)
    flat_pages = pages.view(n_l * n_p, *pages.shape[2:])
    row_sc = torch.amax(rows.abs(), dim=-1) * _INV_Q_MAX  # [L*C, H]
    clear = torch.where(flat_o == 0, 0.0, float("inf"))[:, None].expand_as(
        row_sc)
    old_sc = flat_sc.index_select(0, flat_t)  # [L*T, H]
    idx = flat_p[:, None].expand_as(row_sc)
    flat_sc.scatter_reduce_(0, idx, clear, "amin", include_self=True)
    flat_sc.scatter_reduce_(0, idx, row_sc, "amax", include_self=True)
    new_sc = flat_sc.index_select(0, flat_t)
    # Where none of a layer's touched scales moved, ratio 1 keeps every
    # code of that layer as it is.
    moved = (new_sc != old_sc).reshape(n_l, touched.shape[0] * h).any(dim=1)
    moved = moved.repeat_interleave(touched.shape[0])[:, None]
    ratio = torch.where(moved, old_sc / torch.clamp(new_sc, min=_SCALE_EPS),
                        1.0)
    got = flat_pages.index_select(0, flat_t)  # [L*T, H, page, hd] int8
    flat_pages[flat_t] = torch.clamp(
        torch.round(got.to(torch.float32) * ratio[..., None, None]),
        -_Q_MAX, _Q_MAX,
    ).to(torch.int8)
    row_sc = torch.clamp(flat_sc.index_select(0, flat_p), min=_SCALE_EPS)
    flat_pages[flat_p, :, flat_o, :] = torch.clamp(
        torch.round(rows / row_sc[..., None]), -_Q_MAX, _Q_MAX,
    ).to(torch.int8)


class PagePool:
    """Host-side free-list allocator."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.free = list(range(num_pages - 1, -1, -1))

    def allocate(self, n: int) -> list[int]:
        if n > len(self.free):
            raise RuntimeError(f"page pool exhausted ({n} > {len(self.free)})")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)


def init_paged_cache(
    cfg: ModelConfig,
    batch_size: int,
    device,
    *,
    max_length: int | None = None,
    page_size: int = 128,
    num_pages: int | None = None,
    assign_pages: bool = True,
    kv_dtype: str | None = None,
    tp: int = 1,
) -> tuple[PagedKVCache, PagePool]:
    """Allocate the pool + page tables for ``batch_size`` sequences.
    ``assign_pages=False`` leaves the pool full and the table zeroed, for
    callers that assign pages per request (continuous batching).
    ``kv_dtype="int8"`` (or ``cfg.kv_dtype``; the argument wins) makes an
    int8 pool plus ``[L, P, Hkv]`` f32 ``k_scale``/``v_scale``."""
    kv_dtype = resolve_kv_dtype(kv_dtype, cfg)
    s_max = max_length or cfg.max_length
    if s_max % page_size:
        raise ValueError(f"max_length {s_max} not a page multiple")
    pages_per_seq = s_max // page_size
    num_pages = num_pages or batch_size * pages_per_seq
    pool = PagePool(num_pages)
    if assign_pages:
        table = np.asarray(
            [pool.allocate(pages_per_seq) for _ in range(batch_size)],
            np.int32,
        )
    else:
        table = np.zeros((batch_size, pages_per_seq), np.int32)
    shape = (
        cfg.num_layers, num_pages, cfg.num_kv_heads // tp, page_size,
        cfg.head_dim
    )
    if tp > 1:
        shape = (tp, *shape)
    pool_dtype = torch.int8 if kv_dtype == "int8" else cfg.dtype

    def scales():
        if kv_dtype is None:
            return None
        return torch.zeros(shape[:-2], dtype=torch.float32, device=device)

    cache = PagedKVCache(
        k_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
        v_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
        page_table=torch.from_numpy(table).to(device),
        kv_len=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        k_scale=scales(),
        v_scale=scales(),
    )
    return cache, pool


def kv_bytes_per_token(cache: PagedKVCache) -> float:
    """Device bytes one cached token costs across the K+V pools (every
    rank's), plus the per-page scale overhead when quantized."""
    L, _p, H, page, hd = cache.k_pages.shape[-5:]
    H *= cache.tp
    per = (cache.k_pages.element_size() + cache.v_pages.element_size()) * (
        L * H * hd)
    if cache.quantized:
        per += (cache.k_scale.element_size()
                + cache.v_scale.element_size()) * L * H / page
    return float(per)


def cache_from_jax(tree, device) -> PagedKVCache:
    """A JAX ``PagedKVCache`` whose leaves are numpy arrays (reached by
    attribute or key: ``k_pages``, ``v_pages``, ``page_table``,
    ``kv_len`` and, on an int8 pool, ``k_scale``/``v_scale``) as the
    port's cache on ``device``: the same codes, scales and tables."""
    def leaf(name):
        node = tree[name] if isinstance(tree, dict) else getattr(tree, name)
        return None if node is None else torch.from_numpy(
            np.array(node)).to(device)

    return PagedKVCache(**{f.name: leaf(f.name)
                           for f in dataclasses.fields(PagedKVCache)})


class PoolAuditError(RuntimeError):
    """The pool/radix invariant audit found leaked, double-owned, or
    phantom pages — the serving loop's bookkeeping is corrupt."""


def audit_pool(
    pool: PagePool,
    num_pages: int | None = None,
    owners: dict[str, list[int]] | None = None,
    *,
    shared: dict[str, list[int]] | None = None,
    reserved: tuple[int, ...] = (0,),
) -> list[str]:
    """Cross-check the pool's ownership partition; returns violation
    strings (empty == clean).

    ``owners`` maps an owner name to the pages it holds EXCLUSIVELY;
    ``shared`` maps an owner to pages it maps by reference (a slot's
    refcounted prefix pages). The audit proves: free list ∪ exclusive
    owners ∪ ``reserved`` == all pages; no page has two exclusive
    owners, is both owned and free, or is reserved; the free list holds
    no duplicates; every shared mapping targets a live owned page."""
    problems: list[str] = []
    total = pool.num_pages if num_pages is None else int(num_pages)
    free = list(pool.free)
    free_set = set(free)
    if len(free_set) != len(free):
        dup = sorted(p for p in free_set if free.count(p) > 1)
        problems.append(f"free list holds duplicate pages {dup}")
    claimed: dict[int, str] = {}
    for name, pages in (owners or {}).items():
        seen_local: set[int] = set()
        for p in pages:
            p = int(p)
            if p in seen_local:
                problems.append(f"{name} lists page {p} twice")
                continue
            seen_local.add(p)
            if p in claimed:
                problems.append(
                    f"page {p} owned by both {claimed[p]} and {name}"
                )
                continue
            claimed[p] = name
            if p in free_set:
                problems.append(
                    f"page {p} owned by {name} but also on the free list"
                )
            if p in reserved:
                problems.append(f"{name} owns reserved page {p}")
    all_pages = set(range(total))
    accounted = free_set | set(claimed) | set(reserved)
    leaked = all_pages - accounted
    if leaked:
        problems.append(f"leaked pages (no owner, not free): {sorted(leaked)}")
    phantom = accounted - all_pages
    if phantom:
        problems.append(f"unknown page ids: {sorted(phantom)}")
    for name, pages in (shared or {}).items():
        for p in pages:
            p = int(p)
            if p in free_set:
                problems.append(
                    f"{name} maps shared page {p} that is on the free list"
                )
            elif p not in claimed:
                problems.append(
                    f"{name} maps shared page {p} that no owner holds"
                )
    return problems


def gather_bucket(end_pos: int, page_size: int, pages_per_seq: int) -> int:
    """Page-table gather width for a chunk whose queries/writes end at
    ``end_pos``: enough table entries to cover it, rounded up to a power
    of two (the JAX package's one-program-per-bucket convention, kept so
    both packages attend over the same gathered width)."""
    need = -(-int(end_pos) // page_size)
    if need <= 1:
        return 1
    return min(1 << max(need - 1, 0).bit_length(), pages_per_seq)


def rollback_kv(cache: PagedKVCache, slot: int, new_len: int) -> PagedKVCache:
    """Truncate ``slot``'s cached length to ``new_len`` (speculative
    decoding's KV rollback: a verify chunk wrote its draft rows,
    acceptance kept a prefix, and every row past the accepted length
    becomes garbage beyond kv_len, masked by causality and overwritten by
    the next append). The page table is untouched. An int8 pool rolls
    back for free: its scales are per page and only grow within a page's
    life, so they still cover every retained row. Returns a cache with a
    new ``kv_len`` tensor (the old one is not written)."""
    kv_len = cache.kv_len.clone()
    kv_len[int(slot)] = int(new_len)
    return dataclasses.replace(cache, kv_len=kv_len)


def move_kv_rows(cache: PagedKVCache, slot: int, src: list[int],
                 dst: list[int]) -> PagedKVCache:
    """Move ``slot``'s token rows from absolute positions ``src`` to
    ``dst`` (K and V, all layers, in place): the tree-speculation commit.
    A verify chunk wrote the draft tree's nodes at DFS storage positions
    ``kv + i``; acceptance picked one root path, whose nodes move to the
    contiguous positions ``kv+1 .. kv+a`` linear decode would have
    written. Every row is gathered (and cloned) before any is written,
    so overlapping moves are safe; self-moves are skipped. Full-width
    pools only: on an int8 pool a row hopping between pages would be a
    re-quantization whose rounding depends on move order."""
    if cache.quantized:
        raise ValueError(
            "move_kv_rows is full-width-pool only; quantized pools run "
            "width-1 speculation chains (no row moves)"
        )
    if len(src) != len(dst):
        raise ValueError(f"src/dst length mismatch ({len(src)} vs {len(dst)})")
    pairs = [(int(s), int(d)) for s, d in zip(src, dst) if int(s) != int(d)]
    if not pairs:
        return cache
    page = int(cache.k_pages.shape[3])
    row = cache.page_table[int(slot)].long()
    dev = cache.k_pages.device
    s_pos = torch.tensor([p[0] for p in pairs], device=dev)
    d_pos = torch.tensor([p[1] for p in pairs], device=dev)
    ps, so = row[s_pos // page], s_pos % page
    pd, do = row[d_pos // page], d_pos % page
    # Two advanced indices split by a slice: the advanced axis leads, so
    # the gathered rows are [m, L, H, hd]. Both pools are gathered before
    # either is written.
    rows = [t[:, ps, :, so, :].clone() for t in (cache.k_pages,
                                                 cache.v_pages)]
    for t, r in zip((cache.k_pages, cache.v_pages), rows):
        t[:, pd, :, do, :] = r
    return cache


def truncate_pages(
    pool: PagePool,
    pages: list[int],
    keep_tokens: int,
    page_size: int,
    *,
    shared: int = 0,
) -> list[int]:
    """Release every page of ``pages`` lying wholly past ``keep_tokens``
    cached tokens back to ``pool``; returns the retained prefix. The
    first ``shared`` entries (prefix-cache pages owned by the radix
    tree) are never freed here."""
    if shared < 0 or shared > len(pages):
        raise ValueError(
            f"shared={shared} out of range for {len(pages)} pages"
        )
    keep = max(-(-max(int(keep_tokens), 0) // page_size), shared)
    if keep >= len(pages):
        return pages
    pool.release(pages[keep:])
    return pages[:keep]


def append(cache: PagedKVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> PagedKVCache:
    """Append one token per sequence (``k_new/v_new [L, B, Hkv, hd]``) at
    ``kv_len``: the ``NS = 1`` case of :func:`append_n`."""
    return append_n(cache, k_new[:, :, :, None, :], v_new[:, :, :, None, :])


def append_n(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
             n_valid=None) -> PagedKVCache:
    """Append ``NS`` tokens per sequence (``[L, B, Hkv, NS, hd]``) at
    ``kv_len``, in place; the returned cache carries ``kv_len + NS``.
    Rows ``>= n_valid[b]`` (``[B]``; None → NS) go to the trash page 0
    instead of the sequence's pages: a serving launch knows which of its
    rows overshoot a finishing request, and on an int8 pool those rows
    would otherwise grow the scale of a page about to retire into the
    radix tree. Page-boundary crossings fall out of the per-row (page,
    offset). Caller contract: ``kv_len[b] + NS`` fits the page table.

    A full-width pool takes one scatter per pool. An int8 pool takes the
    rows step by step, one :func:`_row_scatter_layers` per step and pool
    (reset at offset 0, grow and re-quantize otherwise): a single
    ``B*NS``-row scatter would grow each page's scale once for all NS
    rows, while NS single-step appends grow and re-quantize row by row,
    and the pool must end bit-identical to those (retired pages are
    shared across requests through the radix tree)."""
    dev = cache.k_pages.device
    page = cache.k_pages.shape[3]
    L, B, H, NS, hd = k_new.shape
    steps = torch.arange(NS, device=dev)[None]
    pos = cache.kv_len.long()[:, None] + steps
    pps = cache.page_table.shape[1]
    pids = cache.page_table.long().gather(
        1, torch.clamp(pos // page, max=pps - 1))
    if n_valid is not None:
        nv = torch.as_tensor(np.asarray(n_valid) if not isinstance(
            n_valid, torch.Tensor) else n_valid).to(dev).long()
        pids = torch.where(steps < nv[:, None], pids, 0)
    offs = pos % page
    if cache.quantized:
        for s in range(NS):
            _row_scatter_layers(cache.k_pages, cache.k_scale,
                                k_new[:, :, :, s], pids[:, s], offs[:, s])
            _row_scatter_layers(cache.v_pages, cache.v_scale,
                                v_new[:, :, :, s], pids[:, s], offs[:, s])
        return dataclasses.replace(cache, kv_len=cache.kv_len + NS)
    flat_p, flat_o = pids.reshape(-1), offs.reshape(-1)
    for pages, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        # Two advanced indices split by a slice: the indexed view is
        # [B*NS, L, H, hd]. Trash-routed rows may share an index; any
        # of them may land (the trash page is never read).
        pages[:, flat_p, :, flat_o, :] = new.permute(1, 3, 0, 2, 4).reshape(
            B * NS, L, H, hd).to(pages.dtype)
    return dataclasses.replace(cache, kv_len=cache.kv_len + NS)


def write_prefill(
    cache: PagedKVCache,
    b_idx: int,
    k_dense: torch.Tensor,  # [L, 1, Hkv, S, hd] — one filled sequence
    v_dense: torch.Tensor,
    true_len: int,
) -> PagedKVCache:
    """Copy a dense-prefilled sequence into its pages (in place), one
    page-sized slice per page; ceil(true_len/page) pages are written
    (each rank's dense shard into its pool shard at tp=n).
    On an int8 pool every written page is a fresh full write: its scale
    is set absolutely from the page's amax, after the dense rows at
    positions ≥ ``true_len`` are zeroed (the dense scratch is reused
    across prefills, so those rows hold an earlier request's KV and
    would otherwise make the codes depend on admission order)."""
    if cache.tp > 1:
        for r in range(cache.tp):
            write_prefill(cache.rank(r), b_idx, k_dense[r], v_dense[r],
                          true_len)
        return cache
    page = cache.k_pages.shape[3]
    npages = -(-int(true_len) // page)
    if k_dense.shape[3] < npages * page:
        raise ValueError(
            f"dense prefill holds {k_dense.shape[3]} positions; "
            f"{npages * page} needed for true_len={true_len}"
        )
    row = cache.page_table[b_idx, :npages].tolist()
    pools = [(cache.k_pages, cache.k_scale, k_dense),
             (cache.v_pages, cache.v_scale, v_dense)]
    for j, pid in enumerate(row):
        sl = slice(j * page, (j + 1) * page)
        for pages, scales, dense in pools:
            chunk = dense[:, 0, :, sl]  # [L, H, page, hd]
            if scales is None:
                pages[:, pid] = chunk.to(pages.dtype)
                continue
            pos = j * page + torch.arange(page, device=chunk.device)
            chunk = torch.where((pos < true_len)[None, None, :, None],
                                chunk.to(torch.float32), 0.0)
            sc = page_scales(chunk)  # [L, H]
            pages[:, pid] = quantize_page(chunk, sc)
            scales[:, pid] = sc
    cache.kv_len[b_idx] = int(true_len)
    return cache


def _pool_tensors(cache: PagedKVCache):
    """The per-page tensors of the cache: both pools and, when
    quantized, both scale arrays (all indexed [L, P, ...])."""
    return [t for t in (cache.k_pages, cache.v_pages, cache.k_scale,
                        cache.v_scale) if t is not None]


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy one pool page (K and V, all layers) — the prefix cache's
    copy-on-write clone. The destination gets its own copy of the data;
    on an int8 pool the scales are cloned with the codes (the pair is
    the page's content)."""
    for r in range(cache.tp):
        for t in _pool_tensors(cache.rank(r)):
            t[:, dst].copy_(t[:, src])
    return cache


def gather_pages(cache: PagedKVCache, page_ids: list[int]):
    """Copy the listed pool pages to host tensors. Returns ``(k, v,
    k_scale, v_scale)``: ``[L, n, Hkv, page, hd]`` pools in the pool
    dtype and ``[L, n, Hkv]`` scales (None on a full-width pool). These
    are CPU tensors rather than numpy arrays: numpy has no bf16."""
    ids = torch.as_tensor([int(p) for p in page_ids], dtype=torch.long,
                          device=cache.k_pages.device)
    k, v, *sc = [t.index_select(1, ids).cpu() for t in _pool_tensors(cache)]
    ks, vs = sc if sc else (None, None)
    return k, v, ks, vs


def write_page(cache: PagedKVCache, pid: int, k_page, v_page,
               k_scale=None, v_scale=None) -> PagedKVCache:
    """Write one page's full content (``[L, Hkv, page, hd]``, both pools;
    scales ``[L, Hkv]``, required iff the pool is quantized) into pool
    page ``pid``, verbatim."""
    if cache.quantized != (k_scale is not None):
        raise ValueError(
            "page payload and pool disagree on quantization "
            f"(pool quantized={cache.quantized}, scales "
            f"{'present' if k_scale is not None else 'absent'})"
        )
    for t, data in zip(_pool_tensors(cache),
                       (k_page, v_page, k_scale, v_scale)):
        t[:, int(pid)] = torch.as_tensor(data).to(t.device, t.dtype)
    return cache


def as_dense(cache: PagedKVCache, layer=None):
    """Contiguous ``[L?, B, Hkv, S_max, hd]`` views gathered through the
    table (tests; the serving path reads pages through the kernel). An
    int8 pool's view is dequantized (f32)."""
    out = []
    for pages, scales in ((cache.k_pages, cache.k_scale),
                          (cache.v_pages, cache.v_scale)):
        if layer is not None:
            pages = pages[layer]
            scales = None if scales is None else scales[layer]
        dense = pages_to_dense(pages, cache.page_table)
        if scales is not None:
            page = cache.k_pages.shape[3]
            dense = dense.to(torch.float32) * scales_to_dense(
                scales, cache.page_table, page)[..., None]
        out.append(dense)
    return tuple(out)
