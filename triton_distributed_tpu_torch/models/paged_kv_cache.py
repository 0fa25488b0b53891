"""Paged KV cache: fixed-size pages + per-sequence page tables.

Counterpart of the full-width half of
``triton_distributed_tpu/models/paged_kv_cache.py``. The pool is one
tensor per K/V, ``[L, num_pages, Hkv, page, hd]``; the page table and the
free list are control-plane state. Page 0 is reserved as the trash page
that inactive slots and out-of-table pad rows write to.

The JAX writers take a donated cache and return a new one; these write
the pool IN PLACE and return the cache, so call sites read alike.
:func:`copy_page` copies the page's contents (never aliases). The int8
pool (scales, the quantized scatter) is a later slice (ROADMAP queue 1,
item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_distributed_tpu_torch.models.config import ModelConfig
from triton_distributed_tpu_torch.ops.attention.flash_decode import (
    pages_to_dense,
)


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor     # [L, P, Hkv, page_size, hd]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [B, pages_per_seq] int32 — page ids
    kv_len: torch.Tensor      # [B] int32


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
) -> tuple[PagedKVCache, PagePool]:
    """Allocate the pool + page tables for ``batch_size`` sequences.
    ``assign_pages=False`` leaves the pool full and the table zeroed, for
    callers that assign pages per request (continuous batching)."""
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
        cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim
    )
    cache = PagedKVCache(
        k_pages=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v_pages=torch.zeros(shape, dtype=cfg.dtype, device=device),
        page_table=torch.from_numpy(table).to(device),
        kv_len=torch.zeros((batch_size,), dtype=torch.int32, device=device),
    )
    return cache, pool


def kv_bytes_per_token(cache: PagedKVCache) -> float:
    """Device bytes one cached token costs across the K+V pools."""
    L, _p, H, _page, hd = cache.k_pages.shape
    return float(
        (cache.k_pages.element_size() + cache.v_pages.element_size())
        * L * H * hd
    )


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


def write_prefill(
    cache: PagedKVCache,
    b_idx: int,
    k_dense: torch.Tensor,  # [L, 1, Hkv, S, hd] — one filled sequence
    v_dense: torch.Tensor,
    true_len: int,
) -> PagedKVCache:
    """Copy a dense-prefilled sequence into its pages (in place), one
    page-sized slice per page; ceil(true_len/page) pages are written."""
    page = cache.k_pages.shape[3]
    npages = -(-int(true_len) // page)
    if k_dense.shape[3] < npages * page:
        raise ValueError(
            f"dense prefill holds {k_dense.shape[3]} positions; "
            f"{npages * page} needed for true_len={true_len}"
        )
    row = cache.page_table[b_idx, :npages].tolist()
    for j, pid in enumerate(row):
        sl = slice(j * page, (j + 1) * page)
        cache.k_pages[:, pid] = k_dense[:, 0, :, sl].to(cache.k_pages.dtype)
        cache.v_pages[:, pid] = v_dense[:, 0, :, sl].to(cache.v_pages.dtype)
    cache.kv_len[b_idx] = int(true_len)
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy one pool page (K and V, all layers) — the prefix cache's
    copy-on-write clone. The destination gets its own copy of the data."""
    cache.k_pages[:, dst].copy_(cache.k_pages[:, src])
    cache.v_pages[:, dst].copy_(cache.v_pages[:, src])
    return cache


def gather_pages(cache: PagedKVCache, page_ids: list[int]):
    """Copy the listed pool pages to host tensors (``[L, n, Hkv, page,
    hd]``, pool dtype). Returns ``(k, v, None, None)`` — the JAX
    signature's scale slots stay None on a full-width pool. These are
    CPU tensors rather than numpy arrays: numpy has no bf16."""
    ids = torch.as_tensor([int(p) for p in page_ids], dtype=torch.long,
                          device=cache.k_pages.device)
    k = cache.k_pages.index_select(1, ids).cpu()
    v = cache.v_pages.index_select(1, ids).cpu()
    return k, v, None, None


def write_page(cache: PagedKVCache, pid: int, k_page, v_page) -> PagedKVCache:
    """Write one page's full content (``[L, Hkv, page, hd]``, both pools)
    into pool page ``pid``, verbatim."""
    cache.k_pages[:, int(pid)] = torch.as_tensor(k_page).to(
        cache.k_pages.device, cache.k_pages.dtype)
    cache.v_pages[:, int(pid)] = torch.as_tensor(v_page).to(
        cache.v_pages.device, cache.v_pages.dtype)
    return cache


def as_dense(cache: PagedKVCache, layer=None):
    """Contiguous ``[L?, B, Hkv, S_max, hd]`` views gathered through the
    table (tests; the serving path reads pages through the kernel)."""
    kp = cache.k_pages if layer is None else cache.k_pages[layer]
    vp = cache.v_pages if layer is None else cache.v_pages[layer]
    return (pages_to_dense(kp, cache.page_table),
            pages_to_dense(vp, cache.page_table))
