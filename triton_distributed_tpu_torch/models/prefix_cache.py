"""Radix prefix cache over the paged KV pool (host-only).

Counterpart of ``triton_distributed_tpu/models/prefix_cache.py``, near
verbatim: finished sequences donate their KV pages to a radix tree
instead of the free list; admission walks the tree with the new
prompt's tokens, maps every fully matched page into the new sequence's
page table by reference (refcounted), copy-on-write clones a partially
matched page, and prefills only the suffix. Unreferenced leaves are
evicted in LRU order when the pool runs short.

:meth:`PrefixCache.propose_continuations` reads the draft branches of
tree speculation from the tree (and from the KV tier's chains). With
a KV tier attached, eviction offers every full victim page to
``spill_fn`` before releasing it (``ContinuousEngine`` installs its
``_spill_page``). Not ported yet: the routing helpers
``prefix_digest``/``digest_match_len`` (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import heapq
import weakref
from typing import Iterable

from triton_distributed_tpu_torch.obs import events as obs_events
from triton_distributed_tpu_torch.obs import metrics as obs_metrics


def node_chain(node: "RadixNode") -> list[int]:
    """The full token chain from the root through ``node``'s own chunk —
    the identity a spilled page is keyed by in the KV tier
    (``kv_tier.chain_digest``). Walks parent links, so it must run
    BEFORE eviction detaches the node."""
    chunks = []
    while node is not None and node.chunk:
        chunks.append(node.chunk)
        node = node.parent
    out: list[int] = []
    for c in reversed(chunks):
        out.extend(c)
    return out


def round_chunk(n: int) -> int:
    """Prefill chunk widths: ≤128 → multiple of 16, beyond → multiple of
    128. These are the JAX package's widths (its TPU tiles), kept so both
    packages pad chunks alike and write the same pad rows."""
    n = max(int(n), 1)
    if n <= 128:
        return -(-n // 16) * 16
    return -(-n // 128) * 128


class RadixNode:
    """One cached page: ``chunk`` is the exact token ids it holds."""

    __slots__ = ("chunk", "page", "children", "refcount", "parent",
                 "last_use")

    def __init__(self, chunk: tuple[int, ...], page: int,
                 parent: "RadixNode | None"):
        self.chunk = chunk
        self.page = page
        self.children: dict[int, RadixNode] = {}
        self.refcount = 0
        self.parent = parent
        self.last_use = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"RadixNode(page={self.page}, fill={len(self.chunk)}, "
                f"rc={self.refcount}, kids={len(self.children)})")


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix walk. ``nodes`` are fully shared full
    pages (already refcounted); ``cow_node`` is a partially matched page
    to clone (refcount-pinned until :meth:`PrefixCache.finish_cow`)."""

    nodes: list[RadixNode]
    cow_node: RadixNode | None
    cow_len: int
    page_size: int

    @property
    def pages(self) -> list[int]:
        return [n.page for n in self.nodes]

    @property
    def matched_len(self) -> int:
        return len(self.nodes) * self.page_size + self.cow_len


class PrefixCache:
    """Host-side radix tree owning retired KV pages of a ``PagePool``."""

    # Live instances, auditable by the port's tests after every test.
    _live: "weakref.WeakSet[PrefixCache]" = weakref.WeakSet()

    def __init__(self, pool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self.root = RadixNode((), -1, None)
        self._clock = 0
        # KV tier hook: when set, eviction offers every full victim page
        # — ``spill_fn(chain, page_id)`` — BEFORE releasing it, so
        # "evicted" means "demoted to host RAM/disk". Best-effort: a
        # failed spill falls back to the plain drop.
        self.spill_fn = None
        PrefixCache._live.add(self)
        self.node_count = 0  # == pages held by the tree
        self.stats = {
            "lookups": 0,
            "hits": 0,
            "hit_tokens": 0,
            "cow_pages": 0,
            "inserted_pages": 0,
            "deduped_pages": 0,
            "evicted_pages": 0,
        }
        # Resolved ONCE (the ContinuousEngine `_metric_handles`
        # convention): evictions run inside the admission path, and a
        # per-eviction registry get-or-create would contend on the
        # process-global lock with the decode loop's increments.
        self._evicted_counter = obs_metrics.counter(
            "tdt_prefix_evicted_pages_total",
            "Radix-tree pages evicted back to the pool.",
        )

    # -- matching ---------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so at least one suffix token remains to
        prefill (its logits seed generation). Matched nodes are
        refcount-pinned; pair every match with exactly one of
        :meth:`release_match` (admission abandoned) or the
        finish_cow → :meth:`release_node`-per-node protocol."""
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1
        node = self.root
        nodes: list[RadixNode] = []
        cow_node, cow_len = None, 0
        i = 0
        while i < limit:
            child = node.children.get(toks[i])
            if child is None:
                break
            lcp = 0
            for a, b in zip(child.chunk, toks[i:i + len(child.chunk)]):
                if a != b:
                    break
                lcp += 1
            lcp = min(lcp, limit - i)
            if lcp == len(child.chunk) == self.page_size:
                nodes.append(child)
                node = child
                i += lcp
            else:
                if lcp > 0:
                    cow_node, cow_len = child, lcp
                break
        self._clock += 1
        for n in nodes:
            n.refcount += 1
            n.last_use = self._clock
        if cow_node is not None:
            cow_node.refcount += 1
            cow_node.last_use = self._clock
        self.stats["lookups"] += 1
        matched = len(nodes) * self.page_size + cow_len
        if matched:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += matched
        return PrefixMatch(nodes, cow_node, cow_len, self.page_size)

    def finish_cow(self, m: PrefixMatch) -> None:
        """Drop the COW pin after the device-side page clone is enqueued
        (ordering vs. later reuse of the source page is guaranteed by
        the cache arrays threading through the programs)."""
        if m.cow_node is not None:
            self.release_node(m.cow_node)
            m.cow_node = None
            self.stats["cow_pages"] += 1

    def release_match(self, m: PrefixMatch) -> None:
        """Undo :meth:`match` (admission did not go through) — pins AND
        the lookup accounting, so a stalled request re-matched on every
        retry can't inflate hit-rate counters."""
        matched = m.matched_len
        self.stats["lookups"] -= 1
        if matched:
            self.stats["hits"] -= 1
            self.stats["hit_tokens"] -= matched
        for n in m.nodes:
            self.release_node(n)
        m.nodes = []
        if m.cow_node is not None:
            self.release_node(m.cow_node)
            m.cow_node = None
        m.cow_len = 0

    def release_node(self, node: RadixNode) -> None:
        assert node.refcount > 0, "refcount underflow"
        node.refcount -= 1

    # -- insertion --------------------------------------------------------

    def insert_chain(
        self,
        parent: RadixNode,
        tokens: Iterable[int],
        pages: list[int],
    ) -> None:
        """Donate a finished sequence's private pages below ``parent``
        (its deepest shared node, or the root). ``pages[j]`` holds the
        KV of ``tokens[j*page_size : (j+1)*page_size]``; every page is
        consumed — adopted by a node, or released to the pool when its
        chunk is already cached (dedupe), diverges from a sibling that
        keeps its slot, or lies beyond the token chain (unused
        gen-headroom pages)."""
        toks = [int(t) for t in tokens]
        ps = self.page_size
        self._clock += 1
        node = parent
        i = 0
        k = 0
        while i < len(toks) and k < len(pages):
            chunk = tuple(toks[i:i + ps])
            child = node.children.get(chunk[0])
            if child is None:
                new = RadixNode(chunk, pages[k], node)
                new.last_use = self._clock
                node.children[chunk[0]] = new
                self.node_count += 1
                self.stats["inserted_pages"] += 1
                node = new
                i += len(chunk)
                k += 1
                if len(chunk) < ps:
                    break  # partial tail is a leaf; nothing descends
                continue
            lcp = 0
            for a, b in zip(child.chunk, chunk):
                if a != b:
                    break
                lcp += 1
            if lcp == len(child.chunk) == ps == len(chunk):
                # Identical full page already cached — ours is redundant.
                self.pool.release([pages[k]])
                self.stats["deduped_pages"] += 1
                child.last_use = self._clock
                node = child
                i += ps
                k += 1
                continue
            if (lcp == len(child.chunk) < len(chunk)
                    and child.refcount == 0):
                # Cached partial tail is a strict prefix of our chunk:
                # upgrade the node in place — ours supersedes it.
                self.pool.release([child.page])
                child.chunk = chunk
                child.page = pages[k]
                child.last_use = self._clock
                self.stats["inserted_pages"] += 1
                node = child
                i += len(chunk)
                k += 1
                if len(chunk) < ps:
                    break
                continue
            # Divergent sibling (or a pinned/longer partial we must not
            # touch): the remaining chain can't attach — stop. One
            # first-token slot per parent keeps matching O(1); the rare
            # collision costs cache coverage, never correctness.
            break
        self.pool.release(pages[k:])

    # -- eviction ---------------------------------------------------------

    def retire_sequence(self, tokens, pages: list[int],
                        shared_nodes: list[RadixNode]) -> None:
        """Finished-sequence release protocol, in one place for both
        engines: donate the private pages (those past the shared prefix)
        below the deepest pinned node, then drop the pins. ``tokens`` is
        the full cached token chain — prompt plus every fed-back
        generated token, i.e. positions ``[0, s + gen - 1)``."""
        parent = shared_nodes[-1] if shared_nodes else self.root
        n_sh = len(shared_nodes)
        self.insert_chain(
            parent, tokens[n_sh * self.page_size :], pages[n_sh:]
        )
        for node in shared_nodes:
            self.release_node(node)


    def reclaimable_pages(self) -> int:
        """Pages cascading LRU eviction could return to the pool right
        now: nodes whose subtree holds no refcounted node."""

        def rec(node: RadixNode) -> tuple[int, bool]:
            total, pinned = 0, node.refcount > 0
            for c in node.children.values():
                t, p = rec(c)
                total += t
                pinned = pinned or p
            if node is self.root:
                return total, pinned
            return (total, True) if pinned else (total + 1, False)

        return rec(self.root)[0]

    def evict_until(self, free_target: int) -> int:
        """Evict unreferenced LRU leaves until the pool holds
        ``free_target`` free pages (or nothing is evictable)."""
        heap: list[tuple[int, int, RadixNode]] = []

        def seed(node: RadixNode):
            for c in node.children.values():
                if c.children:
                    seed(c)
                elif c.refcount == 0:
                    heapq.heappush(heap, (c.last_use, id(c), c))

        seed(self.root)
        evicted = 0
        while heap and len(self.pool.free) < free_target:
            _, _, victim = heapq.heappop(heap)
            if (victim.parent is None or victim.children
                    or victim.refcount):
                continue  # stale heap entry
            if (self.spill_fn is not None
                    and len(victim.chunk) == self.page_size):
                # Full pages only: fault-back re-maps whole tree pages. The
                # chain is read before the detach below severs the links.
                try:
                    self.spill_fn(node_chain(victim), victim.page)
                except Exception:  # noqa: BLE001 — spill is best-effort
                    obs_events.emit("tier_spill_failed", page=victim.page)
            parent = victim.parent
            del parent.children[victim.chunk[0]]
            victim.parent = None
            self.pool.release([victim.page])
            self.node_count -= 1
            evicted += 1
            if (parent is not self.root and not parent.children
                    and parent.refcount == 0):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        self.stats["evicted_pages"] += evicted
        if evicted:
            obs_events.emit("prefix_evict", pages=evicted)
            self._evicted_counter.inc(evicted)
        return evicted

    def allocate(self, n: int) -> list[int] | None:
        """Allocate ``n`` pool pages, evicting cached (unreferenced)
        pages LRU-first when the free list runs short. None when even
        full eviction cannot cover ``n`` (caller queues the request)."""
        if n > len(self.pool.free):
            self.evict_until(n)
        if n > len(self.pool.free):
            return None
        return self.pool.allocate(n)

    # -- introspection ----------------------------------------------------

    def audit(self) -> list[str]:
        """Structural invariant check; returns violation strings
        (empty == clean). Verifies what the tree can see on its own —
        the engine-level :meth:`ContinuousEngine.audit` adds the
        refcount-vs-live-slot and pool-partition cross-checks:

        - no page appears under two nodes, or under a node AND on the
          free list,
        - children are indexed by their chunk's first token and parent
          links are consistent,
        - a partially filled page is a leaf, chunks are non-empty and
          at most ``page_size`` tokens,
        - refcounts are non-negative and ``node_count`` matches the
          walk.
        """
        problems: list[str] = []
        free = set(self.pool.free)
        seen: dict[int, RadixNode] = {}
        count = 0
        stack: list[RadixNode] = [self.root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                count += 1
                if not child.chunk:
                    problems.append(f"node page {child.page} has an "
                                    "empty chunk")
                elif key != child.chunk[0]:
                    problems.append(
                        f"child indexed by {key} but chunk starts with "
                        f"{child.chunk[0]} (page {child.page})"
                    )
                if len(child.chunk) > self.page_size:
                    problems.append(
                        f"node page {child.page} chunk overflows the "
                        f"page ({len(child.chunk)} > {self.page_size})"
                    )
                if len(child.chunk) < self.page_size and child.children:
                    problems.append(
                        f"partial page {child.page} "
                        f"({len(child.chunk)} tokens) has children"
                    )
                if child.parent is not node:
                    problems.append(
                        f"node page {child.page} has a broken parent link"
                    )
                if child.refcount < 0:
                    problems.append(
                        f"node page {child.page} refcount underflow "
                        f"({child.refcount})"
                    )
                if child.page in seen:
                    problems.append(f"page {child.page} cached by two "
                                    "tree nodes")
                else:
                    seen[child.page] = child
                if child.page in free:
                    problems.append(
                        f"page {child.page} cached by the tree AND on "
                        "the free list"
                    )
                stack.append(child)
        if count != self.node_count:
            problems.append(
                f"node_count={self.node_count} but the walk found {count}"
            )
        return problems

    @property
    def hit_rate(self) -> float:
        return self.stats["hits"] / max(self.stats["lookups"], 1)

    def walk(self):
        """Yield every node (tests/debugging)."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # -- speculation ------------------------------------------------------

    def propose_continuations(
        self,
        tokens,
        *,
        width: int,
        depth: int,
        tier_chains=None,
    ) -> list[list[int]]:
        """Draft continuations of ``tokens`` for tree speculation: up to
        ``width`` candidate paths of up to ``depth`` tokens each, read
        from what the tree remembers FOLLOWING this exact history (the
        chains of finished sequences that shared it and then diverged
        show up as sibling children).

        Pure read: no pins, no LRU touch, no stats. The walk needs the
        FULL history cached token for token; any mismatch, or the cache
        ending before the history does, returns no paths. Branches are
        explored most recently used first.

        ``tier_chains`` (``PageStore.resident_chains``) adds the KV tier's
        RAM-resident chains: continuations whose pages left the tree but
        whose tokens survive in the spill payloads, found by a flat
        prefix scan after the tree's paths."""
        toks = [int(t) for t in tokens]
        width = max(int(width), 0)
        depth = max(int(depth), 0)
        out: list[list[int]] = []
        if depth and width:
            self._tree_continuations(toks, width, depth, out)
        if tier_chains:
            hits = 0
            for chain in tier_chains:
                if hits >= width:
                    break
                if len(chain) > len(toks) and chain[:len(toks)] == toks:
                    out.append(
                        [int(t) for t in chain[len(toks):len(toks) + depth]]
                    )
                    hits += 1
        return out

    def _tree_continuations(self, toks: list[int], width: int, depth: int,
                            out: list) -> None:
        """The radix paths of :meth:`propose_continuations`, into ``out``."""
        node, stem, i = self.root, [], 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                return
            lcp = 0
            for a, b in zip(child.chunk, toks[i:i + len(child.chunk)]):
                if a != b:
                    break
                lcp += 1
            if lcp < len(child.chunk):
                if i + lcp != len(toks):
                    return  # diverged mid-chunk: another prefix
                # The history ends inside this chunk: the chunk's tail is
                # the (single) stem, then the subtree below it.
                stem = [int(t) for t in child.chunk[lcp:]]
                node = child
                break
            if len(child.chunk) < self.page_size and i + lcp < len(toks):
                return  # a partial leaf the history runs past
            node = child
            i += lcp

        def descend(n: RadixNode, prefix: list[int]) -> None:
            if len(out) >= width:
                return
            if len(prefix) >= depth or not n.children:
                if prefix:
                    out.append(prefix[:depth])
                return
            for c in sorted(n.children.values(), key=lambda x: -x.last_use):
                descend(c, prefix + [int(t) for t in c.chunk])
                if len(out) >= width:
                    return

        descend(node, stem)
