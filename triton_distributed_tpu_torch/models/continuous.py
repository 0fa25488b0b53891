"""Continuous batching over the paged KV pool.

Counterpart of the core of ``triton_distributed_tpu/models/continuous.py``:
admit a request the moment a slot and enough pool pages are free, step
the union of in-flight requests one batched decode at a time, evict on
completion. Slot state (page-table rows, kv_len, free list) is host-side;
``_sync_tables`` mirrors it into the device cache. Inactive slots keep a
zeroed table row and kv_len 0, so their (ignored) appends land on the
reserved trash page 0.

With ``prefix_cache=True`` finished sequences retire their pages into a
radix tree and admission maps the longest cached prefix (refcounted, COW
for a partially matched page), chunk-prefilling only the suffix with a
decode step of the running batch between chunks.

Requests fail individually: an unservable, shed (``max_queue``),
deadline-expired or crashed request tears down only its own slot and
surfaces a structured :class:`RequestResult`. ``run()`` ends with the
pool/radix invariant audit.

``kv_dtype="int8"`` stores the pool as int8 codes plus one f32 scale per
(layer, page, kv head); COW clones carry the scales with the codes.

``speculative=K`` drafts up to K tokens per slot from its own n-gram
history and verifies them in one chunk forward per drafted slot; slots
with no draft share the round's batched decode step. With ``spec_width
> 1`` on a full-width pool, a slot whose radix tree holds several
continuations of its history drafts a token trie, verified under the
ancestor mask, and the accepted branch's KV rows move into place. The
host-side kv_len resync (``_sync_tables``) is the rollback.

``mode="mega"`` decodes in ``ns``-step launches of the megakernel: one
launch emits up to ``ns`` tokens per slot (in-kernel argmax), over the
smallest power-of-two batch bucket that covers the active slots
(``mega_buckets``); a slot finishing inside the launch keeps only its
``n_valid`` rows (the rest go to the trash page) and, with ``eos_id``,
stops at its first stop token, found in the kernel. A round that cannot
launch (a slot within ``ns`` of ``max_length``) takes a single-step
launch of the same kernel.

Greedy only. Not ported, and refused when asked for: sampled requests
(``temperature > 0``), resident decode, ``MegaConfig(wq8=True)``,
slot migration/snapshots, the KV tier and fabric,
context-parallel prefill and sharded long-context slots, the device task
tracer (ROADMAP queue 1). Cancellation, request timelines and fault
seams are not ported either.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import Counter, deque

import numpy as np
import torch

from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.engine import (
    SAMPLED_SERVING,
    MegaDispatch,
    engine_setup,
    prefill_suffix_chunks,
)
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    PoolAuditError,
    audit_pool,
    copy_page,
    init_paged_cache,
    kv_bytes_per_token,
    resolve_kv_dtype,
    truncate_pages,
    write_prefill,
)
from triton_distributed_tpu_torch.models.prefix_cache import (
    PrefixCache,
    PrefixMatch,
    round_chunk,
)
from triton_distributed_tpu_torch.models.speculative import (
    SpecState,
    TreeDraft,
    cap_draft,
    commit_tree_path,
    spec_verify_slot,
    spec_verify_tree,
)
from triton_distributed_tpu_torch.models.stats import (
    STAT_METRIC_ALIASES,
    STAT_METRICS,
    kv_dtype_name,
    spec_summary,
)
from triton_distributed_tpu_torch.obs import events as obs_events
from triton_distributed_tpu_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class RequestError:
    """Structured failure: a machine-readable ``status`` plus a human
    ``reason``. Statuses: ``unservable`` (can never fit), ``overloaded``
    (shed by the bounded admission queue), ``deadline_exceeded``,
    ``nan_logits`` (non-finite model output), ``failed`` (crash isolated
    to this request), ``aborted`` (the engine loop itself died)."""

    status: str
    reason: str


@dataclasses.dataclass
class RequestResult:
    """One request's outcome: generated tokens (partial when the request
    failed mid-decode) and its status."""

    tokens: np.ndarray
    status: str = "ok"
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def error(self) -> RequestError | None:
        return None if self.ok else RequestError(self.status, self.reason)


class RequestFailedError(RuntimeError):
    """Raised by ``run(results=False)`` when requests failed: the engine
    completes what it can, tears the failures down cleanly, and raises
    this with every per-request failure attached."""

    def __init__(self, failures):
        self.failures = failures  # list[(index, Request)]
        msgs = "; ".join(
            f"request {i}: [{r.status}] {r.reason}" for i, r in failures
        )
        super().__init__(f"{len(failures)} request(s) failed: {msgs}")


_FAIL_EVENT_KIND = {
    "overloaded": "shed",
    "deadline_exceeded": "deadline",
    "nan_logits": "nan_guard",
}


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated output.
    ``deadline_s`` is a wall-clock budget measured from ``run()`` entry;
    ``temperature`` must be None or 0 (greedy) in this slice."""

    prompt: np.ndarray  # [S] int32
    gen_len: int
    temperature: float | None = None
    deadline_s: float | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    # Tree nodes whose pages lead this request's page list (refcounted
    # for the request's lifetime).
    shared_nodes: list = dataclasses.field(default_factory=list)
    # Per-request SpecState when the engine runs with speculative=K.
    spec: SpecState | None = None
    status: str = "ok"
    reason: str = ""
    deadline_at: float | None = dataclasses.field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.gen_len

    def result(self) -> RequestResult:
        return RequestResult(np.asarray(self.out, np.int32), self.status,
                             self.reason)


# Knobs of the JAX ContinuousEngine this slice does not port: each
# raises NotImplementedError when set (ROADMAP queues 1 and 2).
_UNPORTED = ("resident",
             "kernel_trace", "snapshot_every", "tier_bytes", "tier_dir",
             "tier", "fabric", "rank_page_budget")


@dataclasses.dataclass
class _MegaPlan:
    """One megakernel launch: launch row → engine slot (-1 = bucket
    filler), the bucket width, kept-row counts and stop tokens."""

    rows: list
    B: int
    compact: bool           # B < max_batch: compacted table/kv_len/tok
    eos: bool               # device stop-token test
    n_valid: np.ndarray     # [B] kept-row counts fed to append_n
    stop_tok: np.ndarray | None  # [B] when eos


class ContinuousEngine(MegaDispatch):
    """Admission/eviction serving loop over the paged pool.

    ``max_batch`` decode slots share ``num_pages`` pool pages; a request
    is admitted when a slot AND enough pages for its prompt+gen_len are
    free (cached prefix pages count as free coverage). Page 0 is
    reserved as the trash page for inactive slots. ``max_queue`` bounds
    the admission queue: requests beyond it are shed with a structured
    ``overloaded`` error (None → unbounded). Runs on ``cuda`` unless
    ``device`` says otherwise; it must be the model's device.
    """

    _live: "weakref.WeakSet[ContinuousEngine]" = weakref.WeakSet()

    def __init__(
        self,
        model,
        *,
        max_batch: int = 4,
        page_size: int = 128,
        max_length: int | None = None,
        num_pages: int | None = None,
        mode: str = "xla",
        temperature: float = 0.0,
        eos_id: int | None = None,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        speculative: int = 0,
        spec_width: int = 4,
        max_queue: int | None = None,
        kv_dtype: str | None = None,
        cp: int = 1,
        mega_cfg=None,
        ns: int = 8,
        mega_buckets: bool = True,
        device=None,
        **unported,
    ):
        unknown = set(unported) - set(_UNPORTED)
        if unknown:
            raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
        if cp != 1:
            raise NotImplementedError(
                "cp > 1 (context-parallel prefill) is not ported yet "
                "(ROADMAP queue 1, item 11)"
            )
        engine_setup(model, device, mode, temperature, mega_cfg, **unported)
        if int(ns) < 1:
            raise ValueError(f"ns must be >= 1, got {ns}")
        if speculative and mode == "mega":
            raise ValueError(
                "speculative=K does not compose with mode='mega': a launch "
                "advances every slot ns tokens in lockstep")
        self.model = model
        self.mode = mode
        self.mega_cfg = mega_cfg
        # The megakernel's launch width and its batch buckets.
        self.NS = int(ns)
        self.mega_buckets = bool(mega_buckets)
        self.eos_id = eos_id
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_length = max_length or model.cfg.max_length
        if self.max_length % page_size:
            raise ValueError(
                f"max_length {self.max_length} is not a multiple of "
                f"page_size {page_size}: pages_per_seq would silently "
                f"truncate to {self.max_length // page_size} and the "
                f"tail tokens would have no page — pick an aligned pair"
            )
        self.pps = self.max_length // page_size
        self.max_queue = max_queue
        # +1: page 0 is reserved as the trash page every inactive slot's
        # table points at, and must not shave serviceable capacity.
        n_pages = (num_pages or max_batch * self.pps) + 1
        # int8 KV: the explicit knob wins over the model config's.
        self.kv_dtype = resolve_kv_dtype(kv_dtype, model.cfg)
        self.speculative = int(speculative)
        # Draft trees only on a full-width pool: the commit is a KV
        # row-move, which an int8 pool's per-page scales cannot carry.
        self.spec_width = max(int(spec_width), 1)
        self._spec_tree = (bool(speculative) and self.spec_width > 1
                           and self.kv_dtype is None)
        self.cache, self.pool = init_paged_cache(
            model.cfg, max_batch, model.device,
            max_length=self.max_length, page_size=page_size,
            num_pages=n_pages, assign_pages=False, kv_dtype=self.kv_dtype,
        )
        self.pool.free = [p for p in self.pool.free if p != 0]
        self._capacity = len(self.pool.free)
        self._table = np.zeros((max_batch, self.pps), np.int32)
        self._kv_len = np.zeros((max_batch,), np.int32)
        self._tok = np.zeros((max_batch,), np.int32)
        self._slots: list[Request | None] = [None] * max_batch
        self.prefix = PrefixCache(self.pool, page_size) if prefix_cache else None
        self.prefill_chunk = round_chunk(prefill_chunk) if prefill_chunk else 0
        # Dense batch-1 prefill scratch — only the non-prefix admission
        # path copies through it; the chunked path writes pages directly.
        self._dense1 = None if prefix_cache else model.new_cache(
            1, self.max_length
        )
        self.stats = self._zero_stats()
        self._metric_handles = {
            key: [obs_metrics.counter(*named) for named in
                  ((name, help),) + STAT_METRIC_ALIASES.get(key, ())]
            for key, (name, help) in STAT_METRICS.items()
        }
        self._free_pages_gauge = obs_metrics.gauge(
            "tdt_engine_free_pages", "Pool pages on the free list."
        )
        self._spec_accept_gauge = obs_metrics.gauge(
            "tdt_spec_accept_rate",
            "Cumulative speculative accept rate (accepted / drafted) "
            "of the last run.",
        )
        ContinuousEngine._live.add(self)

    @staticmethod
    def _zero_stats() -> dict:
        return {key: 0 for key in STAT_METRICS}

    @property
    def last_stats(self) -> dict:
        """Serving counters of the last ``run()``: admission / prefill
        work done, prefix-cache reuse, COW copies, stalls, and the
        fault-isolation ledger."""
        stats = dict(self.stats)
        stats["free_pages"] = len(self.pool.free)
        stats["kv_bytes_per_token"] = kv_bytes_per_token(self.cache)
        stats["kv_dtype"] = kv_dtype_name(self.kv_dtype,
                                          self.cache.k_pages.dtype)
        if self.prefix is not None:
            stats["prefix_cache"] = dict(self.prefix.stats)
            stats["prefix_hit_rate"] = self.prefix.hit_rate
            stats["tree_pages"] = self.prefix.node_count
        if self.speculative:
            stats.update(spec_summary(stats))
        return stats

    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a serving counter and every registry metric that
        mirrors it."""
        self.stats[key] += n
        for handle in self._metric_handles[key]:
            handle.inc(n)

    # -- slot management -------------------------------------------------

    def _sync_tables(self) -> None:
        """Mirror the host page table and kv_len into the device cache
        (copies, so later host edits never race a launched step)."""
        self._free_pages_gauge.set(len(self.pool.free))
        dev = self.model.device
        self.cache = dataclasses.replace(
            self.cache,
            page_table=torch.from_numpy(self._table.copy()).to(dev),
            kv_len=torch.from_numpy(self._kv_len.copy()).to(dev),
        )

    def _admit(self, req: Request, slot: int, m: PrefixMatch | None = None):
        """Prefill ``req`` into ``slot``; returns the first token."""
        if self.prefix is not None:
            return self._admit_prefix(req, slot, m)
        s = len(req.prompt)
        need = self._needed_pages(s, req.gen_len)
        req.slot = slot  # before any allocation: teardown keys off it
        req.pages = self.pool.allocate(need)
        self._table[slot] = 0
        self._table[slot, : len(req.pages)] = req.pages
        self._kv_len[slot] = s
        self._sync_tables()
        logits, self._dense1 = self.model.prefill_batched(
            req.prompt[None], self._dense1, self._prefill_mode, [s],
        )
        self.cache = write_prefill(
            self.cache, slot, self._dense1.k, self._dense1.v, s
        )
        self._bump("admitted")
        self._bump("prefill_tokens", s)
        obs_events.emit("admit", slot=slot, prompt_len=s, matched=0)
        self._slots[slot] = req
        return self._sample_req(req, logits[0])

    def _admit_prefix(self, req: Request, slot: int, m: PrefixMatch):
        """Prefix-cache admission: map the matched prefix pages into the
        slot's table row, COW-clone a partially matched tail, then
        chunk-prefill only the suffix."""
        s = len(req.prompt)
        total = self._needed_pages(s, req.gen_len)
        req.slot = slot  # before any allocation: teardown keys off it
        new_pages = self.prefix.allocate(total - len(m.nodes))
        if new_pages is None:
            raise RuntimeError("try_admit availability check failed")
        matched = m.matched_len
        req.pages = m.pages + new_pages
        req.shared_nodes = list(m.nodes)
        # Pins now ride on the request: the admission failure handler
        # releases m's REMAINING pins, the slot teardown the request's.
        m.nodes = []
        self._table[slot] = 0
        self._table[slot, : len(req.pages)] = req.pages
        if m.cow_len:
            # The partially matched page becomes this request's first
            # private page: clone it, count only the matched positions.
            self.cache = copy_page(self.cache, m.cow_node.page, new_pages[0])
            self._bump("pages_cow_copied")
            obs_events.emit("cow", slot=slot, matched=m.cow_len)
        self.prefix.finish_cow(m)
        self._kv_len[slot] = matched
        self._sync_tables()
        logits = self._prefill_suffix(slot, req.prompt, matched)
        self._bump("admitted")
        self._bump("prefix_hit_tokens", matched)
        obs_events.emit("admit", slot=slot, prompt_len=s, matched=matched)
        self._slots[slot] = req
        return self._sample_req(req, logits)

    def _prefill_suffix(self, slot: int, prompt: np.ndarray, start: int):
        """Chunk-prefill ``prompt[start:]`` into ``slot``'s pages,
        stepping the running batch between chunks. Returns the last real
        token's logits ``[V]``."""

        def between_chunks(cache, new_len):
            # The chunk set the slot's device kv_len absolutely, so host
            # and device agree even after interleaved decode steps.
            self.cache = cache
            self._kv_len[slot] = new_len
            if self._step_guard(self._decode_once):
                # An interleaved decode finished (or failed) a request:
                # the device table must drop its pages BEFORE the next
                # chunk, or the stale row's append would corrupt a page.
                self._sync_tables()
            return self.cache

        logits, self.cache, chunks = prefill_suffix_chunks(
            self.model, self.cache, slot, prompt, start,
            self.prefill_chunk, self._prefill_mode, between_chunks,
        )
        self._kv_len[slot] = len(prompt)
        self._bump("prefill_tokens", len(prompt) - start)
        self._bump("prefill_chunks", chunks)
        return logits

    def _decode_once(self) -> bool:
        """One batched decode of every active slot; appends greedy tokens
        and evicts finished requests. Returns whether slot state
        changed."""
        active = np.asarray([r is not None for r in self._slots], np.int32)
        if not active.any():
            return False
        logits, self.cache = self._decode_step(
            torch.from_numpy(self._tok.copy()), self.cache
        )
        self._kv_len = self._kv_len + active
        self._bump("decode_steps")
        # The finite mask and the greedy tokens come back in one fetch.
        finite = torch.isfinite(logits).all(dim=-1)
        both = torch.stack([finite.to(torch.int32), sampling.greedy(logits)])
        finite, nxt = both.cpu().numpy()
        failed = self._guard_logits(finite)
        changed = self._process(lambda slot: [nxt[slot]])
        return changed or bool(failed)

    def _guard_logits(self, finite: np.ndarray) -> list[int]:
        """Fail ONLY the slots whose logits went non-finite."""
        failed = []
        for slot, req in enumerate(self._slots):
            if req is None or bool(finite[slot]):
                continue
            self._bump("nonfinite_logits")
            self._fail(
                req, "nan_logits",
                f"non-finite logits at decode step "
                f"{self.stats['decode_steps']} after {len(req.out)} tokens",
            )
            failed.append(slot)
        return failed

    def _process(self, slot_tokens) -> bool:
        """Append per-slot tokens; evict on gen_len/eos."""
        changed = False
        emitted = 0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for t in slot_tokens(slot):
                req.out.append(int(t))
                emitted += 1
                self._tok[slot] = int(t)
                if req.spec is not None:
                    req.spec.observe((int(t),))
                if self._maybe_finish(req, int(t)):
                    changed = True
                    break
        if emitted:
            self._bump("generated_tokens", emitted)
        return changed

    def _evict(self, req: Request) -> None:
        slot = req.slot
        obs_events.emit("evict", slot=slot, tokens_out=len(req.out))
        if self.prefix is not None:
            self._retire_to_prefix(req)
        else:
            req.pages = truncate_pages(
                self.pool, req.pages, 0, self.page_size
            )
        self._table[slot] = 0  # back to the trash page
        self._kv_len[slot] = 0
        req.pages, req.slot = [], None
        self._slots[slot] = None

    # -- failure isolation -----------------------------------------------

    def _fail(self, req: Request, status: str, reason) -> None:
        """Fail ONE request: record the structured error and tear down
        its slot, if it holds one. Everything else keeps serving."""
        req.status, req.reason = status, str(reason)
        self._bump("failed_requests")
        if status == "deadline_exceeded":
            self._bump("deadline_expired")
        elif status == "overloaded":
            self._bump("shed_requests")
        if req.slot is not None:
            self._teardown_slot(req)
        obs_events.emit(
            _FAIL_EVENT_KIND.get(status, "request_failed"),
            status=status, tokens_out=len(req.out),
            reason=str(reason)[:200],
        )

    def _teardown_slot(self, req: Request) -> None:
        """Crash-safe slot release: private pages to the pool, shared
        prefix pins back to the tree, table row back to the trash page.
        Nothing is donated to the tree: a failed request's KV is
        suspect."""
        slot = req.slot
        truncate_pages(
            self.pool, req.pages, 0, self.page_size,
            shared=len(req.shared_nodes),
        )
        if self.prefix is not None:
            for node in req.shared_nodes:
                self.prefix.release_node(node)
        req.shared_nodes = []
        req.pages = []
        self._table[slot] = 0
        self._kv_len[slot] = 0
        self._slots[slot] = None
        req.slot = None

    def _admit_failure(self, req: Request, m: PrefixMatch | None, e) -> None:
        """Clean up a failed admission: release the prefix pins not yet
        moved to the request, tear down its slot state, mark it failed,
        resync the device table."""
        if self.prefix is not None and m is not None:
            if m.cow_node is not None:
                self.prefix.release_node(m.cow_node)
                m.cow_node = None
            for node in m.nodes:
                self.prefix.release_node(node)
            m.nodes = []
        status = "failed"
        if isinstance(e, sampling.NonFiniteLogitsError):
            status = "nan_logits"
            self._bump("nonfinite_logits")
        self._fail(req, status, f"{type(e).__name__}: {e}")
        self._sync_tables()

    def _step_guard(self, fn) -> bool:
        """Run one decode-phase step with per-request error isolation: an
        exception carrying a ``slot`` fails that request; anything else
        fails the whole in-flight set, and the engine stays reusable."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — isolation boundary
            self._bump("decode_faults")
            slot = getattr(e, "slot", None)
            if (isinstance(slot, int) and 0 <= slot < self.max_batch
                    and self._slots[slot] is not None):
                victims = [self._slots[slot]]
            else:
                victims = [r for r in self._slots if r is not None]
            for r in victims:
                self._fail(r, "failed", f"{type(e).__name__}: {e}")
            self._sync_tables()
            return True

    def _expire_deadlines(self) -> bool:
        """Fail every active request whose wall-clock deadline passed."""
        now = time.monotonic()
        changed = False
        for req in list(self._slots):
            if req is None or req.deadline_at is None:
                continue
            if now > req.deadline_at:
                self._fail(
                    req, "deadline_exceeded",
                    f"deadline_s={req.deadline_s} exceeded after "
                    f"{len(req.out)} generated tokens",
                )
                changed = True
        return changed

    def _retire_to_prefix(self, req: Request) -> None:
        """Donate the finished request's KV pages to the radix tree.
        Valid KV covers positions ``[0, s + len(out) - 1)`` — the last
        sampled token was never fed back."""
        gen_cached = max(len(req.out) - 1, 0)
        toks = np.concatenate(
            [req.prompt, np.asarray(req.out[:gen_cached], np.int32)]
        )
        self.prefix.retire_sequence(toks, req.pages, req.shared_nodes)
        req.shared_nodes = []

    def _sample_req(self, req: Request, logits: torch.Tensor) -> int:
        """The greedy first token from an admission's ``logits [V]``."""
        if not bool(torch.isfinite(logits).all()):
            raise sampling.NonFiniteLogitsError(
                "non-finite logits from the admission prefill",
                slot=req.slot,
            )
        return int(sampling.greedy(logits))

    def _needed_pages(self, prompt_len: int, gen_len: int) -> int:
        return -(-(prompt_len + gen_len) // self.page_size)

    def _maybe_finish(self, req: Request, t: int) -> bool:
        """Evict ``req`` if token ``t`` completed it (gen_len or eos)."""
        if req.done or (self.eos_id is not None and t == self.eos_id):
            self._evict(req)  # free pages NOW
            return True
        return False

    # -- speculative decoding ---------------------------------------------

    def _step(self) -> bool:
        """One scheduling round of the in-flight batch: with speculation,
        a verify chunk for each slot that drafted plus ONE batched decode
        step for the rest (and one more token for the verified slots);
        under ``mode='mega'`` one ``ns``-step launch, or a single step
        when the round cannot launch; else one batched decode step.
        Returns whether slot state changed."""
        if self.mode == "mega":
            plan = self._mega_plan()
            if plan is not None:
                return self._drain_launch(*self._launch_mega(plan))
            self._bump("mega_fallback_steps")
            return self._decode_once()
        if not self.speculative:
            return self._decode_once()
        drafts, ok = self._plan_drafts()
        drafted = {s: d for s, d in drafts.items() if d} if ok else {}
        n_active = sum(r is not None for r in self._slots)
        changed = False
        if drafted:
            changed = self._spec_round(drafted)
        if not ok or len(drafted) < n_active:
            changed = self._decode_once() or changed
        return changed

    # -- megakernel rounds --------------------------------------------------

    def _mega_plan(self) -> _MegaPlan | None:
        """Compose the next launch from host truth, or None when a slot is
        within ``ns`` of ``max_length`` (its ``ns`` appended rows would
        pass the page table) and the round takes a single step."""
        active = np.asarray([r is not None for r in self._slots], np.int32)
        if int((self._kv_len * active).max()) + self.NS > self.max_length:
            return None
        act = [s for s in range(self.max_batch) if self._slots[s] is not None]
        # Batch bucket: the smallest power of two covering the active
        # slots; a full-width round keeps the identity layout.
        B = self.max_batch
        if self.mega_buckets and act:
            b = 1
            while b < len(act):
                b *= 2
            B = min(b, self.max_batch)
        compact = B < self.max_batch
        rows = (act + [-1] * (B - len(act)) if compact
                else list(range(self.max_batch)))
        # Kept-row counts: a slot finishing inside the launch (known now
        # from gen_len) sends its overshoot rows to the trash page.
        n_valid = np.zeros(B, np.int32)
        stop_tok = np.full(B, -1, np.int32)
        for i, slot in enumerate(rows):
            req = self._slots[slot] if slot >= 0 else None
            if req is None:
                continue
            n_valid[i] = min(req.gen_len - len(req.out), self.NS)
            if self.eos_id is not None:
                stop_tok[i] = self.eos_id
        eos = self.eos_id is not None and self.NS > 1
        return _MegaPlan(rows=rows, B=B, compact=compact, eos=eos,
                         n_valid=n_valid,
                         stop_tok=stop_tok if eos else None)

    def _launch_mega(self, plan: _MegaPlan):
        """One ``ns``-step launch for ``plan``, with the launch-time host
        bookkeeping (projected kv_len, counters). A bucket launch runs on
        compacted table/kv_len views of the same pools; filler rows keep
        a zeroed table row (the trash page) and kv_len 0. Returns
        ``(plan, toks [NS, B], stop_step [B] or None)``, on the device."""
        NS = self.NS
        dev = self.model.device
        rows = np.asarray([max(s, 0) for s in plan.rows], np.int64)
        tok = torch.from_numpy(self._tok[rows].copy())
        cache_in = self.cache
        if plan.compact:
            tbl = self._table[rows].copy()
            kvl = self._kv_len[rows].copy()
            for i, slot in enumerate(plan.rows):
                if slot < 0 or self._slots[slot] is None:
                    tbl[i] = 0
                    kvl[i] = 0
            cache_in = dataclasses.replace(
                self.cache, page_table=torch.from_numpy(tbl).to(dev),
                kv_len=torch.from_numpy(kvl).to(dev))
        extra = [plan.n_valid]
        if plan.eos:
            extra += [plan.stop_tok, np.zeros(plan.B, np.int32)]
        mega = self._mega_model()
        fn = mega.decode_multi_fn(
            plan.B, self.max_length, NS, page=self.page_size,
            num_pages=int(self.cache.k_pages.shape[1]), valid_arg=True,
            eos=plan.eos)
        outs = fn(mega._step_params(), tok, cache_in, *extra)
        toks, new_cache = outs[0], outs[2]
        ss = outs[3] if plan.eos else None
        adv = np.zeros(self.max_batch, np.int32)
        for i, slot in enumerate(plan.rows):
            if (slot >= 0 and self._slots[slot] is not None
                    and plan.n_valid[i] > 0):
                adv[slot] = 1
        self._kv_len = self._kv_len + NS * adv
        # The pools were written in place; kv_len (and a bucket's
        # full-width table) come back from the host truth, so an idle
        # slot's length never drifts past the table.
        self.cache = dataclasses.replace(
            new_cache, page_table=self.cache.page_table,
            kv_len=torch.from_numpy(self._kv_len.copy()).to(dev))
        if plan.compact:
            self._bump("mega_bucket_launches")
        self._bump("decode_steps", NS)
        self._bump("mega_launches")
        obs_events.emit("mega:launch", ns=NS, active=int(sum(
            s >= 0 and self._slots[s] is not None for s in plan.rows)))
        return plan, toks, ss

    def _drain_launch(self, plan: _MegaPlan, toks, ss) -> bool:
        """Fetch one launch's tokens and emit/retire through the normal
        paths. A device stop-token hit (``stop_step < n_valid``) ends the
        row's stream at the stop token."""
        toks_np = toks.cpu().numpy()  # [NS, B]: the host sync
        ss_np = ss.cpu().numpy() if ss is not None else None
        col = {slot: i for i, slot in enumerate(plan.rows) if slot >= 0}
        if ss_np is not None:
            for slot, i in col.items():
                if (self._slots[slot] is not None
                        and ss_np[i] < plan.n_valid[i]):
                    self._bump("mega_device_retires")

        def slot_tokens(slot):
            i = col.get(slot)
            if i is None:
                return ()
            n = int(plan.n_valid[i])
            if ss_np is not None:
                n = min(n, int(ss_np[i]) + 1)
            return toks_np[:n, i]

        return self._process(slot_tokens)

    def _plan_drafts(self):
        """A draft for every active slot: a ``TreeDraft`` when tree
        speculation is on and the slot's candidates branch, else a token
        list. Returns ``(drafts, ok)``; ``ok=False`` when some slot is
        too near ``max_length`` for even a zero-draft chunk, and the
        round must take the batched decode step."""
        drafts: dict = {}
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            budget = req.gen_len - len(req.out)
            k = cap_draft(req.spec.k, int(self._kv_len[slot]), budget,
                          self.max_length)
            if k < 0:
                return {}, False
            if k == 0:
                drafts[slot] = []
                continue
            if self._spec_tree and req.spec.width > 1:
                tree = self._plan_tree(req, slot, k)
                if tree is not None:
                    drafts[slot] = tree
                    continue
            drafts[slot] = req.spec.propose(k)
        return drafts, True

    def _plan_tree(self, req: Request, slot: int, k: int):
        """``slot``'s draft trie for a ``k``-token budget from the radix
        tree's continuations of its full history plus its n-gram
        proposal, or None when they do not branch. At most
        ``round_chunk(k + 1)`` nodes: the extra branches ride in rows the
        linear chunk would have padded."""
        if self.prefix is None:
            return None
        hist = [int(t) for t in req.prompt] + [int(t) for t in req.out]
        paths = self.prefix.propose_continuations(
            hist, width=req.spec.width, depth=k)
        ngram = req.spec.propose(k)
        if ngram:
            paths.append(ngram)
        if not paths:
            return None
        tree = TreeDraft(int(self._tok[slot]))
        for p in paths:
            tree.add_path(p[:k], budget=round_chunk(k + 1))
        return None if tree.is_chain else tree

    def _spec_round(self, drafts: dict) -> bool:
        """Verify every slot in ``drafts`` in its own chunk forward and
        append ``accepted + 1`` tokens; the host kv_len becomes ``kv +
        accepted + 1`` and the round's ``_sync_tables`` rolls the device
        back. A verify with non-finite logits fails only its request.
        Returns whether slot state changed."""
        bursts: dict[int, list[int]] = {}
        any_failed = False
        for slot, req in enumerate(self._slots):
            if req is None or slot not in drafts:
                continue
            kv = int(self._kv_len[slot])
            draft = drafts[slot]
            if isinstance(draft, TreeDraft):
                any_failed |= self._spec_tree_slot(req, slot, draft, kv,
                                                   bursts)
                continue
            emitted, self.cache, a = spec_verify_slot(
                self.model, self.cache, slot, int(self._tok[slot]), draft,
                kv, self.mode,
            )
            if emitted is None:
                self._bump("nonfinite_logits")
                self._fail(
                    req, "nan_logits",
                    f"non-finite logits in speculative verify chunk "
                    f"after {len(req.out)} tokens",
                )
                any_failed = True
                continue
            req.spec.record(len(draft), a)
            self._bump("spec_verify_steps")
            self._bump("spec_draft_tokens", len(draft))
            self._bump("spec_accepted_tokens", a)
            self._bump("spec_rollback_tokens", len(draft) - a)
            self._kv_len[slot] = kv + a + 1
            bursts[slot] = emitted
        changed = self._process(lambda slot: bursts.get(slot, []))
        self._sync_tables()  # the rollback, and any evicted slot's pages
        self._spec_accept_gauge.set(
            self.stats["spec_accepted_tokens"]
            / max(self.stats["spec_draft_tokens"], 1))
        return changed or any_failed

    def _spec_tree_slot(self, req: Request, slot: int, tree: TreeDraft,
                        kv: int, bursts: dict) -> bool:
        """One TREE verify of ``slot`` inside a round: the multi-branch
        chunk forward, the greedy walk, the row-move commit of the
        accepted branch. On success ``bursts[slot]`` holds the emitted
        tokens; returns True when the slot FAILED (non-finite logits)."""
        emitted, self.cache, path = spec_verify_tree(
            self.model, self.cache, slot, tree, kv, self.mode)
        if emitted is None:
            self._bump("nonfinite_logits")
            self._fail(
                req, "nan_logits",
                f"non-finite logits in speculative tree-verify chunk "
                f"after {len(req.out)} tokens",
            )
            return True
        a = len(path)
        moved = any(int(n) != j + 1 for j, n in enumerate(path))
        self.cache = commit_tree_path(self.cache, slot, kv, path)
        req.spec.record_tree(tree.num_drafted, tree.max_depth, a)
        self._bump("spec_verify_steps")
        self._bump("spec_tree_rounds")
        self._bump("spec_tree_nodes", tree.num_drafted)
        self._bump("spec_tree_depth", tree.max_depth)
        if moved:
            self._bump("spec_tree_branch_accepts")
        self._bump("spec_draft_tokens", tree.num_drafted)
        self._bump("spec_accepted_tokens", a)
        self._bump("spec_rollback_tokens", tree.num_drafted - a)
        self._kv_len[slot] = kv + a + 1
        bursts[slot] = emitted
        return False

    # -- the loop --------------------------------------------------------

    def _try_admit(self, queue: deque) -> bool:
        """Admit queue heads into free slots while pages allow. A failed
        admission fails ONLY its request and the scan continues."""
        admitted = False
        progress = True
        while progress:  # re-scan: a first-token eviction frees its
            progress = False          # slot for the next request
            for slot in range(self.max_batch):
                if self._slots[slot] is not None or not queue:
                    continue
                head = queue[0]
                if (head.deadline_at is not None
                        and time.monotonic() > head.deadline_at):
                    queue.popleft()
                    self._fail(
                        head, "deadline_exceeded",
                        f"deadline_s={head.deadline_s} expired before "
                        "admission",
                    )
                    progress = True
                    break
                need = self._needed_pages(len(head.prompt), head.gen_len)
                m = None
                if self.prefix is not None:
                    m = self.prefix.match(head.prompt)
                    avail = (
                        len(self.pool.free)
                        + self.prefix.reclaimable_pages()
                    )
                    if need - len(m.nodes) > avail:
                        self.prefix.release_match(m)
                        self._bump("admission_stalls")
                        progress = False
                        break
                elif need > len(self.pool.free):
                    progress = False
                    break  # head-of-line waits for pages
                req = queue.popleft()
                try:
                    first = self._admit(req, slot, m)
                except Exception as e:  # noqa: BLE001 — isolation
                    self._admit_failure(req, m, e)
                    progress = True
                    break
                if self.speculative and req.spec is None:
                    req.spec = SpecState(
                        self.speculative,
                        w_max=self.spec_width if self._spec_tree else 1,
                    )
                    req.spec.observe(req.prompt)
                    req.spec.observe((int(first),))
                req.out.append(int(first))
                self._bump("generated_tokens")
                self._tok[slot] = int(first)
                admitted = progress = True
                # The admission token itself can finish the request.
                self._maybe_finish(req, int(first))
        if admitted:
            # A trailing first-token eviction leaves the device table
            # pointing at released pages until synced.
            self._sync_tables()
        return admitted

    def run(self, requests, *, results: bool = False):
        """Serve requests to completion with per-request error isolation.
        Each entry is a ``(prompt, gen_len)`` tuple or a
        :class:`Request`.

        ``results=False``: returns each request's generated tokens
        (prompt excluded), in order; unservable requests raise
        ``ValueError`` up front; runtime failures finish the survivors
        and raise :class:`RequestFailedError`. ``results=True``: returns
        one :class:`RequestResult` per request and never raises for
        per-request failures. Every run ends with :meth:`audit`; a
        bookkeeping leak raises :class:`PoolAuditError`."""
        reqs = [
            r if isinstance(r, Request)
            else Request(np.asarray(r[0], np.int32), int(r[1]))
            for r in requests
        ]
        for r in reqs:
            if r.temperature:
                raise NotImplementedError(SAMPLED_SERVING)
        self.stats = self._zero_stats()
        t0 = time.monotonic()
        if self.max_queue is not None and len(reqs) > self.max_queue:
            for r in reqs[self.max_queue:]:
                self._fail(
                    r, "overloaded",
                    f"admission queue bounded at {self.max_queue} "
                    f"requests ({len(reqs)} submitted); retry with backoff",
                )
        for r in reqs:
            if r.status != "ok":
                continue
            total = len(r.prompt) + r.gen_len
            if total > self.max_length:
                msg = (
                    f"prompt+gen_len = {total} exceeds max_length "
                    f"{self.max_length}"
                )
                if not results:
                    raise ValueError(msg)
                self._fail(r, "unservable", msg)
                continue
            need = self._needed_pages(len(r.prompt), r.gen_len)
            if need > self._capacity:
                msg = (
                    f"request needs {need} pages; "
                    f"pool capacity is {self._capacity} (unservable)"
                )
                if not results:
                    raise ValueError(msg)
                self._fail(r, "unservable", msg)
                continue
            if r.deadline_s is not None:
                r.deadline_at = t0 + float(r.deadline_s)
        queue = deque(r for r in reqs if r.status == "ok")

        try:
            self._try_admit(queue)
            while True:
                if self._expire_deadlines():
                    # An expiry freed a slot AND its pages: admit now.
                    self._sync_tables()
                    self._try_admit(queue)
                if not any(r is not None for r in self._slots):
                    if not queue:
                        break
                    if not self._try_admit(queue) and queue:
                        # Nothing in flight and the head still can't
                        # admit: capacity was validated, so this is a
                        # bookkeeping leak — fail the head rather than
                        # spin forever (the audit below will name it).
                        head = queue.popleft()
                        if head.status == "ok":
                            self._fail(
                                head, "failed",
                                "admission made no progress on an idle "
                                "engine (page accounting leak?)",
                            )
                    continue
                if self._step_guard(self._step):
                    # Slot state changed: table + kv_len are
                    # host-authoritative.
                    self._try_admit(queue)
                    self._sync_tables()
        finally:
            # Crash-safe teardown: no exit path leaves a slot holding
            # pages, a dangling tree pin, or a stale device table.
            leftover = [r for r in self._slots if r is not None]
            for r in leftover:
                self._fail(r, "aborted", "engine loop aborted mid-flight")
            while queue:
                r = queue.popleft()
                if r.status == "ok":
                    self._fail(
                        r, "aborted", "engine loop aborted before admission"
                    )
            if leftover:
                self._sync_tables()

        self.audit(raise_on_violation=True)
        if results:
            return [r.result() for r in reqs]
        failures = [(i, r) for i, r in enumerate(reqs) if r.status != "ok"]
        if failures:
            raise RequestFailedError(failures)
        return [np.asarray(r.out, np.int32) for r in reqs]

    def audit(self, *, raise_on_violation: bool = False) -> list[str]:
        """Pool/radix invariant audit: free list ∪ slot-private pages ∪
        tree pages ∪ trash page partition the pool exactly; shared
        mappings target live tree pages; tree refcounts equal live slot
        references; host table rows mirror each request's page list."""
        problems: list[str] = []
        owners: dict[str, list[int]] = {}
        shared: dict[str, list[int]] = {}
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            n_sh = len(req.shared_nodes)
            owners[f"slot{slot}"] = [int(p) for p in req.pages[n_sh:]]
            shared[f"slot{slot}"] = [int(p) for p in req.pages[:n_sh]]
        if self.prefix is not None:
            problems += self.prefix.audit()
            owners["tree"] = [n.page for n in self.prefix.walk()]
            pin_counts: Counter = Counter()
            for req in self._slots:
                if req is None:
                    continue
                for node in req.shared_nodes:
                    pin_counts[id(node)] += 1
            for node in self.prefix.walk():
                live = pin_counts.get(id(node), 0)
                if node.refcount != live:
                    problems.append(
                        f"tree node page {node.page}: refcount "
                        f"{node.refcount} != {live} live slot references"
                    )
        problems += audit_pool(
            self.pool, self.pool.num_pages, owners, shared=shared,
            reserved=(0,),
        )
        for slot in range(self.max_batch):
            req = self._slots[slot]
            row = self._table[slot]
            if req is None:
                if row.any():
                    problems.append(
                        f"inactive slot {slot} still has a nonzero "
                        "page-table row"
                    )
            else:
                want = np.zeros(self.pps, np.int32)
                want[: len(req.pages)] = req.pages
                if not np.array_equal(row, want):
                    problems.append(
                        f"slot {slot} table row disagrees with its "
                        "request's page list"
                    )
        if problems and raise_on_violation:
            raise PoolAuditError("; ".join(problems))
        return problems
