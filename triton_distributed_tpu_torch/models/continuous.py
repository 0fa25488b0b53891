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

Sampling: ``temperature`` / ``top_p`` / ``top_k`` are the engine's
defaults and a :class:`Request` may override each; greedy and sampled
requests share a batch. A request draws from its own generators: its
seed comes lazily from the engine's generator (seeded by ``seed``) at
its first sampled draw, and its n-th draw uses a generator seeded by
``sampling.mix64(seed, n)``, so a request's draws do not depend on what
else shares its batch.

``mode="mega"`` decodes in ``ns``-step launches of the megakernel: one
launch emits up to ``ns`` tokens per slot (in-kernel argmax; sampled
slots take the argmax over ``logits + T·gumbel``, the noise drawn from
the engine's generator per launch, and with top-k/top-p over their
keep-set, found in the kernel), over the
smallest power-of-two batch bucket that covers the active slots
(``mega_buckets``); a slot finishing inside the launch keeps only its
``n_valid`` rows (the rest go to the trash page) and, with ``eos_id``,
stops at its first stop token, found in the kernel. A round that cannot
launch (a slot within ``ns`` of ``max_length``, or at ``ns = 1`` a slot
with top-k/top-p) takes a single-step launch of the same kernel.
``resident=True`` pipelines the launches at depth 1: the next launch is
issued off the in-flight one's device outputs (its last token row, its
halt bits, its cache) before the host drains the in-flight one, so the
host syncs only to fetch emitted tokens; admit and retire items go
through a host work ring (``megakernel/ring.WorkRing``) whose doorbell
each launch's RING_POLL task stamps. Every site that mutates slot state
drains the pipeline first. ``kernel_trace=True`` makes every ``ns``-step
launch carry the device task tracer's ring, folded into the metrics and
kept for ``kernel_trace_launches()`` / ``kernel_trace_summary()``. Over an
int8 pool (``kv_dtype="int8"``) the kernel reads the codes through the
pool-wide per-page scales (a bucket's
compacted table reads them unchanged) and the append quantizes the
launch's rows into the pool step by step; ``mega_cfg=MegaConfig(
wq8=True)`` decodes from int8 weights (prefill keeps the model's own).

A KV tier (``tier=``, or one built from ``tier_bytes=``/``tier_dir=``,
:class:`kv_tier.PageStore`) sits behind the radix tree: an evicted full
page spills into it, and admission faults tier-resident pages of a
prompt back into the tree before matching, instead of re-prefilling
them.

``rank_page_budget=N`` (tokens; it needs a tier) admits a request whose
KV needs more than N tokens of pages as a SHARDED slot: a resident
paged window of at most N tokens plus cold pages demoted to the tier,
one page at a time, as the window fills. Every prefill chunk and decode
step of the slot runs a per-slot forward that merges the resident and
the cold-window attention partials with ``lse_combine``; the batched
decode sees the slot as empty and its logits are spliced over.

At tp>1 (a model over n co-located ranks) the engine serves greedy over
a head-sharded full-width pool: ``mode="pallas"`` admits without the
prefix cache through the sequence-sharded prefill (``ag_gemm`` /
``gemm_rs``), with it through replicated chunks, and decodes through
``gemm_ar`` (one-shot, or two-shot for chunks over 512 KB of output); a
Qwen3-MoE model's expert layers take ``all_gather``/``reduce_scatter``
in the sequence-sharded prefill and ``all_reduce`` in chunks and decode
(``layers/tp_moe.py``); ``mode="xla"`` runs the same with plain torch
collectives; ``mode="mega"`` decodes with the megakernel over all ranks
in one launch (``ns``-step launches, ``eos_id``, ``kernel_trace``,
``resident``: one work ring whose doorbell every rank stamps; a Qwen3-MoE
model's experts expert-parallel). Refused at tp>1:
``MegaConfig(wq8=True)`` (queue 1 position 4), speculation, int8 KV,
sampling, the KV tier and ``rank_page_budget`` (queue 1, item 11).

Not ported, and refused when asked for: slot migration/snapshots, the
KV fabric, context-parallel prefill (ROADMAP queue 1). Cancellation,
request timelines and fault seams are not ported either.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import weakref
from collections import Counter, deque

import numpy as np
import torch

from triton_distributed_tpu_torch.megakernel import ring as work_ring
from triton_distributed_tpu_torch.models import kv_tier, sampling
from triton_distributed_tpu_torch.models.engine import (
    MegaDispatch,
    engine_setup,
    prefill_suffix_chunks,
    refuse_at_tp,
)
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    PoolAuditError,
    audit_pool,
    copy_page,
    gather_pages,
    init_paged_cache,
    kv_bytes_per_token,
    resolve_kv_dtype,
    truncate_pages,
    write_page,
    write_prefill,
)
from triton_distributed_tpu_torch.models.prefix_cache import (
    PrefixCache,
    PrefixMatch,
    node_chain,
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


def _model_fingerprint(model) -> str:
    """Identity of the weights a tier entry was produced under, the JAX
    package's byte stream for the same weights (so a ``tier_dir`` written
    by either package faults back into the other): the class name, every
    parameter's shape and dtype name (``float32``, ``bfloat16``), and a
    value sample spread over the tree (up to 8 leaves at an even stride
    plus the last one, the LM head; 64 elements strided over each whole
    flattened leaf in its own dtype, so a layer-stacked ``[L, ...]``
    leaf samples every layer). Leaves go in the JAX ``Qwen3Params``
    order: ``embed``, the layer leaves (``ln1``, ``attn.{wqkv, wo,
    q_norm, k_norm}``, ``ln2``, ``mlp.{w1, w2}``), ``norm``, ``lm_head``
    (the port's LM head has the JAX shape: both pad the vocab to 128).
    A ``tier_dir`` reused across a weight update then faults back
    nothing instead of stale KV. A few small device reads, once per
    engine with a tier."""
    from triton_distributed_tpu_torch.models.qwen import _LAYER_LEAVES

    h = hashlib.sha1(type(model).__name__.encode())
    params = getattr(model, "params", None) or {}
    leaves = [params.get("embed")]
    for path in _LAYER_LEAVES:
        node = params.get("layers") or {}
        for name in path:
            node = (node or {}).get(name)
        leaves.append(node)
    leaves += [params.get("norm"), params.get("lm_head")]
    leaves = [t for t in leaves if t is not None]  # as jax tree_leaves
    for leaf in leaves:
        h.update(str(tuple(leaf.shape)).encode())
        h.update(str(leaf.dtype).removeprefix("torch.").encode())
    sampled = leaves[::max(1, len(leaves) // 8)][:8]
    if leaves and leaves[-1] is not sampled[-1]:
        sampled.append(leaves[-1])
    for leaf in sampled:
        flat = leaf.reshape(-1)
        stride = max(1, flat.shape[0] // 64)
        sample = flat[::stride][:64]
        if sample.dtype == torch.bfloat16:  # its raw 2-byte words
            sample = sample.view(torch.int16)
        h.update(sample.cpu().numpy().tobytes())
    return h.hexdigest()


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
    ``temperature`` / ``top_p`` / ``top_k`` override the engine's
    defaults for this request (None → the engine's). ``deadline_s`` is a
    wall-clock budget measured from ``run()`` entry. ``key`` is the
    request's sampling seed, drawn from the engine's generator at its
    first sampled draw, and ``key_step`` counts its draws."""

    prompt: np.ndarray  # [S] int32
    gen_len: int
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
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
    key: int | None = dataclasses.field(default=None, repr=False)
    key_step: int = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.gen_len

    def result(self) -> RequestResult:
        return RequestResult(np.asarray(self.out, np.int32), self.status,
                             self.reason)


# Knobs of the JAX ContinuousEngine this slice does not port: each
# raises NotImplementedError when set (ROADMAP queues 1 and 2).
_UNPORTED = ("snapshot_every", "fabric")


def _h2d(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without a host sync: a CUDA copy goes
    through pinned memory, non-blocking (a copy from pageable memory
    synchronizes the stream, and so waits for a launch in flight)."""
    t = torch.from_numpy(np.array(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


# Cold-page tier keys of one sharded admission are "<uid>:<page-index>",
# so a slot re-admitted into the same engine (or a second sharded slot)
# never collides with a predecessor's leftovers.
_LONG_UIDS = itertools.count(1)


@dataclasses.dataclass
class _LongSlot:
    """A sharded long-context slot's bookkeeping: a RESIDENT paged window
    (``req.pages``, local positions) plus ``cold`` pages demoted to the
    KV tier. Host ``_kv_len[slot]`` stays the ABSOLUTE sequence length;
    the resident region holds ``_kv_len[slot] - cold * page_size``
    tokens. The DEVICE kv_len and table row of the slot are zero
    (``_sync_tables``): the batched decode treats the slot as empty (its
    append lands on the trash page, its logits are replaced by the
    per-slot forward's)."""

    uid: int
    cold: int = 0           # pages demoted (tokens [0, cold*page) cold)
    # Cached cold window: (k, v, ks, vs, bucket_pages) device tensors
    # [L, Hkv, bucket_pages*page, hd] (scales [L, Hkv, bucket_pages]);
    # invalidated (None) whenever another page demotes.
    view: tuple | None = None


@dataclasses.dataclass
class _MegaPlan:
    """One megakernel launch: launch row → engine slot (-1 = bucket
    filler), the bucket width, kept-row counts, stop tokens and the
    per-row sampling knobs."""

    rows: list
    B: int
    compact: bool           # B < max_batch: compacted table/kv_len/tok
    eos: bool               # device stop-token test
    n_valid: np.ndarray     # [B] kept-row counts fed to append_n
    stop_tok: np.ndarray | None  # [B] when eos
    sampled: bool = False   # some row has temperature > 0
    filtered: bool = False  # some row has top-k/top-p (sampcfg rides)
    temps: np.ndarray | None = None    # [B] noise scale per row (0 greedy)
    sampcfg: np.ndarray | None = None  # [B, 4] when filtered


@dataclasses.dataclass
class _MegaLaunch:
    """An issued, possibly still running, ``ns``-step launch: what the
    resident pipeline holds between issue and drain. ``toks``, ``ss``,
    ``halt``, ``cache`` and ``ring`` are device outputs nothing has
    synced on; ``cache`` is the launch's (bucket-shaped) output cache,
    which a chained launch reads next."""

    plan: _MegaPlan
    toks: torch.Tensor          # [NS, B]
    cache: object               # PagedKVCache
    ss: torch.Tensor | None     # [B] first stop-token step (NS = never)
    halt: torch.Tensor | None   # [B] halt bits chained into the next launch
    ring: torch.Tensor | None   # [1, NS, T, 8] (kernel_trace only)
    t0: float
    doorbell: int | None


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
        top_p: float = 1.0,
        top_k: int = 0,
        seed: int = 0,
        eos_id: int | None = None,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        speculative: int = 0,
        spec_width: int = 4,
        max_queue: int | None = None,
        kv_dtype: str | None = None,
        cp: int = 1,
        tier=None,
        tier_bytes: int = 0,
        tier_dir: str | None = None,
        rank_page_budget: int = 0,
        mega_cfg=None,
        ns: int = 8,
        mega_buckets: bool = True,
        resident: bool = False,
        kernel_trace: bool = False,
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
        engine_setup(model, device, mode, mega_cfg, **unported)
        refuse_at_tp(model, speculative=speculative, kv_dtype=kv_dtype,
                     rank_page_budget=rank_page_budget,
                     tier=tier is not None or bool(tier_bytes or tier_dir),
                     temperature=temperature > 0.0)
        if int(ns) < 1:
            raise ValueError(f"ns must be >= 1, got {ns}")
        if speculative and mode == "mega":
            raise ValueError(
                "speculative=K does not compose with mode='mega': a launch "
                "advances every slot ns tokens in lockstep")
        if resident and mode != "mega":
            raise ValueError(
                "resident=True requires mode='mega' (the resident loop "
                "pipelines megakernel ns-step launches through the host "
                "work ring; the xla decode path has no device loop to keep "
                "resident)")
        self.model = model
        self.mode = mode
        self.mega_cfg = mega_cfg
        self.resident = bool(resident)
        # The resident session's work ring and its occupancy gauge, and
        # the in-flight launch of the depth-1 pipeline.
        self._ring = work_ring.WorkRing() if resident else None
        self._ring_gauge = obs_metrics.gauge(
            "tdt_mega_ring_occupancy",
            "Host work-ring occupancy at the last doorbell publish.",
        ) if resident else None
        self._pend: _MegaLaunch | None = None
        self._init_kernel_trace(kernel_trace, mode)
        # Default sampling knobs (a Request may override each) and the
        # engine's generator: request seeds and the mega launches' noise.
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self._gen = torch.Generator(device=model.device).manual_seed(
            int(seed))
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
        # rank_page_budget (TOKENS) turns over-budget slots into SHARDED
        # slots: a resident paged window plus tier-demoted cold pages.
        self.rank_page_budget = int(rank_page_budget)
        if self.rank_page_budget:
            if self.rank_page_budget % page_size:
                raise ValueError(
                    f"rank_page_budget {self.rank_page_budget} is not "
                    f"a multiple of page_size {page_size}: the budget "
                    f"is demoted page-by-page, so a ragged budget "
                    f"would strand a partial page — pick an aligned "
                    f"pair"
                )
            if self.rank_page_budget < 2 * page_size:
                raise ValueError(
                    f"rank_page_budget {self.rank_page_budget} must "
                    f"cover >= 2 pages of page_size {page_size} (one "
                    f"write page + one full page to demote)"
                )
            if tier is None and not (tier_bytes or tier_dir):
                raise ValueError(
                    "rank_page_budget requires a KV tier (tier=, "
                    "tier_bytes= or tier_dir=): demoted cold pages "
                    "must land somewhere a fault can bring them back "
                    "from"
                )
            if mode == "mega" or speculative:
                raise ValueError(
                    "rank_page_budget composes with the xla/pallas "
                    "decode paths only: sharded slots decode through "
                    "a per-slot partial-merge program the mega/"
                    "resident/speculative launchers do not run"
                )
            if round_chunk(page_size) != page_size:
                raise ValueError(
                    f"rank_page_budget needs a chunk-alignable "
                    f"page_size (multiple of 16, or of 128 past 128); "
                    f"got {page_size}"
                )
        self.budget_pages = self.rank_page_budget // page_size
        # slot -> _LongSlot for slots decoding in sharded mode.
        self._longctx: dict[int, _LongSlot] = {}
        # +1: page 0 is reserved as the trash page every inactive slot's
        # table points at, and must not shave serviceable capacity.
        n_pages = (num_pages or max_batch * self.pps) + 1
        # int8 KV: the explicit knob wins over the model config's.
        self.kv_dtype = resolve_kv_dtype(kv_dtype, model.cfg)
        self.speculative = int(speculative)
        # MoE: top_k per routed token position (0 for a dense model); it
        # gates the moe_routed_tokens bumps and the expert keys of
        # last_stats.
        self._moe_k = (model.cfg.num_experts_per_tok
                       if model.cfg.num_experts else 0)
        # Draft trees only on a full-width pool: the commit is a KV
        # row-move, which an int8 pool's per-page scales cannot carry.
        self.spec_width = max(int(spec_width), 1)
        self._spec_tree = (bool(speculative) and self.spec_width > 1
                           and self.kv_dtype is None)
        self.cache, self.pool = init_paged_cache(
            model.cfg, max_batch, model.device,
            max_length=self.max_length, page_size=page_size,
            num_pages=n_pages, assign_pages=False, kv_dtype=self.kv_dtype,
            tp=model.tp,
        )
        self.pool.free = [p for p in self.pool.free if p != 0]
        self._capacity = len(self.pool.free)
        self._table = np.zeros((max_batch, self.pps), np.int32)
        self._kv_len = np.zeros((max_batch,), np.int32)
        self._tok = np.zeros((max_batch,), np.int32)
        self._slots: list[Request | None] = [None] * max_batch
        self.prefix = PrefixCache(self.pool, page_size) if prefix_cache else None
        # KV tier: a host-RAM (and optionally disk) PageStore behind the
        # radix tree and the sharded slots' cold pages. ``tier=`` takes a
        # pre-built (maybe shared) store; ``tier_bytes``/``tier_dir``
        # build one this engine owns (every entry in it is its own).
        self._tier_owned = tier is None and bool(tier_bytes or tier_dir)
        if tier is None and (tier_bytes or tier_dir):
            # fsync=False: spills run on the scheduling loop; the atomic
            # rename alone gives process-crash durability.
            tier = kv_tier.PageStore(capacity_bytes=tier_bytes or (64 << 20),
                                     dir=tier_dir, fsync=False)
        self.tier = tier
        # Weight identity of the tier's entries: spilled and demoted pages
        # are valid under THESE weights only.
        self._tier_fp = (
            _model_fingerprint(model) if self.tier is not None else None
        )
        if self.prefix is not None and self.tier is not None:
            self.prefix.spill_fn = self._spill_page
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
        if self._moe_k:
            stats["num_experts"] = self.model.cfg.num_experts
            stats["experts_per_tok"] = self._moe_k
        if self.tier is not None:
            stats["tier"] = self.tier.snapshot()
        return stats

    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a serving counter and every registry metric that
        mirrors it."""
        self.stats[key] += n
        for handle in self._metric_handles[key]:
            handle.inc(n)

    def _bump_moe(self, positions: int) -> None:
        """An MoE model routed ``positions`` token positions through its
        expert FFN: ``top_k`` assignments each (a no-op when dense)."""
        if self._moe_k:
            self._bump("moe_routed_tokens", positions * self._moe_k)

    # -- slot management -------------------------------------------------

    def _sync_tables(self) -> None:
        """Mirror the host page table and kv_len into the device cache
        (copies, so later host edits never race a launched step). A
        sharded slot's row and length go to zero on the device: the
        batched decode treats it as empty (the host keeps its resident
        row and absolute length, which the audit and the per-slot
        forwards read)."""
        self._free_pages_gauge.set(len(self.pool.free))
        dev = self.model.device
        table = self._table.copy()
        kv_len = self._kv_len.copy()
        for slot in self._longctx:
            table[slot] = 0
            kv_len[slot] = 0
        self.cache = dataclasses.replace(
            self.cache, page_table=_h2d(table, dev), kv_len=_h2d(kv_len, dev),
        )

    def _admit(self, req: Request, slot: int, m: PrefixMatch | None = None):
        """Prefill ``req`` into ``slot``; returns the first token."""
        if self._sharded_eligible(req):
            if m is not None:
                # Sharded slots never map tree pages: a match computed
                # before routing here releases its pins.
                self.prefix.release_match(m)
            return self._admit_sharded(req, slot)
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
        # tp divisibility of the sequence-sharded prefill: right-padding,
        # inert under causal masking.
        row = np.concatenate([req.prompt,
                              np.zeros((-s) % self.model.tp, np.int32)])
        logits, self._dense1 = self.model.prefill_batched(
            row[None], self._dense1, self._prefill_mode, [s],
        )
        self.cache = write_prefill(
            self.cache, slot, self._dense1.k, self._dense1.v, s
        )
        self._bump("admitted")
        self._bump("prefill_tokens", s)
        self._bump_moe(s)
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
        self._bump_moe(len(prompt) - start)
        return logits

    def _ring_push(self, kind: int, slot: int, arg: int = 0) -> None:
        """Queue one work item (``ring.RING_ADMIT`` or ``RING_RETIRE``) for
        the resident device loop (no-op without a ring); the next
        launch's doorbell publish covers it."""
        if self._ring is None:
            return
        self._ring.push(kind, slot, arg)
        self._bump("mega_ring_items")

    def _flush_ring(self) -> None:
        """Drain the work ring host-side (no doorbell): for rounds no
        device loop observes (single-step fallbacks, the end of a run)."""
        if self._ring is not None:
            flushed = self._ring.flush()
            if flushed:
                self._bump("mega_ring_host_drains", len(flushed))

    # -- sharded long-context slots ---------------------------------------
    #
    # With ``rank_page_budget`` set, a request whose KV needs more pages
    # than the budget admits SHARDED: a resident paged window of at most
    # ``budget_pages`` pages (local positions, the slot's own table row)
    # plus cold pages demoted to the KV tier and faulted back as a
    # read-only dense window. Prefill and decode run per-slot forwards
    # that merge the (cold, resident) attention partials with
    # ``lse_combine``, so the logits are what one large resident slot
    # would compute.

    def _sharded_eligible(self, req: Request) -> bool:
        """Whether ``req`` must admit as a sharded slot: a budgeted
        engine and a KV footprint the budget cannot hold resident."""
        return (
            self.budget_pages > 0
            and self._needed_pages(len(req.prompt), req.gen_len)
            > self.budget_pages
        )

    def _alloc_pages(self, n: int) -> list:
        """``n`` pool pages for a sharded slot: through the radix tree's
        reclaim path when a prefix cache is on (unpinned tree pages
        yield, as at admission), straight from the pool otherwise."""
        if self.prefix is not None:
            pages = self.prefix.allocate(n)
            if pages is None:
                raise RuntimeError(
                    f"page pool exhausted ({n} pages for a sharded slot)"
                )
            return pages
        return self.pool.allocate(n)

    def _admit_sharded(self, req: Request, slot: int):
        """Admit an over-budget request as a SHARDED slot: chunk-prefill
        one page at a time through ``prefill_paged_chunk_cold``, demoting
        the oldest resident page to the KV tier whenever the resident
        window is full, with a decode step of the running batch between
        chunks. Returns the first token."""
        s = len(req.prompt)
        page = self.page_size
        ls = _LongSlot(uid=next(_LONG_UIDS))
        req.slot = slot  # before any allocation: teardown keys off it
        self._longctx[slot] = ls
        self._table[slot] = 0
        self._kv_len[slot] = 0
        self._sync_tables()
        logits = None
        off = 0
        while off < s:
            take = min(page, s - off)
            kv_loc = off - ls.cold * page
            if kv_loc == self.budget_pages * page:
                self._demote_front(slot, ls, req)
                kv_loc -= page
            if kv_loc == len(req.pages) * page:
                req.pages = req.pages + self._alloc_pages(1)
                self._table[slot, len(req.pages) - 1] = req.pages[-1]
            row = np.zeros(self.budget_pages, np.int32)
            row[: len(req.pages)] = req.pages
            k_c, v_c, ks_c, vs_c, _bucket = self._cold_view(ls)
            buf = np.zeros(page, np.int32)
            buf[:take] = req.prompt[off: off + take]
            logits, self.cache = self.model.prefill_paged_chunk_cold(
                buf, row, off, off + take, take - 1, self.cache,
                k_c, v_c, ks_c, vs_c, s_cold=ls.cold * page,
                mode=self._prefill_mode,
            )
            off += take
            self._kv_len[slot] = off
            if off < s and self._step_guard(self._decode_once):
                # The running batch keeps decoding between the chunks.
                self._sync_tables()
        self._bump("admitted")
        self._bump("prefill_tokens", s)
        self._bump("prefill_chunks", -(-s // page))
        self._bump("longctx_sharded_slots")
        self._bump_moe(s)
        obs_events.emit("admit", slot=slot, prompt_len=s, matched=0)
        self._slots[slot] = req
        return self._sample_req(req, logits)

    def _demote_front(self, slot: int, ls: _LongSlot, req: Request) -> None:
        """Demote the slot's oldest (full) resident page to the KV tier:
        its KV (and an int8 pool's scales) ship as a ``prefix_payload``
        keyed ``<uid>:<cold-index>`` under ``LONGCTX_KIND``, the pool
        page frees, and the cold window grows by one page. The payload's
        chain is the page's own ``page_size`` tokens."""
        page = self.page_size
        pid = int(req.pages[0])
        start = ls.cold * page
        seq = [int(t) for t in req.prompt] + [int(t) for t in req.out]
        k, v, ks, vs = gather_pages(self.cache, [pid])
        payload = kv_tier.prefix_payload(
            seq[start: start + page], page, self.kv_dtype,
            k[:, 0], v[:, 0],
            None if ks is None else ks[:, 0],
            None if vs is None else vs[:, 0],
        )
        payload["model_fp"] = self._tier_fp
        key = f"{ls.uid}:{ls.cold}"
        if not self.tier.put(kv_tier.LONGCTX_KIND, key, payload):
            raise RuntimeError(
                f"KV tier refused cold page {key} of sharded slot {slot}"
            )
        self.pool.release([pid])
        req.pages = req.pages[1:]
        self._table[slot] = 0
        self._table[slot, : len(req.pages)] = req.pages
        ls.cold += 1
        ls.view = None
        self._bump("longctx_demoted_pages")
        obs_events.emit("longctx_demote", slot=slot, page=pid,
                        cold=ls.cold)

    def _cold_view(self, ls: _LongSlot):
        """The slot's cold window on the device: every demoted page
        faulted back from the tier (``longctx_tier_faults`` counts each
        page read) and stitched in absolute order into a power-of-two
        page bucket (the tail past ``cold`` pages is zero and masked by
        ``s_cold``). Cached until the next demote. Returns ``(k, v, ks,
        vs, bucket_pages)``."""
        page = self.page_size
        n = ls.cold
        bucket = 1
        while bucket < n:
            bucket *= 2
        if ls.view is not None and ls.view[4] == bucket:
            return ls.view
        kp = self.cache.k_pages  # [L, P, Hkv, page, hd]
        n_layers, _p, hkv, _page, hd = kp.shape
        k_c = torch.zeros((n_layers, hkv, bucket * page, hd), dtype=kp.dtype)
        v_c = torch.zeros_like(k_c)
        quant = self.cache.quantized
        ks_c = (torch.zeros((n_layers, hkv, bucket), dtype=torch.float32)
                if quant else None)
        vs_c = torch.zeros_like(ks_c) if quant else None
        for i in range(n):
            key = f"{ls.uid}:{i}"
            payload = self.tier.get(kv_tier.LONGCTX_KIND, key)
            if payload is None:
                raise RuntimeError(
                    f"cold page {key} missing from the KV tier (a "
                    "sharded slot's cold window cannot be rebuilt)"
                )
            if payload.get("model_fp") != self._tier_fp:
                raise RuntimeError(
                    f"cold page {key} was produced under different "
                    "model weights"
                )
            _chain, _ps, _dt, k1, v1, ks1, vs1 = (
                kv_tier.decode_prefix_payload(payload)
            )
            k_c[:, :, i * page:(i + 1) * page, :] = k1
            v_c[:, :, i * page:(i + 1) * page, :] = v1
            if quant:
                ks_c[:, :, i] = ks1
                vs_c[:, :, i] = vs1
            self._bump("longctx_tier_faults")
            self._bump("longctx_tier_bytes",
                       kv_tier.payload_nbytes(payload))
        dev = self.model.device
        ls.view = (
            k_c.to(dev), v_c.to(dev),
            None if ks_c is None else ks_c.to(dev),
            None if vs_c is None else vs_c.to(dev),
            bucket,
        )
        return ls.view

    def _longctx_decode(self, logits: torch.Tensor):
        """One sharded decode step per sharded slot, after the batched
        step (which saw the slot as empty): append the slot's pending
        token at its local resident position, demoting or allocating a
        page when the append needs room, and write the per-slot forward's
        logits over the batched row (in place) BEFORE the NaN guard and
        the argmax read them. A failure fails only its slot. Returns
        ``(logits, changed)``."""
        page = self.page_size
        changed = False
        for slot in sorted(self._longctx):
            ls = self._longctx.get(slot)
            req = self._slots[slot]
            if ls is None or req is None:
                continue
            try:
                # _kv_len was already bumped for this step: rows cached
                # before the append = _kv_len - 1, all absolute.
                kv_loc = int(self._kv_len[slot]) - 1 - ls.cold * page
                if kv_loc == self.budget_pages * page:
                    self._demote_front(slot, ls, req)
                    kv_loc -= page
                if kv_loc == len(req.pages) * page:
                    req.pages = req.pages + self._alloc_pages(1)
                    self._table[slot, len(req.pages) - 1] = req.pages[-1]
                row = np.zeros(self.budget_pages, np.int32)
                row[: len(req.pages)] = req.pages
                k_c, v_c, ks_c, vs_c, _bucket = self._cold_view(ls)
                lg, self.cache = self.model.decode_step_sharded(
                    np.asarray([self._tok[slot]], np.int32), self.cache,
                    row, kv_loc, k_c, v_c, ks_c, vs_c,
                    s_cold=ls.cold * page, mode=self.mode,
                )
                self._bump("longctx_decode_steps")
            except Exception as e:  # noqa: BLE001 — per-slot isolation
                self._fail(
                    req, "failed",
                    f"sharded decode: {type(e).__name__}: {e}",
                )
                changed = True
                continue
            logits[slot] = lg[0]
        return logits, changed

    def _drop_longctx(self, slot: int) -> None:
        """Forget a sharded slot's bookkeeping and delete its tier
        entries (cold pages belong to exactly ONE live request; they are
        not a cache, and leftovers would leak tier capacity)."""
        ls = self._longctx.pop(slot, None)
        if ls is None:
            return
        for i in range(ls.cold):
            self.tier.delete(kv_tier.LONGCTX_KIND, f"{ls.uid}:{i}")

    def _audit_longctx(self) -> list[str]:
        """Sharded-slot invariants, folded into :meth:`audit`: every
        sharded entry has a live request, resident pages within budget,
        a local length within the resident capacity, and every cold page
        present in the tier; an owned tier holds no cold page of a slot
        that is gone."""
        problems: list[str] = []
        page = self.page_size
        for slot, ls in self._longctx.items():
            req = self._slots[slot]
            if req is None:
                problems.append(
                    f"longctx: slot {slot} sharded but has no request"
                )
                continue
            if len(req.pages) > self.budget_pages:
                problems.append(
                    f"longctx: slot {slot} holds {len(req.pages)} "
                    f"resident pages > budget {self.budget_pages}"
                )
            kv_loc = int(self._kv_len[slot]) - ls.cold * page
            if not 0 <= kv_loc <= len(req.pages) * page:
                problems.append(
                    f"longctx: slot {slot} local kv {kv_loc} outside "
                    f"resident capacity {len(req.pages) * page}"
                )
            for i in range(ls.cold):
                key = f"{ls.uid}:{i}"
                if not self.tier.contains(kv_tier.LONGCTX_KIND, key):
                    problems.append(
                        f"longctx: slot {slot} cold page {key} "
                        "missing from the KV tier"
                    )
        if self.tier is not None and self._tier_owned:
            live = {str(ls.uid) for ls in self._longctx.values()}
            for key in self.tier.keys(kv_tier.LONGCTX_KIND):
                if key.split(":", 1)[0] not in live:
                    problems.append(
                        f"longctx: stale tier entry {key} (no live "
                        "sharded slot owns it)"
                    )
        return problems

    def _decode_once(self) -> bool:
        """One batched decode of every active slot; appends each slot's
        token (greedy, or sampled under its knobs) and evicts finished
        requests. Returns whether slot state changed."""
        # A single-step round applies slot state on the host: no device
        # loop will observe the ring's queued items, so they drain here,
        # or a workload that keeps falling back would fill the ring.
        self._flush_ring()
        active = np.asarray([r is not None for r in self._slots], np.int32)
        if not active.any():
            return False
        logits, self.cache = self._decode_step(
            torch.from_numpy(self._tok.copy()), self.cache
        )
        self._kv_len = self._kv_len + active
        self._bump("decode_steps")
        self._bump_moe(int(active.sum()))
        # Sharded slots were empty to the batched step: their per-slot
        # partial-merge decode runs now and its logits replace the
        # batched rows before the NaN guard and the argmax.
        lc_changed = False
        if self._longctx:
            logits, lc_changed = self._longctx_decode(logits)
        # The finite mask and the greedy tokens come back in one fetch.
        finite = torch.isfinite(logits).all(dim=-1)
        both = torch.stack([finite.to(torch.int32), sampling.greedy(logits)])
        finite, nxt = both.cpu().numpy()
        failed = self._guard_logits(finite)
        nxt = self._sample_slots(logits, nxt)
        changed = self._process(lambda slot: [nxt[slot]])
        return changed or bool(failed) or lc_changed

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
        self._ring_push(work_ring.RING_RETIRE, slot, len(req.out))
        if slot in self._longctx:
            # A sharded slot's resident pages hold a LOCAL window (its
            # cold prefix lives in the tier): useless as a prefix chain,
            # so they go straight back to the pool, and the tier entries
            # go with the slot.
            req.pages = truncate_pages(
                self.pool, req.pages, 0, self.page_size
            )
            self._drop_longctx(slot)
        elif self.prefix is not None:
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
        self._ring_push(work_ring.RING_RETIRE, slot, len(req.out))
        self._drop_longctx(slot)
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
            # A fault mid-round may leave a resident launch in flight:
            # wait for it before the teardown below reuses its state.
            self._abort_pend()
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
        if self._pend is not None and any(
                r is not None and r.deadline_at is not None
                and now > r.deadline_at for r in self._slots):
            # The expiry tears a slot down mid-pipeline: drain first (the
            # drain may even finish the request).
            self._drain_pend()
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

    # -- KV tier: prefix spill and fault-back ------------------------------

    def _spill_page(self, chain: list, page: int) -> None:
        """``PrefixCache.spill_fn``: export one evicted full page to the
        tier, keyed by its token-chain digest, byte-exact (an int8
        page's codes and scales travel as a pair). Raising is fine:
        eviction treats a failed spill as the plain drop."""
        k, v, ks, vs = gather_pages(self.cache, [page])
        payload = kv_tier.prefix_payload(
            chain, self.page_size, self.kv_dtype,
            k[:, 0], v[:, 0],
            None if ks is None else ks[:, 0],
            None if vs is None else vs[:, 0],
        )
        payload["model_fp"] = self._tier_fp
        if self.tier.put(kv_tier.PREFIX_KIND, kv_tier.chain_digest(chain),
                         payload):
            self._bump("tier_spilled_pages")
            obs_events.emit("tier_spill", tokens=len(chain), page=int(page))

    def _tier_fill(self, tokens) -> None:
        """Fault-back half of the tier: extend the radix tree's coverage
        of ``tokens`` from the tier BEFORE admission matches. Each hit
        page is re-allocated, written verbatim (``write_page``) and
        grafted into the tree, where ``match()`` then pins it like any
        cached page. Stops at the first miss, divergence or allocation
        failure; every failure degrades to the ordinary suffix prefill,
        never to wrong bits."""
        if self.tier is None or self.prefix is None:
            return
        if not self.tier.may_contain(kv_tier.PREFIX_KIND):
            # Nothing has ever spilled: every probe would miss.
            return
        ps = self.page_size
        toks = [int(t) for t in tokens]
        limit = len(toks) - 1  # match()'s cap: one suffix token prefills
        node = self.prefix.root
        i = 0
        faulted = bytes_in = 0
        # The walked path is refcount-PINNED for the fill: each faulted
        # page's allocation may run the LRU eviction, which would
        # otherwise evict (and re-spill) the nodes this prompt is about
        # to match. The pins are released before match() takes its own.
        pinned: list = []
        try:
            while i + ps <= limit:
                chunk = toks[i:i + ps]
                child = node.children.get(chunk[0])
                if child is not None:
                    if tuple(chunk) == child.chunk:
                        node = child
                        node.refcount += 1
                        pinned.append(node)
                        i += ps
                        continue
                    break  # divergent/partial sibling: the tree wins
                digest = kv_tier.chain_digest(toks[: i + ps])
                payload = self.tier.get(kv_tier.PREFIX_KIND, digest)
                if payload is None:
                    break
                try:
                    chain, page_size, kv_dtype, k, v, ks, vs = (
                        kv_tier.decode_prefix_payload(payload)
                    )
                except kv_tier.TierIntegrityError:
                    self.tier.delete(kv_tier.PREFIX_KIND, digest)
                    break
                if (chain != toks[: i + ps] or page_size != ps
                        or kv_dtype != self.kv_dtype
                        or payload.get("model_fp") != self._tier_fp):
                    # A digest collision, a foreign geometry, or a page
                    # of DIFFERENT weights: never fault it back. Deleting
                    # is owner-only: on a shared store the entry may be
                    # valid for the engine that spilled it.
                    if self._tier_owned:
                        self.tier.delete(kv_tier.PREFIX_KIND, digest)
                    obs_events.emit(
                        "tier_drop", tier_kind=kv_tier.PREFIX_KIND,
                        key=digest[:64],
                        reason="chain/geometry/weights mismatch",
                    )
                    break
                pages = self.prefix.allocate(1)
                if pages is None:
                    break
                try:
                    self.cache = write_page(
                        self.cache, pages[0], k, v, ks, vs
                    )
                except (ValueError, RuntimeError):  # degrade to re-prefill
                    self.pool.release(pages)
                    if self._tier_owned:
                        self.tier.delete(kv_tier.PREFIX_KIND, digest)
                    break
                self.prefix.insert_chain(node, chunk, pages)
                child = node.children.get(chunk[0])
                if child is None or child.page != pages[0]:
                    break  # insert declined (raced sibling) — released
                node = child
                node.refcount += 1
                pinned.append(node)
                i += ps
                faulted += 1
                bytes_in += kv_tier.payload_nbytes(payload)
        finally:
            for n in pinned:
                self.prefix.release_node(n)
        if faulted:
            self._bump("tier_hits")
            self._bump("tier_faults", faulted)
            self._bump("tier_bytes", bytes_in)
            obs_events.emit("tier_fault", pages=faulted, bytes=bytes_in,
                            matched_tokens=i)

    def _request_sampling(self, req: Request) -> tuple[float, float, int]:
        """A request's effective ``(temperature, top_p, top_k)``: its own
        overrides, else the engine's defaults."""
        t = self.temperature if req.temperature is None else req.temperature
        p = self.top_p if req.top_p is None else req.top_p
        k = self.top_k if req.top_k is None else req.top_k
        return float(t), float(p), int(k)

    def _req_gen(self, req: Request) -> torch.Generator:
        """The generator of ``req``'s next sampled draw: seeded by
        ``mix64(request seed, draw counter)``, so each draw is a pure
        function of the request's seed and how many draws it made (the
        JAX ``fold_in(key, key_step)`` protocol). The request seed is
        drawn from the engine's generator at the first sampled draw."""
        if req.key is None:
            req.key = int(torch.randint(
                0, 2**62, (1,), generator=self._gen,
                device=self._gen.device)[0])
        gen = torch.Generator(device=self.model.device).manual_seed(
            sampling.mix64(req.key, req.key_step))
        req.key_step += 1
        return gen

    def _sample_req(self, req: Request, logits: torch.Tensor) -> int:
        """The first token from an admission's ``logits [V]``, under the
        request's knobs."""
        if not bool(torch.isfinite(logits).all()):
            raise sampling.NonFiniteLogitsError(
                "non-finite logits from the admission prefill",
                slot=req.slot,
            )
        t, p, k = self._request_sampling(req)
        if t <= 0.0:
            return int(sampling.greedy(logits))
        return int(sampling.sample(logits, self._req_gen(req), t, p, k))

    def _sample_slots(self, logits: torch.Tensor, toks: np.ndarray
                      ) -> np.ndarray:
        """Per-slot tokens of a batched ``[max_batch, V]`` decode output:
        ``toks`` (the batch's argmax, already fetched) for greedy slots,
        a draw under its own knobs and generator for every sampled
        slot."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            t, p, k = self._request_sampling(req)
            if t > 0.0:
                toks[slot] = int(sampling.sample(
                    logits[slot], self._req_gen(req), t, p, k))
        return toks

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
            changed = self._mega_round()
            if changed is not None:
                return changed
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
        """Compose the next launch from host truth, or None when the round
        takes a single step: a slot within ``ns`` of ``max_length`` (its
        ``ns`` appended rows would pass the page table), or a slot with
        top-k/top-p at ``ns = 1`` or tp > 1 (the in-kernel filter rides
        the multi-step build and needs the whole vocab row on one rank,
        as in the JAX engine; sampling itself stays refused at tp > 1).
        Greedy and sampled slots launch together: a row's noise is scaled
        by its temperature, so a greedy row's is zero."""
        active = np.asarray([r is not None for r in self._slots], np.int32)
        if int((self._kv_len * active).max()) + self.NS > self.max_length:
            return None
        act = [s for s in range(self.max_batch) if self._slots[s] is not None]
        V = self.model.cfg.vocab_size
        filtered = any(sampling.sampcfg_row(
            *self._request_sampling(self._slots[s]), V)[3] > 0.0 for s in act)
        if filtered and (self.NS <= 1 or self.model.tp > 1):
            return None
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
        temps = np.zeros(B, np.float32)
        # Inert rows: 1/T 1, top-k window V, top-p 1, filter off.
        sampcfg = np.tile(np.asarray([sampling.sampcfg_row(0.0, 1.0, 0, V)],
                                     np.float32), (B, 1))
        for i, slot in enumerate(rows):
            req = self._slots[slot] if slot >= 0 else None
            if req is None:
                continue
            n_valid[i] = min(req.gen_len - len(req.out), self.NS)
            if self.eos_id is not None:
                stop_tok[i] = self.eos_id
            t, p, k = self._request_sampling(req)
            temps[i] = max(t, 0.0)
            sampcfg[i] = sampling.sampcfg_row(t, p, k, V)
        eos = self.eos_id is not None and self.NS > 1
        return _MegaPlan(rows=rows, B=B, compact=compact, eos=eos,
                         n_valid=n_valid,
                         stop_tok=stop_tok if eos else None,
                         sampled=bool((temps > 0.0).any()),
                         filtered=filtered, temps=temps,
                         sampcfg=sampcfg if filtered else None)

    def _mega_round(self):
        """One ``ns``-step launch, pipelined behind the in-flight resident
        launch when there is one, or None when the round takes the
        single-step fallback. With a launch in flight, the next is issued
        off its device outputs first and parked in ``_pend`` before the
        in-flight one drains, so a drain that raises reaches the step
        guard with the new launch still owned (``_abort_pend`` waits for
        it before teardown frees pages it reads)."""
        if self._pend is not None:
            pend, self._pend = self._pend, None
            nxt = self._issue_resident(pend)
            if nxt is not None:
                self._pend = nxt
                self._bump("mega_resident_rounds")
            return self._drain_launch(pend)
        plan = self._mega_plan()
        if plan is None:
            return None
        pend = self._launch_mega(plan)
        if self.resident:
            # Its tokens land at the next drain; the round made progress.
            self._pend = pend
            return True
        return self._drain_launch(pend)

    def _issue_resident(self, chain: _MegaLaunch):
        """The next resident launch, chained off ``chain``'s device outputs
        with no host sync, or None when no launch composes (the pipeline
        breaks; the next round replans from host truth). The slot set is
        ``chain``'s: every slot-state mutation site drains first, so only
        retires at the coming drain differ, and those rows ride along with
        ``n_valid`` 0 (their writes go to the trash page, their tokens are
        dropped)."""
        n_valid = np.zeros(chain.plan.B, np.int32)
        for i, slot in enumerate(chain.plan.rows):
            req = self._slots[slot] if slot >= 0 else None
            if req is None:
                continue
            # The pending launch emits at most its n_valid tokens for this
            # row first; an eos inside it retires the row at its drain,
            # and the chained halt bits already stop this launch's writes.
            rem = req.gen_len - len(req.out) - int(chain.plan.n_valid[i])
            n_valid[i] = min(max(rem, 0), self.NS)
        if not n_valid.any():
            return None
        # Host _kv_len is already projected past the pending launch.
        active = np.asarray([r is not None for r in self._slots], np.int32)
        if int((self._kv_len * active).max()) + self.NS > self.max_length:
            return None
        return self._launch_mega(dataclasses.replace(chain.plan,
                                                     n_valid=n_valid),
                                 chain=chain)

    def _launch_mega(self, plan: _MegaPlan,
                     chain: _MegaLaunch | None = None) -> _MegaLaunch:
        """Issue one ``ns``-step launch for ``plan`` with the launch-time
        host bookkeeping (projected kv_len, counters, the doorbell). A
        bucket launch runs on compacted table/kv_len views of the same
        pools; filler rows keep a zeroed table row (the trash page) and
        kv_len 0. A chained launch (``chain``) takes its tokens, halt bits
        and cache from the pending launch's device outputs. Nothing here
        waits for the device: host arrays reach it through pinned,
        non-blocking copies."""
        NS = self.NS
        dev = self.model.device
        mega = self._mega_model()
        if chain is not None:
            tok = chain.toks[NS - 1]
            cache_in = chain.cache
            halt_in = chain.halt
        else:
            rows = np.asarray([max(s, 0) for s in plan.rows], np.int64)
            tok = _h2d(self._tok[rows], dev)
            cache_in = self.cache
            if plan.compact:
                tbl = self._table[rows].copy()
                kvl = self._kv_len[rows].copy()
                for i, slot in enumerate(plan.rows):
                    if slot < 0 or self._slots[slot] is None:
                        tbl[i] = 0
                        kvl[i] = 0
                cache_in = dataclasses.replace(
                    self.cache, page_table=_h2d(tbl, dev),
                    kv_len=_h2d(kvl, dev))
            halt_in = (torch.zeros(plan.B, dtype=torch.int32, device=dev)
                       if plan.eos else None)
        extra = [_h2d(plan.n_valid, dev)]
        if plan.eos:
            extra += [_h2d(plan.stop_tok, dev), halt_in]
        doorbell = None
        if self._ring is not None:
            # One doorbell per launch; what was pushed before it is this
            # launch's to observe.
            state = self._ring.publish()
            doorbell = int(state[0])
            self._ring_gauge.set(int(state[3]))
            self._bump("mega_ring_doorbells")
            self._ring.consume()
            extra.append(_h2d(state, dev))
        if plan.sampled:
            # One draw per launch from the engine's generator (the JAX
            # engine draws it from the engine key too), scaled per row.
            v_pad = mega._dims(plan.B, self.max_length).v_loc
            temps = _h2d(plan.temps, dev)
            extra.append(sampling.gumbel((NS, plan.B, v_pad), self._gen, dev)
                         * temps[None, :, None])
        if plan.filtered:
            extra.append(_h2d(plan.sampcfg, dev))
        fn = mega.decode_multi_fn(
            plan.B, self.max_length, NS, sampled=plan.sampled,
            page=self.page_size, kv_quant=self.kv_dtype is not None,
            num_pages=self.cache.num_pages, valid_arg=True,
            trace=self.kernel_trace, filtered=plan.filtered, eos=plan.eos,
            ring=self._ring is not None)
        t0 = time.monotonic()
        outs = fn(mega._step_params(), tok, cache_in, *extra)
        toks, new_cache = outs[0], outs[2]
        ss = halt = None
        if plan.eos:
            ss, halt = outs[3], outs[4]
        ring = outs[-1] if self.kernel_trace else None
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
            kv_len=_h2d(self._kv_len, dev))
        if plan.compact:
            self._bump("mega_bucket_launches")
        if plan.filtered:
            self._bump("mega_filtered_rounds")
        n_active = int(sum(s >= 0 and self._slots[s] is not None
                           for s in plan.rows))
        self._bump("decode_steps", NS)
        self._bump_moe(NS * n_active)
        self._bump("mega_launches")
        obs_events.emit("mega:launch", ns=NS, active=n_active)
        return _MegaLaunch(plan=plan, toks=toks, cache=new_cache, ss=ss,
                           halt=halt, ring=ring, t0=t0, doorbell=doorbell)

    def _drain_pend(self) -> bool:
        """The resident pipeline's sync point: drain the in-flight launch
        (if any). Every site that mutates slot state an in-flight launch
        reads (admission, deadline expiry, the end of a run) calls it
        first."""
        pend, self._pend = self._pend, None
        if pend is None:
            return False
        return self._drain_launch(pend)

    def _abort_pend(self) -> None:
        """Teardown-path drain: wait for (then drop) the in-flight launch,
        so no exit path leaves a launch reading state the teardown is
        about to reuse."""
        pend, self._pend = self._pend, None
        if pend is None or not pend.toks.is_cuda:
            return
        try:
            torch.cuda.current_stream(pend.toks.device).synchronize()
        except RuntimeError:  # a failed launch: teardown goes on
            pass

    def _drain_launch(self, pend: _MegaLaunch) -> bool:
        """Fetch one launch's tokens and emit/retire through the normal
        paths. A device stop-token hit (``stop_step < n_valid``) ends the
        row's stream at the stop token. A traced launch's ring is folded
        into the tracer's telemetry here."""
        plan = pend.plan
        toks_np = pend.toks.cpu().numpy()  # [NS, B]: the host sync
        ss_np = pend.ss.cpu().numpy() if pend.ss is not None else None
        if pend.ring is not None:
            self._record_kernel_trace(pend.ring, pend.t0,
                                      time.monotonic() - pend.t0, self.NS,
                                      doorbell=pend.doorbell)
            self._bump("mega_trace_launches")
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
        tier_chains = None
        if (self.tier is not None
                and self.tier.may_contain(kv_tier.PREFIX_KIND)):
            tier_chains = self.tier.resident_chains()
        paths = self.prefix.propose_continuations(
            hist, width=req.spec.width, depth=k, tier_chains=tier_chains)
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
            t, p, k = self._request_sampling(req)
            knobs = dict(temperature=t, top_p=p, top_k=k)
            if isinstance(draft, TreeDraft):
                any_failed |= self._spec_tree_slot(req, slot, draft, kv,
                                                   bursts, knobs)
                continue
            # One per-request generator per verify: its accept and
            # resample draws stay the request's own.
            emitted, self.cache, a = spec_verify_slot(
                self.model, self.cache, slot, int(self._tok[slot]), draft,
                kv, self.mode,
                generator=self._req_gen(req) if t > 0.0 else None, **knobs,
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
            # The verify chunk routes draft + 1 positions of the slot.
            self._bump_moe(len(draft) + 1)
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
                        kv: int, bursts: dict, knobs: dict) -> bool:
        """One TREE verify of ``slot`` inside a round: the multi-branch
        chunk forward, the greedy (or, under ``knobs``' temperature,
        sample-then-match) walk, the row-move commit of the accepted
        branch. On success ``bursts[slot]`` holds the emitted tokens;
        returns True when the slot FAILED (non-finite logits)."""
        emitted, self.cache, path = spec_verify_tree(
            self.model, self.cache, slot, tree, kv, self.mode,
            next_gen=lambda: self._req_gen(req), **knobs)
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
        # The verify chunk routes every trie node's position.
        self._bump_moe(len(tree))
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
        if queue and self._pend is not None:
            # Admission mutates slot, table and pool state the in-flight
            # resident launch still reads: the pipeline drains first. An
            # empty queue mutates nothing and keeps the pipeline going.
            self._drain_pend()
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
                if self._sharded_eligible(head):
                    # A sharded slot holds at most the resident budget;
                    # the rest of its KV lives in the tier.
                    need = self.budget_pages
                    avail = len(self.pool.free) + (
                        self.prefix.reclaimable_pages()
                        if self.prefix is not None else 0
                    )
                    if need > avail:
                        self._bump("admission_stalls")
                        progress = False
                        break  # head-of-line waits for budget pages
                elif self.prefix is not None:
                    if self.tier is not None:
                        # Pull tier-resident pages of this prompt back
                        # into the tree BEFORE the match, so a spilled
                        # prefix re-maps instead of re-prefilling.
                        self._tier_fill(head.prompt)
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
                self._ring_push(work_ring.RING_ADMIT, slot, len(req.prompt))
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
            refuse_at_tp(self.model, temperature=(r.temperature or 0.0) > 0)
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
            if self._sharded_eligible(r):
                # A sharded admission holds only the resident budget.
                need = self.budget_pages
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
            # Wait for any in-flight resident launch before teardown
            # reuses the state it reads; the session's last ring items
            # (the final retires) have no doorbell to ride: drain them,
            # so the ring is empty at rest.
            self._abort_pend()
            self._flush_ring()
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

    def _audit_tier(self) -> list[str]:
        """Tier cross-check, run by :meth:`audit` when a tier is
        attached: for every full tree page whose chain also has a tier
        entry, that entry's chain must equal the node's (a mismatch
        means a later fault-back would map wrong KV under this
        prompt)."""
        problems: list[str] = []
        for node in self.prefix.walk() if self.prefix is not None else ():
            if len(node.chunk) != self.page_size:
                continue
            chain = [int(t) for t in node_chain(node)]
            entry = self.tier.peek(
                kv_tier.PREFIX_KIND, kv_tier.chain_digest(chain)
            )
            if entry is None:
                continue
            if [int(t) for t in entry.get("chain", [])] != chain:
                problems.append(
                    f"tier entry for tree page {node.page} carries a "
                    "different token chain than the node"
                )
        return problems

    def audit(self, *, raise_on_violation: bool = False) -> list[str]:
        """Pool/radix invariant audit: free list ∪ slot-private pages ∪
        tree pages ∪ trash page partition the pool exactly; shared
        mappings target live tree pages; tree refcounts equal live slot
        references; host table rows mirror each request's page list
        (a sharded slot's: its resident pages). With a tier, the tier's
        own audit and the tree/tier chain cross-check; the sharded
        slots' invariants."""
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
        if self.tier is not None:
            problems += [f"tier: {p}" for p in self.tier.audit()]
            problems += self._audit_tier()
        problems += self._audit_longctx()
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
