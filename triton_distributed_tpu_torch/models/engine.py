"""Fixed-batch serving engine: prefill + decode loop.

Counterpart of ``triton_distributed_tpu/models/engine.py``:
``Engine.serve`` with a dense cache (``paged=False``), a paged pool
(``paged=True``) and the cross-serve radix prefix cache
(``paged=True, prefix_cache=True``), plus ``prefill_suffix_chunks``,
the chunked suffix prefill both engines share. Decode is greedy.
``kv_dtype="int8"`` (paged only) stores the pool as int8 codes plus
per-page scales. ``speculative=K`` (paged only) decodes each row through
n-gram draft verify chunks and, with ``spec_width > 1`` on a full-width
pool with the prefix cache, draft trees fed by the radix tree.

``mode="mega"`` decodes through the megakernel (``MegaDispatch``):
``serve(ns=8)`` runs ``(gen_len - 1) // ns`` launches of ``ns`` steps
each (in-kernel argmax) and the remainder as single-step launches of
the same kernel; prefill runs the ``xla`` path, as in the JAX package.

Not ported, and refused when asked for: ``mode="pallas"``, ``profile``,
``temperature > 0``, ``MegaConfig(wq8=True)`` (ROADMAP queues 1 and 2).
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from triton_distributed_tpu_torch.layers.tp_mlp import check_mode
from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    PoolAuditError,
    audit_pool,
    copy_page,
    gather_bucket,
    init_paged_cache,
    kv_bytes_per_token,
    resolve_kv_dtype,
    rollback_kv,
    write_prefill,
)
from triton_distributed_tpu_torch.models.prefix_cache import (
    PrefixCache,
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
    SPEC_STATS_KEYS,
    STAT_METRICS,
    kv_dtype_name,
    spec_summary,
)
from triton_distributed_tpu_torch.obs import metrics as obs_metrics
from triton_distributed_tpu_torch.runtime.context import resolve_device

SAMPLED_SERVING = (
    "temperature > 0 is not ported yet: sampled serving with "
    "per-request torch.Generators is ROADMAP queue 1, item 4b"
)


def engine_setup(model, device, mode: str, temperature: float,
                 mega_cfg=None, **unported) -> None:
    """Ctor checks both engines share: the engine runs on ``device``
    (``cuda`` unless given; it must be the model's), in ``mode='xla'`` or
    ``'mega'``, greedy, and every knob this slice does not port is
    refused."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(
            f"engine device {dev} differs from the model's {model.device}"
        )
    if mode != "mega":
        check_mode(mode)
    if mega_cfg is not None and mega_cfg.wq8:
        from triton_distributed_tpu_torch.megakernel.code_generator import (
            WQ8_UNPORTED,
        )

        raise NotImplementedError(WQ8_UNPORTED)
    if temperature > 0.0:
        raise NotImplementedError(SAMPLED_SERVING)
    for name, value in unported.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (see ROADMAP queue 1)"
            )


def prefill_suffix_chunks(
    model,
    cache,
    slot: int,
    prompt,
    start: int,
    chunk_width: int,
    mode,
    between_chunks=None,
):
    """Chunk-prefill ``prompt[start:]`` of one slot/row over the paged
    cache — the prefix-cache suffix path shared by both engines.
    ``chunk_width=0`` runs the whole suffix as one (rounded) chunk.
    ``between_chunks(cache, new_len)`` runs after every non-final chunk
    and returns the cache to keep threading. Returns
    ``(last-token logits [V], cache, chunks_run)``."""
    s = len(prompt)
    c = round_chunk(chunk_width) if chunk_width else round_chunk(s - start)
    page = int(cache.k_pages.shape[3])
    pps = int(cache.page_table.shape[1])
    logits, off, chunks = None, start, 0
    while off < s:
        take = min(c, s - off)
        buf = np.zeros(c, np.int32)
        buf[:take] = prompt[off : off + take]
        kv_pages = gather_bucket(off + c, page, pps)
        logits, cache = model.prefill_paged_chunk(
            buf, slot, off, off + take, take - 1, cache, mode,
            kv_pages=kv_pages,
        )
        chunks += 1
        off += take
        if off < s and between_chunks is not None:
            cache = between_chunks(cache, off)
    return logits, cache, chunks


class MegaDispatch:
    """Megakernel-mode dispatch shared by both engines: the lazy
    :class:`MegaQwen3`, the ``xla`` prefill under ``mode='mega'`` and the
    single-step decode. Expects ``self.model``, ``self.mode`` and
    ``self.mega_cfg`` (None → the JAX engines' serving default, fused
    norms; its TPU staging flags do not change the CUDA kernel). With a
    card, every mega-mode decode step is a launch of the megakernel;
    nothing falls back to ``mode='xla'``."""

    _mega = None
    mega_cfg = None

    @property
    def _prefill_mode(self) -> str:
        # The mega prefill graph is not ported: prefill runs the model's
        # own path, as the JAX engines do under mode='mega'.
        return "xla" if self.mode == "mega" else self.mode

    def _mega_model(self):
        if self._mega is None:
            from triton_distributed_tpu_torch.megakernel import (
                MegaConfig,
                MegaQwen3,
            )

            cfg = self.mega_cfg or MegaConfig(
                fuse_norms=True, cross_prefetch=True, overlap_ar=True)
            self._mega = MegaQwen3(self.model, cfg=cfg)
        return self._mega

    def _decode_step(self, tok, cache):
        if self.mode == "mega":
            return self._mega_model().decode_step(tok, cache)
        return self.model.decode_step(tok, cache, self.mode)


class _PrefixState:
    """Cross-serve prefix-cache state: the pool-backed cache, its pool
    and the radix tree. ``dirty`` is set for the duration of a serve; a
    crash mid-serve leaves it set and the next serve rebuilds."""

    __slots__ = ("key", "cache", "pool", "tree", "dirty")

    def __init__(self, key, cache, pool, tree):
        self.key = key
        self.cache = cache
        self.pool = pool
        self.tree = tree
        self.dirty = False


class Engine(MegaDispatch):
    """Fixed-batch engine (``serve`` prefills a batch, then decodes it)."""

    # Live engines, auditable by the port's tests after every test.
    _live: "weakref.WeakSet[Engine]" = weakref.WeakSet()

    def __init__(
        self,
        model,
        *,
        temperature: float = 0.0,
        mode: str = "xla",
        paged: bool = False,
        page_size: int = 128,
        prefix_cache: bool = False,
        prefill_chunk: int = 0,
        speculative: int = 0,
        spec_width: int = 4,
        kv_dtype: str | None = None,
        mega_cfg=None,
        device=None,
    ):
        engine_setup(model, device, mode, temperature, mega_cfg)
        # The explicit knob wins over the model config's kv_dtype; the
        # scales live on the page pool, so a dense cache cannot hold int8.
        self.kv_dtype = resolve_kv_dtype(kv_dtype, model.cfg)
        if speculative and not paged:
            raise ValueError(
                "speculative=K requires paged=True (verify chunks run "
                "through the paged chunk-prefill path)"
            )
        if speculative and mode == "mega":
            raise ValueError(
                "speculative=K composes with mode='xla', not the "
                "megakernel"
            )
        self.speculative = int(speculative)
        # Draft trees only on a full-width pool (the commit is a KV
        # row-move, which int8 per-page scales cannot carry).
        self.spec_width = max(int(spec_width), 1)
        self._spec_tree = (bool(speculative) and self.spec_width > 1
                           and self.kv_dtype is None)
        if self.kv_dtype is not None and not paged:
            raise ValueError(
                "kv_dtype requires paged=True (scales live on the "
                "page pool; the dense cache has no pages)"
            )
        self.model = model
        self.mode = mode
        self.mega_cfg = mega_cfg
        self.last_stats: dict = {}
        self.paged = paged
        self.page_size = page_size
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache=True requires paged=True (the radix tree "
                "shares pool pages; a dense cache has none)"
            )
        if paged and model.cfg.max_length % page_size != 0:
            raise ValueError(
                f"max_length={model.cfg.max_length} is not a multiple "
                f"of page_size={page_size}; paged serving needs the "
                "context to tile into whole pages"
            )
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self._prefix_state: _PrefixState | None = None
        self._prefix_counters: dict = {}
        self._metric_handles = {
            key: obs_metrics.counter(*STAT_METRICS[key])
            for key in ("decode_steps", "prefill_tokens", "generated_tokens")
        }
        self._metric_handles["serve_seconds"] = obs_metrics.histogram(
            "tdt_engine_serve_seconds",
            "Wall time of one fixed-batch serve() call.",
        )
        Engine._live.add(self)

    def audit(self, *, raise_on_violation: bool = False) -> list[str]:
        """Pool/radix invariant audit of the cross-serve prefix state:
        between serves every page is free or tree-owned and no pin is
        left behind. A ``dirty`` state (aborted serve) is skipped — it
        is rebuilt, not reused."""
        state = self._prefix_state
        if state is None or state.dirty:
            return []
        problems = state.tree.audit()
        for node in state.tree.walk():
            if node.refcount:
                problems.append(
                    f"idle tree node page {node.page} still pinned "
                    f"(refcount {node.refcount}) between serves"
                )
        problems += audit_pool(
            state.pool, state.pool.num_pages,
            {"tree": [n.page for n in state.tree.walk()]}, reserved=(0,),
        )
        if problems and raise_on_violation:
            raise PoolAuditError("; ".join(problems))
        return problems

    def serve(
        self,
        input_ids,  # [B, S] int32 (list/np/tensor)
        gen_len: int,
        max_length: int | None = None,
        profile: str | None = None,
        prompt_start=None,
        ns: int = 8,
    ) -> np.ndarray:
        """Generate ``gen_len`` tokens for each sequence; returns
        ``[B, S + gen_len]``. ``prompt_start[i]`` marks where row i's
        real prompt begins (client left-padding before it): rows are
        rolled so pads sit on the RIGHT, where causal masking makes them
        inert, and the real length rides to the prefill. ``ns`` is the
        megakernel's launch width (``mode='mega'`` only)."""
        if profile is not None:
            raise NotImplementedError(
                "profile= is not ported yet (ROADMAP queue 1, item 12)"
            )
        input_ids = np.asarray(input_ids, np.int32)
        b, s = input_ids.shape
        starts = np.zeros(b, np.int64) if prompt_start is None else (
            np.asarray(prompt_start, np.int64)
        )
        if starts.shape != (b,) or (starts < 0).any() or (starts >= s).any():
            raise ValueError(
                f"prompt_start must be [batch={b}] ints in [0, {s}); got "
                f"{starts.tolist()}"
            )
        max_length = max_length or self.model.cfg.max_length
        if self.paged and max_length % self.page_size != 0:
            raise ValueError(
                f"max_length={max_length} is not a multiple of "
                f"page_size={self.page_size}; paged serving needs the "
                "context to tile into whole pages"
            )
        t0 = time.perf_counter()
        rows = np.stack(
            [np.roll(input_ids[i], -int(starts[i])) for i in range(b)]
        )
        true_lens = (s - starts).astype(np.int32)
        if s > max_length:
            raise ValueError(
                f"prompt width {s} exceeds max_length={max_length}; raise "
                "max_length or shorten"
            )
        if int(true_lens.max()) + gen_len - 1 > max_length:
            raise ValueError(
                f"longest real prompt ({int(true_lens.max())}) + gen_len "
                f"({gen_len}) exceeds max_length={max_length}; raise "
                f"max_length or shorten"
            )
        pad = round_chunk(1)
        if (self.speculative and gen_len > 1
                and int(true_lens.max()) + gen_len - 2 + pad > max_length):
            # Every verify chunk pads to round_chunk(·) >= 16 rows whose
            # KV is written too; the furthest row's last chunk must fit.
            raise ValueError(
                f"speculative serve pads verify chunks to {pad} tokens; "
                f"longest prompt ({int(true_lens.max())}) + gen_len "
                f"({gen_len}) + {pad - 1} exceeds max_length={max_length}"
                " — raise max_length or shorten"
            )
        row_meta = None
        if self.prefix_cache:
            logits, cache, row_meta = self._prefix_prefill(
                rows, true_lens, gen_len, max_length
            )
        elif self.paged:
            cache, _pool = init_paged_cache(
                self.model.cfg, b, self.model.device,
                max_length=max_length, page_size=self.page_size,
                kv_dtype=self.kv_dtype,
            )
            # One batch-1 dense scratch, reused per row then copied into
            # pages — a full-batch dense cache beside the pool would
            # double peak KV memory.
            dense1 = self.model.new_cache(1, max_length)
            last_logits = []
            for i in range(b):
                logits_i, dense1 = self.model.prefill_batched(
                    rows[i : i + 1], dense1, self._prefill_mode,
                    true_lens[i : i + 1],
                )
                cache = write_prefill(
                    cache, i, dense1.k, dense1.v, int(true_lens[i])
                )
                last_logits.append(logits_i[0])
            logits = torch.stack(last_logits)
        else:
            cache = self.model.new_cache(b, max_length)
            logits, cache = self.model.prefill_batched(
                rows, cache, self._prefill_mode, true_lens,
            )
        t_prefill = time.perf_counter() - t0

        out = [input_ids]
        tok = sampling.greedy(logits)
        out.append(tok.cpu().numpy()[:, None])
        t0 = time.perf_counter()
        spec = None
        mega_launches = 0
        if self.speculative and gen_len > 1:
            tail, cache, spec = self._spec_decode(
                cache, out[-1][:, 0], rows, true_lens, gen_len, max_length)
            out.append(tail)
        else:
            left = gen_len - 1
            if self.mode == "mega":
                tok, cache, left, mega_launches = self._mega_multi(
                    tok, cache, b, int(true_lens.max()), left, ns, out)
            for _ in range(left):
                logits, cache = self._decode_step(tok, cache)
                tok = sampling.greedy(logits)
                out.append(tok.cpu().numpy()[:, None])
        t_decode = time.perf_counter() - t0

        result = np.concatenate(out, axis=1)
        # decode_steps counts batched decode steps only; verify chunks
        # ride spec_verify_steps (target_steps is their sum).
        steps = (max(gen_len - 1, 0) if spec is None
                 else spec["spec_decode_steps"])
        prefill_toks = int(true_lens.sum())
        if row_meta is not None:
            prefill_toks = self._prefix_counters["prefill_tokens"]
        self.last_stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_ms_per_step": t_decode / max(gen_len - 1, 1) * 1e3,
            "tokens_per_s": b * max(gen_len - 1, 1) / max(t_decode, 1e-9),
            "decode_steps": steps,
            "prefill_tokens": prefill_toks,
            "generated_tokens": int(b * gen_len),
        }
        if self.mode == "mega":
            self.last_stats["mega_launches"] = mega_launches
        if spec is not None:
            self.last_stats.update(spec)
            self.last_stats.update(spec_summary(self.last_stats))
        h = self._metric_handles
        h["decode_steps"].inc(steps)
        h["prefill_tokens"].inc(prefill_toks)
        h["generated_tokens"].inc(int(b * gen_len))
        h["serve_seconds"].observe(t_prefill + t_decode)
        if self.paged:
            self.last_stats["kv_bytes_per_token"] = kv_bytes_per_token(cache)
            self.last_stats["kv_dtype"] = kv_dtype_name(
                self.kv_dtype, cache.k_pages.dtype)
        else:
            L, _b, H, _s, hd = cache.k.shape
            self.last_stats["kv_bytes_per_token"] = float(
                2 * L * H * hd * cache.k.element_size()
            )
            self.last_stats["kv_dtype"] = kv_dtype_name(None, cache.k.dtype)
        if row_meta is not None:
            self._prefix_retire(
                result, rows, true_lens, gen_len, cache, row_meta
            )
        return result

    def _mega_multi(self, tok, cache, b: int, kv_high: int, left: int,
                    ns: int, out: list):
        """The multi-step fast path: as many ``ns``-step launches as fit
        both the remaining tokens and the cache (a launch appends ``ns``
        rows at once, so it must not start within ``ns`` of the end).
        Returns ``(tok, cache, steps left for single-step launches,
        launches run)``."""
        NS = int(ns)
        if NS < 1:
            raise ValueError(f"ns must be >= 1, got {ns}")
        if self.paged:
            s_max = int(cache.page_table.shape[1]) * self.page_size
        else:
            s_max = int(cache.k.shape[3])
        launches = min(left // NS, max(s_max - kv_high, 0) // NS)
        if not launches:
            return tok, cache, left, 0
        fn = self._mega_model().decode_multi_fn(
            b, s_max, NS, page=self.page_size if self.paged else 0,
            num_pages=int(cache.k_pages.shape[1]) if self.paged else 0)
        params = self._mega_model()._step_params()
        for _ in range(launches):
            toks, _logits, cache = fn(params, tok, cache)
            out.append(toks.cpu().numpy().T)  # [b, NS]
            tok = toks[-1]
        return tok, cache, left - launches * NS, launches

    # -- speculative decode ------------------------------------------------

    def _spec_decode(self, cache, first_toks, rows, true_lens, gen_len: int,
                     max_length: int):
        """Per-row speculative decode over the paged cache: each row
        drafts from its own n-gram history (or a draft tree fed by the
        radix tree), verifies in one chunk forward and rolls rejected KV
        back (``rollback_kv``). Rows advance at their own pace; rows
        without a draft share one batched decode step. Returns ``(tail
        [b, gen_len-1], cache, counters)``, the tail excluding the
        prefill's first token."""
        b = len(first_toks)
        kv = true_lens.astype(np.int64).copy()
        outs, states = [], []
        for i in range(b):
            st = SpecState(self.speculative,
                           w_max=self.spec_width if self._spec_tree else 1)
            st.observe(rows[i][: int(true_lens[i])])
            st.observe([int(first_toks[i])])
            states.append(st)
            outs.append([int(first_toks[i])])
        # Previous serves' finished chains (the re-ask population) feed
        # the draft tries through the cross-serve radix tree.
        radix = (self._prefix_state.tree
                 if self._spec_tree and self._prefix_state is not None
                 else None)
        counters = {k: 0 for k in SPEC_STATS_KEYS}
        counters["spec_decode_steps"] = 0

        def nonfinite(i):
            return sampling.NonFiniteLogitsError(
                f"non-finite logits in speculative verify chunk (row {i})",
                slot=i)

        def finish_row(i, cache, emitted, a, drafted):
            counters["spec_verify_steps"] += 1
            counters["spec_draft_tokens"] += drafted
            counters["spec_accepted_tokens"] += a
            new_kv = int(kv[i]) + a + 1
            if a < drafted:
                counters["spec_rollback_tokens"] += drafted - a
                cache = rollback_kv(cache, i, new_kv)
            kv[i] = new_kv
            states[i].observe(emitted)
            outs[i].extend(emitted)
            return cache

        def verify_row(i, draft, cache):
            emitted, cache, a = spec_verify_slot(
                self.model, cache, i, outs[i][-1], draft, int(kv[i]),
                self.mode)
            if emitted is None:
                # No per-request failure channel here: fail the serve
                # (a prefix state is left dirty and rebuilt).
                raise nonfinite(i)
            states[i].record(len(draft), a)
            return finish_row(i, cache, emitted, a, len(draft))

        def verify_tree_row(i, tr, cache):
            emitted, cache, path = spec_verify_tree(
                self.model, cache, i, tr, int(kv[i]), self.mode)
            if emitted is None:
                raise nonfinite(i)
            a = len(path)
            counters["spec_tree_rounds"] += 1
            counters["spec_tree_nodes"] += tr.num_drafted
            counters["spec_tree_depth"] += tr.max_depth
            if any(int(n) != j + 1 for j, n in enumerate(path)):
                counters["spec_tree_branch_accepts"] += 1
            states[i].record_tree(tr.num_drafted, tr.max_depth, a)
            # Commit the accepted branch BEFORE the rollback truncates
            # kv_len past it.
            cache = commit_tree_path(cache, i, int(kv[i]), path)
            return finish_row(i, cache, emitted, a, tr.num_drafted)

        def plan_row(i, k):
            """Row i's draft for a ``k``-token budget: a TreeDraft when
            the candidates branch, else a token list, else None."""
            if k <= 0:
                return None
            if radix is not None and states[i].width > 1:
                paths = radix.propose_continuations(
                    states[i].draft.history, width=states[i].width, depth=k)
                ng = states[i].propose(k)
                if ng:
                    paths.append(ng)
                if not paths:
                    return None
                tr = TreeDraft(outs[i][-1])
                for p in paths:
                    tr.add_path(p[:k], budget=round_chunk(k + 1))
                return tr if not tr.is_chain else (tr.chain_tokens() or None)
            return states[i].propose(k) or None

        while True:
            live = [i for i in range(b) if len(outs[i]) < gen_len]
            if not live:
                break
            drafts = {}
            for i in live:
                k = cap_draft(states[i].k, int(kv[i]), gen_len - len(outs[i]),
                              max_length)
                assert k >= 0, "speculative capacity guard violated"
                d = plan_row(i, k)
                if d is not None:
                    drafts[i] = d
            for i, draft in drafts.items():
                if isinstance(draft, TreeDraft):
                    cache = verify_tree_row(i, draft, cache)
                else:
                    cache = verify_row(i, draft, cache)
            undrafted = [i for i in live if i not in drafts]
            if not undrafted:
                continue
            if all(len(o) < gen_len for o in outs):
                # Undrafted rows share ONE batched decode step (every
                # row's device kv_len is exact after the rollbacks);
                # just-verified rows advance one more token.
                pending = torch.tensor([o[-1] for o in outs],
                                       dtype=torch.int32)
                logits, cache = self.model.decode_step(pending, cache,
                                                       self.mode)
                toks = sampling.greedy(logits).cpu().numpy()
                counters["spec_decode_steps"] += 1
                for i in range(b):
                    outs[i].append(int(toks[i]))
                    states[i].observe((int(toks[i]),))
                    kv[i] += 1
            else:
                # A finished row would append KV past its pages in a
                # batched step: the stragglers take zero-draft verifies.
                for i in undrafted:
                    cache = verify_row(i, [], cache)
        counters["spec_tokens_per_step"] = b * (gen_len - 1) / max(
            counters["spec_verify_steps"] + counters["spec_decode_steps"], 1)
        tail = np.asarray([o[1:] for o in outs], np.int32)
        return tail, cache, counters

    # -- prefix-cache paged serving ---------------------------------------

    def _ensure_prefix_state(self, b: int, max_length: int) -> _PrefixState:
        """Pool + pool-backed cache + radix tree persisted across serve()
        calls (that persistence IS the prefix cache); rebuilt when the
        batch geometry changes or the previous serve aborted."""
        key = (b, max_length, self.page_size)
        state = self._prefix_state
        if state is None or state.key != key or state.dirty:
            pps = max_length // self.page_size
            cache, pool = init_paged_cache(
                self.model.cfg, b, self.model.device,
                max_length=max_length, page_size=self.page_size,
                # +1: page 0 reserved as the trash page unused table
                # entries point at (same convention as ContinuousEngine).
                num_pages=b * pps + 1, assign_pages=False,
                kv_dtype=self.kv_dtype,
            )
            pool.free = [p for p in pool.free if p != 0]
            self._prefix_state = _PrefixState(
                key, cache, pool, PrefixCache(pool, self.page_size)
            )
        return self._prefix_state

    def _prefix_prefill(self, rows, true_lens, gen_len: int,
                        max_length: int):
        """Admission for every batch row: longest-prefix match, map
        matched pages into the row's table, COW-clone a partially
        matched tail, chunk-prefill only the suffix. Returns
        ``(last-token logits [b, V], cache, row_meta)``."""
        b = rows.shape[0]
        state = self._ensure_prefix_state(b, max_length)
        cache, tree = state.cache, state.tree
        state.dirty = True  # in-flight; cleared by _prefix_retire
        pps = max_length // self.page_size
        table = np.zeros((b, pps), np.int32)
        row_meta = []
        matches = []
        for i in range(b):
            prompt = rows[i][: int(true_lens[i])]
            m = tree.match(prompt)
            # Positions written: the prompt plus gen_len - 1 decode
            # appends (the final sampled token is never fed back).
            total = -(
                -(int(true_lens[i]) + gen_len - 1) // self.page_size
            )
            new_pages = tree.allocate(total - len(m.nodes))
            if new_pages is None and m.cow_node is not None:
                # A COW pin holds a page without covering any of this
                # row's budget: drop it and retry before degrading.
                tree.release_node(m.cow_node)
                tree.stats["hit_tokens"] -= m.cow_len
                m.cow_node, m.cow_len = None, 0
                new_pages = tree.allocate(total - len(m.nodes))
            if new_pages is None:
                # Degrade to a cold row: with nothing pinned by this
                # row, full eviction always covers <= pages_per_seq.
                tree.release_match(m)
                new_pages = tree.allocate(total)
            if new_pages is None:
                raise RuntimeError("prefix pool sizing violated")
            pages = m.pages + new_pages
            table[i, : len(pages)] = pages
            if m.cow_len:
                cache = copy_page(cache, m.cow_node.page, new_pages[0])
            matches.append(m)
            row_meta.append([pages, list(m.nodes), m.matched_len,
                             m.cow_len])
            tree.finish_cow(m)
        cache = dataclasses.replace(
            cache,
            page_table=torch.from_numpy(table).to(self.model.device),
            kv_len=torch.zeros((b,), dtype=torch.int32,
                               device=self.model.device),
        )

        hit_tokens = prefill_tokens = cow_pages = 0
        last_logits = []
        for i in range(b):
            s = int(true_lens[i])
            start = matches[i].matched_len
            cow_pages += 1 if row_meta[i][3] else 0
            hit_tokens += start
            logits_i, cache, _ = prefill_suffix_chunks(
                self.model, cache, i, rows[i][:s], start,
                self.prefill_chunk, self._prefill_mode,
            )
            prefill_tokens += s - start
            last_logits.append(logits_i)
        self._prefix_counters = {
            "prefix_hit_tokens": hit_tokens,
            "prefill_tokens": prefill_tokens,
            "pages_cow_copied": cow_pages,
            "prefix_hit_rate": tree.hit_rate,
            "tree_pages": tree.node_count,
        }
        return torch.stack(last_logits), cache, row_meta

    def _prefix_retire(self, result, rows, true_lens, gen_len: int, cache,
                       row_meta) -> None:
        """Retire every finished row's pages into the radix tree (valid
        KV covers prompt + gen_len - 1 fed-back tokens) and keep the
        cache for the next serve() call."""
        state = self._prefix_state
        tree = state.tree
        s = result.shape[1] - gen_len
        gen = result[:, s:]
        for i, (pages, nodes, _matched, _cow) in enumerate(row_meta):
            toks = np.concatenate(
                [rows[i][: int(true_lens[i])],
                 gen[i, : gen_len - 1].astype(np.int32)]
            )
            tree.retire_sequence(toks, pages, nodes)
        state.cache = cache
        state.dirty = False  # clean: safe to reuse next serve()
        self.last_stats.update(self._prefix_counters)
        self.last_stats["prefix_cache"] = dict(tree.stats)
