"""Qwen3 megakernel model: a whole decode step (or NS steps) as ONE kernel.

Counterpart of ``triton_distributed_tpu/megakernel/qwen3.py``
``MegaQwen3``: ``build`` / ``decode_step`` / ``decode_fn`` for one step
and ``build_multi`` / ``decode_multi_fn`` for ``nsteps`` greedy steps
per launch (in-kernel argmax fed back to the next step, the launch's
own earlier rows attended as the in-launch band), over a dense
:class:`KVCache` or a full-width :class:`PagedKVCache`, with
``valid_arg`` (kept-row counts; overshoot rows go to the trash page) and
``eos`` (the first stop-token step per row, which clamps the kept rows:
``keep = min(n_valid, stop_step + 1) * (1 - halt)``).

The kernel never writes the cache: the new K/V rows leave as ``knew /
vnew [NS, L, B, hkv, hd]`` and the step appends them (in place, as the
port's caches are written). It reads the model's own parameter tensors;
nothing is copied.

Refused with ``NotImplementedError``: sampled and filtered multi-step
decode, the work ring, the task tracer, int8 pools (``kv_quant``),
int8 weights (``wq8``), MoE models and the prefill megakernel
(ROADMAP queue 2 row 6).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.megakernel.code_generator import (
    WQ8_UNPORTED,
    MegaConfig,
    MegaDims,
    MegaWeights,
)
from triton_distributed_tpu_torch.megakernel.model_builder import ModelBuilder
from triton_distributed_tpu_torch.megakernel.scheduler import SchedulePolicy
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    PagedKVCache,
    append,
    append_n,
)


def _refuse(**modes) -> None:
    msgs = {
        "sampled": "sampled multi-step decode (ROADMAP queue 2 row 6(b))",
        "filtered": "in-kernel top-k/top-p (ROADMAP queue 2 row 6(b))",
        "ring": "the resident work ring (ROADMAP queue 2 row 6(c))",
        "trace": "the device task tracer (ROADMAP queue 2 row 6(c))",
        "kv_quant": "the int8 pool in the megakernel (ROADMAP queue 2 "
                    "row 6, int8 pool)",
        "straggler_rank": "multi-rank fixtures (ROADMAP queue 2 row 6(e))",
    }
    for name, value in modes.items():
        if value:
            raise NotImplementedError(f"{msgs[name]} is not ported yet")


class MegaQwen3:
    """Megakernel decode wrapper around a loaded :class:`Qwen3`."""

    def __init__(self, model, *, cfg: MegaConfig | None = None,
                 policy: SchedulePolicy = SchedulePolicy.ROUND_ROBIN):
        if model.params is None:
            raise ValueError("load or init Qwen3 params first")
        self.cfg = cfg or MegaConfig()
        if self.cfg.wq8:
            raise NotImplementedError(WQ8_UNPORTED)
        if getattr(model.cfg, "num_experts", 0):
            raise NotImplementedError(
                "MoE megakernel decode is not ported yet (ROADMAP queue 2 "
                "row 6(e))")
        self.model = model
        self.policy = policy
        self._jit: dict = {}

    def _dims(self, batch: int, s_max: int, page: int = 0,
              kv_quant: bool = False, num_pages: int = 0,
              trace: bool = False) -> MegaDims:
        c = self.model.cfg
        return MegaDims(
            batch=batch, d=c.hidden_size, hq_loc=c.num_q_heads,
            hkv_loc=c.num_kv_heads, head_dim=c.head_dim,
            f_loc=c.intermediate_size,
            v_loc=int(self.model.params["lm_head"].shape[1]),
            num_layers=c.num_layers, s_max=s_max, n_ranks=1,
            rms_eps=c.rms_eps, rope_theta=c.rope_theta, page=page,
            kv_quant=kv_quant, num_pages=num_pages, trace=trace,
        )

    def _compile(self, dims: MegaDims):
        mb = ModelBuilder(dims, cfg=self.cfg, device=self.model.device)
        mb.build_decoder_graph()
        return mb.compile(self.policy)

    def _step_params(self) -> dict:
        """What the built steps take as their first argument."""
        return self.model.params

    # -- single step ------------------------------------------------------
    def build(self, batch: int, s_max: int, page: int = 0,
              kv_quant: bool = False, num_pages: int = 0,
              trace: bool = False):
        """Build and schedule the task graph; returns ``(compiled, step,
        f)`` with ``f(params, tokens, cache) → (logits [B, V], cache)``
        (``step`` is the same function: PyTorch has nothing to jit)."""
        _refuse(kv_quant=kv_quant, trace=trace)
        dims = self._dims(batch, s_max, page, kv_quant, num_pages, trace)
        compiled = self._compile(dims)
        run = compiled.run
        V = self.model.cfg.vocab_size

        def f(params, tokens, cache):
            tokens = _tokens(tokens, self.model.device)
            w = MegaWeights.from_params(params)
            if page:
                logits, knew, vnew, _, _ = run(
                    w, cache.k_pages, cache.v_pages, cache.page_table,
                    cache.kv_len, tokens)
                cache = append(cache, knew[0], vnew[0])
            else:
                logits, knew, vnew, _, _ = run(
                    w, cache.k, cache.v, None, cache.kv_len, tokens)
                cache = _dense_append(cache, knew, vnew)
            # Drop the vocab-pad logits (zero columns score 0).
            return logits[:, :V], cache

        return compiled, f, f

    def _built(self, batch: int, s_max: int, page: int = 0,
               kv_quant: bool = False, num_pages: int = 0,
               trace: bool = False):
        key = (batch, s_max, page, kv_quant, num_pages, trace)
        if key not in self._jit:
            self._jit[key] = self.build(*key)
        return self._jit[key]

    def decode_step(self, tokens, cache):
        """One decode step for the whole batch: ``tokens [B]`` →
        ``(logits [B, V] f32, cache)`` over a dense or paged cache (one
        launch of the kernel, ``nsteps = 1``)."""
        b = int(torch.as_tensor(tokens).shape[0])
        if isinstance(cache, PagedKVCache):
            if cache.quantized:
                _refuse(kv_quant=True)
            page = int(cache.k_pages.shape[3])
            s_max = int(cache.page_table.shape[1]) * page
            step = self._built(b, s_max, page, False,
                               int(cache.k_pages.shape[1]))[1]
        else:
            step = self._built(b, int(cache.k.shape[3]))[1]
        return step(self._step_params(), tokens, cache)

    def decode_fn(self, batch: int, s_max: int, page: int = 0,
                  kv_quant: bool = False, num_pages: int = 0,
                  trace: bool = False):
        """The step ``f(params, tokens, cache) → (logits, cache)``, the
        contract of ``Qwen3.decode_fn``."""
        return self._built(batch, s_max, page, kv_quant, num_pages,
                           trace)[2]

    # -- multi-step greedy decode -------------------------------------------
    def build_multi(self, batch: int, s_max: int, nsteps: int,
                    sampled: bool = False, page: int = 0,
                    straggler_rank: int | None = None,
                    kv_quant: bool = False, num_pages: int = 0,
                    valid_arg: bool = False, trace: bool = False,
                    filtered: bool = False, eos: bool = False,
                    ring: bool = False):
        """``nsteps`` greedy decode steps in ONE kernel launch:
        ``f(params, tokens, cache[, n_valid][, stop_tok, halt]) → (toks
        [nsteps, B], last-step logits [B, V], cache advanced nsteps[,
        stop_step [B], halt [B]])``.

        Caller contract: ``kv_len[b] + nsteps <= s_max`` for every row.
        ``valid_arg`` (paged only) adds the kept-row counts ``n_valid
        [B]``: rows at or past them go to the trash page. ``eos`` (needs
        ``valid_arg``) adds ``stop_tok [B]`` (-1 = none) and ``halt
        [B]``: the kernel stamps each row's first step whose token is its
        stop token (``nsteps`` = never) and the append keeps ``min(n_valid,
        stop_step + 1) * (1 - halt)`` rows."""
        _refuse(sampled=sampled, filtered=filtered, ring=ring, trace=trace,
                kv_quant=kv_quant, straggler_rank=straggler_rank)
        if eos and not page:
            raise ValueError("eos rides the paged serving path only")
        if eos and not valid_arg:
            raise ValueError("eos needs valid_arg: device retire clamps "
                             "the per-slot kept-row counts")
        if valid_arg and not page:
            raise ValueError("valid_arg rides the paged append only")
        V = self.model.cfg.vocab_size
        base = self._dims(batch, s_max, page, kv_quant, num_pages, trace)
        dims = dataclasses.replace(base, nsteps=nsteps, v_real=V, eos=eos)
        run = self._compile(dims).run
        dev = self.model.device

        def f(params, tokens, cache, *extra):
            tokens = _tokens(tokens, dev)
            w = MegaWeights.from_params(params)
            ex = list(extra)
            n_valid = _ints(ex.pop(0), dev) if valid_arg else None
            stop_tok = _ints(ex.pop(0), dev) if eos else None
            halt = _ints(ex.pop(0), dev) if eos else None
            if page:
                logits, knew, vnew, toks, ss = run(
                    w, cache.k_pages, cache.v_pages, cache.page_table,
                    cache.kv_len, tokens, stop_tok)
                # [NS, L, B, hkv, hd] → [L, B, hkv, NS, hd]: one scatter
                # lands every step's rows.
                k_rows = knew.permute(1, 2, 3, 0, 4)
                v_rows = vnew.permute(1, 2, 3, 0, 4)
                if eos:
                    keep = torch.minimum(n_valid, ss + 1) * (1 - halt)
                    halt_out = torch.maximum(
                        halt, (ss < nsteps).to(torch.int32))
                    return (toks, logits[:, :V],
                            append_n(cache, k_rows, v_rows, keep), ss,
                            halt_out)
                return (toks, logits[:, :V],
                        append_n(cache, k_rows, v_rows, n_valid))
            logits, knew, vnew, toks, _ = run(
                w, cache.k, cache.v, None, cache.kv_len, tokens)
            return toks, logits[:, :V], _dense_append(cache, knew, vnew)

        return f

    @staticmethod
    def _multi_key(batch, s_max, nsteps, sampled=False, page=0,
                   kv_quant=False, num_pages=0, valid_arg=False,
                   trace=False, filtered=False, eos=False, ring=False):
        return ("multi", batch, s_max, nsteps, sampled, page, kv_quant,
                num_pages, valid_arg, trace, filtered, eos, ring)

    def decode_multi_fn(self, batch: int, s_max: int, nsteps: int,
                        sampled: bool = False, page: int = 0,
                        kv_quant: bool = False, num_pages: int = 0,
                        valid_arg: bool = False, trace: bool = False,
                        filtered: bool = False, eos: bool = False,
                        ring: bool = False):
        """The multi-step function of :meth:`build_multi`, built once per
        option tuple."""
        key = self._multi_key(batch, s_max, nsteps, sampled, page,
                              kv_quant, num_pages, valid_arg, trace,
                              filtered, eos, ring)
        if key not in self._jit:
            self._jit[key] = self.build_multi(
                batch, s_max, nsteps, sampled, page, kv_quant=kv_quant,
                num_pages=num_pages, valid_arg=valid_arg, trace=trace,
                filtered=filtered, eos=eos, ring=ring)
        return self._jit[key]

    # -- refused ----------------------------------------------------------
    def prefill(self, tokens, cache, *, true_len=None):
        raise NotImplementedError(
            "the prefill megakernel (_build_prefill) is not ported yet "
            "(ROADMAP queue 2 row 6(d)); the engines prefill with 'xla'")

    def quantized_params(self):
        raise NotImplementedError(WQ8_UNPORTED)


def _ints(a, dev) -> torch.Tensor:
    """``a`` as a contiguous int32 tensor on ``dev`` whose storage starts
    16-byte aligned, as every kernel operand must (a row of a launch's
    token output is a view at an offset: it is copied)."""
    t = torch.as_tensor(a).to(dev, torch.int32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


_tokens = _ints


def _dense_append(cache: KVCache, knew: torch.Tensor,
                  vnew: torch.Tensor) -> KVCache:
    """Write the launch's rows ``[NS, L, B, hkv, hd]`` at each row's
    ``kv_len .. kv_len + NS - 1`` (in place; positions clamp at the
    cache end, which the caller's capacity contract never reaches) and
    return the cache with ``kv_len + NS``."""
    NS, L, B, H, hd = knew.shape
    dev = cache.k.device
    pos = cache.kv_len.long()[:, None] + torch.arange(NS, device=dev)[None]
    pos = torch.clamp(pos, max=cache.k.shape[3] - 1).reshape(-1)
    rows = torch.arange(B, device=dev).repeat_interleave(NS)
    for dst, new in ((cache.k, knew), (cache.v, vnew)):
        # [B*NS, L, H, hd]: the advanced (row, pos) axes lead.
        dst[:, rows, :, pos, :] = new.permute(2, 0, 1, 3, 4).reshape(
            B * NS, L, H, hd).to(dst.dtype)
    return KVCache(k=cache.k, v=cache.v, kv_len=cache.kv_len + NS)
