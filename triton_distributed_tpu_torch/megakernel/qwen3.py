"""Qwen3 megakernel model: a whole decode step (or NS steps) as ONE kernel.

Counterpart of ``triton_distributed_tpu/megakernel/qwen3.py``
``MegaQwen3``: ``build`` / ``decode_step`` / ``decode_fn`` for one step
and ``build_multi`` / ``decode_multi_fn`` for ``nsteps`` steps per launch
(in-kernel argmax fed back to the next step, the launch's own earlier
rows attended as the in-launch band; ``sampled`` takes the argmax over
``logits + noise``, ``filtered`` over each row's top-k/top-p keep-set),
over a dense
:class:`KVCache` or a full-width :class:`PagedKVCache`, with
``valid_arg`` (kept-row counts; overshoot rows go to the trash page),
``eos`` (the first stop-token step per row, which clamps the kept rows:
``keep = min(n_valid, stop_step + 1) * (1 - halt)``), ``trace`` (the
device task tracer's ring ``[1, NS, T, 8]`` as one more return) and
``ring`` (a leading RING_POLL task observing the work-ring snapshot
``ring_state [4]``); ``prefill`` runs one prompt through the prefill
megakernel into dense cache entry 0.

The kernel never writes the cache: the new K/V rows leave as ``knew /
vnew [NS, L, B, hkv, hd]`` in the model dtype and the step appends them
(in place, as the port's caches are written). Over an int8 pool
(``kv_quant``) the kernel reads the codes through the pool's per-page
scales and the append quantizes the rows into the pool
(``paged_kv_cache.append_n``). It reads the model's own parameter
tensors, nothing copied; under ``MegaConfig(wq8=True)`` it reads int8
weights instead (:class:`Q8Params`, from ``quantized_params()`` or
``quantized_init()``).

A Qwen3-MoE model decodes through the MoE graph (router, one task per
local expert, the combine; ``_dims`` sets ``f_loc`` to one expert's full
width). At tp=1 it reads its own tensors (the router ``[L, d, E]`` and
the experts ``[L, E, d, 2f]``, ``[L, E, f, d]``: the JAX ``MoEMegaParams``
at tp=1, with no reshard and no copy). At tp=n it reads the experts
expert-parallel (:meth:`MegaQwen3.moe_params`, the JAX
``_moe_reshard_shard``): rank g holds experts ``[g·E/n, (g+1)·E/n)`` at
full width, and the combine's A2A_SEND/A2A_WAIT (or ALLREDUCE) sums the
ranks' partials. Refused with ``NotImplementedError``, for MoE, as in the
JAX package: ``wq8`` and the prefill megakernel.

At tp=n > 1 (a model over n co-located ranks) a launch covers every
rank: each rank's weight shards (``model.rank_params``, or its EP experts)
and pool or cache shard (``cache.rank(r)``), its own ``knew``/``vnew``
appended to its own shard after the launch, logits ``[B, n·v_loc]`` (each
rank its columns, the pad sliced off), the trace ring ``[tp, NS, T, 8]``;
``build_multi``'s ``straggler_rank`` lags one rank's exchanges.
:meth:`MegaQwen3.prefill` runs the prefill megakernel over every rank
(each rank's K/V rows into its own dense cache shard). Refused at tp > 1,
naming ROADMAP queue 1 position 4 (:meth:`MegaQwen3.check_tp`,
``code_generator.check_dims``): ``MegaConfig(wq8=True)``, the int8 pool
and sampling.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_distributed_tpu_torch.megakernel.code_generator import (
    MegaConfig,
    MegaDims,
    MegaWeights,
)
from triton_distributed_tpu_torch.megakernel.model_builder import ModelBuilder
from triton_distributed_tpu_torch.megakernel.scheduler import SchedulePolicy
from triton_distributed_tpu_torch.models.kv_cache import KVCache
from triton_distributed_tpu_torch.models.paged_kv_cache import (
    _INV_Q_MAX,
    _Q_MAX,
    PagedKVCache,
    append_n,
)
from triton_distributed_tpu_torch.models.qwen import pad_vocab


@dataclasses.dataclass
class Q8Params:
    """Weight-only int8 megakernel parameters (``MegaConfig.wq8``), the
    JAX ``Q8Params`` at tp=1 with its shapes. The five projection weights
    are symmetric per-OUTPUT-channel int8 codes (scale = max|w| / 127
    over the contraction axis, f32); everything else stays in the model
    dtype, ``embed`` included even when the checkpoint ties it to
    ``lm_head``: the tied tensor is then held twice, in the model dtype
    for the gather and in int8 for the head. ``MegaWeights.from_params``
    reads it as the JAX ``_kernel_args_q8`` does."""

    embed: torch.Tensor    # [V, d] model dtype
    wqkv: torch.Tensor     # [L, d, qkv] int8
    wo: torch.Tensor       # [L, hq*hd, d] int8
    w1: torch.Tensor       # [L, d, 2f] int8
    w2: torch.Tensor       # [L, f, d] int8
    lm_head: torch.Tensor  # [d, v_pad] int8
    sc_qkv: torch.Tensor   # [L, 1, qkv] f32
    sc_o: torch.Tensor     # [L, 1, d] f32
    sc_w1: torch.Tensor    # [L, 1, 2f] f32
    sc_w2: torch.Tensor    # [L, 1, d] f32
    sc_lm: torch.Tensor    # [1, v_pad] f32
    ln1: torch.Tensor
    ln2: torch.Tensor
    norm: torch.Tensor
    qn: torch.Tensor
    kn: torch.Tensor


def _quantize_shard(params: dict) -> Q8Params:
    """The JAX ``_quantize_shard`` at tp=1 (one shard): each projection
    weight quantized per output column. The scale is ``max|w| * (1/127)``
    floored at 1e-12: the JAX package computes ``max|w| / 127`` under
    ``jax.jit``, which XLA compiles to that product, so the codes and
    scales match its ``quantized_params()`` bit for bit."""
    lp = params["layers"]

    def q(w, dim):
        wf = w.to(torch.float32)
        s = torch.amax(wf.abs(), dim=dim, keepdim=True) * _INV_Q_MAX
        s = torch.clamp(s, min=1e-12)
        wi = torch.clamp(torch.round(wf / s), -_Q_MAX, _Q_MAX)
        return wi.to(torch.int8), s

    wqkv8, sq = q(lp["attn"]["wqkv"], 1)
    wo8, so = q(lp["attn"]["wo"], 1)
    w18, s1 = q(lp["mlp"]["w1"], 1)
    w28, s2 = q(lp["mlp"]["w2"], 1)
    lm8, slm = q(params["lm_head"], 0)
    return Q8Params(
        embed=params["embed"], wqkv=wqkv8, wo=wo8, w1=w18, w2=w28,
        lm_head=lm8, sc_qkv=sq, sc_o=so, sc_w1=s1, sc_w2=s2, sc_lm=slm,
        ln1=lp["ln1"], ln2=lp["ln2"], norm=params["norm"],
        qn=lp["attn"]["q_norm"], kn=lp["attn"]["k_norm"],
    )


def moe_reshard(shards: list[dict], num_experts: int) -> list[dict]:
    """The tensor-parallel MoE shards (each rank's ``w1 [L, E, d,
    2·f_loc]`` as ``[gate_r | up_r]`` and ``w2 [L, E, f_loc, d]``) as
    expert-parallel ones: rank g's experts ``[g·E/n, (g+1)·E/n)`` at full
    width, ``w1 [L, E/n, d, 2f]`` = ``[gate_0 .. gate_{n-1} | up_0 ..
    up_{n-1}]`` and ``w2 [L, E/n, f, d]`` = the row shards in rank order
    (the JAX ``_moe_reshard_shard``: its all-to-all, then the
    ``[gate_full | up_full]`` reorder). Every other leaf is the rank's
    own tensor. The expert tensors are allocated at their final size and
    filled layer by layer."""
    n = len(shards)
    if num_experts % n:
        raise ValueError(f"num_experts {num_experts} not divisible by "
                         f"tp={n} (the megakernel EP-shards the expert axis)")
    L, E, d, two_fl = shards[0]["layers"]["mlp"]["w1"].shape
    fl, epr = two_fl // 2, E // n
    f = n * fl
    out = []
    for g in range(n):
        mlp = shards[g]["layers"]["mlp"]
        ref = mlp["w1"]
        w1 = torch.empty((L, epr, d, 2 * f), dtype=ref.dtype,
                         device=ref.device)
        w2 = torch.empty((L, epr, f, d), dtype=ref.dtype, device=ref.device)
        ex = slice(g * epr, (g + 1) * epr)
        for l in range(L):
            for s, src in enumerate(shards):
                sw1 = src["layers"]["mlp"]["w1"][l, ex]
                w1[l, :, :, s * fl:(s + 1) * fl] = sw1[..., :fl]
                w1[l, :, :, f + s * fl:f + (s + 1) * fl] = sw1[..., fl:]
                w2[l, :, s * fl:(s + 1) * fl] = \
                    src["layers"]["mlp"]["w2"][l, ex]
        layers = dict(shards[g]["layers"])
        layers["mlp"] = {"w_router": mlp["w_router"], "w1": w1, "w2": w2}
        out.append({**shards[g], "layers": layers})
    return out


class MegaQwen3:
    """Megakernel decode wrapper around a loaded :class:`Qwen3`."""

    def __init__(self, model, *, cfg: MegaConfig | None = None,
                 policy: SchedulePolicy = SchedulePolicy.ROUND_ROBIN):
        self.cfg = cfg or MegaConfig()
        self.check_tp(model, self.cfg)
        if model.params is None and not self.cfg.wq8:
            # wq8 decode can run from Q8Params alone (quantized_init);
            # every other path needs the model's parameters.
            raise ValueError("load or init Qwen3 params first")
        self.model = model
        self.policy = policy
        self._jit: dict = {}
        # The scheduled task order of each multi-step build, by its key:
        # what validate_ring checks a traced launch's ring against.
        self._orders: dict = {}
        self._q8: Q8Params | None = None
        self._moe_p: list | None = None

    @staticmethod
    def check_tp(model, cfg: MegaConfig) -> None:
        """What the megakernel refuses at tp > 1, each naming its ROADMAP
        item (the engines check it when they are made)."""
        if model.tp == 1:
            return
        if cfg.wq8:
            raise NotImplementedError(
                f"MegaConfig(wq8=True) at tp={model.tp} is not ported yet "
                "(ROADMAP queue 1 position 4)")

    def _dims(self, batch: int, s_max: int, page: int = 0,
              kv_quant: bool = False, num_pages: int = 0,
              trace: bool = False) -> MegaDims:
        c = self.model.cfg
        n = self.model.tp
        # The LM head's vocab axis is padded to 128·tp (``set_params``
        # pads it, the step wrappers slice the pad logits off), taken from
        # the config so that a model without parameters (quantized_init)
        # builds too; each rank holds v_pad / tp columns. MoE streams
        # whole experts: f_loc is one expert's FFN width.
        return MegaDims(
            batch=batch, d=c.hidden_size, hq_loc=c.num_q_heads // n,
            hkv_loc=c.num_kv_heads // n, head_dim=c.head_dim,
            f_loc=(c.moe_intermediate_size if c.num_experts
                   else c.intermediate_size // n),
            v_loc=pad_vocab(c.vocab_size, n) // n,
            num_layers=c.num_layers, s_max=s_max, n_ranks=n,
            rms_eps=c.rms_eps, rope_theta=c.rope_theta, page=page,
            kv_quant=kv_quant, num_pages=num_pages, trace=trace,
            num_experts=c.num_experts, moe_top_k=c.num_experts_per_tok,
            norm_topk=c.norm_topk_prob,
        )

    def _compile(self, dims: MegaDims):
        mb = ModelBuilder(dims, cfg=self.cfg, device=self.model.device,
                          ctx=self.model.ctx)
        if dims.prefill:
            mb.build_prefill_graph()
        else:
            mb.build_decoder_graph()
        return mb.compile(self.policy)

    def _step_params(self):
        """What the built steps take as their first argument: the int8
        :class:`Q8Params` under ``wq8``, an MoE model's expert-parallel
        shards at tp > 1 (:meth:`moe_params`), the model's params
        otherwise."""
        if self.cfg.wq8:
            return self.quantized_params()
        if self.model.cfg.num_experts and self.model.tp > 1:
            return self.moe_params()
        return self.model.params

    def moe_params(self) -> list[dict]:
        """The per-rank parameter dicts an MoE decode at tp=n > 1 takes in
        place of ``model.params``: every leaf the rank's own, except the
        experts, resharded from tensor- to expert-parallel (the JAX
        ``moe_params``/``_moe_reshard_shard``). Rank g gets experts
        ``[g·E/n, (g+1)·E/n)`` at full width: ``w1 [L, E/n, d, 2f]`` as
        ``[gate | up]``, each half the ranks' column shards in rank order,
        and ``w2 [L, E/n, f, d]``, the ranks' row shards in rank order.
        Made once, layer by layer into tensors allocated at their final
        size (never a full ``[L, E, d, 2f]`` gather), and cached on this
        instance and on the model for its current parameters, so that
        every engine and wrapper of one model shares one copy (at
        Qwen3-30B-A3B a copy is 1.2 GB a layer); the tensor-parallel
        layout stays in the model, whose prefill reads it."""
        if self._moe_p is None:
            m = self.model
            if m.params is None:
                raise ValueError("load or init the MoE model first")
            cached = getattr(m, "_moe_ep", None)
            if cached is None or cached[0] is not m.params:
                m._moe_ep = (m.params, moe_reshard(m.rank_params,
                                                   m.cfg.num_experts))
            self._moe_p = m._moe_ep[1]
        return self._moe_p

    @staticmethod
    def _scale_args(cache: PagedKVCache, kv_quant: bool) -> dict:
        """The scale operands of a quantized pool's launch: the pool's
        ``[L, P, Hkv]`` planes as they are (a CUDA thread indexes any
        layer and page; the TPU kernel's ``[L, P, 1, H]`` reshape is not
        needed)."""
        if not kv_quant:
            return {}
        return {"k_scale": cache.k_scale, "v_scale": cache.v_scale}

    def quantized_params(self) -> Q8Params:
        """The int8 weights ``wq8`` steps take in place of
        ``model.params``: quantized once from the model's parameters and
        cached on this instance."""
        if self._q8 is None:
            if self.model.tp > 1:
                raise NotImplementedError(
                    f"int8 weights at tp={self.model.tp} are not ported yet "
                    "(ROADMAP queue 1 position 4)")
            if self.model.cfg.num_experts:
                raise NotImplementedError(
                    "wq8 does not compose with MoE decode yet (per-expert "
                    "per-channel scale planes)")
            if self.model.params is None:
                raise ValueError(
                    "no parameters to quantize: load or init the model "
                    "first, or make int8 weights with quantized_init()")
            self._q8 = _quantize_shard(self.model.params)
        return self._q8

    def quantized_init(self, generator: torch.Generator) -> Q8Params:
        """Synthetic int8 parameters made on the model's device without
        ever making the full-precision weights: uniform int8 codes in
        [-127, 127] from ``generator``, every scale 0.02/127, the embed
        ~N(0, 0.02²) in the model dtype, the norms 1. The logits carry no
        knowledge; the shapes, byte streams and dequantization are the
        real ones. Requires ``MegaConfig(wq8=True)``; fills the cache
        :meth:`quantized_params` reads."""
        if not self.cfg.wq8:
            raise ValueError("quantized_init requires MegaConfig(wq8=True)")
        c = self.model.cfg
        dev, dt = self.model.device, c.dtype
        hd, d, L, f = c.head_dim, c.hidden_size, c.num_layers, \
            c.intermediate_size
        qkv = (c.num_q_heads + 2 * c.num_kv_heads) * hd
        v_pad = pad_vocab(c.vocab_size)

        def w8(*shape):
            return torch.randint(-127, 128, shape, generator=generator,
                                 device=dev, dtype=torch.int8)

        def sc(*shape):
            return torch.full(shape, 0.02 / 127.0, dtype=torch.float32,
                              device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        embed = torch.randn((c.vocab_size, d), generator=generator,
                            device=dev, dtype=torch.float32) * 0.02
        self._q8 = Q8Params(
            embed=embed.to(dt), wqkv=w8(L, d, qkv),
            wo=w8(L, c.num_q_heads * hd, d), w1=w8(L, d, 2 * f),
            w2=w8(L, f, d), lm_head=w8(d, v_pad),
            sc_qkv=sc(L, 1, qkv), sc_o=sc(L, 1, d), sc_w1=sc(L, 1, 2 * f),
            sc_w2=sc(L, 1, d), sc_lm=sc(1, v_pad),
            ln1=ones(L, d), ln2=ones(L, d), norm=ones(d), qn=ones(L, hd),
            kn=ones(L, hd),
        )
        return self._q8

    # -- single step ------------------------------------------------------
    def build(self, batch: int, s_max: int, page: int = 0,
              kv_quant: bool = False, num_pages: int = 0,
              trace: bool = False):
        """Build and schedule the task graph; returns ``(compiled, step,
        f)`` with ``f(params, tokens, cache) → (logits [B, V], cache)``
        (``step`` is the same function: PyTorch has nothing to jit);
        ``trace`` appends the trace ring ``[1, 1, T, 8]``."""
        dims = self._dims(batch, s_max, page, kv_quant, num_pages, trace)
        compiled = self._compile(dims)
        run = compiled.run
        V = self.model.cfg.vocab_size

        def f(params, tokens, cache):
            tokens = _tokens(tokens, self.model.device)
            w = _weights(params)
            kc, vc = _kv_operands(cache, page)
            if page:
                outs = run(w, kc, vc, cache.page_table, cache.kv_len, tokens,
                           **self._scale_args(cache, kv_quant))
                cache = _paged_append(cache, outs[1], outs[2])
            else:
                outs = run(w, kc, vc, None, cache.kv_len, tokens)
                cache = _dense_append(cache, outs[1], outs[2])
            # Drop the vocab-pad logits (zero columns score 0).
            if trace:  # the ring on a tp leading axis, as the JAX step's
                return outs[0][:, :V], cache, _ranked(outs[5])
            return outs[0][:, :V], cache

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
            page = cache.page_size
            s_max = int(cache.page_table.shape[1]) * page
            step = self._built(b, s_max, page, cache.quantized,
                               cache.num_pages)[1]
        else:
            step = self._built(b, int(cache.k.shape[-2]))[1]
        return step(self._step_params(), tokens, cache)

    def decode_fn(self, batch: int, s_max: int, page: int = 0,
                  kv_quant: bool = False, num_pages: int = 0,
                  trace: bool = False):
        """The step ``f(params, tokens, cache) → (logits, cache)``, the
        contract of ``Qwen3.decode_fn``."""
        return self._built(batch, s_max, page, kv_quant, num_pages,
                           trace)[2]

    # -- multi-step decode -------------------------------------------
    def build_multi(self, batch: int, s_max: int, nsteps: int,
                    sampled: bool = False, page: int = 0,
                    straggler_rank: int | None = None,
                    kv_quant: bool = False, num_pages: int = 0,
                    valid_arg: bool = False, trace: bool = False,
                    filtered: bool = False, eos: bool = False,
                    ring: bool = False):
        """``nsteps`` decode steps in ONE kernel launch: ``f(params,
        tokens, cache[, n_valid][, stop_tok, halt][, ring_state][, noise]
        [, sampcfg]) → (toks [nsteps, B], last-step logits [B, V], cache
        advanced nsteps[, stop_step [B], halt [B]][, ring [1, NS, T,
        8]])``, the JAX argument and return order.

        Caller contract: ``kv_len[b] + nsteps <= s_max`` for every row.
        ``valid_arg`` (paged only) adds the kept-row counts ``n_valid
        [B]``: rows at or past them go to the trash page. ``eos`` (needs
        ``valid_arg``) adds ``stop_tok [B]`` (-1 = none) and ``halt
        [B]``: the kernel stamps each row's first step whose token is its
        stop token (``nsteps`` = never) and the append keeps ``min(n_valid,
        stop_step + 1) * (1 - halt)`` rows. ``sampled`` adds ``noise
        [nsteps, B, V_pad]`` f32, already ``T_b · gumbel`` per row (a zero
        row decodes greedily), and the in-kernel argmax runs over ``logits
        + noise``: temperature sampling by the Gumbel-max trick, the
        returned logits clean. ``filtered`` (needs ``sampled``) adds
        ``sampcfg [B, 4]`` f32 rows ``[1/T, top-k window, top-p, enable]``
        and the winner is taken over each row's exact top-k/top-p
        keep-set. ``ring`` (paged only) adds the work-ring snapshot
        ``ring_state [4]`` int32 (``WorkRing.publish``), whose doorbell
        the graph's leading RING_POLL task stamps into its trace record;
        ``trace`` appends the trace ring, one ``[task_id, opcode, layer,
        arg0, begin, end, mid, flag]`` record per (step, task), on a
        tp-leading axis (``multi_task_order`` gives the scheduled order
        it is validated against)."""
        if (eos or ring) and not page:
            raise ValueError("eos/ring modes ride the paged serving path "
                             "only")
        if eos and not valid_arg:
            raise ValueError("eos needs valid_arg: device retire clamps "
                             "the per-slot kept-row counts")
        if valid_arg and not page:
            raise ValueError("valid_arg rides the paged append only")
        V = self.model.cfg.vocab_size
        base = self._dims(batch, s_max, page, kv_quant, num_pages, trace)
        dims = dataclasses.replace(base, nsteps=nsteps, v_real=V, eos=eos,
                                   sampled=sampled, filtered=filtered,
                                   ring=ring, straggler_rank=straggler_rank)
        compiled = self._compile(dims)
        run = compiled.run
        self._last_multi_order = compiled.order
        dev = self.model.device

        def f(params, tokens, cache, *extra):
            # No host sync on this path (the resident engine issues
            # launches through it with the previous one in flight):
            # operands arrive on the device or are copied there.
            tokens = _tokens(tokens, dev)
            w = _weights(params)
            kc, vc = _kv_operands(cache, page)
            ex = list(extra)
            n_valid = _ints(ex.pop(0), dev) if valid_arg else None
            stop_tok = _ints(ex.pop(0), dev) if eos else None
            halt = _ints(ex.pop(0), dev) if eos else None
            ring_state = _ints(ex.pop(0), dev) if ring else None
            samp = {"noise": ex.pop(0) if sampled else None,
                    "sampcfg": ex.pop(0) if filtered else None}
            if page:
                outs = run(
                    w, kc, vc, cache.page_table, cache.kv_len, tokens,
                    stop_tok, **self._scale_args(cache, kv_quant), **samp,
                    ring_state=ring_state)
                logits, knew, vnew, toks, ss = outs[:5]
                if eos:
                    keep = torch.minimum(n_valid, ss + 1) * (1 - halt)
                    halt_out = torch.maximum(
                        halt, (ss < nsteps).to(torch.int32))
                    ret = (toks, logits[:, :V],
                           _paged_append(cache, knew, vnew, keep), ss,
                           halt_out)
                else:
                    ret = (toks, logits[:, :V],
                           _paged_append(cache, knew, vnew, n_valid))
            else:
                outs = run(w, kc, vc, None, cache.kv_len, tokens, **samp)
                logits, knew, vnew, toks = outs[:4]
                ret = (toks, logits[:, :V],
                       _dense_append(cache, knew, vnew))
            if trace:  # the ring on a tp leading axis, as the JAX step's
                ret += (_ranked(outs[5]),)
            return ret

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
            self._orders[key] = self._last_multi_order
        return self._jit[key]

    def multi_task_order(self, *args, **kw):
        """The scheduled task order of a multi-step build (the arguments of
        :meth:`decode_multi_fn`; built on first use): ``validate_ring``
        checks every dependency edge of it against a traced ring."""
        self.decode_multi_fn(*args, **kw)
        return self._orders[self._multi_key(*args, **kw)]

    # -- prefill ----------------------------------------------------------
    def _build_prefill(self, s: int):
        """The prefill megakernel for an S-token prompt: ``f(params,
        tokens [S], true_len [1] int32, cache) → (logits [V] of row
        true_len - 1, cache)``. The embedding gather runs in PyTorch
        (the JAX package gathers outside the kernel too); the kernel's
        K/V rows ``[L, hkv, S, hd]`` land in dense cache entry 0 at
        positions ``[0, S)`` (in place; at tp > 1 each rank's rows in its
        own shard, ``cache.rank(r)``) and ``kv_len[0] = true_len``."""
        dims = dataclasses.replace(self._dims(s, s), prefill=True)
        run = self._compile(dims).run
        V = self.model.cfg.vocab_size

        def f(params, tokens, true_len, cache):
            w = _weights(params)
            emb = (w[0] if isinstance(w, list) else w).embed
            x0 = emb.index_select(0, tokens.long())  # [S, d]
            logits, knew, vnew = run.prefill(w, x0, true_len)
            if cache.tp == 1:
                knew, vnew = knew[None], vnew[None]
            for r in range(cache.tp):
                shard = cache.rank(r)
                shard.k[:, 0, :, :s] = knew[r].to(shard.k.dtype)
                shard.v[:, 0, :, :s] = vnew[r].to(shard.v.dtype)
            kv_len = cache.kv_len.clone()
            kv_len[0] = true_len[0]
            return logits[0, :V], KVCache(k=cache.k, v=cache.v,
                                          kv_len=kv_len)

        return f

    def prefill(self, tokens, cache: KVCache, *, true_len=None):
        """Prefill one prompt (``tokens [S]``) through the prefill
        megakernel into dense cache entry 0: returns ``(logits [V] f32
        of the last real token, cache)``, the contract of the JAX
        ``MegaQwen3.prefill`` (at tp > 1 the logits are the ranks' vocab
        columns joined). ``true_len`` (default S) marks right padding;
        under ``wq8`` the kernel reads the int8 weights."""
        dev = self.model.device
        tokens = torch.as_tensor(tokens).to(dev, torch.int32)
        s = int(tokens.shape[0])
        if true_len is None:
            true_len = s
        if not 1 <= int(true_len) <= s:
            raise ValueError(f"true_len {true_len} outside [1, {s}]")
        if int(cache.k.shape[-2]) < s:
            raise ValueError(f"the cache holds {cache.k.shape[-2]} "
                             f"positions, the prompt {s}")
        key = ("prefill", s)
        if key not in self._jit:
            self._jit[key] = self._build_prefill(s)
        return self._jit[key](
            self._step_params(), tokens,
            torch.tensor([int(true_len)], dtype=torch.int32, device=dev),
            cache)


def _ints(a, dev) -> torch.Tensor:
    """``a`` as a contiguous int32 tensor on ``dev`` whose storage starts
    16-byte aligned, as every kernel operand must (a row of a launch's
    token output is a view at an offset: it is copied)."""
    t = torch.as_tensor(a).to(dev, torch.int32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


_tokens = _ints


def _weights(params):
    """The launch's :class:`MegaWeights`: one, or a list of one a rank
    (``params`` is then the model's per-rank dicts)."""
    if isinstance(params, (list, tuple)):
        return [MegaWeights.from_params(p) for p in params]
    return MegaWeights.from_params(params)


def _kv_operands(cache, page: int):
    """The launch's cache operands ``(kc, vc)``: the pool (``page``) or the
    dense cache, as per-rank lists of ``cache.rank(r)``'s tensors at
    tp > 1."""
    ranks = [cache.rank(r) for r in range(cache.tp)]
    if page:
        kc, vc = [c.k_pages for c in ranks], [c.v_pages for c in ranks]
    else:
        kc, vc = [c.k for c in ranks], [c.v for c in ranks]
    return (kc[0], vc[0]) if cache.tp == 1 else (kc, vc)


def _ranked(ring: torch.Tensor) -> torch.Tensor:
    """A launch's trace ring on a tp leading axis, as the JAX step's."""
    return ring[None] if ring.dim() == 3 else ring


def _paged_append(cache: PagedKVCache, knew: torch.Tensor,
                  vnew: torch.Tensor, n_valid=None) -> PagedKVCache:
    """Append a launch's rows ``[NS, L, B, hkv, hd]`` (``[n, NS, ...]`` at
    tp=n: each rank's into its own pool shard) with
    :func:`append_n`, rows ``>= n_valid`` to the trash page; returns the
    cache with ``kv_len + NS``."""
    if cache.tp == 1:
        # [NS, L, B, hkv, hd] → [L, B, hkv, NS, hd]: one scatter lands
        # every step's rows (an int8 pool takes them step by step,
        # quantizing, in append_n).
        return append_n(cache, knew.permute(1, 2, 3, 0, 4),
                        vnew.permute(1, 2, 3, 0, 4), n_valid)
    for r in range(cache.tp):
        append_n(cache.rank(r), knew[r].permute(1, 2, 3, 0, 4),
                 vnew[r].permute(1, 2, 3, 0, 4), n_valid)
    return dataclasses.replace(cache, kv_len=cache.kv_len + knew.shape[1])


def _dense_append(cache: KVCache, knew: torch.Tensor,
                  vnew: torch.Tensor) -> KVCache:
    """Write the launch's rows ``[NS, L, B, hkv, hd]`` (``[n, NS, ...]`` at
    tp=n, each rank's into its own shard) at each row's ``kv_len ..
    kv_len + NS - 1`` (in place; positions clamp at the cache end, which
    the caller's capacity contract never reaches) and return the cache
    with ``kv_len + NS``."""
    if cache.tp > 1:
        for r in range(cache.tp):
            _dense_append(cache.rank(r), knew[r], vnew[r])
        return KVCache(k=cache.k, v=cache.v,
                       kv_len=cache.kv_len + knew.shape[1])
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
