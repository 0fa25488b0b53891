"""The port's MoE megakernel at tp > 1, and its prefill megakernel at tp > 1,
against the JAX package, on the CPU.

At tp=n the MoE megakernel lays the experts out expert-parallel (rank g
runs experts ``[g·E/n, (g+1)·E/n)`` at full width, resharded from the
model's tensor-parallel layout by ``MegaQwen3.moe_params``) and sums the
ranks' combine partials through ALLREDUCE or, under ``overlap_ar``, the
A2A_SEND/A2A_WAIT pair. On the CPU it runs its plain version
(``kernels.mega_decode_plain_tp``: the n rank states walked in lockstep),
the function the CUDA kernel is held against on the card
(``tests/test_torch_cuda.py -k mega_moe_tp``). Here, on the f32
``tiny-moe`` preset (8 experts, top-2) at tp=2 and tp=4 (4 and 2 local
experts a rank), weights carried from a JAX model of the same tp by
``params_from_jax(tree, tp=n)``:

- ``moe_params()`` equals the JAX ``MegaQwen3.moe_params()`` (its
  ``shard_map`` all-to-all on the CPU mesh) bit for bit on every rank;
- the MoE tp graph's packed tables equal the JAX ``ModelBuilder``'s for
  every fused-norms x overlap_ar x {NS 1; NS 8 with ring, trace, eos};
- the plain EP walk against the JAX ``xla`` decode at the same tp (with
  and without overlap_ar): one step's logits within 1e-4 (f32 on both
  sides: only summation order differs), an NS = 4 launch's tokens equal,
  every rank's tokens and final residual bitwise equal, and one rank's
  phase-0 partial dropped at one layer moves the logits by more than
  100x that tolerance;
- ``ContinuousEngine(mode="mega")`` (prefix cache, ns 4, eos; resident and
  traced, with one A2A window per layer and step on each rank's ring) and
  ``Engine(mode="mega")`` (dense and paged) emit the JAX ``xla`` engines'
  greedy tokens, with the JAX engines' MoE ledger;
- ``MegaQwen3.prefill`` of the dense ``tiny`` preset at the same tp against
  JAX ``Qwen3.prefill(..., "xla", true_len=13)``: logits and the real K/V
  rows within 1e-4, ``kv_len`` equal.

The JAX oracles run under ``portable_export()`` (the JAX plain
references).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import MegaConfig as JaxMegaConfig
from triton_distributed_tpu.megakernel import MegaQwen3 as JaxMegaQwen3
from triton_distributed_tpu.megakernel.code_generator import (
    MegaDims as JaxMegaDims,
)
from triton_distributed_tpu.megakernel.model_builder import (
    ModelBuilder as JaxModelBuilder,
)
from triton_distributed_tpu.megakernel.scheduler import schedule as jax_schedule
from triton_distributed_tpu.megakernel.task import pack_table as jax_pack
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import (
    MegaConfig,
    MegaDims,
    MegaQwen3,
    ModelBuilder,
    TaskType,
    pack_table,
    schedule,
)
from triton_distributed_tpu_torch.megakernel.kernels import (
    mega_decode_plain_tp,
)
from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    KVCache,
    PrefixCache,
    Qwen3,
    Qwen3MoE,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.obs import kernel_trace as kt

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-4
PAGE, MAXLEN, GEN, NS = 16, 64, 6, 4
SERVING = dict(fuse_norms=True, cross_prefetch=True, overlap_ar=True)
MOE_KEYS = ("moe_routed_tokens", "a2a_dropped", "num_experts",
            "experts_per_tok")

_rng = np.random.default_rng(37)
_PREFIX = _rng.integers(0, 256, 18)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, k)]).astype(
    np.int32) for k in (6, 13, 2)]
IDS = np.stack([PROMPTS[0][:20], PROMPTS[1][:20]])


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def moe_models(request):
    """The JAX tiny-moe and tiny models at tp=n (f32) and the port's from
    their weights, with the JAX ``xla`` engines' greedy tokens and MoE
    ledgers: ``ContinuousEngine`` with the prefix cache and an eos id that
    fires inside request 0 (the port's own xla run picks it), and the
    dense ``Engine``."""
    n = request.param
    ctx = mesh_mod.initialize_distributed(tp=n, devices=jax.devices()[:n])
    jm = JaxAutoLLM.from_pretrained("tiny-moe", ctx=ctx, seed=0)
    tm = Qwen3MoE(get_config("tiny-moe"), device="cpu", tp=n)
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params),
                                  tp=n))
    jd = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    td = Qwen3(get_config("tiny"), device="cpu", tp=n)
    td.set_params(params_from_jax(jax.tree.map(np.asarray, jd.params),
                                  tp=n))
    plain = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, device="cpu").run(
        [(p, GEN) for p in PROMPTS])
    eos = int(plain[0][2])
    with portable_export():
        cont = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, mode="xla",
                             prefix_cache=True, eos_id=eos)
        gold_cont = [np.asarray(o).tolist()
                     for o in cont.run([(p, GEN) for p in PROMPTS])]
        stats_cont = {k: cont.last_stats[k] for k in MOE_KEYS}
        eng = JaxEngine(jm, mode="xla")
        gold_eng = np.asarray(eng.serve(IDS, GEN,
                                        max_length=MAXLEN)).tolist()
        stats_eng = {k: eng.last_stats[k] for k in MOE_KEYS}
    assert len(gold_cont[0]) == 3  # the eos fired
    yield dict(n=n, jm=jm, tm=tm, jd=jd, td=td, eos=eos,
               gold_cont=(gold_cont, stats_cont),
               gold_eng=(gold_eng, stats_eng))
    mesh_mod.finalize_distributed()


# -- the TP -> EP reshard ----------------------------------------------------

def test_moe_params_equal_the_jax_reshard(moe_models):
    """Rank g's experts g·E/n .. at full width, w1 as [gate | up] with the
    ranks' column shards in rank order, w2's rows in rank order: the JAX
    ``moe_params()`` (all-to-all + reorder under ``shard_map``) bit for
    bit; every other leaf is the rank's own tensor."""
    n, jm, tm = moe_models["n"], moe_models["jm"], moe_models["tm"]
    got = MegaQwen3(tm).moe_params()
    with portable_export():
        want = JaxMegaQwen3(jm).moe_params()
    w1, w2 = np.asarray(want.w1), np.asarray(want.w2)
    E = tm.cfg.num_experts
    epr = E // n
    assert len(got) == n
    for g, p in enumerate(got):
        mlp = p["layers"]["mlp"]
        assert tuple(mlp["w1"].shape) == (tm.cfg.num_layers, epr,
                                          tm.cfg.hidden_size,
                                          2 * tm.cfg.moe_intermediate_size)
        np.testing.assert_array_equal(mlp["w1"].numpy(),
                                      w1[:, g * epr:(g + 1) * epr])
        np.testing.assert_array_equal(mlp["w2"].numpy(),
                                      w2[:, g * epr:(g + 1) * epr])
        assert mlp["w_router"] is tm.params[g]["layers"]["mlp"]["w_router"]
        assert p["lm_head"] is tm.params[g]["lm_head"]
    assert MegaQwen3(tm)._step_params()[0]["layers"]["mlp"]["w1"].shape[1] \
        == epr


# -- task graph ---------------------------------------------------------------

_DIMS = dict(batch=2, d=64, hq_loc=4, hkv_loc=2, head_dim=32, f_loc=64,
             v_loc=128, num_layers=3, s_max=64, num_experts=8, moe_top_k=2)


def test_moe_tp_task_tables_match_jax(moe_models):
    """The MoE graph at tp=n packs the JAX table for every option: the
    entry BARRIER, o-proj's exchange, MOE_GATE, E/n MOE_FFN tasks, then
    A2A_SEND phase 0 after ceil(E_loc/2) experts, phase 1 and A2A_WAIT
    (overlap_ar) or the last expert's handoff to ALLREDUCE. (The options
    loop here: pytest parameters would make it reorder the module's tests
    across the fixture's instances.)"""
    n, jm = moe_models["n"], moe_models["jm"]
    el = _DIMS["num_experts"] // n
    for fuse_norms, overlap, ns, eos, ring, trace in (
            (f, o, *rest) for f in (False, True) for o in (False, True)
            for rest in ((1, False, False, False), (8, True, True, True))):
        kw = dict(_DIMS, n_ranks=n, nsteps=ns, v_real=200, page=16,
                  num_pages=9, eos=eos, ring=ring, trace=trace)
        jb = JaxModelBuilder(JaxMegaDims(**kw), cfg=JaxMegaConfig(
            fuse_norms=fuse_norms, overlap_ar=overlap), ctx=jm.ctx)
        jb.build_decoder_graph()
        tb = ModelBuilder(MegaDims(**kw), cfg=MegaConfig(
            fuse_norms=fuse_norms, overlap_ar=overlap))
        tb.build_decoder_graph()
        got = pack_table(schedule(tb.tasks), trace=trace)
        np.testing.assert_array_equal(
            got, jax_pack(jax_schedule(jb.tasks), trace=trace))
        types = [TaskType(int(t)) for t in got[:, 0]]
        L = _DIMS["num_layers"]
        assert types[int(ring)] == TaskType.BARRIER
        assert types.count(TaskType.MOE_FFN) == L * el
        if overlap:
            assert types.count(TaskType.A2A_SEND) == 2 * L
            assert types.count(TaskType.A2A_WAIT) == L
            first = types.index(TaskType.A2A_SEND)
            assert types[first - (el + 1) // 2:first] == \
                [TaskType.MOE_FFN] * ((el + 1) // 2)
        else:
            assert TaskType.A2A_SEND not in types
            ffn = [i for i, t in enumerate(got) if t[0] == TaskType.MOE_FFN]
            assert [int(got[i, 3]) for i in ffn] == [0] * (el - 1) + [1] \
                + ([0] * (el - 1) + [1]) * (L - 1)


# -- the plain EP megakernel against the JAX xla decode -----------------------

def _warm(jm, tm, b: int):
    """A dense cache after one JAX xla step, in both packages (the port's
    ``[n, L, B, hkv_loc, S, hd]``: the JAX cache's kv heads split in n
    contiguous parts)."""
    n = tm.tp
    jc = jm.new_cache(b, max_length=MAXLEN)
    with portable_export():
        _, jc = jm.decode_fn("xla")(jm.params,
                                    jnp.asarray([3, 5, 7, 9][:b], jnp.int32),
                                    jc)
    leaves = jax.tree.map(np.array, jc)

    def port():
        def split(a):
            return torch.from_numpy(np.stack(np.split(a, n, axis=2)).copy())

        return KVCache(k=split(leaves.k), v=split(leaves.v),
                       kv_len=torch.from_numpy(leaves.kv_len.copy()))

    return jc, port


def test_moe_tp_plain_megakernel_matches_jax_xla(moe_models):
    """One step's logits and an NS = 4 launch's tokens against the JAX xla
    decode at the same tp, with and without overlap_ar; every rank's
    tokens and final residual bitwise equal; rank 1's phase-0 combine
    partial dropped at layer 1 moves the logits."""
    n, jm, tm = moe_models["n"], moe_models["jm"], moe_models["tm"]
    B = 2
    jc, port = _warm(jm, tm, B)
    tok0 = jnp.asarray([19, 23], jnp.int32)
    with portable_export():
        step = jm.decode_fn("xla")
        jl, jc1 = step(jm.params, tok0, jc)
        want_toks, want_logits, c = [], None, jc
        tok = tok0
        for _ in range(NS):
            want_logits, c = step(jm.params, tok, c)
            tok = jnp.argmax(want_logits, axis=-1).astype(jnp.int32)
            want_toks.append(np.asarray(tok))
    for cfg in (MegaConfig(), MegaConfig(**SERVING)):
        mega = MegaQwen3(tm, cfg=cfg)
        logits, cache = mega.decode_step(torch.tensor([19, 23]), port())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=ATOL, rtol=0)
        assert cache.kv_len.tolist() == np.asarray(jc1.kv_len).tolist()
        toks, lg, _ = mega.decode_multi_fn(B, MAXLEN, NS)(
            mega._step_params(), torch.tensor([19, 23]), port())
        np.testing.assert_array_equal(toks.numpy(), np.stack(want_toks))
        np.testing.assert_allclose(lg.numpy(), np.asarray(want_logits),
                                   atol=ATOL, rtol=0)
    # The launch itself (overlap_ar): the ranks agree bit for bit; a
    # dropped phase-0 partial is seen.
    dims = dataclasses.replace(mega._dims(B, MAXLEN), nsteps=NS,
                               v_real=tm.cfg.vocab_size)
    table = mega._compile(dims).table
    assert TaskType.A2A_WAIT in {TaskType(int(t)) for t in table[:, 0]}
    cache = port()
    w = _weights(mega._step_params())
    args = ([c.k for c in map(cache.rank, range(n))],
            [c.v for c in map(cache.rank, range(n))], None, cache.kv_len,
            torch.tensor([19, 23], dtype=torch.int32))
    info = {}
    out = mega_decode_plain_tp(dims, True, table, w, *args, info=info)
    assert info["x"].shape == (n, B, tm.cfg.hidden_size)
    for r in range(1, n):
        assert torch.equal(info["x"][r], info["x"][0])
        assert torch.equal(info["toks"][r], info["toks"][0])
    np.testing.assert_array_equal(out[3].numpy(), np.stack(want_toks))
    dropped = mega_decode_plain_tp(dims, True, table, w, *args,
                                   drop_partial=(1, 1, 0))
    assert (dropped[0] - out[0]).abs().max().item() > 100 * ATOL


# -- the engines -------------------------------------------------------------

def _ledger_ok(tm, st, stats, outs) -> None:
    """A mega ContinuousEngine's MoE ledger: the JAX engine's expert
    counts and no drop; a launch routes NS positions of every live slot
    in lockstep (the JAX mega engine's count, not its xla engine's), so
    the routed decode positions lie between the tokens decoded and NS a
    slot of each launch (as tests/test_torch_moe.py checks at tp=1)."""
    assert {k: st[k] for k in MOE_KEYS[1:]} == {k: stats[k]
                                                 for k in MOE_KEYS[1:]}
    k = tm.cfg.num_experts_per_tok
    pos = st["moe_routed_tokens"] // k - st["prefill_tokens"]
    assert st["moe_routed_tokens"] % k == 0 and st["mega_launches"] > 0
    assert sum(map(len, outs)) - len(outs) <= pos <= (
        NS * 2 * st["mega_launches"])


def test_moe_tp_mega_engines_emit_the_jax_tokens(moe_models):
    """ContinuousEngine(mode="mega", ns=4) with the prefix cache and eos,
    then resident and traced (every launch's per-rank rings validate
    against the scheduled order and its doorbell; one A2A window per
    layer and step a rank), and Engine(mode="mega") dense and paged: the
    JAX xla engines' greedy tokens and MoE ledgers."""
    n, tm, eos = moe_models["n"], moe_models["tm"], moe_models["eos"]
    gold_cont, stats_cont = moe_models["gold_cont"]
    gold_eng, stats_eng = moe_models["gold_eng"]
    kw = dict(max_batch=2, page_size=PAGE, max_length=MAXLEN, mode="mega",
              ns=NS, device="cpu", eos_id=eos)
    reqs = [(p, GEN) for p in PROMPTS]
    eng = ContinuousEngine(tm, prefix_cache=True, **kw)
    assert [o.tolist() for o in eng.run(reqs)] == gold_cont
    _ledger_ok(tm, eng.last_stats, stats_cont, gold_cont)
    res = ContinuousEngine(tm, resident=True, kernel_trace=True, **kw)
    assert [o.tolist() for o in res.run(reqs)] == gold_cont
    st = res.last_stats
    assert st["mega_resident_rounds"] > 0 and st["mega_trace_launches"] > 0
    _ledger_ok(tm, st, stats_cont, gold_cont)
    order = res._mega_model().multi_task_order(
        2, MAXLEN, NS, page=PAGE, num_pages=res.cache.num_pages,
        valid_arg=True, trace=True, eos=True, ring=True)
    assert [t.task_type for t in order[:2]] == [TaskType.RING_POLL,
                                               TaskType.BARRIER]
    L = tm.cfg.num_layers
    for ln in res.kernel_trace_launches():
        assert ln.ring.shape[0] == n
        records = ln.get_records()
        assert kt.validate_ring(records, order, doorbell=ln.doorbell) == []
        ran = {(r.rank, r.step) for r in records}
        rep = kt.overlap_report(records)
        assert rep["a2a_windows"] == L * len(ran)  # L a (rank, step)
        assert len(ran) == n * NS
    assert res._ring.occupancy == 0
    for paged in (False, True):
        e = Engine(tm, mode="mega", paged=paged, page_size=PAGE,
                   device="cpu")
        out = e.serve(IDS, GEN, max_length=MAXLEN, ns=NS)
        assert out.tolist() == gold_eng
        assert {k: e.last_stats[k] for k in MOE_KEYS} == stats_eng


# -- MegaQwen3.prefill at tp > 1 ---------------------------------------------

def test_mega_prefill_tp_matches_jax_xla_prefill(moe_models):
    """The prefill megakernel's plain version over n ranks (each rank its
    heads and vocab columns, the ALLREDUCEs over the S rows) against the
    JAX xla prefill at the same tp: a right-padded 16-token prompt
    (true_len 13), logits and the real K/V rows within 1e-4, kv_len
    equal; the ranks end with bitwise-equal residuals."""
    n, jd, td = moe_models["n"], moe_models["jd"], moe_models["td"]
    S, true_len = 16, 13
    toks = np.arange(S) % 251 + 1
    jc = jd.new_cache(1, max_length=MAXLEN)
    with portable_export():
        jl, jc = jd.prefill(jnp.asarray(toks, jnp.int32), jc, "xla",
                            true_len=true_len)
    mega = MegaQwen3(td)
    logits, cache = mega.prefill(toks, td.new_cache(1, MAXLEN),
                                 true_len=true_len)
    assert logits.shape == (td.cfg.vocab_size,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    for name in ("k", "v"):
        want = np.stack(np.split(np.asarray(getattr(jc, name)), n, axis=2))
        np.testing.assert_allclose(
            getattr(cache, name).numpy()[..., :true_len, :],
            want[..., :true_len, :], atol=ATOL, rtol=0)
    assert cache.kv_len.tolist() == np.asarray(jc.kv_len).tolist()
    comp = mega._compile(dataclasses.replace(mega._dims(S, S),
                                             prefill=True))
    assert TaskType(int(comp.table[0, 0])) == TaskType.BARRIER
    w = _weights(td.params)
    x0 = w[0].embed.index_select(0, torch.as_tensor(toks).long())
    info = {}
    comp.run.prefill(w, x0, torch.tensor([true_len], dtype=torch.int32),
                     info=info)
    for r in range(1, n):
        assert torch.equal(info["x"][r], info["x"][0])
