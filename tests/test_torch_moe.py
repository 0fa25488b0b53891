"""The port's Qwen3-MoE serving against the JAX package, on the CPU.

The f32 ``tiny-moe`` preset (8 experts, top-2) carries one JAX model and
its port (``params_from_jax``) for the whole module:

- ``router_topk``, ``moe_sort``, ``moe_combine`` and ``grouped_ffn`` on
  seeded numpy inputs with planted router ties: expert ids and the sort
  order equal, values within 1e-6 (f32, summation order only);
- ``Qwen3MoE`` prefill and decode logits within 1e-4 of the JAX
  ``Qwen3MoE`` ``xla`` forwards (the dense model's limit);
- ``ContinuousEngine`` (f32 and int8 pools, prefix cache) and ``Engine``
  emit the JAX engines' greedy tokens on ``tests/test_moe_serving.py``'s
  prompts, with the JAX ``last_stats`` MoE ledger
  (``moe_routed_tokens``, ``num_experts``, ``experts_per_tok``,
  ``a2a_dropped``); speculative greedy emits plain greedy's tokens;
- the MoE megakernel task tables equal the JAX ``ModelBuilder``'s, int
  for int, with ``overlap_ar`` and ``fuse_norms`` on and off, NS 1 and 3;
- the megakernel's plain version (``mode="mega"`` on the CPU) emits the
  JAX ``xla`` engine's tokens, and a traced launch's ring passes
  ``validate_ring`` with ``a2a_windows == L * NS``;
- ``wq8`` with MoE and an MoE prefill graph are refused, as in JAX.

The JAX engines run under ``portable_export()`` (the JAX plain
references: interpret-mode Pallas would cost ~1 s a decode step here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel.code_generator import (
    MegaConfig as JaxMegaConfig,
)
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
from triton_distributed_tpu.ops.moe.grouped_gemm import (
    grouped_ffn as jax_grouped_ffn,
)
from triton_distributed_tpu.ops.moe import routing as jrt
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
from triton_distributed_tpu_torch.models import (
    AutoLLM,
    ContinuousEngine,
    Engine,
    PrefixCache,
    Qwen3MoE,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.obs import kernel_trace as kt
from triton_distributed_tpu_torch.ops.moe import (
    grouped_ffn,
    moe_combine,
    moe_sort,
    router_topk,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

LOGIT_ATOL = 1e-4
OP_ATOL = 1e-6
PAGE, MAXLEN = 16, 64
# tests/test_moe_serving.py's traffic.
PROMPTS = [
    np.arange(1, 13, dtype=np.int32),
    np.arange(30, 40, dtype=np.int32),
    np.arange(1, 13, dtype=np.int32),
]
GENS = [8, 6, 8]
MOE_KEYS = ("moe_routed_tokens", "num_experts", "experts_per_tok",
            "a2a_dropped")


@pytest.fixture(scope="module")
def models():
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jm = JaxAutoLLM.from_pretrained("tiny-moe", ctx=ctx, seed=0)
    tm = Qwen3MoE(get_config("tiny-moe"), device="cpu")
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params)))
    yield jm, tm
    mesh_mod.finalize_distributed()


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# -- routing and the grouped FFN ----------------------------------------------

def _moe_inputs(seed: int, t=12, d=32, e=8, f=16):
    """Seeded tokens, router and expert weights, with planted ties: rows
    0-1 route through two identical router columns (experts 2 and 5),
    row 2 through all-equal logits (a zero token)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[2] = 0.0
    wr = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    wr[:, 5] = wr[:, 2]
    x[:2] = 3.0 * wr[:, 2] / np.linalg.norm(wr[:, 2])  # 2 and 5 lead
    w1 = (rng.standard_normal((e, d, 2 * f)) * d ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return x, wr, w1, w2


@pytest.mark.parametrize("k,norm", [(2, True), (3, False)])
def test_routing_and_grouped_ffn_match_jax(k, norm):
    x, wr, w1, w2 = _moe_inputs(7)
    e = wr.shape[1]
    jr = jrt.router_topk(jnp.asarray(x), jnp.asarray(wr), k,
                         norm_topk_prob=norm)
    tr = router_topk(torch.from_numpy(x), torch.from_numpy(wr), k,
                     norm_topk_prob=norm)
    np.testing.assert_array_equal(tr.expert_ids.numpy(),
                                  np.asarray(jr.expert_ids))
    # The planted ties resolve to the lowest index on both sides.
    assert tr.expert_ids[0, :2].tolist() == [2, 5]
    assert tr.expert_ids[2].tolist() == list(range(k))
    _close(tr.weights, jr.weights, OP_ATOL)
    js = jrt.moe_sort(jr, e)
    ts = moe_sort(tr, e)
    for name in ("order", "token_ids", "expert_ids", "group_sizes"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    _close(ts.weights, js.weights, OP_ATOL)
    jh = jax_grouped_ffn(jnp.asarray(x)[js.token_ids], jnp.asarray(w1),
                         jnp.asarray(w2), js.group_sizes)
    th = grouped_ffn(torch.from_numpy(x)[ts.token_ids.long()],
                     torch.from_numpy(w1), torch.from_numpy(w2),
                     ts.group_sizes)
    _close(th, jh, OP_ATOL)
    _close(moe_combine(th, ts, x.shape[0]),
           jrt.moe_combine(jh, js, x.shape[0]), OP_ATOL)


# -- forwards ------------------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(models):
    jm, tm = models
    ids = np.stack([PROMPTS[0][:10], PROMPTS[1]])
    with portable_export():
        jl, jc = jm.prefill_batched(jnp.asarray(ids), jm.new_cache(2, MAXLEN),
                                    "xla")
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        jl2, _ = jm.decode_step(tok, jc, "xla")
    tl, tc = tm.prefill_batched(ids, tm.new_cache(2, MAXLEN), "xla")
    _close(tl, jl, LOGIT_ATOL)
    tl2, _ = tm.decode_step(torch.from_numpy(np.array(tok)), tc, "xla")
    _close(tl2, jl2, LOGIT_ATOL)


def test_auto_llm_builds_moe():
    m = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=1)
    assert isinstance(m, Qwen3MoE)
    mlp = m.params["layers"]["mlp"]
    assert tuple(mlp["w_router"].shape) == (2, 64, 8)
    assert tuple(mlp["w1"].shape) == (2, 8, 64, 128)
    assert tuple(mlp["w2"].shape) == (2, 8, 64, 64)
    assert all(t.dtype == torch.float32 for t in mlp.values())


# -- serving -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_goldens(models):
    """The JAX engines' tokens and MoE ledgers on the shared traffic: the
    continuous engine per pool dtype, the dense Engine."""
    jm, _ = models
    reqs = list(zip(PROMPTS, GENS))
    out = {}
    with portable_export():
        for kv in (None, "int8"):
            eng = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                                max_length=MAXLEN, prefix_cache=True,
                                kv_dtype=kv)
            toks = [r.tokens.tolist() for r in eng.run(reqs, results=True)]
            out[kv] = (toks, {k: eng.last_stats[k] for k in MOE_KEYS})
        eng = JaxEngine(jm)
        ids = np.stack([PROMPTS[0][:10], PROMPTS[1]])
        out["engine"] = (np.asarray(eng.serve(ids, 6, max_length=MAXLEN)),
                         {k: eng.last_stats[k] for k in MOE_KEYS})
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_continuous_greedy_matches_jax(models, jax_goldens, kv_dtype):
    _, tm = models
    want, stats = jax_goldens[kv_dtype]
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                           max_length=MAXLEN, prefix_cache=True,
                           kv_dtype=kv_dtype, device="cpu")
    res = eng.run(list(zip(PROMPTS, GENS)), results=True)
    assert [r.tokens.tolist() for r in res] == want
    assert {k: eng.last_stats[k] for k in MOE_KEYS} == stats
    assert eng.audit() == []


def test_engine_greedy_matches_jax(models, jax_goldens):
    _, tm = models
    want, stats = jax_goldens["engine"]
    eng = Engine(tm, device="cpu")
    ids = np.stack([PROMPTS[0][:10], PROMPTS[1]])
    np.testing.assert_array_equal(eng.serve(ids, 6, max_length=MAXLEN), want)
    assert {k: eng.last_stats[k] for k in MOE_KEYS} == stats


def test_speculative_greedy_equals_plain(models):
    """Speculation rides the chunk-verify path for MoE: the same tokens as
    plain greedy, with verify chunks run and routed."""
    _, tm = models
    p = np.asarray([5, 6, 7] * 5, np.int32)
    kw = dict(max_batch=2, page_size=PAGE, max_length=MAXLEN,
              prefix_cache=True, device="cpu")
    want = ContinuousEngine(tm, **kw).run([(p, 8)], results=True)[0]
    eng = ContinuousEngine(tm, speculative=2, **kw)
    got = eng.run([(p, 8)], results=True)[0]
    assert got.tokens.tolist() == want.tokens.tolist()
    st = eng.last_stats
    assert st["spec_verify_steps"] > 0
    assert st["moe_routed_tokens"] > 0
    assert st["moe_routed_tokens"] % tm.cfg.num_experts_per_tok == 0


# -- the megakernel ------------------------------------------------------------

_MOE_DIMS = dict(batch=2, d=64, hq_loc=8, hkv_loc=4, head_dim=32, f_loc=64,
                 v_loc=256, num_layers=2, s_max=64, n_ranks=1,
                 num_experts=8, moe_top_k=2)


@pytest.mark.parametrize("nsteps", [1, 3])
@pytest.mark.parametrize("overlap_ar", [False, True])
@pytest.mark.parametrize("fuse_norms", [False, True])
def test_moe_task_tables_match_jax(models, fuse_norms, overlap_ar, nsteps):
    jm, _ = models
    cfg = dict(fuse_norms=fuse_norms, overlap_ar=overlap_ar,
               cross_prefetch=overlap_ar)
    jb = JaxModelBuilder(JaxMegaDims(**_MOE_DIMS, nsteps=nsteps),
                         cfg=JaxMegaConfig(**cfg), ctx=jm.ctx)
    jb.build_decoder_graph()
    tb = ModelBuilder(MegaDims(**_MOE_DIMS, nsteps=nsteps),
                      cfg=MegaConfig(**cfg))
    tb.build_decoder_graph()
    for trace in (False, True):
        np.testing.assert_array_equal(
            pack_table(schedule(tb.tasks), trace=trace),
            jax_pack(jax_schedule(jb.tasks), trace=trace))
    ops = [t.task_type for t in tb.tasks]
    assert TaskType.FC1 not in ops and TaskType.FC2 not in ops
    assert ops.count(TaskType.MOE_FFN) == 8 * 2
    assert ops.count(TaskType.A2A_SEND) == (4 if overlap_ar else 0)
    handoffs = [t.arg1 for t in tb.tasks if t.task_type == TaskType.MOE_FFN]
    assert sum(handoffs) == (0 if overlap_ar else 2)


@pytest.mark.parametrize("overlap_ar", [False, True])
def test_mega_engine_matches_jax_xla(models, jax_goldens, overlap_ar):
    """``mode="mega"`` (the plain MoE megakernel; the serving default
    config splits the combine into A2A_SEND/A2A_WAIT, and without
    ``overlap_ar`` the last expert hands off to ALLREDUCE) emits the JAX
    ``xla`` engine's tokens, with NS = 4 launches and the tracer on."""
    _, tm = models
    want, stats = jax_goldens[None]
    cfg = MegaConfig(fuse_norms=True, cross_prefetch=overlap_ar,
                     overlap_ar=overlap_ar)
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                           max_length=MAXLEN, prefix_cache=True, mode="mega",
                           ns=4, mega_cfg=cfg, kernel_trace=True,
                           device="cpu")
    res = eng.run(list(zip(PROMPTS, GENS)), results=True)
    assert [r.tokens.tolist() for r in res] == want
    st = eng.last_stats
    assert {k: st[k] for k in MOE_KEYS[1:]} == {k: stats[k]
                                                 for k in MOE_KEYS[1:]}
    # A launch routes NS positions of every live slot in lockstep (the
    # JAX engine's count): at least the decoded positions, at most NS per
    # row of each launch.
    k = tm.cfg.num_experts_per_tok
    pos = st["moe_routed_tokens"] // k - st["prefill_tokens"]
    assert st["moe_routed_tokens"] % k == 0
    assert sum(GENS) - len(GENS) <= pos <= 4 * 2 * st["mega_launches"]
    assert st["mega_launches"] > 0
    rep = eng.kernel_trace_summary()["recent"][-1]["overlap"]
    assert (rep["a2a_windows"] > 0) == overlap_ar


def test_mega_trace_ring_validates(models):
    """A traced NS = 3 launch of the plain MoE megakernel: the ring passes
    ``validate_ring`` against the scheduled order, with one A2A window per
    layer and step, and equals the untraced launch's outputs."""
    _, tm = models
    mega = MegaQwen3(tm, cfg=MegaConfig(fuse_norms=True, cross_prefetch=True,
                                        overlap_ar=True))
    ns, L = 3, tm.cfg.num_layers
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    logits, cache = tm.prefill_batched(ids, tm.new_cache(2, MAXLEN), "xla")
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks, lg, _ = mega.decode_multi_fn(2, MAXLEN, ns)(
        mega._step_params(), tok, _copy(cache))
    ttoks, tlg, _, ring = mega.decode_multi_fn(2, MAXLEN, ns, trace=True)(
        mega._step_params(), tok, _copy(cache))
    assert torch.equal(toks, ttoks) and torch.equal(lg, tlg)
    order = mega.multi_task_order(2, MAXLEN, ns, trace=True)
    records = kt.decode_trace(ring.numpy())
    assert kt.validate_ring(records, order) == []
    assert kt.overlap_report(records)["a2a_windows"] == L * ns


def _copy(cache):
    return type(cache)(k=cache.k.clone(), v=cache.v.clone(),
                       kv_len=cache.kv_len.clone())


def test_moe_refusals(models):
    """As in JAX: int8 weights do not compose with MoE decode, and the
    prefill megakernel does not run an MoE graph."""
    _, tm = models
    with pytest.raises(NotImplementedError, match="wq8"):
        MegaQwen3(tm, cfg=MegaConfig(wq8=True)).decode_step(
            np.array([1, 2], np.int32), tm.new_cache(2, MAXLEN))
    with pytest.raises(NotImplementedError, match="MoE prefill"):
        MegaQwen3(tm).prefill(np.arange(8), tm.new_cache(1, MAXLEN))
