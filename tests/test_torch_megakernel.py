"""The port's megakernel (``mode="mega"``) against the JAX package, on the CPU.

On the CPU the megakernel runs its plain version
(``megakernel/kernels.py``), the function the CUDA kernel is held
against on the card (``tests/test_torch_cuda.py``). Here that plain
version is held against the JAX package on the f32 ``tiny`` preset:

- the packed task tables equal the JAX ``ModelBuilder`` + ``schedule`` +
  ``pack_table`` output, int for int (host-only on both sides);
- one decode step equals the JAX ``xla`` decode step on dense and paged
  caches (the golden the JAX megakernel tests use): logits atol 1e-4 and
  appended K/V rows atol 1e-5 (f32 on both sides; only summation order
  differs, ~1e-6), ``kv_len`` exactly;
- an NS = 4 launch emits the tokens of four JAX greedy steps;
- ``Engine(mode="mega")`` and ``ContinuousEngine(mode="mega")`` emit the
  JAX ``xla`` engines' greedy tokens exactly, with a bucket launch, a
  capacity fallback and an eos retire inside a launch forced;
- the knobs this slice does not port are refused.

The JAX megakernel itself is never run here (its interpret mode is the
JAX package's slow suite); its golden is the JAX ``xla`` path.
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
from triton_distributed_tpu.megakernel.scheduler import (
    SchedulePolicy as JaxPolicy,
)
from triton_distributed_tpu.megakernel.scheduler import schedule as jax_schedule
from triton_distributed_tpu.megakernel.task import Task as JaxTask
from triton_distributed_tpu.megakernel.task import TaskDependency as JaxDep
from triton_distributed_tpu.megakernel.task import TaskType as JaxTaskType
from triton_distributed_tpu.megakernel.task import pack_table as jax_pack
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import (
    MegaConfig,
    MegaDims,
    MegaQwen3,
    ModelBuilder,
    SchedulePolicy,
    Task,
    TaskDependency,
    TaskType,
    pack_table,
    schedule,
)
from triton_distributed_tpu_torch.megakernel.code_generator import check_dims
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    KVCache,
    PrefixCache,
    Qwen3,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
PAGE, MAXLEN = 16, 64

_rng = np.random.default_rng(21)
_PREFIX = _rng.integers(0, 256, 24)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, 8)]).astype(np.int32)
           for _ in range(4)]
IDS = np.stack(PROMPTS[:2])


@pytest.fixture(scope="module")
def models():
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    tm = Qwen3(get_config("tiny"), device="cpu")
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


# -- task graph ---------------------------------------------------------------

_DIMS = dict(batch=2, d=64, hq_loc=8, hkv_loc=4, head_dim=32, f_loc=128,
             v_loc=256, num_layers=3, s_max=64, n_ranks=1)


@pytest.mark.parametrize("policy", ["round_robin", "zig_zag"])
@pytest.mark.parametrize("fuse_norms", [False, True])
def test_task_tables_match_jax(models, fuse_norms, policy):
    jm, _ = models
    jb = JaxModelBuilder(JaxMegaDims(**_DIMS),
                         cfg=JaxMegaConfig(fuse_norms=fuse_norms), ctx=jm.ctx)
    jb.build_decoder_graph()
    want = jax_pack(jax_schedule(jb.tasks, JaxPolicy(policy)))
    tb = ModelBuilder(MegaDims(**_DIMS), cfg=MegaConfig(fuse_norms=fuse_norms))
    tb.build_decoder_graph()
    got = pack_table(schedule(tb.tasks, SchedulePolicy(policy)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # 9 tasks a layer (7 fused) + EMBED + LM_HEAD (+ the final NORM).
    per = 7 if fuse_norms else 9
    assert got.shape == (per * 3 + 2 + (0 if fuse_norms else 1), 8)
    traced = pack_table(schedule(tb.tasks), trace=True)
    np.testing.assert_array_equal(traced, jax_pack(jax_schedule(jb.tasks),
                                                   trace=True))


def test_scheduler_matches_jax_on_a_dag():
    """Both policies order a branchy graph as the JAX scheduler does, and
    both refuse cycles and unknown producers."""
    rng = np.random.default_rng(4)
    types = list(TaskType)[:9]
    spec = []
    for tid in range(24):
        deps = sorted(set(rng.integers(0, tid, min(tid, 2)).tolist()))
        spec.append((tid, int(rng.integers(0, len(types))), deps))
    port = [Task(t, TaskType(ty), deps=tuple(TaskDependency(d) for d in ds))
            for t, ty, ds in spec]
    ref = [JaxTask(t, JaxTaskType(ty), deps=tuple(JaxDep(d) for d in ds))
           for t, ty, ds in spec]
    for name in ("round_robin", "zig_zag"):
        got = [t.task_id for t in schedule(port, SchedulePolicy(name))]
        want = [t.task_id for t in jax_schedule(ref, JaxPolicy(name))]
        assert got == want
    with pytest.raises(ValueError, match="cycle"):
        schedule([Task(0, TaskType.NORM, deps=(TaskDependency(1),)),
                  Task(1, TaskType.NORM, deps=(TaskDependency(0),))])
    with pytest.raises(ValueError, match="unknown"):
        schedule([Task(0, TaskType.NORM, deps=(TaskDependency(7),))])


def test_config_spec_round_trip():
    for spec in ("1024:1024:2", "2048:512:3:1:1:0"):
        cfg = MegaConfig.from_spec(spec)
        assert MegaConfig.from_spec(cfg.spec()) == cfg
        jcfg = JaxMegaConfig.from_spec(spec)
        assert cfg.spec() == jcfg.spec()
    for bad in ("0:1024:2", "1024:1024", "1024:1024:2:2"):
        with pytest.raises(ValueError):
            MegaConfig.from_spec(bad)


# -- one step, NS steps --------------------------------------------------------

def _to_port(jcache, paged: bool):
    leaves = jax.tree.map(np.array, jcache)
    if paged:
        return tpk.cache_from_jax(leaves, "cpu")
    return KVCache(k=torch.from_numpy(leaves.k), v=torch.from_numpy(leaves.v),
                   kv_len=torch.from_numpy(leaves.kv_len))


@pytest.fixture(scope="module")
def steps(models):
    """Per cache kind: a cache after three golden steps (as numpy), then
    four greedy JAX xla steps from tokens [19, 23]: the first step's
    logits and cache, the four tokens, the last logits and cache."""
    jm, _ = models
    out = {}
    for paged in (False, True):
        if paged:
            jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx,
                                             max_length=MAXLEN,
                                             page_size=PAGE)
        else:
            jcache = jm.new_cache(2, MAXLEN)
        for tok in ([3, 5], [7, 11], [13, 17]):
            _, jcache = jm.decode_step(jnp.asarray(tok, jnp.int32), jcache,
                                       "xla")
        rec = {"filled": jax.tree.map(np.array, jcache), "toks": []}
        t = jnp.asarray([19, 23], jnp.int32)
        for i in range(4):
            jlogits, jcache = jm.decode_step(t, jcache, "xla")
            t = jnp.argmax(jlogits, -1).astype(jnp.int32)
            rec["toks"].append(np.asarray(t).tolist())
            if i == 0:
                rec["first"] = (np.asarray(jlogits),
                                jax.tree.map(np.array, jcache))
        rec["last"] = (np.asarray(jlogits), jax.tree.map(np.array, jcache))
        out[paged] = rec
    return out


@pytest.mark.parametrize("paged,fuse_norms", [
    (False, False), (False, True), (True, False), (True, True)])
def test_decode_step_matches_jax_xla(models, steps, paged, fuse_norms):
    _, tm = models
    rec = steps[paged]
    tcache = _to_port(rec["filled"], paged)
    mega = MegaQwen3(tm, cfg=MegaConfig(fuse_norms=fuse_norms))
    tlogits, tcache = mega.decode_step(torch.tensor([19, 23]), tcache)
    jlogits, jcache = rec["first"]
    _close(tlogits, jlogits, LOGIT_ATOL)
    want = _to_port(jcache, paged)
    if paged:
        for got, ref in zip(tpk.as_dense(tcache), tpk.as_dense(want)):
            _close(got, ref.numpy(), KV_ATOL)
    else:
        _close(tcache.k, want.k.numpy(), KV_ATOL)
        _close(tcache.v, want.v.numpy(), KV_ATOL)
    assert tcache.kv_len.tolist() == want.kv_len.tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_ns4_launch_equals_four_xla_steps(models, steps, paged):
    _, tm = models
    rec = steps[paged]
    tcache = _to_port(rec["filled"], paged)
    mega = MegaQwen3(tm, cfg=MegaConfig(fuse_norms=True))
    fn = mega.decode_multi_fn(2, MAXLEN, 4, page=PAGE if paged else 0,
                              num_pages=int(tcache.k_pages.shape[1])
                              if paged else 0)
    toks, logits, tcache = fn(tm.params, torch.tensor([19, 23]), tcache)
    assert toks.tolist() == rec["toks"]
    jlogits, jcache = rec["last"]
    _close(logits, jlogits, LOGIT_ATOL)
    want = _to_port(jcache, paged)
    assert tcache.kv_len.tolist() == want.kv_len.tolist()
    # The launch's rows (the band) landed where four steps put them.
    got = tpk.as_dense(tcache) if paged else (tcache.k, tcache.v)
    ref = tpk.as_dense(want) if paged else (want.k, want.v)
    for a, b in zip(got, ref):
        _close(a, b.numpy(), KV_ATOL)


def test_append_n_matches_jax(models, steps):
    """The paged multi-row append, trash-routed overshoot included, writes
    the JAX append_n's pool bit for bit (the trash page aside)."""
    jm, _ = models
    filled = steps[True]["filled"]
    jcache = jax.tree.map(jnp.asarray, filled)
    tcache = _to_port(filled, True)
    rng = np.random.default_rng(5)
    L, H, hd = 2, 4, 32
    k = rng.standard_normal((L, 2, H, 6, hd)).astype(np.float32)
    v = rng.standard_normal((L, 2, H, 6, hd)).astype(np.float32)
    n_valid = np.asarray([6, 2], np.int32)
    want = jpk.append_n(jcache, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(n_valid))
    got = tpk.append_n(tcache, torch.from_numpy(k), torch.from_numpy(v),
                       n_valid)
    np.testing.assert_array_equal(got.k_pages.numpy()[:, 1:],
                                  np.asarray(want.k_pages)[:, 1:])
    np.testing.assert_array_equal(got.v_pages.numpy()[:, 1:],
                                  np.asarray(want.v_pages)[:, 1:])
    assert got.kv_len.tolist() == np.asarray(want.kv_len).tolist()


# -- serving ------------------------------------------------------------------

# Continuous traffic (max_batch 4, page 16, max_length 48, ns 4): row 0's
# 34-token prompt leaves it within ns of max_length after three launches
# (a single-step fallback follows), rows 1 and 3 finish inside launches,
# and the last launch carries rows 0 and 2 alone (a 2-wide bucket).
CONT_MAXLEN, CONT_NS = 48, 4
CONT_PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, n)]).astype(
    np.int32) for n in (10, 8, 8, 8)]
CONT_REQS = list(zip(CONT_PROMPTS, (14, 3, 10, 6)))


@pytest.fixture(scope="module")
def goldens(models):
    """The JAX xla engines' streams for the serving comparisons."""
    jm, tm = models
    # One Engine golden serves both cache kinds: greedy tokens do not
    # depend on the cache layout (test_torch_model holds the port's dense
    # and paged xla engines to it).
    out = {"engine": JaxEngine(jm, mode="xla").serve(IDS, 10, MAXLEN)}
    # eos: a token row 2 first emits inside its second launch that row 0
    # never emits, so row 2 retires inside a launch and row 0 runs on to
    # its fallback step. Picked from the port's own xla streams (fast on
    # the CPU); the golden is the JAX engine's run with that eos.
    free = ContinuousEngine(tm, max_batch=4, page_size=PAGE,
                            max_length=CONT_MAXLEN, device="cpu").run(
                                CONT_REQS)
    row0, row2 = free[0].tolist(), free[2].tolist()
    out["eos"] = next(t for i, t in enumerate(row2)
                      if i >= 5 and t not in row0 and t not in row2[:i])
    eng = JaxContinuous(jm, max_batch=4, page_size=PAGE,
                        max_length=CONT_MAXLEN, prefix_cache=True,
                        eos_id=out["eos"])
    out["continuous"] = eng.run(CONT_REQS)
    assert eng.audit() == []
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_mega_tokens_identical(models, goldens, paged):
    """serve(ns=4) with gen_len 10: two 4-step launches, then one
    single-step launch of the same kernel."""
    _, tm = models
    eng = Engine(tm, mode="mega", paged=paged, page_size=PAGE, device="cpu")
    got = eng.serve(IDS, 10, MAXLEN, ns=4)
    np.testing.assert_array_equal(got, goldens["engine"])
    assert eng.last_stats["mega_launches"] == 2
    assert eng.last_stats["decode_steps"] == 9


# Ten rows: more than one of the CUDA kernel's batch groups (kGroupB in
# csrc/megakernel.cu); like the JAX megakernel, the engines take any batch.
WIDE_IDS = np.stack([np.concatenate([_PREFIX[:8], _rng.integers(0, 256, 8)])
                     for _ in range(10)]).astype(np.int32)


def test_mega_wide_batch_tokens_identical(models):
    """Ten rows through Engine.serve (one 4-step launch and a single-step
    remainder) and through a ContinuousEngine with max_batch=10 emit the
    JAX xla Engine's greedy tokens."""
    jm, tm = models
    want = JaxEngine(jm, mode="xla").serve(WIDE_IDS, 6, MAXLEN)
    eng = Engine(tm, mode="mega", device="cpu")
    np.testing.assert_array_equal(eng.serve(WIDE_IDS, 6, MAXLEN, ns=4), want)
    assert eng.last_stats["mega_launches"] == 1
    cont = ContinuousEngine(tm, max_batch=10, page_size=PAGE,
                            max_length=MAXLEN, mode="mega", ns=4,
                            device="cpu")
    got = cont.run([(row, 6) for row in WIDE_IDS])
    np.testing.assert_array_equal(np.stack(got), want[:, WIDE_IDS.shape[1]:])
    assert cont.last_stats["mega_launches"] > 0
    assert cont.audit() == []


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_continuous_mega_tokens_identical(models, goldens, prefix_cache):
    """Greedy streams equal the JAX xla ContinuousEngine's (one golden: a
    greedy stream does not depend on the prefix cache), through a bucket
    launch, a capacity fallback and an eos retire inside a launch."""
    _, tm = models
    eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE,
                           max_length=CONT_MAXLEN, prefix_cache=prefix_cache,
                           mode="mega", ns=CONT_NS, eos_id=goldens["eos"],
                           device="cpu")
    got = eng.run(CONT_REQS)
    for g, w in zip(got, goldens["continuous"]):
        np.testing.assert_array_equal(g, w)
    stats = eng.last_stats
    assert stats["mega_launches"] > 0
    assert stats["mega_bucket_launches"] > 0  # fewer slots than max_batch
    assert stats["mega_fallback_steps"] > 0   # a slot within ns of the end
    assert stats["mega_device_retires"] > 0   # eos found inside a launch
    assert stats["decode_steps"] == (CONT_NS * stats["mega_launches"]
                                     + stats["mega_fallback_steps"])
    assert eng.audit() == []


# -- refusals -----------------------------------------------------------------

def test_refused_knobs_raise(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="wq8"):
        MegaQwen3(tm, cfg=MegaConfig(wq8=True))
    mega = MegaQwen3(tm)
    for kw in (dict(sampled=True), dict(filtered=True), dict(ring=True),
               dict(trace=True), dict(kv_quant=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mega.build_multi(2, MAXLEN, 4, page=PAGE, **kw)
    with pytest.raises(NotImplementedError, match="prefill"):
        mega.prefill(np.arange(8), tm.new_cache(1, MAXLEN))
    with pytest.raises(NotImplementedError, match="wq8"):
        mega.quantized_params()
    cache8, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE, kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        mega.decode_step(torch.tensor([1, 2]), cache8)
    base = MegaDims(**_DIMS)
    import dataclasses

    for over in (dict(prefill=True), dict(num_experts=4, moe_top_k=2),
                 dict(n_ranks=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_dims(dataclasses.replace(base, **over), MegaConfig())
    with pytest.raises(ValueError, match="eos"):
        mega.build_multi(2, MAXLEN, 4, eos=True, valid_arg=True)
    with pytest.raises(NotImplementedError, match="wq8"):
        Engine(tm, mode="mega", mega_cfg=MegaConfig(wq8=True), device="cpu")
    for kw in (dict(resident=True), dict(kernel_trace=True),
               dict(mega_cfg=MegaConfig(wq8=True))):
        with pytest.raises(NotImplementedError):
            ContinuousEngine(tm, page_size=PAGE, max_length=MAXLEN,
                             mode="mega", device="cpu", **kw)
    with pytest.raises(ValueError, match="mega"):
        ContinuousEngine(tm, page_size=PAGE, max_length=MAXLEN, mode="mega",
                         speculative=2, device="cpu")
    with pytest.raises(ValueError, match="ns"):
        ContinuousEngine(tm, page_size=PAGE, max_length=MAXLEN, mode="mega",
                         ns=0, device="cpu")
