"""The port's Qwen3 and serving engines against the JAX package, on the CPU.

One JAX ``tiny`` model (f32, tp=1 on one CPU device, Pallas in interpret
mode) is built per module; its weights carry to the port through
``params_from_jax``, so both packages compute with the same numbers on
the same seeded numpy inputs. JAX reference runs live in module-scoped
fixtures and share the JAX model's compiled programs (shapes are chosen
so the engines and the model-level checks hit the same programs).

Tolerances: logits atol 1e-4 (f32 on both sides; the port's plain
attention takes a full softmax where the Pallas kernels take a
blockwise one, and GEMMs sum in another order — differences are
~1e-6 of logits of size ~1); KV-cache rows atol 1e-5; greedy tokens
must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    PrefixCache,
    Qwen3,
    Request,
    get_config,
    load_hf_state_dict,
    params_from_jax,
)
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.models import sampling
from triton_distributed_tpu_torch.models.engine import prefill_suffix_chunks
from triton_distributed_tpu_torch.models.stats import missing_core_stats
from triton_distributed_tpu_torch.obs import events as obs_events
from triton_distributed_tpu_torch.obs import metrics as obs_metrics

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
PAGE, MAXLEN, GEN = 16, 64, 5

# Four 32-token prompts sharing a 24-token prefix (1.5 pages): the warm
# admissions map page 0 and COW-clone page 1.
_rng = np.random.default_rng(11)
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
    """Every port engine and radix tree a test touched must end with a
    clean pool (the JAX conftest's audit, for the port's objects)."""
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_weight_carry(models):
    jm, tm = models
    jp = jm.params
    _close(tm.params["embed"], jp.embed, 0)
    _close(tm.params["lm_head"], jp.lm_head, 0)
    for name in ("wqkv", "wo", "q_norm", "k_norm"):
        _close(tm.params["layers"]["attn"][name],
               getattr(jp.layers.attn, name), 0)
    for name in ("w1", "w2"):
        _close(tm.params["layers"]["mlp"][name],
               getattr(jp.layers.mlp, name), 0)


def test_load_hf_state_dict_matches_jax(models):
    """An HF-layout state dict (torch ``[out, in]`` weights, tied
    embeddings off) maps to the same leaves in both packages."""
    from triton_distributed_tpu.models.qwen import (
        load_hf_state_dict as jax_load,
    )

    jm, tm = models
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    d, hd, ff = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    shapes = {"q_proj": (cfg.num_q_heads * hd, d),
              "k_proj": (cfg.num_kv_heads * hd, d),
              "v_proj": (cfg.num_kv_heads * hd, d),
              "o_proj": (d, cfg.num_q_heads * hd),
              "q_norm": (hd,), "k_norm": (hd,)}
    state = {"model.embed_tokens.weight": (cfg.vocab_size, d),
             "model.norm.weight": (d,), "lm_head.weight": (cfg.vocab_size, d)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        state.update({pre + f"self_attn.{k}.weight": v
                      for k, v in shapes.items()})
        state.update({pre + "mlp.gate_proj.weight": (ff, d),
                      pre + "mlp.up_proj.weight": (ff, d),
                      pre + "mlp.down_proj.weight": (d, ff),
                      pre + "input_layernorm.weight": (d,),
                      pre + "post_attention_layernorm.weight": (d,)})
    state = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in state.items()}
    want = jax_load(jm.cfg, state, 1)
    got = load_hf_state_dict(cfg, state)
    np.testing.assert_array_equal(got["lm_head"], np.asarray(want.lm_head))
    for name in ("wqkv", "wo", "q_norm", "k_norm"):
        np.testing.assert_array_equal(got["layers"]["attn"][name],
                                      np.asarray(getattr(want.layers.attn,
                                                         name)))
    for name in ("w1", "w2"):
        np.testing.assert_array_equal(got["layers"]["mlp"][name],
                                      np.asarray(getattr(want.layers.mlp,
                                                         name)))


def test_filter_logits_matches_jax():
    from triton_distributed_tpu.models.sampling import (
        filter_logits as jax_filter,
    )

    logits = np.random.default_rng(3).standard_normal((3, 256)).astype(
        np.float32)
    for t, p, k in ((0.7, 1.0, 0), (1.0, 0.9, 0), (1.3, 0.8, 20)):
        want = np.asarray(jax_filter(jnp.asarray(logits), t, p, k))
        got = sampling.filter_logits(torch.from_numpy(logits), t, p, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        gen = torch.Generator().manual_seed(0)
        toks = sampling.sample(torch.from_numpy(logits), gen, t, p, k)
        assert np.isfinite(want[np.arange(3), toks.numpy()]).all()
    assert sampling.sample(torch.from_numpy(logits), None, 0.0).tolist() == (
        logits.argmax(-1).tolist())


def _jax_dense_prefill(jm):
    lens = np.array([32, 27], np.int32)
    logits, cache = jm.prefill_batched(
        jnp.asarray(IDS), jm.new_cache(2, MAXLEN), "xla", jnp.asarray(lens))
    return lens, logits, cache


def test_prefill_batched_and_dense_decode_steps(models):
    jm, tm = models
    lens, jlogits, jcache = _jax_dense_prefill(jm)
    tlogits, tcache = tm.prefill_batched(IDS, tm.new_cache(2, MAXLEN),
                                         true_lens=lens)
    _close(tlogits, jlogits, LOGIT_ATOL)
    for row, n in enumerate(lens):
        _close(tcache.k[:, row, :, :n], np.asarray(jcache.k)[:, row, :, :n],
               KV_ATOL)
    assert tcache.kv_len.tolist() == lens.tolist()
    tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(3):
        jlogits, jcache = jm.decode_step(jnp.asarray(tok), jcache, "xla")
        tlogits, tcache = tm.decode_step(torch.tensor(tok), tcache)
        _close(tlogits, jlogits, LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    assert tcache.kv_len.tolist() == np.asarray(jcache.kv_len).tolist()


def test_paged_decode_steps(models):
    """Dense prefill copied into pages, then decode through the page
    table (the Engine(paged=True) layout: 8 pages, table [2, 4])."""
    jm, tm = models
    lens, jlogits, jdense = _jax_dense_prefill(jm)
    jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                     page_size=PAGE)
    tcache, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE)
    tdense = tm.new_cache(2, MAXLEN)
    tm.prefill_batched(IDS, tdense, true_lens=lens)
    for i in range(2):
        jcache = jpk.write_prefill(jcache, i, jdense.k[:, i:i + 1],
                                   jdense.v[:, i:i + 1], int(lens[i]))
        tcache = tpk.write_prefill(tcache, i, tdense.k[:, i:i + 1],
                                   tdense.v[:, i:i + 1], int(lens[i]))
    tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(3):
        jlogits, jcache = jm.decode_step(jnp.asarray(tok), jcache, "xla")
        tlogits, tcache = tm.decode_step(torch.tensor(tok), tcache)
        _close(tlogits, jlogits, LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    jk, _ = jpk.as_dense(jcache)
    tk, _ = tpk.as_dense(tcache)
    for row, n in enumerate(lens + 3):
        _close(tk[:, row, :, :n], np.asarray(jk)[:, row, :, :n], KV_ATOL)


def test_prefill_paged_chunk_at_offset(models):
    """A cold 24-token prompt in one 32-wide chunk, then an 8-token
    suffix chunk at q_offset 24 (8 real rows + 8 pad rows, the pad rows
    past the slot's pages routed to the trash page) — the
    ContinuousEngine prefix path's two chunk shapes."""
    jm, tm = models
    jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                     page_size=PAGE, assign_pages=False)
    tcache, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE, assign_pages=False)
    table = np.zeros((2, MAXLEN // PAGE), np.int32)
    table[1, :3] = [5, 7, 2]
    jcache.page_table = jnp.asarray(table)
    tcache.page_table = torch.from_numpy(table)
    prompt = np.concatenate([PROMPTS[0][:24], PROMPTS[1][24:]])
    jl, jcache, _ = _jax_chunks(jm, jcache, prompt[:24], 0)
    tl, tcache, _ = prefill_suffix_chunks(tm, tcache, 1, prompt[:24], 0, 0,
                                           "xla")
    _close(tl, jl, LOGIT_ATOL)
    jl, jcache, _ = _jax_chunks(jm, jcache, prompt, 24)
    tl, tcache, _ = prefill_suffix_chunks(tm, tcache, 1, prompt, 24, 0, "xla")
    _close(tl, jl, LOGIT_ATOL)
    assert tcache.kv_len.tolist() == np.asarray(jcache.kv_len).tolist()
    assert tcache.kv_len.tolist() == [0, 32]
    for pid in (5, 7):
        _close(tcache.k_pages[:, pid], np.asarray(jcache.k_pages)[:, pid],
               KV_ATOL)


def _jax_chunks(jm, cache, prompt, start):
    from triton_distributed_tpu.models.engine import (
        prefill_suffix_chunks as jax_chunks,
    )
    return jax_chunks(jm, cache, 1, prompt, start, 0, "xla")


# -- serving: token streams identical to the JAX engines ------------------


@pytest.fixture(scope="module")
def jax_streams(models):
    jm, _ = models
    out = {}
    for name, kw in (("dense", {}), ("paged", dict(paged=True,
                                                      page_size=PAGE))):
        eng = JaxEngine(jm, mode="xla", **kw)
        out[name] = eng.serve(IDS, GEN, MAXLEN)
        out[f"{name}-stats"] = eng.last_stats
    for pc in (False, True):
        eng = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                            max_length=MAXLEN, num_pages=7, prefix_cache=pc)
        out[f"continuous-{pc}"] = eng.run([(p, GEN) for p in PROMPTS])
        assert eng.audit() == []
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_engine_serve_tokens_identical(models, jax_streams, paged):
    _, tm = models
    eng = Engine(tm, paged=paged, page_size=PAGE, device="cpu")
    got = eng.serve(IDS, GEN, MAXLEN)
    np.testing.assert_array_equal(got, jax_streams["paged" if paged
                                                   else "dense"])
    assert eng.last_stats["decode_steps"] == GEN - 1
    assert missing_core_stats(eng.last_stats) == []
    want = jax_streams[("paged" if paged else "dense") + "-stats"]
    for key in ("kv_dtype", "kv_bytes_per_token"):
        assert eng.last_stats[key] == want[key], key


@pytest.mark.parametrize("prefix_cache,prefill_chunk", [
    (False, 0), (True, 0),
    (True, 16),  # chunked: a decode step of the batch between chunks
])
def test_continuous_tokens_identical(models, jax_streams, prefix_cache,
                                     prefill_chunk):
    _, tm = models
    admitted = obs_metrics.counter("tdt_engine_admitted_total")
    before, seq = admitted.value(), obs_events.default_ring().next_seq
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           num_pages=7, prefix_cache=prefix_cache,
                           prefill_chunk=prefill_chunk, device="cpu")
    got = eng.run([(p, GEN) for p in PROMPTS])
    want = jax_streams[f"continuous-{prefix_cache}"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.audit() == []
    stats = eng.last_stats
    assert missing_core_stats(stats) == []
    assert admitted.value() - before == len(PROMPTS)
    kinds = [e.kind for e in obs_events.default_ring().tail(seq - 1)[0]]
    assert kinds.count("admit") == kinds.count("evict") == len(PROMPTS)
    if prefix_cache:
        assert stats["prefix_hit_tokens"] > 0
        assert stats["pages_cow_copied"] > 0
    if prefill_chunk:
        assert stats["prefill_chunks"] > len(PROMPTS)
    # The engines agree with each other, too (greedy is deterministic).
    np.testing.assert_array_equal(np.stack(got[:2]),
                                  jax_streams["dense"][:, IDS.shape[1]:])


def test_engine_prefix_cache_warm_serve(models, jax_streams):
    """Engine(paged=True, prefix_cache=True): the second serve maps the
    first's pages and still emits the same tokens."""
    _, tm = models
    eng = Engine(tm, paged=True, page_size=PAGE, prefix_cache=True,
                 device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(eng.serve(IDS, GEN, MAXLEN),
                                      jax_streams["dense"])
    assert eng.last_stats["prefix_hit_tokens"] > 0
    assert eng.audit() == []


def test_continuous_failure_isolation(models, jax_streams):
    """Shed past max_queue, an already-expired deadline, an unservable
    request and an eos stop each end only their own request; the rest
    emit the JAX tokens and the pool audits clean."""
    _, tm = models
    want = jax_streams["continuous-True"]
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           num_pages=7, prefix_cache=True, max_queue=4,
                           device="cpu")
    reqs = [Request(PROMPTS[0], GEN), Request(PROMPTS[1], GEN),
            Request(PROMPTS[2], GEN, deadline_s=0.0),
            Request(np.zeros(MAXLEN, np.int32), GEN),
            Request(PROMPTS[3], GEN)]
    res = eng.run(reqs, results=True)
    assert [r.status for r in res] == [
        "ok", "ok", "deadline_exceeded", "unservable", "overloaded"]
    np.testing.assert_array_equal(res[0].tokens, want[0])
    np.testing.assert_array_equal(res[1].tokens, want[1])
    assert res[4].error.status == "overloaded"
    stats = eng.last_stats
    assert stats["shed_requests"] == 1 and stats["deadline_expired"] == 1
    assert eng.audit() == []
    stop = int(want[0][2])
    eos = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                           max_length=MAXLEN, eos_id=stop, device="cpu")
    out = eos.run([(PROMPTS[0], GEN)])[0]
    np.testing.assert_array_equal(out, want[0][: list(want[0]).index(stop)
                                                + 1])
