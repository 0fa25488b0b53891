"""The port's greedy speculative decoding against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages:

- the drafting and bookkeeping pieces (``NGramDraft``, ``SpecState``,
  ``cap_draft``, ``TreeDraft`` masks and depths, the radix tree's
  ``propose_continuations``) must give EXACTLY the JAX outputs: they are
  host integer logic;
- ``flash_attention(bias=)`` (the port's plain version) against the JAX
  Pallas kernel with its ``b_ref`` operand in interpret mode, and the
  tree chunk through ``tp_attn_prefill_paged_chunk`` and
  ``Qwen3.prefill_paged_chunk``, agree within 1e-5 (layer) and 1e-4
  (logits): f32 on both sides, only summation order differs;
- ``move_kv_rows`` and ``rollback_kv`` leave bit-identical pools and
  lengths (pure data movement);
- on the f32 ``tiny`` model every speculative arm of both port engines
  emits the greedy tokens of the JAX package's PLAIN ``Engine.serve``
  (never the JAX speculative engines' output). Acceptance is forced by
  monkeypatching the drafters to propose the golden continuation (with a
  wrong last token, or behind a decoy branch), so accepted rows, rolled
  back rows and moved rows are all exercised. The int8 arm (linear
  chains only) is held against the JAX int8 speculative engine on the
  same traffic: over an int8 pool a verify chunk's rejected rows can grow
  a page's scale, so its tokens need not equal plain int8 decode, but
  the scale protocol is bit-identical across the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.models import prefix_cache as jpc
from triton_distributed_tpu.models import speculative as jspec
from triton_distributed_tpu.ops.attention.flash_attention import (
    flash_attention as jax_flash_attention,
)
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    PrefixCache,
    Qwen3,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.models import speculative as tspec
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention import flash_attention

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-5
LOGIT_ATOL = 1e-4
PAGE, MAXLEN, GEN = 16, 128, 24
# Aperiodic 7-token motifs: the n-gram drafter proposes them, and on a
# re-ask the radix walk and the n-gram proposal disagree, so trees form.
_rng = np.random.default_rng(0)
PROMPTS = [np.asarray(_rng.integers(1, 50, 7).tolist() * 4 + [3, 5],
                      np.int32) for _ in range(2)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _trees(rng, n_trees=6):
    """Seeded draft tries: a pending token and 1-4 overlapping paths."""
    out = []
    for _ in range(n_trees):
        pending = int(rng.integers(0, 9))
        paths = [rng.integers(0, 4, int(rng.integers(1, 6))).tolist()
                 for _ in range(int(rng.integers(1, 5)))]
        out.append((pending, paths, int(rng.integers(4, 17))))
    return out


# -- host pieces: exact equality -------------------------------------------


def test_tree_draft_matches_jax():
    for pending, paths, budget in _trees(np.random.default_rng(1)):
        trees = [mod.TreeDraft(pending) for mod in (tspec, jspec)]
        for p in paths:
            assert trees[0].add_path(p, budget=budget) == trees[1].add_path(
                p, budget=budget)
        got, want = trees
        for attr in ("tokens", "parent", "depth", "num_drafted", "max_depth",
                     "is_chain"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got.chain_tokens() == want.chain_tokens()
        for c in (len(want), 16, 32):
            np.testing.assert_array_equal(got.mask(c), want.mask(c))
            np.testing.assert_array_equal(got.depths(c), want.depths(c))
        assert [got.child(i, t) for i in range(len(got)) for t in range(5)] \
            == [want.child(i, t) for i in range(len(want)) for t in range(5)]


def test_ngram_spec_state_and_cap_draft_match_jax():
    rng = np.random.default_rng(2)
    motif = rng.integers(0, 6, 5).tolist()
    stream = motif * 3 + rng.integers(0, 6, 20).tolist() + motif * 2
    for ngram in ((3, 1), (2, 2)):
        states = [mod.SpecState(5, max_ngram=ngram[0], min_ngram=ngram[1],
                                w_max=4) for mod in (tspec, jspec)]
        for i, t in enumerate(stream):
            for st in states:
                st.observe([t])
            for k in range(0, 7):
                assert states[0].draft.propose(k) == states[1].draft.propose(
                    k), (i, k)
            assert states[0].propose(6) == states[1].propose(6)
            outcome = (int(rng.integers(0, 5)), int(rng.integers(0, 5)),
                       int(rng.integers(0, 5)))
            for st in states:
                if i % 3:
                    st.record(outcome[0], min(outcome[1], outcome[0]))
                else:
                    st.record_tree(*outcome)
            for attr in ("k", "width", "proposed", "accepted", "accept_rate"):
                assert getattr(states[0], attr) == getattr(states[1], attr)
    for k in range(-1, 8):
        for kv in (0, 90, 100, 111, 112, 113, 127):
            for budget in (0, 1, 3, 9):
                assert tspec.cap_draft(k, kv, budget, 128) == jspec.cap_draft(
                    k, kv, budget, 128)
    with pytest.raises(ValueError):
        tspec.NGramDraft(1, 2)


def _radix_pair():
    """The same radix tree in both packages: chains sharing prefixes,
    inserted in one order, then matched in one order (the LRU clock that
    orders branch exploration)."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 50, 24).tolist()
    chains = [base + rng.integers(0, 50, n).tolist() for n in (12, 20, 9)]
    chains.append(base[:10] + rng.integers(0, 50, 30).tolist())
    chains.append(base[:16] + rng.integers(0, 50, 3).tolist())  # partial leaf
    out = []
    for pc_mod, pk_mod in ((PrefixCache, tpk), (jpc.PrefixCache, jpk)):
        pool = pk_mod.PagePool(40)
        tree = pc_mod(pool, 8)
        for ch in chains:
            tree.insert_chain(tree.root, ch, pool.allocate(-(-len(ch) // 8)))
        for ch in (chains[1], chains[3]):
            tree.release_match(tree.match(ch))
        out.append(tree)
    return out, chains


def test_propose_continuations_matches_jax():
    (got, want), chains = _radix_pair()
    free = [len(t.pool.free) for t in (got, want)]
    histories = [chains[0][:n] for n in (1, 8, 13, 16, 24, 30, 36)]
    histories += [chains[3][:11], chains[4][:17], chains[4][:19],
                  [49, 48, 47], [], chains[0][:20] + [99]]
    for h in histories:
        for width, depth in ((1, 4), (3, 6), (4, 16), (0, 4), (2, 0)):
            assert got.propose_continuations(h, width=width, depth=depth) \
                == want.propose_continuations(h, width=width, depth=depth), (
                    len(h), width, depth)
    # A pure read: no pages moved, no pins, no lookups counted.
    assert [len(t.pool.free) for t in (got, want)] == free
    assert all(n.refcount == 0 for n in got.walk())
    assert got.stats == {k: want.stats[k] for k in got.stats}
    # The KV tier's chains extend the tree's paths by a flat prefix scan.
    tier = [chains[0][:8] + [77, 78, 79], chains[1], [5, 6, 7], chains[0]]
    for h in (chains[0][:8], chains[1][:3], [], chains[0] + [1]):
        for width, depth in ((1, 2), (3, 6), (0, 4), (2, 0)):
            assert got.propose_continuations(
                h, width=width, depth=depth, tier_chains=tier
            ) == want.propose_continuations(
                h, width=width, depth=depth, tier_chains=tier), (
                    len(h), width, depth)
    for t in (got, want):
        t.evict_until(t.pool.num_pages)  # leave both pools clean


# -- attention with the tree bias ------------------------------------------


def _tree_bias(q_offset: int, c: int, s_kv: int, tree) -> np.ndarray:
    """The [C, S_kv] bias the model layer builds from a [C, C] mask."""
    bias = np.zeros((c, s_kv), np.float32)
    bias[:, q_offset:q_offset + c] = tree.mask(c)
    return bias


def _sample_tree():
    tree = tspec.TreeDraft(4)
    for path in ([1, 2, 3], [1, 5], [6, 7, 8, 9], [6, 2]):
        tree.add_path(path)
    return tree


@pytest.mark.parametrize("off", [0, 40])
def test_flash_attention_bias_matches_jax(off):
    rng = np.random.default_rng(off + 5)
    sq, sk = 16, 64
    q = rng.standard_normal((1, 8, sq, 32)).astype(np.float32)
    k = rng.standard_normal((1, 4, sk, 32)).astype(np.float32)
    v = rng.standard_normal((1, 4, sk, 32)).astype(np.float32)
    bias = _tree_bias(off, sq, sk, _sample_tree())
    want, want_lse = jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, kv_offset=off,
        block_q=16, block_k=16, bias=jnp.asarray(bias), return_lse=True)
    got, got_lse = flash_attention(*map(_t, (q, k, v)), causal=True,
                                   kv_offset=off, bias=_t(bias),
                                   return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    assert ck.FLASH_ATTENTION_BIAS.launches == 0  # CPU tensors never launch
    # The mask matters: without it the outputs move well past the limit.
    plain = flash_attention(*map(_t, (q, k, v)), kv_offset=off)
    assert (plain - got).abs().max().item() > 100 * ATOL
    with pytest.raises(ValueError, match="bias shape"):
        flash_attention(*map(_t, (q, k, v)), kv_offset=off,
                        bias=_t(bias[:, :-1]))
    # With int8 codes and scales too (the plain version dequantizes
    # first), as the JAX kernel takes them.
    codes = np.clip(np.round(k * 30), -127, 127).astype(np.int8)
    ks = rng.random((1, 4, sk // 16)).astype(np.float32) / 30
    want8 = jax_flash_attention(
        *map(jnp.asarray, (q, codes, codes)), causal=True, kv_offset=off,
        block_q=16, block_k=16, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(ks), bias=jnp.asarray(bias))
    got8 = flash_attention(*map(_t, (q, codes, codes)), kv_offset=off,
                           block_k=16, k_scale=_t(ks), v_scale=_t(ks),
                           bias=_t(bias))
    np.testing.assert_allclose(got8.numpy(), np.asarray(want8), atol=ATOL,
                               rtol=0)


@pytest.fixture(scope="module")
def models():
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0,
                                    max_length=MAXLEN)
    tm = Qwen3(get_config("tiny", max_length=MAXLEN), device="cpu")
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params)))
    yield jm, tm
    mesh_mod.finalize_distributed()


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


def _jax_layer(jm, fn, *args, **kw):
    """Run a JAX attention-layer function at tp=1 inside ``shard_map``."""
    def body(*a):
        return fn(*a, jm.dims, axis=jm.axis, mode="xla_ar", ctx=jm.ctx, **kw)

    f = jm.ctx.shard_map(body, in_specs=tuple(P() for _ in args),
                         out_specs=P())
    return jax.jit(f)(*args)


def test_tp_attn_tree_chunk_matches_jax(models):
    """A 16-row tree chunk at q_offset 20 over the paged pool: nodes rope
    at their depth, scatter at their storage position, attend under the
    ancestor mask."""
    jm, tm = models
    jp = jax.tree.map(lambda a: a[0], jm.params.layers.attn)
    rng = np.random.default_rng(6)
    kp = rng.standard_normal((8, 4, PAGE, 32)).astype(np.float32)
    vp = rng.standard_normal((8, 4, PAGE, 32)).astype(np.float32)
    table = np.array([4, 7, 2, 0], np.int32)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    tree = _sample_tree()
    bias = _tree_bias(20, 16, 4 * PAGE, tree)
    rope = 20 + tree.depths(16)
    want = _jax_layer(jm, jattn.tp_attn_prefill_paged_chunk, jp,
                      jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(table), jnp.asarray(20, jnp.int32),
                      kv_pages=4, rope_pos=jnp.asarray(rope),
                      attn_bias=jnp.asarray(bias))
    got = tattn.tp_attn_prefill_paged_chunk(
        tm._layers[0]["attn"], _t(x), _t(kp), _t(vp),
        torch.from_numpy(table), 20, tm.dims, kv_pages=4,
        rope_pos=torch.from_numpy(rope).long(), attn_bias=_t(bias))
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=ATOL, rtol=0)


def test_prefill_paged_chunk_tree_logits_match_jax(models):
    """The model expands the [C, C] mask to the gathered view once and
    returns per-position logits; both packages, same cache."""
    jm, tm = models
    rng = np.random.default_rng(7)
    jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                     page_size=PAGE)
    tcache, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE)
    prompt = rng.integers(0, 256, 30).astype(np.int32)
    from triton_distributed_tpu.models.engine import (
        prefill_suffix_chunks as jax_chunks,
    )
    from triton_distributed_tpu_torch.models.engine import (
        prefill_suffix_chunks,
    )

    _, jcache, _ = jax_chunks(jm, jcache, 1, prompt, 0, 0, "xla")
    _, tcache, _ = prefill_suffix_chunks(tm, tcache, 1, prompt, 0, 0, "xla")
    tree = _sample_tree()
    buf = np.zeros(16, np.int32)
    buf[:len(tree)] = tree.tokens
    kw = dict(kv_pages=4, all_logits=True, tree_mask=tree.mask(16),
              tree_depth=tree.depths(16))
    want, jcache = jm.prefill_paged_chunk(buf, 1, 30, 30 + len(tree),
                                          len(tree) - 1, jcache, "xla", **kw)
    got, tcache = tm.prefill_paged_chunk(buf, 1, 30, 30 + len(tree),
                                         len(tree) - 1, tcache, "xla", **kw)
    n = len(tree)
    assert got.shape == (16, tm.cfg.vocab_size)
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n],
                               atol=LOGIT_ATOL, rtol=0)
    assert tcache.kv_len.tolist() == np.asarray(jcache.kv_len).tolist()
    with pytest.raises(ValueError, match="go together"):
        tm.prefill_paged_chunk(buf, 1, 30, 37, 6, tcache, "xla",
                               tree_mask=tree.mask(16))


def test_move_kv_rows_and_rollback_bit_identical():
    rng = np.random.default_rng(8)
    kp = rng.standard_normal((2, 6, 2, 4, 8)).astype(np.float32)
    vp = rng.standard_normal((2, 6, 2, 4, 8)).astype(np.float32)
    table = np.array([[0, 0, 0], [3, 1, 5]], np.int32)
    kv_len = np.array([0, 9], np.int32)
    # Leftward moves across a page boundary, overlapping, one self-move.
    src, dst = [5, 7, 9, 10], [4, 5, 6, 10]
    jc = jpk.PagedKVCache(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
                          page_table=jnp.asarray(table),
                          kv_len=jnp.asarray(kv_len))
    tc = tpk.PagedKVCache(k_pages=torch.from_numpy(kp.copy()),
                          v_pages=torch.from_numpy(vp.copy()),
                          page_table=torch.from_numpy(table),
                          kv_len=torch.from_numpy(kv_len))
    jc = jpk.rollback_kv(jpk.move_kv_rows(jc, 1, src, dst), 1, 7)
    tc = tpk.rollback_kv(tpk.move_kv_rows(tc, 1, src, dst), 1, 7)
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    assert tc.kv_len.tolist() == np.asarray(jc.kv_len).tolist() == [0, 7]
    assert not np.array_equal(tc.k_pages.numpy(), kp)  # rows really moved
    assert tpk.move_kv_rows(tc, 1, [3], [3]) is tc
    with pytest.raises(ValueError, match="mismatch"):
        tpk.move_kv_rows(tc, 1, [3, 4], [2])
    q8 = tpk.PagedKVCache(k_pages=tc.k_pages.to(torch.int8),
                          v_pages=tc.v_pages.to(torch.int8),
                          page_table=tc.page_table, kv_len=tc.kv_len,
                          k_scale=torch.ones(2, 6, 2),
                          v_scale=torch.ones(2, 6, 2))
    with pytest.raises(ValueError, match="full-width-pool only"):
        tpk.move_kv_rows(q8, 1, src, dst)
    assert tpk.rollback_kv(q8, 1, 3).kv_len.tolist() == [0, 3]


# -- engines: tokens equal the JAX package's plain greedy goldens ----------


@pytest.fixture(scope="module")
def goldens(models):
    jm, _ = models
    out = JaxEngine(jm, mode="xla").serve(np.stack(PROMPTS), GEN, MAXLEN)
    return [out[i, len(PROMPTS[i]):] for i in range(len(PROMPTS))]


def _force_drafts(monkeypatch, goldens, tree: bool):
    """Make the drafters propose the golden continuation: linear drafts
    get a wrong last token (so every verify accepts a prefix and rolls
    one row back); tree drafts put a decoy branch FIRST, so the true
    branch sits in later storage rows and every accept moves rows."""
    fulls = [list(p) + [int(t) for t in g] for p, g in zip(PROMPTS, goldens)]

    def truth(hist, depth):
        hist = [int(t) for t in hist]
        for full in fulls:
            if full[:len(hist)] == hist:
                return full[len(hist):len(hist) + depth]
        return []

    if tree:
        def propose_continuations(self, tokens, *, width, depth,
                                  tier_chains=None):
            true = truth(tokens, depth)
            if len(true) < 2:
                return []
            return [[(true[0] + 1) % 256] * len(true), true]

        monkeypatch.setattr(PrefixCache, "propose_continuations",
                            propose_continuations)
    else:
        def propose(self, budget):
            true = truth(self.draft.history, min(self.k, int(budget)))
            return true[:-1] + [(true[-1] + 1) % 256] if true else []

        monkeypatch.setattr(tspec.SpecState, "propose", propose)


def _check_ledger(st: dict, tree: bool):
    assert st["spec_accepted_tokens"] > 0
    assert st["spec_rollback_tokens"] == (st["spec_draft_tokens"]
                                          - st["spec_accepted_tokens"])
    assert st["target_steps"] == st["decode_steps"] + st["spec_verify_steps"]
    if tree:
        assert st["spec_tree_rounds"] > 0
        assert st["spec_tree_branch_accepts"] > 0  # rows really moved
        assert st["spec_tree_nodes"] >= st["spec_tree_rounds"]


@pytest.mark.parametrize("tree", [False, True])
def test_continuous_spec_forced_matches_jax_greedy(models, goldens,
                                                   monkeypatch, tree):
    _, tm = models
    _force_drafts(monkeypatch, goldens, tree)
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           prefix_cache=tree, speculative=4,
                           spec_width=4 if tree else 1, device="cpu")
    assert eng._spec_tree == tree
    outs = eng.run([(p, GEN) for p in PROMPTS])
    for got, want in zip(outs, goldens):
        np.testing.assert_array_equal(got, want)
    _check_ledger(eng.last_stats, tree)
    assert eng.audit() == []


def test_continuous_tree_warm_radix_matches_jax_greedy(models, goldens):
    """No forcing: a warm pass fills the radix tree, and on the re-ask the
    radix continuation and the n-gram proposal disagree, so real trees
    form; the tokens stay the plain greedy ones."""
    _, tm = models
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           prefix_cache=True, speculative=4, spec_width=4,
                           device="cpu")
    free0 = len(eng.pool.free)
    for _ in range(2):
        outs = eng.run([(p, GEN) for p in PROMPTS])
        for got, want in zip(outs, goldens):
            np.testing.assert_array_equal(got, want)
    st = eng.last_stats
    assert st["spec_tree_rounds"] > 0 and st["spec_accepted_tokens"] > 0
    assert st["spec_rollback_tokens"] == (st["spec_draft_tokens"]
                                          - st["spec_accepted_tokens"])
    assert eng.audit() == []
    assert len(eng.pool.free) + eng.prefix.node_count == free0


@pytest.mark.parametrize("tree", [False, True])
def test_engine_spec_forced_matches_jax_greedy(models, goldens, monkeypatch,
                                               tree):
    _, tm = models
    _force_drafts(monkeypatch, goldens, tree)
    eng = Engine(tm, paged=True, page_size=PAGE, prefix_cache=True,
                 speculative=4, spec_width=4 if tree else 1, device="cpu")
    for _ in range(2):  # the second serve walks the radix the first filled
        out = eng.serve(np.stack(PROMPTS), GEN, MAXLEN)
        for i, want in enumerate(goldens):
            np.testing.assert_array_equal(out[i, len(PROMPTS[i]):], want)
    _check_ledger(eng.last_stats, tree)
    assert eng.last_stats["decode_steps"] == eng.last_stats[
        "spec_decode_steps"]
    assert eng.audit() == []


def test_continuous_int8_spec_matches_jax_int8_engine(models):
    """tests/test_kv_quant.py's speculative case over an int8 pool: the
    port's tokens equal the JAX int8 speculative engine's, and the engine
    keeps width-1 chains (no row moves on an int8 pool)."""
    jm, tm = models
    rng = np.random.default_rng(42)
    prompt = np.tile(rng.integers(1, 200, size=8).astype(np.int32), 4)
    work = [(prompt, 5), (prompt[:20], 4)]
    kw = dict(max_batch=2, page_size=PAGE, max_length=MAXLEN,
              prefix_cache=True, speculative=3, kv_dtype="int8")
    want_eng = JaxContinuous(jm, **kw)
    want = want_eng.run(work)
    eng = ContinuousEngine(tm, device="cpu", **kw)
    assert not eng._spec_tree
    got = eng.run(work)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, wst = eng.last_stats, want_eng.last_stats
    for key in ("spec_verify_steps", "spec_draft_tokens",
                "spec_accepted_tokens", "decode_steps", "target_steps"):
        assert st[key] == wst[key], key
    assert st["spec_draft_tokens"] > 0 and st["spec_tree_rounds"] == 0
    assert eng.audit() == []
