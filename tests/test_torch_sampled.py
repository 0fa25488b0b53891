"""Sampled serving in the port (temperature, top-k, top-p) against the JAX
package, on the CPU.

The two packages' PRNGs differ (``jax.random`` keys against
``torch.Generator``s), so where a test can feed both sides the same
random numbers (numpy logits and Gumbel noise) it demands equal results,
and elsewhere it compares distributions:

- (a) ``filter_logits`` / ``target_probs`` against the JAX functions on
  seeded logits with ties: keep-sets equal, probabilities within 1e-6;
- (b) ``filtered_winner_plain`` (the plain version of the megakernel's
  in-kernel filter) against JAX ``filter_logits`` plus the noisy argmax
  on 600 seeded rows, enable 0, ``k >= V`` and ``p = 1`` included:
  both winners are an exact filter's (``chip_smoke.filter_band``: the
  noisy argmax over a keep-set between the top-p cut at p·Z·(1 - 1e-5)
  and at p·Z·(1 + 1e-5), where summation order decides), and at most 1%
  of the rows may differ;
- (c) Gumbel-max with the port's ``gumbel`` against JAX ``target_probs``:
  total variation < 0.02 on V=16 over 40000 draws;
- (d) the megakernel's plain sampled and filtered NS-step launch on the
  f32 ``tiny`` preset against the JAX ``decode_fn("xla")`` chain with the
  JAX host filter and the same noise: tokens equal;
- (e) both engines on ``tiny``, ``mode="xla"`` and ``"mega"``, mixed
  greedy and sampled batches: greedy requests emit the argmax of JAX's
  teacher-forced logits, every sampled token lies in the keep-set of
  JAX's teacher-forced logits (within 1e-4), the same seed replays the
  same tokens and another seed changes them, a filtered mega round runs
  in the kernel (``mega_filtered_rounds``) and at ``ns=1`` falls back;
  the int8 pool, int8 weights and speculation serve sampled requests;
- (f) ``verify_sampled`` and ``verify_tree_sampled`` keep the target
  distribution (the port's versions of the JAX tests).

The JAX oracles are jitted ``xla`` paths traced under
``portable_export()`` (the JAX package's plain references instead of
interpret-mode Pallas) and plain functions.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import sampling as jsampling
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    KVCache,
    PrefixCache,
    Qwen3,
    Request,
    get_config,
    params_from_jax,
    sampling,
)
from triton_distributed_tpu_torch.models import speculative as tspec
from triton_distributed_tpu_torch.models.speculative import (
    TreeDraft,
    verify_sampled,
    verify_tree_sampled,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

PAGE, MAXLEN, GEN = 16, 64, 10
# Keep-set tolerance of the engine checks: a sampled token must be kept
# by JAX's filter on JAX's teacher-forced logits, or lie within this of
# the lowest kept scaled logit (the two forwards differ by ~1e-6).
KEEP_TOL = 1e-4

_rng = np.random.default_rng(31)
_PREFIX = _rng.integers(0, 256, 20)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, n)]).astype(np.int32)
           for n in (6, 9, 4, 12)]


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


@functools.cache
def _chip_smoke():
    """``chip_smoke.py``, for its top-p sandwich ``filter_band``."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tied_logits(rng, rows: int, v: int) -> np.ndarray:
    """~N(0, 2²) logits, every other row rounded to halves (exact ties)."""
    lg = rng.standard_normal((rows, v)).astype(np.float32) * 2.0
    lg[::2] = np.round(lg[::2] * 2.0) / 2.0
    return lg


# -- (a) the host filter -------------------------------------------------------

@pytest.mark.parametrize("v", [7, 256, 1000])
def test_filter_and_target_probs_match_jax(v):
    rng = np.random.default_rng(v)
    logits = _tied_logits(rng, 6, v)
    for t, p, k in ((0.3, 1.0, 0), (0.7, 0.05, 0), (1.0, 0.9, 0),
                    (1.5, 1.0, 5), (0.8, 0.5, 50), (1.2, 0.95, v),
                    (1.0, 1.0, 1), (0.9, 0.999, 3)):
        want = np.asarray(jsampling.filter_logits(jnp.asarray(logits), t, p,
                                                  k))
        got = sampling.filter_logits(torch.from_numpy(logits), t, p,
                                     k).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        wp = np.asarray(jsampling.target_probs(jnp.asarray(logits), t, p, k))
        gp = sampling.target_probs(torch.from_numpy(logits), t, p, k).numpy()
        np.testing.assert_allclose(gp, wp, atol=1e-6, rtol=0)
    # temperature 0: one-hot at the (first) argmax on both sides.
    np.testing.assert_array_equal(
        sampling.target_probs(torch.from_numpy(logits), 0.0).numpy(),
        np.asarray(jsampling.target_probs(jnp.asarray(logits), 0.0)))


# -- (b) the megakernel's filter, plain version -----------------------------------

def _jax_filtered_winner(logits, noise, t, p, k):
    """JAX ``filter_logits`` + argmax of logits + noise over the kept
    columns; ``t <= 0`` keeps every column (the greedy row)."""
    if t > 0.0:
        kept = np.isfinite(np.asarray(jsampling.filter_logits(
            jnp.asarray(logits), t, p, k)))
    else:
        kept = np.ones(logits.shape, bool)
    score = np.where(kept, logits + noise, -np.inf)
    return np.argmax(score, axis=-1)


# (T, top_p, top_k): greedy (enable 0), unfiltered sampled (enable 0),
# k >= V and p = 1 (enable 0 through the window), top-k, top-p, both.
WINNER_CASES = [(0.0, 1.0, 0), (0.8, 1.0, 0), (1.0, 1.0, 10**6),
                (0.7, 1.0, 1), (1.3, 1.0, 5), (0.9, 1.0, 50),
                (1.0, 0.9, 0), (0.6, 0.5, 0), (1.5, 0.05, 0),
                (1.1, 0.95, 40), (0.5, 0.8, 3), (1.0, 0.999, 0)]


@pytest.mark.parametrize("v", [7, 256, 1000])
def test_filtered_winner_matches_jax_filter(v):
    """600 rows (200 per V) through ``filtered_winner_plain`` with the
    vocab padded to a multiple of 8 (as the kernel sees it): the winner
    equals JAX's filter plus noisy argmax on the same noise, and both are
    an exact filter's where the top-p cut is a near tie of sums."""
    rng = np.random.default_rng(100 + v)
    vp = -(-v // 8) * 8
    per = -(-200 // len(WINNER_CASES))
    boundary = mismatched = rows = 0
    for t, p, k in WINNER_CASES:
        logits = _tied_logits(rng, per, v)
        noise = (max(t, 0.0) * rng.gumbel(size=(per, v))).astype(np.float32)
        want = _jax_filtered_winner(logits, noise, t, p, min(k, v))
        pad = lambda a: np.pad(a, ((0, 0), (0, vp - v)))  # noqa: E731
        cfg = torch.tensor([sampling.sampcfg_row(t, p, k, v)] * per)
        lg_t, nz_t = torch.from_numpy(pad(logits)), torch.from_numpy(
            pad(noise))
        got = sampling.filtered_winner_plain(lg_t, nz_t, cfg, v).numpy()
        bands = _chip_smoke().filter_band(lg_t, nz_t, cfg, v)
        for b, bd in enumerate(bands):
            assert {int(got[b]), int(want[b])} <= bd["winners"], (
                t, p, k, b, got[b], want[b], bd)
        mismatched += int((got != want).sum())
        boundary += sum(len(bd["winners"]) > 1 for bd in bands)
        rows += per
    assert rows >= 200
    assert mismatched <= rows // 100, mismatched
    print(f"V={v}: {rows} rows, {boundary} with two winners in the top-p "
          f"band, {mismatched} winners differ (all within it)")


def test_sampcfg_rows_and_gumbel_are_finite():
    v = 100
    assert sampling.sampcfg_row(0.0, 0.3, 7, v) == [1.0, 7.0, 0.3, 0.0]
    assert sampling.sampcfg_row(0.0, 1.0, 0, v) == [1.0, v, 1.0, 0.0]
    assert sampling.sampcfg_row(0.5, 1.0, 0, v) == [2.0, v, 1.0, 0.0]
    assert sampling.sampcfg_row(0.5, 1.0, v, v) == [2.0, v, 1.0, 0.0]
    assert sampling.sampcfg_row(0.5, 0.0, 7, v) == [2.0, 7.0, 1e-6, 1.0]
    g = sampling.gumbel((4, 1 << 16), torch.Generator().manual_seed(1), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    again = sampling.gumbel((4, 1 << 16), torch.Generator().manual_seed(1),
                            "cpu")
    assert torch.equal(g, again)
    assert sampling.mix64(5, 0) != sampling.mix64(5, 1) != sampling.mix64(6, 1)
    assert 0 <= sampling.mix64(2**62, 7) < 2**64


# -- (c) Gumbel-max draws ----------------------------------------------------------

@pytest.mark.parametrize("t,p,k", [(0.8, 1.0, 0), (1.2, 0.8, 6)])
def test_gumbel_max_draws_follow_jax_target_probs(t, p, k):
    v, n = 16, 40000
    logits = np.random.default_rng(9).standard_normal(v).astype(np.float32)
    want = np.asarray(jsampling.target_probs(jnp.asarray(logits), t, p, k),
                      np.float64)
    gen = torch.Generator().manual_seed(3)
    noise = t * sampling.gumbel((n, v), gen, "cpu")
    lg = torch.from_numpy(logits)[None].expand(n, v)
    cfg = torch.tensor([sampling.sampcfg_row(t, p, k, v)] * n)
    toks = sampling.filtered_winner_plain(lg, noise, cfg, v).numpy()
    emp = np.bincount(toks, minlength=v) / n
    assert set(np.flatnonzero(emp)) <= set(np.flatnonzero(want > 0))
    tv = np.abs(emp - want).sum() / 2
    assert tv < 0.02, tv


# -- (d) the megakernel's plain sampled / filtered launch ------------------------

B4, NS3 = 4, 3
# Per row (T, top_p, top_k): greedy, top-k, top-p, both.
MEGA_ROWS = {
    "sampled": [(0.0, 1.0, 0), (0.8, 1.0, 0), (0.5, 1.0, 0), (1.2, 1.0, 0)],
    "filtered": [(0.0, 1.0, 0), (0.8, 1.0, 5), (1.0, 0.9, 0), (0.7, 0.8, 20)],
}


@pytest.fixture(scope="module")
def filled(models):
    """The JAX xla step and a dense cache after three of its steps over a
    4-row batch."""
    jm, _ = models
    cache = jm.new_cache(B4, MAXLEN)
    step = jm.decode_fn("xla")
    with portable_export():
        for tok in ([3, 5, 7, 9], [11, 13, 17, 19], [23, 29, 31, 37]):
            _, cache = step(jm.params, jnp.asarray(tok, jnp.int32), cache)
    return step, jax.tree.map(np.array, cache)


@pytest.mark.parametrize("kind", ["sampled", "filtered"])
def test_mega_sampled_launch_matches_jax_chain(models, filled, kind):
    jm, tm = models
    step, filled = filled
    rows = MEGA_ROWS[kind]
    V = tm.cfg.vocab_size
    mega = MegaQwen3(tm, cfg=MegaConfig(fuse_norms=True))
    v_pad = mega._dims(B4, MAXLEN).v_loc
    temps = np.asarray([t for t, _, _ in rows], np.float32)
    rng = np.random.default_rng(17)
    noise = (temps[None, :, None]
             * rng.gumbel(size=(NS3, B4, v_pad))).astype(np.float32)
    tok0 = np.asarray([41, 43, 47, 53], np.int32)

    cache = jax.tree.map(jnp.asarray, filled)
    t = jnp.asarray(tok0)
    want = []
    for i in range(NS3):
        with portable_export():
            lg, cache = step(jm.params, t, cache)
        lg = np.asarray(lg)
        t = np.asarray([_jax_filtered_winner(
            lg[b], noise[i, b, :V], *rows[b]) for b in range(B4)], np.int32)
        want.append(t.tolist())
        t = jnp.asarray(t)

    filt = kind == "filtered"
    fn = mega.decode_multi_fn(B4, MAXLEN, NS3, sampled=True, filtered=filt)
    extra = [torch.from_numpy(noise)]
    if filt:
        extra.append(torch.tensor([sampling.sampcfg_row(*r, V)
                                   for r in rows]))
    port_cache = KVCache(k=torch.from_numpy(filled.k.copy()),
                         v=torch.from_numpy(filled.v.copy()),
                         kv_len=torch.from_numpy(filled.kv_len.copy()))
    toks, logits, _ = fn(tm.params, torch.from_numpy(tok0), port_cache,
                         *extra)
    assert toks.tolist() == want
    assert torch.isfinite(logits).all()
    # The greedy row's noise is zero: its stream is the greedy launch's.
    greedy = mega.decode_multi_fn(B4, MAXLEN, NS3)
    port_cache = KVCache(k=torch.from_numpy(filled.k.copy()),
                         v=torch.from_numpy(filled.v.copy()),
                         kv_len=torch.from_numpy(filled.kv_len.copy()))
    gtoks = greedy(tm.params, torch.from_numpy(tok0), port_cache)[0]
    assert toks[:, 0].tolist() == gtoks[:, 0].tolist()


def test_mega_sampled_operands_are_checked(models):
    _, tm = models
    mega = MegaQwen3(tm)
    cache = tm.new_cache(2, MAXLEN)
    v_pad = mega._dims(2, MAXLEN).v_loc
    fn = mega.decode_multi_fn(2, MAXLEN, 2, sampled=True)
    with pytest.raises(ValueError, match="noise"):
        fn(tm.params, torch.tensor([1, 2]), cache,
           torch.zeros(2, 2, v_pad - 8))
    with pytest.raises(ValueError, match="filtered"):
        mega.build_multi(2, MAXLEN, 2, filtered=True)


# -- (e) the engines ------------------------------------------------------------

TF_ROWS, TF_WIDTH = 8, 32  # one JAX program shape for every check


def _teacher_forced(jm, pairs) -> list[np.ndarray]:
    """JAX logits [gen, V] at every generated position of each ``(prompt,
    tokens)`` pair: one batched prefill, then one decode step per
    generated token, each row fed its own stream."""
    assert len(pairs) <= TF_ROWS
    n, s = TF_ROWS, TF_WIDTH
    g = max(len(o) for _, o in pairs)
    ids = np.zeros((n, s), np.int32)
    lens = np.ones(n, np.int32)
    feed = np.zeros((n, g), np.int32)
    for i, (p, o) in enumerate(pairs):
        ids[i, : len(p)] = p
        lens[i] = len(p)
        feed[i, : len(o)] = o
    with portable_export():
        logits, cache = jm.prefill_batched(jnp.asarray(ids), jm.new_cache(
            n, MAXLEN), "xla", jnp.asarray(lens))
        rows = [np.asarray(logits)]
        for j in range(g - 1):
            logits, cache = jm.decode_step(jnp.asarray(feed[:, j]), cache,
                                           "xla")
            rows.append(np.asarray(logits))
    steps = np.stack(rows, axis=1)  # [n, g, V]
    return [steps[i, : len(o)] for i, (_, o) in enumerate(pairs)]


def _check_tokens(jm, cases):
    """``cases``: ``(prompt, tokens, (T, top_p, top_k))``. Greedy tokens
    are JAX's teacher-forced argmax; sampled ones lie in the keep-set of
    JAX's filter over those logits (within KEEP_TOL). Returns how many
    tokens were checked."""
    ref = _teacher_forced(jm, [(p, o) for p, o, _ in cases])
    n = 0
    for (p, o, (t, tp, tk)), lg in zip(cases, ref):
        o = np.asarray(o)
        if t <= 0.0:
            np.testing.assert_array_equal(o, lg.argmax(-1))
        else:
            kept = np.isfinite(np.asarray(jsampling.filter_logits(
                jnp.asarray(lg), t, tp, tk)))
            ls = lg / np.float32(t)
            floor = np.where(kept, ls, np.inf).min(-1)
            got = ls[np.arange(len(o)), o]
            assert (kept[np.arange(len(o)), o]
                    | (got >= floor - KEEP_TOL)).all(), (t, tp, tk)
        n += len(o)
    return n


# Engine defaults (T 0.8, top_p 0.95, top_k 8) and per-request overrides:
# greedy, the defaults (filtered), unfiltered sampled, top-k 3.
CONT_KNOBS = dict(temperature=0.8, top_p=0.95, top_k=8)
CONT_OVERRIDES = [dict(temperature=0.0), {}, dict(top_p=1.0, top_k=0),
                  dict(top_k=3)]


def _cont_requests():
    return [Request(p, GEN, **kw) for p, kw in zip(PROMPTS, CONT_OVERRIDES)]


def _effective(kw):
    eff = {**CONT_KNOBS, **kw}
    return eff["temperature"], eff["top_p"], eff["top_k"]


def _run_cont(tm, seed, **kw):
    eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE, max_length=MAXLEN,
                           prefix_cache=True, seed=seed, device="cpu",
                           **CONT_KNOBS, **kw)
    out = eng.run(_cont_requests())
    assert eng.audit() == []
    return out, eng.last_stats


@pytest.mark.parametrize("mode", ["xla", "mega"])
def test_continuous_sampled_mixed_batch(models, mode):
    jm, tm = models
    kw = dict(mode=mode, ns=4) if mode == "mega" else {}
    a, st = _run_cont(tm, 5, **kw)
    b, _ = _run_cont(tm, 5, **kw)
    c, _ = _run_cont(tm, 6, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # Another seed changes some sampled request; the greedy one stays.
    np.testing.assert_array_equal(a[0], c[0])
    assert any(not np.array_equal(x, y) for x, y in zip(a[1:], c[1:]))
    cases = [(p, o, _effective(kw_)) for p, o, kw_ in
             zip(PROMPTS, a, CONT_OVERRIDES)]
    cases += [(p, o, _effective(kw_)) for p, o, kw_ in
              zip(PROMPTS, c, CONT_OVERRIDES)]
    assert _check_tokens(jm, cases) == 8 * GEN
    if mode == "mega":
        assert st["mega_launches"] > 0 and st["mega_filtered_rounds"] > 0
        assert st["mega_fallback_steps"] == 0


def test_continuous_request_draws_do_not_depend_on_the_batch(models):
    """A request's draws are a function of its seed and draw counter: the
    same request alone, or beside another, emits the same tokens when its
    seed is the same."""
    _, tm = models
    outs = []
    for others in ([], [Request(PROMPTS[1], GEN, temperature=1.0)]):
        req = Request(PROMPTS[0], GEN, temperature=0.9, top_k=6)
        req.key = 1234  # a fixed request seed
        eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                               max_length=MAXLEN, device="cpu")
        outs.append(eng.run([req, *others])[0])
        assert req.key_step == GEN
    np.testing.assert_array_equal(outs[0], outs[1])


def test_mega_filtered_ns1_falls_back(models):
    _, tm = models
    eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE, max_length=MAXLEN,
                           mode="mega", ns=1, seed=2, device="cpu",
                           **CONT_KNOBS)
    eng.run(_cont_requests())
    st = eng.last_stats
    assert st["mega_launches"] == 0 and st["mega_filtered_rounds"] == 0
    assert st["mega_fallback_steps"] == st["decode_steps"] > 0
    # Unfiltered sampling still launches at ns=1.
    eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE, max_length=MAXLEN,
                           mode="mega", ns=1, temperature=0.7, device="cpu")
    eng.run([(p, 4) for p in PROMPTS])
    assert eng.last_stats["mega_launches"] > 0
    fixed = Engine(tm, mode="mega", temperature=0.8, top_k=8, device="cpu")
    fixed.serve(np.stack([p[:24] for p in PROMPTS[:2]]), 6, MAXLEN, ns=1)
    assert fixed.last_stats["mega_launches"] == 0


@pytest.mark.parametrize("mode,paged", [("xla", False), ("xla", True),
                                        ("mega", False), ("mega", True)])
def test_engine_sampled(models, mode, paged):
    jm, tm = models
    ids = np.stack([PROMPTS[0][:24], PROMPTS[1][:24]])
    knobs = (0.7, 0.9, 8)

    def serve(seed):
        eng = Engine(tm, mode=mode, paged=paged, page_size=PAGE,
                     temperature=knobs[0], top_p=knobs[1], top_k=knobs[2],
                     seed=seed, device="cpu")
        out = eng.serve(ids, GEN, MAXLEN, ns=4)
        return out, eng.last_stats

    a, st = serve(3)
    b, _ = serve(3)
    c, _ = serve(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    cases = [(ids[i], out[i, 24:], knobs) for out in (a, c) for i in (0, 1)]
    assert _check_tokens(jm, cases) == 4 * GEN
    if mode == "mega":
        assert st["mega_launches"] == 2 and st["mega_filtered_rounds"] == 2


@pytest.mark.parametrize("kv_dtype,wq8", [("int8", False), (None, True),
                                          ("int8", True)])
def test_mega_sampled_int8_pool_and_wq8(models, kv_dtype, wq8):
    """Sampled mega serving over an int8 pool and from int8 weights: the
    greedy request emits what the greedy engine emits on the same path,
    sampled requests replay under their seed, and rounds filter in the
    kernel."""
    _, tm = models
    cfg = MegaConfig(fuse_norms=True, wq8=wq8)

    def run(**kw):
        eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE,
                               max_length=MAXLEN, mode="mega", ns=4,
                               kv_dtype=kv_dtype, mega_cfg=cfg, device="cpu",
                               **kw)
        return eng.run(_cont_requests()), eng.last_stats

    a, st = run(seed=1, **CONT_KNOBS)
    b, _ = run(seed=1, **CONT_KNOBS)
    greedy, _ = run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[0], greedy[0])
    assert st["mega_filtered_rounds"] > 0
    assert all(((o >= 0) & (o < tm.cfg.vocab_size)).all() for o in a)


def test_speculative_sampled(models, monkeypatch):
    """Sampled speculation (T 0.05, top-k 3): the drafters propose each
    prompt's greedy continuation, so drafts are accepted and rolled back
    under the sampled rule; tokens stay in JAX's keep-set and replay
    under the seed, through both engines."""
    jm, tm = models
    ids = np.stack([p[:24] for p in PROMPTS])
    prompts = PROMPTS + list(ids)
    greedy = ContinuousEngine(tm, max_batch=4, page_size=PAGE,
                              max_length=MAXLEN, device="cpu").run(
                                  [(p, GEN) for p in prompts])
    fulls = [list(p) + [int(t) for t in g] for p, g in zip(prompts, greedy)]

    def propose(self, budget):
        hist = [int(t) for t in self.draft.history]
        for full in fulls:
            if full[: len(hist)] == hist:
                return full[len(hist): len(hist) + min(self.k, int(budget))]
        return []

    monkeypatch.setattr(tspec.SpecState, "propose", propose)
    knobs = (0.05, 1.0, 3)

    def run(seed):
        eng = ContinuousEngine(tm, max_batch=4, page_size=PAGE,
                               max_length=MAXLEN, speculative=4, seed=seed,
                               temperature=knobs[0], top_k=knobs[2],
                               device="cpu")
        return eng.run([(p, GEN) for p in PROMPTS]), eng.last_stats

    a, st = run(7)
    b, _ = run(7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert st["spec_accepted_tokens"] > 0
    assert st["spec_rollback_tokens"] == (st["spec_draft_tokens"]
                                          - st["spec_accepted_tokens"])
    fixed = Engine(tm, paged=True, page_size=PAGE, speculative=4, seed=7,
                   temperature=knobs[0], top_k=knobs[2], device="cpu")
    out = fixed.serve(ids, GEN, MAXLEN)
    assert fixed.last_stats["spec_accepted_tokens"] > 0
    cases = [(p, o, knobs) for p, o in zip(PROMPTS, a)]
    cases += [(ids[i], out[i, 24:], knobs) for i in range(len(ids))]
    assert _check_tokens(jm, cases) == 8 * GEN


# -- (f) sampled verification keeps the target distribution --------------------

def test_verify_sampled_preserves_target_distribution():
    """With a fixed draft token, the first emitted token's empirical law
    over many generators matches the filtered target, and a delta
    proposal is accepted with probability p(d)."""
    rng = np.random.default_rng(0)
    v = 8
    logits = torch.from_numpy(np.asarray(rng.normal(size=(2, v)) * 1.5,
                                         np.float32))
    t, p, k = 0.9, 0.95, 6
    target = np.asarray(jsampling.target_probs(jnp.asarray(logits[0].numpy()),
                                               t, p, k), np.float64)
    draft_tok = int(np.argsort(target)[-2])  # plausible but not the argmax
    n = 4000
    counts = np.zeros(v, np.int64)
    accepted = 0
    for i in range(n):
        gen = torch.Generator().manual_seed(i)
        a, nxt = verify_sampled(logits, [draft_tok], gen, t, p, k)
        counts[draft_tok if a >= 1 else nxt] += 1
        accepted += a
    emp = counts / n
    assert np.abs(emp - target).sum() / 2 < 0.05  # total variation
    assert accepted / n == pytest.approx(float(target[draft_tok]), abs=0.04)


def test_verify_sampled_rejects_zero_probability_draft():
    logits = torch.full((2, 8), -50.0)
    logits[:, 3] = 50.0
    for i in range(16):
        a, nxt = verify_sampled(logits, [6], torch.Generator().manual_seed(i),
                                1.0)
        assert a == 0 and nxt == 3


def test_verify_tree_sampled_matches_target_distribution():
    """Each emitted token is drawn from its own node's target before any
    match, so the first token's law is ``target_probs(logits[0])`` and
    two different trees under the same generators draw the same first
    token."""
    rng = np.random.default_rng(7)
    t, p, k = 0.8, 0.9, 5
    wide = TreeDraft(5)
    wide.add_path([1, 2])
    wide.add_path([3, 4])
    wide.add_path([6])
    narrow = TreeDraft(5)
    narrow.add_path([2, 2])
    logits = torch.from_numpy(rng.normal(size=(len(wide), 8)).astype(
        np.float32) * 2.0)
    probs = np.asarray(jsampling.target_probs(jnp.asarray(logits[0].numpy()),
                                              t, p, k), np.float64)
    n = 1200
    first, first_narrow = [], []
    for i in range(n):
        for tree, lg, out in ((wide, logits, first),
                              (narrow, logits[: len(narrow)], first_narrow)):
            seeds = iter(range(4 * i, 4 * i + 4))
            _, em = verify_tree_sampled(
                lg, tree,
                lambda: torch.Generator().manual_seed(next(seeds)), t, p, k)
            out.append(em[0])
    emp = np.bincount(first, minlength=8) / n
    assert set(np.flatnonzero(emp)) <= set(np.flatnonzero(probs > 0))
    assert np.abs(emp - probs).sum() / 2 < 0.05
    assert first == first_narrow
