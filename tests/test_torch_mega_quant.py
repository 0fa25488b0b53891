"""The port's megakernel over the int8 KV pool and with int8 weights (wq8),
and the tier fingerprint, against the JAX package, on the CPU.

On the CPU the megakernel runs its plain version
(``megakernel/kernels.py``), the function the CUDA kernel is held
against on the card (``tests/test_torch_cuda.py``). On the f32 ``tiny``
preset:

- the quantized ``append_n`` writes the JAX ``append_n``'s codes and
  scales bit for bit (NS = 4, a page crossing, an offset-0 reset,
  ``n_valid`` trash routing) and equals NS single-step appends;
- the port's int8 weights and scales equal the JAX
  ``quantized_params()`` bit for bit, and carry across;
- single-step ``mega`` decode over an int8 pool emits the JAX int8
  ``xla`` step's tokens, step for step (pools within one code unit);
  an NS = 4 launch emits NS chained single steps' tokens;
- ``wq8`` logits are within rtol = atol = 2e-3 of the JAX ``xla`` step
  over the dequantized weights (``w8 * s``), and a multi-step launch
  emits that golden's greedy chain;
- both engines with ``kv_dtype="int8"``, ``mode="mega"``, NS 1 and 4,
  with and without ``wq8``, emit the JAX int8 engines' tokens (under
  ``wq8`` the JAX engines decode over the dequantized weights and
  prefill with the model's own, the JAX mega engines' split);
- the tier fingerprint equals the JAX package's, and a prefix page a JAX
  engine spilled into a ``tier_dir`` faults back into the port's engine.

The JAX engines here run under ``portable_export()`` (the JAX plain
references, the arithmetic of the port's CPU path), and the JAX
megakernel itself never runs: its golden is the JAX ``xla`` path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel.code_generator import (
    MegaConfig as JaxMegaConfig,
)
from triton_distributed_tpu.megakernel.qwen3 import MegaQwen3 as JaxMegaQwen3
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import paged_kv_cache as jpk
from triton_distributed_tpu.models.continuous import (
    _model_fingerprint as jax_fingerprint,
)
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import (
    MegaConfig,
    MegaQwen3,
    Q8Params,
)
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    KVCache,
    PrefixCache,
    Qwen3,
    get_config,
    params_from_jax,
    q8_params_from_jax,
)
from triton_distributed_tpu_torch.models import paged_kv_cache as tpk
from triton_distributed_tpu_torch.models.continuous import _model_fingerprint

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

PAGE, MAXLEN = 16, 64
# One int8 code unit of a unit-scale page (amax/127 with amax ~ 4): rows
# computed by two paths may round to adjacent codes.
POOL_ATOL = 0.06
WQ8_TOL = 2e-3

_rng = np.random.default_rng(31)
_PREFIX = _rng.integers(0, 256, 16)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, n)]).astype(
    np.int32) for n in (6, 9, 4)]
GEN = 9
REQS = [(p, GEN) for p in PROMPTS]
IDS = np.stack([p[:20] for p in PROMPTS])


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


def _jax_q8(jm):
    return JaxMegaQwen3(jm, cfg=JaxMegaConfig(wq8=True)).quantized_params()


def _dequantized(jm, qp):
    """The JAX golden's weights: ``w8 * s`` rounded to the model dtype
    (tests/test_megakernel.py's wq8 golden at tp=1)."""
    dt = jm.cfg.dtype

    def deq(w8, s):
        return (w8.astype(jnp.float32) * s).astype(dt)

    lp = jm.params.layers
    return dataclasses.replace(
        jm.params,
        layers=dataclasses.replace(
            lp,
            attn=dataclasses.replace(lp.attn, wqkv=deq(qp.wqkv, qp.sc_qkv),
                                     wo=deq(qp.wo, qp.sc_o)),
            mlp=dataclasses.replace(lp.mlp, w1=deq(qp.w1, qp.sc_w1),
                                    w2=deq(qp.w2, qp.sc_w2)),
        ),
        lm_head=deq(qp.lm_head, qp.sc_lm),
    )


# -- the tier fingerprint -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprint_equals_jax(models, dtype):
    """The same weights give the same fingerprint in both packages (leaf
    order, dtype names, native-dtype samples); a changed weight changes
    it."""
    jm, tm = models
    if dtype == "bfloat16":
        jm = JaxAutoLLM.from_pretrained("tiny", ctx=jm.ctx, seed=0,
                                        dtype=jnp.bfloat16)
        tm = Qwen3(get_config("tiny", dtype=torch.bfloat16), device="cpu")
        tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params)))
        assert tm.params["embed"].dtype == torch.bfloat16
    want = jax_fingerprint(jm)
    assert _model_fingerprint(tm) == want
    other = Qwen3(tm.cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jm.params))
    params["lm_head"][0, 0] += 1.0
    other.set_params(params)
    assert _model_fingerprint(other) != want


def test_jax_tier_dir_faults_into_port(models, tmp_path):
    """A prefix page the JAX engine spilled into a ``tier_dir`` faults
    back into the port's engine over the same directory: the port reads
    the JAX entries as its own weights' (equal fingerprints) and emits
    the JAX tokens."""
    jm, tm = models
    rng = np.random.default_rng(12)
    a, b = (rng.integers(1, 200, 48).astype(np.int32) for _ in range(2))
    kw = dict(max_batch=1, page_size=PAGE, max_length=MAXLEN, num_pages=4,
              prefix_cache=True, tier_dir=str(tmp_path))
    jeng = JaxContinuous(jm, **kw)
    with portable_export():
        want = jeng.run([(a, 4), (b, 4)])
    assert jeng.last_stats["tier_spilled_pages"] > 0
    eng = ContinuousEngine(tm, device="cpu", **kw)
    got = eng.run([(a, 4)])
    np.testing.assert_array_equal(got[0], want[0])
    stats = eng.last_stats
    assert stats["tier_faults"] > 0 and stats["tier_hits"] > 0
    assert stats["tier"]["disk_hits"] > 0
    assert eng.audit() == []


# -- the quantized append -----------------------------------------------------


def _int8_pools(rng, L, P, H, page, hd):
    """Two int8 pools (codes, scales as numpy) quantized from ~N(0, 1)."""
    out = []
    for _ in range(2):
        x = torch.from_numpy(
            rng.standard_normal((L, P, H, page, hd)).astype(np.float32))
        codes, scales = tpk.quantize_pages(x)
        out += [codes.numpy(), scales.numpy()]
    return out


@pytest.mark.parametrize("kv_len,n_valid", [
    ([2, 4], None),     # row 0 crosses a page (offset-0 reset), row 1
                        # starts on a fresh page
    ([7, 9], [4, 1]),   # row 1's last three rows go to the trash page
    ([0, 11], [2, 4]),  # row 0 writes page offset 0 of its first page
])
def test_quantized_append_n_matches_jax(kv_len, n_valid):
    L, B, H, NS, page, hd, P = 2, 2, 2, 4, 4, 8, 10
    rng = np.random.default_rng(sum(kv_len))
    kp, ks, vp, vs = _int8_pools(rng, L, P, H, page, hd)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = np.asarray(kv_len, np.int32)
    # Row magnitudes grow step by step, so every append grows a scale and
    # re-quantizes the rows before it: the order-sensitive case.
    k_new = (rng.standard_normal((L, B, H, NS, hd))
             * 2.0 ** np.arange(NS)[None, None, None, :, None]).astype(
                 np.float32)
    v_new = rng.standard_normal((L, B, H, NS, hd)).astype(np.float32)

    def port_cache():
        return tpk.PagedKVCache(
            k_pages=torch.from_numpy(kp.copy()),
            v_pages=torch.from_numpy(vp.copy()),
            page_table=torch.from_numpy(table), kv_len=torch.from_numpy(lens),
            k_scale=torch.from_numpy(ks.copy()),
            v_scale=torch.from_numpy(vs.copy()))

    jcache = jpk.PagedKVCache(
        k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp),
        page_table=jnp.asarray(table), kv_len=jnp.asarray(lens),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    nv = None if n_valid is None else np.asarray(n_valid, np.int32)
    want = jax.jit(jpk.append_n)(
        jcache, jnp.asarray(k_new), jnp.asarray(v_new),
        None if nv is None else jnp.asarray(nv))
    got = tpk.append_n(port_cache(), torch.from_numpy(k_new),
                       torch.from_numpy(v_new), nv)
    # Page 0 (the trash page) aside: rows routed there land in any order.
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:, 1:],
                                      np.asarray(getattr(want, name))[:, 1:],
                                      err_msg=name)
    assert got.kv_len.tolist() == np.asarray(want.kv_len).tolist()
    if n_valid is None:
        # NS single-step appends leave the same pool, page 0 included.
        seq = port_cache()
        for s in range(NS):
            seq = tpk.append(seq, torch.from_numpy(k_new[:, :, :, s]),
                             torch.from_numpy(v_new[:, :, :, s]))
        for name in ("k_pages", "v_pages", "k_scale", "v_scale", "kv_len"):
            assert torch.equal(getattr(got, name), getattr(seq, name)), name


# -- int8 weights -------------------------------------------------------------


def test_wq8_params_match_jax(models):
    jm, tm = models
    want = _jax_q8(jm)
    mega = MegaQwen3(tm, cfg=MegaConfig(wq8=True))
    got = mega.quantized_params()
    assert mega.quantized_params() is got  # cached on the instance
    assert mega._step_params() is got
    carried = q8_params_from_jax(jax.tree.map(np.asarray, want))
    for f in dataclasses.fields(Q8Params):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert g.numpy().dtype == w.dtype, f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
        assert torch.equal(getattr(carried, f.name), g), f.name
    assert got.wqkv.dtype == torch.int8 and got.sc_qkv.dtype == torch.float32


def test_wq8_synthetic_init_runs_without_params():
    """``quantized_init`` makes int8 weights on a model without
    parameters; a single step and an NS = 3 launch over them agree."""
    model = Qwen3(get_config("tiny"), device="cpu")
    mega = MegaQwen3(model, cfg=MegaConfig(wq8=True, fuse_norms=True))
    qp = mega.quantized_init(torch.Generator().manual_seed(3))
    assert mega.quantized_params() is qp and qp.wqkv.dtype == torch.int8
    assert int(qp.wqkv.min()) >= -127 and int(qp.wqkv.max()) <= 127
    with pytest.raises(ValueError, match="params"):
        MegaQwen3(model)  # only wq8 decodes without the model's params
    full = Qwen3(get_config("tiny"), device="cpu")
    full.init_params(0)
    with pytest.raises(ValueError, match="wq8"):
        MegaQwen3(full).quantized_init(torch.Generator())
    cache = model.new_cache(2, MAXLEN)
    tok = torch.tensor([5, 9], dtype=torch.int32)
    chain = []
    step = mega.decode_fn(2, MAXLEN)
    c = KVCache(k=cache.k.clone(), v=cache.v.clone(),
                kv_len=cache.kv_len.clone())
    t = tok
    for _ in range(3):
        logits, c = step(qp, t, c)
        assert torch.isfinite(logits).all()
        t = logits.argmax(-1).to(torch.int32)
        chain.append(t.tolist())
    toks, _, _ = mega.decode_multi_fn(2, MAXLEN, 3)(qp, tok, cache)
    assert toks.tolist() == chain


def _jax_dense_prefilled(jm):
    cache = jm.new_cache(1, MAXLEN)
    toks = jnp.asarray(np.arange(16) % jm.cfg.vocab_size, jnp.int32)
    logits, cache = jm.prefill(toks, cache, "xla")
    return jnp.argmax(logits)[None].astype(jnp.int32), cache


def _to_port_dense(jcache) -> KVCache:
    leaves = jax.tree.map(np.array, jcache)
    return KVCache(k=torch.from_numpy(leaves.k), v=torch.from_numpy(leaves.v),
                   kv_len=torch.from_numpy(leaves.kv_len))


def test_wq8_logits_match_dequant_golden(models):
    """One ``wq8`` step against the JAX ``xla`` step over the dequantized
    weights (the same math up to where the scale is multiplied in), and
    an NS = 3 launch against that golden's greedy chain."""
    jm, tm = models
    gold = _dequantized(jm, _jax_q8(jm))
    tok0, jcache = _jax_dense_prefilled(jm)
    gold_step = jax.jit(jm.decode_fn("xla"))
    clone = lambda c: jax.tree.map(jnp.copy, c)  # noqa: E731
    lg_gold, _ = gold_step(gold, tok0, clone(jcache))
    mega = MegaQwen3(tm, cfg=MegaConfig(wq8=True))
    qp = mega.quantized_params()
    tok0_t = torch.from_numpy(np.array(tok0))
    lg, _ = mega.decode_fn(1, MAXLEN)(qp, tok0_t, _to_port_dense(jcache))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_gold),
                               rtol=WQ8_TOL, atol=WQ8_TOL)
    tok, c, ref = tok0, clone(jcache), []
    for _ in range(3):
        lg_g, c = gold_step(gold, tok, c)
        tok = jnp.argmax(lg_g, -1).astype(jnp.int32)
        ref.append(int(tok[0]))
    toks, _, _ = mega.decode_multi_fn(1, MAXLEN, 3)(
        qp, tok0_t, _to_port_dense(jcache))
    assert toks[:, 0].tolist() == ref


# -- the int8 pool ------------------------------------------------------------


def _filled_pools(tm):
    """The JAX megakernel tests' warm pools (``_warm_pools``): three greedy
    ``xla`` steps from [3, 5], [7, 11], [13, 17] into a dense cache, each
    row written into an int8 pool (page 16) by ``write_prefill``; returned
    for the port and, bit for bit the same, for JAX."""
    cache = tm.new_cache(2, MAXLEN)
    for toks in ([3, 5], [7, 11], [13, 17]):
        _, cache = tm.decode_step(torch.tensor(toks, dtype=torch.int32),
                                  cache)
    port, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                   page_size=PAGE, kv_dtype="int8")
    for b in range(2):
        tpk.write_prefill(port, b, cache.k[:, b:b + 1], cache.v[:, b:b + 1],
                          int(cache.kv_len[b]))
    leaves = {f.name: jnp.asarray(getattr(port, f.name).numpy())
              for f in dataclasses.fields(port)}
    return port, jpk.PagedKVCache(**leaves)


def _clone_pool(c):
    return dataclasses.replace(c, **{
        f.name: getattr(c, f.name).clone()
        for f in dataclasses.fields(c)})


def _pools_close(a, b):
    for x, y in zip(tpk.as_dense(a), tpk.as_dense(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=POOL_ATOL,
                                   rtol=0)
    assert a.kv_len.tolist() == b.kv_len.tolist()


def test_int8_single_step_matches_jax_xla(models):
    """Greedy single-step ``mega`` over the int8 pool against the JAX int8
    ``xla`` step, step for step (tests/test_megakernel.py's int8 parity
    test): the same tokens; pools within one code unit (both append
    through the one scale protocol, from rows two different computations
    produced)."""
    jm, tm = models
    pc, jc = _filled_pools(tm)
    mega = MegaQwen3(tm)
    tm_tok = tx = np.asarray([19, 23], np.int32)
    with portable_export():
        for _ in range(6):
            lg_m, pc = mega.decode_step(torch.from_numpy(tm_tok), pc)
            lg_x, jc = jm.decode_step(jnp.asarray(tx), jc, "xla")
            tm_tok = lg_m.argmax(-1).to(torch.int32).numpy()
            tx = np.asarray(jnp.argmax(lg_x, -1).astype(jnp.int32))
            np.testing.assert_array_equal(tm_tok, tx)
    _pools_close(pc, tpk.cache_from_jax(jax.tree.map(np.array, jc), "cpu"))


def test_int8_ns_launch_matches_chained_steps(models):
    """An NS = 4 launch over the int8 pool emits the tokens of four chained
    single-step launches; the pools end within one code unit (the launch
    attends its own rows at full precision, the chained steps re-read
    them quantized) with equal kv_len."""
    jm, tm = models
    pc, _ = _filled_pools(tm)
    multi = _clone_pool(pc)
    mega = MegaQwen3(tm, cfg=MegaConfig(fuse_norms=True))
    tok0 = torch.tensor([19, 23], dtype=torch.int32)
    t, ref = tok0, []
    for _ in range(4):
        lg, pc = mega.decode_step(t, pc)
        t = lg.argmax(-1).to(torch.int32)
        ref.append(t.tolist())
    fn = mega.decode_multi_fn(2, MAXLEN, 4, page=PAGE, kv_quant=True,
                              num_pages=int(multi.k_pages.shape[1]))
    toks, _, multi = fn(mega._step_params(), tok0, multi)
    assert toks.tolist() == ref
    _pools_close(multi, pc)
    with pytest.raises(ValueError, match="kv_quant"):
        # The full-width build over an int8 pool, and kv_quant dense.
        mega.decode_multi_fn(2, MAXLEN, 4, page=PAGE, num_pages=9)(
            tm.params, tok0, _clone_pool(multi))
    with pytest.raises(ValueError, match="paged"):
        mega.decode_multi_fn(2, MAXLEN, 4, kv_quant=True)(
            tm.params, tok0, tm.new_cache(2, MAXLEN))


# -- the engines --------------------------------------------------------------


@pytest.fixture(scope="module")
def goldens(models):
    """The JAX int8 engines' tokens: full-precision, and with decode over
    the dequantized int8 weights (prefill keeps the model's own)."""
    jm, _ = models
    out = {}

    def run():
        eng = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                            max_length=MAXLEN, prefix_cache=True,
                            kv_dtype="int8")
        cont = eng.run(REQS)
        assert eng.audit() == []
        fixed = JaxEngine(jm, paged=True, page_size=PAGE,
                          kv_dtype="int8").serve(IDS, GEN, MAXLEN)
        return cont, fixed

    with portable_export():
        out[False] = run()
        gold = _dequantized(jm, _jax_q8(jm))
        full_step = jm.decode_step

        def dequant_step(tokens, cache, mode="xla"):
            full = jm.params
            jm.params = gold
            try:
                return full_step(tokens, cache, mode)
            finally:
                jm.params = full

        jm.decode_step = dequant_step
        try:
            out[True] = run()
        finally:
            del jm.decode_step
    return out


@pytest.mark.parametrize("wq8", [False, True])
@pytest.mark.parametrize("ns", [1, 4])
def test_engines_int8_mega_tokens_match_jax(models, goldens, ns, wq8):
    _, tm = models
    cfg = MegaConfig(fuse_norms=True, wq8=wq8)
    want_cont, want_fixed = goldens[wq8]
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                           max_length=MAXLEN, prefix_cache=True,
                           kv_dtype="int8", mode="mega", ns=ns,
                           mega_cfg=cfg, device="cpu")
    got = eng.run(REQS)
    for g, w in zip(got, want_cont):
        np.testing.assert_array_equal(g, w)
    stats = eng.last_stats
    assert stats["mega_launches"] > 0 and stats["kv_dtype"] == "int8"
    assert eng.audit() == []
    fixed = Engine(tm, paged=True, page_size=PAGE, kv_dtype="int8",
                   mode="mega", mega_cfg=cfg, device="cpu")
    np.testing.assert_array_equal(fixed.serve(IDS, GEN, MAXLEN, ns=ns),
                                  want_fixed)
    assert fixed.last_stats["mega_launches"] == (GEN - 1) // ns
    assert fixed.audit() == []
