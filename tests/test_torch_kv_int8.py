"""The port's int8 KV path against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through both packages:

- the scale protocol (``quantize_pages``, ``quantized_row_scatter``,
  the quantized ``write_prefill``, ``copy_page`` with scales, the page
  export/import and ``as_dense``) must leave BIT-IDENTICAL codes and
  scales: both sides do the same f32 arithmetic and round half to even.
  The JAX functions run under ``jax.jit``, as in the JAX engines, where
  XLA turns ``amax / 127`` into ``amax * (1/127)``;
- the int8 attention ops (the port's plain versions against the JAX
  Pallas kernels in interpret mode) agree within 1e-5: the plain
  versions dequantize first and then attend, the kernels fold the
  scale in after QK^T and P·V, so only f32 rounding order differs;
- the attention layers over an int8 pool (through ``shard_map`` at tp=1
  on the JAX side) agree within 1e-5 on their output. The K/V rows they
  write come out of each framework's own GEMM (~1e-7 apart), so the
  scales agree to rtol 1e-6 and a code may differ by one where a value
  sits on a rounding boundary;
- the tiny f32 engines with ``kv_dtype="int8"`` emit the JAX int8
  engines' greedy tokens exactly, with clean audits and the same
  ``kv_dtype``/``kv_bytes_per_token`` stats.
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
from triton_distributed_tpu.ops.attention.flash_attention import (
    flash_attention as jax_flash_attention,
)
from triton_distributed_tpu.ops.attention.flash_decode import (
    paged_flash_decode as jax_paged_flash_decode,
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
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention import (
    flash_attention,
    paged_flash_decode,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-5
PAGE, MAXLEN, GEN = 16, 64, 5
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
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pool(rng, p=6, h=2, page=8, hd=16):
    """An int8 pool quantized from ~N(0, 1), as numpy codes + scales."""
    codes, scales = jax.jit(jpk.quantize_pages)(
        jnp.asarray(rng.standard_normal((p, h, page, hd)), jnp.float32))
    return np.array(codes), np.array(scales)


def test_quantize_pages_bit_identical():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 16, 32)) * 5.0).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero page: scale 0, codes 0
    jq, js = jax.jit(jpk.quantize_pages)(jnp.asarray(x))
    tq, ts = tpk.quantize_pages(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _same(tq, jq)
    _same(ts, js)
    _same(tpk.dequantize_page(tq, ts), jpk.dequantize_page(jq, js))


# (pids, offs, row magnitude): one write each, on the same pool.
SCATTER_CASES = {
    # A write at offset 0 resets the page's stale scale, then grows it.
    "reset_over_stale": ([3, 3], [0, 1], 0.5),
    # Rows 10x the pool's values grow the scale: stored codes re-quantize.
    "grow_requant": ([2], [5], 10.0),
    # Rows well inside the scale: no scale moves (the JAX cond skips).
    "steady": ([2, 4], [5, 7], 0.01),
    # Several rows in one page, and inactive rows fanning into trash page
    # 0 at offset 0, as a decode batch's empty slots do.
    "duplicates_and_trash": ([1, 1, 1, 0, 0], [2, 3, 4, 0, 0], 3.0),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_quantized_row_scatter_bit_identical(case):
    pids, offs, mag = SCATTER_CASES[case]
    rng = np.random.default_rng(len(case))
    codes, scales = _pool(rng)
    scales[3] = 40.0  # a stale tenant's scale on page 3
    rows = (rng.standard_normal((len(pids), 2, 16)) * mag).astype(np.float32)
    jp, js = jax.jit(jpk.quantized_row_scatter)(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(rows),
        jnp.asarray(pids, jnp.int32), jnp.asarray(offs, jnp.int32))
    tp_, ts = _t(codes), _t(scales)
    out = tpk.quantized_row_scatter(tp_, ts, _t(rows),
                                    torch.tensor(pids, dtype=torch.int32),
                                    torch.tensor(offs, dtype=torch.int32))
    assert out[0] is tp_ and out[1] is ts  # written in place
    _same(ts, js)
    _same(tp_, jp)
    # Re-quantizing each touched page once (the chunk path's ``touched``)
    # leaves the same codes as once per row.
    tp2, ts2 = _t(codes), _t(scales)
    tpk.quantized_row_scatter(tp2, ts2, _t(rows), torch.tensor(pids),
                              torch.tensor(offs),
                              torch.unique(torch.tensor(pids)))
    _same(ts2, js)
    _same(tp2, jp)
    if case == "reset_over_stale":
        assert float(ts[3].max()) < 40.0


def test_write_prefill_copy_page_and_page_round_trip(models):
    """Quantized write_prefill over stale scales and stale scratch rows,
    the COW clone with its scales, the page export/import and the
    dequantized dense view, bit for bit; ``cache_from_jax`` carries a
    JAX int8 cache over exactly."""
    jm, tm = models
    rng = np.random.default_rng(1)
    jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                     page_size=PAGE, num_pages=9,
                                     assign_pages=False, kv_dtype="int8")
    tcache, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE, num_pages=9,
                                     assign_pages=False, kv_dtype="int8")
    assert tcache.quantized and tcache.k_pages.dtype == torch.int8
    table = np.array([[3, 7, 1, 0], [2, 8, 0, 0]], np.int32)
    stale = np.full((2, 9, 4), 50.0, np.float32)  # a previous tenant
    jcache.page_table, jcache.k_scale = jnp.asarray(table), jnp.asarray(stale)
    jcache.v_scale = jnp.asarray(stale)
    tcache.page_table = _t(table)
    tcache.k_scale.copy_(_t(stale))
    tcache.v_scale.copy_(_t(stale))
    kd = rng.standard_normal((2, 1, 4, MAXLEN, 32)).astype(np.float32)
    vd = rng.standard_normal((2, 1, 4, MAXLEN, 32)).astype(np.float32)
    kd[..., 37:, :] = 77.7  # stale scratch past true_len
    jcache = jpk.write_prefill(jcache, 0, jnp.asarray(kd), jnp.asarray(vd),
                               37)
    tcache = tpk.write_prefill(tcache, 0, _t(kd), _t(vd), 37)

    def same_cache(tc, jc):
        for name in ("k_pages", "v_pages", "k_scale", "v_scale", "kv_len"):
            _same(getattr(tc, name), getattr(jc, name))

    same_cache(tcache, jcache)
    assert float(tcache.k_scale[:, 1].max()) < 1.0  # set, not grown
    jcache = jpk.copy_page(jcache, 7, 5)
    tcache = tpk.copy_page(tcache, 7, 5)
    same_cache(tcache, jcache)
    jk, jv, jks, jvs = jpk.gather_pages(jcache, [3, 1])
    tk, tv, tks, tvs = tpk.gather_pages(tcache, [3, 1])
    _same(tk, jk)
    _same(tks, jks)
    jcache = jpk.write_page(jcache, 6, jk[:, 0], jv[:, 0], jks[:, 0],
                            jvs[:, 0])
    tcache = tpk.write_page(tcache, 6, tk[:, 0], tv[:, 0], tks[:, 0],
                            tvs[:, 0])
    same_cache(tcache, jcache)
    with pytest.raises(ValueError, match="quantization"):
        tpk.write_page(tcache, 6, tk[:, 0], tv[:, 0])
    jd, _ = jpk.as_dense(jcache)
    td, _ = tpk.as_dense(tcache)
    _same(td, jd)
    same_cache(tpk.cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu"),
               jcache)


def test_kv_bytes_per_token_counts_the_scales(models):
    jm, tm = models
    for kv in (None, "int8"):
        jcache, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                         page_size=PAGE, kv_dtype=kv)
        tcache, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                         page_size=PAGE, kv_dtype=kv)
        assert tpk.kv_bytes_per_token(tcache) == jpk.kv_bytes_per_token(
            jcache)
    # Qwen3-0.6B: 28 layers, 8 kv heads of 128, page 128.
    shape = (28, 2, 8, 128, 128)
    q8 = tpk.PagedKVCache(torch.empty(shape, dtype=torch.int8),
                          torch.empty(shape, dtype=torch.int8), None, None,
                          torch.empty(shape[:3]), torch.empty(shape[:3]))
    assert tpk.kv_bytes_per_token(q8) == 57358.0
    with pytest.raises(ValueError, match="fp8"):
        tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                             page_size=PAGE, kv_dtype="fp8")


LENS = np.array([1, PAGE - 1, PAGE, PAGE + 1, 4 * PAGE], np.int32)


def test_paged_flash_decode_int8_matches_jax():
    """Unused table entries point at the trash page 0, whose codes and
    scale are garbage: neither side may read them."""
    rng = np.random.default_rng(4)
    b, pps, n_pages = len(LENS), 4, 24
    codes_k, sc_k = _pool(rng, n_pages, 4, PAGE, 32)
    codes_v, sc_v = _pool(rng, n_pages, 4, PAGE, 32)
    codes_k[0] = codes_v[0] = 127
    sc_k[0] = sc_v[0] = 1e4
    perm = rng.permutation(np.arange(1, n_pages))[: b * pps].reshape(b, pps)
    table = np.where(np.arange(pps)[None] < -(-LENS[:, None] // PAGE), perm,
                     0).astype(np.int32)
    q = rng.standard_normal((b, 8, 32)).astype(np.float32)
    want, want_lse = jax_paged_flash_decode(
        *map(jnp.asarray, (q, codes_k, codes_v, table, LENS)),
        return_lse=True, k_scale=jnp.asarray(sc_k), v_scale=jnp.asarray(sc_v))
    got, got_lse = paged_flash_decode(
        *map(_t, (q, codes_k, codes_v, table, LENS)), return_lse=True,
        k_scale=_t(sc_k), v_scale=_t(sc_v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    assert ck.PAGED_FLASH_DECODE_INT8.launches == 0  # CPU never launches
    with pytest.raises(ValueError, match="per-page layout"):
        paged_flash_decode(_t(q), _t(codes_k), _t(codes_v), _t(table),
                           _t(LENS), k_scale=_t(sc_k[:, :2]),
                           v_scale=_t(sc_v[:, :2]))


@pytest.mark.parametrize("sq,sk,off,blk", [
    (32, 64, 32, 16),   # the tiny chunk path: block_k = page = 16
    (16, 128, 112, 32),
])
def test_flash_attention_int8_matches_jax(sq, sk, off, blk):
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((1, 8, sq, 32)).astype(np.float32)
    kc, ks = _pool(rng, sk // blk, 4, blk, 32)  # [n, 4, blk, 32] blocks
    vc, vs = _pool(rng, sk // blk, 4, blk, 32)
    k = kc.transpose(1, 0, 2, 3).reshape(1, 4, sk, 32)
    v = vc.transpose(1, 0, 2, 3).reshape(1, 4, sk, 32)
    ks, vs = ks.T[None].copy(), vs.T[None].copy()  # [1, 4, n]
    want, want_lse = jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, kv_offset=off,
        block_k=blk, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        return_lse=True)
    got, got_lse = flash_attention(
        *map(_t, (q, k, v)), causal=True, kv_offset=off, block_k=blk,
        k_scale=_t(ks), v_scale=_t(vs), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    assert ck.FLASH_ATTENTION_INT8.launches == 0
    with pytest.raises(ValueError, match="per-block layout"):
        flash_attention(*map(_t, (q, k, v)), kv_offset=off, block_k=blk // 2,
                        k_scale=_t(ks), v_scale=_t(vs))


def _jax_layer(jm, fn, *args, **kw):
    """Run a JAX attention-layer function at tp=1 inside ``shard_map``."""
    def body(*a):
        return fn(*a, jm.dims, axis=jm.axis, mode="xla_ar", ctx=jm.ctx, **kw)

    f = jm.ctx.shard_map(body, in_specs=tuple(P() for _ in args),
                         out_specs=P())
    return jax.jit(f)(*args)


def _layer0(jm, tm):
    jp = jax.tree.map(lambda a: a[0], jm.params.layers.attn)
    return jp, tm._layers[0]["attn"]


def _close_pools(got, want, sc_got, sc_want):
    """Scales to rtol 1e-6; codes equal except a rare ±1 on a value that
    sits on a rounding boundary (the rows come from each framework's own
    GEMM)."""
    np.testing.assert_allclose(sc_got.numpy(), np.asarray(sc_want),
                               rtol=1e-6, atol=0)
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_tp_attn_decode_paged_int8_matches_jax(models):
    """One batched decode append over an int8 pool: two live rows (one
    at a page boundary, one mid-page) and an inactive slot writing the
    trash page, then the int8 decode."""
    jm, tm = models
    jp, tp_ = _layer0(jm, tm)
    rng = np.random.default_rng(5)
    kc, ks = _pool(rng, 8, 4, PAGE, 32)
    vc, vs = _pool(rng, 8, 4, PAGE, 32)
    table = np.array([[3, 5, 0, 0], [6, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    kv_len = np.array([16, 9, 0], np.int32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    want = _jax_layer(jm, jattn.tp_attn_decode_paged, jp, jnp.asarray(x),
                      *map(jnp.asarray, (kc, vc, table, kv_len)),
                      k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tattn.tp_attn_decode_paged(
        tp_, _t(x), _t(kc), _t(vc), _t(table), _t(kv_len), tm.dims,
        k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)
    for i in (1, 2):
        _close_pools(got[i][1:], want[i][1:], got[i + 2], want[i + 2])


def test_tp_attn_prefill_paged_chunk_int8_matches_jax(models):
    """A 16-row chunk at q_offset 20 whose real rows end at q_end 27:
    the 5 pad rows would land in page 2 (holding a stale scale) and must
    go to the trash page instead, on both sides."""
    jm, tm = models
    jp, tp_ = _layer0(jm, tm)
    rng = np.random.default_rng(6)
    kc, ks = _pool(rng, 8, 4, PAGE, 32)
    vc, vs = _pool(rng, 8, 4, PAGE, 32)
    ks[2] = vs[2] = 9.0
    table = np.array([4, 7, 2, 0], np.int32)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    want = _jax_layer(jm, jattn.tp_attn_prefill_paged_chunk, jp,
                      jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                      jnp.asarray(table), jnp.asarray(20, jnp.int32),
                      k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                      q_end=jnp.asarray(27, jnp.int32), kv_pages=4)
    got = tattn.tp_attn_prefill_paged_chunk(
        tp_, _t(x), _t(kc), _t(vc), _t(table), 20, tm.dims, kv_pages=4,
        k_scale=_t(ks), v_scale=_t(vs), q_end=27)
    # The 7 real rows; the pad rows' outputs are discarded by the engines
    # (they attend page 2's stale, 9x-scaled codes and reach ~1e3).
    np.testing.assert_allclose(got[0][:7].numpy(), np.asarray(want[0])[:7],
                               atol=ATOL, rtol=0)
    for i in (1, 2):
        _close_pools(got[i][1:], want[i][1:], got[i + 2], want[i + 2])
        assert float(got[i + 2][2].max()) == 9.0  # page 2 untouched
        np.testing.assert_array_equal(got[i][2].numpy(), (kc, vc)[i - 1][2])


@pytest.fixture(scope="module")
def jax_int8_streams(models):
    jm, _ = models
    eng = JaxEngine(jm, mode="xla", paged=True, page_size=PAGE,
                    kv_dtype="int8")
    out = {"paged": (eng.serve(IDS, GEN, MAXLEN), eng.last_stats)}
    for pc in (False, True):
        eng = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                            max_length=MAXLEN, num_pages=7, prefix_cache=pc,
                            kv_dtype="int8")
        out[f"continuous-{pc}"] = (eng.run([(p, GEN) for p in PROMPTS]),
                                   eng.last_stats)
        assert eng.audit() == []
    return out


def _same_stats(got: dict, want: dict):
    for key in ("kv_dtype", "kv_bytes_per_token"):
        assert got[key] == want[key], key


def test_engine_int8_tokens_identical(models, jax_int8_streams):
    _, tm = models
    want, want_stats = jax_int8_streams["paged"]
    eng = Engine(tm, paged=True, page_size=PAGE, kv_dtype="int8",
                 device="cpu")
    np.testing.assert_array_equal(eng.serve(IDS, GEN, MAXLEN), want)
    _same_stats(eng.last_stats, want_stats)
    assert eng.last_stats["kv_dtype"] == "int8"


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_continuous_int8_tokens_identical(models, jax_int8_streams,
                                          prefix_cache):
    _, tm = models
    want, want_stats = jax_int8_streams[f"continuous-{prefix_cache}"]
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           num_pages=7, prefix_cache=prefix_cache,
                           kv_dtype="int8", device="cpu")
    got = eng.run([(p, GEN) for p in PROMPTS])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.audit() == []
    _same_stats(eng.last_stats, want_stats)
    if prefix_cache:
        assert eng.last_stats["prefix_hit_tokens"] > 0
        assert eng.last_stats["pages_cow_copied"] > 0


def test_continuous_stats_match_jax_before_a_run(models):
    """``last_stats`` reads the pool even before any run: both pool
    kinds, against the JAX engine's."""
    jm, tm = models
    for kv in (None, "int8"):
        kw = dict(max_batch=2, page_size=PAGE, max_length=MAXLEN,
                  kv_dtype=kv)
        _same_stats(ContinuousEngine(tm, device="cpu", **kw).last_stats,
                    JaxContinuous(jm, **kw).last_stats)
