"""The port's long-context sharded slots and KV tier against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both packages (JAX at tp=1):

- the cold-partial kernels' plain versions: non-causal
  ``flash_attention`` with the cold window's ``[Sq, S_bucket]`` bias (f32
  K/V, and int8 codes + per-page scales) and the int8 dense
  ``flash_decode``, against the JAX Pallas kernels in interpret mode,
  within 1e-5 (f32 on both sides, only the summation order and where the
  scale is multiplied in differ). ``s_cold = 0`` (every column masked,
  or an empty decode context) must stay finite on both sides;
- the two sharded-slot attention layers, through ``shard_map`` at tp=1
  on the JAX side, within 1e-5, over a full-width and an int8 pool;
- ``PageStore``: the RAM LRU, disk write-through and reread, integrity
  drops, the audit, and tier blobs BYTE-identical to the JAX ``_encode``
  of the same arrays (f32, bf16, int8);
- the tiny f32 engines: a sharded ``ContinuousEngine`` emits the JAX
  sharded engine's tokens and the JAX big-pool engine's, with the same
  ``longctx_*`` counters and a clean audit, over a full-width and an
  int8 pool and beside a short request decoding in the same batch; a
  prefix-cache engine over a tier spills evicted pages and faults them
  back with the JAX engine's tokens and ``tier_*`` counters;
- the knob validation, with the JAX engine's exceptions and messages.
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
from triton_distributed_tpu.models import kv_tier as jtier
from triton_distributed_tpu.ops.attention.flash_attention import (
    flash_attention as jax_flash_attention,
)
from triton_distributed_tpu.ops.attention.flash_decode import (
    flash_decode as jax_flash_decode,
)
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers import tp_attn as tattn
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Qwen3,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.models import kv_tier as ttier
from triton_distributed_tpu_torch.obs import metrics as obs_metrics
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.attention import (
    flash_attention,
    flash_decode,
)

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-5
PAGE = 16
PROMPT_LONG = np.random.default_rng(8).integers(
    1, 200, size=120).astype(np.int32)
PROMPT_SHORT = np.random.default_rng(9).integers(
    1, 200, size=20).astype(np.int32)
SHARDED = dict(rank_page_budget=64, tier_bytes=32 << 20, num_pages=6)
LONGCTX_KEYS = ("longctx_sharded_slots", "longctx_demoted_pages",
                "longctx_tier_faults", "longctx_decode_steps",
                "prefill_chunks", "decode_steps", "generated_tokens")


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
    problems = [p for obj in list(ContinuousEngine._live)
                for p in obj.audit()]
    assert not problems, problems


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol=ATOL):
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _int8_window(rng, hkv, n_pages, page, hd):
    """An int8 cold window ``[1, hkv, n_pages * page, hd]`` quantized per
    (page, head) from ~N(0, 1), and its scales ``[1, hkv, n_pages]``."""
    x = rng.standard_normal((hkv, n_pages, page, hd)).astype(np.float32)
    scale = np.abs(x).max(axis=(-2, -1)) * np.float32(1 / 127)
    codes = np.clip(np.round(x / scale[..., None, None]), -127, 127)
    return (codes.astype(np.int8).reshape(1, hkv, n_pages * page, hd),
            scale[None].astype(np.float32))


def _cold_bias(sq, s_bucket, s_cold):
    return np.where(np.arange(s_bucket)[None] < s_cold, 0.0,
                    -1e30).astype(np.float32).repeat(sq, axis=0)


# -- the cold partials' plain versions --------------------------------------


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s_cold", [0, 40])
def test_cold_flash_attention_matches_jax(int8, s_cold):
    """A page-wide chunk against a 4-page cold bucket: non-causal, the
    bias masking the bucket past ``s_cold`` (mid-page at 40, all of it
    at 0)."""
    rng = np.random.default_rng(s_cold + int8)
    sq, sk = PAGE, 4 * PAGE
    q = rng.standard_normal((1, 8, sq, 32)).astype(np.float32)
    bias = _cold_bias(sq, sk, s_cold)
    if int8:
        k, ks = _int8_window(rng, 4, 4, PAGE, 32)
        v, vs = _int8_window(rng, 4, 4, PAGE, 32)
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=_t(ks), v_scale=_t(vs))
    else:
        k = rng.standard_normal((1, 4, sk, 32)).astype(np.float32)
        v = rng.standard_normal((1, 4, sk, 32)).astype(np.float32)
        jkw, tkw = {}, {}
    want, want_lse = jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=False, block_k=PAGE,
        bias=jnp.asarray(bias), return_lse=True, **jkw)
    got, got_lse = flash_attention(
        *map(_t, (q, k, v)), causal=False, block_k=PAGE, bias=_t(bias),
        return_lse=True, **tkw)
    _close(got, want)
    _close(got_lse, want_lse, atol=ATOL * (1e30 if s_cold == 0 else 1))
    if s_cold == 0:
        assert float(got_lse.max()) < -1e29  # weight 0 in the combine
    else:
        # The bias matters: the unmasked window moves O well past ATOL.
        whole = flash_attention(*map(_t, (q, k, v)), causal=False,
                                block_k=PAGE, **tkw)
        assert (whole - got).abs().max() > 100 * ATOL
    assert ck.FLASH_ATTENTION_COLD.launches == 0  # CPU never launches
    assert ck.FLASH_ATTENTION_COLD_INT8.launches == 0


@pytest.mark.parametrize("int8", [False, True])
def test_cold_flash_decode_matches_jax(int8):
    """Dense decode over a 4-page cold window with ``chunk_k = page``:
    an empty context (``s_cold = 0``), a mid-bucket and a full one in one
    batch. The empty row is O = 0 with LSE ~ -1e30 on both sides."""
    rng = np.random.default_rng(30 + int8)
    lens = np.array([0, 24, 4 * PAGE], np.int32)
    b, s = len(lens), 4 * PAGE
    q = rng.standard_normal((b, 8, 32)).astype(np.float32)
    if int8:
        ks_, k_ = zip(*[_int8_window(rng, 4, 4, PAGE, 32)[::-1]
                        for _ in range(b)])
        vs_, v_ = zip(*[_int8_window(rng, 4, 4, PAGE, 32)[::-1]
                        for _ in range(b)])
        k, v = np.concatenate(k_), np.concatenate(v_)
        ks, vs = np.concatenate(ks_), np.concatenate(vs_)
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=_t(ks), v_scale=_t(vs))
    else:
        k = rng.standard_normal((b, 4, s, 32)).astype(np.float32)
        v = rng.standard_normal((b, 4, s, 32)).astype(np.float32)
        jkw, tkw = {}, {}
    want, want_lse = jax_flash_decode(
        *map(jnp.asarray, (q, k, v, lens)), chunk_k=PAGE, return_lse=True,
        **jkw)
    got, got_lse = flash_decode(*map(_t, (q, k, v, lens)), chunk_k=PAGE,
                                return_lse=True, **tkw)
    _close(got, want)
    assert not got[0].any() and float(got_lse[0].max()) < -1e29
    _close(got_lse[1:], np.asarray(want_lse)[1:])
    assert ck.FLASH_DECODE_INT8.launches == 0
    if int8:
        with pytest.raises(ValueError, match="per-chunk layout"):
            flash_decode(*map(_t, (q, k, v, lens)), chunk_k=PAGE // 2,
                         **tkw)


# -- the sharded-slot attention layers ----------------------------------------


def _jax_layer(jm, fn, *args, **kw):
    """Run a JAX attention-layer function at tp=1 inside ``shard_map``,
    its attention through the JAX package's plain references (the op
    tests above hold those kernels in interpret mode)."""
    def body(*a):
        return fn(*a, jm.dims, axis=jm.axis, mode="xla_ar", ctx=jm.ctx, **kw)

    f = jm.ctx.shard_map(body, in_specs=tuple(P() for _ in args),
                         out_specs=P())
    with portable_export():
        return jax.jit(f)(*args)


def _layer_pools(rng, int8):
    """A 10-page one-layer pool and a 4-page cold window (64 keys), both
    full width or int8, as numpy: ``(kc, vc, ks, vs, k_cold, v_cold,
    ks_cold, vs_cold)`` (scales None at full width)."""
    if int8:
        kc, ks = _int8_window(rng, 4, 10, PAGE, 32)
        vc, vs = _int8_window(rng, 4, 10, PAGE, 32)
        pool = [x.reshape(4, 10, PAGE, 32).transpose(1, 0, 2, 3).copy()
                for x in (kc, vc)]
        k_cold, ks_cold = _int8_window(rng, 4, 4, PAGE, 32)
        v_cold, vs_cold = _int8_window(rng, 4, 4, PAGE, 32)
        return (*pool, ks[0].T.copy(), vs[0].T.copy(), k_cold[0],
                v_cold[0], ks_cold[0], vs_cold[0])
    pool = [rng.standard_normal((10, 4, PAGE, 32)).astype(np.float32)
            for _ in range(2)]
    cold = [rng.standard_normal((4, 4 * PAGE, 32)).astype(np.float32)
            for _ in range(2)]
    return (*pool, None, None, *cold, None, None)


def _scale_kw(ks, vs, ks_cold, vs_cold, conv):
    if ks is None:
        return {}
    return dict(k_scale=conv(ks), v_scale=conv(vs), ks_cold=conv(ks_cold),
                vs_cold=conv(vs_cold))


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_chunk_cold_layer_matches_jax(models, int8):
    """A page chunk at absolute offset ``s_cold + 16`` (local 16) whose
    real rows end 5 short of the page, over a 4-page bucket holding 2
    cold pages: rope at absolute positions, K/V at local ones, pad rows
    to the trash page, the bucket's tail masked."""
    s_cold = 2 * PAGE
    jm, tm = models
    jp = jax.tree.map(lambda a: a[0], jm.params.layers.attn)
    rng = np.random.default_rng(40 + s_cold + int8)
    kc, vc, ks, vs, k_cold, v_cold, ks_cold, vs_cold = _layer_pools(rng,
                                                                    int8)
    table = np.array([3, 7, 5, 0], np.int32)
    x = rng.standard_normal((PAGE, 64)).astype(np.float32)
    q_off = s_cold + PAGE
    q_end = q_off + PAGE - 5
    want = _jax_layer(
        jm, jattn.tp_attn_prefill_paged_chunk_cold, jp, jnp.asarray(x),
        *map(jnp.asarray, (kc, vc, table, k_cold, v_cold)),
        jnp.asarray(s_cold, jnp.int32), jnp.asarray(q_off, jnp.int32),
        q_end=jnp.asarray(q_end, jnp.int32),
        **_scale_kw(ks, vs, ks_cold, vs_cold, jnp.asarray))
    got = tattn.tp_attn_prefill_paged_chunk_cold(
        tm._layers[0]["attn"], _t(x), _t(kc), _t(vc), _t(table), _t(k_cold),
        _t(v_cold), s_cold, q_off, tm.dims, q_end=q_end,
        **_scale_kw(ks, vs, ks_cold, vs_cold, _t))
    real = PAGE - 5
    _close(got[0][:real], np.asarray(want[0])[:real])
    for i in (1, 2, 3, 4):
        if got[i] is None:
            continue
        # Every page but the trash page 0 (pad rows land there).
        g, w = got[i][1:].numpy(), np.asarray(want[i])[1:]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_sharded_layer_matches_jax(models, int8):
    """One decode step at local length 37 (mid-page 2 of the resident
    row) over a 4-page bucket holding 2 cold pages: rope at
    ``s_cold + 37``, append at local 37."""
    s_cold = 2 * PAGE
    jm, tm = models
    jp = jax.tree.map(lambda a: a[0], jm.params.layers.attn)
    rng = np.random.default_rng(50 + s_cold + int8)
    kc, vc, ks, vs, k_cold, v_cold, ks_cold, vs_cold = _layer_pools(rng,
                                                                    int8)
    table = np.array([3, 7, 5, 0], np.int32)
    x = rng.standard_normal((1, 64)).astype(np.float32)
    kv_loc = 37
    want = _jax_layer(
        jm, jattn.tp_attn_decode_sharded, jp, jnp.asarray(x),
        *map(jnp.asarray, (kc, vc, table)),
        jnp.asarray([kv_loc], jnp.int32), jnp.asarray(k_cold),
        jnp.asarray(v_cold), jnp.asarray([s_cold], jnp.int32),
        **_scale_kw(ks, vs, ks_cold, vs_cold, jnp.asarray))
    got = tattn.tp_attn_decode_sharded(
        tm._layers[0]["attn"], _t(x), _t(kc), _t(vc), _t(table), kv_loc,
        _t(k_cold), _t(v_cold), s_cold, tm.dims,
        **_scale_kw(ks, vs, ks_cold, vs_cold, _t))
    _close(got[0], want[0])
    for i in (1, 2, 3, 4):
        if got[i] is None:
            continue
        g, w = got[i].numpy(), np.asarray(want[i])
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=1e-6)


# -- the KV tier ---------------------------------------------------------------


def _payload_arrays(rng, dtype):
    """One page's (k, v, ks, vs) as numpy, bf16 through ml_dtypes."""
    k = rng.standard_normal((2, 4, PAGE, 32)).astype(np.float32)
    v = rng.standard_normal((2, 4, PAGE, 32)).astype(np.float32)
    if dtype == "int8":
        sc = rng.random((2, 4)).astype(np.float32)
        return (np.clip(k * 40, -127, 127).astype(np.int8),
                np.clip(v * 40, -127, 127).astype(np.int8), sc, sc * 2)
    if dtype == "bfloat16":
        k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (k, v))
    return k, v, None, None


def _as_torch(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tier_blobs_byte_identical_to_jax(dtype):
    """The same page encodes to the same bytes in both packages, and each
    package decodes the other's blob to the same arrays."""
    rng = np.random.default_rng(len(dtype))
    arrays = _payload_arrays(rng, dtype)
    chain = list(range(3, 3 + 2 * PAGE))
    kv = "int8" if dtype == "int8" else None
    jp = jtier.prefix_payload(chain, PAGE, kv, *arrays)
    tp_ = ttier.prefix_payload(chain, PAGE, kv, *map(_as_torch, arrays))
    jp["model_fp"] = tp_["model_fp"] = "abc"
    key = ttier.chain_digest(chain)
    assert key == jtier.chain_digest(chain)
    blob = ttier._encode(ttier.PREFIX_KIND, key, tp_)
    assert blob == jtier._encode(jtier.PREFIX_KIND, key, jp)
    got = ttier.decode_prefix_payload(
        ttier._decode(ttier.PREFIX_KIND, key, blob))
    want = jtier.decode_prefix_payload(
        jtier._decode(jtier.PREFIX_KIND, key, blob))
    assert got[:3] == tuple(want[:3])
    for g, w in zip(got[3:], want[3:]):
        if w is None:
            assert g is None
            continue
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_tier_blobs_carry_equal_fingerprints(models):
    """With the real fingerprints (not a stand-in), the same page under
    the same weights encodes to the same blob in both packages, so either
    package's tier entries pass the other's weight check."""
    jm, tm = models
    from triton_distributed_tpu.models.continuous import (
        _model_fingerprint as jax_fingerprint,
    )
    from triton_distributed_tpu_torch.models.continuous import (
        _model_fingerprint,
    )

    arrays = _payload_arrays(np.random.default_rng(7), "float32")
    chain = list(range(3, 3 + PAGE))
    jp = jtier.prefix_payload(chain, PAGE, None, *arrays)
    tp_ = ttier.prefix_payload(chain, PAGE, None, *map(_as_torch, arrays))
    jp["model_fp"] = jax_fingerprint(jm)
    tp_["model_fp"] = _model_fingerprint(tm)
    assert tp_["model_fp"] == jp["model_fp"]
    key = ttier.chain_digest(chain)
    assert (ttier._encode(ttier.PREFIX_KIND, key, tp_)
            == jtier._encode(jtier.PREFIX_KIND, key, jp))


def _entry(n: int) -> dict:
    return {"chain": list(range(n)), "blob": "x" * 200}


def test_page_store_lru_and_integrity():
    """RAM LRU bounded by bytes, ``get`` promotes, corrupt or truncated
    bytes give None and drop the entry, ``audit`` checks the ledger and
    each prefix key against its chain."""
    size = len(ttier._encode(ttier.PREFIX_KIND, ttier.chain_digest(range(4)),
                             _entry(4)))
    store = ttier.PageStore(capacity_bytes=int(size * 2.5))
    keys = [ttier.chain_digest(range(n)) for n in (4, 5, 6)]
    assert not store.may_contain(ttier.PREFIX_KIND)
    assert store.put(ttier.PREFIX_KIND, keys[0], _entry(4))
    assert store.put(ttier.PREFIX_KIND, keys[1], _entry(5))
    assert store.get(ttier.PREFIX_KIND, keys[0])["chain"] == list(range(4))
    assert store.put(ttier.PREFIX_KIND, keys[2], _entry(6))  # evicts keys[1]
    assert store.keys(ttier.PREFIX_KIND) == sorted([keys[0], keys[2]])
    assert store.get(ttier.PREFIX_KIND, keys[1]) is None
    assert store.stats["evictions"] == 1 and store.stats["misses"] == 1
    assert store.may_contain(ttier.PREFIX_KIND)
    assert not store.put(ttier.PREFIX_KIND, "big", {"x": "y" * size * 3})
    assert store.audit() == []
    assert store.resident_chains() == [list(range(4)), list(range(6))]
    # A flipped body byte: the CRC drops it.
    blob = bytearray(store._ram[(ttier.PREFIX_KIND, keys[0])])
    blob[-5] ^= 1
    store._ram[(ttier.PREFIX_KIND, keys[0])] = bytes(blob)
    assert any("checksum" in p for p in store.audit())
    assert store.get(ttier.PREFIX_KIND, keys[0]) is None
    assert not store.contains(ttier.PREFIX_KIND, keys[0])
    assert store.stats["drops"] == 1
    # A prefix entry under the wrong chain's key.
    store.put(ttier.PREFIX_KIND, keys[0], _entry(6))
    assert any("digest key" in p for p in store.audit())
    store.delete(ttier.PREFIX_KIND, keys[0])
    assert store.audit() == [] and store.snapshot()["ram_entries"] == 1
    assert store.clear() == 1 and store.ram_bytes == 0


def test_page_store_disk_write_through(tmp_path):
    """Entries survive in ``dir`` for a fresh store over the same
    directory (promoted to RAM on read); a truncated file gives None and
    is deleted; a store built by JAX reads the port's files."""
    store = ttier.PageStore(capacity_bytes=1 << 20, dir=str(tmp_path))
    key = ttier.chain_digest(range(5))
    store.put(ttier.PREFIX_KIND, key, _entry(5))
    store.put(ttier.LONGCTX_KIND, "7:0", _entry(3))
    again = ttier.PageStore(capacity_bytes=1 << 20, dir=str(tmp_path))
    assert again.may_contain(ttier.PREFIX_KIND)
    assert again.keys(ttier.PREFIX_KIND) == [key]
    assert again.keys(ttier.LONGCTX_KIND) == ["7:0"]
    assert again.get(ttier.PREFIX_KIND, key) == _entry(5)
    assert again.stats["disk_hits"] == 1 and again.snapshot()[
        "ram_entries"] == 1
    jstore = jtier.PageStore(capacity_bytes=1 << 20, dir=str(tmp_path))
    assert jstore.get(jtier.LONGCTX_KIND, "7:0") == _entry(3)
    path = tmp_path / ttier.LONGCTX_KIND / (
        __import__("hashlib").sha1(b"7:0").hexdigest() + ".tier")
    path.write_bytes(path.read_bytes()[:-10])
    fresh = ttier.PageStore(capacity_bytes=1 << 20, dir=str(tmp_path))
    assert fresh.get(ttier.LONGCTX_KIND, "7:0") is None
    assert not path.exists() and fresh.stats["drops"] == 1


# -- the engines ----------------------------------------------------------------


def _engine(cls, model, **kw):
    kw.setdefault("max_batch", 1)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_length", 256)
    if cls is ContinuousEngine:
        kw["device"] = "cpu"
    return cls(model, **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engines' tokens and counters on every engine case. Their
    attention runs through the JAX package's plain references (its
    ``portable_export`` path): the same arithmetic as the port's CPU
    path, without interpret-mode Pallas' compile time."""
    jm, _ = models
    with portable_export():
        out = {"gold": _engine(JaxContinuous, jm).run(
            [(PROMPT_LONG, 6), (PROMPT_SHORT, 10)])}
        for name, kw, reqs in _ENGINE_CASES:
            eng = _engine(JaxContinuous, jm, **kw)
            out[name] = (eng.run(reqs), dict(eng.last_stats))
            assert eng.audit() == []
    return out


_ENGINE_CASES = [
    ("sharded", SHARDED, [(PROMPT_LONG, 6)]),
    ("sharded_int8", dict(SHARDED, kv_dtype="int8"), [(PROMPT_LONG, 6)]),
    # The short request decodes beside the sharded slot, between its
    # prefill chunks too.
    ("sharded_beside", dict(SHARDED, max_batch=2),
     [(PROMPT_SHORT, 10), (PROMPT_LONG, 6)]),
]


@pytest.mark.parametrize("case", [c[0] for c in _ENGINE_CASES])
def test_sharded_engine_matches_jax(models, jax_runs, case):
    _, tm = models
    _, kw, reqs = next(c for c in _ENGINE_CASES if c[0] == case)
    eng = _engine(ContinuousEngine, tm, **kw)
    got = eng.run(reqs)
    want, want_stats = jax_runs[case]
    gold = {len(PROMPT_LONG): jax_runs["gold"][0],
            len(PROMPT_SHORT): jax_runs["gold"][1]}
    stats = eng.last_stats
    for (prompt, _), g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, w)
        if "int8" not in case:  # int8 KV noise may flip a tiny-model tie
            np.testing.assert_array_equal(g, gold[len(prompt)])
    assert {k: stats[k] for k in LONGCTX_KEYS} == {
        k: want_stats[k] for k in LONGCTX_KEYS}
    assert stats["longctx_sharded_slots"] == 1
    assert stats["longctx_demoted_pages"] > 0
    assert stats["longctx_tier_faults"] > 0
    assert stats["tier"]["puts"] == stats["longctx_demoted_pages"]
    assert eng.audit() == [] and eng.tier.keys(ttier.LONGCTX_KIND) == []


def test_prefix_spill_and_fill_match_jax(models):
    """A pool of 4 pages under a prefix cache and a tier: the second
    prompt evicts the first one's tree pages into the tier, and the
    re-asked first prompt faults its full pages back instead of
    re-prefilling them. Tokens and ``tier_*`` counters equal JAX's."""
    jm, tm = models
    rng = np.random.default_rng(12)
    a, b = (rng.integers(1, 200, 48).astype(np.int32) for _ in range(2))
    reqs = [(a, 4), (b, 4), (a, 4)]
    kw = dict(max_length=64, num_pages=4, prefix_cache=True,
              tier_bytes=8 << 20)
    jeng = _engine(JaxContinuous, jm, **kw)
    with portable_export():
        want = jeng.run(reqs)
    eng = _engine(ContinuousEngine, tm, **kw)
    got = eng.run(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keys = ("tier_spilled_pages", "tier_hits", "tier_faults",
            "prefix_hit_tokens", "prefill_tokens")
    stats = eng.last_stats
    assert {k: stats[k] for k in keys} == {k: jeng.last_stats[k]
                                           for k in keys}
    assert stats["tier_spilled_pages"] > 0 and stats["tier_faults"] > 0
    assert stats["tier_bytes"] > 0 and stats["tier"]["hits"] > 0
    assert eng.audit() == []


def test_longctx_knob_validation(models):
    """The JAX engine's refusals, exception and message alike."""
    jm, tm = models
    for kw, match in (
        (dict(rank_page_budget=40, tier_bytes=1 << 20), "not a multiple"),
        (dict(rank_page_budget=16, tier_bytes=1 << 20), ">= 2 pages"),
        (dict(rank_page_budget=64), "requires a KV tier"),
        (dict(rank_page_budget=64, tier_bytes=1 << 20, speculative=2),
         "xla/pallas decode"),
        (dict(rank_page_budget=64, tier_bytes=1 << 20, mode="mega"),
         "xla/pallas decode"),
        (dict(rank_page_budget=48, tier_bytes=1 << 20, page_size=24,
              max_length=240), "chunk-alignable"),
    ):
        msgs = []
        for cls, m in ((JaxContinuous, jm), (ContinuousEngine, tm)):
            with pytest.raises(ValueError, match=match) as e:
                _engine(cls, m, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_tier_and_longctx_metrics_pretouched(models):
    """A cold engine (no tier) already holds a registered handle for
    every ``tdt_tier_*``/``tdt_longctx_*`` counter, as the JAX engine
    does, so a scrape sees the whole catalog before the first long
    request."""
    _, tm = models
    eng = _engine(ContinuousEngine, tm, prefix_cache=True)
    names = {h.name for hs in eng._metric_handles.values() for h in hs}
    reg = obs_metrics.default_registry()
    for stem in ("tier_spilled_pages", "tier_hits", "tier_faulted_pages",
                 "tier_bytes_faulted", "longctx_sharded_slots",
                 "longctx_demoted_pages", "longctx_tier_faults",
                 "longctx_tier_bytes", "longctx_decode_steps"):
        name = f"tdt_{stem}_total"
        assert name in names, stem
        assert reg.counter(name) in (h for hs in eng._metric_handles.values()
                                     for h in hs)
