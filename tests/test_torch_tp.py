"""Tensor parallelism of the port against the JAX package, on the CPU.

The port runs tp ranks co-located in one process (``DistContext``); on
the CPU its cross-rank ops take their plain versions. The JAX side runs
as its own tests run it: an ``initialize_distributed(tp=n)`` context on
the 8-device CPU mesh the conftest makes, the overlap and collective
kernels in interpret mode (explicit methods), the layers and models
under ``portable_export()`` (the JAX plain attention references, the
arithmetic of the port's CPU path).

Tolerances:
- each plain collective against its JAX kernel, f32: rtol = atol = 1e-4
  (the limits ``tests/test_overlap.py`` holds the JAX kernels to);
- ``gemm_rs_plain`` against the JAX ring at bf16: one bf16 ulp of the
  output per hop (n of them; the f32 partials may sum in another order
  and flip a rounding), and on planted rows the ring's result must be
  FAR from a sum in rank order (so the order is really tested);
- layers and logits, f32: atol 1e-4 (full vs blockwise softmax, GEMM
  summation order; differences ~1e-6 on values of size ~1);
- greedy tokens: identical.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers import tp_attn as jattn
from triton_distributed_tpu.layers.tp_mlp import TPMLP
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.ops import overlap as jov
from triton_distributed_tpu.ops.collectives import all_gather as jag
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers.tp_attn import (
    TPAttnDims,
    tp_attn_decode,
    tp_attn_decode_paged,
    tp_attn_prefill,
    tp_attn_prefill_paged_chunk,
)
from triton_distributed_tpu_torch.layers.tp_mlp import tp_mlp_fwd
from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
from triton_distributed_tpu_torch.models import (
    AutoLLM,
    ContinuousEngine,
    Engine,
    PrefixCache,
    Qwen3,
    Request,
    get_config,
    params_from_jax,
    shard_params,
    unshard_params,
)
from triton_distributed_tpu_torch.ops import overlap as tov
from triton_distributed_tpu_torch.ops.collectives import (
    AllGatherMethod,
    all_gather,
)
from triton_distributed_tpu_torch.runtime import initialize_distributed

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-4
PAGE, MAXLEN, GEN = 16, 64, 5


@contextlib.contextmanager
def jax_tp(n: int):
    ctx = mesh_mod.initialize_distributed(tp=n, devices=jax.devices()[:n])
    try:
        yield ctx
    finally:
        mesh_mod.finalize_distributed()


def port_tp(n: int, dtype=torch.float32):
    return initialize_distributed(n, device="cpu", dtype=dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


# -- each plain collective against its JAX kernel (interpret mode) --------

COLLECTIVES = ("gemm_ar_one_shot", "gemm_ar_two_shot", "gemm_rs",
               "gemm_rs_bidir", "ag_gemm", "all_gather")


def _collective(op, n, rng, jctx):
    """(port per-rank outputs, the JAX kernel's output, how the port's
    ranks combine into the JAX output: 'same' (replicated), 'rows',
    'cols')."""
    ctx = port_tp(n)
    f32 = functools.partial(rng.standard_normal, dtype=np.float32)
    if op.startswith("gemm_ar"):
        a, b = f32((8, 128)), f32((128, 256))
        method = (tov.GemmARMethod.ONE_SHOT if op.endswith("one_shot")
                  else tov.GemmARMethod.TWO_SHOT)
        jm = (jov.GemmARMethod.ONE_SHOT if op.endswith("one_shot")
              else jov.GemmARMethod.TWO_SHOT)
        want = jov.gemm_ar_op(jnp.asarray(a), jnp.asarray(b), "tp", jm,
                              jov.GemmARConfig(tile_n=128), jctx)
        got = tov.gemm_ar(ctx.shard(_t(a), 1), ctx.shard(_t(b), 0), ctx,
                          method=method)
        return got, want, "same"
    if op.startswith("gemm_rs"):
        bidir = op.endswith("bidir")
        a, b = f32((n * 16, 128)), f32((128, 128))
        want = jov.gemm_rs_op(
            jnp.asarray(a), jnp.asarray(b), "tp",
            jov.GemmRSConfig(tile_n=128, tile_m=8 if bidir else 16,
                             bidir=bidir), jctx)
        got = tov.gemm_rs(ctx.shard(_t(a), 1), ctx.shard(_t(b), 0), ctx,
                          tov.GemmRSConfig(tile_m=8 if bidir else 16,
                                           bidir=bidir))
        return got, want, "rows"
    if op == "ag_gemm":
        a, b = f32((n * 16, 64)), f32((64, 128 * n))
        want = jov.ag_gemm_op(jnp.asarray(a), jnp.asarray(b), "tp",
                              jov.AGGemmConfig(tile_n=128), jctx)
        got = tov.ag_gemm(ctx.shard(_t(a), 0), ctx.shard(_t(b), 1), ctx)
        return got, want, "cols"
    x = f32((n * 8, 128))
    want = jag.all_gather_op(jnp.asarray(x), "tp",
                             jag.AllGatherMethod.PALLAS_FULL_MESH, jctx)
    got = all_gather(ctx.shard(_t(x), 0), ctx,
                     AllGatherMethod.PALLAS_FULL_MESH)
    return got, want, "same"


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", COLLECTIVES)
def test_plain_collective_matches_jax_kernel(op, n):
    rng = np.random.default_rng(7 + n)
    with jax_tp(n) as jctx:
        got, want, how = _collective(op, n, rng, jctx)
    want = np.asarray(want)
    assert len(got) == n
    if how == "same":
        for g in got[1:]:  # every rank holds bitwise the same output
            assert torch.equal(g, got[0])
        got = got[0]
    else:
        got = torch.cat(got, dim=0 if how == "rows" else 1)
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _ring_pos_value(r, c, row, n, half):
    """Planted partial of rank r for chunk c: by r's position s on the
    chunk's ring (clockwise below ``half``: s = r - c - 1; else s = c -
    1 - r, mod n), 256, 1, -256, 0: the ring rounds 256 + 1 back to 256
    and ends at 0, a sum in rank order gives 1."""
    s = (r - c - 1) % n if row < half else (c - 1 - r) % n
    return (256.0, 1.0, -256.0, 0.0)[s]


@pytest.mark.parametrize("bidir", [False, True])
def test_gemm_rs_plain_follows_the_ring_at_bf16(bidir):
    n, m_per, kl = 4, 16, 128
    rng = np.random.default_rng(3)
    half = 8 if bidir else m_per
    # A_r's columns are rank r's K shard; B_r = I, so rank r's partial is
    # A_r itself: random bf16 values, and column 0 planted per ring slot.
    a = rng.standard_normal((n * m_per, n * kl)).astype(np.float32)
    for r in range(n):
        for c in range(n):
            for i in range(m_per):
                a[c * m_per + i, r * kl] = _ring_pos_value(r, c, i, n, half)
    a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    b = np.tile(np.eye(kl, dtype=np.float32), (n, 1))
    with jax_tp(n) as jctx:
        want = np.asarray(jov.gemm_rs_op(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), "tp",
            jov.GemmRSConfig(tile_n=128, tile_m=8 if bidir else 16,
                             bidir=bidir), jctx).astype(jnp.float32))
    ctx = port_tp(n, torch.bfloat16)
    got = torch.cat(tov.gemm_rs(
        ctx.shard(_t(a, torch.bfloat16), 1),
        ctx.shard(_t(b, torch.bfloat16), 0), ctx,
        tov.GemmRSConfig(tile_m=8 if bidir else 16, bidir=bidir))
    ).to(torch.float32).numpy()
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-6)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= n * ulp).all()
    # The planted column: the ring's order (port and JAX) gives 0, a sum
    # in rank order 1, far outside the tolerance.
    assert (got[:, 0] == 0).all() and (want[:, 0] == 0).all()
    rank_order = a.reshape(n * m_per, n, kl)[:, :, 0].sum(axis=1)
    assert (np.abs(got[:, 0] - rank_order) > n * 2.0**-7).all()


# -- layers, each mode, against the JAX layers ------------------------------

D, HQ, HKV, HD, FF = 64, 8, 4, 32, 128


def _weights(rng):
    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(
            np.float32)
    return dict(wq=w(D, HQ * HD), wk=w(D, HKV * HD), wv=w(D, HKV * HD),
                wo=w(HQ * HD, D), gate=w(D, FF), up=w(D, FF), down=w(FF, D),
                qn=(1 + 0.1 * rng.standard_normal(HD)).astype(np.float32),
                kn=(1 + 0.1 * rng.standard_normal(HD)).astype(np.float32))


def _port_attn(wts, n):
    def cols(x, r, w):
        return x[:, r * w:(r + 1) * w]
    ql, kl = HQ * HD // n, HKV * HD // n
    return [{
        "wqkv": _t(np.concatenate([cols(wts["wq"], r, ql),
                                   cols(wts["wk"], r, kl),
                                   cols(wts["wv"], r, kl)], axis=1)),
        "wo": _t(wts["wo"][r * ql:(r + 1) * ql]),
        "q_norm": _t(wts["qn"]), "k_norm": _t(wts["kn"]),
    } for r in range(n)]


def _jax_attn(wts, jctx):
    layer = jattn.TPAttn(D, HQ, HKV, HD, dtype=jnp.float32, ctx=jctx)
    layer.load(*(jnp.asarray(wts[k]) for k in ("wq", "wk", "wv", "wo",
                                               "qn", "kn")))
    return layer


def _dims(n):
    return TPAttnDims(hq_loc=HQ // n, hkv_loc=HKV // n, head_dim=HD)


def _jdims(n):
    return jattn.TPAttnDims(hq_loc=HQ // n, hkv_loc=HKV // n, head_dim=HD)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_mlp_fwd_every_mode(n):
    rng = np.random.default_rng(20 + n)
    wts = _weights(rng)
    x = rng.standard_normal((n * 8, D)).astype(np.float32)
    ctx = port_tp(n)
    fl = FF // n
    params = [{"w1": _t(np.concatenate([wts["gate"][:, r * fl:(r + 1) * fl],
                                        wts["up"][:, r * fl:(r + 1) * fl]],
                                       axis=1)),
               "w2": _t(wts["down"][r * fl:(r + 1) * fl])} for r in range(n)]
    with jax_tp(n) as jctx:
        mlp = TPMLP(D, FF, dtype=jnp.float32, ctx=jctx)
        mlp.load(*(jnp.asarray(wts[k]) for k in ("gate", "up", "down")))
        want = {m: np.asarray(mlp.forward(jnp.asarray(x), m))
                for m in ("xla", "xla_ar", "pallas")}
    for mode, ref in (("xla", "xla"), ("pallas", "pallas"),
                      ("pallas", "xla")):
        out = tp_mlp_fwd(params, ctx.shard(_t(x), 0), mode=mode, ctx=ctx)
        _close(torch.cat(out), want[ref])
    for mode in ("xla_ar", "pallas_ar"):
        out = tp_mlp_fwd(params, ctx.replicate(_t(x)), mode=mode, ctx=ctx)
        for o in out:
            _close(o, want["xla_ar"])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_attn_prefill_sequence_sharded(n):
    rng = np.random.default_rng(30 + n)
    wts = _weights(rng)
    x = rng.standard_normal((n * 8, D)).astype(np.float32)
    ctx = port_tp(n)
    with jax_tp(n) as jctx, portable_export():
        layer = _jax_attn(wts, jctx)
        f = jax.jit(jctx.shard_map(
            functools.partial(jattn.tp_attn_prefill, dims=_jdims(n),
                              axis="tp", mode="xla", ctx=jctx),
            in_specs=(layer.param_specs, P("tp", None)),
            out_specs=(P("tp", None), P("tp"), P("tp"))))
        want = [np.asarray(t) for t in f(layer.params, jnp.asarray(x))]
    for mode in ("xla", "pallas"):
        out, k, v = tp_attn_prefill(_port_attn(wts, n),
                                    ctx.shard(_t(x), 0), _dims(n),
                                    mode=mode, ctx=ctx)
        _close(torch.cat(out), want[0])
        _close(torch.cat(k), want[1], 1e-5)
        _close(torch.cat(v), want[2], 1e-5)


def _jax_paged_fn(fn, jctx, layer, dims):
    """``fn(params, x, k_pages, v_pages, a, b, dims)`` (a per-shard JAX
    layer) over the mesh in mode ``xla_ar``: params sharded as the
    layer's, the pools by kv head (axis 1), the rest replicated; returns
    (out, k_pages, v_pages)."""
    pool = P(None, "tp", None, None)
    return jax.jit(jctx.shard_map(
        lambda p, x, kp, vp, a, b: fn(p, x, kp, vp, a, b, dims, axis="tp",
                                      mode="xla_ar", ctx=jctx)[:3],
        in_specs=(layer.param_specs, P(), pool, pool, P(), P()),
        out_specs=(P(), pool, pool)))


@pytest.mark.parametrize("n", [2, 4])
def test_tp_attn_decode_paged_and_chunk(n):
    """The replicated-activation layers: a 16-row chunk at offset 20 of
    slot 0, then one decode step of both slots, over the same pools."""
    rng = np.random.default_rng(40 + n)
    wts = _weights(rng)
    pages = 8
    kp = rng.standard_normal((pages, HKV, PAGE, HD)).astype(np.float32)
    vp = rng.standard_normal((pages, HKV, PAGE, HD)).astype(np.float32)
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    kv_len = np.array([36, 50], np.int32)
    xc = rng.standard_normal((16, D)).astype(np.float32)
    xd = rng.standard_normal((2, D)).astype(np.float32)
    dims, jdims = _dims(n), _jdims(n)
    with jax_tp(n) as jctx, portable_export():
        layer = _jax_attn(wts, jctx)
        chunk = _jax_paged_fn(jattn.tp_attn_prefill_paged_chunk, jctx, layer,
                              jdims)
        jc = chunk(layer.params, jnp.asarray(xc), jnp.asarray(kp),
                   jnp.asarray(vp), jnp.asarray(table[0]), jnp.int32(20))
        dec = _jax_paged_fn(jattn.tp_attn_decode_paged, jctx, layer, jdims)
        jd = dec(layer.params, jnp.asarray(xd), jc[1], jc[2],
                 jnp.asarray(table), jnp.asarray(kv_len))
        jd = [np.asarray(t) for t in jd]
        jc = [np.asarray(t) for t in jc]
    ctx = port_tp(n)
    hl = HKV // n
    for mode in ("xla_ar", "pallas_ar"):
        kps = [_t(kp[:, r * hl:(r + 1) * hl]).contiguous() for r in range(n)]
        vps = [_t(vp[:, r * hl:(r + 1) * hl]).contiguous() for r in range(n)]
        out = tp_attn_prefill_paged_chunk(
            _port_attn(wts, n), ctx.replicate(_t(xc)), kps, vps,
            torch.from_numpy(table[0]), 20, dims, mode=mode, ctx=ctx)[0]
        for o in out:
            _close(o, jc[0])
        _close(torch.cat(kps, dim=1), jc[1], 1e-5)
        out = tp_attn_decode_paged(
            _port_attn(wts, n), ctx.replicate(_t(xd)), kps, vps,
            torch.from_numpy(table), torch.from_numpy(kv_len), dims,
            mode=mode, ctx=ctx)[0]
        for o in out:
            _close(o, jd[0])
        _close(torch.cat(vps, dim=1), jd[2], 1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_attn_decode_dense(n):
    rng = np.random.default_rng(50 + n)
    wts = _weights(rng)
    kc = rng.standard_normal((2, HKV, 32, HD)).astype(np.float32)
    vc = rng.standard_normal((2, HKV, 32, HD)).astype(np.float32)
    kv_len = np.array([5, 17], np.int32)
    x = rng.standard_normal((2, D)).astype(np.float32)
    dims, jdims = _dims(n), _jdims(n)
    with jax_tp(n) as jctx, portable_export():
        layer = _jax_attn(wts, jctx)
        cache = P(None, "tp", None, None)
        f = jax.jit(jctx.shard_map(
            lambda p, x_, k_, v_, kl: jattn.tp_attn_decode(
                p, x_, k_, v_, kl, jdims, axis="tp", mode="xla_ar", ctx=jctx),
            in_specs=(layer.param_specs, P(), cache, cache, P()),
            out_specs=(P(), cache, cache)))
        want = [np.asarray(t) for t in f(layer.params, jnp.asarray(x),
                                         jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(kv_len))]
    ctx = port_tp(n)
    hl = HKV // n
    for mode in ("xla_ar", "pallas_ar"):
        kcs = [_t(kc[:, r * hl:(r + 1) * hl]).contiguous() for r in range(n)]
        vcs = [_t(vc[:, r * hl:(r + 1) * hl]).contiguous() for r in range(n)]
        out = tp_attn_decode(_port_attn(wts, n), ctx.replicate(_t(x)), kcs,
                             vcs, torch.from_numpy(kv_len), dims, mode=mode,
                             ctx=ctx)[0]
        for o in out:
            _close(o, want[0])
        _close(torch.cat(kcs, dim=1), want[1], 1e-5)


# -- the model and the engines at tp=4 with JAX weights ----------------------

_rng = np.random.default_rng(11)
_PREFIX = _rng.integers(0, 256, 24)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, k)]).astype(np.int32)
           for k in (8, 3, 13)]
IDS = np.stack([PROMPTS[0][:32], PROMPTS[2][:32]])


@pytest.fixture(scope="module")
def tp4():
    """The JAX tiny model at tp=4 (f32) and the port's, from its weights;
    the JAX engines' greedy tokens (mode 'xla': on the CPU the JAX AUTO
    dispatch takes XLA, ``common.py:208-221``)."""
    ctx = mesh_mod.initialize_distributed(tp=4, devices=jax.devices()[:4])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    tree = jax.tree.map(np.asarray, jm.params)
    tm = Qwen3(get_config("tiny"), device="cpu", tp=4)
    tm.set_params(params_from_jax(tree, tp=4))
    with portable_export():
        cont = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, mode="xla",
                             prefix_cache=True)
        gold_cont = [np.asarray(o).tolist()
                     for o in cont.run([(p, GEN) for p in PROMPTS])]
        gold_eng = np.asarray(JaxEngine(jm, mode="xla", paged=True,
                                        page_size=PAGE).serve(
            IDS, GEN, max_length=MAXLEN)).tolist()
    yield jm, tm, tree, gold_cont, gold_eng
    mesh_mod.finalize_distributed()


def test_tp4_logits_of_a_chunk_and_a_decode_step(tp4):
    from triton_distributed_tpu.models import paged_kv_cache as jpk

    from triton_distributed_tpu_torch.models import paged_kv_cache as tpk

    jm, tm, _, _, _ = tp4
    prompt = PROMPTS[0]
    with portable_export():
        jc, _ = jpk.init_paged_cache(jm.cfg, 2, jm.ctx, max_length=MAXLEN,
                                     page_size=PAGE)
        buf = np.zeros(32, np.int32)
        buf[:len(prompt)] = prompt
        jl, jc = jm.prefill_paged_chunk(jnp.asarray(buf), 0, 0, len(prompt),
                                        len(prompt) - 1, jc, "xla")
        tok = np.array([int(np.argmax(jl)), 3], np.int32)
        jd, _ = jm.decode_step(jnp.asarray(tok), jc, "xla")
    for mode in ("xla", "pallas"):
        tc, _ = tpk.init_paged_cache(tm.cfg, 2, "cpu", max_length=MAXLEN,
                                     page_size=PAGE, tp=4)
        tl, tc = tm.prefill_paged_chunk(buf, 0, 0, len(prompt),
                                        len(prompt) - 1, tc, mode)
        _close(tl, jl)
        td, _ = tm.decode_step(torch.from_numpy(tok), tc, mode)
        _close(td, jd)


def test_tp4_sequence_sharded_prefill_logits(tp4):
    jm, tm, _, _, _ = tp4
    lens = np.array([32, 27], np.int32)
    with portable_export():
        jl, jc = jm.prefill_batched(jnp.asarray(IDS), jm.new_cache(2, MAXLEN),
                                    "xla", jnp.asarray(lens))
    for mode in ("xla", "pallas"):
        tl, tc = tm.prefill_batched(IDS, tm.new_cache(2, MAXLEN), mode,
                                    lens)
        _close(tl, jl)
        k = torch.cat([tc.k[r] for r in range(4)], dim=2)
        _close(k[:, :, :, :27], np.asarray(jc.k)[:, :, :, :27], 1e-5)


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_tp4_continuous_engine_emits_the_jax_tokens(tp4, mode, prefix_cache):
    _, tm, _, gold, _ = tp4
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           mode=mode, prefix_cache=prefix_cache, device="cpu")
    got = [o.tolist() for o in eng.run([(p, GEN) for p in PROMPTS])]
    assert got == gold


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_tp4_engine_emits_the_jax_tokens(tp4, mode, paged):
    _, tm, _, _, gold = tp4
    out = Engine(tm, mode=mode, paged=paged, page_size=PAGE,
                 device="cpu").serve(IDS, GEN, max_length=MAXLEN)
    assert out.tolist() == gold


@pytest.mark.parametrize("tp", [2, 4])
def test_port_tp_emits_its_own_tp1_tokens(tp):
    m1 = AutoLLM.from_pretrained("tiny", device="cpu", seed=1)
    mt = AutoLLM.from_pretrained("tiny", device="cpu", seed=1, tp=tp)
    reqs = [(p, GEN) for p in PROMPTS]
    want = [o.tolist() for o in ContinuousEngine(
        m1, page_size=PAGE, max_length=MAXLEN, device="cpu").run(reqs)]
    for pc in (False, True):
        eng = ContinuousEngine(mt, page_size=PAGE, max_length=MAXLEN,
                               mode="pallas", prefix_cache=pc, device="cpu",
                               prefill_chunk=16)
        assert [o.tolist() for o in eng.run(reqs)] == want
    ids = IDS[:, :29]  # odd width: right-padded to a multiple of tp
    want = Engine(m1, device="cpu").serve(ids, GEN, max_length=MAXLEN)
    got = Engine(mt, mode="pallas", device="cpu").serve(ids, GEN,
                                                        max_length=MAXLEN)
    assert got.tolist() == want.tolist()


# -- plumbing ---------------------------------------------------------------

def test_shard_params_round_trips():
    m1 = AutoLLM.from_pretrained("tiny", device="cpu", seed=2)
    for n in (2, 4):
        back = unshard_params(shard_params(m1.params, n))
        for path in (("embed",), ("norm",), ("layers", "attn", "wqkv"),
                     ("layers", "attn", "wo"), ("layers", "mlp", "w1"),
                     ("layers", "mlp", "w2"), ("layers", "ln1")):
            a, b = m1.params, back
            for k in path:
                a, b = a[k], b[k]
            assert torch.equal(a, b)
        assert torch.equal(back["lm_head"][:, :256], m1.params["lm_head"])
        assert not back["lm_head"][:, 256:].any()
        # Replicated leaves are each rank's own copy.
        shards = shard_params(m1.params, n)
        assert shards[1]["embed"] is not shards[0]["embed"]


def test_params_from_jax_at_tp_undoes_the_shard_fusion(tp4):
    jm, tm, tree4, _, _ = tp4
    with jax_tp(1) as ctx1:
        tree1 = jax.tree.map(np.asarray, JaxAutoLLM.from_pretrained(
            "tiny", ctx=ctx1, seed=0).params)
    mesh_mod.initialize_distributed(tp=4, devices=jax.devices()[:4])
    want = shard_params(params_from_jax(tree1), 4)
    got = params_from_jax(tree4, tp=4)
    for g, w in zip(got, want):
        for k in ("wqkv", "wo"):
            np.testing.assert_array_equal(g["layers"]["attn"][k],
                                          w["layers"]["attn"][k])
        for k in ("w1", "w2"):
            np.testing.assert_array_equal(g["layers"]["mlp"][k],
                                          w["layers"]["mlp"][k])
        np.testing.assert_array_equal(g["lm_head"], w["lm_head"])
    # Slicing the shard-fused tree as if it were tp=1 would not match.
    naive = shard_params(params_from_jax(tree4), 4)
    assert not np.array_equal(naive[1]["layers"]["attn"]["wqkv"],
                              want[1]["layers"]["attn"]["wqkv"])


@pytest.mark.parametrize("what", [
    "mega_engine", "mega_continuous", "moe", "speculative", "cp",
    "rank_page_budget", "int8", "sampled", "sampled_request", "tier",
])
def test_tp_refusals(what):
    cfg = get_config("tiny")
    if what == "moe":
        # Qwen3-MoE serves at tp>1 (tests/test_torch_moe_tp.py), also in
        # mode="mega" (tests/test_torch_mega_moe_tp.py); int8 weights stay
        # refused there (queue 1 position 4; wq8 with MoE, as in JAX).
        m = AutoLLM.from_pretrained("tiny-moe", device="cpu", tp=2)
        with pytest.raises(NotImplementedError, match="position 4"):
            Engine(m, mode="mega", device="cpu",
                   mega_cfg=MegaConfig(wq8=True))
        return
    m = Qwen3(cfg, device="cpu", tp=2)
    m.init_params(0)
    kw = dict(device="cpu", page_size=PAGE, max_length=MAXLEN)
    # mode="mega" serves a dense model at tp>1 (tests/test_torch_mega_tp.py)
    # and MegaQwen3.prefill runs there (tests/test_torch_mega_moe_tp.py);
    # what stays refused: int8 weights (wq8), for decode and for the
    # prefill megakernel (queue 1 position 4; the MoE megakernel: "moe").
    cases = {
        "mega_engine": (lambda: Engine(m, mode="mega", device="cpu",
                                       mega_cfg=MegaConfig(wq8=True)),
                        "position 4"),
        "mega_continuous": (lambda: MegaQwen3(
            m, cfg=MegaConfig(wq8=True)).prefill(
            np.arange(8), m.new_cache(1, MAXLEN)), "position 4"),
        "speculative": (lambda: ContinuousEngine(m, speculative=2, **kw),
                        "item 11"),
        "cp": (lambda: ContinuousEngine(m, cp=2, **kw), "item 11"),
        "rank_page_budget": (lambda: ContinuousEngine(
            m, rank_page_budget=32, tier_bytes=1 << 20, **kw), "item 11"),
        "int8": (lambda: Engine(m, paged=True, kv_dtype="int8",
                                device="cpu"), "item 11"),
        "sampled": (lambda: ContinuousEngine(m, temperature=0.7, **kw),
                    "item 11"),
        "sampled_request": (lambda: ContinuousEngine(m, **kw).run(
            [Request(PROMPTS[0], 3, temperature=0.5)]), "item 11"),
        "tier": (lambda: ContinuousEngine(m, prefix_cache=True,
                                          tier_bytes=1 << 20, **kw),
                 "item 11"),
    }
    fn, match = cases[what]
    with pytest.raises(NotImplementedError, match=match):
        fn()


def test_workspace_is_one_grow_only_buffer_per_site():
    """A kernel site keeps one symmetric workspace per dtype whatever the
    shapes it is asked for: a smaller call gets a view of the same slots
    (the same pointer table), a larger one reallocates it, and other
    sites and dtypes keep their own."""
    ctx = initialize_distributed(2, device="cpu", dtype=torch.float32)
    f32 = torch.float32
    first = ctx.workspace("gemm_rs", (1, 48, 64), f32)
    small = ctx.workspace("gemm_rs", (1, 16, 64), f32)
    assert tuple(small.data.shape) == (2, 1, 16, 64)
    assert small.table.tolist() == first.table.tolist()
    for r in range(2):
        assert small.data[r].data_ptr() == small.table[r].item()
    grown = ctx.workspace("gemm_rs", (1, 640, 64), f32)
    assert tuple(grown.data.shape) == (2, 1, 640, 64)
    assert grown.table.tolist() != first.table.tolist()
    assert ctx.workspace("gemm_rs", (1, 48, 64), f32).table.tolist() == \
        grown.table.tolist()
    ctx.workspace("ag_gemm", (2, 8, 64), f32)
    ctx.workspace("gemm_rs", (1, 8, 64), torch.bfloat16)
    assert len(ctx._workspaces) == 3
