"""Tensor-parallel Qwen3-MoE of the port against the JAX package, on the CPU.

The port runs tp ranks co-located in one process (``DistContext``); on
the CPU its collectives take their plain versions. The JAX side runs as
its own tests run it: an ``initialize_distributed(tp=n)`` context on the
8-device CPU mesh the conftest makes, the collective kernels in interpret
mode (explicit methods: on the CPU the JAX AUTO takes XLA), the layer
jitted, the engines under ``portable_export()``.

Tolerances:
- each plain collective against its JAX kernel, f32: rtol = atol = 1e-4
  (``tests/test_collectives.py``'s limits); the all-gathers move bytes
  and are equal;
- the rings' bf16 order, with planted partials: the port's plain ring
  and the JAX kernel give 0 where a sum in rank order gives 1, and agree
  within one bf16 ulp a hop elsewhere;
- DOUBLING at n = 4 in bf16, rank by rank: equal to the JAX kernel's
  output of the same rank (the same f32 sums and roundings);
- ``tp_moe_fwd`` in every mode, f32: atol 1e-4 (GEMM summation order);
- weights: equal; greedy tokens and the MoE ledger: equal.
"""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers import tp_moe as jmoe
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.ops.collectives import all_gather as jag
from triton_distributed_tpu.ops.collectives import all_reduce as jar
from triton_distributed_tpu.ops.collectives import reduce_scatter as jrs
from triton_distributed_tpu.ops.common import VMEM_COMM_MAX_BYTES
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers.tp_moe import tp_moe_fwd
from triton_distributed_tpu_torch.models import (
    AutoLLM,
    ContinuousEngine,
    Engine,
    PrefixCache,
    get_config,
    load_hf_moe_state_dict,
    params_from_jax,
    shard_params,
    unshard_params,
)
from triton_distributed_tpu_torch.ops import collectives as tcol
from triton_distributed_tpu_torch.ops.collectives import (
    AllGatherMethod,
    AllReduceMethod,
    ReduceScatterMethod,
)
from triton_distributed_tpu_torch.runtime import initialize_distributed

# The modules (the package exports functions of the same names).
tag_mod = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.all_gather")
tar_mod = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.all_reduce")
trs_mod = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.reduce_scatter")

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-4
PAGE, MAXLEN, GEN = 16, 128, 5


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


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


# -- each plain collective against its JAX kernel (interpret mode) --------

# op -> (port method, family, JAX method). The all-reduces' and
# all-gathers' ranks hold the JAX output; the reduce-scatters' ranks, its
# rows.
COLLECTIVES = {
    "ar_one_shot": (AllReduceMethod.ONE_SHOT, "ar",
                    jar.AllReduceMethod.ONE_SHOT),
    "ar_doubling": (AllReduceMethod.DOUBLING, "ar",
                    jar.AllReduceMethod.DOUBLING),
    "ar_two_shot": (AllReduceMethod.TWO_SHOT, "ar",
                    jar.AllReduceMethod.TWO_SHOT),
    "rs_one_shot": (ReduceScatterMethod.ONE_SHOT, "rs",
                    jrs.ReduceScatterMethod.ONE_SHOT),
    "rs_ring": (ReduceScatterMethod.PALLAS_RING, "rs",
                jrs.ReduceScatterMethod.PALLAS_RING),
    "rs_bidir_ring": (ReduceScatterMethod.PALLAS_BIDIR_RING, "rs",
                      jrs.ReduceScatterMethod.PALLAS_BIDIR_RING),
    "rs_ring_hbm": (ReduceScatterMethod.PALLAS_RING_HBM, "rs",
                    jrs.ReduceScatterMethod.PALLAS_RING_HBM),
    "ag_ring": (AllGatherMethod.PALLAS_RING, "ag",
                jag.AllGatherMethod.PALLAS_RING),
    "ag_bidir_ring": (AllGatherMethod.PALLAS_BIDIR_RING, "ag",
                      jag.AllGatherMethod.PALLAS_BIDIR_RING),
}


def _run_collective(op, xs_np, n, jctx, dtype=torch.float32,
                    jdtype=jnp.float32):
    """(port per-rank outputs, the JAX kernel's output) on per-rank
    inputs ``xs_np [n, rows, cols]``."""
    method, fam, jmethod = COLLECTIVES[op]
    ctx = port_tp(n, dtype)
    xs = [_t(x, dtype) for x in xs_np]
    jx = jnp.asarray(xs_np, jdtype)
    if fam == "ar":
        got = tcol.all_reduce(xs, ctx, method)
        want = jar.all_reduce_op(jx, "tp", jmethod, jctx)
    elif fam == "rs":
        got = tcol.reduce_scatter(xs, ctx, method)
        want = jrs.reduce_scatter_op(jx, "tp", jmethod, jctx)
    else:
        got = tcol.all_gather(xs, ctx, method)
        want = jag.all_gather_op(jx.reshape(-1, jx.shape[-1]), "tp", jmethod,
                                 jctx)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", sorted(COLLECTIVES))
def test_plain_collective_matches_jax_kernel(op, n):
    rng = np.random.default_rng(70 + n)
    xs_np = rng.standard_normal((n, n * 8, 128)).astype(np.float32)
    with jax_tp(n) as jctx:
        got, want = _run_collective(op, xs_np, n, jctx)
    assert len(got) == n and not np.isnan(want).any()
    if op.startswith("rs"):
        got = torch.cat(got)
    else:
        for g in got[1:]:  # every rank holds bitwise the same output
            assert torch.equal(g, got[0])
        got = got[0]
    if op.startswith("ag"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _ring_pos_value(r, c, row, n, half):
    """Planted partial of rank r for chunk c: by r's position s on the
    chunk's ring (clockwise below ``half``: s = r - c - 1; else s = c -
    1 - r, mod n), 256, 1, -256, 0: the ring rounds 256 + 1 back to 256
    and ends at 0, a sum in rank order gives 1."""
    s = (r - c - 1) % n if row < half else (c - 1 - r) % n
    return (256.0, 1.0, -256.0, 0.0)[s]


@pytest.mark.parametrize("op", ["rs_ring", "rs_bidir_ring", "rs_ring_hbm"])
def test_plain_rings_follow_the_ring_order_at_bf16(op):
    n, m_per, cols = 4, 8, 128
    half = m_per // 2 if op == "rs_bidir_ring" else m_per
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((n, n * m_per, cols)).astype(np.float32)
    for r in range(n):
        for c in range(n):
            for i in range(m_per):
                xs[r, c * m_per + i, 0] = _ring_pos_value(r, c, i, n, half)
    xs = np.asarray(jnp.asarray(xs).astype(jnp.bfloat16).astype(jnp.float32))
    with jax_tp(n) as jctx:
        got, want = _run_collective(op, xs, n, jctx, torch.bfloat16,
                                    jnp.bfloat16)
    got = torch.cat(got).to(torch.float32).numpy()
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-6)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= n * ulp).all()
    # The planted column: the ring's order (port and JAX) gives 0, a sum
    # in rank order 1, far outside the tolerance.
    assert (got[:, 0] == 0).all() and (want[:, 0] == 0).all()
    rank_order = xs[:, :, 0].sum(axis=0)
    assert (np.abs(got[:, 0] - rank_order) > n * 2.0**-7).all()
    assert (np.abs(tcol.reduce_scatter_one_shot_plain(
        [_t(x, torch.bfloat16) for x in xs])[0][:, 0].float().numpy()
        - 1.0) == 0).all()


def test_doubling_rank_by_rank_at_bf16():
    """The butterfly at n = 4: each rank's output equals the JAX kernel's
    output on the same rank (the ranks may differ from each other)."""
    n = 4
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((n, 16, 128)).astype(np.float32)
    with jax_tp(n) as jctx:
        f = jax.jit(jctx.shard_map(
            lambda xi: jar.all_reduce(xi[0], "tp", jar.AllReduceMethod.DOUBLING,
                                      jctx)[None],
            in_specs=P("tp", None, None), out_specs=P("tp", None, None)))
        want = np.asarray(f(jnp.asarray(xs, jnp.bfloat16)).astype(
            jnp.float32))
    got = tcol.all_reduce_doubling_plain([_t(x, torch.bfloat16) for x in xs])
    for r in range(n):
        np.testing.assert_array_equal(got[r].float().numpy(), want[r])


# -- the card's dispatch, on the CPU ----------------------------------------

# (op, shape a rank, n) along the slice's path at d = 2048 bf16 (4 KB a
# row) and its n = 4 card tests, with the method the JAX AUTO takes on the
# device (ops/collectives/*.py); TWO_SHOT's legs after their demotions.
DISPATCH = [
    ("ar", (4, 2048), 2, ["ONE_SHOT"]),
    ("ar", (48, 2048), 2, ["ONE_SHOT"]),
    ("ar", (112, 2048), 2, ["DOUBLING"]),
    ("ar", (384, 2048), 2, ["PALLAS_RING", "PALLAS_RING"]),
    ("ar", (1152, 2048), 2, ["PALLAS_RING_HBM", "PALLAS_RING"]),
    ("ar", (112, 2048), 4, ["DOUBLING"]),
    ("ar", (384, 2048), 4, ["PALLAS_BIDIR_RING", "PALLAS_BIDIR_RING"]),
    ("ar", (1152, 2048), 4, ["PALLAS_RING_HBM", "PALLAS_BIDIR_RING"]),
    ("ar", (385, 2048), 2, ["ONE_SHOT"]),  # indivisible: the card's one
    ("rs", (48, 2048), 2, ["ONE_SHOT"]),
    ("rs", (300, 2048), 2, ["PALLAS_RING"]),
    ("rs", (1152, 2048), 2, ["PALLAS_RING_HBM"]),
    ("rs", (304, 2048), 4, ["PALLAS_BIDIR_RING"]),
    ("rs", (300, 2048), 4, ["PALLAS_RING"]),  # odd chunk: demoted
    ("ag", (150, 2048), 2, ["PALLAS_FULL_MESH"]),
    ("ag", (8, 2048), 4, ["PALLAS_FULL_MESH"]),
    ("ag", (76, 2048), 4, ["PALLAS_BIDIR_RING"]),
]


@pytest.mark.parametrize("op,shape,n,want", DISPATCH)
def test_card_dispatch_takes_what_the_jax_auto_takes(monkeypatch, op, shape,
                                                     n, want):
    """The port's AUTO with the ranks on a device: every size on the
    slice's path reaches the kernel the JAX AUTO picks (the kernel
    launches are replaced by recorders that return the plain results)."""
    taken = []

    def rec(plain):
        def kernel(method, xs, ctx, *a, **kw):
            taken.append(method.name)
            return plain(method, xs)
        return kernel

    def rs_plain(method, xs):
        m_per = xs[0].shape[0] // len(xs)
        return tcol.reduce_scatter_ring_plain(
            xs, m_per // 2 if method.name == "PALLAS_BIDIR_RING" else None)

    for mod in (tag_mod, tar_mod, trs_mod):
        monkeypatch.setattr(mod, "device_initiable", lambda ctx: True)
    monkeypatch.setattr(tag_mod, "_gather_kernel",
                        rec(lambda m, xs: tcol.all_gather_plain(xs)))
    monkeypatch.setattr(trs_mod, "reduce_scatter_kernel", rec(rs_plain))
    monkeypatch.setattr(tar_mod, "all_reduce_kernel",
                        rec(lambda m, xs: tcol.all_reduce_plain(xs)))
    ctx = port_tp(n, torch.bfloat16)
    xs = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(n)]
    fn = {"ar": tcol.all_reduce, "rs": tcol.reduce_scatter,
          "ag": tcol.all_gather}[op]
    fn(xs, ctx)
    assert taken == want
    if op == "ar":  # the table's first pick is the JAX AUTO's
        jm = jar.get_auto_allreduce_method(shape[0] * shape[1] * 2, n).name
        if jm == "TWO_SHOT" and shape[0] % n == 0:
            hbm = shape[0] * shape[1] * 2 > VMEM_COMM_MAX_BYTES
            assert (want[0] == "PALLAS_RING_HBM") == hbm
        else:  # ONE_SHOT, DOUBLING; or indivisible rows (see above)
            assert want == [jm] or (jm == "TWO_SHOT" and want == ["ONE_SHOT"])


# -- the layer in every mode against the JAX TPMoE ----------------------------

D, E, TOPK, FF = 64, 8, 2, 64


@pytest.mark.parametrize("n", [2, 4])
def test_tp_moe_fwd_every_mode(n):
    rng = np.random.default_rng(80 + n)
    s = D**-0.5
    router = (rng.standard_normal((D, E)) * s).astype(np.float32)
    gate = (rng.standard_normal((E, D, FF)) * s).astype(np.float32)
    up = (rng.standard_normal((E, D, FF)) * s).astype(np.float32)
    down = (rng.standard_normal((E, FF, D)) * FF**-0.5).astype(np.float32)
    x = rng.standard_normal((n * 8, D)).astype(np.float32)
    fl = FF // n
    params = [{"w_router": _t(router),
               "w1": _t(np.concatenate([gate[..., r * fl:(r + 1) * fl],
                                        up[..., r * fl:(r + 1) * fl]], -1)),
               "w2": _t(down[:, r * fl:(r + 1) * fl])} for r in range(n)]
    want = {}
    with jax_tp(n) as jctx:
        layer = jmoe.TPMoE(D, FF, E, TOPK, dtype=jnp.float32, ctx=jctx)
        layer.load(*(jnp.asarray(a) for a in (router, gate, up, down)))
        for mode in ("xla", "xla_ar", "pallas", "pallas_ar"):
            xs = P("tp", None) if mode in ("xla", "pallas") else P()
            f = jax.jit(jctx.shard_map(
                functools.partial(jmoe.tp_moe_fwd, k=TOPK, axis="tp",
                                  mode=mode, ctx=jctx),
                in_specs=(layer.param_specs, xs), out_specs=xs))
            want[mode] = np.asarray(f(layer.params, jnp.asarray(x)))
    ctx = port_tp(n)
    for mode in ("xla", "pallas"):
        out = tp_moe_fwd(params, ctx.shard(_t(x), 0), TOPK, mode=mode,
                         ctx=ctx)
        np.testing.assert_allclose(torch.cat(out).numpy(), want[mode],
                                   atol=ATOL, rtol=0)
    for mode in ("xla_ar", "pallas_ar"):
        out = tp_moe_fwd(params, ctx.replicate(_t(x)), TOPK, mode=mode,
                         ctx=ctx)
        for o in out:
            np.testing.assert_allclose(o.numpy(), want[mode], atol=ATOL,
                                       rtol=0)


# -- weights -------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_params_from_jax_moe_tree_at_tp(n):
    """A JAX Qwen3MoE tree built at tp=n (w1 fused per shard) carries
    over as the shards of the tp=1 tree of the same seed."""
    with jax_tp(1) as ctx1:
        tree1 = jax.tree.map(np.asarray, JaxAutoLLM.from_pretrained(
            "tiny-moe", ctx=ctx1, seed=0).params)
    with jax_tp(n) as ctxn:
        treen = jax.tree.map(np.asarray, JaxAutoLLM.from_pretrained(
            "tiny-moe", ctx=ctxn, seed=0).params)
    want = shard_params(params_from_jax(tree1), n)
    got = params_from_jax(treen, tp=n)
    for g, w in zip(got, want):
        for k in ("w_router", "w1", "w2"):
            np.testing.assert_array_equal(g["layers"]["mlp"][k],
                                          w["layers"]["mlp"][k])
        for k in ("wqkv", "wo"):
            np.testing.assert_array_equal(g["layers"]["attn"][k],
                                          w["layers"]["attn"][k])
        np.testing.assert_array_equal(g["lm_head"], w["lm_head"])
    # Slicing the shard-fused w1 as if it were tp=1 would not match.
    naive = shard_params(params_from_jax(treen), n)
    assert not np.array_equal(naive[1]["layers"]["mlp"]["w1"],
                              want[1]["layers"]["mlp"]["w1"])


def test_moe_tp_init_and_hf_load_are_the_shards_of_tp1():
    """``Qwen3MoE`` at tp=2 draws the tp=1 model's weights rank part by
    rank part; ``load_hf_moe_state_dict(tp=2)`` and ``unshard_params``
    agree with ``shard_params``."""
    m1 = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=4)
    m2 = AutoLLM.from_pretrained("tiny-moe", device="cpu", seed=4, tp=2)
    want = shard_params(m1.params, 2)
    for g, w in zip(m2.params, want):
        for grp in ("attn", "mlp"):
            for k, t in w["layers"][grp].items():
                assert torch.equal(g["layers"][grp][k], t), (grp, k)
        for k in ("embed", "norm", "lm_head"):
            assert torch.equal(g[k], w[k]), k
    back = unshard_params(m2.params)
    for k in ("w_router", "w1", "w2"):
        assert torch.equal(back["layers"]["mlp"][k],
                           m1.params["layers"]["mlp"][k])
    cfg = get_config("tiny-moe")
    rng = np.random.default_rng(6)
    d, f, L = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_layers
    hq, hkv, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    state = {"model.embed_tokens.weight": w(cfg.vocab_size, d),
             "model.norm.weight": w(d), "lm_head.weight": w(cfg.vocab_size, d)}
    for i in range(L):
        p = f"model.layers.{i}."
        state.update({
            p + "input_layernorm.weight": w(d),
            p + "post_attention_layernorm.weight": w(d),
            p + "self_attn.q_proj.weight": w(hq * hd, d),
            p + "self_attn.k_proj.weight": w(hkv * hd, d),
            p + "self_attn.v_proj.weight": w(hkv * hd, d),
            p + "self_attn.o_proj.weight": w(d, hq * hd),
            p + "self_attn.q_norm.weight": w(hd),
            p + "self_attn.k_norm.weight": w(hd),
            p + "mlp.gate.weight": w(cfg.num_experts, d)})
        for j in range(cfg.num_experts):
            q = p + f"mlp.experts.{j}."
            state.update({q + "gate_proj.weight": w(f, d),
                          q + "up_proj.weight": w(f, d),
                          q + "down_proj.weight": w(d, f)})
    got = load_hf_moe_state_dict(cfg, state, tp=2)
    want = shard_params(load_hf_moe_state_dict(cfg, state), 2)
    for g, wt in zip(got, want):
        for k in ("w_router", "w1", "w2"):
            np.testing.assert_array_equal(g["layers"]["mlp"][k],
                                          wt["layers"]["mlp"][k])


# -- tiny-moe at tp=4 through both engines against the JAX engines ----------

_rng = np.random.default_rng(12)
_PREFIX = _rng.integers(0, 256, 24)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, k)]).astype(np.int32)
           for k in (8, 3, 13)]
IDS = np.stack([PROMPTS[0][:32], PROMPTS[2][:32]])
MOE_KEYS = ("moe_routed_tokens", "a2a_dropped", "num_experts",
            "experts_per_tok")


@pytest.fixture(scope="module")
def moe_tp4():
    """The JAX tiny-moe at tp=4 (f32) and the port's, from its weights;
    the JAX engines' greedy tokens and MoE ledgers (mode 'xla': on the
    CPU the JAX AUTO takes XLA)."""
    ctx = mesh_mod.initialize_distributed(tp=4, devices=jax.devices()[:4])
    jm = JaxAutoLLM.from_pretrained("tiny-moe", ctx=ctx, seed=0)
    tree = jax.tree.map(np.asarray, jm.params)
    tm = AutoLLM.from_pretrained("tiny-moe", device="cpu", tp=4)
    tm.set_params(params_from_jax(tree, tp=4))
    with portable_export():
        cont = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, mode="xla",
                             prefix_cache=True)
        gold_cont = [np.asarray(o).tolist()
                     for o in cont.run([(p, GEN) for p in PROMPTS])]
        stats_cont = {k: cont.last_stats[k] for k in MOE_KEYS}
        eng = JaxEngine(jm, mode="xla", paged=True, page_size=PAGE)
        gold_eng = np.asarray(eng.serve(IDS, GEN,
                                        max_length=MAXLEN)).tolist()
        stats_eng = {k: eng.last_stats[k] for k in MOE_KEYS}
    yield tm, (gold_cont, stats_cont), (gold_eng, stats_eng)
    mesh_mod.finalize_distributed()


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_moe_tp4_continuous_engine_emits_the_jax_tokens(moe_tp4, mode,
                                                        prefix_cache):
    tm, (gold, stats), _ = moe_tp4
    eng = ContinuousEngine(tm, max_batch=2, page_size=PAGE, max_length=MAXLEN,
                           mode=mode, prefix_cache=prefix_cache, device="cpu")
    got = [o.tolist() for o in eng.run([(p, GEN) for p in PROMPTS])]
    assert got == gold
    if prefix_cache:  # the JAX golden's traffic: same prefill positions
        assert {k: eng.last_stats[k] for k in MOE_KEYS} == stats


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_moe_tp4_engine_emits_the_jax_tokens(moe_tp4, mode):
    tm, _, (gold, stats) = moe_tp4
    eng = Engine(tm, mode=mode, paged=True, page_size=PAGE, device="cpu")
    out = eng.serve(IDS, GEN, max_length=MAXLEN)
    assert out.tolist() == gold
    assert {k: eng.last_stats[k] for k in MOE_KEYS} == stats


# -- refusals that remain --------------------------------------------------------


def test_moe_tp_refusals():
    # The MoE megakernel serves at tp>1 (tests/test_torch_mega_moe_tp.py);
    # its int8 pool and sampling stay refused there (queue 1 position 4;
    # the engines refuse both knobs at tp>1 under item 11).
    import dataclasses

    from triton_distributed_tpu_torch.megakernel import MegaConfig, MegaQwen3
    from triton_distributed_tpu_torch.megakernel.code_generator import (
        check_dims,
    )

    m = AutoLLM.from_pretrained("tiny-moe", device="cpu", tp=2)
    with pytest.raises(NotImplementedError, match="item 11"):
        Engine(m, mode="mega", paged=True, kv_dtype="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        ContinuousEngine(m, mode="mega", temperature=0.7, page_size=PAGE,
                         max_length=MAXLEN, device="cpu")
    dims = MegaQwen3(m)._dims(2, MAXLEN, PAGE, num_pages=8)
    check_dims(dims, MegaConfig())
    for kw in (dict(kv_quant=True), dict(sampled=True, nsteps=4,
                                         v_real=256)):
        with pytest.raises(NotImplementedError, match="position 4"):
            check_dims(dataclasses.replace(dims, **kw), MegaConfig())
    # mode="ring" serves (ops/moe/ring_moe.py) and equals mode="xla";
    # the pull all-gather serves too (its CPU form is the plain gather).
    ctx = port_tp(2)
    mlp = [{k: v[0] for k, v in q["layers"]["mlp"].items()}
           for q in m.rank_params]
    x = ctx.shard(torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, D)).astype(np.float32)), 0)
    ring = tp_moe_fwd(mlp, x, 2, mode="ring", ctx=ctx)
    xla = tp_moe_fwd(mlp, x, 2, mode="xla", ctx=ctx)
    for a, b in zip(ring, xla):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    pull = tcol.all_gather(x, ctx, AllGatherMethod.PALLAS_PULL)
    for a, b in zip(pull, tcol.all_gather(x, ctx, AllGatherMethod.XLA)):
        assert torch.equal(a, b)
