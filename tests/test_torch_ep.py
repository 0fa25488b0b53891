"""Expert-parallel MoE dispatch/combine, the EP exchange, the dense
all-to-all and the ring MoE of the port against the JAX package, on the
CPU.

The port runs n co-located ranks in one process; on the CPU its
exchanges take their plain versions (the EP exchange writes NaN bytes
past every count, so a missing mask shows). The JAX side runs as its own
tests run it, on the conftest's CPU mesh (``tp`` axis), computed once per
module: the ``xla`` transport (JAX's own test holds it bit-identical to
``pallas``), and each interpret-mode Pallas kernel once (``ep_exchange``
on skewed splits, ``all_to_all``).

Tolerances:
- packed row bytes, fp8 codes and scales, ``DispatchState``, the
  exchanges' rows within counts, the dispatched rows: exact;
- ``ep_moe_ffn`` and ``tp_moe_fwd(mode="ring")`` in f32: atol 2e-6,
  rtol 0 (outputs ~0.1; the expert GEMMs sum in another order:
  ``torch.matmul`` against ``ragged_dot``), and the port's transports
  equal bit for bit.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.layers import tp_moe as jmoe
from triton_distributed_tpu.ops.moe.routing import router_topk as j_router
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers.tp_moe import tp_moe_fwd
from triton_distributed_tpu_torch.ops.collectives import all_to_all_op
from triton_distributed_tpu_torch.runtime import initialize_distributed

# The modules (the packages export functions of the same names).
ja2a = importlib.import_module(
    "triton_distributed_tpu.ops.collectives.all_to_all")
jep = importlib.import_module("triton_distributed_tpu.ops.moe.ep_a2a")
jex = importlib.import_module("triton_distributed_tpu.ops.moe.ep_exchange")
tep = importlib.import_module("triton_distributed_tpu_torch.ops.moe.ep_a2a")
tex = importlib.import_module(
    "triton_distributed_tpu_torch.ops.moe.ep_exchange")

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 2e-6
E, D, F, K, T_LOC = 8, 32, 64, 2, 8
# name -> (n, capacity_factor, payload, skewed router)
CASES = {
    "lossless4": (4, None, None, False),
    "capacity4": (4, 1.25, None, False),
    "adversarial4": (4, None, None, True),
    "adversarial_cap4": (4, 1.0, None, True),
    "fp8_4": (4, None, "fp8", False),
    "fp8_cap2": (2, 1.25, "fp8", True),
    "lossless2": (2, None, None, False),
}
STATE = ("dest", "slot", "valid", "splits", "recv_counts", "num_dropped",
         "token_ids")


def _weights(seed: int = 7):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    return dict(w_router=mk(D, E), gate=mk(E, D, F), up=mk(E, D, F),
                down=mk(E, F, D))


def _inputs(name: str, w: dict):
    n, _, _, skew = CASES[name]
    rng = np.random.default_rng(100 + len(name))
    x = (rng.standard_normal((n * T_LOC, D)) * 0.1).astype(np.float32)
    wr = w["w_router"]
    if skew:
        # Positive tokens + a +-100 column bias: every top-k lands on rank
        # 0's experts (tests/test_moe.py:101).
        x = np.abs(x)
        wr = wr.copy()
        wr[:, :E // n] += 100.0
        wr[:, E // n:] -= 100.0
    return x, wr


def _port_ctx(n):
    return initialize_distributed(n, device="cpu", dtype=torch.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_oracles():
    """Every JAX output the file compares with, computed once."""
    w = _weights()
    w1 = np.concatenate([w["gate"], w["up"]], axis=2)
    out = {}
    for n in (4, 2):
        ctx = mesh_mod.initialize_distributed(tp=n, devices=jax.devices()[:n])
        try:
            for name, (nn, cf, pd, _) in CASES.items():
                if nn != n:
                    continue
                x, wr = _inputs(name, w)

                def body(x_loc, w_router, a, b, cf=cf, pd=pd):
                    o, st = jep.ep_moe_ffn(
                        x_loc, w_router, a, b, K, axis="tp", method="xla",
                        capacity_factor=cf, payload_dtype=pd,
                        return_state=True, ctx=ctx)
                    route = j_router(x_loc, w_router, K)
                    cap = None if cf is None else int(
                        -(-(x_loc.shape[0] * K * cf / n) // 8) * 8)
                    rx, re, rv, _ = jep.ep_dispatch(
                        x_loc, route, E, cap, axis="tp", method="xla",
                        ctx=ctx, payload_dtype=pd)
                    return (o, rx, re, rv,
                            *(getattr(st, f)[None] for f in STATE))

                f = jax.jit(ctx.shard_map(
                    body, in_specs=(P("tp", None), P(), P("tp", None, None),
                                    P("tp", None, None)),
                    out_specs=(P("tp", None), P("tp", None), P("tp"),
                               P("tp")) + (P("tp"),) * len(STATE)))
                res = [np.asarray(a) for a in f(x, wr, w1, w["down"])]
                out[name] = dict(out=res[0], recv_x=res[1], recv_e=res[2],
                                 recv_v=res[3], **dict(zip(STATE, res[4:])))
            if n == 4:
                out["exchange"] = _jax_exchange(ctx)
                xa = np.random.default_rng(3).standard_normal(
                    (4, 4 * 3, 5)).astype(np.float32)
                out["a2a_in"] = xa
                out["a2a"] = np.asarray(ja2a.all_to_all_op(
                    jnp.asarray(xa), axis="tp", method="pallas", ctx=ctx))
                out["ring"] = _jax_ring(ctx, w)
        finally:
            mesh_mod.finalize_distributed()
    return out


# The exchange oracle: rank r sends SPLITS[r][p] rows of its segment p
# (empty, partial and full segments; counts not a multiple of 32).
SPLITS = np.array([[40, 0, 33, 1], [7, 64, 0, 0], [0, 5, 64, 31],
                   [64, 64, 64, 64]], np.int32)
EX_CAP, EX_R = 64, 256


def _exchange_rows():
    return np.random.default_rng(11).integers(
        0, 255, (4, 4, EX_CAP, EX_R), dtype=np.uint8)


def _jax_exchange(ctx):
    rows = _exchange_rows()

    def body(r, s, c):
        return jex.ep_exchange(r[0], s[0], c[0], axis="tp", ctx=ctx)[None]

    f = ctx.shard_map(body, in_specs=(P("tp"), P("tp"), P("tp")),
                      out_specs=P("tp"))
    return np.asarray(f(jnp.asarray(rows), jnp.asarray(SPLITS),
                        jnp.asarray(SPLITS.T.copy())))


def _ring_params(w, n):
    fl = F // n
    return [{"w_router": _t(w["w_router"]),
             "w1": _t(np.concatenate([w["gate"][..., r * fl:(r + 1) * fl],
                                      w["up"][..., r * fl:(r + 1) * fl]], -1)),
             "w2": _t(w["down"][:, r * fl:(r + 1) * fl])} for r in range(n)]


def _ring_x():
    return (np.random.default_rng(5).standard_normal((4 * T_LOC, D))
            * 0.1).astype(np.float32)


def _jax_ring(ctx, w):
    layer = jmoe.TPMoE(D, F, E, K, dtype=jnp.float32, ctx=ctx)
    layer.load(*(jnp.asarray(w[a]) for a in ("w_router", "gate", "up",
                                              "down")))
    f = jax.jit(ctx.shard_map(
        functools.partial(jmoe.tp_moe_fwd, k=K, axis="tp", mode="ring",
                          ctx=ctx),
        in_specs=(layer.param_specs, P("tp", None)),
        out_specs=P("tp", None)))
    return np.asarray(f(layer.params, jnp.asarray(_ring_x())))


# -- the row codec -------------------------------------------------------------


@pytest.mark.parametrize("payload", ["bf16", "fp8"])
def test_pack_rows_bytes_equal_jax(payload):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((10, 24)).astype(np.float32)
    ids = rng.integers(0, 8, (10, 1)).astype(np.int32)
    if payload == "fp8":
        # Jitted, as every JAX caller runs it (XLA multiplies by the
        # reciprocal of 448 there; an eager call divides).
        jq, jsc = jax.jit(jep._fp8_encode)(jnp.asarray(x))
        tq, tsc = tep._fp8_encode(_t(x))
        np.testing.assert_array_equal(
            np.asarray(jax.lax.bitcast_convert_type(jq, jnp.uint8)),
            tq.view(torch.uint8).numpy())
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
        jparts = [jq, jsc, jnp.asarray(ids)]
        tparts = [tq, tsc, _t(ids)]
        dt, jdt = torch.float8_e4m3fn, jnp.float8_e4m3fn
    else:
        xb = jnp.asarray(x, jnp.bfloat16)
        jparts = [xb, jnp.asarray(ids)]
        tparts = [_t(x).to(torch.bfloat16), _t(ids)]
        dt, jdt = torch.bfloat16, jnp.bfloat16
    jrows, joffs = jex.pack_rows(jparts)
    trows, toffs = tex.pack_rows(tparts)
    assert toffs == joffs and trows.shape[-1] % 128 == 0
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())
    back = tex.unpack_row(trows, toffs[0], dt, 24)
    want = jex.unpack_row(jrows, joffs[0], jdt, 24)
    np.testing.assert_array_equal(
        back.view(torch.uint8).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(want, jnp.uint8)).reshape(
            back.view(torch.uint8).shape))
    ids_back = tex.unpack_row(trows, toffs[-1], torch.int32, 1)
    np.testing.assert_array_equal(ids_back.numpy(), ids)


# -- the exchanges ----------------------------------------------------------------


def test_ep_exchange_plain_equals_jax_kernel(jax_oracles):
    """The plain exchange equals the interpret-mode TPU kernel on every
    row within a count (empty, partial, full segments) and writes NaN
    bytes past each count."""
    rows = _exchange_rows()
    ctx = _port_ctx(4)
    got = tex.ep_exchange([_t(r) for r in rows],
                          [_t(s) for s in SPLITS],
                          [_t(c.copy()) for c in SPLITS.T], ctx)
    want = jax_oracles["exchange"]
    for p in range(4):
        for s in range(4):
            cnt = SPLITS[s, p]
            np.testing.assert_array_equal(got[p][s, :cnt].numpy(),
                                          want[p, s, :cnt])
            assert (got[p][s, cnt:] == tex.POISON).all()
    with pytest.raises(ValueError, match="lane-aligned"):
        tex.ep_exchange([_t(r[..., :100]) for r in rows],
                        [_t(s) for s in SPLITS], [_t(s) for s in SPLITS], ctx)


@pytest.mark.parametrize("method", ["auto", "xla", "pallas"])
def test_all_to_all_equals_jax(jax_oracles, method):
    ctx = _port_ctx(4)
    got = all_to_all_op(_t(jax_oracles["a2a_in"]), ctx, method=method)
    np.testing.assert_array_equal(got.numpy(), jax_oracles["a2a"])


# -- dispatch, combine, the whole layer -------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_ep_moe_ffn_equals_jax(jax_oracles, name):
    """Both transports (``pallas`` takes the plain exchange on the CPU)
    against the JAX ``xla`` transport: the state and the dispatched rows
    exactly, the output within ATOL; the port's transports bitwise
    equal."""
    n, cf, pd, _ = CASES[name]
    w = _weights()
    x, wr = _inputs(name, w)
    want = jax_oracles[name]
    ctx = _port_ctx(n)
    xs = list(torch.chunk(_t(x), n))
    w1 = np.concatenate([w["gate"], w["up"]], axis=2)
    epr = E // n
    w1s = [_t(w1[r * epr:(r + 1) * epr]) for r in range(n)]
    w2s = [_t(w["down"][r * epr:(r + 1) * epr]) for r in range(n)]
    outs = {}
    for method in ("xla", "pallas"):
        outs[method], states = tep.ep_moe_ffn(
            xs, _t(wr), w1s, w2s, K, ctx=ctx, method=method,
            capacity_factor=cf, payload_dtype=pd, return_state=True)
        for f in STATE:
            got = np.stack([np.asarray(getattr(s, f)) for s in states])
            np.testing.assert_array_equal(
                got.reshape(want[f].shape), want[f], err_msg=f"{method} {f}")
        np.testing.assert_allclose(torch.cat(outs[method]).numpy(),
                                   want["out"], atol=ATOL, rtol=0)
    for a, b in zip(outs["xla"], outs["pallas"]):
        assert torch.equal(a, b)
    if name == "adversarial_cap4":
        assert want["num_dropped"].max() > 0
    elif cf is None:
        assert (want["num_dropped"] == 0).all()
    # The dispatched rows, both transports.
    routes = [tep.router_topk(x_, _t(wr), K) for x_ in xs]
    cap = None if cf is None else int(-(-(T_LOC * K * cf / n) // 8) * 8)
    for method in ("xla", "pallas"):
        rx, re, rv, _ = tep.ep_dispatch(xs, routes, E, cap, ctx=ctx,
                                        method=method, payload_dtype=pd)
        np.testing.assert_array_equal(torch.cat(rx).numpy(), want["recv_x"])
        np.testing.assert_array_equal(torch.cat(re).numpy(), want["recv_e"])
        np.testing.assert_array_equal(torch.cat(rv).numpy(), want["recv_v"])


def test_ep_combine_mask_holds_off_poison():
    """The rows a rank gets back past each destination's count are the
    plain exchange's NaN bytes; the combine's count mask turns them to 0.
    Without it a weight-0 assignment whose (clamped) slot lands on such a
    row makes the token NaN (NaN * 0 = NaN): the negative control the
    card repeats."""
    n, name = 4, "capacity4"
    w = _weights()
    x, wr = _inputs(name, w)
    ctx = _port_ctx(n)
    xs = list(torch.chunk(_t(x), n))
    routes = [tep.router_topk(x_, _t(wr), K) for x_ in xs]
    cap = int(-(-(T_LOC * K * 1.25 / n) // 8) * 8)
    rx, _, _, states = tep.ep_dispatch(xs, routes, E, cap, ctx=ctx,
                                       method="pallas")
    outs = tep.ep_combine(rx, states, T_LOC, ctx=ctx, method="pallas")
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    rows = [tex.pack_rows([r.reshape(n, cap, D)])[0] for r in rx]
    back = tex.ep_exchange(rows, [s.recv_counts for s in states],
                           [s.splits for s in states], ctx)
    raw = [tex.unpack_row(b, 0, torch.float32, D) for b in back]
    st = states[0]
    sent = torch.arange(cap)[None, :] < st.splits[:, None]
    assert (~sent).any()
    assert torch.isnan(raw[0][~sent]).all() and not torch.isnan(
        raw[0][sent]).any()
    p = int(torch.argmin(st.splits))  # a destination with unsent rows
    slot = st.slot.clone()
    valid = st.valid.clone()
    dest = st.dest.clone()
    dest[0], slot[0], valid[0] = p, int(st.splits[p]), False
    bad = st._replace(dest=dest, slot=slot, valid=valid)
    assert torch.isnan(tep.combine_rows(raw[0], bad, T_LOC)[0]).all()
    masked = torch.where(sent[..., None], raw[0], torch.zeros_like(raw[0]))
    assert torch.isfinite(tep.combine_rows(masked, bad, T_LOC)).all()


def test_tp_moe_ring_equals_jax(jax_oracles):
    """``tp_moe_fwd(mode="ring")`` serves and equals the JAX ring MoE."""
    ctx = _port_ctx(4)
    w = _weights()
    out = tp_moe_fwd(_ring_params(w, 4), ctx.shard(_t(_ring_x()), 0), K,
                     mode="ring", ctx=ctx)
    np.testing.assert_allclose(torch.cat(out).numpy(), jax_oracles["ring"],
                               atol=ATOL, rtol=0)
