"""The pull and 2-D torus all-gathers, the broadcast, the low-latency
all-gather and the two-level collectives of the port against the JAX
package, on the CPU.

The port runs n co-located ranks in one process, one tensor a rank; on
the CPU every kernel method takes its plain version. The JAX side runs as
``tests/test_collectives.py`` runs it, on the conftest's CPU devices,
once per module: the interpret-mode ``_pull_kernel`` (windows 1, 2, 3, 8
at n = 4), ``_one_shot_bcast_kernel`` (roots 0 and 2) and ``_ll_ag_kernel``
(1 and 3 chained steps at n = 4, 2 at n = 8; interpret mode runs its
entry-barrier variant), ``_torus_2d_kernel`` on a dp x tp = 2 x 4 mesh,
and the hierarchical ops, whose AUTO inner stages take XLA on the CPU.

Tolerances: the byte movers (gathers, broadcast) exact; the two-level
sums in f32, atol = rtol = 1e-5 (eight addends of ~N(0, 1) summed in
another order: XLA's ``psum_scatter``/``psum`` against the port's
rank-order fold, a few f32 ulps of |sum| <= ~10).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.ops import AllGatherMethod as JAGM
from triton_distributed_tpu.ops import BroadcastMethod as JBM
from triton_distributed_tpu.ops import all_gather_op as j_ag_op
from triton_distributed_tpu.ops import broadcast_op as j_bcast_op
from triton_distributed_tpu.ops import ll_all_gather_op as j_ll_op
from triton_distributed_tpu.ops.collectives import hierarchical as jhier
from triton_distributed_tpu.ops.collectives.all_gather import (
    all_gather_torus_2d as j_torus,
)
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.ops import cuda_kernels as tck
from triton_distributed_tpu_torch.ops.collectives import (
    AllGatherMethod,
    BroadcastMethod,
    all_gather,
    all_gather_2d,
    all_gather_2d_op,
    all_gather_op,
    all_gather_torus_2d,
    all_reduce_2level,
    all_reduce_2level_op,
    broadcast,
    broadcast_op,
    ll_all_gather,
    ll_all_gather_op,
    ll_all_gather_workspace,
    ll_expected_flags,
    ll_flags,
    reduce_scatter_2d,
)
from triton_distributed_tpu_torch.ops.collectives import _launch
from triton_distributed_tpu_torch.runtime import initialize_distributed

# The modules (the packages export functions of the same names).
tag = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.all_gather")
tbc = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.broadcast")
tll = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.low_latency")

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

SUM_TOL = dict(atol=1e-5, rtol=1e-5)
WINDOWS = (1, 2, 3, 8)
ROOTS = (0, 2)
LL_STEPS = ((4, 1), (4, 3), (8, 2))  # (n, chained calls)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cpu(n, dp=1, dtype=torch.float32):
    return initialize_distributed(n, dp=dp, device="cpu", dtype=dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_oracles():
    out = {}
    ctx = mesh_mod.initialize_distributed(tp=4, devices=jax.devices()[:4])
    try:
        x = jnp.asarray(_np((4 * 8, 128), 0))
        for w in WINDOWS:
            out[("pull", w)] = np.asarray(j_ag_op(
                x, "tp", JAGM.PALLAS_PULL, ctx, pull_window=w))
        xb = jnp.asarray(_np((4, 16, 128), 1))
        for root in ROOTS:
            for m in ("one_shot", "xla"):
                out[("bcast", root, m)] = np.asarray(
                    j_bcast_op(xb, "tp", root, JBM(m), ctx))
        for n, steps in LL_STEPS:
            if n == 4:
                out[("ll", n, steps)] = np.asarray(j_ll_op(
                    jnp.asarray(_np((n * 8, 128), 2 + steps)), steps=steps,
                    axis="tp", ctx=ctx))
    finally:
        mesh_mod.finalize_distributed()
    ctx = mesh_mod.initialize_distributed(tp=8)
    try:
        for n, steps in LL_STEPS:
            if n == 8:
                out[("ll", n, steps)] = np.asarray(j_ll_op(
                    jnp.asarray(_np((n * 8, 128), 2 + steps)), steps=steps,
                    axis="tp", ctx=ctx))
    finally:
        mesh_mod.finalize_distributed()
    ctx = mesh_mod.initialize_distributed(dp=2, tp=4)
    try:
        f = ctx.shard_map(
            lambda xi: j_torus(xi, axes=("dp", "tp"), ctx=ctx),
            in_specs=P(("dp", "tp"), None), out_specs=P(None, None))
        out["torus"] = np.asarray(f(jnp.asarray(_np((8 * 8, 128), 10))))
        out["ag2d"] = np.asarray(jhier.all_gather_2d_op(
            jnp.asarray(_np((8 * 4, 128), 11)), inner_axis="tp",
            outer_axis="dp", ctx=ctx))
        out["ar2"] = np.asarray(jhier.all_reduce_2level_op(
            jnp.asarray(_np((8, 16, 128), 12)), inner_axis="tp",
            outer_axis="dp", ctx=ctx))
        f = ctx.shard_map(
            lambda xi: jhier.reduce_scatter_2d(
                xi[0], inner_axis="tp", outer_axis="dp", ctx=ctx),
            in_specs=P(("dp", "tp"), None, None),
            out_specs=P(("tp", "dp"), None))
        out["rs2d"] = np.asarray(f(jnp.asarray(_np((8, 64, 128), 13))))
    finally:
        mesh_mod.finalize_distributed()
    return out


# -- the pull all-gather ----------------------------------------------------------


@pytest.mark.parametrize("window", WINDOWS)
def test_pull_all_gather_equals_jax(jax_oracles, window):
    """``PALLAS_PULL`` at every window: every rank's gather bitwise the
    JAX interpret-mode pull kernel's (which is the input itself)."""
    x = _np((4 * 8, 128), 0)
    want = jax_oracles[("pull", window)]
    np.testing.assert_array_equal(want, x)
    got = all_gather_op(_t(x), _cpu(4), AllGatherMethod.PALLAS_PULL,
                        pull_window=window)
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_pull_equals_xla_at_odd_widths():
    for shape, dtype in (((3, 5), torch.float32), ((3, 99), torch.bfloat16)):
        ctx = _cpu(2, dtype=dtype)
        xs = [torch.randn(shape).to(dtype) for _ in range(2)]
        for a, b in zip(all_gather(xs, ctx, AllGatherMethod.PALLAS_PULL, 1),
                        all_gather(xs, ctx, AllGatherMethod.XLA)):
            assert torch.equal(a, b)


# -- the 2-D torus all-gather ------------------------------------------------------


def test_torus_2d_equals_jax(jax_oracles):
    """dp x tp = 2 x 4: rank-major slots, every rank bitwise the JAX
    interpret-mode torus kernel's."""
    x = _np((8 * 8, 128), 10)
    np.testing.assert_array_equal(jax_oracles["torus"], x)
    ctx = _cpu(4, dp=2)
    got = all_gather_torus_2d([_t(c) for c in np.split(x, 8)], ctx)
    assert len(got) == 8
    for g in got:
        np.testing.assert_array_equal(g.numpy(), jax_oracles["torus"])


def test_torus_2d_refusals():
    ctx = _cpu(4, dp=2)
    xs = [torch.zeros(8, 16) for _ in range(8)]
    with pytest.raises(ValueError, match="axes"):
        all_gather_torus_2d(xs, ctx, axes=("tp", "dp"))
    with pytest.raises(ValueError, match=">= 2-D"):
        all_gather_torus_2d([torch.zeros(16) for _ in range(8)], ctx)
    with pytest.raises(ValueError, match="tensors"):
        all_gather_torus_2d(xs[:4], ctx)


# -- the broadcast ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["one_shot", "xla", "auto"])
@pytest.mark.parametrize("root", ROOTS)
def test_broadcast_equals_jax(jax_oracles, root, method):
    x = _np((4, 16, 128), 1)
    want = jax_oracles[("bcast", root, "one_shot")]
    np.testing.assert_array_equal(jax_oracles[("bcast", root, "xla")], want)
    got = broadcast_op(_t(x), _cpu(4), root, BroadcastMethod(method))
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_broadcast_refusals():
    ctx = _cpu(4)
    xs = [torch.zeros(4, 8) for _ in range(4)]
    for root in (-1, 4):
        with pytest.raises(ValueError, match="out of range"):
            broadcast(xs, ctx, root)
    flat = [torch.arange(8.0) + r for r in range(4)]
    with pytest.raises(ValueError, match=">= 2-D"):
        broadcast(flat, ctx, 1, BroadcastMethod.ONE_SHOT)
    assert all(torch.equal(g, flat[1]) for g in broadcast(flat, ctx, 1))


# -- the low-latency all-gather ------------------------------------------------------


@pytest.mark.parametrize("n,steps", LL_STEPS)
def test_ll_all_gather_equals_jax(jax_oracles, n, steps):
    """``steps`` chained calls on one workspace: the last call's gather on
    every rank bitwise the JAX kernel's (interpret mode runs its
    entry-barrier variant)."""
    x = _np((n * 8, 128), 2 + steps)
    want = jax_oracles[("ll", n, steps)]
    np.testing.assert_array_equal(want, x)
    got = ll_all_gather_op(_t(x), steps, _cpu(n))
    for r in range(n):
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_ll_all_gather_phase_must_advance_by_one():
    """A phase that does not advance by one on its workspace raises (on
    the card its waits would never be met); the workspace's flags start
    at zero and the prediction of the discipline starts there too."""
    ctx = _cpu(4)
    ws = ll_all_gather_workspace(ctx, 8, 16, torch.float32)
    assert ws.phase == -1 and ws.blocks == 1
    assert torch.equal(ll_flags(ws)["acks"], ll_expected_flags(ws))
    xs = [torch.randn(8, 16) for _ in range(4)]
    with pytest.raises(ValueError, match="advances the phase by one"):
        ll_all_gather(xs, ws, 1, ctx)
    out, ws = ll_all_gather(xs, ws, 0, ctx)
    assert torch.equal(out[3], torch.cat(xs))
    for bad in (0, 2):
        with pytest.raises(ValueError, match="advances the phase by one"):
            ll_all_gather(xs, ws, bad, ctx)
    ll_all_gather(xs, ws, torch.tensor(1), ctx)
    assert ws.phase == 1
    with pytest.raises(ValueError, match="workspace takes"):
        ll_all_gather([torch.randn(8, 32) for _ in range(4)], ws, 2, ctx)


@pytest.mark.parametrize("bad", ["shape", "dtype", "ranks", "unequal"])
def test_ll_kernel_refuses_a_mismatched_workspace(bad):
    """The launcher itself refuses shards that its workspace was not made
    for (their bytes would overrun every rank's output and the peers'
    slots), before any launch: a larger shard, a wider dtype at the same
    shape, a workspace of another rank count, ranks of unequal shape."""
    ctx = _cpu(4)
    ws = ll_all_gather_workspace(ctx, 8, 16, torch.bfloat16)
    xs = {"shape": [torch.zeros(16, 16, dtype=torch.bfloat16)] * 4,
          "dtype": [torch.zeros(8, 16)] * 4,
          "ranks": [torch.zeros(8, 16, dtype=torch.bfloat16)] * 2,
          "unequal": [torch.zeros(8, 16, dtype=torch.bfloat16)] * 3
          + [torch.zeros(8, 8, dtype=torch.bfloat16)]}[bad]
    k_ctx = _cpu(2) if bad == "ranks" else ctx
    before = tck.LL_ALL_GATHER.launches
    with pytest.raises(ValueError, match="workspace|rank 0's is"):
        tll.ll_all_gather_kernel(xs, ws, 0, k_ctx)
    assert tck.LL_ALL_GATHER.launches == before and ws.phase == -1


def test_ll_expected_flags_follow_the_phases():
    """The flag values the discipline leaves after k calls: slot p holds
    the last phase of parity p plus one from every peer, 0 from the rank
    itself."""
    ctx = _cpu(3)
    ws = ll_all_gather_workspace(ctx, 2, 4, blocks_per_rank=2)
    w = _launch.RING_WARPS
    want = {-1: (0, 0), 0: (1, 0), 1: (1, 2), 4: (5, 4), 5: (5, 6)}
    for phase, (p0, p1) in want.items():
        ws.phase = phase
        e = ll_expected_flags(ws)
        assert e.shape == (3, 2, 3, 2, w)
        assert e.shape == ll_flags(ws)["acks"].shape
        for r in range(3):
            for c in range(3):
                assert (e[r, 0, c] == (0 if c == r else p0)).all()
                assert (e[r, 1, c] == (0 if c == r else p1)).all()


# -- the two-level collectives --------------------------------------------------------


def test_all_gather_2d_equals_jax(jax_oracles):
    x = _np((8 * 4, 128), 11)
    np.testing.assert_array_equal(jax_oracles["ag2d"], x)
    got = all_gather_2d_op(_t(x), _cpu(4, dp=2))
    for r in range(8):
        np.testing.assert_array_equal(got[r].numpy(), jax_oracles["ag2d"])


def test_all_reduce_2level_equals_jax(jax_oracles):
    x = _np((8, 16, 128), 12)
    got = all_reduce_2level_op(_t(x), _cpu(4, dp=2))
    for r in range(8):
        np.testing.assert_allclose(got[r].numpy(), jax_oracles["ar2"],
                                   **SUM_TOL)
    np.testing.assert_allclose(jax_oracles["ar2"], x.sum(0), **SUM_TOL)


def test_reduce_scatter_2d_equals_jax(jax_oracles):
    """Rank (d, t) holds chunk t * dp + d of the sum (inner-major)."""
    x = _np((8, 64, 128), 13)
    ctx = _cpu(4, dp=2)
    got = reduce_scatter_2d([_t(x[r]) for r in range(8)], ctx)
    want = jax_oracles["rs2d"].reshape(8, 8, 128)
    for d in range(2):
        for t in range(4):
            np.testing.assert_allclose(got[d * 4 + t].numpy(),
                                       want[t * 2 + d], **SUM_TOL)


def test_two_level_refusals():
    ctx = _cpu(4, dp=2)
    xs = [torch.zeros(8, 16) for _ in range(4)]
    for fn in (all_gather_2d, reduce_scatter_2d, all_reduce_2level):
        with pytest.raises(ValueError, match="tensors"):
            fn(xs, ctx)
    with pytest.raises(ValueError, match="not divisible by dp"):
        reduce_scatter_2d([torch.zeros(4, 16) for _ in range(8)], ctx)


# -- the card's dispatch, on the CPU ----------------------------------------------------


def test_card_dispatch_takes_the_kernels(monkeypatch):
    """On the card AUTO takes the broadcast kernel for every >= 2-D input,
    ``PALLAS_PULL`` its kernel with the window, the torus and the LL
    gathers their kernels (the LL barrier-free by default), and AUTO never
    picks the pull: each kernel replaced by a recording plain version,
    the device check by True."""
    calls = []
    ctx = _cpu(4)
    ws = ll_all_gather_workspace(ctx, 8, 16)  # its grid asks the card
    for mod in (tag, tbc, tll):
        monkeypatch.setattr(mod, "device_initiable", lambda ctx: True)

    def rec(name, plain):
        def fn(*args, **kw):
            calls.append((name, args[2:], kw))
            return plain(*args)
        return fn

    monkeypatch.setattr(tbc, "broadcast_kernel", rec(
        "bcast", lambda xs, ctx, root: tbc.broadcast_plain(xs, root)))
    monkeypatch.setattr(tag, "all_gather_pull", rec(
        "pull", lambda xs, ctx, w: tag.all_gather_plain(xs)))
    monkeypatch.setattr(tag, "all_gather_torus_2d_kernel", rec(
        "torus", lambda xs, ctx: tag.all_gather_plain(xs)))
    monkeypatch.setattr(tag, "_gather_kernel", rec(
        "ag", lambda method, xs, ctx, b: tag.all_gather_plain(xs)))
    monkeypatch.setattr(tll, "ll_all_gather_kernel", rec(
        "ll", lambda xs, ws, phase, ctx, bf: tag.all_gather_plain(xs)))
    xs = [torch.randn(8, 16) for _ in range(4)]
    broadcast(xs, ctx, 3)
    broadcast([x[0] for x in xs], ctx, 3)
    all_gather(xs, ctx, AllGatherMethod.PALLAS_PULL, pull_window=3)
    all_gather(xs, ctx)
    all_gather_torus_2d([torch.randn(8, 16) for _ in range(8)],
                        _cpu(4, dp=2))
    ll_all_gather(xs, ws, 0, ctx)
    ll_all_gather(xs, ws, 1, ctx, barrier_free=False)
    assert [(c[0], c[1]) for c in calls] == [
        ("bcast", (3,)), ("pull", (3,)), ("ag", (ctx, None)),
        ("torus", ()), ("ll", (0, ctx, True)), ("ll", (1, ctx, False))]


# -- the ring all-gathers' host-side planning (no card needed) -------------

def test_ring_warps_match_the_kernel_source():
    """``_launch.RING_WARPS`` is the kernel's flagged sub-pieces a block
    (``kRingWarps``: a warp each)."""
    import re

    src = (tck.CSRC / "collectives.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    assert "constexpr int kRingWarps = kThreads / 32;" in src
    assert _launch.RING_WARPS == threads // 32


def _ring_flag_indices(kind, n, blocks):
    """Every flag a ring launch stores on a rank (``ag_ring_kernel``'s
    index, transcribed): the barrier's n, then (dir, hop, block, warp)."""
    dirs = 2 if kind == 2 else 1
    w_dir = _launch.RING_WARPS // dirs
    out = list(range(n))
    for d in range(dirs):
        for s in range(n - 1):
            for g in range(blocks):
                for w in range(w_dir):
                    out.append(n + ((d * (n - 1) + s) * blocks + g) * w_dir
                               + w)
    return out


@pytest.mark.parametrize("kind,n,blocks", [(1, 2, 48), (2, 4, 24),
                                           (1, 3, 5), (2, 3, 1), (2, 2, 7),
                                           (1, 8, 2)])
def test_ring_flags_sized_for_every_sub_piece(kind, n, blocks):
    """One flag a (direction, hop, block, warp), each distinct, all inside
    ``gather_flags``; the full mesh keeps one a (source, block)."""
    idx = _ring_flag_indices(kind, n, blocks)
    assert len(set(idx)) == len(idx)
    assert max(idx) == tag.gather_flags(kind, n, blocks) - 1
    assert tag.gather_flags(0, n, blocks) == n + n * blocks


@pytest.mark.parametrize("shard_bytes,n,want", [
    (96 * 2048 * 2, 4, 24),    # the bidir ring's timed shard
    (192 * 2048 * 2, 2, 48),   # the ring's
    (128 * 129 * 4, 4, 5),     # the SP decode's [128, 129] f32 partials
    (60, 2, 1),
    (1 << 30, 2, 132),         # capped at one block an SM
])
def test_ring_grid_is_sized_to_the_bytes(monkeypatch, shard_bytes, n, want):
    """The rings take ~RING_BLOCK_BYTES of a shard a block, at most what
    stays co-resident over n ranks and MAX_BLOCKS."""
    monkeypatch.setitem(_launch._capacity,
                        (_launch.ALL_GATHER, 2, torch.bfloat16), 1056)
    assert _launch.blocks(_launch.ALL_GATHER, 2, torch.bfloat16, n,
                          shard_bytes, None, _launch.RING_BLOCK_BYTES) == want
    assert _launch.blocks(_launch.ALL_GATHER, 2, torch.bfloat16, n,
                          shard_bytes, 3, _launch.RING_BLOCK_BYTES) == 3


# -- the ring reduce-scatters' and the LL gather's host-side planning ------

trs = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.reduce_scatter")
tar = importlib.import_module(
    "triton_distributed_tpu_torch.ops.collectives.all_reduce")


def _kernel_body(src: str, name: str) -> str:
    """The source of ``__global__`` kernel ``name`` (signature to its
    closing brace at column 0)."""
    start = src.index(f"\n{name}(")
    return src[start:src.index("\n}\n", start)]


def _device_fn(src: str, name: str) -> str:
    start = src.index(f"void {name}(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("kernel,helpers", [
    ("ag_ring_kernel", ("warp_put", "warp_signal", "warp_wait")),
    ("rs_ring_kernel", ("warp_add_put", "warp_signal", "warp_wait")),
    ("ll_ag_kernel", ("warp_copy_k", "warp_signal_k", "warp_wait_k")),
    ("rs_one_shot_kernel", ("sub_piece_of", "warp_copy_k", "warp_signal_k",
                            "warp_wait_k")),
    ("ar_doubling_kernel", ("sub_piece_of", "warp_signal", "warp_wait")),
])
def test_sub_piece_kernels_flag_a_warp_at_device_scope(kernel, helpers):
    """The ring all-gathers, the ring and one-shot reduce-scatters, the
    doubling all-reduce and the LL gather cut a block's piece into
    ``kRingWarps`` sub-pieces (``_launch.RING_WARPS``, held to the source
    above) and neither they nor the helpers they cut, signal and wait with
    hold a system-scope fence, release or acquire, a block-wide flag or a
    barrier at system scope."""
    src = (tck.CSRC / "collectives.cu").read_text()
    body = _kernel_body(src, kernel)
    assert "kRingWarps" in body or "sub_piece_of(" in body
    assert "kRingWarps" in _device_fn(src, "sub_piece_of")
    assert "tdt::barrier_all(" not in body
    for text in [body] + [_device_fn(src, h) for h in helpers]:
        text = text.replace("wait_until<false, true>(", "")
        for bad in ("__threadfence_system", "_sys(", "block_signal",
                    "block_wait", "tdt::signal(", "wait_until("):
            assert bad not in text, (kernel, bad)


def _scatter_flag_indices(kind, n, blocks):
    """Every flag a ring reduce-scatter launch stores on a rank
    (``rs_ring_kernel``'s index, transcribed): the barrier's n, then
    (direction, hop, block, warp). The HBM ring (kind 3) runs the ring's
    kernel: its JAX row tiles are folded into the warps' sub-pieces, so
    its tile axis is one wide."""
    dirs = 2 if kind == 2 else 1
    w_dir = _launch.RING_WARPS // dirs
    out = list(range(n))
    for d in range(dirs):
        for s in range(n - 1):
            for g in range(blocks):
                for w in range(w_dir):
                    out.append(n + ((d * (n - 1) + s) * blocks + g) * w_dir
                               + w)
    return out


@pytest.mark.parametrize("kind", [1, 2, 3])
@pytest.mark.parametrize("n,blocks", [(2, 38), (3, 5), (4, 24), (5, 1),
                                      (8, 132), (7, 3)])
def test_scatter_ring_flags_sized_for_every_sub_piece(kind, n, blocks):
    """One flag a (direction, hop, block, warp), each distinct, all inside
    ``scatter_flags``; the one-shot takes one a (source, block, warp)."""
    idx = _scatter_flag_indices(kind, n, blocks)
    assert len(set(idx)) == len(idx)
    assert max(idx) == trs.scatter_flags(kind, n, blocks) - 1
    assert trs.scatter_flags(0, n, blocks) == (
        n + n * blocks * _launch.RING_WARPS)


@pytest.mark.parametrize("n,blocks", [(2, 24), (3, 5), (4, 24), (5, 1),
                                      (8, 16), (7, 3)])
def test_one_shot_scatter_flags_one_a_sub_piece(n, blocks):
    """``rs_one_shot_kernel``'s index, transcribed: the barrier's n, then
    n + (src * G + g) * W + w, each distinct, filling ``scatter_flags(0,
    ...)``; every flag a rank waits on is set by exactly one peer (its
    source's warp of the same block)."""
    w_n = _launch.RING_WARPS
    idx = list(range(n))
    setters = {}
    for me in range(n):
        for g in range(blocks):
            for w in range(w_n):
                for q in range(n - 1):
                    peer = (me + 1 + q) % n
                    f = n + (me * blocks + g) * w_n + w
                    setters.setdefault((peer, f), []).append(me)
    for src in range(n):
        for g in range(blocks):
            for w in range(w_n):
                idx.append(n + (src * blocks + g) * w_n + w)
    assert sorted(idx) == list(range(trs.scatter_flags(0, n, blocks)))
    assert all(len(v) == 1 for v in setters.values())
    assert len(setters) == n * (n - 1) * blocks * w_n


@pytest.mark.parametrize("n,blocks", [(2, 28), (4, 28), (8, 33), (2, 1),
                                      (8, 132)])
def test_doubling_flags_one_a_round_and_sub_piece(n, blocks):
    """``ar_doubling_kernel``'s index, transcribed: the barrier's n, then
    n + (k * G + g) * W + w for round k of log2 n, each distinct, filling
    ``reduce_flags(1, ...)``; round k's flag on a rank is set by its one
    partner me ^ 2^k, and the one-shot all-reduce keeps one a (source,
    block)."""
    w_n, lg = _launch.RING_WARPS, n.bit_length() - 1
    idx = list(range(n))
    for k in range(lg):
        for g in range(blocks):
            for w in range(w_n):
                idx.append(n + (k * blocks + g) * w_n + w)
    assert sorted(idx) == list(range(tar.reduce_flags(1, n, blocks)))
    for k in range(lg):
        partners = [me ^ (1 << k) for me in range(n)]
        assert sorted(partners) == list(range(n))
        assert all(p != me for me, p in enumerate(partners))
    assert tar.reduce_flags(0, n, blocks) == n + n * blocks


@pytest.mark.parametrize("n,blocks", [(2, 1), (4, 28), (8, 60), (3, 7)])
def test_ll_flags_one_a_sub_piece(n, blocks):
    """The LL gather's arrival and ACK flags (``ll_ag_kernel``'s index,
    transcribed): one a (kind, slot, peer, block, warp), each distinct,
    filling n + 4 n blocks W; ``ll_flags`` reads them with the warp
    axis."""
    w_n = _launch.RING_WARPS
    gw = blocks * w_n
    idx = list(range(n))
    for p in range(2):
        for src in range(n):
            for g in range(blocks):
                for w in range(w_n):
                    sub = g * w_n + w
                    idx.append(n + (p * n + src) * gw + sub)          # arrival
                    idx.append(n + (2 * n + p * n + src) * gw + sub)  # ACK
    assert sorted(idx) == list(range(tll.ll_flag_count(n, blocks)))
    assert tll.ll_flag_count(n, blocks) == n + 4 * n * blocks * w_n
    ws = ll_all_gather_workspace(_cpu(n), 2, 4, blocks_per_rank=blocks)
    assert ws.blocks == blocks
    assert ws.flags.data.shape == (n, tll.ll_flag_count(n, blocks))
    for kind in ("arrivals", "acks"):
        assert ll_flags(ws)[kind].shape == (n, 2, n, blocks, w_n)


@pytest.mark.parametrize("kind,n,rows,dtype,want", [
    (2, 4, 384, torch.bfloat16, 24),    # the bidir ring's timed chunk
    (1, 2, 300, torch.bfloat16, 38),    # the ring's
    (3, 2, 1152, torch.bfloat16, 132),  # the HBM ring's: one block an SM
    (1, 4, 32, torch.float32, 4),       # the stress shape
    (0, 2, 48, torch.bfloat16, 24),     # the one-shot's timed chunk
    (0, 4, 48, torch.bfloat16, 24),     # the one-shot at n = 4
    (0, 2, 4, torch.float32, 4),        # a 16 KB chunk: four of work
])
def test_scatter_grid_is_sized_to_the_bytes(monkeypatch, kind, n, rows,
                                            dtype, want):
    """The rings take ~RING_BLOCK_BYTES of a chunk a block (both
    directions' rows), the one-shot ~RING_BLOCK_BYTES of its 2n chunks of
    work (n read, n - 1 of them pushed out, n summed), at most what stays
    co-resident over n ranks and MAX_BLOCKS; an explicit grid passes
    through."""
    monkeypatch.setitem(_launch._capacity,
                        (_launch.REDUCE_SCATTER, kind, dtype), 1056)
    chunk = rows // n * 2048 * torch.empty((), dtype=dtype).element_size()
    assert trs.scatter_grid(kind, dtype, n, chunk) == want
    assert trs.scatter_grid(kind, dtype, n, chunk, 5) == 5


@pytest.mark.parametrize("kind,n,rows,cap,want", [
    (1, 2, 112, 1056, 28),   # the doubling's timed [112, 2048] bf16
    (1, 4, 112, 1056, 28),
    (1, 8, 256, 1056, 64),   # 1 MB, the AUTO's doubling limit
    (1, 8, 256, 264, 33),    # capped: two blocks an SM over 8 ranks
    (1, 2, 4, 1056, 1),
    (0, 2, 4, 1056, 1),      # the one-shot all-reduce keeps 64 KB a block
    (0, 2, 112, 1056, 7),
])
def test_reduce_grid_is_sized_to_the_bytes(monkeypatch, kind, n, rows, cap,
                                           want):
    """The doubling takes ~RING_BLOCK_BYTES of x a block, the one-shot
    ~BLOCK_BYTES, at most what stays co-resident over n ranks; an explicit
    grid passes through."""
    monkeypatch.setitem(_launch._capacity,
                        (_launch.ALL_REDUCE, kind, torch.bfloat16), cap)
    nbytes = rows * 2048 * 2
    assert tar.reduce_grid(kind, torch.bfloat16, n, nbytes) == want
    assert tar.reduce_grid(kind, torch.bfloat16, n, nbytes, 5) == 5


@pytest.mark.parametrize("n,want", [(4, 28), (8, 60), (2, 12)])
def test_ll_grid_is_sized_to_the_bytes(monkeypatch, n, want):
    """~RING_BLOCK_BYTES of a rank's (2n - 1) shards of work a block at the
    timed [8, 4096] bf16 shard; a workspace made for the card takes it."""
    monkeypatch.setitem(_launch._capacity,
                        (_launch.LOW_LATENCY, 0, torch.bfloat16), 1056)
    assert tll.ll_grid(n, 8 * 4096 * 2, torch.bfloat16) == want
    monkeypatch.setattr(tll, "device_initiable", lambda ctx: True)
    ws = ll_all_gather_workspace(_cpu(n), 8, 4096, torch.bfloat16)
    assert ws.blocks == want
