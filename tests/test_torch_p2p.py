"""The pipeline neighbour shift of the port against the JAX package, on the
CPU.

The port runs n co-located ranks in one process, one tensor a rank; on
the CPU ``pp_shift`` takes its plain version. The JAX side runs as
``tests/test_p2p.py`` runs it, on the conftest's CPU devices, once per
module: ``pp_shift`` with ``method="pallas"`` (the interpret-mode
``_shift_kernel``) and ``"xla"``, wrap off and on, at n = 4 over ``tp``,
over the ``tp`` axis of a dp x tp = 2 x 4 mesh, and at n = 1;
``pp_send_recv`` from 1 to 3. A shift moves bytes only: every comparison
is exact.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.parallel import pp_send_recv as j_send_recv
from triton_distributed_tpu.parallel import pp_shift as j_shift
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.parallel import (
    pp_recv_from_prev,
    pp_send_recv,
    pp_shift,
)
from triton_distributed_tpu_torch.runtime import initialize_distributed

tp2p = importlib.import_module("triton_distributed_tpu_torch.parallel.p2p")

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

N = 4


def _x(rows, seed=0):
    """``[rows, 8, 128]`` f32: row i is rank i's buffer."""
    return np.random.default_rng(seed).standard_normal(
        (rows, 8, 128)).astype(np.float32)


def _ranks(x):
    return [torch.from_numpy(x[r].copy()) for r in range(x.shape[0])]


@pytest.fixture(scope="module")
def jax_oracles():
    out = {}
    x = jnp.asarray(_x(N))
    ctx = mesh_mod.initialize_distributed(tp=N, devices=jax.devices()[:N])
    try:
        for wrap in (False, True):
            for method in ("pallas", "xla"):
                f = ctx.shard_map(
                    functools.partial(j_shift, axis="tp", wrap=wrap,
                                      method=method, ctx=ctx),
                    in_specs=P("tp"), out_specs=P("tp"))
                out[(N, wrap, method)] = np.asarray(f(x))
        f = ctx.shard_map(
            functools.partial(j_send_recv, src=1, dst=3, axis="tp"),
            in_specs=P("tp"), out_specs=P("tp"))
        out["send_recv"] = np.asarray(f(x))
    finally:
        mesh_mod.finalize_distributed()
    ctx = mesh_mod.initialize_distributed(dp=2, tp=N)
    try:
        x8 = jnp.asarray(_x(2 * N, seed=1))
        for wrap in (False, True):
            f = ctx.shard_map(
                functools.partial(j_shift, axis="tp", wrap=wrap,
                                  method="pallas", ctx=ctx),
                in_specs=P(("dp", "tp")), out_specs=P(("dp", "tp")))
            out[("2x4", wrap)] = np.asarray(f(x8))
    finally:
        mesh_mod.finalize_distributed()
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    try:
        x1 = jnp.asarray(_x(1, seed=2))
        for wrap in (False, True):
            f = ctx.shard_map(
                functools.partial(j_shift, axis="tp", wrap=wrap,
                                  method="pallas", ctx=ctx),
                in_specs=P("tp"), out_specs=P("tp"))
            out[(1, wrap, "pallas")] = np.asarray(f(x1))
    finally:
        mesh_mod.finalize_distributed()
    return out


@pytest.mark.parametrize("method", ["pallas", "xla", "auto"])
@pytest.mark.parametrize("wrap", [False, True])
def test_pp_shift_equals_jax(jax_oracles, wrap, method):
    """Every rank's buffer bitwise the JAX shift's (the interpret-mode
    kernel and ``ppermute`` agree, and so does every port method)."""
    np.testing.assert_array_equal(jax_oracles[(N, wrap, "pallas")],
                                  jax_oracles[(N, wrap, "xla")])
    ctx = initialize_distributed(N, device="cpu", dtype=torch.float32)
    got = pp_shift(_ranks(_x(N)), ctx, wrap=wrap, method=method)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  jax_oracles[(N, wrap, "pallas")])
    again = pp_recv_from_prev(_ranks(_x(N)), ctx, wrap=wrap, method=method)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("wrap", [False, True])
def test_pp_shift_over_dp_groups_equals_jax(jax_oracles, wrap):
    """Over a dp x tp = 2 x 4 context the shift runs in each dp group, as
    the JAX ``axis="tp"`` shift on a 2 x 4 mesh."""
    ctx = initialize_distributed(N, dp=2, device="cpu", dtype=torch.float32)
    got = pp_shift(_ranks(_x(2 * N, seed=1)), ctx, wrap=wrap)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  jax_oracles[("2x4", wrap)])


@pytest.mark.parametrize("wrap", [False, True])
def test_pp_shift_one_rank_equals_jax(jax_oracles, wrap):
    ctx = initialize_distributed(1, device="cpu", dtype=torch.float32)
    got = pp_shift(_ranks(_x(1, seed=2)), ctx, wrap=wrap, method="pallas")
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  jax_oracles[(1, wrap, "pallas")])


def test_pp_send_recv_equals_jax(jax_oracles):
    ctx = initialize_distributed(N, device="cpu", dtype=torch.float32)
    got = pp_send_recv(_ranks(_x(N)), 1, 3, ctx)
    np.testing.assert_array_equal(torch.stack(got).numpy(),
                                  jax_oracles["send_recv"])
    with pytest.raises(ValueError, match="out of range"):
        pp_send_recv(_ranks(_x(N)), 1, N, ctx)


def test_pp_shift_refusals():
    """An explicit kernel method on a 1-D input raises, as does an unknown
    method or a rank count off the context."""
    ctx = initialize_distributed(N, device="cpu", dtype=torch.float32)
    flat = [torch.zeros(16) for _ in range(N)]
    with pytest.raises(ValueError, match=">= 2-D"):
        pp_shift(flat, ctx, method="pallas")
    assert all(torch.equal(a, b) for a, b in zip(
        pp_shift(flat, ctx), pp_shift(flat, ctx, method="xla")))
    with pytest.raises(ValueError, match="unknown"):
        pp_shift(_ranks(_x(N)), ctx, method="ring")
    with pytest.raises(ValueError, match="tensors"):
        pp_shift(_ranks(_x(N))[:3], ctx)


def test_card_dispatch_takes_the_kernel(monkeypatch):
    """On the card AUTO launches the kernel for every >= 2-D input and the
    plain version only for a 1-D one (the kernel replaced by a recording
    plain version, the device check by True)."""
    calls = []

    def kernel(xs, ctx, wrap=False):
        calls.append((len(xs), wrap))
        return tp2p.pp_shift_plain(xs, wrap)

    monkeypatch.setattr(tp2p, "device_initiable", lambda ctx: True)
    monkeypatch.setattr(tp2p, "pp_shift_kernel", kernel)
    ctx = initialize_distributed(N, dp=2, device="cpu", dtype=torch.float32)
    got = pp_shift(_ranks(_x(2 * N, seed=1)), ctx, wrap=True)
    assert calls == [(N, True), (N, True)]
    want = pp_shift(_ranks(_x(2 * N, seed=1)), ctx, wrap=True, method="xla")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pp_shift([torch.zeros(16) for _ in range(2 * N)], ctx)
    assert len(calls) == 2
