"""Sequence-parallel attention of the port against the JAX package, on the
CPU: the SP all-gather attention, ring attention, the SP decode layer and
the distributed flash-decode, and the two-level variants over a dp x tp
context.

The port runs n co-located ranks in one process, the sequence sharded in
rank order, one tensor a rank; on the CPU its kernels take their plain
versions. The JAX oracles are its fast references (``mha_reference``
over the whole sequence, ``gqa_decode_reference`` over the whole cache,
``sp_append_kv``, ``distributed_flash_decode`` and its two-level form
under ``portable_export()``), and the interpret-mode ``sp_ag_attention``
kernel once per module (O and LSE). JAX meshes: ``tp`` over 4 devices,
``dp x tp`` = 2 x 2 for the two-level decode. The two-level SP attention
is held to ``mha_reference``: the interpret-mode JAX kernel over a
2 x 2 mesh did not finish in 15 minutes on a CPU host.

Tolerances (f32 unless named): attention and decode outputs and LSEs,
atol = rtol = 2e-5 (the JAX tests' own, summation order); bf16 decode
against the JAX layer that rounds at the same places, atol 2^-8, rtol
2^-7 (an ulp of |O| < 1 flipped by the f32 order); the appended K/V,
exact.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_distributed_tpu.ops.attention.flash_attention import (
    mha_reference as j_mha,
)
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.layers.sp_flash_decode import (
    sp_append_kv,
    sp_decode_attention,
)
from triton_distributed_tpu_torch.ops.attention import (
    distributed_flash_decode,
    distributed_flash_decode_2level,
    ring_attention,
    sp_ag_attention,
    sp_ag_attention_2level,
)
from triton_distributed_tpu_torch.runtime import initialize_distributed

# The modules (the packages export functions of the same names).
jsp = importlib.import_module("triton_distributed_tpu.layers.sp_flash_decode")
jfd = importlib.import_module(
    "triton_distributed_tpu.ops.attention.flash_decode")
jsa = importlib.import_module(
    "triton_distributed_tpu.ops.attention.sp_ag_attention")

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2.0**-8, rtol=2.0**-7)
N, S, HD = 4, 256, 32          # 64 rows a rank
HEADS = [(4, 4), (4, 2), (8, 2)]  # (hq, hkv): G 1, 2, 4
B, DS, CHUNK = 3, 256, 32
# Global lengths: a row ending on rank 0, one inside rank 2 (rank 3 has
# no key), one on a shard edge (ranks 1-3 have none).
LENS = np.array([200, 150, 63], np.int32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _qkv(hq, hkv, s=S, seed=0):
    rng = np.random.default_rng(seed + hq * 10 + hkv)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return mk(hq, s, HD), mk(hkv, s, HD), mk(hkv, s, HD)


def _shards(a, n, axis=1):
    return [_t(c) for c in np.split(a, n, axis=axis)]


def _decode_inputs(seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return dict(q=mk(B, 8, HD), kc=mk(B, 2, DS, HD), vc=mk(B, 2, DS, HD),
                kn=mk(B, 2, HD), vn=mk(B, 2, HD))


def _int8_cache(kc, rng_seed=4):
    """int8 codes and one scale per CHUNK keys per kv head."""
    rng = np.random.default_rng(rng_seed)
    codes = rng.integers(-127, 128, kc.shape).astype(np.int8)
    scales = (rng.random((B, 2, DS // CHUNK)) * 0.02 + 0.001).astype(
        np.float32)
    return codes, scales


@pytest.fixture(scope="module")
def jax_oracles():
    """The JAX outputs of the file: references, the decode layer under
    portable_export(), and the interpret-mode SP kernel once."""
    out = {}
    ctx = mesh_mod.initialize_distributed(tp=N, devices=jax.devices()[:N])
    try:
        for hq, hkv in HEADS:
            q, k, v = _qkv(hq, hkv)
            for causal in (True, False):
                o, lse = j_mha(q[None], k[None], v[None], causal=causal,
                               return_lse=True)
                out[("mha", hq, hkv, causal)] = (np.asarray(o[0]),
                                                 np.asarray(lse[0]))
        q, k, v = _qkv(4, 2)
        f = ctx.shard_map(
            functools.partial(jsa.sp_ag_attention, axis="tp", block_q=32,
                              return_lse=True, ctx=ctx),
            in_specs=(P(None, "tp", None),) * 3,
            out_specs=(P(None, "tp", None), P(None, "tp")))
        out["sp_kernel"] = tuple(np.asarray(a) for a in f(q, k, v))

        d = _decode_inputs()
        cache = P(None, None, "tp", None)
        f = jax.jit(ctx.shard_map(
            functools.partial(jsp.sp_append_kv, axis="tp"),
            in_specs=(cache, P(), P()), out_specs=cache))
        out["append"] = np.asarray(f(d["kc"], d["kn"], LENS))
        gold_k, gold_v = d["kc"].copy(), d["vc"].copy()
        for b in range(B):
            gold_k[b, :, LENS[b]] = d["kn"][b]
            gold_v[b, :, LENS[b]] = d["vn"][b]
        out["decode"] = np.asarray(jfd.gqa_decode_reference(
            jnp.asarray(d["q"]), gold_k, gold_v, LENS + 1))
        codes, scales = _int8_cache(d["kc"])
        deq = codes.astype(np.float32) * np.repeat(scales, CHUNK, -1)[..., None]
        out["decode_int8"] = np.asarray(jfd.gqa_decode_reference(
            jnp.asarray(d["q"]), deq, deq, LENS))
        with portable_export():
            dq = functools.partial(jfd.distributed_flash_decode, axis="tp",
                                   chunk_k=CHUNK, method="xla", ctx=ctx)
            f = jax.jit(ctx.shard_map(
                dq, in_specs=(P(), cache, cache, P()), out_specs=P()))
            out["decode_bf16"] = np.asarray(f(
                jnp.asarray(d["q"], jnp.bfloat16),
                jnp.asarray(gold_k, jnp.bfloat16),
                jnp.asarray(gold_v, jnp.bfloat16), LENS + 1).astype(
                    jnp.float32))
            f = jax.jit(ctx.shard_map(
                lambda q_, k_, v_, n_, ks, vs: dq(q_, k_, v_, n_, k_scale=ks,
                                                  v_scale=vs),
                in_specs=(P(), cache, cache, P(), P(None, None, "tp"),
                          P(None, None, "tp")),
                out_specs=P()))
            out["decode_int8_layer"] = np.asarray(f(
                jnp.asarray(d["q"]), codes, codes, LENS, scales, scales))
    finally:
        mesh_mod.finalize_distributed()
    # The two-level variants on a dp x tp = 2 x 2 mesh.
    ctx = mesh_mod.initialize_distributed(dp=2, tp=2,
                                          devices=jax.devices()[:4])
    try:
        d = _decode_inputs(seed=5)
        cache = P(None, None, ("dp", "tp"), None)
        with portable_export():
            f = jax.jit(ctx.shard_map(
                functools.partial(jfd.distributed_flash_decode_2level,
                                  inner_axis="tp", outer_axis="dp",
                                  chunk_k=CHUNK, method="xla", ctx=ctx),
                in_specs=(P(), cache, cache, P()), out_specs=P()))
            out["decode_2level"] = np.asarray(f(d["q"], d["kc"], d["vc"],
                                                LENS))
    finally:
        mesh_mod.finalize_distributed()
    return out


# -- SP prefill attention --------------------------------------------------------


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_sp_ag_attention_equals_jax(jax_oracles, hq, hkv):
    """O and LSE of every rank's rows against JAX's causal attention over
    the whole sequence (and, at G = 2, against the JAX SP kernel)."""
    q, k, v = _qkv(hq, hkv)
    ctx = initialize_distributed(N, device="cpu", dtype=torch.float32)
    o, lse = sp_ag_attention(_shards(q, N), _shards(k, N), _shards(v, N),
                             ctx, return_lse=True)
    want_o, want_lse = jax_oracles[("mha", hq, hkv, True)]
    np.testing.assert_allclose(torch.cat(o, 1).numpy(), want_o, **TOL)
    np.testing.assert_allclose(torch.cat(lse, 1).numpy(), want_lse, **TOL)
    if (hq, hkv) == (4, 2):
        ko, klse = jax_oracles["sp_kernel"]
        np.testing.assert_allclose(torch.cat(o, 1).numpy(), ko, **TOL)
        np.testing.assert_allclose(torch.cat(lse, 1).numpy(), klse, **TOL)
    with pytest.raises(ValueError, match="do not match"):
        sp_ag_attention(_shards(q, N), _shards(k[:, :-N], N), _shards(v, N),
                        ctx)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_equals_jax(jax_oracles, causal):
    hq, hkv = 4, 2
    q, k, v = _qkv(hq, hkv)
    o = ring_attention(_shards(q, N), _shards(k, N), _shards(v, N),
                       causal=causal)
    np.testing.assert_allclose(torch.cat(o, 1).numpy(),
                               jax_oracles[("mha", hq, hkv, causal)][0],
                               **TOL)


# -- SP decode -----------------------------------------------------------------------


def test_sp_append_kv_equals_jax(jax_oracles):
    d = _decode_inputs()
    caches = _shards(d["kc"], N, axis=2)
    sp_append_kv(caches, _t(d["kn"]), torch.from_numpy(LENS))
    np.testing.assert_array_equal(torch.cat(caches, 2).numpy(),
                                  jax_oracles["append"])


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_sp_decode_attention_equals_jax(jax_oracles, method):
    """The layer: append at the owner, then the distributed decode; O
    replicated on every rank, against the golden cache's reference."""
    d = _decode_inputs()
    ctx = initialize_distributed(N, device="cpu", dtype=torch.float32)
    kc, vc = _shards(d["kc"], N, 2), _shards(d["vc"], N, 2)
    o, kc2, _ = sp_decode_attention(
        [_t(d["q"])] * N, _t(d["kn"]), _t(d["vn"]), kc, vc,
        torch.from_numpy(LENS), ctx, chunk_k=CHUNK, method=method)
    for r in range(N):
        np.testing.assert_allclose(o[r].numpy(), jax_oracles["decode"],
                                   **TOL)
    np.testing.assert_array_equal(torch.cat(kc2, 2).numpy(),
                                  jax_oracles["append"])


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_distributed_flash_decode_bf16_and_int8(jax_oracles, method):
    """bf16: the JAX layer (portable path) rounds each rank's partial
    where the port does; int8 codes with per-chunk scales: against the
    dequantized reference and the JAX layer."""
    d = _decode_inputs()
    ctx = initialize_distributed(N, device="cpu", dtype=torch.bfloat16)
    gold_k, gold_v = d["kc"].copy(), d["vc"].copy()
    for b in range(B):
        gold_k[b, :, LENS[b]] = d["kn"][b]
        gold_v[b, :, LENS[b]] = d["vn"][b]
    bf = torch.bfloat16
    o = distributed_flash_decode(
        [_t(d["q"], bf)] * N, [s.to(bf) for s in _shards(gold_k, N, 2)],
        [s.to(bf) for s in _shards(gold_v, N, 2)],
        torch.from_numpy(LENS + 1), ctx, chunk_k=CHUNK, method=method)
    for r in range(N):
        assert o[r].dtype == bf
        np.testing.assert_allclose(o[r].float().numpy(),
                                   jax_oracles["decode_bf16"], **BF16_TOL)
    codes, scales = _int8_cache(d["kc"])
    ctx32 = initialize_distributed(N, device="cpu", dtype=torch.float32)
    cs = [torch.from_numpy(c.copy()) for c in np.split(codes, N, axis=2)]
    ss = [torch.from_numpy(c.copy()) for c in np.split(scales, N, axis=2)]
    o = distributed_flash_decode([_t(d["q"])] * N, cs, cs,
                                 torch.from_numpy(LENS), ctx32,
                                 chunk_k=CHUNK, method=method, k_scale=ss,
                                 v_scale=ss)
    for r in range(N):
        np.testing.assert_allclose(o[r].numpy(), jax_oracles["decode_int8"],
                                   **TOL)
        np.testing.assert_allclose(o[r].numpy(),
                                   jax_oracles["decode_int8_layer"], **TOL)


# -- the two-level variants over dp x tp = 2 x 2 ---------------------------------------


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2)])
def test_sp_ag_attention_2level_equals_jax(jax_oracles, hq, hkv):
    q, k, v = _qkv(hq, hkv)
    ctx = initialize_distributed(2, dp=2, device="cpu", dtype=torch.float32)
    assert ctx.world == 4 and ctx.group(1) is ctx.group(1)
    o = sp_ag_attention_2level(_shards(q, 4), _shards(k, 4), _shards(v, 4),
                               ctx)
    np.testing.assert_allclose(torch.cat(o, 1).numpy(),
                               jax_oracles[("mha", hq, hkv, True)][0], **TOL)


@pytest.mark.parametrize("method", ["xla", "pallas"])
def test_distributed_flash_decode_2level_equals_jax(jax_oracles, method):
    d = _decode_inputs(seed=5)
    ctx = initialize_distributed(2, dp=2, device="cpu", dtype=torch.float32)
    o = distributed_flash_decode_2level(
        [_t(d["q"])] * 4, _shards(d["kc"], 4, 2), _shards(d["vc"], 4, 2),
        torch.from_numpy(LENS), ctx, chunk_k=CHUNK, method=method)
    want = np.asarray(jfd.gqa_decode_reference(
        jnp.asarray(d["q"]), d["kc"], d["vc"], LENS))
    for r in range(4):
        np.testing.assert_allclose(o[r].numpy(), want, **TOL)
        np.testing.assert_allclose(o[r].numpy(), jax_oracles["decode_2level"],
                                   **TOL)


# -- the kernel launch's host-side planning (no card needed) --------------

tsp = importlib.import_module(
    "triton_distributed_tpu_torch.ops.attention.sp_ag_attention")


def _kernel_block_rank(counts, b):
    """``csrc/sp_attention.cu`` ``block_rank``, transcribed."""
    r = 0
    while b >= counts[r]:
        b -= counts[r]
        r += 1
    return r, b


@pytest.mark.parametrize("n,cap", [(1, 132), (2, 132), (3, 132), (4, 132),
                                   (8, 132), (3, 264), (4, 4), (4, 5),
                                   (8, 8), (8, 9), (8, 10), (2, 3)])
def test_sp_split_by_work_shares_the_grid(n, cap):
    """Each rank's blocks: at least one (a push piece), about its causal
    share (2r + 1) / n^2 of the grid, non-decreasing in r, summing to at
    most the co-resident capacity (to all of it when every share is a
    block or more)."""
    counts = tsp.split_by_work(n, cap, items=10**6)
    shares = [cap * (2 * r + 1) / n**2 for r in range(n)]
    assert len(counts) == n and min(counts) >= 1
    assert sum(counts) <= cap
    assert counts == sorted(counts)
    for c, w in zip(counts, shares):
        assert c == 1 if w < 1 else abs(c - w) < 1
    if min(shares) >= 1:
        assert sum(counts) == cap


def test_sp_split_by_work_at_the_measured_grids():
    """One H100 block an SM (132): n = 2 gives rank 1 three times rank
    0's blocks, n = 4 the largest remainders to ranks 3 and 1; no rank
    takes more blocks than it has items; a capacity under n raises."""
    assert tsp.split_by_work(2, 132, 4096) == [33, 99]
    assert tsp.split_by_work(4, 132, 2048) == [8, 25, 41, 58]
    assert tsp.split_by_work(4, 132, 10) == [8, 10, 10, 10]
    with pytest.raises(ValueError):
        tsp.split_by_work(4, 3, 100)


@pytest.mark.parametrize("counts", [[33, 99], [8, 25, 41, 58], [1, 1, 1],
                                    [3, 3, 3, 3], [1, 2, 3, 4, 5, 6, 7, 8]])
def test_sp_block_map_and_flags_follow_the_counts(counts):
    """Block b is (rank, index) through the prefix of the counts, as the
    kernel maps it; the flags a rank hold the entry barrier's n and one a
    push piece of every source (``n + prefix(src) + g``), each distinct
    and inside the count."""
    ranks = [r for r, c in enumerate(counts) for _ in range(c)]
    for b, r in enumerate(ranks):
        assert _kernel_block_rank(counts, b) == (r, b - sum(counts[:r]))
    n = len(counts)
    flags = [n + sum(counts[:src]) + g for src in range(n)
             for g in range(counts[src])]
    assert sorted(flags) == list(range(n, tsp.flag_count(counts)))


@pytest.mark.parametrize("n,cap,items,bpr,want", [
    (2, 132, 4096, None, [33, 99]),
    (4, 132, 2048, 33, [33, 33, 33, 33]),
    (3, 20, 5, None, [2, 5, 5]),
    (4, 132, 100, 1, [1, 1, 1, 1]),
])
def test_sp_plan_even_and_split_grids(n, cap, items, bpr, want):
    """``blocks_per_rank`` keeps the even grid; the default is the split
    by work; the flag count covers either."""
    counts, n_flags = tsp.plan(n, cap, items, bpr)
    assert counts == want
    assert n_flags == n + sum(want)


@pytest.mark.parametrize("dtype,tiles", [
    (torch.bfloat16, {1: 128, 2: 64, 4: 32, 8: 16}),
    (torch.float32, {1: 16, 2: 8, 4: 4, 8: 2}),
])
def test_sp_q_tile_per_group(dtype, tiles):
    """The items' q rows a head: 128 (head, row) rows over the G heads of
    a kv head on the tensor cores, 16 on the FMA pipes."""
    assert {g: tsp.q_tile(dtype, g) for g in tsp.GROUPS} == tiles
