"""The options of the overlap kernels, port against the JAX package on the
CPU: gemm_rs's wire dtype and one-rank ring, gemm_ar's device trace ring,
ag_gemm's arrival-adaptive pick.

On the CPU the port's ops take their plain versions; the JAX oracles run
as the JAX package's own tests run them (``tests/test_overlap.py``,
``tests/test_kernel_trace.py``): interpret-mode kernels on the conftest's
CPU mesh. Tolerances:

- the e4m3 wire: integer-valued inputs (every partial exact in f32, so
  both sides round the same hop sums) bitwise; random inputs within one
  e4m3 ulp of the row's largest |partial| sum per hop (an f32 partial
  summed in another order may flip a rounding); against the f64 golden
  JAX's own error model (``test_gemm_rs_fp8_wire``: median relative
  error < 0.08, worst absolute < 0.06); the overflow planted at 448, 460,
  464, 465 and -1000 gives 448, 448, 448, NaN, NaN on both sides;
- the one-rank ring: 1e-4 against ``a @ b`` (JAX's
  ``test_gemm_rs_force_kernel_n1``);
- the trace ring: exact (logical ticks);
- ag_gemm: 1e-4, as ``tests/test_torch_tp.py`` holds the collectives.

JAX's ``adaptive_pick`` reads DMA semaphores, which have no interpret
lowering here (``semaphore_read``), and JAX resolves ``adaptive=None``
to ring order off the TPU: the pick rule is held against an independent
transcription of its docstring, and the outputs against JAX's default.
"""

import contextlib
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_distributed_tpu.obs import kernel_trace as jkt
from triton_distributed_tpu.ops import overlap as jov
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.obs import kernel_trace as kt
from triton_distributed_tpu_torch.ops import overlap as tov
from triton_distributed_tpu_torch.ops.overlap.ag_gemm import resolve_adaptive
from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (
    gemm_rs_plain,
    ring_split,
    round_to_wire,
)
from triton_distributed_tpu_torch.runtime import initialize_distributed

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

E4M3 = torch.float8_e4m3fn
RS_M, RS_K, RS_N, RS_N_RANKS = 4 * 32, 256, 256, 4
PLANTED = (448.0, 460.0, 464.0, 465.0, -1000.0)


@contextlib.contextmanager
def jax_tp(n: int):
    ctx = mesh_mod.initialize_distributed(tp=n, devices=jax.devices()[:n])
    try:
        yield ctx
    finally:
        mesh_mod.finalize_distributed()


def port_tp(n: int, dtype=torch.float32):
    return initialize_distributed(n, device="cpu", dtype=dtype)


def _jax_rs(a, b, n=RS_N_RANKS, wire=jnp.float8_e4m3fn):
    cfg = jov.GemmRSConfig(tile_n=128, tile_m=8, wire_dtype=wire)
    with jax_tp(n) as jctx:
        return np.asarray(jov.gemm_rs_op(jnp.asarray(a), jnp.asarray(b),
                                         "tp", cfg, jctx))


def _port_rs(a, b, n=RS_N_RANKS, wire=E4M3):
    ctx = port_tp(n)
    return tov.gemm_rs_op(torch.from_numpy(a), torch.from_numpy(b), ctx,
                          tov.GemmRSConfig(tile_m=8, wire_dtype=wire)
                          ).numpy()


def _planted_inputs(n=RS_N_RANKS):
    """a [M, n*N] with B_r = I: rank r's partial is its column shard. Each
    chunk's rows carry PLANTED values (cycled) in the partial of the rank
    that opens their ring (clockwise rows: c+1; counter-clockwise: c-1)
    and 0 in every other rank's, so the first hop sum is the planted
    value and the later hops add 0."""
    m_per, w = RS_M // n, 128
    half = ring_split(m_per, tov.GemmRSConfig(tile_m=8))
    a = np.zeros((RS_M, n * w), np.float32)
    for c in range(n):
        for i in range(m_per):
            r = (c + 1) % n if i < half else (c - 1) % n
            a[c * m_per + i, r * w:(r + 1) * w] = PLANTED[i % len(PLANTED)]
    b = np.tile(np.eye(w, dtype=np.float32), (n, 1))
    return a, b


@pytest.fixture(scope="module")
def rs_cases():
    """(port, JAX) e4m3-wire results of the integer, random and planted
    inputs, computed once."""
    rng = np.random.default_rng(11)
    out = {}
    a = rng.integers(-2, 3, (RS_M, RS_K)).astype(np.float32)
    b = rng.integers(-1, 2, (RS_K, RS_N)).astype(np.float32)
    out["integer"] = (a, b, _port_rs(a, b), _jax_rs(a, b))
    a = (rng.standard_normal((RS_M, RS_K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((RS_K, RS_N)) * 0.1).astype(np.float32)
    out["random"] = (a, b, _port_rs(a, b), _jax_rs(a, b))
    a, b = _planted_inputs()
    out["planted"] = (a, b, _port_rs(a, b), _jax_rs(a, b))
    return out


def test_round_to_wire_matches_the_jax_cast():
    """The plain e4m3 rounding equals ml_dtypes' cast (the JAX oracle's)
    bit for bit: every e4m3 value, the midpoints between neighbours (ties
    to even), a dense sweep across the range and past the overflow, NaN;
    bf16 equals torch's own cast."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.sort(codes.astype(np.float32)[~np.isnan(
        codes.astype(np.float32))])
    mids = (vals[:-1] + vals[1:]) / 2
    sweep = np.linspace(-600, 600, 48001, dtype=np.float32)
    x = np.concatenate([vals, mids, sweep, np.float32(
        [463.99, 464.0, 464.01, -464.0, -464.5, 1e6, np.inf, -np.inf,
         np.nan])]).astype(np.float32)
    want = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = round_to_wire(torch.from_numpy(x), E4M3).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[x == 464.01]).all() and (got[x == 464.0] == 448).all()
    xb = torch.from_numpy(sweep)
    assert torch.equal(round_to_wire(xb, torch.bfloat16),
                       xb.to(torch.bfloat16).float())


def test_e4m3_wire_integer_inputs_bitwise(rs_cases):
    _, _, got, want = rs_cases["integer"]
    assert not np.isnan(want).any()
    np.testing.assert_array_equal(got, want)


def test_e4m3_wire_random_inputs_within_an_ulp_a_hop(rs_cases):
    a, b, got, want = rs_cases["random"]
    n = RS_N_RANKS
    k_loc = RS_K // n
    parts = np.stack([a[:, r * k_loc:(r + 1) * k_loc]
                      @ b[r * k_loc:(r + 1) * k_loc] for r in range(n)])
    row_max = np.abs(parts).sum(axis=0).max(axis=1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(row_max)) - 3)
    assert (np.abs(got - want) <= (n - 1) * ulp).all()
    # JAX's own error model against the f64 golden.
    gold = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(got.astype(np.float64) - gold)
    assert np.median(err / (np.abs(gold) + 1e-3)) < 0.08
    assert err.max() < 0.06
    # The wire really is narrower: an f32 wire gives another result.
    f32 = _port_rs(a, b, wire=None)
    assert np.abs(f32 - gold).max() < 1e-5 < np.abs(got - f32).max()


def test_e4m3_wire_overflow_gives_nan_where_jax_does(rs_cases):
    _, _, got, want = rs_cases["planted"]
    np.testing.assert_array_equal(got, want)   # NaN where JAX has NaN
    expect = {448.0: 448.0, 460.0: 448.0, 464.0: 448.0, 465.0: np.nan,
              -1000.0: np.nan}
    m_per = RS_M // RS_N_RANKS
    for c in range(RS_N_RANKS):
        for i in range(m_per):
            e = expect[PLANTED[i % len(PLANTED)]]
            row = got[c * m_per + i]
            assert (np.isnan(row).all() if np.isnan(e) else (row == e).all())


def test_wire_dtypes_and_refusals():
    """bf16 over f32 inputs is a narrow wire too (each hop rounded to
    bf16, the last to f32); a wire wider than the input, or one the ring
    has no build for, is refused naming the ROADMAP row."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 64)).astype(np.float32)
    ctx = port_tp(2)
    xs, ws = ctx.shard(torch.from_numpy(a), 1), ctx.shard(
        torch.from_numpy(b), 0)
    got = tov.gemm_rs(xs, ws, ctx, tov.GemmRSConfig(
        wire_dtype=torch.bfloat16))
    half = ring_split(32, tov.create_gemm_rs_context(64, 64, n_ranks=2))
    want = gemm_rs_plain(xs, ws, half, torch.bfloat16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # n = 2: one hop rounded to bf16, then the final f32 sum.
    p0 = torch.from_numpy(a[:32, :64] @ b[:64])
    p1 = torch.from_numpy(a[:32, 64:] @ b[64:])
    assert torch.allclose(got[0][:half], p0[:half] + p1[:half].to(
        torch.bfloat16).float(), atol=1e-5)
    bctx = port_tp(2, torch.bfloat16)
    for wire in (torch.float32, torch.float16, torch.float8_e5m2):
        with pytest.raises(NotImplementedError, match="queue 2 row 8"):
            tov.gemm_rs([x.bfloat16() for x in xs],
                        [w.bfloat16() for w in ws], bctx,
                        tov.GemmRSConfig(wire_dtype=wire))


def test_force_kernel_one_rank_ring():
    """force_kernel at tp=1 runs the ring's plain version (step 0 is the
    last step): a @ b within 1e-4, as JAX's test_gemm_rs_force_kernel_n1
    holds its kernel, and equal to JAX's kernel at tp=1; bf16 rounds the
    f32 product once."""
    rng = np.random.default_rng(42)
    a = rng.standard_normal((32, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    with jax_tp(1) as jctx:
        want = np.asarray(jov.gemm_rs_op(
            jnp.asarray(a), jnp.asarray(b), "tp",
            jov.GemmRSConfig(tile_n=128, tile_m=8, force_kernel=True), jctx))
    ctx = port_tp(1)
    got = tov.gemm_rs_op(torch.from_numpy(a), torch.from_numpy(b), ctx,
                         tov.GemmRSConfig(tile_m=8, force_kernel=True))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    bctx = port_tp(1, torch.bfloat16)
    ab, bb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = tov.gemm_rs([ab], [bb], bctx, tov.GemmRSConfig(
        force_kernel=True, wire_dtype=E4M3))
    assert torch.equal(got[0], (ab.float() @ bb.float()).bfloat16())


# -- gemm_ar's trace ring ----------------------------------------------------

def _trace_case(n, tile_n=128):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    out, ring = tov.gemm_ar_op(
        torch.from_numpy(a), torch.from_numpy(b), port_tp(n),
        tov.GemmARMethod.ONE_SHOT, tov.GemmARConfig(tile_n=tile_n),
        trace=True)
    return a, b, out, ring


def _fields(records):
    return [(r.rank, r.step, r.index, r.task_id, r.opcode, r.layer, r.slot,
             r.begin, r.end, r.mid) for r in records]


def test_trace_ring_shape_and_outputs_match_jax(ctx4):
    a, b, out, ring = _trace_case(4)
    sh = jax.eval_shape(
        lambda a_, b_: jov.gemm_ar_op(
            a_, b_, "tp", jov.GemmARMethod.ONE_SHOT,
            jov.GemmARConfig(tile_n=128), ctx4, trace=True),
        jnp.zeros(a.shape, jnp.float32), jnp.zeros(b.shape, jnp.float32))
    assert tuple(ring.shape) == sh[1].shape == (4, 3, 3, 8)
    assert ring.dtype == torch.int32 and sh[1].dtype == jnp.int32
    assert tuple(out.shape) == sh[0].shape
    want = jov.gemm_ar_op(jnp.asarray(a), jnp.asarray(b), "tp",
                          jov.GemmARMethod.ONE_SHOT,
                          jov.GemmARConfig(tile_n=128), ctx4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    untraced = tov.gemm_ar_op(torch.from_numpy(a), torch.from_numpy(b),
                              port_tp(4), tov.GemmARMethod.ONE_SHOT)
    assert torch.equal(out, untraced)


@pytest.mark.parametrize("tile_n", [64, 128, 256])
def test_trace_ring_decodes_and_validates_in_both_packages(tile_n):
    """The plain ring decodes (strict=False) to the same records under the
    JAX decoder and the port's, validates in both, and reshaped to one
    step gives one AR_SEND..AR_WAIT window a column group a rank, equal
    reports in both packages."""
    n = 4
    _, _, _, ring = _trace_case(n, tile_n)
    num_j = 256 // tile_n
    arr = ring.numpy()
    recs, jrecs = kt.decode_trace(arr, strict=False), jkt.decode_trace(
        arr, strict=False)
    assert _fields(recs) == _fields(jrecs)
    assert len(recs) == n * (2 * num_j + 1)
    assert kt.validate_ring(recs) == [] and jkt.validate_ring(jrecs) == []
    one = arr.reshape(n, 1, -1, 8)
    rep = kt.overlap_report(kt.decode_trace(one, strict=False))
    jrep = jkt.overlap_report(jkt.decode_trace(one, strict=False))
    assert rep["windows"] == n * num_j == jrep["windows"]
    assert rep == jrep
    # Unreshaped, a send and its wait sit in different steps: no window.
    assert kt.overlap_report(recs)["windows"] == 0


def test_trace_ring_breaks_validation_when_disordered():
    """Control: swapping an iteration's produce and reduce rows breaks
    the ring's clock order, and validate_ring says so."""
    _, _, _, ring = _trace_case(2)
    bad = ring.clone()
    bad[0, 1, [0, 1]] = ring[0, 1, [1, 0]]
    assert kt.validate_ring(kt.decode_trace(bad.numpy(), strict=False))


def test_trace_one_rank_arity_and_refusal():
    """tp=1: (out, an all-zero ring that decodes to []), as JAX; any method
    but ONE_SHOT raises, naming it."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    with jax_tp(1) as jctx:
        jout, jring = jov.gemm_ar_op(
            jnp.asarray(a), jnp.asarray(b), "tp", jov.GemmARMethod.ONE_SHOT,
            jov.GemmARConfig(tile_n=128), jctx, trace=True)
    out, ring = tov.gemm_ar_op(torch.from_numpy(a), torch.from_numpy(b),
                               port_tp(1), tov.GemmARMethod.ONE_SHOT,
                               tov.GemmARConfig(tile_n=128), trace=True)
    assert tuple(ring.shape) == np.asarray(jring).shape == (1, 3, 3, 8)
    assert not ring.any() and kt.decode_trace(ring.numpy(),
                                              strict=False) == []
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    ctx = port_tp(2)
    for method in (tov.GemmARMethod.AUTO, tov.GemmARMethod.XLA,
                   tov.GemmARMethod.TWO_SHOT):
        with pytest.raises(ValueError, match="ONE_SHOT"):
            tov.gemm_ar_op(torch.from_numpy(a), torch.from_numpy(b), ctx,
                           method, trace=True)
    assert tov.create_gemm_ar_context(4, 4096, 2048).tile_n == \
        jov.create_gemm_ar_context(4, 4096, 2048).tile_n == 512


# -- ag_gemm's arrival-adaptive pick -----------------------------------------

def _pick_by_the_docstring(done, landed, me, n):
    """JAX ``adaptive_pick``'s docstring (:128-139), transcribed: the
    first unprocessed chunk (scanning me+1, me+2, ...) whose arrival has
    landed; ring order, i.e. the first unprocessed chunk, when none
    has."""
    unprocessed = [(me + off) % n for off in range(1, n)
                   if not done[(me + off) % n]]
    arrived = [c for c in unprocessed if landed[c]]
    return arrived[0] if arrived else unprocessed[0]


def test_adaptive_pick_every_case_up_to_five_ranks():
    cases = 0
    for n in range(2, 6):
        for me in range(n):
            for dmask in range(1 << n):
                done = [bool(dmask >> c & 1) for c in range(n)]
                if not done[me] or all(done):
                    continue   # own chunk first; a pick needs a chunk left
                for lmask in range(1 << n):
                    landed = [bool(lmask >> c & 1) for c in range(n)]
                    assert tov.adaptive_pick_plain(done, landed, me, n) == \
                        _pick_by_the_docstring(done, landed, me, n)
                    cases += 1
    assert cases == sum(n * (2 ** (n - 1) - 1) * 2 ** n for n in range(2, 6))


def test_adaptive_pick_defers_a_straggler_to_the_end():
    """The order the pick makes with rank 2's chunk late at n = 4: every
    other rank computes it last; ring order would not."""
    n, late = 4, 2
    for me in range(n):
        if me == late:
            continue
        done, order = [c == me for c in range(n)], [me]
        for _ in range(n - 1):
            landed = [c != late or len(order) == n - 1 for c in range(n)]
            nxt = tov.adaptive_pick_plain(done, landed, me, n)
            done[nxt] = True
            order.append(nxt)
        assert order[-1] == late
    assert [(1 + s) % n for s in range(n)].index(late) == 1


@pytest.mark.parametrize("adaptive", [None, True, False])
def test_ag_gemm_every_pick_matches_jax(ctx4, adaptive):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 512)).astype(np.float32)
    want = np.asarray(jov.ag_gemm_op(jnp.asarray(a), jnp.asarray(b), "tp",
                                     jov.AGGemmConfig(tile_n=128), ctx4))
    ctx = port_tp(4)
    got = tov.ag_gemm(ctx.shard(torch.from_numpy(a), 0),
                      ctx.shard(torch.from_numpy(b), 1), ctx,
                      tov.AGGemmConfig(adaptive=adaptive, straggler_rank=2))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_adaptive_resolves_on_where_the_kernels_run():
    cfg = tov.AGGemmConfig()
    assert cfg.adaptive is None and jov.AGGemmConfig().adaptive is None
    assert resolve_adaptive(cfg, port_tp(2)) is False
    cuda_ctx = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert resolve_adaptive(cfg, cuda_ctx) is True
    assert resolve_adaptive(tov.AGGemmConfig(adaptive=False),
                            cuda_ctx) is False
    # JAX's fields and defaults.
    jf = {name: f.default for name, f in
          jov.AGGemmConfig.__dataclass_fields__.items()}
    for name in ("adaptive", "for_correctness", "straggler_rank",
                 "straggler_nanos"):
        assert getattr(cfg, name) == jf[name]


# -- the launchers' tile arithmetic ------------------------------------------
#
# ag_gemm's and gemm_rs's launchers size the grid and the flag site from
# the kernel's tile (csrc/overlap.cu). Held here against a plain
# enumeration of the kernel's work items, with the tiles read from the
# source: every output element in exactly one tile, every flag a kernel
# item touches inside the site, the grid within the tiles and the
# co-resident blocks.

def _kernel_tiles():
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "triton_distributed_tpu_torch/csrc/overlap.cu").read_text()
    fma_bn = int(re.search(r"constexpr int kBN = (\d+);", src).group(1))
    wg = re.search(r"struct WgTile \{\s*static constexpr int kRows = (\d+), "
                   r"kCols = (\d+),", src)
    put = int(re.search(r"constexpr int kPutRows = (\d+);", src).group(1))
    return fma_bn, (int(wg.group(1)), int(wg.group(2))), put


def _tile_of(dtype, m):
    """The kernel's (rows, cols) tile for a GEMM of m rows (pick_kernel)."""
    fma_bn, wg, _ = _kernel_tiles()
    if m <= 16:
        return 16, fma_bn
    return wg if dtype == torch.bfloat16 else (64, fma_bn)


def _covers_once(tiles, tiles_m, bm, bn, m, n_out):
    """Tile t at rows (t % tiles_m) * bm, columns (t // tiles_m) * bn: a
    column strip's row tiles are neighbours, so blocks that run together
    share its B."""
    seen = np.zeros((m, n_out), np.int32)
    for t in range(tiles):
        m0, n0 = (t % tiles_m) * bm, (t // tiles_m) * bn
        seen[m0:m0 + bm, n0:n0 + bn] += 1
    return bool((seen == 1).all())


# (n, dtype, m_per, n_out): the card tests', chip_smoke.py's and the main
# path's shapes (Qwen3-8B tp=2 QKV/FC1/o-proj/FC2, the one-rank ring).
BF, F32 = torch.bfloat16, torch.float32
RS_SHAPES = [(2, BF, 192, 392), (2, BF, 192, 4096), (2, BF, 150, 520),
             (2, BF, 150, 4096), (4, BF, 32, 264), (4, BF, 32, 520),
             (2, BF, 2, 4096), (1, BF, 384, 4096), (1, BF, 150, 520),
             (2, F32, 16, 64), (4, F32, 16, 64), (2, BF, 64, 4096),
             (4, BF, 96, 512), (2, BF, 320, 4096), (4, BF, 16, 128)]
AG_SHAPES = [(2, BF, 150, 200), (2, BF, 150, 1000), (2, BF, 192, 392),
             (4, BF, 32, 72), (4, BF, 32, 136), (2, BF, 192, 3072),
             (2, BF, 192, 12288), (4, BF, 96, 1536), (4, BF, 64, 1536),
             (4, BF, 256, 1536), (2, F32, 16, 128), (4, F32, 16, 128),
             (4, BF, 10, 32)]


@pytest.mark.parametrize("n,dtype,m_per,n_out", RS_SHAPES)
def test_gemm_rs_launch_arithmetic_matches_the_kernel_items(n, dtype, m_per,
                                                           n_out):
    from triton_distributed_tpu_torch.ops.overlap import _launch
    from triton_distributed_tpu_torch.ops.overlap.gemm_rs import plan

    bm, bn = _tile_of(dtype, m_per)
    assert _launch.tile("gemm_rs", dtype, m_per) == (bm, bn)
    tiles, flags = plan(n, m_per, n_out, dtype)
    tiles_m = -(-m_per // bm)
    assert tiles == tiles_m * -(-n_out // bn)
    assert _covers_once(tiles, tiles_m, bm, bn, m_per, n_out)
    # The kernel's flags: the barrier [0, n), then the tile t of direction
    # d's forwarding step s at n + (d * (n-1) + s) * tiles + t.
    used = set(range(n))
    for d in (0, 1):
        for s in range(n - 1):
            for t in range(tiles):
                used.add(n + (d * (n - 1) + s) * tiles + t)
    assert used == set(range(flags))
    for cap in (1, n, 3 * n - 1, 132, 264, 396):
        g = _launch.grid(tiles, cap, n)
        assert 1 <= g <= tiles and (n * g <= cap or g == 1)
        assert g == min(tiles, max(1, cap // n))


@pytest.mark.parametrize("n,dtype,m_per,n_loc", AG_SHAPES)
def test_ag_gemm_launch_arithmetic_matches_the_kernel_items(n, dtype, m_per,
                                                           n_loc):
    from triton_distributed_tpu_torch.ops.overlap import _launch
    from triton_distributed_tpu_torch.ops.overlap.ag_gemm import plan

    bm, bn = _tile_of(dtype, m_per)
    _, _, put = _kernel_tiles()
    assert _launch.PUT_ROWS == put
    assert _launch.tile("ag_gemm", dtype, m_per) == (bm, bn)
    assert _launch.tile("ag_gemm_adaptive", dtype, m_per) == (bm, bn)
    puts, tiles, flags = plan(n, m_per, n_loc, dtype)
    tiles_m = -(-m_per // bm)
    assert tiles == tiles_m * -(-n_loc // bn)
    assert puts == -(-m_per // put)
    assert _covers_once(tiles, tiles_m, bm, bn, m_per, n_loc)
    # Puts: every row of a source's chunk in one put tile, flagged at
    # n + src * puts + p; a GEMM tile waits for the put tiles of its rows.
    rows = np.zeros(m_per, np.int32)
    for p in range(puts):
        rows[p * put:(p + 1) * put] += 1
    assert (rows == 1).all()
    used = set(range(n))
    for src in range(n):
        for p in range(puts):
            used.add(n + src * puts + p)
    for t in range(tiles):
        m0 = (t % tiles_m) * bm
        p0, p1 = m0 // put, min(puts, -(-(m0 + bm) // put))
        assert p1 - p0 <= 128   # one waiting thread a put tile
        waited = set(range(p0 * put, min(p1 * put, m_per)))
        assert set(range(m0, min(m0 + bm, m_per))) <= waited
    # The adaptive build's claim word and publish flag of each step.
    base = n + n * puts
    for s in range(n):
        used.update((base + s, base + n + s))
    assert used == set(range(flags))
    for cap in (1, n, 132, 264, 396):
        g = _launch.grid(tiles, cap, n)
        assert 1 <= g <= tiles and g == min(tiles, max(1, cap // n))


# gemm_ar's launcher: the items, blocks, flags and workspace of each
# build, held against a plain enumeration of the kernel's items (overlap.cu
# gemm_ar_mma_kernel in bf16, gemm_ar_kernel in f32): every (row tile,
# column tile, K slice) of a column group in exactly one item, every atom
# non-empty, the kernel's one atom length for both builds (the untraced
# build's item a whole tile, the traced build's one atom), each atom's
# owner block the one the traced build's tile sum waits for, the flag site
# holding every word the kernel touches, each in one role (each an epoch:
# the barrier, the traced build's rank-local count and a flag a block and
# iteration, the put flags), the traced build's f32 atom partials after
# the slots; without the caller's blocks, the grid of the build launched.
AR_SHAPES = [  # (n, dtype, m, k_loc, n_out, tile_n, blocks a rank)
    (2, BF, 4, 2048, 4096, None, 198), (2, BF, 4, 6144, 4096, None, 198),
    (2, BF, 4, 2048, 4096, 512, 198), (2, BF, 4, 6144, 4096, 512, 198),
    (2, BF, 48, 6144, 4096, None, 132), (2, BF, 48, 2048, 4096, 512, 132),
    (4, BF, 1, 1000, 1000, None, 99), (4, BF, 5, 1000, 4096, 512, 99),
    (2, BF, 17, 2048, 1000, None, 132), (4, BF, 64, 6144, 4096, 512, 66),
    (2, BF, 301, 6144, 4096, None, 132), (4, BF, 301, 1000, 1000, None, 66),
    (4, BF, 16, 64, 256, 64, 99), (2, BF, 40, 256, 384, 128, 132),
    (2, BF, 4, 4096, 4096, None, 1), (2, BF, 4, 256, 128, None, 198),
    (2, F32, 4, 2048, 4096, None, 100),
    (4, F32, 48, 1000, 4096, 512, 50), (2, F32, 301, 2048, 1000, None, 66),
]


@pytest.mark.parametrize("n,dtype,m,k,n_out,tile_n,blocks", AR_SHAPES)
def test_gemm_ar_launch_arithmetic_matches_the_kernel_items(
        n, dtype, m, k, n_out, tile_n, blocks, monkeypatch):
    from triton_distributed_tpu_torch.ops.overlap import _launch
    from triton_distributed_tpu_torch.ops.overlap.gemm_ar import plan

    src = (pathlib.Path(__file__).resolve().parents[1]
           / "triton_distributed_tpu_torch/csrc/overlap.cu").read_text()
    depth = int(re.search(r"constexpr int kArDepth = (\d+);", src).group(1))
    atom = int(re.search(r"constexpr int kArAtom = (\d+);", src).group(1))
    fma_bn, _, _ = _kernel_tiles()
    assert _launch.AR_ATOM == atom and atom % depth == 0
    assert _launch.BN == fma_bn
    items, g, flags, ws = plan(n, m, n_out, k, dtype, tile_n, blocks)
    assert g == blocks  # the caller's grid, which the flags are laid for
    bm = 16 if m <= 16 else 64
    tiles_m, tiles_n = -(-m // bm), -(-n_out // fma_bn)
    tiles = tiles_m * tiles_n
    head = n + (2 if tile_n else 0)
    per = tile_n // fma_bn if tile_n else tiles_n
    groups = [(j * per, per) for j in range(tiles_n // per)]
    assert per * len(groups) == tiles_n
    # Without the caller's blocks: one an item, at most what the launched
    # build keeps co-resident (the two builds' capacities told apart).
    small = m <= _launch.SMALL_M
    for kind, cap in (("gemm_ar", 7 * n), ("gemm_ar_traced", 11 * n)):
        monkeypatch.setitem(_launch._capacity, (kind, dtype, small, None),
                            cap)
    cap = 11 * n if tile_n else 7 * n
    assert plan.__wrapped__(n, m, n_out, k, dtype, tile_n)[:2] == (
        items, min(items, cap // n))
    if dtype != BF:  # the FMA tile: an item is a tile; no atoms
        assert items == tiles_m * per
        assert flags == head + n * tiles and ws == n * m * n_out
        return
    atoms = -(-k // atom)
    span = 1 if tile_n else atoms
    seen, owners = {}, {}
    for ct0, nct in groups:
        assert items == nct * -(-atoms // span) * tiles_m
        for i in range(items):
            rt, ct = i % tiles_m, ct0 + (i // tiles_m) % nct
            k0 = (i // (tiles_m * nct)) * span * atom
            assert k0 < k  # no empty item
            owners[rt, ct, k0 // atom] = i % g
            for kk in range(k0, min(k, k0 + span * atom), depth):
                key = (rt, ct, kk)
                seen[key] = seen.get(key, 0) + 1
        if tile_n:  # the traced build's tile sums wait for these blocks
            for q in range(nct * tiles_m):
                rt, ct = q % tiles_m, ct0 + q // tiles_m
                for a in range(atoms):
                    assert owners[rt, ct, a] == (a * nct * tiles_m + q) % g
    assert set(seen.values()) == {1}
    assert len(seen) == tiles * -(-k // depth)
    words = list(range(head))
    if tile_n:
        words += [head + j * g + b for j in range(len(groups))
                  for b in range(g)]
    fput = len(words) if not tile_n else head + len(groups) * g
    words += [fput + src * tiles + t for src in range(n)
              for t in range(tiles)]
    assert len(set(words)) == len(words) and max(words) < flags
    if tile_n:
        assert flags == head + len(groups) * g + n * tiles
        # n bf16 slots, then the f32 atom partials [atoms, tiles, bm x 64]
        # on a 16-byte boundary.
        assert ws == n * m * n_out + 2 * atoms * tiles * bm * fma_bn
        assert (n * m * n_out * 2) % 16 == 0
    else:
        assert flags == n + n * tiles and ws == n * m * n_out
