"""The port's megakernel at tp > 1 against the JAX package, on the CPU.

On the CPU the megakernel over n co-located ranks runs its plain version
(``kernels.mega_decode_plain_tp``: the n rank states walked in lockstep,
every exchange a plain sum over the ranks' partials in rank order), the
function the CUDA kernel is held against on the card
(``tests/test_torch_cuda.py``). Here it is held against the JAX package
on the f32 ``tiny`` preset at tp=2 and tp=4 (a JAX mesh of as many CPU
devices, weights carried by ``params_from_jax(tree, tp=n)``):

- the packed task tables (entry BARRIER, ALLREDUCE or AR_SEND/AR_WAIT,
  fused norms or not, eos, ring, trace ids) equal the JAX
  ``ModelBuilder``'s, int for int;
- one decode step's logits within 1e-4 of the JAX ``xla`` decode step at
  the same tp, and an NS = 4 launch's tokens equal four JAX greedy
  steps' (f32 on both sides: only summation order differs, ~1e-6);
  every rank's tokens and final residual are bitwise equal; a rank's
  partial dropped at one layer's exchanges changes the logits;
- the plain trace ring at tp=2 equals the JAX interpret-mode ring (one
  short launch, all eight columns, rank by rank);
- ``ContinuousEngine(mode="mega")`` (prefix cache, ns 4, eos; resident
  and traced) and ``Engine(mode="mega")`` (dense and paged) emit the JAX
  ``xla`` engines' greedy tokens at tp=2 and 4.

The JAX oracles run under ``portable_export()`` (the JAX plain
references), except the ring, which only the interpret-mode megakernel
writes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import MegaConfig as JaxMegaConfig
from triton_distributed_tpu.megakernel import MegaQwen3 as JaxMegaQwen3
from triton_distributed_tpu.megakernel.code_generator import (
    MegaDims as JaxMegaDims,
)
from triton_distributed_tpu.megakernel.model_builder import (
    ModelBuilder as JaxModelBuilder,
)
from triton_distributed_tpu.megakernel.scheduler import schedule as jax_schedule
from triton_distributed_tpu.megakernel.task import pack_table as jax_pack
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import ContinuousEngine as JaxContinuous
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.obs import kernel_trace as jkt
from triton_distributed_tpu.ops.common import portable_export
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import (
    MegaConfig,
    MegaDims,
    MegaQwen3,
    ModelBuilder,
    TaskType,
    pack_table,
    schedule,
)
from triton_distributed_tpu_torch.megakernel.kernels import (
    mega_decode_plain_tp,
)
from triton_distributed_tpu_torch.megakernel.qwen3 import _weights
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    Engine,
    KVCache,
    PrefixCache,
    Qwen3,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.obs import kernel_trace as kt

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

ATOL = 1e-4
PAGE, MAXLEN, GEN, NS = 16, 64, 6, 4
SERVING = dict(fuse_norms=True, cross_prefetch=True, overlap_ar=True)

_rng = np.random.default_rng(31)
_PREFIX = _rng.integers(0, 256, 18)
PROMPTS = [np.concatenate([_PREFIX, _rng.integers(0, 256, k)]).astype(
    np.int32) for k in (6, 13, 2)]
IDS = np.stack([PROMPTS[0][:20], PROMPTS[1][:20]])


@pytest.fixture(autouse=True)
def _audit_port_engines():
    yield
    problems = [p for cls in (Engine, ContinuousEngine, PrefixCache)
                for obj in list(cls._live) for p in obj.audit()]
    assert not problems, problems


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def tp_models(request):
    """The JAX tiny model at tp=n (f32) and the port's from its weights,
    with the JAX ``xla`` engines' greedy tokens: ``ContinuousEngine``
    with the prefix cache and an eos id that fires inside request 0 (the
    port's own xla run picks it), and the dense ``Engine``."""
    n = request.param
    ctx = mesh_mod.initialize_distributed(tp=n, devices=jax.devices()[:n])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    tm = Qwen3(get_config("tiny"), device="cpu", tp=n)
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params),
                                  tp=n))
    plain = ContinuousEngine(tm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, device="cpu").run(
        [(p, GEN) for p in PROMPTS])
    eos = int(plain[0][2])
    with portable_export():
        cont = JaxContinuous(jm, max_batch=2, page_size=PAGE,
                             max_length=MAXLEN, mode="xla",
                             prefix_cache=True, eos_id=eos)
        gold_cont = [np.asarray(o).tolist()
                     for o in cont.run([(p, GEN) for p in PROMPTS])]
        gold_eng = np.asarray(JaxEngine(jm, mode="xla").serve(
            IDS, GEN, max_length=MAXLEN)).tolist()
    assert len(gold_cont[0]) == 3  # the eos fired
    yield n, jm, tm, eos, gold_cont, gold_eng
    mesh_mod.finalize_distributed()


# -- task graph ---------------------------------------------------------------

_DIMS = dict(batch=2, d=64, hq_loc=4, hkv_loc=2, head_dim=32, f_loc=64,
             v_loc=128, num_layers=3, s_max=64)


def test_tp_task_tables_match_jax(tp_models):
    """Every option of a tp=n decode graph packs the JAX table: the entry
    BARRIER (after RING_POLL with a work ring), each exchange an
    ALLREDUCE or an AR_SEND/AR_WAIT pair, fused norms or not, traced ids
    or not. (The options loop here: pytest parameters would make it
    reorder the module's tests across the tp fixture's instances.)"""
    n, jm = tp_models[:2]
    for fuse_norms, overlap, ns, eos, ring, trace in (
            (f, o, *rest) for f in (False, True) for o in (False, True)
            for rest in ((1, False, False, False), (8, True, True, True),
                         (8, False, False, True))):
        kw = dict(_DIMS, n_ranks=n, nsteps=ns, v_real=200, page=16,
                  num_pages=9, eos=eos, ring=ring, trace=trace)
        jb = JaxModelBuilder(JaxMegaDims(**kw), cfg=JaxMegaConfig(
            fuse_norms=fuse_norms, overlap_ar=overlap), ctx=jm.ctx)
        jb.build_decoder_graph()
        tb = ModelBuilder(MegaDims(**kw), cfg=MegaConfig(
            fuse_norms=fuse_norms, overlap_ar=overlap))
        tb.build_decoder_graph()
        got = pack_table(schedule(tb.tasks), trace=trace)
        np.testing.assert_array_equal(
            got, jax_pack(jax_schedule(jb.tasks), trace=trace))
        types = [TaskType(int(t)) for t in got[:, 0]]
        assert types[int(ring)] == TaskType.BARRIER
        exch = 2 * _DIMS["num_layers"]
        if overlap:
            assert types.count(TaskType.AR_SEND) == exch
            assert types.count(TaskType.AR_WAIT) == exch
        else:
            assert types.count(TaskType.ALLREDUCE) == exch


# -- the plain megakernel against the JAX xla decode -------------------------

def _warm(jm, tm, b: int):
    """A dense cache after one JAX xla step, in both packages (the port's
    ``[n, L, B, hkv_loc, S, hd]``: the JAX cache's kv heads split in n
    contiguous parts)."""
    n = tm.tp
    jc = jm.new_cache(b, max_length=MAXLEN)
    with portable_export():
        _, jc = jm.decode_fn("xla")(jm.params,
                                    jnp.asarray([3, 5, 7, 9][:b], jnp.int32),
                                    jc)
    leaves = jax.tree.map(np.array, jc)

    def port():
        def split(a):
            return torch.from_numpy(np.stack(np.split(a, n, axis=2)).copy())

        return KVCache(k=split(leaves.k), v=split(leaves.v),
                       kv_len=torch.from_numpy(leaves.kv_len.copy()))

    return jc, port


def test_tp_plain_megakernel_matches_jax_xla(tp_models):
    """One step's logits and an NS = 4 launch's tokens (and last logits)
    against the JAX xla decode at the same tp; every rank's tokens and
    final residual bitwise equal; rank 1's partial dropped at layer 1's
    exchanges changes the logits."""
    n, jm, tm, _, _, _ = tp_models
    B = 2
    jc, port = _warm(jm, tm, B)
    tok0 = jnp.asarray([19, 23], jnp.int32)
    with portable_export():
        step = jm.decode_fn("xla")
        jl, jc1 = step(jm.params, tok0, jc)
        want_toks, want_logits, c = [], None, jc
        tok = tok0
        for _ in range(NS):
            want_logits, c = step(jm.params, tok, c)
            tok = jnp.argmax(want_logits, axis=-1).astype(jnp.int32)
            want_toks.append(np.asarray(tok))
    for cfg in (MegaConfig(), MegaConfig(**SERVING)):
        mega = MegaQwen3(tm, cfg=cfg)
        logits, cache = mega.decode_step(torch.tensor([19, 23]), port())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=ATOL, rtol=0)
        assert cache.kv_len.tolist() == np.asarray(jc1.kv_len).tolist()
        toks, lg, _ = mega.decode_multi_fn(B, MAXLEN, NS)(
            tm.params, torch.tensor([19, 23]), port())
        np.testing.assert_array_equal(toks.numpy(), np.stack(want_toks))
        np.testing.assert_allclose(lg.numpy(), np.asarray(want_logits),
                                   atol=ATOL, rtol=0)
    # The launch itself: the ranks agree bit for bit; a dropped partial
    # is seen.
    dims = dataclasses.replace(mega._dims(B, MAXLEN), nsteps=NS,
                               v_real=tm.cfg.vocab_size)
    table = mega._compile(dims).table
    cache = port()
    args = ([c.k for c in map(cache.rank, range(n))],
            [c.v for c in map(cache.rank, range(n))], None, cache.kv_len,
            torch.tensor([19, 23], dtype=torch.int32))
    info = {}
    out = mega_decode_plain_tp(dims, True, table, _weights(tm.params), *args,
                               info=info)
    assert info["x"].shape == (n, B, tm.cfg.hidden_size)
    for r in range(1, n):
        assert torch.equal(info["x"][r], info["x"][0])
        assert torch.equal(info["toks"][r], info["toks"][0])
    np.testing.assert_array_equal(out[3].numpy(), np.stack(want_toks))
    dropped = mega_decode_plain_tp(dims, True, table, _weights(tm.params),
                                   *args, drop_partial=(1, 1))
    assert (dropped[0] - out[0]).abs().max().item() > 100 * ATOL


def test_plain_rings_per_rank(tp_models):
    """The serving config, B=2, NS=2: one ring a rank, gap-free and valid
    against the scheduled order, every AR_SEND/AR_WAIT pair stamping its
    phase marks, one overlap window per exchange per rank (the JAX
    ``tests/test_kernel_trace.py:132`` checks at tp=4); the traced launch
    keeps the untraced one's outputs. At tp=2 the rings equal the JAX
    interpret-mode megakernel's, every column and rank, with equal
    overlap reports (one short launch: the interpret kernel at tp=4 would
    break the time budget)."""
    n, jm, tm, _, _, _ = tp_models
    B, ns = 2, 2
    jc, port = _warm(jm, tm, B)
    mega = MegaQwen3(tm, cfg=MegaConfig(**SERVING))
    t0, l0, _ = mega.decode_multi_fn(B, MAXLEN, ns)(
        tm.params, torch.tensor([19, 23]), port())
    t1, l1, _, ring = mega.decode_multi_fn(B, MAXLEN, ns, trace=True)(
        tm.params, torch.tensor([19, 23]), port())
    assert ring.shape == (n, ns, ring.shape[2], 8)
    assert torch.equal(t0, t1) and torch.equal(l0, l1)
    order = mega.multi_task_order(B, MAXLEN, ns, trace=True)
    records = kt.decode_trace(ring.numpy())
    assert kt.validate_ring(records, order) == []
    L = tm.cfg.num_layers
    pairs = [r for r in records if r.opcode in (int(TaskType.AR_SEND),
                                                int(TaskType.AR_WAIT))]
    assert len(pairs) == 2 * 2 * L * ns * n
    assert all(r.begin <= r.mid <= r.end for r in pairs)
    rep = kt.overlap_report(records)
    assert rep["windows"] == 2 * L * ns * n
    if n != 2:
        return
    # Step 0's tokens agree with the JAX xla step's. The interpret-mode
    # megakernel's tokens are no oracle at tp > 1, not even at step 0: its
    # cross-rank exchange does not gate under this jax's interpret mode,
    # so under a loaded host a rank may fold a peer's partial before it
    # is written (its ring, on the logical clock, is deterministic).
    with portable_export():
        jl, _ = jm.decode_fn("xla")(jm.params,
                                    jnp.asarray([19, 23], jnp.int32), jc)
    np.testing.assert_array_equal(t1.numpy()[0],
                                  np.asarray(jnp.argmax(jl, axis=-1)))
    jmega = JaxMegaQwen3(jm, cfg=JaxMegaConfig(**SERVING))
    _, _, _, jring = jmega.decode_multi_fn(B, MAXLEN, ns, trace=True)(
        jm.params, jnp.asarray([19, 23], jnp.int32), jc)
    jring = np.asarray(jring)
    np.testing.assert_array_equal(ring.numpy(), jring)
    assert rep == jkt.overlap_report(jkt.decode_trace(jring))


# -- the engines -------------------------------------------------------------

def test_tp_mega_engines_emit_the_jax_tokens(tp_models):
    """ContinuousEngine(mode="mega", ns=4) with the prefix cache and eos,
    then resident and traced (every launch's per-rank rings validate
    against the scheduled order and its doorbell), and Engine(mode="mega")
    dense and paged: the JAX xla engines' greedy tokens."""
    n, _, tm, eos, gold_cont, gold_eng = tp_models
    kw = dict(max_batch=2, page_size=PAGE, max_length=MAXLEN, mode="mega",
              ns=NS, device="cpu", eos_id=eos)
    reqs = [(p, GEN) for p in PROMPTS]
    eng = ContinuousEngine(tm, prefix_cache=True, **kw)
    assert [o.tolist() for o in eng.run(reqs)] == gold_cont
    assert eng.last_stats["mega_launches"] > 0
    res = ContinuousEngine(tm, resident=True, kernel_trace=True, **kw)
    assert [o.tolist() for o in res.run(reqs)] == gold_cont
    st = res.last_stats
    assert st["mega_resident_rounds"] > 0 and st["mega_trace_launches"] > 0
    order = res._mega_model().multi_task_order(
        2, MAXLEN, NS, page=PAGE, num_pages=res.cache.num_pages,
        valid_arg=True, trace=True, eos=True, ring=True)
    assert [t.task_type for t in order[:2]] == [TaskType.RING_POLL,
                                               TaskType.BARRIER]
    for ln in res.kernel_trace_launches():
        assert ln.ring.shape[0] == n
        assert kt.validate_ring(ln.get_records(), order,
                                doorbell=ln.doorbell) == []
    assert res._ring.occupancy == 0
    for paged in (False, True):
        out = Engine(tm, mode="mega", paged=paged, page_size=PAGE,
                     device="cpu").serve(IDS, GEN, max_length=MAXLEN, ns=NS)
        assert out.tolist() == gold_eng
