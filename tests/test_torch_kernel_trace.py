"""The port's device task tracer and resident megakernel decode against the
JAX package, on the CPU.

On the CPU the megakernel runs its plain version
(``megakernel/kernels.py``), which keeps the JAX kernel's logical trace
clock (one tick per begin, ALLREDUCE's mid and every end), so its ring is
held to the JAX megakernel's interpret-mode ring bit for bit, all eight
columns. The CUDA kernel stamps ``clock64()`` ticks instead and is held
to its plain version on the card (``tests/test_torch_cuda.py``).

- the plain ring at tiny, B=2, NS=2 equals JAX
  ``decode_multi_fn(..., trace=True)``'s, the tokens equal, and both
  packages' decoders read it the same;
- ``WorkRing``: publish, consume up to the published tail, flush, the
  overflow error;
- ``validate_ring``'s gap, order and doorbell checks on synthetic rings;
- resident ``ContinuousEngine(ns=2, resident=True, kernel_trace=True)``
  emits the JAX ``Engine(temperature=0).serve`` goldens with the JAX
  package's counter floors, and its rings validate against their
  doorbells;
- a resident session that always falls back to single steps drains its
  ring host-side;
- a drain that raises leaves the in-flight launch parked, and the step
  guard aborts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_distributed_tpu.megakernel import MegaQwen3 as JaxMegaQwen3
from triton_distributed_tpu.models import AutoLLM as JaxAutoLLM
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.obs import kernel_trace as jkt
from triton_distributed_tpu.runtime import mesh as mesh_mod
from triton_distributed_tpu_torch.megakernel import MegaQwen3, TaskType
from triton_distributed_tpu_torch.megakernel.ring import (
    RING_ADMIT,
    RING_CANCEL,
    RING_RETIRE,
    WorkRing,
    kind_name,
)
from triton_distributed_tpu_torch.models import (
    ContinuousEngine,
    KVCache,
    Qwen3,
    get_config,
    params_from_jax,
)
from triton_distributed_tpu_torch.obs import kernel_trace as kt

torch.set_num_threads(1)  # leave the CPU to the JAX test workers

PROMPTS = [np.asarray([5, 9, 2, 4], np.int32),
           np.asarray([7, 1, 3, 8, 6, 2, 4, 9], np.int32)]


@pytest.fixture(scope="module")
def models():
    ctx = mesh_mod.initialize_distributed(tp=1, devices=jax.devices()[:1])
    jm = JaxAutoLLM.from_pretrained("tiny", ctx=ctx, seed=0)
    tm = Qwen3(get_config("tiny"), device="cpu")
    tm.set_params(params_from_jax(jax.tree.map(np.asarray, jm.params)))
    yield jm, tm
    mesh_mod.finalize_distributed()


@pytest.fixture(scope="module")
def goldens(models):
    jm, _ = models
    return [JaxEngine(jm, temperature=0.0).serve(p[None], gen_len=6)[
        0, len(p):] for p in PROMPTS]


# -- the ring against the JAX megakernel ---------------------------------------

def test_plain_ring_equals_jax_interpret_ring(models):
    """tiny, B=2, NS=2 from a cache warmed by one xla step: the port's
    traced plain launch writes the JAX interpret-mode ring bit for bit
    (header columns, the logical clock's begin/mid/end, the flags), emits
    the JAX tokens, and keeps the untraced launch's outputs."""
    jm, tm = models
    B, NS, s_max = 2, 2, 64
    jcache = jm.new_cache(B, max_length=s_max)
    _, jcache = jm.decode_fn("xla")(jm.params, jnp.asarray([3, 5], jnp.int32),
                                    jcache)
    leaves = jax.tree.map(np.array, jcache)
    jmega = JaxMegaQwen3(jm)
    jt, _, _, jring = jmega.decode_multi_fn(B, s_max, NS, trace=True)(
        jm.params, jnp.asarray([19, 23], jnp.int32), jcache)
    jring = np.asarray(jring)

    def port_cache():
        return KVCache(k=torch.from_numpy(leaves.k.copy()),
                       v=torch.from_numpy(leaves.v.copy()),
                       kv_len=torch.from_numpy(leaves.kv_len.copy()))

    mega = MegaQwen3(tm)
    t0, l0, c0 = mega.decode_multi_fn(B, s_max, NS)(
        tm.params, torch.tensor([19, 23]), port_cache())
    t1, l1, c1, ring = mega.decode_multi_fn(B, s_max, NS, trace=True)(
        tm.params, torch.tensor([19, 23]), port_cache())
    assert ring.dtype == torch.int32 and ring.shape == jring.shape
    np.testing.assert_array_equal(ring.numpy(), jring)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt))
    for a, b in ((t0, t1), (l0, l1), (c0.k, c1.k), (c0.v, c1.v)):
        assert torch.equal(a, b)
    order = mega.multi_task_order(B, s_max, NS, trace=True)
    jorder = jmega.multi_task_order(B, s_max, NS, trace=True)
    assert [t.task_id for t in order] == [t.task_id for t in jorder]
    records = kt.decode_trace(ring.numpy())
    jrecords = jkt.decode_trace(jring)
    assert [r.__repr__() for r in records] == [r.__repr__() for r in jrecords]
    assert kt.validate_ring(records, order) == []
    assert kt.overlap_report(records) == jkt.overlap_report(jrecords)
    ar = [r for r in records if r.opcode == int(TaskType.ALLREDUCE)]
    assert ar and all(r.begin < r.mid < r.end for r in ar)


def test_single_step_trace_build_returns_the_ring(models):
    """``decode_fn(trace=True)``: (logits, cache, ring [1, 1, T, 8]); the
    untraced step keeps its 2-tuple."""
    _, tm = models
    mega = MegaQwen3(tm)
    cache = tm.new_cache(1, 64)
    out = mega.decode_fn(1, 64, trace=True)(tm.params, torch.tensor([3]),
                                            cache)
    assert len(out) == 3 and out[2].shape[:2] == (1, 1)
    assert kt.validate_ring(kt.decode_trace(out[2].numpy())) == []
    assert len(mega.decode_fn(1, 64)(tm.params, torch.tensor([3]),
                                     tm.new_cache(1, 64))) == 2


# -- WorkRing and validate_ring --------------------------------------------------

def test_work_ring_round_protocol():
    ring = WorkRing(capacity=3)
    ring.push(RING_ADMIT, 0, 4)
    ring.push(RING_ADMIT, 1, 8)
    state = ring.publish()
    assert state.tolist() == [1, 0, 2, 2]
    ring.push(RING_RETIRE, 0, 6)  # after the publish: the next round's
    got = ring.consume()
    assert [(i.kind_str, i.slot, i.arg, i.seq) for i in got] == [
        ("admit", 0, 4, 0), ("admit", 1, 8, 1)]
    assert ring.occupancy == 1 and ring.consume() == []
    ring.push(RING_CANCEL, 1)
    ring.push(RING_RETIRE, 1, 2)
    with pytest.raises(RuntimeError, match="full"):
        ring.push(RING_RETIRE, 0)
    assert ring.peak_occupancy == 3
    flushed = ring.flush()  # host drain: the doorbell does not move
    assert [i.kind for i in flushed] == [RING_RETIRE, RING_CANCEL,
                                         RING_RETIRE]
    assert ring.occupancy == 0 and ring.doorbell == 1
    assert ring.publish()[0] == 2
    assert kind_name(RING_CANCEL) == "cancel" and kind_name(9) == "kind9"
    with pytest.raises(ValueError):
        WorkRing(capacity=0)


def _synthetic_ring():
    """2 steps x [RING_POLL, EMBED, ALLREDUCE], a clean logical clock, the
    doorbell 5."""
    ring = np.zeros((2, 3, 8), np.int32)
    clk = 0
    for s in range(2):
        for t, op in enumerate((TaskType.RING_POLL, TaskType.EMBED,
                                TaskType.ALLREDUCE)):
            rec = ring[s, t]
            rec[:4] = (t, int(op), 0, 0)
            clk += 1
            rec[4] = clk
            if op == TaskType.ALLREDUCE:
                clk += 1
                rec[6] = clk
            if op == TaskType.RING_POLL:
                rec[6] = 5
            clk += 1
            rec[5] = clk
            rec[7] = 1
    return ring


def test_validate_ring_gap_order_and_doorbell():
    from triton_distributed_tpu_torch.megakernel.task import (
        Task,
        TaskDependency,
    )

    ring = _synthetic_ring()
    order = [Task(0, TaskType.RING_POLL),
             Task(1, TaskType.EMBED, deps=(TaskDependency(0),)),
             Task(2, TaskType.ALLREDUCE, deps=(TaskDependency(1),))]
    records = kt.decode_trace(ring)
    assert kt.validate_ring(records, order, doorbell=5) == []
    assert kt.overlap_report(records)["ring_polls"] == 2
    # The doorbell check: a stale snapshot.
    assert any("stale" in p for p in kt.validate_ring(records, doorbell=6))
    # A gap: an unwritten record raises in strict decoding.
    gap = ring.copy()
    gap[1, 2, 7] = 0
    with pytest.raises(kt.TraceError, match="gap"):
        kt.decode_trace(gap)
    assert len(kt.decode_trace(gap, strict=False)) == 5
    # Order: a record that begins before the previous one ends, a mid
    # outside its record, a consumer before its producer, steps that
    # overlap.
    bad = ring.copy()
    bad[0, 1, 4] = bad[0, 0, 5] - 1
    problems = kt.validate_ring(kt.decode_trace(bad), order)
    assert any("began at" in p for p in problems)
    assert any("before producer" in p for p in problems)
    bad = ring.copy()
    bad[0, 2, 6] = bad[0, 2, 5] + 1
    assert any("outside" in p for p in kt.validate_ring(kt.decode_trace(bad)))
    bad = ring.copy()
    bad[1, 0, 4] = 1
    assert any("step 1 began" in p
               for p in kt.validate_ring(kt.decode_trace(bad)))
    # The port's and the JAX package's decoders agree on every ring.
    for r in (ring, bad):
        assert (kt.validate_ring(kt.decode_trace(r), doorbell=5)
                == jkt.validate_ring(jkt.decode_trace(r), doorbell=5))


def test_observe_launch_and_chrome_rows():
    """``observe_launch`` folds a ring into the task histograms in groups
    of (opcode, bucket); the counts and sums equal one observation per
    record, on a ring of clock64-like durations (nearly all distinct)."""
    from triton_distributed_tpu_torch.obs import metrics

    launch = kt.KernelTraceLaunch(wall_s=0.01, t0=0.0, ring=_synthetic_ring(),
                                  doorbell=5, nsteps=2, launch=1)
    rep = kt.observe_launch(launch)
    assert rep["windows"] == 2 and rep["ring_doorbell_max"] == 5
    hist = metrics.default_registry().histogram(
        "tdt_mega_task_seconds", labels=("opcode",))
    assert sum(hist._series[("EMBED",)][0]) >= 2
    rows = kt.records_to_chrome(launch)
    assert sum(e["ph"] == "X" for e in rows) == 6
    assert launch.summary()["records"] == 6

    rng = np.random.default_rng(0)
    ring = np.zeros((4, 9, 8), np.int32)
    ends = np.cumsum(rng.integers(1, 40000, ring.shape[:2]).ravel())
    ring[..., 4] = (ends - rng.integers(1, 900, ends.size)).reshape(4, 9)
    ring[..., 5] = ends.reshape(4, 9)
    ring[..., 1] = np.arange(9) % 3 + 4  # O_PROJ, FC1, FC2
    ring[..., 7] = 1
    reg, ref = metrics.Registry(), metrics.Registry()
    kt.observe_launch(kt.KernelTraceLaunch(wall_s=0.05, t0=0.0, ring=ring),
                      registry=reg)
    want = ref.histogram("t", labels=("opcode",))
    span = int(ring[..., 5].max() - ring[..., 4].min())
    for rec in kt.decode_trace(ring):
        want.observe(rec.dur * 0.05 / span, opcode=rec.op)
    got = reg.histogram("tdt_mega_task_seconds", labels=("opcode",))
    assert set(got._series) == set(want._series)
    for key, (counts, total) in want._series.items():
        assert got._series[key][0] == counts
        assert abs(got._series[key][1] - total) <= 1e-12


# -- the resident engine ----------------------------------------------------------

def _resident(tm, **kw):
    return ContinuousEngine(tm, max_batch=2, page_size=16, max_length=64,
                            mode="mega", resident=True, device="cpu", **kw)


def test_resident_traced_engine_matches_jax_goldens(models, goldens):
    """Launch i+1 issues off launch i's outputs (mega_resident_rounds),
    admit and retire items go through the work ring, every traced
    launch's ring validates against the scheduled order and the doorbell
    published for it, doorbells climb, the ring is empty at rest, and the
    tokens are the JAX greedy engine's (JAX tests/test_resident.py's
    floors)."""
    _, tm = models
    eng = _resident(tm, kernel_trace=True, ns=2)
    outs = eng.run([(p, 6) for p in PROMPTS])
    for got, gold in zip(outs, goldens):
        np.testing.assert_array_equal(got, np.asarray(gold))
    st = eng.last_stats
    assert st["mega_resident_rounds"] > 0, st
    assert st["mega_ring_items"] >= 4, st  # 2 admits + 2 retires
    assert st["mega_ring_doorbells"] > 0, st
    assert st["mega_trace_launches"] == st["mega_launches"] > 0, st
    order = eng._mega_model().multi_task_order(
        2, 64, 2, page=16, num_pages=int(eng.cache.k_pages.shape[1]),
        valid_arg=True, trace=True, ring=True)
    assert order[0].task_type == TaskType.RING_POLL
    launches = eng.kernel_trace_launches()
    bells = [ln.doorbell for ln in launches]
    for ln in launches:
        assert kt.validate_ring(ln.get_records(), order,
                                doorbell=ln.doorbell) == []
    assert bells == sorted(bells) and len(set(bells)) == len(bells)
    summary = eng.kernel_trace_summary()
    assert summary["enabled"] and summary["launches"] == len(launches)
    assert eng._ring.occupancy == 0 and eng.audit() == []


def test_resident_persistent_fallback_drains_ring(models):
    """ns=1 with filtered sampling never composes a launch: every round
    falls back to a single step, which drains the ring host-side, so a
    ring of 4 items carries 4 requests' 8 admits and retires."""
    _, tm = models
    eng = ContinuousEngine(tm, max_batch=1, page_size=16, max_length=64,
                           mode="mega", resident=True, ns=1, temperature=0.8,
                           top_k=5, top_p=0.9, seed=3, device="cpu")
    eng._ring = WorkRing(capacity=4)
    results = eng.run([(PROMPTS[0], 4)] * 4, results=True)
    assert all(r.ok for r in results), [r.status for r in results]
    assert all(len(r.tokens) == 4 for r in results)
    st = eng.last_stats
    assert st["mega_fallback_steps"] > 0, st
    assert st["mega_ring_items"] == 8, st
    assert st["mega_ring_host_drains"] == 8, st
    assert st["mega_ring_doorbells"] == 0, st
    assert eng._ring.occupancy == 0 and eng.audit() == []


def test_resident_drain_fault_parks_inflight_launch(models, goldens):
    """A drain that raises on a pipelined round reaches the step guard
    with the next launch already parked in ``_pend``; the guard aborts it
    before teardown, every request fails with the error, and the engine
    then serves the goldens again."""
    _, tm = models
    eng = _resident(tm, ns=2)
    parked, orig = [], eng._drain_launch

    def faulty(pend):
        parked.append(eng._pend is not None)
        if eng._pend is not None:
            raise RuntimeError("drain fault")
        return orig(pend)

    eng._drain_launch = faulty
    results = eng.run([(p, 6) for p in PROMPTS], results=True)
    assert parked and parked[-1], parked
    assert all(r.status == "failed" and "drain fault" in r.reason
               for r in results)
    assert eng._pend is None
    assert eng.last_stats["decode_faults"] == 1
    assert eng.audit() == []
    eng._drain_launch = orig
    for got, gold in zip(eng.run([(p, 6) for p in PROMPTS]), goldens):
        np.testing.assert_array_equal(got, np.asarray(gold))
