"""Device task-tracer decoding: the megakernel's trace ring to records,
chrome-trace rows and overlap metrics.

Counterpart of ``triton_distributed_tpu/obs/kernel_trace.py``, a
host-only copy. The device half is ``MegaDims.trace``: the kernel
(``csrc/megakernel.cu``, or its plain version in
``megakernel/kernels.py``) writes one ``[task_id, opcode, layer, slot,
begin, end, mid, flag]`` int32 record per (step, task) into a ``[NS, T,
8]`` ring (layout ``megakernel/task.py``, ``TR_*``). This module is the
host half:

- :func:`decode_trace`: a raw ``[tp, NS, T, TRACE_INTS]`` ring to a flat
  :class:`TaskRecord` list (strict: a gap raises);
- :func:`validate_ring`: well-formed intervals, launch order on the
  clock, every dependency edge of the scheduled order, and the RING_POLL
  doorbell;
- :func:`overlap_report`: comm windows and what of them coincided with
  compute work (ALLREDUCE's ``[begin, mid]`` at tp=1);
- :func:`records_to_chrome`: one launch's records as chrome-trace rows;
- :func:`observe_launch`: ``tdt_mega_task_seconds{opcode}`` histograms
  and the overlap gauges in the port's metrics registry.

Clocks: the CUDA kernel stamps ``clock64()`` ticks of block 0's SM,
relative to the launch's first read; the plain version a logical clock
(one tick per begin, mid and end), as the JAX kernel does under
interpret. Decoding treats ticks as opaque monotonic values; seconds come
from apportioning a launch's measured wall time over its ticks. The
merged host/device timeline (JAX ``merge_with_host_profile``) waits for
the port of ``runtime/profiling.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from triton_distributed_tpu_torch.megakernel.task import (
    COMM_TASKS,
    TR_BEGIN,
    TR_END,
    TR_FLAG,
    TR_LAYER,
    TR_MID,
    TR_OPCODE,
    TR_SLOT,
    TR_TASK_ID,
    TRACE_INTS,
    TaskType,
)
from triton_distributed_tpu_torch.obs import metrics as obs_metrics

# Device-task rows sit in their own pid inside each rank's pid namespace
# of the JAX package's merged timeline (rank r's host events live at
# ``r * _PID_STRIDE + pid``): the same layout, so a port timeline merges
# with one.
_PID_STRIDE = 10_000_000
DEVICE_TASK_PID = 9_000_000


class TraceError(ValueError):
    """A decoded ring violated a structural invariant."""


# Hot-path lookup tables: TaskRecord.op / .is_comm run per record per
# traced launch inline on the serving decode path; constructing a
# TaskType enum per call was the decode cost's second-largest term.
_OP_NAMES = {int(t): t.name for t in TaskType}
_COMM_OPS = frozenset(int(t) for t in COMM_TASKS)
_AR_SEND = int(TaskType.AR_SEND)
_AR_WAIT = int(TaskType.AR_WAIT)
_ALLREDUCE = int(TaskType.ALLREDUCE)
_A2A_SEND = int(TaskType.A2A_SEND)
_A2A_WAIT = int(TaskType.A2A_WAIT)
_RING_POLL = int(TaskType.RING_POLL)


class TaskRecord:
    """One decoded (rank, step, task) ring record.

    A ``__slots__`` class with a positional ctor, not a dataclass:
    decoding runs inline on the serving decode path (every traced
    launch), where frozen-dataclass field assignment was the decode
    cost's dominant term in the JAX package.
    """

    __slots__ = ("rank", "step", "index", "task_id", "opcode", "layer",
                 "slot", "begin", "end", "mid")

    def __init__(self, rank, step, index, task_id, opcode, layer, slot,
                 begin, end, mid):
        self.rank = rank
        self.step = step
        self.index = index      # position in the scheduled order (grid t)
        self.task_id = task_id  # builder id (header slot 4)
        self.opcode = opcode    # TaskType value
        self.layer = layer
        self.slot = slot        # header arg0 (e.g. allreduce parity slot)
        self.begin = begin
        self.end = end
        self.mid = mid          # 0 = no intra-task phase stamp

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TaskRecord(rank={self.rank}, step={self.step}, "
                f"t={self.index}, {self.op}, [{self.begin}, {self.end}])")

    @property
    def op(self) -> str:
        name = _OP_NAMES.get(self.opcode)
        return name if name is not None else f"OP{self.opcode}"

    @property
    def dur(self) -> int:
        return self.end - self.begin

    @property
    def is_comm(self) -> bool:
        return self.opcode in _COMM_OPS


def _as_ranked(trace) -> np.ndarray:
    """Normalize a ring array to ``[tp, NS, T, TRACE_INTS]``."""
    arr = np.asarray(trace)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != TRACE_INTS:
        raise TraceError(
            f"expected [tp, NS, T, {TRACE_INTS}] ring, got {arr.shape}"
        )
    return arr


def decode_trace(trace, strict: bool = True) -> list[TaskRecord]:
    """Decode a device ring into records. ``strict=True`` (the
    megakernel contract) raises :class:`TraceError` on an unwritten
    row — that ring is dense by construction (one record per grid
    iteration), so a zero flag means the kernel never reached that
    iteration and the trace is not evidence of anything.
    ``strict=False`` skips unwritten rows instead: sparse rings (the
    standalone gemm_ar kernel's per-phase rows — not every grid
    position owns every phase) decode through the same path."""
    arr = _as_ranked(trace)
    records: list[TaskRecord] = []
    n_ranks, nsteps, T, _ = arr.shape
    # One C-level conversion to native ints (tolist) instead of eight
    # numpy-scalar casts per record: decoding runs inline on the
    # serving decode path (every traced launch).
    nested = arr.tolist()
    for r in range(n_ranks):
        for s in range(nsteps):
            rows = nested[r][s]
            for t in range(T):
                row = rows[t]
                if row[TR_FLAG] != 1:
                    if not strict:
                        continue
                    raise TraceError(
                        f"unwritten ring record at rank={r} step={s} "
                        f"task={t} (flag={row[TR_FLAG]}): the "
                        "trace has gaps"
                    )
                records.append(TaskRecord(
                    r, s, t, row[TR_TASK_ID], row[TR_OPCODE],
                    row[TR_LAYER], row[TR_SLOT], row[TR_BEGIN],
                    row[TR_END], row[TR_MID],
                ))
    return records


def validate_ring(
    records: list[TaskRecord], order=None, doorbell: int | None = None,
) -> list[str]:
    """Structural checks over decoded records; returns violation
    strings (empty == consistent).

    - every record's clock interval is well-formed (``begin < end``,
      ``mid`` inside it when stamped — EXCEPT RING_POLL records, whose
      mid column carries the observed work-ring doorbell, not a clock
      tick);
    - per (rank, step) the launch order is clock-monotonic (the grid is
      sequential: record i+1 must begin at/after record i ended);
    - with ``order`` (the scheduled ``list[Task]``), every scoreboard
      edge holds on the clock: ``begin[consumer] >= end[producer]``
      within a step, and step s+1's records all begin after step s's
      last end (the cross-step dependency the multi-step band implies);
    - with ``doorbell`` (the value ``WorkRing.publish`` returned for
      this launch), every RING_POLL record must have stamped exactly
      it — a mismatch means a round ran against a ring snapshot the
      host did not publish for it (the doorbell-gap check; the resident
      loop's proof that no round consumed stale ring state).
    """
    problems: list[str] = []
    by_rs: dict[tuple, list[TaskRecord]] = {}
    for rec in records:
        by_rs.setdefault((rec.rank, rec.step), []).append(rec)
    for (rank, step), recs in sorted(by_rs.items()):
        recs = sorted(recs, key=lambda x: x.index)
        for rec in recs:
            if rec.begin >= rec.end:
                problems.append(
                    f"rank{rank} step{step} t{rec.index} {rec.op}: "
                    f"begin {rec.begin} >= end {rec.end}"
                )
            if rec.opcode == _RING_POLL:
                if doorbell is not None and rec.mid != doorbell:
                    problems.append(
                        f"rank{rank} step{step} t{rec.index} RING_POLL: "
                        f"observed doorbell {rec.mid} != published "
                        f"{doorbell} (stale ring snapshot)"
                    )
            elif rec.mid and not (rec.begin <= rec.mid <= rec.end):
                problems.append(
                    f"rank{rank} step{step} t{rec.index} {rec.op}: mid "
                    f"{rec.mid} outside [{rec.begin}, {rec.end}]"
                )
        for a, b in zip(recs, recs[1:]):
            if b.begin < a.end:
                problems.append(
                    f"rank{rank} step{step}: t{b.index} {b.op} began at "
                    f"{b.begin} before t{a.index} {a.op} ended at {a.end}"
                )
        if order is not None:
            by_id = {rec.task_id: rec for rec in recs}
            for task in order:
                rec = by_id.get(task.task_id)
                if rec is None:
                    problems.append(
                        f"rank{rank} step{step}: scheduled task "
                        f"{task.task_id} has no ring record"
                    )
                    continue
                for dep in task.deps:
                    prod = by_id.get(dep.producer)
                    if prod is not None and rec.begin < prod.end:
                        problems.append(
                            f"rank{rank} step{step}: consumer "
                            f"{task.task_id} ({rec.op}) began at "
                            f"{rec.begin} before producer "
                            f"{dep.producer} ended at {prod.end}"
                        )
    # Cross-step ordering per rank.
    by_rank_step: dict[int, dict[int, list[TaskRecord]]] = {}
    for rec in records:
        by_rank_step.setdefault(rec.rank, {}).setdefault(
            rec.step, []).append(rec)
    for rank, steps in sorted(by_rank_step.items()):
        keys = sorted(steps)
        for s0, s1 in zip(keys, keys[1:]):
            hi = max(r.end for r in steps[s0])
            lo = min(r.begin for r in steps[s1])
            if lo < hi:
                problems.append(
                    f"rank{rank}: step {s1} began at {lo} before step "
                    f"{s0} ended at {hi}"
                )
    return problems


def overlap_report(records: list[TaskRecord]) -> dict:
    """MEASURED overlap exposure from the ring.

    Per (rank, step), each comm window is an AR_SEND..AR_WAIT pair
    (``MegaConfig.overlap_ar``: the window opens when the send's
    puts are in flight — its ``mid`` — and closes when the wait's
    blocked phase ends), a fused ALLREDUCE's ``[begin, mid]`` comm
    phase, or — MoE graphs — an A2A_SEND..A2A_WAIT EP-combine window
    (ONE window per gate layer: it opens at the FIRST phase's ``mid``,
    so the second half of the expert grouped GEMMs is exactly the work
    it hides under). Hidden = the part of the window coinciding with
    compute work: whole tasks scheduled inside it plus the wait's
    pre-block phase (tile-0 prefetch + dispatch — ``[begin, mid]`` of
    the wait). Exposed = the blocked remainder (``[mid, end]`` of the
    wait; the whole comm phase of a fused exchange).
    ``hidden_fraction`` aggregates every window; the ``a2a_*`` keys
    break the A2A family out. The
    ``ring_*`` keys summarize RING_POLL records (resident decode):
    poll count and the doorbell range they observed — a resident
    session's launches should show doorbells climbing 1, 2, 3, … with
    no repeats within a launch.
    """
    windows = 0
    comm = hidden = exposed = 0
    a2a_windows = 0
    a2a_comm = a2a_hidden = a2a_exposed = 0
    ring_polls = 0
    ring_doorbells: set[int] = set()
    by_rs: dict[tuple, list[TaskRecord]] = {}
    for rec in records:
        by_rs.setdefault((rec.rank, rec.step), []).append(rec)

    def _window(recs, open_t, close_t, wait):
        """(comm, hidden, exposed) of one send..wait window."""
        c = close_t - open_t
        h = (wait.mid or wait.begin) - wait.begin
        for other in recs:
            if other is wait or other.is_comm:
                continue
            lo = max(other.begin, open_t)
            hi = min(other.end, close_t)
            if hi > lo:
                h += hi - lo
        e = close_t - (wait.mid or wait.begin)
        return c, h, e

    for recs in by_rs.values():
        recs = sorted(recs, key=lambda x: x.index)
        seen_a2a_waits = set()
        for i, rec in enumerate(recs):
            if rec.opcode == _AR_SEND:
                wait = next(
                    (w for w in recs[i + 1:]
                     if w.opcode == _AR_WAIT
                     and w.layer == rec.layer and w.slot == rec.slot),
                    None,
                )
                if wait is None:
                    continue
                windows += 1
                c, h, e = _window(recs, rec.mid or rec.end, wait.end, wait)
                comm += c
                hidden += h
                exposed += e
            elif rec.opcode == _A2A_SEND and rec.slot == 0:
                # ONE window per gate layer, opened by the phase-0 send
                # (phase 1's bytes ride the same window — it closes at
                # the shared wait's end).
                wait = next(
                    (w for w in recs[i + 1:]
                     if w.opcode == _A2A_WAIT and w.layer == rec.layer),
                    None,
                )
                if wait is None or id(wait) in seen_a2a_waits:
                    continue
                seen_a2a_waits.add(id(wait))
                windows += 1
                a2a_windows += 1
                c, h, e = _window(recs, rec.mid or rec.end, wait.end, wait)
                comm += c
                hidden += h
                exposed += e
                a2a_comm += c
                a2a_hidden += h
                a2a_exposed += e
            elif rec.opcode == _ALLREDUCE and rec.mid:
                windows += 1
                comm += rec.mid - rec.begin
                exposed += rec.mid - rec.begin
            elif rec.opcode == _RING_POLL:
                ring_polls += 1
                ring_doorbells.add(rec.mid)
    return {
        "windows": windows,
        "comm_ticks": int(comm),
        "hidden_ticks": int(hidden),
        "exposed_ticks": int(exposed),
        "hidden_fraction": (hidden / comm) if comm else None,
        "a2a_windows": a2a_windows,
        "a2a_comm_ticks": int(a2a_comm),
        "a2a_hidden_ticks": int(a2a_hidden),
        "a2a_exposed_ticks": int(a2a_exposed),
        "a2a_hidden_fraction": (
            (a2a_hidden / a2a_comm) if a2a_comm else None
        ),
        "ring_polls": ring_polls,
        "ring_doorbell_min": (
            min(ring_doorbells) if ring_doorbells else None
        ),
        "ring_doorbell_max": (
            max(ring_doorbells) if ring_doorbells else None
        ),
    }


def _tick_span(records: list[TaskRecord], rank: int = 0) -> int:
    """Total clock span of one rank's records (seconds scaling base)."""
    mine = [r for r in records if r.rank == rank]
    if not mine:
        return 0
    return max(r.end for r in mine) - min(r.begin for r in mine)


def _overlap_report_array(arr: np.ndarray) -> dict | None:
    """Vectorized :func:`overlap_report` over a raw ring — the inline
    per-launch path (serving decode pays this every traced launch).
    Valid only when every AR_SEND is immediately followed by its
    AR_WAIT along the task axis (what the builder emits and the
    scheduler's sequential-chain deps preserve — tested); returns None
    otherwise and the caller falls back to the general record-wise
    implementation, which stays the semantic reference."""
    ops = arr[..., TR_OPCODE]
    if (ops == _A2A_SEND).any():
        # MoE EP-combine windows span whole expert-GEMM runs (never
        # send-adjacent-to-wait); the record-wise reference handles
        # them — and MoE launches are rare enough per process that the
        # general path's cost is irrelevant.
        return None
    n_sends = int((ops == _AR_SEND).sum())
    mids = arr[..., TR_MID]
    windows = 0
    comm = hidden = exposed = 0
    if n_sends:
        send_adj = (
            (ops[:, :, :-1] == _AR_SEND)
            & (ops[:, :, 1:] == _AR_WAIT)
            & (arr[:, :, :-1, TR_LAYER] == arr[:, :, 1:, TR_LAYER])
            & (arr[:, :, :-1, TR_SLOT] == arr[:, :, 1:, TR_SLOT])
        )
        if int(send_adj.sum()) != n_sends:
            return None  # non-adjacent pair somewhere: general path
        send = arr[:, :, :-1][send_adj]
        wait = arr[:, :, 1:][send_adj]
        open_t = np.where(
            send[:, TR_MID] > 0, send[:, TR_MID], send[:, TR_END]
        )
        wmid = np.where(
            wait[:, TR_MID] > 0, wait[:, TR_MID], wait[:, TR_BEGIN]
        )
        windows += n_sends
        comm += int((wait[:, TR_END] - open_t).sum())
        hidden += int((wmid - wait[:, TR_BEGIN]).sum())
        exposed += int((wait[:, TR_END] - wmid).sum())
    fused = (ops == _ALLREDUCE) & (mids > 0)
    if fused.any():
        c = int((mids[fused] - arr[..., TR_BEGIN][fused]).sum())
        windows += int(fused.sum())
        comm += c
        exposed += c
    rp = ops == _RING_POLL
    rp_mids = mids[rp]
    return {
        "windows": windows,
        "comm_ticks": comm,
        "hidden_ticks": hidden,
        "exposed_ticks": exposed,
        "hidden_fraction": (hidden / comm) if comm else None,
        # Schema parity with overlap_report: no A2A records reached
        # this path (it bails to the record-wise reference on any).
        "a2a_windows": 0,
        "a2a_comm_ticks": 0,
        "a2a_hidden_ticks": 0,
        "a2a_exposed_ticks": 0,
        "a2a_hidden_fraction": None,
        "ring_polls": int(rp.sum()),
        "ring_doorbell_min": (
            int(rp_mids.min()) if rp_mids.size else None
        ),
        "ring_doorbell_max": (
            int(rp_mids.max()) if rp_mids.size else None
        ),
    }


@dataclasses.dataclass
class KernelTraceLaunch:
    """Host-side metadata for one traced launch: the ring (raw and/or
    decoded) plus what only the host knows — wall time, when the
    launch ran (monotonic, comparable to event-ring timestamps), and
    which requests' trace ids occupied the batch slots.

    Engines construct with the RAW ``ring`` array and leave
    ``records`` to decode lazily (:meth:`get_records`): the inline
    per-launch work on the serving decode path is vectorized over the
    raw ring (``observe_launch``); full record decode happens only for
    the rare consumers (``kernel_trace_summary``, the chrome rows)."""

    wall_s: float
    t0: float
    trace_ids: dict[int, str] = dataclasses.field(default_factory=dict)
    nsteps: int = 0
    launch: int = 0
    records: list[TaskRecord] | None = None
    ring: np.ndarray | None = None
    # Work-ring doorbell the host published for this launch (resident
    # decode; None = ring-less launch). validate_ring checks every
    # RING_POLL record stamped exactly this value.
    doorbell: int | None = None

    def get_records(self) -> list[TaskRecord]:
        if self.records is None:
            self.records = decode_trace(self.ring)
        return self.records

    def summary(self) -> dict:
        records = self.get_records()
        per_op: dict[str, int] = {}
        for rec in records:
            if rec.rank == 0:
                per_op[rec.op] = per_op.get(rec.op, 0) + rec.dur
        return {
            "launch": self.launch,
            "wall_s": self.wall_s,
            "nsteps": self.nsteps,
            "records": len(records),
            "trace_ids": dict(self.trace_ids),
            "ticks_by_opcode": per_op,
            "overlap": overlap_report(records),
        }


def observe_launch(launch: KernelTraceLaunch, registry=None) -> dict:
    """Fold one traced launch into the metrics registry:
    ``tdt_mega_task_seconds{opcode}`` histograms (rank 0's records,
    ticks apportioned over the launch's measured wall time) and the
    ``tdt_mega_overlap_exposure`` gauge — measured wall seconds of AR
    comm window that coincided with compute work in this launch (the
    ring-derived replacement for the analytic estimate). Returns the
    overlap report.

    This runs INLINE per traced launch on the serving decode path:
    with a raw ``ring`` attached it is fully vectorized (gap check,
    per-opcode duration grouping, overlap windows) and never
    materializes records."""
    reg = registry if registry is not None else obs_metrics.default_registry()
    if launch.ring is not None and launch.records is None:
        arr = _as_ranked(launch.ring)
        if not (arr[..., TR_FLAG] == 1).all():
            decode_trace(arr)  # raises TraceError with the location
        rep = _overlap_report_array(arr)
        if rep is None:
            rep = overlap_report(launch.get_records())
        r0 = arr[0]
        span = int(r0[..., TR_END].max()) - int(r0[..., TR_BEGIN].min())
        durs = (r0[..., TR_END] - r0[..., TR_BEGIN]).ravel()
        ops = r0[..., TR_OPCODE].ravel()
    else:
        records = [r for r in launch.get_records() if r.rank == 0]
        rep = overlap_report(launch.get_records())
        span = _tick_span(records)
        durs = np.asarray([r.dur for r in records], np.int64)
        ops = np.asarray([r.opcode for r in records], np.int64)
    sec_per_tick = (launch.wall_s / span) if span else 0.0
    hist = reg.histogram(
        "tdt_mega_task_seconds",
        "Per-task device time inside megakernel launches, by opcode "
        "(ring ticks scaled to the launch's measured wall).",
        labels=("opcode",),
    )
    # Grouped by (opcode, bucket): one registry update per group, not per
    # record. The CUDA kernel's clock64 ticks make nearly every duration
    # distinct, so grouping by exact ticks (the JAX package's key, fine
    # for its logical clock) left one update per record, ~1600 a launch
    # at Qwen3-0.6B. A group's first value picks its bucket; its sum
    # stays exact.
    secs = durs.astype(np.float64) * sec_per_tick
    nb = len(hist.edges) + 1
    keys = (ops.astype(np.int64) * nb
            + np.searchsorted(hist.edges, secs, side="left"))
    uniq, first, inv, counts = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True)
    sums = np.bincount(inv.ravel(), weights=secs, minlength=len(uniq))
    for k, i, n, total in zip(uniq.tolist(), first.tolist(), counts.tolist(),
                              sums.tolist()):
        op = k // nb
        hist.observe_n(float(secs[i]), n, total=total,
                       opcode=_OP_NAMES.get(op, f"OP{op}"))
    reg.gauge(
        "tdt_mega_overlap_exposure",
        "Measured wall seconds of AR comm window coinciding with "
        "compute in the last traced launch (device ring; hidden comm).",
    ).set(rep["hidden_ticks"] * sec_per_tick)
    reg.gauge(
        "tdt_mega_overlap_hidden_fraction",
        "Measured fraction of AR comm window hidden under compute in "
        "the last traced launch (device ring).",
    ).set(rep["hidden_fraction"] if rep["hidden_fraction"] is not None
          else 1.0)
    return rep


def records_to_chrome(
    launch: KernelTraceLaunch, *, t0_us: float = 0.0
) -> list[dict]:
    """One launch's records as chrome-trace ``X`` events + per-rank
    process metadata. Each rank's device rows live at
    ``rank * _PID_STRIDE + DEVICE_TASK_PID``, inside that rank's pid
    namespace of the JAX package's merged host timeline.
    Ticks are scaled to microseconds over the launch's wall time; the
    launch's request trace ids ride in every event's args."""
    records = launch.get_records()
    span = _tick_span(records)
    us_per_tick = (launch.wall_s * 1e6 / span) if span else 1.0
    tids = ",".join(
        launch.trace_ids[k] for k in sorted(launch.trace_ids)
    )
    events: list[dict] = []
    ranks = sorted({r.rank for r in records})
    base_tick = {
        r: min(x.begin for x in records if x.rank == r)
        for r in ranks
    }
    for rank in ranks:
        events.append({
            "ph": "M", "name": "process_name",
            "pid": rank * _PID_STRIDE + DEVICE_TASK_PID,
            "args": {"name": f"rank{rank}: device tasks"},
        })
    for rec in records:
        events.append({
            "ph": "X",
            "name": rec.op,
            "pid": rec.rank * _PID_STRIDE + DEVICE_TASK_PID,
            "tid": rec.step,
            "ts": t0_us + (rec.begin - base_tick[rec.rank]) * us_per_tick,
            "dur": max(rec.dur * us_per_tick, 0.001),
            "args": {
                "task_id": rec.task_id, "layer": rec.layer,
                "slot": rec.slot, "step": rec.step,
                "launch": launch.launch, "trace_ids": tids,
            },
        })
    return events
