"""Task scheduler: dependency-respecting linearization policies.

Counterpart of ``triton_distributed_tpu/megakernel/scheduler.py``, a
host-only copy. ROUND_ROBIN keeps build order; ZIG_ZAG list-schedules
so data-movement tasks sit next to matrix tasks whenever dependencies
allow. Both return an order in which every producer precedes its
consumers; the kernel walks it with a grid barrier between tasks.
"""

from __future__ import annotations

import enum

from triton_distributed_tpu_torch.megakernel.task import COMM_TASKS, Task


class SchedulePolicy(enum.Enum):
    ROUND_ROBIN = "round_robin"
    ZIG_ZAG = "zig_zag"


def _check_deps(tasks: list[Task]) -> None:
    ids = {t.task_id for t in tasks}
    for t in tasks:
        for d in t.deps:
            if d.producer not in ids:
                raise ValueError(
                    f"task {t.task_id} depends on unknown task {d.producer}"
                )


def schedule(
    tasks: list[Task], policy: SchedulePolicy = SchedulePolicy.ROUND_ROBIN
) -> list[Task]:
    """Return tasks in execution order; raises on dependency cycles."""
    _check_deps(tasks)
    if policy is SchedulePolicy.ROUND_ROBIN:
        order = _list_schedule(tasks, prefer_comm_flip=False)
    elif policy is SchedulePolicy.ZIG_ZAG:
        order = _list_schedule(tasks, prefer_comm_flip=True)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    _validate(order)
    return order


def _list_schedule(tasks: list[Task], *, prefer_comm_flip: bool) -> list[Task]:
    """Kahn's algorithm, ties broken by build order; with
    ``prefer_comm_flip`` the pick alternates resource classes."""
    by_id = {t.task_id: t for t in tasks}
    indeg = {t.task_id: len(t.deps) for t in tasks}
    consumers: dict[int, list[int]] = {t.task_id: [] for t in tasks}
    for t in tasks:
        for d in t.deps:
            consumers[d.producer].append(t.task_id)
    ready = [t.task_id for t in tasks if indeg[t.task_id] == 0]
    order: list[Task] = []
    last_comm = True  # so the first pick prefers compute
    while ready:
        pick = ready[0]
        if prefer_comm_flip:
            for tid in ready:
                if (by_id[tid].task_type in COMM_TASKS) != last_comm:
                    pick = tid
                    break
        ready.remove(pick)
        t = by_id[pick]
        last_comm = t.task_type in COMM_TASKS
        order.append(t)
        for c in consumers[pick]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if len(order) != len(tasks):
        stuck = sorted(set(by_id) - {t.task_id for t in order})
        raise ValueError(f"dependency cycle among tasks {stuck}")
    return order


def _validate(order: list[Task]) -> None:
    """Every producer precedes its consumers."""
    seen: set[int] = set()
    for t in order:
        for d in t.deps:
            if d.producer not in seen:
                raise AssertionError(
                    f"schedule places task {t.task_id} before its "
                    f"dependency {d.producer}"
                )
        seen.add(t.task_id)
