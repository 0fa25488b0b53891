"""Megakernel task graph: task types, headers, ids, dependencies.

Counterpart of ``triton_distributed_tpu/megakernel/task.py``, a
host-only copy: the same ``TaskType`` values, ``Task``,
``TaskDependency``, ``TaskIDManager``, ``pack_table`` and the
``HDR_INTS`` / ``TR_*`` layout, so a packed table of the port is the
JAX package's table, int for int.

Tasks are op-granular (one task = one op over the whole batch). The
TPU kernel discharges dependencies by schedule order on its sequential
grid; the CUDA kernel (``csrc/megakernel.cu``) walks the same order with
a grid-wide barrier between dependent tasks, and splits each task into
tiles over its blocks.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

# Device-side header layout: HDR_INTS int32 per task.
# [0] task_type  [1] layer_id  [2] arg0  [3] arg1  [4] task_id
# (rest reserved). task_id is stamped only for traced tables.
HDR_INTS = 8

# Device trace-ring record layout (the JAX package's task tracer; the
# port keeps the layout, its kernel writes no ring yet).
TRACE_INTS = 8
TR_TASK_ID = 0   # builder task id (header slot 4)
TR_OPCODE = 1    # TaskType value
TR_LAYER = 2     # layer_id
TR_SLOT = 3      # arg0 (e.g. the allreduce parity slot)
TR_BEGIN = 4     # clock at task entry
TR_END = 5       # clock at task exit (epilogue included)
TR_MID = 6       # optional intra-task phase stamp (0 = none)
TR_FLAG = 7      # 1 = record written


class TaskType(enum.IntEnum):
    """Dispatch key: the value in header slot 0."""

    EMBED = 0        # x ← embed[tokens]
    NORM = 1         # h ← rms_norm(x) * w;  arg0: 0=ln1  1=ln2  2=final
    QKV_PROJ = 2     # qkv ← h @ wqkv[layer]
    ATTN = 3         # rope + QK-norm + GQA decode → attn out
    O_PROJ = 4       # h ← attn_out @ wo[layer]
    FC1 = 5          # mlp ← silu(h @ gate) * (h @ up)
    FC2 = 6          # h ← mlp @ w2[layer]
    ALLREDUCE = 7    # x ← x + psum(h);  arg0: parity slot
    LM_HEAD = 8      # logits ← rms_norm(x) stage then tiled GEMM
    BARRIER = 9      # standalone cross-chip barrier
    ATTN_PREFILL = 10  # causal self-attn over the S token rows + K/V out
    LOAD_X = 11      # x ← x0 input (prefill)
    AR_SEND = 12     # split allreduce, send half (overlap_ar, tp > 1)
    AR_WAIT = 13     # split allreduce, wait half
    MOE_GATE = 14    # router: softmax top-k over experts
    MOE_FFN = 15     # one local expert's SwiGLU FFN; arg0: local expert
    A2A_SEND = 16    # EP combine puts; arg0: phase
    A2A_WAIT = 17    # EP combine wait
    RING_POLL = 18   # resident decode: observe the host work ring


# Resource class used by the zig-zag scheduler: tasks dominated by
# data movement rather than by the matrix units.
COMM_TASKS = frozenset({
    TaskType.ALLREDUCE, TaskType.BARRIER, TaskType.EMBED,
    TaskType.AR_SEND, TaskType.AR_WAIT,
    TaskType.A2A_SEND, TaskType.A2A_WAIT, TaskType.RING_POLL,
})


@dataclasses.dataclass(frozen=True)
class TaskDependency:
    """Edge producer → consumer (whole-task edges)."""

    producer: int  # task id


@dataclasses.dataclass
class Task:
    """One schedulable unit."""

    task_id: int
    task_type: TaskType
    layer_id: int = 0
    arg0: int = 0
    arg1: int = 0
    deps: tuple[TaskDependency, ...] = ()

    def header(self, trace: bool = False) -> list[int]:
        # The id column (slot 4) is stamped only for traced tables, so
        # an untraced table is the same bytes with the tracer off.
        h = [int(self.task_type), self.layer_id, self.arg0, self.arg1,
             self.task_id if trace else 0]
        return h + [0] * (HDR_INTS - len(h))


class TaskIDManager:
    """Monotone task-id allocator."""

    def __init__(self) -> None:
        self._next = 0

    def alloc(self) -> int:
        tid = self._next
        self._next += 1
        return tid

    @property
    def count(self) -> int:
        return self._next


def pack_table(tasks: list[Task], trace: bool = False) -> np.ndarray:
    """Flatten scheduled tasks into the ``[T, HDR_INTS]`` int32 table the
    kernel walks."""
    if not tasks:
        raise ValueError("empty task list")
    return np.asarray([t.header(trace) for t in tasks], np.int32)
