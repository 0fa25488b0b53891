"""ModelBuilder: whole-decode-step task graphs → one megakernel launch.

Counterpart of ``triton_distributed_tpu/megakernel/model_builder.py``:
the same ``make_*`` methods, the same ``build_decoder_graph`` and
``build_prefill_graph`` (so the packed tables equal the JAX package's,
int for int), and ``compile``, which schedules, packs the table and
binds it to the launch of ``csrc/megakernel.cu`` (or to the plain
version on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from triton_distributed_tpu_torch.megakernel.code_generator import (
    MegaCall,
    MegaConfig,
    MegaDims,
)
from triton_distributed_tpu_torch.megakernel.scheduler import (
    SchedulePolicy,
    schedule,
)
from triton_distributed_tpu_torch.megakernel.task import (
    Task,
    TaskDependency,
    TaskIDManager,
    TaskType,
    pack_table,
)


class ModelBuilder:
    """Decoder-LM task-graph builder. ``make_*`` methods append tasks
    with explicit dependencies (default: the previously appended task,
    the sequential decode chain); ``compile()`` freezes the graph."""

    def __init__(self, dims: MegaDims, *, cfg: MegaConfig | None = None,
                 device="cpu", ctx=None):
        self.dims = dims
        self.cfg = cfg or MegaConfig()
        self.device = device
        # The ranks' DistContext (tp > 1: the exchange's slots and flags).
        self.ctx = ctx
        self.tasks: list[Task] = []
        self._idm = TaskIDManager()
        self._last: int | None = None

    def _add(self, task_type: TaskType, layer: int = 0, arg0: int = 0,
             deps: list[int] | None = None) -> int:
        tid = self._idm.alloc()
        if deps is None:
            deps = [] if self._last is None else [self._last]
        self.tasks.append(Task(
            task_id=tid, task_type=task_type, layer_id=layer, arg0=arg0,
            deps=tuple(TaskDependency(d) for d in deps),
        ))
        self._last = tid
        return tid

    def make_embed(self, **kw) -> int:
        return self._add(TaskType.EMBED, **kw)

    def make_norm(self, layer: int, which: int, **kw) -> int | None:
        """which: 0 = input layernorm, 1 = post-attn, 2 = final. A no-op
        under ``cfg.fuse_norms``: the consumers normalise inline."""
        if self.cfg.fuse_norms:
            return None
        return self._add(TaskType.NORM, layer, arg0=which, **kw)

    def make_qkv_proj(self, layer: int, **kw) -> int:
        return self._add(TaskType.QKV_PROJ, layer, **kw)

    def make_attn(self, layer: int, **kw) -> int:
        return self._add(TaskType.ATTN, layer, **kw)

    def make_o_proj(self, layer: int, **kw) -> int:
        return self._add(TaskType.O_PROJ, layer, **kw)

    def make_fc1(self, layer: int, **kw) -> int:
        return self._add(TaskType.FC1, layer, **kw)

    def make_fc2(self, layer: int, **kw) -> int:
        return self._add(TaskType.FC2, layer, **kw)

    def make_allreduce(self, layer: int = 0, **kw) -> int:
        # Kept at tp=1: the body folds the residual (x += h). The split
        # AR_SEND/AR_WAIT pair exists only with real peers.
        if self.cfg.overlap_ar and self.dims.n_ranks > 1:
            self._add(TaskType.AR_SEND, layer, **kw)
            return self._add(TaskType.AR_WAIT, layer)
        return self._add(TaskType.ALLREDUCE, layer, **kw)

    def make_moe_gate(self, layer: int, **kw) -> int:
        return self._add(TaskType.MOE_GATE, layer, **kw)

    def make_moe_ffn(self, layer: int, expert: int,
                     handoff: bool = False) -> int:
        """One local expert's FFN task (``arg0`` = the expert).
        ``handoff`` marks the last expert without ``overlap_ar``: it
        copies the combine accumulator into ``h`` for the ALLREDUCE task
        that follows (``arg1 = 1``)."""
        tid = self._add(TaskType.MOE_FFN, layer, arg0=expert)
        if handoff:
            self.tasks[-1].arg1 = 1
        return tid

    def make_a2a_send(self, layer: int, phase: int) -> int:
        return self._add(TaskType.A2A_SEND, layer, arg0=phase)

    def make_a2a_wait(self, layer: int) -> int:
        return self._add(TaskType.A2A_WAIT, layer)

    def make_lm_head(self, **kw) -> int:
        return self._add(TaskType.LM_HEAD, **kw)

    def make_barrier(self, **kw) -> int:
        return self._add(TaskType.BARRIER, **kw)

    def make_ring_poll(self, **kw) -> int:
        return self._add(TaskType.RING_POLL, **kw)

    def make_attn_prefill(self, layer: int, **kw) -> int:
        return self._add(TaskType.ATTN_PREFILL, layer, **kw)

    def make_load_x(self, **kw) -> int:
        return self._add(TaskType.LOAD_X, **kw)

    def build_decoder_graph(self) -> None:
        """The decode-step chain: EMBED, per layer [NORM] QKV_PROJ ATTN
        O_PROJ ALLREDUCE [NORM] FC1 FC2 ALLREDUCE, then [NORM] LM_HEAD.
        With ``dims.moe`` the MLP section is ``_build_moe_mlp``'s."""
        if self.dims.ring:
            # A ring round observes the host work ring first: the
            # doorbell it stamps proves which published ring state the
            # round ran against.
            self.make_ring_poll()
        if self.dims.n_ranks > 1:
            self.make_barrier()
        self.make_embed()
        for l in range(self.dims.num_layers):
            self.make_norm(l, 0)  # no-op under cfg.fuse_norms
            self.make_qkv_proj(l)
            self.make_attn(l)
            self.make_o_proj(l)
            self.make_allreduce(l)
            self.make_norm(l, 1)
            if self.dims.moe:
                self._build_moe_mlp(l)
            else:
                self.make_fc1(l)
                self.make_fc2(l)
                self.make_allreduce(l)
        self.make_norm(0, 2)
        self.make_lm_head()

    def _build_moe_mlp(self, l: int) -> None:
        """One layer's MoE MLP: MOE_GATE, one MOE_FFN per local expert,
        and the combine. Under ``cfg.overlap_ar`` the combine is split:
        A2A_SEND phase 0 after the first half of the experts, phase 1
        and A2A_WAIT after the rest (kept at tp=1, where they are local
        copies and the fold); otherwise the last expert hands the
        accumulator to an ALLREDUCE task."""
        self.make_moe_gate(l)
        epr = self.dims.experts_loc
        overlap = self.cfg.overlap_ar
        split = max(-(-epr // 2), 1)  # phase 0 covers this many experts
        for e in range(epr):
            self.make_moe_ffn(l, e, handoff=e == epr - 1 and not overlap)
            if overlap and e == split - 1:
                self.make_a2a_send(l, phase=0)
        if overlap:
            self.make_a2a_send(l, phase=1)
            self.make_a2a_wait(l)
        else:
            self.make_allreduce(l)

    def build_prefill_graph(self) -> None:
        """The prompt-prefill chain: the decode chain's per-layer pipeline
        with causal self-attention over the S prompt rows (ATTN_PREFILL);
        the embedded prompt arrives as an input (LOAD_X) and the LM head
        projects only the last real row (``dims.prefill``)."""
        if self.dims.n_ranks > 1:
            self.make_barrier()
        self.make_load_x()
        for l in range(self.dims.num_layers):
            self.make_norm(l, 0)  # no-op under cfg.fuse_norms
            self.make_qkv_proj(l)
            self.make_attn_prefill(l)
            self.make_o_proj(l)
            self.make_allreduce(l)
            self.make_norm(l, 1)
            self.make_fc1(l)
            self.make_fc2(l)
            self.make_allreduce(l)
        self.make_norm(0, 2)
        self.make_lm_head()

    def compile(self, policy: SchedulePolicy = SchedulePolicy.ROUND_ROBIN
                ) -> "CompiledMegaKernel":
        """Schedule, pack the table and bind it to the launch."""
        order = schedule(self.tasks, policy)
        table = pack_table(order, trace=self.dims.trace)
        run = MegaCall(self.dims, self.cfg, order, table, self.device,
                       self.ctx)
        return CompiledMegaKernel(builder=self, order=order, table=table,
                                  run=run)


@dataclasses.dataclass
class CompiledMegaKernel:
    """A scheduled, packed megakernel and its launch."""

    builder: ModelBuilder
    order: list[Task]
    table: np.ndarray
    run: MegaCall

    @property
    def num_tasks(self) -> int:
        return len(self.order)
