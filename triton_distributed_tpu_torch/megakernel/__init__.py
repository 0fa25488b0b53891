"""Megakernel subsystem of the PyTorch port: a whole decode step (or NS
steps), or a prompt's prefill, as one persistent CUDA kernel over a
packed task table.

Counterpart of ``triton_distributed_tpu/megakernel``: the task graph
(``task``), scheduler, registry (task type → plain PyTorch body),
``ModelBuilder``, the launch (``code_generator``: ``MegaDims``,
``MegaConfig``, ``mega_decode``, ``mega_decode_tp``, ``mega_prefill``),
the plain bodies (``kernels``), the resident engine's host work ring
(``ring``) and ``MegaQwen3``. The kernels are in ``csrc/megakernel.cu``.
"""

from triton_distributed_tpu_torch.megakernel import kernels  # noqa: F401  (register bodies)
from triton_distributed_tpu_torch.megakernel.code_generator import (
    MegaConfig,
    MegaDims,
    MegaWeights,
    mega_decode,
    mega_decode_tp,
)
from triton_distributed_tpu_torch.megakernel.model_builder import (
    CompiledMegaKernel,
    ModelBuilder,
)
from triton_distributed_tpu_torch.megakernel.qwen3 import MegaQwen3, Q8Params
from triton_distributed_tpu_torch.megakernel.registry import (
    register_task,
    registered_types,
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

__all__ = [
    "CompiledMegaKernel",
    "MegaConfig",
    "MegaDims",
    "MegaQwen3",
    "MegaWeights",
    "ModelBuilder",
    "Q8Params",
    "SchedulePolicy",
    "Task",
    "TaskDependency",
    "TaskIDManager",
    "TaskType",
    "mega_decode",
    "mega_decode_tp",
    "pack_table",
    "register_task",
    "registered_types",
    "schedule",
]
