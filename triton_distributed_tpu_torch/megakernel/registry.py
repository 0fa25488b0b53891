"""Task registry: task type → plain PyTorch body.

Counterpart of ``triton_distributed_tpu/megakernel/registry.py``. There
a task type maps to the factory of its Pallas body; here to the plain
PyTorch function that computes the body over the f32 decode state
(``megakernel/kernels.py``). The CUDA kernel holds its own bodies in
``csrc/megakernel.cu`` and is held against these.
"""

from __future__ import annotations

from typing import Callable

from triton_distributed_tpu_torch.megakernel.task import TaskType

# body(state, layer, arg0) -> None, updating ``state`` in place.
Body = Callable[..., None]

_REGISTRY: dict[TaskType, Body] = {}


def register_task(task_type: TaskType):
    """Decorator: register the plain body of ``task_type``."""

    def deco(body: Body) -> Body:
        if task_type in _REGISTRY:
            raise ValueError(f"duplicate task body for {task_type!r}")
        _REGISTRY[task_type] = body
        return body

    return deco


def get_body(task_type: TaskType) -> Body:
    try:
        return _REGISTRY[task_type]
    except KeyError:
        raise KeyError(
            f"no body registered for {task_type!r}; "
            "import triton_distributed_tpu_torch.megakernel.kernels"
        ) from None


def registered_types() -> tuple[TaskType, ...]:
    return tuple(sorted(_REGISTRY, key=int))
