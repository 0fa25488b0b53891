"""One-device context: the port's stand-in for the JAX ``DistContext``.

The JAX package runs every model as a ``shard_map`` program over a mesh
(``triton_distributed_tpu/runtime/mesh.py`` ``DistContext``). At tp=1
there is no mesh to speak of, so the port keeps only what the code
around the kernels needs: the device the tensors live on and the model
dtype. Sharding, psums and partition specs are not ported.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Never falls back: asking for (or defaulting to) CUDA
    on a machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU (its kernels then use their plain "
                "PyTorch versions)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceContext:
    """Where a model's tensors live and what dtype they compute in."""

    device: torch.device
    dtype: torch.dtype

    @classmethod
    def create(cls, device=None, dtype: torch.dtype = torch.bfloat16):
        return cls(resolve_device(device), dtype)
