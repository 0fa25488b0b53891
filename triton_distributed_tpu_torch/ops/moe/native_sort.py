"""The native (C++) MoE align/sort, on host tensors.

Counterpart of ``triton_distributed_tpu/ops/moe/native_sort.py``: the
C++ routine of ``csrc/moe_utils.cc`` (the port's copy, built by
``native.py``) reached two ways, both with the output contract of
:class:`~triton_distributed_tpu_torch.ops.moe.routing.AlignedBlocks`:

- :func:`moe_align_block_size_host`: a ctypes call on numpy arrays (the
  planner path);
- :func:`moe_align_block_size_op`: a ``torch.library`` custom op over CPU
  int32 tensors, with a fake implementation so traced code
  (``torch.compile``, ``torch.export``) can call it: the counterpart of
  JAX's XLA FFI call (:63). The routine is host code: a CUDA tensor is
  refused (the card's in-graph path is the torch composition
  ``routing.moe_align_block_size``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from triton_distributed_tpu_torch.native import get_native
from triton_distributed_tpu_torch.ops.moe.routing import (
    AlignedBlocks,
    align_capacities,
)

_I32P = ctypes.POINTER(ctypes.c_int32)


def _align(flat: np.ndarray, num_experts: int, block_size: int) -> tuple:
    """(sorted_ids, block_expert, counts[2]) of the native routine;
    raises ValueError on its error codes, RuntimeError without a build."""
    lib = get_native()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    n = flat.shape[0]
    # A block size the routine refuses (rc 1) has no capacities to size.
    cap, bcap = (align_capacities(n, num_experts, block_size)
                 if block_size > 0 else (0, 0))
    sorted_ids = np.empty((cap,), np.int32)
    block_expert = np.empty((bcap,), np.int32)
    counts = np.empty((2,), np.int32)
    rc = lib.tdt_moe_align_block_size_host(
        flat.ctypes.data_as(_I32P), n, num_experts, block_size,
        sorted_ids.ctypes.data_as(_I32P), cap,
        block_expert.ctypes.data_as(_I32P), bcap,
        counts.ctypes.data_as(_I32P))
    if rc != 0:
        raise ValueError(f"moe_align_block_size failed (rc={rc})")
    return sorted_ids, block_expert, counts


def moe_align_block_size_host(expert_ids: np.ndarray, num_experts: int,
                              block_size: int) -> AlignedBlocks:
    """The C++ host planner on a numpy ``[T, k]`` or ``[N]`` int32 array
    (raises RuntimeError without a native build)."""
    flat = np.ascontiguousarray(np.asarray(expert_ids).reshape(-1),
                                np.int32)
    sorted_ids, block_expert, counts = _align(flat, num_experts, block_size)
    return AlignedBlocks(sorted_ids=sorted_ids, block_expert=block_expert,
                         num_blocks=np.int32(counts[0]),
                         num_padded=np.int32(counts[1]))


@torch.library.custom_op("tdt_torch::moe_align_block_size", mutates_args=())
def _align_op(expert_ids: torch.Tensor, num_experts: int, block_size: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if expert_ids.device.type != "cpu":
        raise ValueError("moe_align_block_size_op runs on host tensors; got "
                         f"one on {expert_ids.device}")
    flat = np.ascontiguousarray(
        expert_ids.reshape(-1).to(torch.int32).numpy())
    out = _align(flat, num_experts, block_size)
    return tuple(torch.from_numpy(x) for x in out)


@_align_op.register_fake
def _(expert_ids, num_experts, block_size):
    cap, bcap = (align_capacities(expert_ids.numel(), num_experts,
                                  block_size) if block_size > 0 else (0, 0))
    return (expert_ids.new_empty((cap,), dtype=torch.int32),
            expert_ids.new_empty((bcap,), dtype=torch.int32),
            expert_ids.new_empty((2,), dtype=torch.int32))


def moe_align_block_size_op(expert_ids: torch.Tensor, num_experts: int,
                            block_size: int) -> AlignedBlocks:
    """The custom-op form on a CPU int tensor (callable inside traced
    code)."""
    sorted_ids, block_expert, counts = _align_op(expert_ids, num_experts,
                                                 block_size)
    return AlignedBlocks(sorted_ids=sorted_ids, block_expert=block_expert,
                         num_blocks=counts[0], num_padded=counts[1])
