"""Shared helpers of the cross-rank ops.

Counterpart of ``triton_distributed_tpu/ops/common.py``: the stage tile
picker (``pick_stage_tile``, which sets gemm_rs's bidir split) and
``device_initiable``, and ``pick_tile`` (:90: gemm_ar's default
``tile_n``, the column group of its trace ring). No counterpart:
``VMEM_COMM_MAX_BYTES`` (:36), a VMEM limit the card does not have
(``ops/overlap/gemm_ar.py`` says how its AUTO differs); and the Pallas
launch helper ``comm_pallas_call`` (:134), since each CUDA kernel is
launched by its wrapper (``ops/cuda_kernels.py``).
"""

from __future__ import annotations

import ctypes

import torch


def pick_stage_tile(m: int, row_bytes: int, budget: int,
                    floor: int = 128) -> int:
    """Largest divisor tile of ``m`` (by halving) whose staging buffer
    ``tile * row_bytes`` fits ``budget``; never below ``floor`` unless
    divisibility demands it."""
    tile = m
    while tile > floor and tile * row_bytes > budget:
        tile //= 2
    while m % tile:
        tile //= 2
    return max(tile, 1)


def pick_tile(n: int, preferred: int = 512) -> int:
    """Largest power-of-two-ish tile dividing ``n`` (JAX's
    ``create_*_context`` heuristic)."""
    tile = min(preferred, n)
    while n % tile:
        tile //= 2
    return max(tile, 128 if n % 128 == 0 else 1)


def device_initiable(ctx) -> bool:
    """True when the cross-rank CUDA kernels run: the context's ranks
    live on a CUDA device. On the CPU the ops take their plain versions,
    as the JAX package falls back to XLA off the TPU
    (``common.py:208-221``); :func:`check_ranks` holds every operand to
    the context's device, so this is also where the tensors lie."""
    return ctx.device.type == "cuda"


def rank_ptrs(ts) -> ctypes.Array:
    """The per-rank tensors' device pointers as a host int64 array (the
    kernels' by-value pointer table)."""
    return (ctypes.c_int64 * len(ts))(*[t.data_ptr() for t in ts])


def check_ranks(name: str, ts, ctx, dtype=None, ndim: int | None = None):
    """``ts`` is one tensor per rank of ``ctx``, alike in shape and dtype,
    on the context's device."""
    if len(ts) != ctx.tp:
        raise ValueError(f"{name}: {len(ts)} tensors for tp={ctx.tp}")
    shape, dt = tuple(ts[0].shape), dtype or ts[0].dtype
    for r, t in enumerate(ts):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(
                f"{name}[{r}] is {tuple(t.shape)} {t.dtype}; rank 0's is "
                f"{shape} {dt}")
        if ndim is not None and t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got {shape}")
        if t.device != ctx.device:
            raise ValueError(f"{name}[{r}] is on {t.device}, "
                             f"expected {ctx.device}")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated AND returned in f32 (the JAX
    ``preferred_element_type=f32`` product before any rounding)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))
