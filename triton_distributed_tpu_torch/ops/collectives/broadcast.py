"""Broadcast over co-located ranks: the root's buffer to every rank.

Counterpart of ``triton_distributed_tpu/ops/collectives/broadcast.py``:
``BroadcastMethod`` (:32), ``broadcast`` (:68) and ``broadcast_op``
(:108). ``XLA`` is the plain version, the root's shard copied to every
rank (the JAX masked ``psum``); ``ONE_SHOT`` is the hand-written kernel
of ``csrc/collectives.cu`` (replacing ``_one_shot_bcast_kernel`` :41):
the entry barrier, then the root copies into its own output and puts to
every peer, one flag a (peer, piece). It moves bytes only, so it is
bitwise the plain version.

AUTO takes the kernel on the card for every input of >= 2 dims, and the
plain version on the CPU or for a 1-D input. The JAX AUTO hands payloads
over ``VMEM_COMM_MAX_BYTES`` (4 MiB) to XLA only because its kernel is
VMEM-resident; the card has no such ceiling (as for ``all_to_all``).
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives import _launch
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
)


class BroadcastMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    ONE_SHOT = "one_shot"


def broadcast_plain(xs: list[torch.Tensor], root: int) -> list[torch.Tensor]:
    """Every rank's copy of rank ``root``'s buffer."""
    return [xs[root].clone() for _ in xs]


def broadcast_kernel(xs: list[torch.Tensor], ctx, root: int, *, out=None
                     ) -> list[torch.Tensor]:
    """One cooperative launch of the one-shot kernel over all ranks."""
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    outs = _launch.outputs("out", tuple(x0.shape), x0.dtype, ctx, out)
    return _launch.move(ck.BROADCAST, _launch.BROADCAST, "broadcast", xs,
                        outs, ctx, root, 1,
                        work_bytes=x0.numel() * x0.element_size())


def broadcast(xs: list[torch.Tensor], ctx, root: int = 0,
              method: BroadcastMethod = BroadcastMethod.AUTO
              ) -> list[torch.Tensor]:
    """Every rank returns rank ``root``'s buffer. Takes and returns one
    tensor per rank. A kernel method on the CPU takes the plain
    version."""
    check_ranks("x", xs, ctx)
    n = ctx.tp
    if not 0 <= root < n:
        raise ValueError(f"root={root} out of range for axis size {n}")
    if method == BroadcastMethod.AUTO:
        method = (BroadcastMethod.ONE_SHOT
                  if device_initiable(ctx) and xs[0].dim() >= 2
                  else BroadcastMethod.XLA)
    if method == BroadcastMethod.XLA:
        return broadcast_plain(xs, root)
    if xs[0].dim() < 2:
        raise ValueError("the broadcast kernel needs >= 2-D input")
    if n == 1 or not device_initiable(ctx):
        return broadcast_plain(xs, root)
    return broadcast_kernel(xs, ctx, root)


def broadcast_op(x: torch.Tensor, ctx, root: int = 0,
                 method: BroadcastMethod = BroadcastMethod.AUTO
                 ) -> torch.Tensor:
    """Host-level form: ``x [n, ...]`` (row i = rank i's buffer); returns
    ``[n, ...]`` (row i = rank i's copy of the root's buffer)."""
    if x.shape[0] != ctx.tp:
        raise ValueError(f"leading dim {x.shape[0]} != tp={ctx.tp}")
    xs = [x[r].to(ctx.device).contiguous() for r in range(ctx.tp)]
    return torch.stack(broadcast(xs, ctx, root, method))
