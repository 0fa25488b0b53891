"""Point-to-point transport for pipeline parallelism over co-located ranks.

Counterpart of ``triton_distributed_tpu/parallel/p2p.py``: ``pp_shift``
(:71), ``pp_send_recv`` (:107) and ``pp_recv_from_prev`` (:120). A
pipeline hop is a neighbour shift: stage i's buffer becomes stage i+1's
input; stage 0 receives zeros, or stage n-1's buffer with ``wrap``.

Methods: ``"xla"`` is the plain version (the JAX ``ppermute``: a copy of
the previous rank's buffer, zeros at rank 0); ``"pallas"`` is the
hand-written kernel of ``csrc/collectives.cu`` replacing ``_shift_kernel``
(:43): the entry barrier, every sender puts its shard into rank me+1's
output and flags it, receivers wait on the flag, rank 0 writes zeros when
not wrapping. It moves bytes only, so it is bitwise the plain version.
``"auto"`` takes the kernel when the context is on the card and the input
has >= 2 dims, else the plain version; an explicit ``"pallas"`` on a 1-D
input raises ``ValueError``, and on the CPU takes the plain version.

The shift runs over the context's ``tp`` ranks (the axis the port's
kernels run over). Over a ``dp x tp`` context ``xs`` holds one tensor per
global rank ``d * tp + t`` and the shift runs in each dp group
(``ctx.group(d)``), as the JAX ``axis="tp"`` shift does on a dp x tp
mesh. ``pp_send_recv`` is a ``ppermute`` in JAX, with no kernel: the port
has its plain version only.
"""

from __future__ import annotations

import torch

from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.collectives import _launch
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
)

METHODS = ("auto", "xla", "pallas")


def pp_shift_plain(xs: list[torch.Tensor], wrap: bool = False
                   ) -> list[torch.Tensor]:
    """Rank i's copy of rank i-1's buffer; rank 0's is rank n-1's with
    ``wrap``, else zeros."""
    first = xs[-1].clone() if wrap else torch.zeros_like(xs[0])
    return [first] + [x.clone() for x in xs[:-1]]


def pp_shift_kernel(xs: list[torch.Tensor], ctx, wrap: bool = False, *,
                    out=None, blocks_per_rank: int | None = None
                    ) -> list[torch.Tensor]:
    """One cooperative launch of the shift kernel over the context's
    ranks."""
    x0 = xs[0]
    _launch.check_operands("x", xs, ctx, elementwise=False)
    outs = _launch.outputs("out", tuple(x0.shape), x0.dtype, ctx, out)
    return _launch.move(ck.PP_SHIFT, _launch.SHIFT, "pp_shift", xs, outs,
                        ctx, int(bool(wrap)), 1,
                        work_bytes=x0.numel() * x0.element_size(),
                        blocks_per_rank=blocks_per_rank)


def _shift_group(xs, ctx, wrap: bool, method: str) -> list[torch.Tensor]:
    n = ctx.tp
    if method == "auto":
        method = ("pallas" if device_initiable(ctx) and xs[0].dim() >= 2
                  else "xla")
    if n == 1:
        return [xs[0].clone() if wrap else torch.zeros_like(xs[0])]
    if method == "pallas" and xs[0].dim() < 2:
        raise ValueError("the pp_shift kernel needs >= 2-D input")
    if method == "xla" or not device_initiable(ctx):
        return pp_shift_plain(xs, wrap)
    return pp_shift_kernel(xs, ctx, wrap)


def pp_shift(xs: list[torch.Tensor], ctx, *, wrap: bool = False,
             method: str = "auto") -> list[torch.Tensor]:
    """Shift every rank's buffer one stage forward: rank i's output is
    rank i-1's ``xs``; rank 0's is zeros, or rank n-1's with ``wrap``.
    Takes and returns one tensor per rank (per global rank over a dp x tp
    context, shifted within each dp group)."""
    if method not in METHODS:
        raise ValueError(f"unknown pp_shift method {method!r}; {METHODS}")
    if len(xs) != ctx.world:
        raise ValueError(f"x: {len(xs)} tensors for dp x tp = {ctx.world}")
    out = []
    for d in range(ctx.dp):
        g = ctx.group(d)
        part = list(xs[d * ctx.tp:(d + 1) * ctx.tp])
        check_ranks("x", part, g)
        out += _shift_group(part, g, wrap, method)
    return out


def pp_send_recv(xs: list[torch.Tensor], src: int, dst: int, ctx
                 ) -> list[torch.Tensor]:
    """A single directed hop: rank ``dst`` receives rank ``src``'s buffer,
    every other rank zeros (the JAX ``ppermute`` with one pair)."""
    check_ranks("x", xs, ctx)
    n = ctx.tp
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"src={src}, dst={dst} out of range for {n} ranks")
    return [xs[src].clone() if r == dst else torch.zeros_like(xs[r])
            for r in range(n)]


def pp_recv_from_prev(xs: list[torch.Tensor], ctx, **kw
                      ) -> list[torch.Tensor]:
    """:func:`pp_shift` from the receiving stage's viewpoint."""
    return pp_shift(xs, ctx, **kw)
