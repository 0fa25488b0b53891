"""AllGather over co-located ranks.

Counterpart of ``triton_distributed_tpu/ops/collectives/all_gather.py``:
``AllGatherMethod`` and ``all_gather`` (:245), with ``XLA`` (the plain
version: a concatenation of the shards, the counterpart of XLA's own
``all_gather``) and ``PALLAS_FULL_MESH`` (the hand-written kernel of
``csrc/collectives.cu``, replacing ``_full_mesh_kernel`` :146).

Dispatch differs from the JAX AUTO in one place: for n > 2 and more than
64 KB JAX takes ``PALLAS_BIDIR_RING`` (:263-269); the port takes
``PALLAS_FULL_MESH`` at every size until the ring kernels are ported
(ROADMAP queue 2 row 10). It is the same gathered tensor from a ported
kernel. On the CPU AUTO takes ``XLA``, as the JAX AUTO does off the TPU.
"""

from __future__ import annotations

import enum

import torch

from triton_distributed_tpu_torch.language.primitives import (
    next_epoch,
    site_flags,
)
from triton_distributed_tpu_torch.ops import cuda_kernels as ck
from triton_distributed_tpu_torch.ops.common import (
    check_ranks,
    device_initiable,
    rank_ptrs,
)

_SITE = "all_gather"


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    PALLAS_RING = "pallas_ring"
    PALLAS_BIDIR_RING = "pallas_bidir_ring"
    PALLAS_FULL_MESH = "pallas_full_mesh"
    PALLAS_PULL = "pallas_pull"


_UNPORTED = (AllGatherMethod.PALLAS_RING, AllGatherMethod.PALLAS_BIDIR_RING,
             AllGatherMethod.PALLAS_PULL)


def all_gather_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's ``[n * m_per, ...]``: the shards in rank order."""
    full = torch.cat(xs, dim=0)
    return [full] + [full.clone() for _ in xs[1:]]


def all_gather_full_mesh(xs: list[torch.Tensor], ctx,
                         blocks_per_rank: int | None = None
                         ) -> list[torch.Tensor]:
    """The full-mesh kernel: one cooperative launch over all ranks.
    ``blocks_per_rank`` overrides the default grid (a grid that cannot be
    co-resident raises)."""
    n = ctx.tp
    x0 = xs[0]
    for r, t in enumerate(xs):
        ck.check_cuda_operand(f"x[{r}]", t, ctx.device, x0.dtype)
    out = torch.empty((n, n * x0.shape[0], *x0.shape[1:]), dtype=x0.dtype,
                      device=ctx.device)
    outs = [out[r] for r in range(n)]
    shard_bytes = x0.numel() * x0.element_size()
    if blocks_per_rank is None:
        cap = ck.coresident_blocks("collectives", "tdt_all_gather_capacity")
        want = max(1, -(-shard_bytes // (64 << 10)))  # ~64 KB a block
        blocks_per_rank = max(1, min(want, cap // n, 132))
    fs = site_flags(ctx, _SITE, n + n * blocks_per_rank)
    ck.ALL_GATHER(rank_ptrs(xs), rank_ptrs(outs), fs.flags.table.data_ptr(),
                  n, shard_bytes, next_epoch(fs), int(blocks_per_rank),
                  ck.stream_ptr(x0))
    return outs


def all_gather(xs: list[torch.Tensor], ctx,
               method: AllGatherMethod = AllGatherMethod.AUTO
               ) -> list[torch.Tensor]:
    """Gather the ranks' shards ``xs[r] [m_per, ...]`` along the leading
    dim: every rank gets ``[n * m_per, ...]``. Takes and returns one
    tensor per rank."""
    check_ranks("x", xs, ctx)
    if method in _UNPORTED:
        raise NotImplementedError(
            f"{method} is not ported yet (ROADMAP queue 2 row 10); the "
            "port gathers through PALLAS_FULL_MESH")
    if ctx.tp == 1:
        return list(xs)
    if method == AllGatherMethod.XLA or not device_initiable(ctx):
        return all_gather_plain(xs)
    return all_gather_full_mesh(xs, ctx)
