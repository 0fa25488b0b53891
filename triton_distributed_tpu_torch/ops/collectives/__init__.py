"""Collectives over co-located ranks (counterpart of
``triton_distributed_tpu.ops.collectives``; the full-mesh all-gather is
ported, the rest wait for ROADMAP queue 2 row 10)."""

from triton_distributed_tpu_torch.ops.collectives.all_gather import (  # noqa: F401
    AllGatherMethod,
    all_gather,
    all_gather_full_mesh,
    all_gather_plain,
)
