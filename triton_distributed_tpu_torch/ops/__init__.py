"""Operators of the PyTorch port: attention ops, collectives, MoE ops and
their CUDA kernels."""

from triton_distributed_tpu_torch.ops.collectives.all_to_all import (  # noqa: F401
    all_to_all,
    all_to_all_op,
)
