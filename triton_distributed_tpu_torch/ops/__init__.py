"""Operators of the PyTorch port: attention ops, collectives, MoE ops and
their CUDA kernels."""

from triton_distributed_tpu_torch.ops.collectives import (  # noqa: F401
    AllGatherMethod,
    AllReduceMethod,
    BroadcastMethod,
    ReduceScatterMethod,
    all_gather,
    all_gather_2d,
    all_gather_2d_op,
    all_gather_op,
    all_gather_torus_2d,
    all_reduce,
    all_reduce_2level,
    all_reduce_2level_op,
    all_to_all,
    all_to_all_op,
    broadcast,
    broadcast_op,
    ll_all_gather,
    ll_all_gather_op,
    ll_all_gather_workspace,
    reduce_scatter,
    reduce_scatter_2d,
)
