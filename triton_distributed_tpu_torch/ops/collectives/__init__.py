"""Collectives over co-located ranks (counterpart of
``triton_distributed_tpu.ops.collectives``): the all-gathers (full mesh,
ring, bidirectional ring), the reduce-scatters (one-shot, ring,
bidirectional ring, HBM ring), the all-reduces (one-shot, doubling,
two-shot) and the dense all-to-all. The rest wait for ROADMAP queue 1
position 3."""

from triton_distributed_tpu_torch.ops.collectives.all_gather import (  # noqa: F401
    AllGatherMethod,
    all_gather,
    all_gather_bidir_ring,
    all_gather_full_mesh,
    all_gather_plain,
    all_gather_ring,
)
from triton_distributed_tpu_torch.ops.collectives.all_to_all import (  # noqa: F401
    all_to_all,
    all_to_all_kernel,
    all_to_all_op,
    all_to_all_plain,
)
from triton_distributed_tpu_torch.ops.collectives.all_reduce import (  # noqa: F401
    AllReduceMethod,
    all_reduce,
    all_reduce_doubling_plain,
    all_reduce_kernel,
    all_reduce_plain,
    get_auto_allreduce_method,
)
from triton_distributed_tpu_torch.ops.collectives.reduce_scatter import (  # noqa: F401
    ReduceScatterMethod,
    reduce_scatter,
    reduce_scatter_kernel,
    reduce_scatter_one_shot_plain,
    reduce_scatter_ring_plain,
)
