"""Collectives over co-located ranks (counterpart of
``triton_distributed_tpu.ops.collectives``): the all-gathers (full mesh,
ring, bidirectional ring, pull, 2-D torus), the reduce-scatters (one-shot,
ring, bidirectional ring, HBM ring), the all-reduces (one-shot, doubling,
two-shot), the dense all-to-all, the one-shot broadcast, the low-latency
all-gather and the two-level compositions over a dp x tp context."""

from triton_distributed_tpu_torch.ops.collectives.all_gather import (  # noqa: F401
    AllGatherMethod,
    all_gather,
    all_gather_bidir_ring,
    all_gather_full_mesh,
    all_gather_op,
    all_gather_plain,
    all_gather_pull,
    all_gather_ring,
    all_gather_torus_2d,
    all_gather_torus_2d_kernel,
)
from triton_distributed_tpu_torch.ops.collectives.broadcast import (  # noqa: F401
    BroadcastMethod,
    broadcast,
    broadcast_kernel,
    broadcast_op,
    broadcast_plain,
)
from triton_distributed_tpu_torch.ops.collectives.hierarchical import (  # noqa: F401
    all_gather_2d,
    all_gather_2d_op,
    all_reduce_2level,
    all_reduce_2level_op,
    reduce_scatter_2d,
)
from triton_distributed_tpu_torch.ops.collectives.low_latency import (  # noqa: F401
    LLWorkspace,
    ll_all_gather,
    ll_all_gather_kernel,
    ll_all_gather_op,
    ll_all_gather_workspace,
    ll_expected_flags,
    ll_flags,
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
