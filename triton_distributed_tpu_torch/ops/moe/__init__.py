"""MoE ops of the PyTorch port: routing (top-k gate, expert sort, weighted
combine), the grouped expert FFN, the expert-parallel dispatch/combine
over the EP exchange and the ring MoE (counterpart of
``triton_distributed_tpu.ops.moe``)."""

from triton_distributed_tpu_torch.ops.moe.ep_a2a import (  # noqa: F401
    DispatchState,
    ep_combine,
    ep_dispatch,
    ep_moe_ffn,
)
from triton_distributed_tpu_torch.ops.moe.ep_exchange import (  # noqa: F401
    ep_exchange,
    pack_rows,
    unpack_row,
)
from triton_distributed_tpu_torch.ops.moe.grouped_gemm import (  # noqa: F401
    grouped_ffn,
    grouped_gemm,
)
from triton_distributed_tpu_torch.ops.moe.routing import (  # noqa: F401
    AlignedBlocks,
    RouterOut,
    SortedTokens,
    align_capacities,
    moe_align_block_size,
    moe_combine,
    moe_sort,
    router_topk,
)
from triton_distributed_tpu_torch.ops.moe.ring_moe import moe_ffn_ring  # noqa: F401,E501
