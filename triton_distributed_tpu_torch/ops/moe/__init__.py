"""MoE ops of the PyTorch port: routing (top-k gate, expert sort, weighted
combine) and the grouped expert FFN (counterpart of
``triton_distributed_tpu.ops.moe``; the EP exchange, the ring MoE and the
native block-aligned sort wait for the multi-GPU slice, ROADMAP queue 1
item 11)."""

from triton_distributed_tpu_torch.ops.moe.grouped_gemm import (  # noqa: F401
    grouped_ffn,
    grouped_gemm,
)
from triton_distributed_tpu_torch.ops.moe.routing import (  # noqa: F401
    RouterOut,
    SortedTokens,
    moe_combine,
    moe_sort,
    router_topk,
)
