"""GEMM + collective ops over co-located ranks (counterpart of
``triton_distributed_tpu.ops.overlap``)."""

from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (  # noqa: F401
    AGGemmConfig,
    adaptive_pick_plain,
    ag_gemm,
    ag_gemm_plain,
)
from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (  # noqa: F401
    GemmARConfig,
    GemmARMethod,
    create_gemm_ar_context,
    gemm_ar,
    gemm_ar_op,
    gemm_ar_plain,
    gemm_ar_ring_plain,
)
from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (  # noqa: F401
    GemmRSConfig,
    create_gemm_rs_context,
    gemm_rs,
    gemm_rs_op,
    gemm_rs_plain,
)
