"""GEMM + collective ops over co-located ranks (counterpart of
``triton_distributed_tpu.ops.overlap``)."""

from triton_distributed_tpu_torch.ops.overlap.ag_gemm import (  # noqa: F401
    AGGemmConfig,
    ag_gemm,
    ag_gemm_plain,
)
from triton_distributed_tpu_torch.ops.overlap.gemm_ar import (  # noqa: F401
    GemmARMethod,
    gemm_ar,
    gemm_ar_op,
    gemm_ar_plain,
)
from triton_distributed_tpu_torch.ops.overlap.gemm_rs import (  # noqa: F401
    GemmRSConfig,
    create_gemm_rs_context,
    gemm_rs,
    gemm_rs_plain,
)
