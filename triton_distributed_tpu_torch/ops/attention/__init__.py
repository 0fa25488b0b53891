"""Attention ops (counterpart of ``triton_distributed_tpu.ops.attention``)."""

from triton_distributed_tpu_torch.ops.attention.flash_attention import (  # noqa: F401
    flash_attention,
    mha_reference,
)
from triton_distributed_tpu_torch.ops.attention.flash_decode import (  # noqa: F401
    distributed_flash_decode,
    distributed_flash_decode_2level,
    flash_decode,
    gqa_decode_reference,
    lse_combine,
    paged_flash_decode,
    pages_to_dense,
)
from triton_distributed_tpu_torch.ops.attention.rope import (  # noqa: F401
    apply_rope,
    rope_freqs,
)
from triton_distributed_tpu_torch.ops.attention.ring_attention import (  # noqa: F401
    ring_attention,
)
from triton_distributed_tpu_torch.ops.attention.sp_ag_attention import (  # noqa: F401
    sp_ag_attention,
    sp_ag_attention_2level,
)
