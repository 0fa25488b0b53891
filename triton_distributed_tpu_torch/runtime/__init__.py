"""Runtime helpers of the PyTorch port: the device context and its
co-located tensor-parallel ranks."""

from triton_distributed_tpu_torch.runtime.mesh import (  # noqa: F401
    DeviceContext,
    DistContext,
    SymmBuffer,
    initialize_distributed,
    resolve_device,
)
