"""Runtime helpers of the PyTorch port (one device, no mesh)."""

from triton_distributed_tpu_torch.runtime.context import (  # noqa: F401
    DeviceContext,
    resolve_device,
)
