"""The device context of an entry point (see :mod:`.mesh`).

``DeviceContext`` is :class:`~.mesh.DistContext`; at ``tp=1`` it holds
only what the code around the kernels needs, the device the tensors live
on and the model dtype. Kept as a module so earlier imports still read
alike.
"""

from triton_distributed_tpu_torch.runtime.mesh import (  # noqa: F401
    DeviceContext,
    DistContext,
    resolve_device,
)
