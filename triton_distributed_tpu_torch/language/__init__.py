"""Host side of the port's device communication language (the device
side is ``csrc/tdt_comm.cuh``)."""

from triton_distributed_tpu_torch.language.primitives import (  # noqa: F401
    FlagSite,
    next_epoch,
    num_ranks,
    rank,
    site_flags,
)
