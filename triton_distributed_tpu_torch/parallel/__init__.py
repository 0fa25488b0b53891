"""Parallelism transports beyond the collective ops (counterpart of
``triton_distributed_tpu.parallel``): the pipeline point-to-point shift."""

from triton_distributed_tpu_torch.parallel.p2p import (  # noqa: F401
    pp_recv_from_prev,
    pp_send_recv,
    pp_shift,
)
