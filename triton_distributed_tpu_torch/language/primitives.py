"""Host side of the cross-rank primitives.

Counterpart of ``triton_distributed_tpu/language/primitives.py``. The
device side (``put``, ``signal``, ``wait_until`` :186, ``put_signal``
:257, ``barrier_all`` :342) is CUDA: ``csrc/tdt_comm.cuh``. What stays in
Python is who a rank is and the signal bookkeeping:

- :func:`rank` / :func:`num_ranks`: a rank is an index of the
  :class:`~triton_distributed_tpu_torch.runtime.mesh.DistContext`'s
  co-located ranks (the JAX ``axis_index`` / ``axis_size``).
- :class:`FlagSite`: one collective site's flags, the counterpart of
  ``ops/common.py:24-28`` ``next_collective_id``. Each site holds a
  symmetric uint64 flag buffer (zeroed once) and an epoch that goes up by
  one per launch (:func:`next_epoch`); a device wait spins until
  ``flag >= epoch``, so the flags are never reset between launches.
"""

from __future__ import annotations

import dataclasses

import torch


def rank(ctx, r: int) -> int:
    """Rank ``r`` of ``ctx``, checked."""
    if not 0 <= int(r) < ctx.tp:
        raise ValueError(f"rank {r} outside tp={ctx.tp}")
    return int(r)


def num_ranks(ctx) -> int:
    return ctx.tp


@dataclasses.dataclass
class FlagSite:
    """A collective site's symmetric flag buffer and launch epoch."""

    flags: object      # SymmBuffer of int64 (read as uint64 on the device)
    capacity: int      # flags per rank
    epoch: int = 0


def site_flags(ctx, site: str, count: int) -> FlagSite:
    """The flags of ``site`` on ``ctx``, at least ``count`` per rank. A
    site that needs more than it holds gets a new zeroed buffer (twice the
    count) and its epoch starts again at 0; the old buffer's last launch
    is ordered before the next one on the stream."""
    sites = ctx._flag_sites
    fs = sites.get(site)
    if fs is None or fs.capacity < count:
        cap = max(2 * int(count), 64)
        fs = sites[site] = FlagSite(
            ctx.symm_empty((cap,), torch.int64, zero=True), cap)
    return fs


def next_epoch(fs: FlagSite) -> int:
    """The epoch of the next launch at this site."""
    fs.epoch += 1
    return fs.epoch
