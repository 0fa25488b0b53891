"""Tensor-parallel ranks co-located on one device, and their symmetric
buffers.

Counterpart of ``triton_distributed_tpu/runtime/mesh.py``:
:class:`DistContext` and :func:`initialize_distributed` (``tp=n``). The
JAX package runs every model as one ``shard_map`` program over a mesh of
devices. The port runs ``tp`` ranks inside one process on one card: each
rank holds its own weight shards and its own copies of the activations
the JAX program keeps replicated, per-rank work runs in a plain loop over
ranks (the body of the ``shard_map``), and the cross-rank kernels move
data between the ranks' buffers through pointer tables and flags, as
they would between cards.

Symmetric memory: the JAX package needs none (an identically shaped
per-device shard is addressed by mesh index, ``mesh.py:20-25``). The
CUDA kernels address a peer's buffer by pointer, so the context keeps a
symmetric allocator, the counterpart of the reference's NVSHMEM
symmetric tensors: :meth:`DistContext.symm_empty` returns one
``[n, *shape]`` allocation (each rank's slot contiguous) and a
device-resident int64 table of the n slot pointers. A kernel takes the
table and a rank, never a base plus a stride, so ranks on separate cards
change only where the table comes from (CUDA IPC, torch symmetric
memory).

A ``dp`` axis (``DistContext(dp=...)``, ``initialize_distributed(dp=,
tp=)``) lays ``dp * tp`` co-located ranks out dp-major, rank ``d * tp +
t``, as the JAX mesh's ``me = outer * n_in + inner``. ``tp`` stays the
inner axis the cross-rank kernels run over: :meth:`DistContext.group`
is dp group d's own ``tp``-rank context (its own symmetric workspaces
and flags), so an inner-axis kernel takes one group's pointer tables.
``dp=1`` (the default) is the context every earlier entry point took.
:meth:`DistContext.flat` is the whole world as one ``tp``-rank context,
for a kernel that runs over both axes at once.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Never falls back: asking for (or defaulting to) CUDA
    on a machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU (its kernels then use their plain "
                "PyTorch versions)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class SymmBuffer:
    """One symmetric allocation: ``data [n, *shape]`` (rank r's slot is
    ``data[r]``, contiguous) and ``table [n]`` int64, the slot pointers on
    the device."""

    data: torch.Tensor
    table: torch.Tensor


class DistContext:
    """``dp * tp`` ranks on one device, in one dtype (dp-major).

    ``tp == 1`` is the one-device context every tp=1 entry point took
    before (``DeviceContext`` is this class)."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 tp: int = 1, dp: int = 1):
        if int(tp) < 1 or int(dp) < 1:
            raise ValueError(f"tp and dp must be >= 1, got tp={tp}, dp={dp}")
        self.device = device
        self.dtype = dtype
        self.tp = int(tp)
        self.dp = int(dp)
        self._workspaces: dict = {}
        self._flag_sites: dict = {}  # language.primitives.site_flags
        self._groups: dict = {}
        self._flat: DistContext | None = None

    @classmethod
    def create(cls, device=None, dtype: torch.dtype = torch.bfloat16,
               tp: int = 1, dp: int = 1) -> "DistContext":
        return cls(resolve_device(device), dtype, tp, dp)

    def __repr__(self) -> str:
        dp = f"dp={self.dp}, " if self.dp > 1 else ""
        return (f"DistContext({dp}tp={self.tp}, device={self.device}, "
                f"dtype={self.dtype})")

    @property
    def world(self) -> int:
        """Ranks of the context: ``dp * tp``."""
        return self.dp * self.tp

    def group(self, d: int) -> "DistContext":
        """dp group ``d``'s ``tp`` ranks (global ranks ``d * tp .. d * tp
        + tp - 1``) as a context of their own; the same object on every
        call. At ``dp == 1`` group 0 is the context itself."""
        if not 0 <= int(d) < self.dp:
            raise ValueError(f"dp group {d} outside dp={self.dp}")
        if self.dp == 1:
            return self
        g = self._groups.get(int(d))
        if g is None:
            g = self._groups[int(d)] = DistContext(self.device, self.dtype,
                                                   self.tp)
        return g

    def flat(self) -> "DistContext":
        """All ``dp * tp`` ranks as one context of ``tp = world`` ranks in
        global rank order, with its own symmetric workspaces and flags:
        what a kernel over every rank of the context launches over (the
        2-D torus all-gather). The same object on every call; at ``dp ==
        1`` the context itself."""
        if self.dp == 1:
            return self
        if self._flat is None:
            self._flat = DistContext(self.device, self.dtype, self.world)
        return self._flat

    def shard(self, t: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """``tp`` contiguous shards of ``t`` along ``dim`` (rank r's is
        the r-th of equal parts), on the context's device."""
        if t.shape[dim] % self.tp:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} not divisible by "
                f"tp={self.tp}")
        t = t.to(self.device)
        return [p.contiguous() for p in torch.chunk(t, self.tp, dim=dim)]

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """One copy of ``t`` per rank (rank 0 keeps ``t`` itself)."""
        t = t.to(self.device)
        return [t] + [t.clone() for _ in range(self.tp - 1)]

    def symm_empty(self, shape, dtype: torch.dtype,
                   zero: bool = False) -> SymmBuffer:
        """A fresh symmetric allocation of ``shape`` per rank."""
        alloc = torch.zeros if zero else torch.empty
        data = alloc((self.tp, *shape), dtype=dtype, device=self.device)
        ptrs = [data[r].data_ptr() for r in range(self.tp)]
        table = torch.tensor(ptrs, dtype=torch.int64).to(self.device)
        return SymmBuffer(data, table)

    def workspace(self, site: str, shape, dtype: torch.dtype) -> SymmBuffer:
        """The symmetric workspace of a kernel site, ``shape`` per rank:
        one grow-only buffer per (site, dtype), reallocated only when a
        call needs more than it holds, so a server that sees many shapes
        keeps one buffer a site (as :func:`~triton_distributed_tpu_torch.
        language.primitives.site_flags` does). Each call gets a view of
        the size it needs at the start of every slot; the launches of a
        site are ordered on the stream, so reuse needs no wait."""
        need = 1
        for s_ in shape:
            need *= int(s_)
        key = (site, dtype)
        buf = self._workspaces.get(key)
        if buf is None or buf.data.shape[1] < need:
            buf = self._workspaces[key] = self.symm_empty((need,), dtype)
        return SymmBuffer(buf.data[:, :need].view(self.tp, *shape), buf.table)


# The tp=1 context the earlier slices took.
DeviceContext = DistContext


def initialize_distributed(tp: int = 1, *, dp: int = 1, device=None,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> DistContext:
    """A context of ``dp * tp`` ranks on one device (``cuda`` unless
    ``device`` says otherwise): the counterpart of the JAX
    ``initialize_distributed(dp=, tp=)``."""
    return DistContext.create(device, dtype, tp, dp)
