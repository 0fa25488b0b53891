"""Host-to-device work ring for resident megakernel decode.

Counterpart of ``triton_distributed_tpu/megakernel/ring.py``, a
host-only copy (numpy). The resident engine pushes admit, retire and
cancel items into the ring, rings the doorbell once per round, and the
round's launch observes the published ``[doorbell, head, tail,
occupancy]`` snapshot: its RING_POLL task stamps the doorbell into its
trace record, which is how ``obs.kernel_trace.validate_ring`` proves
that no round ran against a stale ring. The launch is emulated at round
granularity: each round is one launch, and the ring is consumed by the
host at the round boundary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Work-item kinds (0 is reserved as "empty slot", so a zeroed ring is
# all-empty).
RING_ADMIT = 1    # arg = prompt length admitted into the slot
RING_RETIRE = 2   # arg = generated-token count at retire
RING_CANCEL = 3   # arg = 0

# Item layout: [kind, slot, arg, seq] int32.
ITEM_INTS = 4

_KIND_NAMES = {RING_ADMIT: "admit", RING_RETIRE: "retire",
               RING_CANCEL: "cancel"}


def kind_name(kind: int) -> str:
    return _KIND_NAMES.get(int(kind), f"kind{int(kind)}")


@dataclasses.dataclass
class RingItem:
    kind: int
    slot: int
    arg: int
    seq: int

    @property
    def kind_str(self) -> str:
        return kind_name(self.kind)


class WorkRing:
    """Bounded host-to-device work queue with a monotonic doorbell.

    ``push`` appends an item at ``tail``; ``publish`` bumps the doorbell,
    snapshots ``tail`` and returns the ``[doorbell, head, tail,
    occupancy]`` int32 snapshot a round's launch observes; ``consume``
    retires exactly what the published round covered (items pushed after
    the publish wait for the next doorbell); ``flush`` drains everything
    host-side without moving the doorbell, for rounds that take the
    single-step fallback and so never reach a device loop. Pushing into
    a full ring raises: a lost admit or retire item would desynchronize
    the device loop from the engine's slot state.
    """

    def __init__(self, capacity: int = 64):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self.buf = np.zeros((self.capacity, ITEM_INTS), np.int32)
        self.head = 0       # consumer position (monotonic)
        self.tail = 0       # producer position (monotonic)
        self.doorbell = 0   # rounds published
        self._seq = 0       # items ever pushed
        self._published_tail = 0  # tail at the last publish
        self.peak_occupancy = 0

    @property
    def occupancy(self) -> int:
        return self.tail - self.head

    def push(self, kind: int, slot: int, arg: int = 0) -> RingItem:
        if self.occupancy >= self.capacity:
            raise RuntimeError(
                f"work ring full ({self.capacity} items): the host "
                "out-ran the device by a whole ring; raise the ring "
                "capacity or drain more often"
            )
        item = RingItem(int(kind), int(slot), int(arg), self._seq)
        self.buf[self.tail % self.capacity] = (
            item.kind, item.slot, item.arg, item.seq
        )
        self.tail += 1
        self._seq += 1
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy)
        return item

    def publish(self) -> np.ndarray:
        """Ring the doorbell for one round; returns the ``[doorbell, head,
        tail, occupancy]`` int32 snapshot the round's launch observes.
        The ``tail`` snapshot bounds the next ``consume``."""
        self.doorbell += 1
        self._published_tail = self.tail
        return np.asarray(
            [self.doorbell, self.head, self.tail, self.occupancy],
            np.int32,
        )

    def _drain(self, upto: int) -> list[RingItem]:
        items = []
        while self.head < upto:
            row = self.buf[self.head % self.capacity]
            items.append(RingItem(*(int(v) for v in row)))
            self.head += 1
        return items

    def consume(self) -> list[RingItem]:
        """Round-boundary drain: every item pushed before the last publish
        is now the device loop's. Returns them, oldest first."""
        return self._drain(self._published_tail)

    def flush(self) -> list[RingItem]:
        """Host-side drain of everything queued, published or not; the
        doorbell does not move. Returns the drained items."""
        self._published_tail = self.tail
        return self._drain(self.tail)
