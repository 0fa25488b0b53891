"""Bounded structured-event ring with sequence numbers.

Host-only copy of ``triton_distributed_tpu/obs/events.py`` (the parts the
ported engines and prefix cache call): admissions, evictions, COW
clones, sheds, deadline expiries and NaN guards land here with a
gap-free ``seq``, so a consumer tailing the ring detects drops exactly.
"""

from __future__ import annotations

import threading
import time


class Event:
    __slots__ = ("seq", "t", "kind", "fields")

    def __init__(self, seq: int, t: float, kind: str, fields: dict):
        self.seq = seq
        self.t = t
        self.kind = kind
        self.fields = fields


class EventRing:
    """Fixed-capacity ring of :class:`Event`\\ s."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: list[Event | None] = [None] * capacity
        self._next_seq = 1
        self._floor = 0  # events with seq <= floor were cleared
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields) -> int:
        """Record one event; returns its seq."""
        t = time.monotonic()
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._buf[seq % self.capacity] = Event(seq, t, kind, fields)
        return seq

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def tail(self, since: int = 0) -> tuple[list[Event], int]:
        """Events with ``seq > since``, oldest first, plus how many such
        events were overwritten before this call saw them."""
        since = max(since, 0)
        with self._lock:
            newest = self._next_seq - 1
            oldest = max(self._floor + 1, self._next_seq - self.capacity)
            start = max(since + 1, oldest)
            events = [self._buf[s % self.capacity]
                      for s in range(start, newest + 1)]
        dropped = (events[0].seq - since - 1) if events else max(
            0, newest - since)
        return events, dropped

    def clear(self) -> None:
        """Drop buffered events; seq numbering keeps increasing."""
        with self._lock:
            self._buf = [None] * self.capacity
            self._floor = self._next_seq - 1


_DEFAULT = EventRing()


def default_ring() -> EventRing:
    return _DEFAULT


def emit(kind: str, **fields) -> int:
    return _DEFAULT.emit(kind, **fields)
