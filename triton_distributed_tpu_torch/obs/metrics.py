"""Metrics registry: counters, gauges, log-bucketed histograms.

Host-only copy of the parts of ``triton_distributed_tpu/obs/metrics.py``
the ported engines and prefix cache call (the Prometheus exposition and
the fleet merge come with the server slice, ROADMAP queue 1 item 6).
The token path never reads a metric.
"""

from __future__ import annotations

import bisect
import math
import threading


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Geometric bucket edges from ``lo`` to (at least) ``hi``."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    edges = []
    k = math.ceil(math.log10(lo) * per_decade)
    while True:
        e = 10.0 ** (k / per_decade)
        edges.append(e)
        if e >= hi:
            return tuple(edges)
        k += 1


LATENCY_BUCKETS = log_buckets(1e-4, 100.0, per_decade=4)


class _Metric:
    """A named, labeled family of series keyed by label values."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str,
                 label_names: tuple):
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names = label_names
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, declared "
                f"{sorted(self.label_names)}"
            )
        return tuple(labels[k] for k in self.label_names)


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        reg = self._registry
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._key(labels)
        with reg._lock:
            self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        reg = self._registry
        key = self._key(labels)
        with reg._lock:
            self._series[key] = v


class Histogram(_Metric):
    """Fixed-edge histogram: a series is ``[counts, sum]``, ``counts[-1]``
    the +Inf overflow."""

    kind = "histogram"

    def __init__(self, registry, name, help, label_names,
                 buckets: tuple = LATENCY_BUCKETS):
        super().__init__(registry, name, help, label_names)
        self.edges = tuple(float(e) for e in buckets)

    def observe(self, v: float, **labels) -> None:
        self.observe_n(v, 1, **labels)

    def observe_n(self, v: float, n: int, total: float | None = None,
                  **labels) -> None:
        """``n`` observations in ``v``'s bucket in one update: ``n``
        copies of ``v``, or ``n`` values summing to ``total``."""
        reg = self._registry
        key = self._key(labels)
        i = bisect.bisect_left(self.edges, v)
        with reg._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [
                    [0] * (len(self.edges) + 1), 0.0
                ]
            series[0][i] += n
            series[1] += v * n if total is None else total


class Registry:
    """Thread-safe named-metric registry; re-registering a name with the
    same kind and labels returns the existing family."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw):
        label_names = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != label_names:
                    raise ValueError(
                        f"metric {name} redeclared as {cls.kind}"
                        f"{sorted(label_names)} but exists as {m.kind}"
                        f"{sorted(m.label_names)}"
                    )
                return m
            m = cls(self, name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: tuple = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)


_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def counter(name: str, help: str = "", labels=()) -> Counter:
    return _DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()) -> Gauge:
    return _DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=(),
              buckets: tuple = LATENCY_BUCKETS) -> Histogram:
    return _DEFAULT.histogram(name, help, labels, buckets)
