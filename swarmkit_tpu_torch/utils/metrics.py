"""Hot-path latency histograms (the reference's prometheus timers:
store tx / lock-hold — memory.go:99-112).

A tiny fixed-bucket histogram with a process-global registry. Observation
is a few list ops under a lock — cheap enough for every store transaction.

The port's copy of the part of the JAX package's `utils/metrics.py` that
the store uses: the histogram and its registry, without the counters, the
labelled families, the Prometheus text and the telemetry codec.
"""
from __future__ import annotations

import bisect
from ..analysis.lockgraph import make_lock

# prometheus-style default buckets, seconds
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._n = 0
        self._lock = make_lock('utils.metrics.histogram')

    def observe(self, seconds: float):
        i = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            self._counts[i] += 1
            self._sum += seconds
            self._n += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._n


_registry: dict[str, Histogram] = {}
_registry_lock = make_lock('utils.metrics.registry_lock')


def histogram(name: str, help_: str = "") -> Histogram:
    with _registry_lock:
        h = _registry.get(name)
        if h is None:
            h = Histogram(name, help_)
            _registry[name] = h
        return h
