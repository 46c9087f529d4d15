"""Fixed-bucket latency histograms (counterpart of
``split_learning_tpu/obs/metrics.py``, less the Prometheus text
exposition, which waits for the HTTP transport).

Spans land in per-phase :class:`Histogram`\\ s inside a
:class:`Registry`, one registry per party; ``ServerRuntime.metrics()``
returns its snapshot. Buckets are fixed at construction (cumulative
counts stay monotone across scrapes), spanning 100 us to 10 s.
Stdlib-only; nothing here runs on the step path unless tracing is on.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable

# upper bounds (``le``) in seconds; +Inf is implicit
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """Cumulative fixed-bucket histogram (Prometheus semantics)."""

    __slots__ = ("buckets", "_counts", "sum", "count", "_lock")

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(float(b) for b in buckets)
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"buckets must be non-empty and strictly increasing "
                f"(got {self.buckets})")
        self._counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        # first bucket whose upper bound is >= v; past-the-end = +Inf slot
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self.sum += v
            self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative per-``le`` counts, plus sum and count."""
        with self._lock:
            raw = list(self._counts)
            total, s = self.count, self.sum
        cumulative = []
        acc = 0
        for c in raw:
            acc += c
            cumulative.append(acc)
        return {"buckets": self.buckets, "cumulative": cumulative,
                "sum": s, "count": total}


class Registry:
    """Named histograms / counters / gauges for one party."""

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self._buckets = tuple(buckets)
        self._hist: Dict[str, Histogram] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = Histogram(self._buckets)
            return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def incr(self, name: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict snapshot, with the per-phase share of the summed
        histogram time."""
        with self._lock:
            hists = dict(self._hist)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        snap_h = {name: h.snapshot() for name, h in sorted(hists.items())}
        total = sum(h["sum"] for h in snap_h.values())
        fractions = {name: (h["sum"] / total if total > 0 else 0.0)
                     for name, h in snap_h.items()}
        return {"histograms": snap_h, "counters": counters,
                "gauges": gauges, "phase_fractions": fractions}
