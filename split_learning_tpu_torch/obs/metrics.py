"""Fixed-bucket latency histograms and their Prometheus text exposition
(counterpart of ``split_learning_tpu/obs/metrics.py``).

Spans land in per-phase :class:`Histogram`\\ s inside a
:class:`Registry`, one registry per party; ``ServerRuntime.metrics()``
returns its snapshot, and :func:`render_prometheus` turns a snapshot
into the text ``GET /metrics`` serves, byte for byte JAX's;
:func:`histogram_percentile` and :func:`histogram_delta` read windows
of them (the telemetry ring's percentiles). Buckets
are fixed at construction (cumulative counts stay monotone across
scrapes), spanning 100 us to 10 s.
Stdlib-only; nothing here runs on the step path unless tracing is on.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, Optional

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


def histogram_percentile(hist_snapshot: Dict[str, Any], q: float) -> float:
    """The q-th percentile (0..100) of a :meth:`Histogram.snapshot`, by
    linear interpolation within the covering bucket (Prometheus's
    ``histogram_quantile``). 0.0 on an empty histogram; a percentile in
    the +Inf slot clamps to the last finite bound."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile must be in [0, 100] (got {q})")
    total = int(hist_snapshot.get("count", 0))
    buckets = tuple(hist_snapshot.get("buckets") or ())
    cumulative = list(hist_snapshot.get("cumulative") or ())
    # an empty window (obs/telemetry.py's bucket subtraction) reads 0.0,
    # never NaN
    if total <= 0 or not buckets or not cumulative:
        return 0.0
    rank = q / 100.0 * total
    prev_cum, prev_le = 0, 0.0
    for le, cum in zip(buckets, cumulative):
        if cum >= rank:
            if cum == prev_cum:
                return float(le)
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (float(le) - prev_le) * max(frac, 0.0)
        prev_cum, prev_le = cum, float(le)
    return float(buckets[-1])  # +Inf slot: clamp to the last finite bound


def histogram_delta(cur: Dict[str, Any],
                    prev: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The window between two cumulative snapshots, in the snapshot's
    shape (feed it to :func:`histogram_percentile`). A counter reset
    (``cur`` below ``prev`` in the count or any bucket: the party
    restarted) and a ``prev`` of None give ``cur`` itself, Prometheus's
    ``rate()`` convention."""
    cur_cum = list(cur.get("cumulative") or ())
    if prev is None:
        return {"buckets": tuple(cur.get("buckets") or ()),
                "cumulative": cur_cum,
                "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    prev_cum = list(prev.get("cumulative") or ())
    d_count = int(cur.get("count", 0)) - int(prev.get("count", 0))
    reset = (d_count < 0 or len(prev_cum) > len(cur_cum)
             or any(c < p for c, p in zip(cur_cum, prev_cum)))
    if reset:
        return histogram_delta(cur, None)
    prev_cum += [0] * (len(cur_cum) - len(prev_cum))
    return {"buckets": tuple(cur.get("buckets") or ()),
            "cumulative": [c - p for c, p in zip(cur_cum, prev_cum)],
            "sum": max(float(cur.get("sum", 0.0))
                       - float(prev.get("sum", 0.0)), 0.0),
            "count": d_count}

def _sanitize(name: str) -> str:
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _fmt(v: float) -> str:
    return f"{float(v):.9g}"


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash,
    double quote and newline (in that order: escaping the backslash
    first keeps the other two unambiguous)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    inner = ",".join(
        f'{_sanitize(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}" if inner else ""


def render_prometheus(snapshot: Dict[str, Any], prefix: str = "slt") -> str:
    """Snapshot (from :meth:`Registry.snapshot`) -> Prometheus text
    exposition (version 0.0.4). Histogram names gain a ``_seconds``
    unit suffix; phase fractions render as one gauge with a ``phase``
    label; ``labeled`` entries (``{"name", "labels", "value",
    "type"?}``) render one series each, with one TYPE header a name."""
    lines = []
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        metric = f"{prefix}_{_sanitize(name)}_seconds"
        lines.append(f"# HELP {metric} Latency of the {name} phase.")
        lines.append(f"# TYPE {metric} histogram")
        for le, cum in zip(h["buckets"], h["cumulative"]):
            lines.append(f'{metric}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{metric}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{metric}_sum {_fmt(h['sum'])}")
        lines.append(f"{metric}_count {h['count']}")
    fractions = snapshot.get("phase_fractions", {})
    if fractions:
        metric = f"{prefix}_phase_fraction"
        lines.append(f"# HELP {metric} Share of summed phase time.")
        lines.append(f"# TYPE {metric} gauge")
        for name, frac in sorted(fractions.items()):
            lines.append(
                f'{metric}{{phase="{_sanitize(name)}"}} {_fmt(frac)}')
    typed_seen = set()
    for name, v in sorted(snapshot.get("counters", {}).items()):
        metric = f"{prefix}_{_sanitize(name)}"
        typed_seen.add(metric)
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(v)}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        metric = f"{prefix}_{_sanitize(name)}"
        typed_seen.add(metric)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(v)}")
    labeled = snapshot.get("labeled") or []
    for entry in sorted(labeled,
                        key=lambda e: (e["name"],
                                       sorted(e.get("labels", {}).items()))):
        metric = f"{prefix}_{_sanitize(entry['name'])}"
        if metric not in typed_seen:
            typed_seen.add(metric)
            lines.append(
                f"# TYPE {metric} {entry.get('type', 'counter')}")
        lines.append(
            f"{metric}{_fmt_labels(entry.get('labels', {}))} "
            f"{_fmt(entry['value'])}")
    return "\n".join(lines) + "\n"
