"""Per-step tracing across the two parties (counterpart of
``split_learning_tpu/obs/trace.py``).

Each split step gets a trace ID, and every phase is a span:

- client party: ``client_fwd``, ``transport`` (the whole transport
  call, wire codec included), ``client_bwd``, ``opt_apply``,
  ``step_total``;
- server party: ``queue_wait`` (waiting for the runtime lock),
  ``dispatch`` (the lock-held window: handshake, forward, backward and
  update launched), ``d2h`` (the reply materialised off the lock: a
  host copy for a numpy caller, the loss read for every caller).

On the card a span measures device work only where it ends in a
synchronise; the client synchronises at its span edges while tracing is
on, which is the documented cost of tracing. Spans aggregate into the
party's :class:`~.metrics.Registry` histograms and export as Chrome
trace events (one JSON event per line, Perfetto-loadable).

Zero overhead when off: the global tracer defaults to ``None`` and every
call site is gated on ``get_tracer() is None``. The ``CTX`` thread-local
carries the trace id from the client trainer to the server (the same
thread under ``LocalTransport``) and the server's span times back.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs.metrics import Registry


class _Ctx(threading.local):
    """Per-thread propagation slots (None = nothing in flight)."""
    trace_id: Optional[str] = None
    server_spans: Optional[Dict[str, float]] = None


CTX = _Ctx()

# Chrome-trace process ids: one synthetic "process" per party
PARTY_PIDS = {"client": 1, "server": 2}

CLIENT_PHASES = spans.CLIENT_PHASES
SERVER_PHASES = spans.SERVER_PHASES


class Tracer:
    """Collects spans; aggregates them into a Registry; exports Chrome
    trace events. Thread-safe."""

    def __init__(self, registry: Optional[Registry] = None,
                 max_spans: int = 200_000) -> None:
        self.registry = registry if registry is not None else Registry()
        # bounded: oldest spans fall off, histograms keep the full tally
        self._spans: deque = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._t0 = time.perf_counter()

    def new_trace_id(self, client_id: int = 0, step: int = -1) -> str:
        return f"c{client_id}-s{step}-{next(self._seq):06x}"

    def record(self, name: str, t_start: float, duration: float, *,
               trace_id: Optional[str] = None, party: str = "client",
               tid: int = 0, step: int = -1) -> None:
        """One span: ``t_start`` a ``time.perf_counter()`` reading,
        ``duration`` in seconds."""
        with self._lock:
            self._spans.append((name, party, int(tid), int(step),
                                trace_id, float(t_start), float(duration)))
        self.registry.observe(name, duration)

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            raw = list(self._spans)
        return [{"name": n, "party": p, "tid": t, "step": s,
                 "trace_id": tr, "t_start": t0, "duration": d}
                for n, p, t, s, tr, t0, d in raw]

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase count, total, mean, p50 and p90."""
        by_name: Dict[str, list] = {}
        for sp in self.spans():
            by_name.setdefault(sp["name"], []).append(sp["duration"])
        out = {}
        for name, xs in by_name.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
            }
        return out

    def fraction(self, name: str) -> float:
        """Share of ``name`` in the client-level phase total (0.0 when
        nothing was recorded)."""
        totals: Dict[str, float] = {}
        for sp in self.spans():
            totals[sp["name"]] = totals.get(sp["name"], 0.0) + sp["duration"]
        denom = sum(totals.get(p, 0.0) for p in CLIENT_PHASES)
        return totals.get(name, 0.0) / denom if denom > 0 else 0.0

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome trace events (``ph: "X"``, microseconds from tracer
        start, one pid per party)."""
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"slt-{party}"}}
            for party, pid in sorted(PARTY_PIDS.items())
        ]
        for sp in self.spans():
            events.append({
                "name": sp["name"], "cat": sp["party"], "ph": "X",
                "ts": max(sp["t_start"] - self._t0, 0.0) * 1e6,
                "dur": sp["duration"] * 1e6,
                "pid": PARTY_PIDS.get(sp["party"], 0), "tid": sp["tid"],
                "args": {"trace_id": sp["trace_id"], "step": sp["step"]},
            })
        return events

    def export_chrome(self, path: str) -> str:
        """Write the Chrome-trace JSON array, one event per line."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        events = self.chrome_events()
        with open(path, "w") as f:
            f.write("[\n")
            for i, ev in enumerate(events):
                tail = "," if i < len(events) - 1 else ""
                f.write(json.dumps(ev) + tail + "\n")
            f.write("]\n")
        return path


# the global switch: None means OFF and is the default
_tracer: Optional[Tracer] = None
_switch_lock = threading.Lock()


def enable(registry: Optional[Registry] = None,
           max_spans: int = 200_000) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _tracer
    with _switch_lock:
        _tracer = Tracer(registry=registry, max_spans=max_spans)
        return _tracer


def disable() -> Optional[Tracer]:
    """Turn tracing off; returns the tracer that was active."""
    global _tracer
    with _switch_lock:
        t, _tracer = _tracer, None
        return t


def get_tracer() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None
