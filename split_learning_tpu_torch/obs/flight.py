"""Flight recorder: a bounded causal event journal for postmortems
(counterpart of ``split_learning_tpu/obs/flight.py``).

Each party keeps a bounded ring of structured causal events (admission
admit/reject, replay claim begin/resolve/fail/wait, coalesce group
form/pickup, deferred-apply enqueue/drain/flush, breaker transitions,
chaos injections, checkpoint capture/commit/lineage, dispatches,
replies, hops), each stamped with a monotonic per-process sequence
number, the step, the client_id and the trace ID, so
``scripts/postmortem.py`` merges client and server dumps (of this port
or of the JAX package: the dump schema is JAX's) into one per-step
causal timeline. Event names live in ``obs/spans.py`` (``FL_*``).

Zero overhead when off: the global recorder defaults to ``None`` and
every call site is gated on ``get_recorder() is None``, so with the
recorder off no event tuple is allocated and the wire bytes and losses
are the unrecorded run's.

The record path takes no lock: the ring is a ``deque(maxlen=...)``
(thread-safe append; the oldest falls off) and the sequence is
``itertools.count().__next__``, so call sites may record while holding
runtime locks, the lock watchdog's report path among them.

Dumps fire on four triggers: a lock-watchdog trip (``obs/locks.py``
calls :func:`trip`); SIGTERM or a fatal exception in ``launch/run.py``
(:func:`fatal`); ``GET /debug/flight`` on ``SplitHTTPServer``; the CLI's
``--flight PATH`` at exit. ``SLT_FLIGHT`` enables from the environment:
``1``/``true``/``on``/``yes`` turn the recorder on, any other non-empty
value is both "on" and the dump path; ``SLT_FLIGHT_CAPACITY`` sizes the
ring (default 65536 events). Stdlib-only.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace

DEFAULT_CAPACITY = 65_536

# values of SLT_FLIGHT that mean "on, no dump path"
_TRUTHY = ("1", "true", "on", "yes")


class FlightRecorder:
    """The bounded event ring of one process.

    ``party`` labels every dump (``"client"``, ``"server"``, ``"proc"``);
    a single-process run (``LocalTransport``) records both parties into
    one ring and tags each event with its own party instead."""

    def __init__(self, party: str = "proc",
                 capacity: int = DEFAULT_CAPACITY,
                 dump_path: Optional[str] = None) -> None:
        if capacity < 1:
            raise ValueError("flight ring capacity must be >= 1")
        self.party = party
        self.capacity = int(capacity)
        self.dump_path = dump_path
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        # dumps serialise on this; the record path never takes it
        self._dump_lock = threading.Lock()

    def record(self, name: str, *, step: int = -1, client_id: int = -1,
               trace_id: Optional[str] = None, party: Optional[str] = None,
               **fields: Any) -> None:
        """Journal one event. ``name`` is a ``spans.FL_*`` constant;
        ``trace_id`` defaults to the in-flight ``obs.trace.CTX.trace_id``,
        so events correlate across the wire without every call site
        threading it through. Extra keyword ``fields`` (JSON-safe) ride
        along into the dump."""
        if trace_id is None:
            trace_id = obs_trace.CTX.trace_id
        # the wall-clock stamp derives from one monotonic base, so the
        # merge order is immune to clock steps within a run
        t = self._t0_wall + (time.monotonic() - self._t0_mono)
        self._events.append((next(self._seq), t, name,
                             party if party is not None else self.party,
                             int(step), int(client_id), trace_id,
                             fields or None))

    def events(self) -> List[Dict[str, Any]]:
        """The ring as dicts, oldest first (a snapshot, safe against
        concurrent appends)."""
        return [{"seq": q, "t": t, "name": n, "party": p, "step": s,
                 "client_id": c, "trace_id": tr, "fields": f}
                for q, t, n, p, s, c, tr, f in list(self._events)]

    def dump(self, reason: str = "manual") -> Dict[str, Any]:
        """The dump ``scripts/postmortem.py`` reads (JAX's schema)."""
        events = self.events()
        # seq is dense from 0: the newest event says how many were ever
        # recorded, without consuming the counter
        dropped = (events[-1]["seq"] + 1 - len(events)) if events else 0
        return {
            "version": 1,
            "kind": "slt-flight-dump",
            "party": self.party,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "captured_at": time.time(),
            "reason": reason,
            "capacity": self.capacity,
            "dropped": dropped,
            "events": events,
        }

    def dump_json(self, path: str, reason: str = "manual") -> str:
        """Write the dump crash-atomically (tmp, fsync, rename: a reader
        never sees a torn dump). Returns ``path``."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with self._dump_lock:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.dump(reason=reason), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return path


# the global switch: None means OFF and is the default
_recorder: Optional[FlightRecorder] = None
_switch_lock = threading.Lock()


def enable(party: str = "proc", capacity: Optional[int] = None,
           dump_path: Optional[str] = None) -> FlightRecorder:
    """Install (and return) a fresh global recorder; call sites pick it
    up at their next event."""
    global _recorder
    if capacity is None:
        capacity = int(os.environ.get("SLT_FLIGHT_CAPACITY",
                                      DEFAULT_CAPACITY))
    with _switch_lock:
        _recorder = FlightRecorder(party=party, capacity=capacity,
                                   dump_path=dump_path)
        return _recorder


def disable() -> Optional[FlightRecorder]:
    """Turn recording off; returns the recorder that was active (its
    events can still be dumped)."""
    global _recorder
    with _switch_lock:
        r, _recorder = _recorder, None
        return r


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def enabled() -> bool:
    return _recorder is not None


def maybe_enable_from_env(party: str = "proc") -> Optional[FlightRecorder]:
    """Honour ``SLT_FLIGHT``: a truthy value enables; any other non-empty
    value enables and sets the trip/fatal dump path."""
    val = os.environ.get("SLT_FLIGHT", "")
    if val and not enabled():
        path = None if val.strip().lower() in _TRUTHY else val
        return enable(party=party, dump_path=path)
    return get_recorder()


def trip(source: str, message: str) -> Optional[str]:
    """The watchdog hook (``obs/locks.py``): records
    ``FL_WATCHDOG_TRIP`` and, with a dump path configured, writes the
    dump there. Never raises and takes no runtime lock (the watchdog
    calls it holding its own). Returns the path written, or None."""
    fl = get_recorder()
    if fl is None:
        return None
    try:
        fl.record(spans.FL_WATCHDOG_TRIP, source=source,
                  message=str(message)[:500])
        if fl.dump_path:
            return fl.dump_json(fl.dump_path, reason=f"watchdog:{source}")
    except Exception:
        pass  # a broken dump path must not mask the watchdog's report
    return None


def fatal(reason: str, message: str = "",
          path: Optional[str] = None) -> Optional[str]:
    """The SIGTERM / fatal-exception hook (``launch/run.py``): records
    ``FL_FATAL`` and dumps to ``path`` (or the configured dump path).
    Never raises."""
    fl = get_recorder()
    if fl is None:
        return None
    try:
        fl.record(spans.FL_FATAL, reason=reason,
                  message=str(message)[:500])
        target = path or fl.dump_path
        if target:
            return fl.dump_json(target, reason=f"fatal:{reason}")
    except Exception:
        pass
    return None
