"""Telemetry plane: windowed time series and SLO burn-rate tracking
(counterpart of ``split_learning_tpu/obs/telemetry.py``).

The metrics registry is cumulative ("how many, ever"); this module
derives "how fast, lately" at scrape time, never on the step path:

:class:`TelemetryRing`
    A bounded ring of fixed-interval windows for one party. Each
    :meth:`TelemetryRing.advance` reads an injectable clock; when
    intervals have elapsed it takes ONE snapshot from the party's
    ``metrics()``-shaped callable and subtracts the previous one:
    per-window counter deltas and rates, histogram deltas (bucket
    subtraction; rolling p50/p95/p99 through
    :func:`~split_learning_tpu_torch.obs.metrics.histogram_percentile`)
    and point-in-time gauges. A counter reset (a party restart) falls
    back to the post-restart cumulative value.

:class:`SLOTracker`
    Per-tenant latency/availability objectives over the ring's windows,
    with the multi-window burn-rate pair: an alert fires only when both
    the fast (5 windows) and the slow (60) burn rate exceed the
    threshold, and clears only when both recede. Burn rates publish as
    gauges (``spans.SLO_BURN_FAST``/``SLO_BURN_SLOW`` per tenant) and
    each transition journals ``spans.FL_SLO_ALERT`` into the flight
    recorder when one is on.

Zero overhead when off: the global ring defaults to ``None``; nothing
here runs unless :func:`enable` was called and something drives
:meth:`TelemetryRing.advance` (a ``/telemetry`` scrape or the sampler
thread). The clock is injectable (``clock=``, default
``time.monotonic``), so tests drive a virtual clock through the same
``advance()`` the scrape uses. Env knobs: ``SLT_TELEMETRY`` (truthy:
on), ``SLT_TELEMETRY_INTERVAL_S`` (default 1.0),
``SLT_TELEMETRY_CAPACITY`` (default 120), ``SLT_TELEMETRY_SLO_MS`` (the
per-tenant latency objective; turns the SLOTracker on),
``SLT_TELEMETRY_BURN_THRESHOLD`` (default 1.0). Stdlib-only;
:meth:`TelemetryRing.advance` holds only the ring's own lock, never a
runtime lock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs.metrics import (
    histogram_delta, histogram_percentile)

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 120
# the SRE multi-window pair: fast catches sudden burn, slow rejects blips
DEFAULT_FAST_WINDOWS = 5
DEFAULT_SLOW_WINDOWS = 60
DEFAULT_BURN_THRESHOLD = 1.0

_TRUTHY = ("1", "true", "on", "yes")

# the rolling percentiles every window carries, (label, q) pairs
WINDOW_PERCENTILES = (("p50", 50.0), ("p95", 95.0), ("p99", 99.0))


def _counter_delta(cur: Dict[str, float],
                   prev: Dict[str, float]) -> Dict[str, float]:
    """Per-name counter deltas, reset-tolerant: a counter that went
    backwards (party restart) contributes its post-restart value."""
    out = {}
    for name, v in cur.items():
        d = float(v) - float(prev.get(name, 0.0))
        out[name] = float(v) if d < 0 else d
    return out


@dataclass
class SloAlert:
    """One burn-rate alert transition (typed; journaled to flight)."""

    tenant: int
    objective: str          # "latency" | "availability"
    state: str              # "firing" | "cleared"
    window_index: int
    burn_fast: float
    burn_slow: float
    threshold: float

    def to_dict(self) -> Dict[str, Any]:
        return {"tenant": self.tenant, "objective": self.objective,
                "state": self.state, "window_index": self.window_index,
                "burn_fast": self.burn_fast, "burn_slow": self.burn_slow,
                "threshold": self.threshold}


@dataclass
class SloObjective:
    """One tracked objective for one tenant.

    ``kind="latency"``: good = observations of histogram
    ``latency_hist`` at or under ``slo_ms`` within the window
    (bucket-resolution estimate: the first bucket edge >= the SLO bounds
    the good count from below, so the error estimate is conservative).

    ``kind="availability"``: good = admitted, bad = rejected, from the
    per-tenant admission counters (``admission_admitted_t<i>`` /
    ``admission_rejected_t<i>`` — runtime/admission.py's naming).
    """

    kind: str
    tenant: int = 0
    target: float = 0.99
    slo_ms: float = 100.0
    latency_hist: str = spans.DISPATCH

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO objective kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1) "
                             f"(got {self.target})")

    # -------------------------------------------------------------- #
    def window_error_rate(self, window: Dict[str, Any]) -> Optional[float]:
        """Fraction of the window's events that violated the objective;
        None when the window carried no relevant events (an idle window
        burns no budget and spends none — it is skipped, not zero)."""
        if self.kind == "latency":
            h = window.get("histograms", {}).get(self.latency_hist)
            if not h or int(h.get("count", 0)) <= 0:
                return None
            total = int(h["count"])
            buckets = h.get("buckets") or ()
            cum = h.get("cumulative") or ()
            slo_s = self.slo_ms / 1e3
            good = 0
            for le, c in zip(buckets, cum):
                if le >= slo_s:
                    good = int(c)
                    break
            else:
                good = int(cum[len(buckets) - 1]) if buckets and cum else 0
            return max(0.0, min(1.0, (total - good) / total))
        counters = window.get("counters", {})
        suffix = f"_t{self.tenant}"
        ok = float(counters.get(
            spans.ADMISSION_ADMITTED + suffix,
            counters.get(spans.ADMISSION_ADMITTED, 0.0)))
        bad = float(counters.get(
            spans.ADMISSION_REJECTED + suffix,
            counters.get(spans.ADMISSION_REJECTED, 0.0)))
        total = ok + bad
        if total <= 0:
            return None
        return bad / total


class SLOTracker:
    """Multi-window burn-rate tracking over a ring's window stream.

    Burn rate = window error rate / error budget (budget = 1 - target):
    burn 1.0 spends the budget exactly at the sustainable pace, burn N
    spends it N× too fast. The fast/slow pair must BOTH exceed
    ``threshold`` to fire (and both recede to clear) — the standard
    guard against paging on a single bad window.
    """

    def __init__(self, objectives: List[SloObjective],
                 fast_windows: int = DEFAULT_FAST_WINDOWS,
                 slow_windows: int = DEFAULT_SLOW_WINDOWS,
                 threshold: float = DEFAULT_BURN_THRESHOLD) -> None:
        if fast_windows < 1 or slow_windows < fast_windows:
            raise ValueError(
                f"need 1 <= fast_windows <= slow_windows "
                f"(got {fast_windows}/{slow_windows})")
        self.objectives = list(objectives)
        self.fast_windows = int(fast_windows)
        self.slow_windows = int(slow_windows)
        self.threshold = float(threshold)
        # per-objective recent window error rates (idle windows skipped)
        self._errors: List[deque] = [
            deque(maxlen=self.slow_windows) for _ in self.objectives]
        self._firing = [False] * len(self.objectives)
        self._alerts: List[SloAlert] = []
        self._burn: List[Tuple[float, float]] = [
            (0.0, 0.0)] * len(self.objectives)

    # -------------------------------------------------------------- #
    def observe_window(self, window: Dict[str, Any]) -> List[SloAlert]:
        """Fold one ring window in; returns the alert transitions it
        caused (also journaled to the flight recorder when enabled)."""
        transitions: List[SloAlert] = []
        for i, obj in enumerate(self.objectives):
            err = obj.window_error_rate(window)
            if err is None:
                continue
            self._errors[i].append(err)
            budget = 1.0 - obj.target
            recent = list(self._errors[i])
            fast = recent[-self.fast_windows:]
            burn_fast = (sum(fast) / len(fast)) / budget
            burn_slow = (sum(recent) / len(recent)) / budget
            self._burn[i] = (burn_fast, burn_slow)
            over = (burn_fast > self.threshold
                    and burn_slow > self.threshold)
            if over != self._firing[i]:
                self._firing[i] = over
                alert = SloAlert(
                    tenant=obj.tenant, objective=obj.kind,
                    state="firing" if over else "cleared",
                    window_index=int(window.get("index", -1)),
                    burn_fast=burn_fast, burn_slow=burn_slow,
                    threshold=self.threshold)
                self._alerts.append(alert)
                transitions.append(alert)
                self._journal(alert)
        return transitions

    def _journal(self, alert: SloAlert) -> None:
        from split_learning_tpu_torch.obs import flight
        fl = flight.get_recorder()
        if fl is None:
            return
        fl.record(spans.FL_SLO_ALERT, tenant=alert.tenant,
                  objective=alert.objective, state=alert.state,
                  window_index=alert.window_index,
                  burn_fast=alert.burn_fast, burn_slow=alert.burn_slow,
                  threshold=alert.threshold)

    # -------------------------------------------------------------- #
    def burn_gauges(self) -> Dict[str, float]:
        """The per-tenant burn-rate gauges, exposition-ready (merged
        into every window and into ``/telemetry``'s ``slo`` block)."""
        out: Dict[str, float] = {}
        for obj, (fast, slow) in zip(self.objectives, self._burn):
            out[f"{spans.SLO_BURN_FAST}_{obj.kind}_t{obj.tenant}"] = fast
            out[f"{spans.SLO_BURN_SLOW}_{obj.kind}_t{obj.tenant}"] = slow
        return out

    def alerts(self) -> List[Dict[str, Any]]:
        return [a.to_dict() for a in self._alerts]

    def firing(self) -> List[Dict[str, Any]]:
        return [{"tenant": o.tenant, "objective": o.kind}
                for o, f in zip(self.objectives, self._firing) if f]

    def dump(self) -> Dict[str, Any]:
        return {
            "fast_windows": self.fast_windows,
            "slow_windows": self.slow_windows,
            "threshold": self.threshold,
            "objectives": [{"kind": o.kind, "tenant": o.tenant,
                            "target": o.target, "slo_ms": o.slo_ms,
                            "latency_hist": o.latency_hist}
                           for o in self.objectives],
            "burn": self.burn_gauges(),
            "firing": self.firing(),
            "alerts": self.alerts(),
        }


class TelemetryRing:
    """Bounded ring of fixed-interval windowed metric deltas for one
    party. Purely scrape-time: call :meth:`advance` (the ``/telemetry``
    handler and the optional sampler thread both do) and it snapshots
    the party's cumulative metrics at most once per elapsed interval,
    diffing against the previous snapshot.

    When several intervals elapsed between advances, the whole delta is
    attributed to the most recent complete window and the skipped
    intervals yield empty windows (we cannot know how activity
    distributed, and empty windows keep the ring's time axis uniform —
    the burn-rate pair depends on that). Deterministic: same clock
    sequence + same snapshots → same windows, bit for bit.
    """

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]], *,
                 party: str = "proc",
                 interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic,
                 slo: Optional[SLOTracker] = None) -> None:
        if interval_s <= 0:
            raise ValueError("telemetry interval must be > 0")
        if capacity < 1:
            raise ValueError("telemetry ring capacity must be >= 1")
        self.snapshot_fn = snapshot_fn
        self.party = party
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.clock = clock
        self.slo = slo
        self._windows: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = float(clock())
        self._next_index = 0            # first un-closed window index
        self._prev: Optional[Dict[str, Any]] = None
        self._sampler: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # set by start(): the SLO its windows are held to, and whether
        # it turned the tracer on
        self.slo_ms: Optional[float] = None
        self.own_tracer = False

    # -------------------------------------------------------------- #
    def _empty_window(self, index: int) -> Dict[str, Any]:
        return {"index": index,
                "t_start": index * self.interval_s,
                "t_end": (index + 1) * self.interval_s,
                "interval_s": self.interval_s,
                "counters": {}, "rates": {}, "gauges": {},
                "histograms": {}, "percentiles": {}}

    def advance(self, force: bool = False) -> int:
        """Close every window boundary the clock has crossed since the
        last call; returns how many windows were appended. ``force``
        closes the in-progress window early (final flush on close /
        end-of-run dump). Holds only the ring's own lock — NEVER a
        runtime lock (acceptance: the scrape path must not serialize
        under one)."""
        with self._lock:
            now = float(self.clock())
            elapsed = now - self._t0
            complete = int(elapsed // self.interval_s)
            if complete <= self._next_index and not force:
                return 0
            snap = self.snapshot_fn() or {}
            prev = self._prev or {}
            counters = _counter_delta(snap.get("counters", {}),
                                      prev.get("counters", {}))
            hists = {
                name: histogram_delta(
                    h, (prev.get("histograms", {}) or {}).get(name))
                for name, h in (snap.get("histograms", {}) or {}).items()}
            pct = {
                name: {label: histogram_percentile(h, q) * 1e3
                       for label, q in WINDOW_PERCENTILES}
                for name, h in hists.items() if int(h.get("count", 0)) > 0}
            self._prev = snap
            appended = 0
            # idle intervals first (empty, keep the time axis uniform)
            last = max(complete - 1, self._next_index)
            while self._next_index < last:
                w = self._empty_window(self._next_index)
                self._windows.append(w)
                if self.slo is not None:
                    self.slo.observe_window(w)
                self._next_index += 1
                appended += 1
            w = self._empty_window(self._next_index)
            if force and complete <= self._next_index:
                # partial window, honest width (floored so a double
                # force inside one interval cannot invert the axis)
                w["t_end"] = max(elapsed, w["t_start"] + 1e-9)
            width = max(w["t_end"] - w["t_start"], 1e-9)
            w["counters"] = counters
            w["rates"] = {name: d / width for name, d in counters.items()}
            w["gauges"] = dict(snap.get("gauges", {}) or {})
            w["histograms"] = hists
            w["percentiles"] = pct
            self._windows.append(w)
            if self.slo is not None:
                self.slo.observe_window(w)
                w["gauges"].update(self.slo.burn_gauges())
            self._next_index += 1
            return appended + 1

    # -------------------------------------------------------------- #
    def windows(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            ws = list(self._windows)
        return ws if last is None else ws[-int(last):]

    def dump(self) -> Dict[str, Any]:
        """The ``/telemetry`` JSON payload (JAX's schema:
        ``scripts/slt_top.py`` and obs/federate.py consume it). JSON-safe by construction; the
        caller serializes OUTSIDE any runtime lock."""
        return {
            "version": 1,
            "kind": "slt-telemetry",
            "party": self.party,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "next_index": self._next_index,
            "windows": self.windows(),
            "slo": self.slo.dump() if self.slo is not None else None,
        }

    # -------------------------------------------------------------- #
    def start_sampler(self) -> None:
        """Optional daemon thread advancing the ring between scrapes so
        SLO alerts fire even when nobody is polling ``/telemetry``.
        Serve mode starts this; tests drive :meth:`advance` directly
        with a virtual clock instead."""
        if self._sampler is not None:
            return
        def _run() -> None:
            while not self._stop.wait(self.interval_s / 2.0):
                self.advance()
        self._sampler = threading.Thread(
            target=_run, name="slt-telemetry-sampler", daemon=True)
        self._sampler.start()

    def close(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=2.0)
            self._sampler = None


# -- global per-process ring (the tracer's enable/disable idiom) ------- #
_RING: Optional[TelemetryRing] = None


def enable(snapshot_fn: Callable[[], Dict[str, Any]], **kw: Any
           ) -> TelemetryRing:
    """Install the process-global ring (see :class:`TelemetryRing` for
    kwargs). Call sites gate on ``get_ring() is None`` — the tracer's
    zero-overhead-off contract, verbatim."""
    global _RING
    _RING = TelemetryRing(snapshot_fn, **kw)
    return _RING


def disable() -> None:
    global _RING
    if _RING is not None:
        _RING.close()
    _RING = None


def get_ring() -> Optional[TelemetryRing]:
    return _RING


def enabled() -> bool:
    return _RING is not None


def env_config() -> Optional[Dict[str, Any]]:
    """Parse the SLT_TELEMETRY* env knobs; None when telemetry is off.
    Split from :func:`maybe_enable_from_env` so launch/run.py can merge
    CLI flags over the env before constructing the ring."""
    raw = os.environ.get("SLT_TELEMETRY", "")
    if not raw or raw.lower() not in _TRUTHY:
        return None
    cfg: Dict[str, Any] = {
        "interval_s": float(os.environ.get(
            "SLT_TELEMETRY_INTERVAL_S", DEFAULT_INTERVAL_S)),
        "capacity": int(os.environ.get(
            "SLT_TELEMETRY_CAPACITY", DEFAULT_CAPACITY)),
    }
    slo_ms = os.environ.get("SLT_TELEMETRY_SLO_MS", "")
    if slo_ms:
        cfg["slo_ms"] = float(slo_ms)
        cfg["burn_threshold"] = float(os.environ.get(
            "SLT_TELEMETRY_BURN_THRESHOLD", DEFAULT_BURN_THRESHOLD))
    return cfg


def tracker_from_config(cfg: Dict[str, Any], tenants: int = 1
                        ) -> Optional[SLOTracker]:
    """An SLOTracker matching an :func:`env_config` dict: one latency
    objective per tenant against the dispatch histogram plus one
    availability objective per tenant, or None when no SLO was asked
    for."""
    if "slo_ms" not in cfg:
        return None
    objectives: List[SloObjective] = []
    for t in range(max(int(tenants), 1)):
        objectives.append(SloObjective(
            kind="latency", tenant=t, slo_ms=float(cfg["slo_ms"])))
        objectives.append(SloObjective(kind="availability", tenant=t))
    return SLOTracker(objectives, threshold=float(
        cfg.get("burn_threshold", DEFAULT_BURN_THRESHOLD)))


def maybe_enable_from_env(snapshot_fn: Callable[[], Dict[str, Any]],
                          party: str = "proc", tenants: int = 1
                          ) -> Optional[TelemetryRing]:
    """``SLT_TELEMETRY`` truthy → install + return the global ring
    (with an SLOTracker when ``SLT_TELEMETRY_SLO_MS`` is set); else
    leave telemetry off and return None."""
    cfg = env_config()
    if cfg is None:
        return None
    return enable(snapshot_fn, party=party,
                  interval_s=cfg["interval_s"], capacity=cfg["capacity"],
                  slo=tracker_from_config(cfg, tenants=tenants))


def start(snapshot_fn: Callable[[], Dict[str, Any]], *,
          party: str = "server", force: bool = False,
          interval_s: Optional[float] = None,
          slo_ms: Optional[float] = None,
          default_slo_ms: Optional[float] = None,
          tenants: int = 1) -> Optional[TelemetryRing]:
    """The ring behind ``--telemetry``, ``SLT_TELEMETRY`` and
    ``--autoscale`` (``force``: the policy reads its windows): None when
    none of them asks. ``interval_s`` and ``slo_ms`` (flags) win over
    the env knobs; ``default_slo_ms`` applies only where neither set an
    SLO. Telemetry implies tracing: the tracer is turned on when off,
    and :func:`stop` turns it off again. The sampler is started."""
    from split_learning_tpu_torch.obs import trace as obs_trace
    cfg = env_config()
    if cfg is None and not force:
        return None
    if cfg is None:
        cfg = {"interval_s": DEFAULT_INTERVAL_S,
               "capacity": DEFAULT_CAPACITY}
    if interval_s:
        cfg["interval_s"] = float(interval_s)
    if slo_ms:
        cfg["slo_ms"] = float(slo_ms)
    elif default_slo_ms and "slo_ms" not in cfg:
        cfg["slo_ms"] = float(default_slo_ms)
    own_tracer = obs_trace.get_tracer() is None
    if own_tracer:
        obs_trace.enable()  # the windows read the tracer-gated histograms
    ring = enable(snapshot_fn, party=party, interval_s=cfg["interval_s"],
                  capacity=cfg["capacity"],
                  slo=tracker_from_config(cfg, tenants=tenants))
    ring.slo_ms = cfg.get("slo_ms")
    ring.own_tracer = own_tracer
    ring.start_sampler()
    return ring


def stop() -> None:
    """Close the ring :func:`start` installed, and the tracer if it
    turned it on."""
    from split_learning_tpu_torch.obs import trace as obs_trace
    ring = _RING
    disable()
    if ring is not None and ring.own_tracer:
        obs_trace.disable()
