"""Elastic autoscaling: policy-driven scale events (counterpart of
``split_learning_tpu/runtime/autoscale.py``, the same policy and
decisions).

- **Signals** come from the telemetry ring (``obs/telemetry.py``): each
  completed window yields the group's occupancy (coalescer fill against
  ``coalesce_max``), the admission reject rate, the fast-window SLO burn
  gauge and the dispatch p99 against the SLO.
- :class:`AutoscalePolicy` turns one window's signals into ``up``,
  ``down`` or ``hold``: up when a pressure signal breaches (rejects above
  the ceiling, p99 over the SLO, occupancy above the band; burn only as
  the mid-band tie-break), down only when every signal is comfortable.
  Hysteresis (consecutive agreeing windows) and per-direction cooldowns
  keep it from flapping; the clock is injectable, so the same window
  series gives the same calls.
- :class:`Autoscaler` executes the verdicts on a live
  :class:`~split_learning_tpu_torch.runtime.replica.ReplicaGroup`:
  scale-up spawns a replica through the caller's factory (on one card,
  another runtime sharing it), scale-down retires the least-loaded one
  through the failover handoff; never below ``min_replicas``, never
  while another handoff is in flight, never against the breaker.

The flight recorder journals ``fl_scale_decision`` (non-hold verdicts);
the group's registry carries the ``autoscale_decision`` gauge (1 up, -1
down, 0 otherwise). Nothing here is built unless ``--autoscale`` (or
``SLT_AUTOSCALE``) asks for it.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.runtime.replica import ScaleRefused

# policy defaults: the occupancy band targets the coalescer's sweet
# spot (full-enough groups without queue growth); one bad window is
# enough to scale up, two idle windows to scale down
DEFAULT_BAND = (0.35, 0.85)
DEFAULT_REJECT_CEILING = 0.01
DEFAULT_BURN_CEILING = 1.0
DEFAULT_HYSTERESIS_UP = 1
DEFAULT_HYSTERESIS_DOWN = 2
DEFAULT_COOLDOWN_S = 5.0

_TRUTHY = ("1", "true", "yes", "on")


@dataclass
class AutoscaleSignals:
    """One telemetry window, reduced to what the policy reads. ``None``
    means the window carried no evidence for that signal (no traffic,
    no SLO configured) — a missing signal never *triggers* a scale-up,
    and only an idle occupancy signal argues for scale-down."""

    occupancy: Optional[float] = None      # mean group fill / coalesce_max
    reject_rate: Optional[float] = None    # rejected / offered
    burn: Optional[float] = None           # max fast-window SLO burn rate
    p99_over_slo: Optional[float] = None   # window dispatch p99 / SLO
    window_index: int = -1


@dataclass
class AutoscaleDecision:
    direction: str                         # "up" | "down" | "hold"
    reason: str
    n_live: int
    signals: AutoscaleSignals
    executed: bool = False
    replica: Optional[int] = None


def signals_from_window(window: Dict[str, Any], *, coalesce_max: int = 1,
                        slo_ms: Optional[float] = None) -> AutoscaleSignals:
    """Reduce one :meth:`TelemetryRing.advance` window to policy
    signals. Window counters are already per-window deltas, so the
    occupancy here is the window's own mean group fill — not the
    lifetime mean ``health()`` reports."""
    counters = window.get("counters", {}) or {}
    gauges = window.get("gauges", {}) or {}
    pcts = window.get("percentiles", {}) or {}

    occupancy = None
    groups = float(counters.get("coalesce_groups_flushed", 0.0) or 0.0)
    if groups > 0:
        mean_fill = float(
            counters.get("coalesce_requests_coalesced", 0.0)) / groups
        occupancy = mean_fill / max(int(coalesce_max), 1)

    reject_rate = None
    admitted = float(counters.get(spans.ADMISSION_ADMITTED, 0.0) or 0.0)
    rejected = float(counters.get(spans.ADMISSION_REJECTED, 0.0) or 0.0)
    offered = admitted + rejected
    if offered > 0:
        reject_rate = rejected / offered

    burn = None
    burns = [float(v) for k, v in gauges.items()
             if k.startswith(spans.SLO_BURN_FAST)]
    if burns:
        burn = max(burns)

    p99_over_slo = None
    if slo_ms:
        p99 = (pcts.get(spans.DISPATCH) or {}).get("p99")
        if p99 is not None:
            p99_over_slo = float(p99) / float(slo_ms)

    return AutoscaleSignals(occupancy=occupancy, reject_rate=reject_rate,
                            burn=burn, p99_over_slo=p99_over_slo,
                            window_index=int(window.get("index", -1)))


class AutoscalePolicy:
    """Window signals -> up/down/hold, with hysteresis and per-direction
    cooldowns. Pure control logic: no group, no threads, no wall clock
    (``clock`` is injectable and only gates cooldowns) — feed it the
    same window sequence twice and it makes the same calls."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 band: tuple = DEFAULT_BAND,
                 reject_ceiling: float = DEFAULT_REJECT_CEILING,
                 burn_ceiling: float = DEFAULT_BURN_CEILING,
                 hysteresis_up: int = DEFAULT_HYSTERESIS_UP,
                 hysteresis_down: int = DEFAULT_HYSTERESIS_DOWN,
                 cooldown_up_s: float = DEFAULT_COOLDOWN_S,
                 cooldown_down_s: float = 2 * DEFAULT_COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        low, high = float(band[0]), float(band[1])
        if not (0.0 <= low < high):
            raise ValueError(f"occupancy band must satisfy 0 <= low < "
                             f"high (got {band!r})")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.band_low, self.band_high = low, high
        self.reject_ceiling = float(reject_ceiling)
        self.burn_ceiling = float(burn_ceiling)
        self.hysteresis_up = max(int(hysteresis_up), 1)
        self.hysteresis_down = max(int(hysteresis_down), 1)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self._clock = clock
        self._pending_dir = "hold"
        self._pending_n = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None

    def _raw_direction(self, s: AutoscaleSignals) -> tuple:
        # window-local pressure first, in both directions; the burn
        # gauge integrates windows of history, so it only breaks the
        # mid-band tie below — capacity can't un-spend budget already
        # burned, and stale burn must not block a scale-down once the
        # window itself is idle
        if s.reject_rate is not None and s.reject_rate > self.reject_ceiling:
            return "up", (f"reject_rate {s.reject_rate:.3f} > "
                          f"{self.reject_ceiling:g}")
        if s.p99_over_slo is not None and s.p99_over_slo > 1.0:
            return "up", f"p99 {s.p99_over_slo:.2f}x slo"
        if s.occupancy is not None and s.occupancy > self.band_high:
            return "up", (f"occupancy {s.occupancy:.2f} > "
                          f"{self.band_high:g}")
        if ((s.occupancy is None or s.occupancy < self.band_low)
                and (s.reject_rate is None or s.reject_rate == 0.0)
                and (s.p99_over_slo is None or s.p99_over_slo <= 1.0)):
            occ = "idle" if s.occupancy is None \
                else f"{s.occupancy:.2f}"
            return "down", f"occupancy {occ} < {self.band_low:g}"
        if s.burn is not None and s.burn > self.burn_ceiling:
            return "up", f"burn {s.burn:.2f} > {self.burn_ceiling:g}"
        return "hold", "in_band"

    def decide(self, signals: AutoscaleSignals,
               n_live: int) -> AutoscaleDecision:
        """One verdict per window. ``n_live`` is the group's
        breaker-healthy capacity — the caller must not count
        breaker-open replicas."""
        raw, reason = self._raw_direction(signals)
        if raw == self._pending_dir:
            self._pending_n += 1
        else:
            self._pending_dir, self._pending_n = raw, 1

        def hold(why: str) -> AutoscaleDecision:
            return AutoscaleDecision("hold", why, n_live, signals)

        if raw == "hold":
            return hold(reason)
        need = (self.hysteresis_up if raw == "up"
                else self.hysteresis_down)
        if self._pending_n < need:
            return hold(f"hysteresis {raw} {self._pending_n}/{need}")
        now = self._clock()
        if raw == "up":
            if n_live >= self.max_replicas:
                return hold(f"at_max ({n_live})")
            if (self._last_up_t is not None
                    and now - self._last_up_t < self.cooldown_up_s):
                return hold("cooldown_up")
            self._last_up_t = now
            self._pending_n = 0
            return AutoscaleDecision("up", reason, n_live, signals)
        if n_live <= self.min_replicas:
            return hold(f"at_min ({n_live})")
        if (self._last_down_t is not None
                and now - self._last_down_t < self.cooldown_down_s):
            return hold("cooldown_down")
        self._last_down_t = now
        self._pending_n = 0
        return AutoscaleDecision("down", reason, n_live, signals)


class Autoscaler:
    """Drives a live ``ReplicaGroup`` from an ``AutoscalePolicy`` over a
    ``TelemetryRing``. ``maybe_scale()`` is safe to call from any worker
    thread at any cadence: it evaluates at most once per *new* telemetry
    window, and concurrent callers skip rather than queue (non-blocking
    try-acquire), so the fleet harness can hook it onto step completion
    without serializing steps."""

    def __init__(self, group: Any, factory: Callable[[int], Any],
                 policy: AutoscalePolicy, ring: Any, *,
                 coalesce_max: int = 1,
                 slo_ms: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.group = group
        self.policy = policy
        self._factory = factory
        self._ring = ring
        self._coalesce_max = max(int(coalesce_max), 1)
        self._slo_ms = slo_ms
        self._clock = clock if clock is not None else policy._clock
        self._t0 = self._clock()
        # plain lock on purpose: only ever try-acquired, never waited on
        self._eval_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # windows that predate the autoscaler are history, not signal
        self._last_index = -1
        for w in ring.windows(last=1):
            self._last_index = int(w.get("index", -1))
        self.decisions = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.events: List[Dict[str, Any]] = []
        self.p99_trajectory: List[Optional[float]] = []
        # faults that note_error() counted, by caller; a healthy run has none
        self._err_lock = threading.Lock()
        self.errors: Dict[str, int] = {"pump": 0, "step_hook": 0}
        self.last_error: Optional[str] = None

    # -- the control loop ------------------------------------------------ #
    def maybe_scale(self) -> Optional[AutoscaleDecision]:
        if not self._eval_lock.acquire(blocking=False):
            return None
        try:
            return self._evaluate()
        finally:
            self._eval_lock.release()

    def _evaluate(self) -> Optional[AutoscaleDecision]:
        self._ring.advance()
        ws = self._ring.windows(last=1)
        if not ws:
            return None
        window = ws[-1]
        index = int(window.get("index", -1))
        if index <= self._last_index:
            return None
        self._last_index = index
        sig = signals_from_window(window, coalesce_max=self._coalesce_max,
                                  slo_ms=self._slo_ms)
        p99 = (window.get("percentiles", {}).get(spans.DISPATCH)
               or {}).get("p99")
        self.p99_trajectory.append(
            None if p99 is None else round(float(p99), 3))
        n_live = len(self.group.capacity_replicas())
        decision = self.policy.decide(sig, n_live)
        self.decisions += 1
        fl = obs_flight.get_recorder()
        if decision.direction == "up":
            self._scale_up(decision)
        elif decision.direction == "down":
            if self.group.handoff_in_flight():
                decision.reason += " (blocked: handoff in flight)"
            else:
                self._scale_down(decision)
        gauge = 0.0
        if decision.executed:
            gauge = 1.0 if decision.direction == "up" else -1.0
        self.group.registry.set_gauge(spans.AUTOSCALE_DECISION, gauge)
        if fl is not None and decision.direction != "hold":
            fl.record(spans.FL_SCALE_DECISION, party="autoscaler",
                      direction=decision.direction,
                      reason=decision.reason, executed=decision.executed,
                      n_live=n_live)
        if decision.executed:
            self.events.append({
                "t_s": round(self._clock() - self._t0, 3),
                "window": index,
                "direction": decision.direction,
                "reason": decision.reason,
                "replica": decision.replica,
                "n_live": n_live})
        return decision

    def _scale_up(self, decision: AutoscaleDecision) -> None:
        decision.replica = self.group.add_replica(self._factory)
        decision.executed = True
        self.scale_ups += 1

    def _scale_down(self, decision: AutoscaleDecision) -> None:
        counts = self.group.route_counts()
        capacity = self.group.capacity_replicas()
        if len(capacity) <= self.policy.min_replicas:
            decision.reason += " (blocked: at capacity floor)"
            return
        # least-loaded victim; prefer the newest on ties (LIFO retire)
        victim = min(capacity,
                     key=lambda idx: (counts.get(idx, 0), -idx))
        try:
            self.group.remove_replica(victim)
        except ScaleRefused as exc:
            # lost a race with a breaker death or a concurrent retire —
            # the scale lock made the other event win atomically; a
            # fault past the fence propagates to the caller's count
            decision.reason += f" (blocked: {exc})"
            return
        decision.replica = victim
        decision.executed = True
        self.scale_downs += 1

    def note_error(self, source: str, exc: BaseException) -> None:
        """Count a fault that a caller of :meth:`maybe_scale` caught so
        as to outlive it (``"pump"``, or the fleet's ``"step_hook"``) and
        keep its text, for :meth:`summary` and the gates that read it."""
        with self._err_lock:
            self.errors[source] = self.errors.get(source, 0) + 1
            self.last_error = f"{type(exc).__name__}: {exc}"

    # -- background pump (serve/train mode) ------------------------------ #
    def start(self, interval_s: float = 1.0) -> None:
        """Poll ``maybe_scale`` on a daemon thread — for the serve path,
        where no fleet harness calls it per step."""
        if self._thread is not None:
            return
        period = max(float(interval_s), 0.05)

        def pump() -> None:
            while not self._stop.wait(period):
                try:
                    self.maybe_scale()
                except Exception as exc:  # never kill the serve loop
                    self.note_error("pump", exc)

        self._thread = threading.Thread(
            target=pump, name="slt-autoscaler", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- reporting -------------------------------------------------------- #
    def summary(self) -> Dict[str, Any]:
        """The schema-stable core of fleet_sim's ``autoscale`` block."""
        return {
            "decisions": int(self.decisions),
            "scale_ups": int(self.scale_ups),
            "scale_downs": int(self.scale_downs),
            "events": list(self.events),
            "p99_ms_trajectory": list(self.p99_trajectory),
            "pump_errors": int(self.errors["pump"]),
            "step_hook_errors": int(self.errors["step_hook"]),
            "last_error": self.last_error,
        }


def env_config() -> Dict[str, Any]:
    """Parse the SLT_AUTOSCALE* env knobs (CLI flags merge over these in
    launch/run.py, the SLT_TELEMETRY* precedent). Always returns a dict;
    ``enabled`` is False unless SLT_AUTOSCALE is truthy."""
    raw = os.environ.get("SLT_AUTOSCALE", "")
    return {
        "enabled": bool(raw) and raw.lower() in _TRUTHY,
        "min_replicas": int(os.environ.get("SLT_AUTOSCALE_MIN", "1")),
        "max_replicas": int(os.environ.get("SLT_AUTOSCALE_MAX", "4")),
        "cooldown_s": float(os.environ.get(
            "SLT_AUTOSCALE_COOLDOWN_S", str(DEFAULT_COOLDOWN_S))),
    }


def args_config(args) -> Optional[Dict[str, Any]]:
    """Merge the ``--autoscale*`` CLI flags over the SLT_AUTOSCALE* env
    knobs (CLI wins, the SLT_TELEMETRY* precedent). None when the
    autoscaler is off — no policy object is ever constructed, the
    zero-overhead-off pin shared by launch/run.py and fleet_sim."""
    cfg = env_config()
    if getattr(args, "autoscale", False):
        cfg["enabled"] = True
    if not cfg["enabled"]:
        return None
    if getattr(args, "autoscale_min", None) is not None:
        cfg["min_replicas"] = int(args.autoscale_min)
    if getattr(args, "autoscale_max", None) is not None:
        cfg["max_replicas"] = int(args.autoscale_max)
    if getattr(args, "autoscale_cooldown_s", None) is not None:
        cfg["cooldown_s"] = float(args.autoscale_cooldown_s)
    return cfg


def policy_from_config(cfg: Dict[str, Any],
                       clock: Callable[[], float] = time.monotonic
                       ) -> AutoscalePolicy:
    """An :class:`AutoscalePolicy` from an :func:`env_config`-shaped
    dict: one ``cooldown_s`` knob maps to cooldown_up_s and a 2x
    scale-down cooldown (retiring capacity should be the slower
    reflex)."""
    cooldown = float(cfg.get("cooldown_s", DEFAULT_COOLDOWN_S))
    return AutoscalePolicy(
        min_replicas=int(cfg.get("min_replicas", 1)),
        max_replicas=int(cfg.get("max_replicas", 4)),
        cooldown_up_s=cooldown,
        cooldown_down_s=2 * cooldown,
        clock=clock)
