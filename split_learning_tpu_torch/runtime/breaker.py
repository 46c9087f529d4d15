"""Client-side circuit breaker (counterpart of
``split_learning_tpu/runtime/breaker.py``).

The retry policy alone hammers a down server: every batch burns its
whole retry budget against a peer that cannot answer. The breaker sits
between the retry loop and the wire with three states:

- **CLOSED**: requests flow; consecutive failures are counted.
- **OPEN**: ``failure_threshold`` consecutive transport failures seen;
  :meth:`CircuitBreaker.before_attempt` probes the cheap ``/health``
  endpoint on an exponential-backoff-with-jitter schedule
  (``transport/base.py`` ``backoff_delays``) until the server answers
  or ``max_open_s`` elapses.
- **HALF_OPEN**: a probe succeeded; one real request is let through.
  Success re-closes the breaker; failure re-opens it.

The breaker never swallows errors and never decides policy: it only
shapes when the next attempt happens. Each state transition journals
``FL_BREAKER`` when the flight recorder is on.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.base import (
    TransportError, backoff_delays)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Thread-safe breaker around a health-probe callable.

    ``health_probe`` is any zero-argument callable that raises
    ``TransportError`` while the peer is down (``transport.health``).
    The probe jitter comes from ``rng`` or a ``random.Random(seed)``
    (seed 0 by default): a run reproduces its probe schedule."""

    def __init__(self, health_probe: Callable[[], object],
                 failure_threshold: int = 3,
                 probe_initial_s: float = 0.5,
                 probe_cap_s: float = 5.0,
                 probe_jitter: float = 0.5,
                 max_open_s: float = 60.0,
                 seed: Optional[int] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._probe = health_probe
        self.failure_threshold = int(failure_threshold)
        self.probe_initial_s = float(probe_initial_s)
        self.probe_cap_s = float(probe_cap_s)
        self.probe_jitter = float(probe_jitter)
        self.max_open_s = float(max_open_s)
        self._rng = rng if rng is not None else random.Random(
            0 if seed is None else seed)
        self._sleep = sleep  # injectable for tests: no real waiting
        self._lock = obs_locks.make_lock("CircuitBreaker._lock")
        self.state = CLOSED
        self._consecutive_failures = 0
        self.counters: Dict[str, int] = {
            "breaker_opened": 0, "breaker_probes": 0,
            "breaker_probe_failures": 0, "breaker_reclosed": 0,
            "breaker_reopened": 0, "breaker_backpressure_waits": 0}

    def record_failure(self) -> None:
        """One transport failure on a real request."""
        transition = None
        with self._lock:
            self._consecutive_failures += 1
            if self.state == HALF_OPEN:
                # the trial request failed: the recovery was an illusion
                self.state = OPEN
                self.counters["breaker_reopened"] += 1
                transition = (HALF_OPEN, OPEN, "trial_failed")
            elif (self.state == CLOSED and
                  self._consecutive_failures >= self.failure_threshold):
                self.state = OPEN
                self.counters["breaker_opened"] += 1
                transition = (CLOSED, OPEN, "threshold")
        self._record_transition(transition)

    def record_success(self) -> None:
        """One real request completed: from any state, back to CLOSED."""
        transition = None
        with self._lock:
            self._consecutive_failures = 0
            if self.state != CLOSED:
                transition = (self.state, CLOSED, "success")
                self.state = CLOSED
                self.counters["breaker_reclosed"] += 1
        self._record_transition(transition)

    @staticmethod
    def _record_transition(transition) -> None:
        if transition is None:
            return
        fl = obs_flight.get_recorder()
        if fl is not None:
            src, dst, why = transition
            fl.record(spans.FL_BREAKER, party="client",
                      src=src, dst=dst, why=why)

    def backpressure_wait(self, delay_s: float) -> None:
        """Honour an explicit 429 / Retry-After without counting a
        failure: the server is healthy and refused this step, so the
        state and the failure count are untouched."""
        with self._lock:
            self.counters["breaker_backpressure_waits"] += 1
        # sleep outside the lock: other threads' record_* must not queue
        # behind a quota wait
        self._sleep(max(float(delay_s), 0.0))

    def before_attempt(self) -> None:
        """Gate one delivery attempt. CLOSED/HALF_OPEN: pass through.
        OPEN: probe ``/health`` with backoff and jitter until it answers
        (-> HALF_OPEN) or ``max_open_s`` is spent (-> TransportError,
        which the caller's failure policy takes from there)."""
        with self._lock:
            if self.state != OPEN:
                return
        deadline = time.monotonic() + self.max_open_s
        for delay in backoff_delays(self.probe_initial_s, cap=self.probe_cap_s,
                                    jitter=self.probe_jitter, rng=self._rng):
            self._sleep(min(delay, max(deadline - time.monotonic(), 0.0)))
            with self._lock:
                if self.state != OPEN:
                    return  # another thread's probe already succeeded
                self.counters["breaker_probes"] += 1
            try:
                self._probe()
            except TransportError:
                with self._lock:
                    self.counters["breaker_probe_failures"] += 1
                if time.monotonic() >= deadline:
                    raise TransportError(
                        f"circuit open: health probes failed for "
                        f"{self.max_open_s:.0f}s")
                continue
            transition = None
            with self._lock:
                if self.state == OPEN:
                    self.state = HALF_OPEN
                    transition = (OPEN, HALF_OPEN, "probe_ok")
            self._record_transition(transition)
            return
