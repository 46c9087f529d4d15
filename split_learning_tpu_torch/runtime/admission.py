"""Multi-tenant admission control: token-bucket quotas and EDF deadlines
(counterpart of ``split_learning_tpu/runtime/admission.py``; host code).

- **Per-tenant token buckets.** Each tenant (``client_id % tenants`` by
  default) accrues ``quota`` tokens a second up to a ``burst`` cap; one
  admitted step spends one token. An empty bucket raises
  :class:`~split_learning_tpu_torch.transport.base.Backpressure` with
  the time until the next token: 429 with ``Retry-After`` over HTTP,
  the exception itself in process.
- **SLO deadlines.** Admission stamps each request with ``now +
  slo_ms`` of its tenant; the continuous batcher
  (``runtime/coalesce.py``) picks its next group's head
  earliest-deadline-first.

Deterministic: no RNG, every time from one injectable monotonic clock,
so a virtual clock reproduces an admission sequence exactly. The one
lock guards bucket arithmetic only. Each admit and reject journals a
flight event (``FL_ADMIT``, ``FL_REJECT``) when the recorder is on.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.base import Backpressure


def _per_tenant(value: Union[None, float, Sequence[float]],
                tenants: int, name: str) -> Optional[List[float]]:
    """A scalar knob as one float per tenant (or a per-tenant sequence,
    checked); None stays None (the feature is off)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return [float(value)] * tenants
    vals = [float(v) for v in value]
    if len(vals) != tenants:
        raise ValueError(
            f"{name} must be a scalar or one value per tenant "
            f"(got {len(vals)} values for {tenants} tenants)")
    return vals


class AdmissionController:
    """Thread-safe admission gate in front of the split step.

    ``admit(client_id)`` returns the request's EDF deadline (a
    monotonic-clock instant, or None without an SLO) or raises
    :class:`Backpressure` with the advised retry delay.
    ``complete(client_id)`` releases the in-flight slot an admit
    charged; the per-tenant queue-depth gauge is the difference.

    ``quota`` is admitted steps a second per tenant (None: every request
    admits, deadlines still apply). ``burst`` caps the bucket (default
    one second of quota, at least one token)."""

    def __init__(self, tenants: int = 1,
                 quota: Union[None, float, Sequence[float]] = None,
                 burst: Union[None, float, Sequence[float]] = None,
                 slo_ms: Union[None, float, Sequence[float]] = None,
                 tenant_of: Optional[Callable[[int], int]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if tenants < 1:
            raise ValueError(f"tenants must be >= 1 (got {tenants})")
        self.tenants = int(tenants)
        self._quota = _per_tenant(quota, self.tenants, "quota")
        if self._quota is not None and any(q <= 0 for q in self._quota):
            raise ValueError(f"quota must be > 0 (got {self._quota})")
        if burst is None and self._quota is not None:
            self._burst = [max(q, 1.0) for q in self._quota]
        else:
            self._burst = _per_tenant(burst, self.tenants, "burst")
        if self._burst is not None and any(b < 1 for b in self._burst):
            raise ValueError(
                f"burst must allow at least one token (got {self._burst})")
        slo = _per_tenant(slo_ms, self.tenants, "slo_ms")
        self._slo_s = None if slo is None else [v / 1e3 for v in slo]
        self._tenant_of = tenant_of
        self._clock = clock
        self._lock = obs_locks.make_lock("AdmissionController._lock")
        # buckets start full: a fresh server admits an opening burst
        self._tokens = (list(self._burst) if self._burst is not None
                        else None)
        self._refill_at = [self._clock()] * self.tenants
        self._depth = [0] * self.tenants
        self._admitted = [0] * self.tenants
        self._rejected = [0] * self.tenants

    # ------------------------------------------------------------------ #
    def tenant_of(self, client_id: int) -> int:
        if self._tenant_of is not None:
            return int(self._tenant_of(client_id)) % self.tenants
        return int(client_id) % self.tenants

    def admit(self, client_id: int) -> Optional[float]:
        """Charge one step to ``client_id``'s tenant. Returns the EDF
        deadline (monotonic seconds; None without an SLO) or raises
        :class:`Backpressure` whose ``retry_after_s`` is the time until
        the bucket next holds a whole token."""
        t = self.tenant_of(client_id)
        now = self._clock()
        with self._lock:
            if self._quota is not None:
                rate = self._quota[t]
                tokens = min(
                    self._burst[t],
                    self._tokens[t] + (now - self._refill_at[t]) * rate)
                self._refill_at[t] = now
                if tokens < 1.0:
                    self._tokens[t] = tokens
                    self._rejected[t] += 1
                    retry_after = (1.0 - tokens) / rate
                else:
                    self._tokens[t] = tokens - 1.0
                    retry_after = None
            else:
                retry_after = None
            if retry_after is None:
                self._admitted[t] += 1
                self._depth[t] += 1
        fl = obs_flight.get_recorder()
        if retry_after is not None:
            if fl is not None:
                fl.record(spans.FL_REJECT, client_id=int(client_id),
                          party="server", tenant=t,
                          retry_after_s=retry_after)
            raise Backpressure(
                f"tenant {t} over quota ({self._quota[t]:g} steps/s): "
                f"retry in {retry_after:.3f}s", retry_after_s=retry_after)
        deadline = (now + self._slo_s[t]) if self._slo_s is not None else None
        if fl is not None:
            fl.record(spans.FL_ADMIT, client_id=int(client_id),
                      party="server", tenant=t, deadline=deadline)
        return deadline

    def complete(self, client_id: int) -> None:
        """Release the slot an :meth:`admit` charged (on success or
        failure: callers pair the two)."""
        t = self.tenant_of(client_id)
        with self._lock:
            self._depth[t] = max(self._depth[t] - 1, 0)

    # ------------------------------------------------------------------ #
    def counters(self) -> Dict[str, float]:
        """Totals and per-tenant admitted/rejected (``_t<i>`` suffixed)."""
        with self._lock:
            admitted = list(self._admitted)
            rejected = list(self._rejected)
        out: Dict[str, float] = {
            spans.ADMISSION_ADMITTED: float(sum(admitted)),
            spans.ADMISSION_REJECTED: float(sum(rejected)),
        }
        for i in range(self.tenants):
            out[f"{spans.ADMISSION_ADMITTED}_t{i}"] = float(admitted[i])
            out[f"{spans.ADMISSION_REJECTED}_t{i}"] = float(rejected[i])
        return out

    def gauges(self) -> Dict[str, float]:
        """Per-tenant in-flight depth (admitted minus completed)."""
        with self._lock:
            depth = list(self._depth)
        return {f"{spans.ADMISSION_QUEUE_DEPTH}_t{i}": float(depth[i])
                for i in range(self.tenants)}

    def config(self) -> Dict[str, object]:
        """The knobs as configured, for /health."""
        return {"tenants": self.tenants,
                "quota": self._quota,
                "burst": self._burst,
                "slo_ms": (None if self._slo_s is None
                           else [s * 1e3 for s in self._slo_s])}
