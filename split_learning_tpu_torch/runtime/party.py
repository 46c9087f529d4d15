"""PartyRuntime: the shared core of a split-learning party (counterpart
of ``split_learning_tpu/runtime/party.py``, the core only).

What is here, each as in JAX:

- one metrics :class:`~split_learning_tpu_torch.obs.metrics.Registry`
  and one reentrant runtime lock (instrumented under
  ``SLT_LOCK_DEBUG=1``);
- the replay cache (exactly-once claims, ``replay_window`` > 0) and
  :meth:`PartyRuntime.replay_lookup` / :meth:`attach_reply_body`;
- the reply-direction error-feedback ledger ``wire_ef`` of the
  compressed wire modes, and :meth:`note_wire_compression`, which folds
  the transports' byte counts into the ``wire_compression_ratio`` gauge;
- :meth:`_check_batch_rows`, the shape check of an incoming batch;
- the shared health/metrics folds and :meth:`close`.

What waits, raising ``NotImplementedError`` naming its ROADMAP item: a
device mesh (item 18), checkpoint resume and the runtime-extras sidecar
(item 13), the deferred-apply queue of the decoupled backward (item 14)
and multi-tenant admission (item 14).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs.metrics import Registry
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.utils.config import Config


class ProtocolError(RuntimeError):
    """Permanent protocol violation (mode mismatch, step replay, a
    malformed batch). ``status`` carries the HTTP status a wire transport
    maps it to: 400 = a request the server cannot take, 409 =
    handshake/state conflict."""

    def __init__(self, message: str, status: int = 409) -> None:
        super().__init__(message)
        self.status = status


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an argument or op of the JAX runtime that the port does
    not run yet raises."""
    return NotImplementedError(f"not ported yet: {what} (ROADMAP {item})")


class PartyRuntime:
    """Base class: one party's shared runtime machinery. Subclasses own
    their protocol ops. Thread-safe under ``self._lock`` (reentrant)."""

    def __init__(self, cfg: Config, *, party: str, lock_name: str,
                 mesh: Optional[Any] = None,
                 replay_window: int = 8,
                 tenants: int = 1,
                 quota: Optional[Any] = None,
                 slo_ms: Optional[Any] = None,
                 ef_mode: str = "topk8") -> None:
        if mesh is not None:
            raise not_ported("a sharded party (mesh)", "item 18")
        if tenants > 1 or quota is not None or slo_ms is not None:
            raise not_ported("multi-tenant admission (tenants, quota, "
                             "slo_ms)", "item 14")
        self.cfg = cfg
        self.party = str(party)
        self._metrics = Registry()
        self._lock = obs_locks.make_lock(lock_name, registry=self._metrics)
        # exactly-once within a window: applied replies are cached and
        # replayed verbatim to duplicate deliveries; below the window the
        # strict-step 409 still holds
        self.replay: Optional[ReplayCache] = (
            ReplayCache(window=replay_window) if replay_window > 0
            else None)
        # reply-direction error feedback for the compressed wire modes,
        # keyed (client_id, op) by the transports; "clapping" is the
        # storage-free ledger (same selection, nothing exported)
        self.ef_mode = str(ef_mode)
        self.wire_ef = codec.make_wire_ef(self.ef_mode)
        self._wire_totals = [0, 0]  # raw, wire: behind the ratio gauge
        self._t_start = time.monotonic()

    def _check_batch_rows(self, rows: int, label_rows: int) -> None:
        """An incoming batch needs rows, and one label per row: anything
        else is a malformed request (400), not a transient failure."""
        if rows < 1 or rows != label_rows:
            raise ProtocolError(
                f"batch of {rows} activation rows and {label_rows} labels; "
                "send at least one row and one label per row", status=400)

    # -- not ported yet ------------------------------------------------- #
    def resume_from(self, state: Any, step: int,
                    extras: Optional[Dict[str, Any]] = None) -> None:
        raise not_ported("checkpoint resume", "item 13")

    def export_runtime_extras(self, step: int) -> Dict[str, Any]:
        raise not_ported("the runtime-extras sidecar", "item 13")

    def close(self) -> None:
        """Nothing is queued on a serialized party (no coalescer, no
        deferred applies): every reply's update landed before it was
        returned."""

    # -- wire compression + replay hooks (transports) ------------------- #
    def note_wire_compression(self, raw_bytes: int, wire_bytes: int) -> None:
        """Fold one compressed exchange (logical bytes against bytes on
        the wire) into the metrics: cumulative byte counters and the
        ``wire_compression_ratio`` gauge."""
        raw_i, wire_i = int(raw_bytes), int(wire_bytes)
        with self._lock:
            self._wire_totals[0] += raw_i
            self._wire_totals[1] += wire_i
            self._metrics.incr("wire_raw_bytes", float(raw_i))
            self._metrics.incr("wire_bytes", float(wire_i))
            if self._wire_totals[1] > 0:
                self._metrics.set_gauge(
                    "wire_compression_ratio",
                    self._wire_totals[0] / self._wire_totals[1])

    def replay_lookup(self, client_id: int, op: str,
                      step: int) -> Tuple[Optional[bytes], Optional[Any]]:
        """The cached reply to a duplicate delivery: ``(body, result)``,
        both None on a miss or with replay off. Blocks on an in-flight
        entry."""
        if self.replay is None:
            return None, None
        return self.replay.lookup(client_id, op, step)

    def attach_reply_body(self, client_id: int, op: str, step: int,
                          body: bytes) -> None:
        """Pin the encoded wire reply to the step's cache entry, so a
        replay ships the original frame byte for byte."""
        if self.replay is not None:
            self.replay.attach_body(client_id, op, step, body)

    # -- shared metrics folds ------------------------------------------- #
    def _fold_shared_metrics(self, snap: Dict[str, Any]) -> None:
        snap["gauges"]["uptime_seconds"] = float(
            time.monotonic() - self._t_start)
        if self.replay is not None:
            rc = self.replay.counters()
            snap["gauges"]["replay_cache_size"] = float(
                rc.pop("replay_cache_size"))
            for k, v in rc.items():
                snap["counters"][f"{k}_total"] = float(v)


class _DeferredApply:
    """The step-ordered queue of deferred weight updates of the
    decoupled backward (2BP): not ported yet."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise not_ported("the deferred-apply queue (decouple_bwd, "
                         "apply_lag)", "item 14")
