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
- checkpoints, as in JAX: :meth:`PartyRuntime.export_state` (the
  caught-up state), :meth:`PartyRuntime.export_runtime_extras` (the
  checksummed sidecar with the replay cache and the ``wire_ef`` ledger,
  under a monotonic lineage counter) and :meth:`PartyRuntime.resume_from`
  (adopt a restored state; a valid sidecar of the restored step
  repopulates the cache and the ledger, anything else clears both);
- the two protocol hooks a resume calls, which each party fills in:
  :meth:`_reset_protocol_state` (re-arm the handshake, drop residuals;
  the server's also drops the U-shaped residuals) and
  :meth:`_post_resume_hook` (the federated server restarts its FedAvg
  round);
- ``on_reply(client_id, op, step)``, called once a step's wire reply is
  pinned to its replay entry (:meth:`attach_reply_body`): the point
  where ``serve`` checkpoints, so the sidecar of a save holds the reply
  of the step it follows and a retry of that step after a restart gets
  the original frame;
- the shared health/metrics folds and :meth:`close`.

The protocol ops themselves (the split step, the U-shaped hops,
FedAvg) live on ``ServerRuntime`` (``runtime/server.py``). What waits,
raising ``NotImplementedError`` naming its ROADMAP item: a device mesh
(item 18), the deferred-apply queue of the decoupled backward (item 14)
and multi-tenant admission (item 14).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs.metrics import Registry
from split_learning_tpu_torch.runtime import checkpoint as ckpt
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.state import (
    TrainState, restore_state, state_tree)
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.transport.base import not_ported  # noqa: F401
from split_learning_tpu_torch.utils.config import Config


class ProtocolError(RuntimeError):
    """Permanent protocol violation (mode mismatch, step replay, a
    malformed batch). ``status`` carries the HTTP status a wire transport
    maps it to: 400 = a request the server cannot take, 409 =
    handshake/state conflict."""

    def __init__(self, message: str, status: int = 409) -> None:
        super().__init__(message)
        self.status = status


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
        self.state: Optional[TrainState] = None
        self._ckpt_lineage = 0  # the sidecar's monotonic commit counter
        self.on_reply: Optional[Callable[[int, str, int], None]] = None

    def _check_batch_rows(self, rows: int, label_rows: int) -> None:
        """An incoming batch needs rows, and one label per row: anything
        else is a malformed request (400), not a transient failure."""
        if rows < 1 or rows != label_rows:
            raise ProtocolError(
                f"batch of {rows} activation rows and {label_rows} labels; "
                "send at least one row and one label per row", status=400)

    # -- protocol hooks (a resume calls them under the lock) ------------ #
    def _reset_protocol_state(self, step: int) -> None:
        """Re-arm the party's handshake floor so the next accepted op is
        ``step`` or later, and drop pre-restore residuals."""
        raise NotImplementedError

    def _post_resume_hook(self) -> None:
        """Reset any protocol machinery beyond the shared pieces."""

    # -- checkpoints ------------------------------------------------------ #
    def export_state(self) -> TrainState:
        """The state to checkpoint. Every reply's update landed before
        the reply left (no deferred applies are ported), so this is
        ``self.state``: live tensors, which the checkpointer snapshots."""
        with self._lock:
            return self.state

    def capture_runtime_extras(self, step: int
                               ) -> Callable[[], Dict[str, Any]]:
        """The sidecar of ``step`` as of now, built later: the replay
        cache's resolved entries and the ``wire_ef`` ledger are taken
        (by reference: entries and residuals are replaced, never updated
        in place) and a lineage number assigned under the lock; the
        returned callable encodes and checksums them (host copies, base64)
        off it, on the checkpointer's writer thread."""
        with self._lock:
            self._ckpt_lineage += 1
            lineage = self._ckpt_lineage
            replay = (self.replay.export_state()
                      if self.replay is not None else None)
            # clapping exports [] -> key omitted: a storage-free party
            # checkpoints no ledger
            wire_ef = self.wire_ef.export_state() or None
        return lambda: ckpt.build_extras(step, lineage, replay=replay,
                                         wire_ef=wire_ef)

    def export_runtime_extras(self, step: int) -> Dict[str, Any]:
        """Checksummed sidecar payload (JAX's): the runtime state the
        step tree does not carry, the replay cache (so post-restart
        duplicates are served the pre-crash replies bit-identically) and
        the topk8 EF residual ledger."""
        return self.capture_runtime_extras(step)()

    def checkpoint(self, ckptr: Any, step: int, key: str = "server"
                   ) -> bool:
        """Save ``{key: state}`` at ``step`` with its sidecar, both
        captured under the lock: the on-card snapshot of the state is
        what the lock is held for, the write happens off it
        (``Checkpointer.save_once``). Returns whether a save was made."""
        with self._lock:
            return ckptr.save_once(step, {key: state_tree(self.state)},
                                   extras=self.capture_runtime_extras(step))

    def resume_from(self, state: Any, step: int,
                    extras: Optional[Dict[str, Any]] = None) -> None:
        """Adopt a restored state (a ``TrainState``, or a
        :func:`~split_learning_tpu_torch.runtime.state.state_tree`) and
        re-arm the handshake so the next client op must be at ``step`` or
        later.

        ``extras`` is the runtime-extras sidecar (read back through
        ``checkpoint.read_latest_extras``): when present, valid and
        stamped with this exact ``step``, the replay cache and the EF
        residuals are restored from it, and a client retrying its
        in-flight step against the recovered party is served the
        pre-crash reply instead of a 409. Anything else (no sidecar, a
        torn file, a stale step) clears the cache and resets the
        residuals."""
        use_extras = (extras is not None and ckpt.extras_valid(extras)
                      and extras["step"] == int(step))
        with self._lock:
            if state is not self.state:
                restore_state(self.state, state if isinstance(state, dict)
                              else state_tree(state))
            self._reset_protocol_state(int(step))
            # replies of the pre-restore lineage must not be replayable
            # into the restored one, unless the sidecar carries this
            # step's own cache
            if self.replay is not None:
                if use_extras and "replay" in extras:
                    self.replay.restore_state(
                        ckpt.decode_obj(extras["replay"]))
                else:
                    self.replay.clear()
            # error-feedback residuals describe the pre-restore stream:
            # restore them only from a matching sidecar
            if use_extras and "wire_ef" in extras:
                self.wire_ef.restore_state(ckpt.decode_obj(extras["wire_ef"]))
            else:
                self.wire_ef.reset()
            if use_extras:
                # later exports stay monotonic past the restored sidecar
                self._ckpt_lineage = max(self._ckpt_lineage,
                                         int(extras["lineage"]))
            self._post_resume_hook()

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
        replay ships the original frame byte for byte; then the
        ``on_reply`` hook."""
        if self.replay is not None:
            self.replay.attach_body(client_id, op, step, body)
        if self.on_reply is not None:
            self.on_reply(client_id, op, step)

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
