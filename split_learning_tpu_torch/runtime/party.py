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
- multi-tenant admission (``tenants``, ``quota``, ``slo_ms``): an
  :class:`~split_learning_tpu_torch.runtime.admission.AdmissionController`,
  built only when a knob is set;
- the deferred-apply queue of the decoupled backward (2BP),
  :class:`_DeferredApply`, which a decoupled server installs, and the
  barriers that flush it before the state is read:
  :meth:`flush_deferred`, :meth:`export_state`, :meth:`checkpoint` (and
  the sidecar's capture) and :meth:`close`; :meth:`resume_from` drops it
  instead (its entries are gradients of the pre-restore lineage);
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
- the shared health/metrics folds and :meth:`close`;
- the dispatch watchdog's tracker (``obs/dispatch_debug.py``, None
  unless on), whose gauges join :meth:`_fold_shared_metrics`;
- observability, as in JAX: the flight events of the shared machinery
  (checkpoint capture and lineage, close, deferred enqueue and flush)
  and, while tracing is on, the per-program FLOP accounting
  (:meth:`_note_flops`) behind :meth:`trace_metadata`, the MFU sidecar
  of the party's Chrome trace.

- the mesh (``mesh=``), as in JAX: a mesh of one device is ``None``,
  so the unsharded path runs bit for bit; a federated party refuses one
  (``ValueError``). :meth:`_new_state` lays the state out by the
  party's :class:`~split_learning_tpu_torch.parallel.distributed.
  SpecLayout` (weights by the ``model`` rule, a copy per ``data`` row:
  :class:`~split_learning_tpu_torch.runtime.state.ShardedState`, whose
  ops scatter a batch over the ``data`` rows and each row over its
  ``model`` ranks); :meth:`_to_dev` puts a batch where the scatter
  starts, the first row's first rank; :meth:`_check_batch_rows` refuses
  (400) a serialized batch that does not tile ``data``;
  :meth:`_host_gather` is the one device-to-host read of a meshed
  output, trimmed to the rows asked for, counting ``gather_bytes`` and
  journalling ``FL_GATHER`` on a mesh only; ``mesh_axes`` goes into
  /health, the metrics gauges and :meth:`trace_metadata`, whose MFU
  counts the mesh's devices; :meth:`resume_from` lays a restored tree
  (whole leaves, from any mesh or none) out on this party's mesh.

The protocol ops themselves (the split step, the U-shaped hops,
FedAvg) live on ``ServerRuntime`` (``runtime/server.py``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs.metrics import Registry
from split_learning_tpu_torch.parallel.distributed import (
    SpecLayout, server_state_layout)
from split_learning_tpu_torch.parallel.mesh import host_gather
from split_learning_tpu_torch.runtime import checkpoint as ckpt
from split_learning_tpu_torch.runtime.admission import AdmissionController
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.state import (
    ShardedState, TrainState, init_params, make_state, restore_state,
    state_tree)
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.utils.arrays import from_host, to_host
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


def rows_of(x: Any) -> int:
    """The leading dimension of a numpy array or a tensor (0 for a
    scalar)."""
    shape = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) \
        else tuple(x.shape)
    return int(shape[0]) if shape else 0


def mesh_axes(mesh: Optional[Any]) -> Dict[str, int]:
    """``{"devices": n, axis: size, ...}``, the form /health, /metrics
    and :meth:`PartyRuntime.trace_metadata` describe a mesh in (JAX's);
    without a mesh the one-device layout."""
    if mesh is None:
        return {"devices": 1, "data": 1}
    return {"devices": int(mesh.size),
            **{str(k): int(v) for k, v in mesh.shape.items()}}


def reply_like(value: Any, request: Any) -> Any:
    """``value`` in the kind of ``request``: numpy for a numpy request, a
    tensor on the request's device otherwise."""
    if not isinstance(value, torch.Tensor):
        return value  # already on the host
    if isinstance(request, torch.Tensor):
        return value.to(request.device)
    return to_host(value)


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
        # a one-device mesh is the unsharded layout: never branch on it
        if mesh is not None and mesh.size <= 1:
            mesh = None
        if mesh is not None and cfg.mode == "federated":
            raise ValueError(
                "mesh sharding applies to the jitted split/u_split server "
                "stage; the federated server holds plain param trees")
        self._mesh = mesh
        self._layout: Optional[SpecLayout] = (
            server_state_layout(mesh) if mesh is not None else None)
        self._mesh_data = (self._layout.data if self._layout is not None
                           else 1)
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
        # the admission layer: built only when a knob is set, so other
        # parties pay nothing
        self._admission: Optional[AdmissionController] = None
        if tenants > 1 or quota is not None or slo_ms is not None:
            self._admission = AdmissionController(
                tenants=tenants, quota=quota, slo_ms=slo_ms)
        # the deferred-apply queue (2BP): a decoupled server installs
        # one; None makes every barrier below a no-op
        self._deferred: Optional[_DeferredApply] = None
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
        # traced-only MFU accounting: model FLOPs per (program, shapes),
        # counted once; per program [flops, seconds, calls]
        self._flops_cache: Dict[Tuple[Any, ...], float] = {}
        self._prog_stats: Dict[str, list] = {}
        # the card's traced windows whose events are not read yet
        self._windows: list = []
        # dispatch watchdog: None unless SLT_DISPATCH_DEBUG / force()
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()
        # the synthetic transfer cost of every host read (a server sets
        # it, see ServerRuntime); 0 is no cost and no code on the path
        self._d2h_delay_s = 0.0
        self._d2h_single = False

    def _place(self, device: DeviceLike) -> torch.device:
        """The party's ``device``: on a mesh its first rank's (every rank
        checked), else ``device``."""
        if self._mesh is None:
            return resolve_device(device)
        for dev in self._mesh.devices.flat:
            resolve_device(dev)
        return self._mesh.device()

    def _new_state(self, plan: Any, init: Any,
                   stages: Optional[Tuple[int, ...]] = None) -> Any:
        """The state of ``stages`` of ``plan``: on a mesh laid out by
        the party's layout (each rank takes its slices from the host, so
        none holds a whole split leaf), else on ``device``."""
        if self._mesh is None:
            return make_state(init_params(plan, init, self.device, stages),
                              self._tx)
        return ShardedState(init_params(plan, init, torch.device("cpu"),
                                        stages), self._tx, self._mesh)

    def _to_dev(self, x: Any, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """``x`` on the party's ``device``, in ``dtype`` (None: a float32
        or bfloat16 tensor keeps its dtype, another float becomes
        float32). On a mesh that is the first row's first rank, where
        the ops of the sharded state scatter it over the rows."""
        t = from_host(x) if not isinstance(x, torch.Tensor) else x.detach()
        if dtype is None:
            dtype = (t.dtype if t.dtype in (torch.float32, torch.bfloat16)
                     else torch.float32)
        return t.to(self.device, dtype)

    def _check_batch_rows(self, rows: int, label_rows: int,
                          tile: bool = True) -> None:
        """An incoming batch needs rows, and one label per row: anything
        else is a malformed request (400), not a transient failure. On a
        mesh a serialized batch (``tile``) must also tile the ``data``
        axis (a coalesced group pads instead)."""
        if rows < 1 or rows != label_rows:
            raise ProtocolError(
                f"batch of {rows} activation rows and {label_rows} labels; "
                "send at least one row and one label per row", status=400)
        if tile and self._mesh is not None and rows % self._mesh_data:
            raise ProtocolError(
                f"batch of {rows} rows cannot shard over the mesh 'data' "
                f"axis of size {self._mesh_data}; send a multiple of "
                f"{self._mesh_data} (coalesced groups pad automatically)",
                status=400)

    def _host_gather(self, x: Any, rows: Optional[int] = None
                     ) -> np.ndarray:
        """The sanctioned device-to-host read of a program's output:
        trimmed to its first ``rows`` rows on a mesh, where the bytes are
        counted (``gather_bytes``) and journalled (``FL_GATHER``); the
        plain host copy otherwise (bit for bit the unsharded reply)."""
        if isinstance(x, torch.Tensor):
            out = to_host(x[:rows] if rows is not None else x)
        else:
            out = host_gather(x, rows=rows)
        if self._mesh is None:
            return out
        self._metrics.incr(spans.GATHER_BYTES, float(out.nbytes))
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_GATHER, party=self.party,
                      nbytes=int(out.nbytes))
        return out

    def _sleep_d2h(self) -> None:
        # the synthetic transfer cost of a host read (ServerRuntime's
        # d2h_delay_s); nothing at the default 0
        if self._d2h_delay_s <= 0.0:
            return
        if not self._d2h_single:
            time.sleep(self._d2h_delay_s)
            return
        # single-channel model: reserve the next free window under the
        # leaf lock, then sleep out the reservation off it (monotonic, so
        # a wall-clock step never hands out a negative wait)
        with self._d2h_chan_lock:
            start = max(time.monotonic(), self._d2h_chan_free_at)
            end = start + self._d2h_delay_s
            self._d2h_chan_free_at = end
        while True:
            remaining = end - time.monotonic()
            if remaining <= 0.0:
                return
            time.sleep(remaining)

    def _reply_value(self, value: Any, request: Any,
                     rows: Optional[int] = None) -> Any:
        """``value`` (trimmed to ``rows``) in the kind of ``request``
        (:func:`reply_like`), a host reply through :meth:`_host_gather`."""
        if rows is not None and isinstance(value, torch.Tensor):
            value = value[:rows]
        if (self._mesh is not None and isinstance(value, torch.Tensor)
                and not isinstance(request, torch.Tensor)):
            return self._host_gather(value)
        return reply_like(value, request)

    # -- protocol hooks (a resume calls them under the lock) ------------ #
    def _reset_protocol_state(self, step: int) -> None:
        """Re-arm the party's handshake floor so the next accepted op is
        ``step`` or later, and drop pre-restore residuals."""
        raise NotImplementedError

    def _post_resume_hook(self) -> None:
        """Reset any protocol machinery beyond the shared pieces."""

    # -- barriers and checkpoints --------------------------------------- #
    def flush_deferred(self) -> int:
        """Apply every queued deferred update now, in step order, and
        return how many were applied (0 on a coupled party). For callers
        about to read the state as if training were caught up
        (``MultiClientSplitRunner.sync_bottoms``); safe from any thread
        and from under the runtime lock (reentrant)."""
        if self._deferred is None:
            return 0
        return self._deferred.flush()

    def export_state(self) -> TrainState:
        """The state to checkpoint: the deferred-apply queue is flushed
        first (a decoupled party's live state may be up to ``apply_lag``
        updates behind the replies it sent), then ``self.state``, live
        tensors, which the checkpointer snapshots."""
        with self._lock:
            if self._deferred is not None:
                self._deferred.flush()
            return self.state

    def capture_runtime_extras(self, step: int
                               ) -> Callable[[], Dict[str, Any]]:
        """The sidecar of ``step`` as of now, built later: the replay
        cache's resolved entries and the ``wire_ef`` ledger are taken
        (by reference: entries and residuals are replaced, never updated
        in place) and a lineage number assigned under the lock; the
        returned callable encodes and checksums them (host copies, base64)
        off it, on the checkpointer's writer thread. The deferred-apply
        queue is flushed first, under the same lock: the sidecar describes
        the caught-up instant the state beside it does."""
        with self._lock:
            if self._deferred is not None:
                self._deferred.flush()
            self._ckpt_lineage += 1
            lineage = self._ckpt_lineage
            replay = (self.replay.export_state()
                      if self.replay is not None else None)
            # clapping exports [] -> key omitted: a storage-free party
            # checkpoints no ledger
            wire_ef = self.wire_ef.export_state() or None
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CKPT_CAPTURE, step=int(step),
                      party=self.party, lineage=lineage)
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
            tree = {key: state_tree(self.export_state())}
            return ckptr.save_once(step, tree,
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
            if self._deferred is not None:
                # drop, not flush: the queued updates are gradients of
                # the pre-restore lineage
                self._deferred.clear()
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
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CKPT_LINEAGE, step=int(step),
                      party=self.party, use_extras=use_extras,
                      lineage=self._ckpt_lineage)

    def _close_hook(self) -> None:
        """Drain party machinery (the server's coalescer) before the
        deferred queue: its last groups queue applies of their own."""

    def close(self) -> None:
        """Drain, never drop: the replies of queued steps have left, so a
        clean shutdown lands their updates."""
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CLOSE, party=self.party)
        self._close_hook()
        if self._deferred is not None:
            self._deferred.flush()

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

    # -- traced-only MFU accounting ------------------------------------- #
    def _window_open(self) -> Any:
        """The start of a traced program's window, taken under the lock
        before its launches: a timing event on the card's stream, or the
        ``perf_counter`` reading on the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            return start
        return time.perf_counter()

    def _window_close(self, start: Any) -> Any:
        """The window's end, taken under the lock right after the
        program's launches, so work that other clients queue once the
        lock is free falls outside it: ``(start, end)`` events on the
        card (read off the step path, :meth:`_fold_windows`), the
        seconds on the CPU."""
        if isinstance(start, float):
            return time.perf_counter() - start
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        return start, end

    def _note_flops(self, name: str, fn: Callable[..., Any],
                    args: Tuple[Any, ...], window: Any) -> None:
        """Fold one traced program into :meth:`trace_metadata`: ``fn``
        is the program's pure form (forward and backward from its
        arguments, :func:`~split_learning_tpu_torch.utils.flops.
        step_flops`), counted once per (program, argument shapes) and
        outside the lock; ``window`` is :meth:`_window_close`'s. On the
        card the window is the program's device time between its two
        events (JAX's closes at the dispatch's return). Called only
        while tracing is on, off the lock."""
        from split_learning_tpu_torch.utils.flops import step_flops
        key = (name,) + tuple(
            (tuple(a.shape), str(a.dtype)) for a in args
            if isinstance(a, torch.Tensor))
        with self._lock:
            flops = self._flops_cache.get(key)
        if flops is None:
            flops = step_flops(fn, *args)
        with self._lock:
            self._flops_cache[key] = flops
            st = self._prog_stats.setdefault(name, [0.0, 0.0, 0])
            st[0] += flops
            st[2] += 1
            if isinstance(window, float):
                st[1] += window
            else:
                self._windows.append((name,) + tuple(window))
        self._fold_windows(wait=False)

    def _fold_windows(self, wait: bool) -> None:
        """Add the device time of the card's closed windows to their
        programs: those whose end event has passed, or with ``wait``
        every one (``trace_metadata``, off the step path)."""
        with self._lock:
            pending, self._windows = self._windows, []
        done, keep = [], []
        for name, start, end in pending:
            if wait:
                end.synchronize()
            (done if wait or end.query() else keep).append(
                (name, start, end))
        with self._lock:
            self._windows[:0] = keep
            for name, start, end in done:
                self._prog_stats[name][1] += start.elapsed_time(end) / 1e3

    def trace_metadata(self) -> Dict[str, Any]:
        """The MFU sidecar of ``Tracer.export_chrome(metadata=...)``, JAX's
        keys: the mesh (:func:`mesh_axes`), the bytes of the sanctioned
        gathers, the programs' model FLOPs over their traced windows, and
        the MFU against the peak of the mesh's devices where the card's
        peak is known (``None`` on the CPU, the honest answer, not a
        zero)."""
        from split_learning_tpu_torch import __version__
        from split_learning_tpu_torch.utils.flops import (
            device_peak_flops, mfu)
        peak = device_peak_flops(self.device)
        mesh_info = mesh_axes(self._mesh)
        self._fold_windows(wait=True)
        with self._lock:
            stats = {k: tuple(v) for k, v in self._prog_stats.items()}
            gather = self._metrics.snapshot()["counters"].get(
                spans.GATHER_BYTES, 0.0)
        programs = {}
        for name, (fl, secs, calls) in stats.items():
            rate = (fl / secs) if secs > 0 else None
            programs[name] = {
                "calls": calls,
                "model_flops": fl,
                "dispatch_s": secs,
                "model_flops_per_sec": rate,
                "mfu": (mfu(rate, peak * mesh_info["devices"])
                        if (peak and rate) else None),
            }
        return {"mesh": mesh_info,
                "gather_bytes": int(gather),
                "peak_flops_per_device": peak,
                "programs": programs,
                "build": {"version": __version__,
                          "uptime_seconds": time.monotonic() - self._t_start}}

    # -- shared metrics folds ------------------------------------------- #
    def _fold_shared_metrics(self, snap: Dict[str, Any]) -> None:
        snap["gauges"]["uptime_seconds"] = float(
            time.monotonic() - self._t_start)
        if self._admission is not None:
            for k, v in self._admission.counters().items():
                snap["counters"][k] = float(v)
            snap["gauges"].update(self._admission.gauges())
        if self._deferred is not None:
            dc = self._deferred.counters()
            snap["gauges"]["deferred_apply_depth"] = float(
                dc.pop("deferred_apply_depth"))
            for k, v in dc.items():
                snap["counters"][f"{k}_total"] = float(v)
        if self.replay is not None:
            rc = self.replay.counters()
            snap["gauges"]["replay_cache_size"] = float(
                rc.pop("replay_cache_size"))
            for k, v in rc.items():
                snap["counters"][f"{k}_total"] = float(v)
        if self._dd is not None:
            # the watchdog's gauges (render_prometheus prefixes slt_)
            snap["gauges"].update(self._dd.gauges())
        if self._mesh is not None:
            for k, v in mesh_axes(self._mesh).items():
                snap["gauges"][f"mesh_{k}"] = float(v)


class _DeferredApply:
    """Step-ordered queue of pending weight updates (2BP; JAX's).

    The reply path pushes one entry per dispatch (a single step or a
    whole coalesced group) in lock order, which is the order the updates
    apply in, and entries drain strictly FIFO, each through ``apply_fn``.
    Every method takes the owning runtime's (reentrant) lock: on the step
    path, where it is held, push and drain are atomic with the reply that
    produced them; from barrier callers on other threads, ``flush``
    serialises against steps in flight. An entry leaves the deque exactly
    when it is applied (popped before the apply, so a failed apply is
    never retried: its reply has left).

    ``lag`` bounds staleness: ``drain_over_lag`` (after every reply,
    under the lock) applies the oldest entries until at most ``lag``
    remain, so a forward at step t runs on weights at most ``lag``
    updates old."""

    def __init__(self, apply_fn: Callable[[Dict[str, Any]], None],
                 lag: int, lock: Any) -> None:
        self._apply = apply_fn
        self.lag = int(lag)
        self._lock = lock
        self._q: "deque[Dict[str, Any]]" = deque()
        self._enqueued = 0
        self._applied = 0
        self._flushes = 0

    def push(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._q.append(entry)
            self._enqueued += 1
            depth = len(self._q)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_DEFER_ENQ, step=entry["step"],
                      client_id=entry["client_id"], party="server",
                      kind=entry["kind"], depth=depth)

    def pending(self) -> list:
        """The queued entries, oldest first (under the caller's lock)."""
        with self._lock:
            return list(self._q)

    def drain_over_lag(self) -> int:
        """Apply the oldest entries until depth <= lag."""
        return self._drain(limit_to_lag=True)

    def flush(self) -> int:
        """Apply everything queued (the state-export barrier)."""
        return self._drain(limit_to_lag=False)

    def _drain(self, limit_to_lag: bool) -> int:
        n = 0
        with self._lock:
            floor = self.lag if limit_to_lag else 0
            while len(self._q) > floor:
                entry = self._q.popleft()
                self._apply(entry)
                self._applied += 1
                n += 1
            if n:
                self._flushes += 1
        if n:
            fl = obs_flight.get_recorder()
            if fl is not None:
                fl.record(spans.FL_DEFER_FLUSH, party="server",
                          applied=n,
                          mode=("over_lag" if limit_to_lag else "flush"))
        return n

    def clear(self) -> int:
        """Drop everything queued without applying it (``resume_from``
        only). Returns how many were dropped."""
        with self._lock:
            n = len(self._q)
            self._q.clear()
            return n

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"deferred_apply_depth": len(self._q),
                    "deferred_enqueued": self._enqueued,
                    "deferred_applied": self._applied,
                    "deferred_flushes": self._flushes}
