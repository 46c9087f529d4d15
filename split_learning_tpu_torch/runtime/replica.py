"""Horizontal server replication: a replica group behind a sticky router
(counterpart of ``split_learning_tpu/runtime/replica.py``).

:class:`ReplicaGroup` owns N party runtimes (``ServerRuntime`` replicas,
or ``StageRuntime`` replicas of one chain stage) and presents the party
surface the transports, the HTTP server and the CLI speak (the ops, the
replay hooks, ``health``/``metrics``, checkpoints, ``trace_metadata``,
``on_step``/``on_reply``, ``device``), so ``LocalTransport(group)``,
``SplitHTTPServer(group)`` and the chain's wires route through it as
they do through one runtime. On one card the N replicas are N runtimes
sharing the card, each with its own parameters, all drawn from the same
init (the caller's factory builds them from one seed).

- **Sticky routing**: clients map to replicas by rendezvous (HRW)
  hashing over the routable set, on blake2b (the same picks as JAX's
  for the same ids; the builtin ``hash`` is salted): removing a replica
  moves only its clients, and a surviving replica's clients never move.
- **Liveness**: each replica has a :class:`CircuitBreaker` over its
  health probe; a replica is dead when its breaker is OPEN.
- **Failover handoff**: fence (the replica takes no new calls; its
  clients block on the handoff instead of landing elsewhere early),
  quiesce (in-flight calls drain), capture (the extras sidecar, the
  deferred 2BP queue flushed first), merge (replay entries through
  ``put`` + ``attach_body``, born resolved and never clobbering the
  successor's own; EF residuals through ``merge_state``), commit (the
  clients reroute, the fenced waiters wake). ``handoff="checkpoint"``
  sends the capture through ``write_extras``/``read_latest_extras`` on
  disk and the successors read what disk holds. A duplicate that lands
  after the handoff is served the original reply; no (client, op,
  step) is applied twice group-wide. The capture is the sidecar's host
  copy; no other device state crosses the host.
- **Statistical oneness**: ``sync_every`` group steps install the FedAvg
  mean of the live replicas' parameters in each (dense, or through
  :func:`~split_learning_tpu_torch.runtime.state.
  compressed_sync_contribution` for ``topk8``/``clapping``); a
  scale-up's newcomer adopts a live donor's parameters.

:func:`maybe_replicate` with ``n <= 1`` returns the factory's bare
runtime: no router, no group lock on the step path.

The flight recorder journals ``fl_route``, ``fl_replica_death``,
``fl_handoff_begin``/``commit`` and ``fl_scale_up``/``down``; ``metrics``
carries the ``replicas_live`` gauge.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs.metrics import Registry
from split_learning_tpu_torch.runtime import checkpoint as ckpt
from split_learning_tpu_torch.runtime.breaker import OPEN, CircuitBreaker
from split_learning_tpu_torch.runtime.state import (
    ShardedState, adopt_params, compressed_sync_contribution, fedavg_mean)
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.transport.base import TransportError

HANDOFF_MODES = ("live", "checkpoint")

# how long a fenced client waits for a handoff to commit, and how long
# the handoff waits for the dying replica's in-flight calls to drain
_HANDOFF_TIMEOUT_S = float(os.environ.get("SLT_HANDOFF_TIMEOUT_S", "30"))


def rendezvous_pick(client_id: int, replica_ids: Sequence[int]) -> int:
    """Highest-random-weight (rendezvous) hash: the replica whose
    blake2b((client, replica)) digest is largest, ties to the lower id.
    Deterministic across processes and frameworks (JAX's picks)."""
    if not replica_ids:
        raise ValueError("no live replicas to route to")
    best: Optional[Tuple[int, int]] = None
    for rid in replica_ids:
        digest = hashlib.blake2b(
            f"{int(client_id)}:{int(rid)}".encode(), digest_size=8).digest()
        weight = int.from_bytes(digest, "big")
        if best is None or (weight, -rid) > (best[0], -best[1]):
            best = (weight, rid)
    return best[1]


def _client_of(key: Any) -> Any:
    """The client id of an EF ledger key: ``(client_id, route)``."""
    return key[0] if isinstance(key, (list, tuple)) else key


class ScaleRefused(RuntimeError):
    """``remove_replica`` refused the retirement before fencing anything:
    the replica is already retired or mid-handoff, or it is the last one
    live. An error past that point is a failed scale-down, not this."""


class _ReplicaSlot:
    """Router-side bookkeeping for one replica."""

    __slots__ = ("idx", "runtime", "breaker", "alive", "routable",
                 "inflight", "drained", "handoff_done", "born_t", "dead_t")

    def __init__(self, idx: int, runtime: Any) -> None:
        self.idx = idx
        self.runtime = runtime
        self.breaker: Optional[CircuitBreaker] = None
        # alive window (group clock), for replica-seconds
        self.born_t = 0.0
        self.dead_t: Optional[float] = None
        # alive: takes new calls. routable: still its clients' rendezvous
        # target; stays True through the handoff, so fenced clients wait
        # instead of rerouting before the merged state is in place
        self.alive = True
        self.routable = True
        self.inflight = 0
        self.drained = obs_locks.make_event(f"ReplicaSlot[{idx}].drained")
        self.drained.set()
        self.handoff_done = obs_locks.make_event(
            f"ReplicaSlot[{idx}].handoff_done")


class ReplicaGroup:
    """N same-init party runtimes behind a sticky, failover-aware router;
    drops in wherever one runtime does.

    ``sync_every`` > 0 installs the FedAvg mean of the live replicas'
    parameters every that many group steps (``sync_compress`` ``topk8``
    or ``clapping`` sends each replica's drift from the last mean through
    the codec at ``sync_density``). ``handoff`` is ``"live"`` (the
    capture in memory) or ``"checkpoint"`` (through the durable sidecar
    under ``ckpt_dir``, a temporary directory when None)."""

    def __init__(self, replicas: Sequence[Any], sync_every: int = 0,
                 handoff: str = "live",
                 ckpt_dir: Optional[str] = None,
                 failure_threshold: int = 3,
                 seed: int = 0,
                 sync_compress: Optional[str] = None,
                 sync_density: float = 0.1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not replicas:
            raise ValueError("ReplicaGroup needs at least one replica")
        if handoff not in HANDOFF_MODES:
            raise ValueError(
                f"handoff must be one of {HANDOFF_MODES} (got {handoff!r})")
        if sync_compress not in (None, "topk8", "clapping"):
            raise ValueError(f"unknown sync compression {sync_compress!r}")
        self.replicas: List[Any] = list(replicas)
        self.sync_every = int(sync_every)
        self.handoff_mode = handoff
        self._ckpt_dir = ckpt_dir
        self._clock = clock
        self._failure_threshold = int(failure_threshold)
        self._seed = int(seed)
        self._slots = [_ReplicaSlot(i, r)
                       for i, r in enumerate(self.replicas)]
        for slot in self._slots:
            slot.born_t = self._clock()
            slot.breaker = self._make_breaker(slot.idx)
        self._lock = obs_locks.make_lock("ReplicaGroup._lock")
        # membership changes (add, remove, a breaker's death declaration)
        # serialise here, outside _lock: the order is _scale_lock, _lock
        self._scale_lock = obs_locks.make_lock("ReplicaGroup._scale_lock")
        self._route_cache: Dict[int, int] = {}
        self.registry = Registry()
        self._counters: Dict[str, float] = {
            "replica_routes": 0.0, "replica_reroutes": 0.0,
            "replica_deaths": 0.0, "replica_handoffs": 0.0,
            "handoff_replay_entries": 0.0, "handoff_ef_entries": 0.0,
            "handoff_deferred_flushed": 0.0, "replica_syncs": 0.0,
            "replica_fenced_waits": 0.0, "replica_scale_ups": 0.0,
            "replica_scale_downs": 0.0}
        self._steps_since_sync = 0
        self._ckpt_lineage = 0
        self.sync_compress = sync_compress
        self.sync_density = float(sync_density)
        self._sync_ef = None
        self._sync_ref = None
        if sync_compress is not None:
            self._sync_ef = codec.make_wire_ef(sync_compress)
            self._counters["sync_raw_bytes"] = 0.0
            self._counters["sync_wire_bytes"] = 0.0
        # the party hooks the CLI installs, handed to every replica
        # (newcomers too)
        self._on_step: Optional[Callable[[int], None]] = None
        self._on_reply: Optional[Callable[[int, str, int], None]] = None

    def _make_breaker(self, idx: int) -> CircuitBreaker:
        # the breaker is the liveness verdict; in-process probes are
        # free, so its backoff sleep is a no-op
        return CircuitBreaker(
            self._make_probe(idx),
            failure_threshold=self._failure_threshold,
            seed=self._seed * 1_000_003 + idx,
            sleep=lambda _s: None)

    # -- liveness --------------------------------------------------------- #
    def _make_probe(self, idx: int) -> Callable[[], Any]:
        def probe() -> Any:
            slot = self._slots[idx]
            if not slot.alive:
                raise TransportError(f"replica {idx} is down")
            return slot.runtime.health()
        return probe

    def probe(self, idx: int) -> bool:
        """One health probe through the replica's breaker; True if it
        answered. A replica whose breaker reaches OPEN is declared dead
        and failed over."""
        slot = self._slots[idx]
        try:
            slot.breaker._probe()
        except TransportError:
            slot.breaker.record_failure()
            if slot.breaker.state == OPEN and slot.routable:
                self._declare_dead(slot)
            return False
        slot.breaker.record_success()
        return True

    def check_liveness(self) -> List[int]:
        """Probe every routable replica once; the indices still live."""
        return [s.idx for s in self._slots
                if s.routable and self.probe(s.idx)]

    def kill(self, idx: int) -> None:
        """Chaos entry point: fence replica ``idx`` (its probes now fail),
        drive its breaker to OPEN through consecutive failures, and fail
        it over. Raises on the last live replica: with nowhere to hand
        off to, exactly-once cannot hold."""
        with self._lock:
            slot = self._slots[idx]
            if not slot.alive:
                return
            if sum(1 for s in self._slots if s.alive) <= 1:
                raise RuntimeError(
                    "cannot kill the last live replica (no successor to "
                    "hand its step state to)")
            slot.alive = False
        while slot.breaker.state != OPEN:
            self.probe(idx)

    def _declare_dead(self, slot: _ReplicaSlot) -> None:
        with self._scale_lock:
            with self._lock:
                if not slot.routable:
                    return
                slot.alive = False
                self._counters["replica_deaths"] += 1
                live = sum(1 for s in self._slots if s.alive)
            fl = obs_flight.get_recorder()
            if fl is not None:
                fl.record(spans.FL_REPLICA_DEATH, party="router",
                          replica=slot.idx, live=live)
            self._fail_over(slot)

    # -- failover handoff ------------------------------------------------- #
    def _fail_over(self, slot: _ReplicaSlot) -> None:
        """Quiesce, capture, merge, commit, on the thread that observed
        the death; the dead replica's fenced clients block in
        :meth:`_route` until the commit."""
        t0 = time.perf_counter()
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_HANDOFF_BEGIN, party="router",
                      replica=slot.idx)
        # alive=False already refuses new entries; every reply that
        # reached a client must be in the capture
        if not slot.drained.wait(timeout=_HANDOFF_TIMEOUT_S):
            raise TimeoutError(
                f"replica {slot.idx}: in-flight calls did not drain "
                f"within {_HANDOFF_TIMEOUT_S}s; cannot hand off safely")
        runtime = slot.runtime
        flushed = int(runtime.flush_deferred())
        step = int(runtime.health().get("step", -1))
        payload = runtime.export_runtime_extras(max(step, 0))
        if self.handoff_mode == "checkpoint":
            payload = self._durable_roundtrip(payload)
        n_replay, n_ef = self._merge_into_successors(payload)
        with self._lock:
            self._ckpt_lineage = max(self._ckpt_lineage,
                                     int(payload.get("lineage", 0)))
            # commit: only now does the dead replica stop being its
            # clients' target; they reroute onto successors that hold
            # the merged state
            slot.routable = False
            slot.dead_t = self._clock()
            stale = [cid for cid, rid in self._route_cache.items()
                     if rid == slot.idx]
            for cid in stale:
                del self._route_cache[cid]
            self._counters["replica_reroutes"] += len(stale)
            self._counters["replica_handoffs"] += 1
            self._counters["handoff_replay_entries"] += n_replay
            self._counters["handoff_ef_entries"] += n_ef
            self._counters["handoff_deferred_flushed"] += flushed
        slot.handoff_done.set()
        self.registry.observe(spans.REPLICA_HANDOFF_LATENCY,
                              time.perf_counter() - t0)
        if fl is not None:
            fl.record(spans.FL_HANDOFF_COMMIT, step=max(step, 0),
                      party="router", replica=slot.idx,
                      replay_entries=n_replay, ef_entries=n_ef,
                      rerouted=len(stale))
        runtime.close()

    def _durable_roundtrip(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """``handoff="checkpoint"``: the successors restore from what the
        durable sidecar path committed."""
        directory = self._handoff_dir()
        ckpt.write_extras(directory, payload)
        stored = ckpt.read_latest_extras(directory, step=payload["step"])
        return payload if stored is None else stored

    def _handoff_dir(self) -> str:
        if self._ckpt_dir is None:
            self._ckpt_dir = tempfile.mkdtemp(prefix="slt-handoff-")
        os.makedirs(self._ckpt_dir, exist_ok=True)
        return self._ckpt_dir

    @staticmethod
    def _put_replay(runtime: Any, recs: List[Dict[str, Any]]) -> int:
        cache = getattr(runtime, "replay", None)
        if cache is None:
            return 0
        for rec in recs:
            cid, op, st = rec["key"]
            # born resolved, first apply wins: never clobbers an entry
            # the receiver owns for this key
            cache.put(int(cid), str(op), int(st), rec.get("result"))
            body = rec.get("body")
            if body is not None:
                cache.attach_body(int(cid), str(op), int(st), bytes(body))
        return len(recs)

    def _merge_into_successors(self, payload: Dict[str, Any]
                               ) -> Tuple[int, int]:
        with self._lock:
            survivors = [s.idx for s in self._slots if s.alive]
        replay: Dict[int, list] = {}
        for rec in ckpt.decode_obj(payload.get("replay")) or []:
            target = rendezvous_pick(int(rec["key"][0]), survivors)
            replay.setdefault(target, []).append(rec)
        n_replay = sum(self._put_replay(self._slots[t].runtime, recs)
                       for t, recs in replay.items())
        # EF ledger keys are (client_id, route): each migrated stream to
        # its client's successor
        buckets: Dict[int, list] = {}
        for rec in ckpt.decode_obj(payload.get("wire_ef")) or []:
            try:
                target = rendezvous_pick(int(_client_of(rec["key"])),
                                         survivors)
            except (TypeError, ValueError):
                target = survivors[0]
            buckets.setdefault(target, []).append(rec)
        n_ef = 0
        for target, recs in buckets.items():
            ledger = getattr(self._slots[target].runtime, "wire_ef", None)
            if ledger is not None:
                n_ef += int(ledger.merge_state(recs))
        return n_replay, n_ef

    # -- sticky routing --------------------------------------------------- #
    def _route(self, client_id: int) -> _ReplicaSlot:
        """The client's replica, in-flight-counted. Blocks while its
        replica is mid-handoff and reroutes only after the commit."""
        cid = int(client_id)
        fl = obs_flight.get_recorder()
        while True:
            decision = None
            wait_on = None
            with self._lock:
                targets = [s.idx for s in self._slots if s.routable]
                idx = self._route_cache.get(cid)
                if idx is None or not self._slots[idx].routable:
                    new = rendezvous_pick(cid, targets)
                    decision = (new, idx is not None)
                    self._route_cache[cid] = new
                    self._counters["replica_routes"] += 1
                    idx = new
                slot = self._slots[idx]
                if slot.alive:
                    slot.inflight += 1
                    if slot.inflight == 1:
                        slot.drained.clear()
                else:
                    wait_on = slot.handoff_done
                    self._counters["replica_fenced_waits"] += 1
            if decision is not None and fl is not None:
                fl.record(spans.FL_ROUTE, client_id=cid, party="router",
                          replica=decision[0], reroute=decision[1])
            if wait_on is None:
                return slot
            t0 = time.perf_counter()
            if not wait_on.wait(timeout=_HANDOFF_TIMEOUT_S):
                raise TransportError(
                    f"client {cid}: replica {slot.idx} handoff did not "
                    f"commit within {_HANDOFF_TIMEOUT_S}s")
            self.registry.observe(spans.REPLICA_REROUTE_WAIT,
                                  time.perf_counter() - t0)

    def _release(self, slot: _ReplicaSlot) -> None:
        with self._lock:
            slot.inflight -= 1
            if slot.inflight == 0:
                slot.drained.set()

    def _acquire_first_live(self) -> _ReplicaSlot:
        """In-flight-counted handle on the first live replica, for calls
        that carry no client identity."""
        deadline = time.monotonic() + _HANDOFF_TIMEOUT_S
        while True:
            with self._lock:
                for slot in self._slots:
                    if slot.alive:
                        slot.inflight += 1
                        if slot.inflight == 1:
                            slot.drained.clear()
                        return slot
                pending = [s for s in self._slots
                           if s.routable and not s.alive]
            if not pending or time.monotonic() >= deadline:
                raise TransportError("no live replicas in the group")
            pending[0].handoff_done.wait(timeout=_HANDOFF_TIMEOUT_S)

    def _call(self, client_id: int, fn: Callable[[Any], Any],
              step_done: bool = False) -> Any:
        slot = self._route(client_id)
        try:
            result = fn(slot.runtime)
        finally:
            self._release(slot)
        if step_done:
            self._note_group_step()
        return result

    def _call_first_live(self, fn: Callable[[Any], Any]) -> Any:
        slot = self._acquire_first_live()
        try:
            return fn(slot.runtime)
        finally:
            self._release(slot)

    def assignment(self, client_id: int) -> int:
        """The replica ``client_id`` routes to now, without a call."""
        with self._lock:
            targets = [s.idx for s in self._slots if s.routable]
        return rendezvous_pick(int(client_id), targets)

    def live_replicas(self) -> List[int]:
        with self._lock:
            return [s.idx for s in self._slots if s.alive]

    def _first_live(self) -> Any:
        return self._slots[self.live_replicas()[0]].runtime

    # -- elastic scale operations ---------------------------------------- #
    def capacity_replicas(self) -> List[int]:
        """Live replicas whose breaker is not OPEN: what an autoscaler may
        count as serving capacity."""
        with self._lock:
            return [s.idx for s in self._slots
                    if s.alive and s.breaker is not None
                    and s.breaker.state != OPEN]

    def handoff_in_flight(self) -> bool:
        """True while a handoff is fenced but not committed."""
        with self._lock:
            return any(s.routable and not s.alive for s in self._slots)

    def route_counts(self) -> Dict[int, int]:
        """Cached client assignments per live replica (a scale-down's
        least-loaded victim)."""
        with self._lock:
            counts = {s.idx: 0 for s in self._slots if s.alive}
            for rid in self._route_cache.values():
                if rid in counts:
                    counts[rid] += 1
            return counts

    def replica_seconds(self) -> Dict[int, float]:
        """Per-replica alive seconds on the group clock."""
        now = self._clock()
        with self._lock:
            return {s.idx: max(0.0, (now if s.dead_t is None else s.dead_t)
                               - s.born_t)
                    for s in self._slots}

    def add_replica(self, factory: Callable[[int], Any]) -> int:
        """Scale-up: a replica from ``factory``, adopted by HRW routing.
        The newcomer takes a live donor's parameters, and, before it
        becomes routable, the resolved replay entries and EF streams of
        every client HRW moves to it (born resolved: a rerouted duplicate
        is served the original reply). Returns its index."""
        with self._scale_lock:
            idx = len(self._slots)
            runtime = factory(idx)
            self._install_hooks(runtime)
            slot = _ReplicaSlot(idx, runtime)
            slot.born_t = self._clock()
            slot.breaker = self._make_breaker(idx)
            with self._lock:
                targets = [s.idx for s in self._slots if s.routable]
                donors = [s for s in self._slots if s.alive]
            new_targets = targets + [idx]
            self._adopt_params(donors, runtime)
            moved_replay: list = []
            moved_ef: list = []
            for donor in donors:
                cache = getattr(donor.runtime, "replay", None)
                if cache is not None:
                    moved_replay += [
                        rec for rec in cache.export_state()
                        if rendezvous_pick(int(rec["key"][0]),
                                           new_targets) == idx]
                ledger = getattr(donor.runtime, "wire_ef", None)
                for rec in (ledger.export_state() or []) if ledger else []:
                    try:
                        if rendezvous_pick(int(_client_of(rec["key"])),
                                           new_targets) == idx:
                            moved_ef.append(rec)
                    except (TypeError, ValueError):
                        pass
            self._put_replay(runtime, moved_replay)
            ledger = getattr(runtime, "wire_ef", None)
            if ledger is not None and moved_ef:
                ledger.merge_state(moved_ef)
            with self._lock:
                self._slots.append(slot)
                self.replicas.append(runtime)
                # purge exactly the clients HRW hands the newcomer
                moved = [cid for cid in self._route_cache
                         if rendezvous_pick(cid, new_targets) == idx]
                for cid in moved:
                    del self._route_cache[cid]
                self._counters["replica_scale_ups"] += 1
                live = sum(1 for s in self._slots if s.alive)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_SCALE_UP, party="router", replica=idx,
                      live=live, adopted_replay=len(moved_replay),
                      adopted_ef=len(moved_ef), rerouted=len(moved))
        return idx

    @staticmethod
    def _adopt_params(donors: List[_ReplicaSlot], runtime: Any) -> None:
        # a fresh-init newcomer would drag the FedAvg mean back toward
        # the init: it adopts the first live donor's parameters (a device
        # copy, taken under the donor's lock: its steps update in place)
        if getattr(runtime, "state", None) is None or not donors:
            return
        donor = donors[0].runtime
        if getattr(donor, "state", None) is None:
            return
        with donor._lock, runtime._lock:
            adopt_params(runtime.state, donor.state.params, runtime.device)

    def remove_replica(self, idx: int) -> None:
        """Scale-down: retire replica ``idx`` through the failover
        handoff, driven by policy instead of death (no
        ``replica_deaths``). Refuses the last live replica and one
        already fenced or retired."""
        with self._scale_lock:
            with self._lock:
                slot = self._slots[idx]
                if not slot.routable:
                    raise ScaleRefused(f"replica {idx} is already retired")
                if not slot.alive:
                    raise ScaleRefused(
                        f"replica {idx} is mid-handoff; scale-down must "
                        "not race it")
                if sum(1 for s in self._slots if s.alive) <= 1:
                    raise ScaleRefused(
                        "cannot scale down the last live replica (no "
                        "successor to hand its step state to)")
                slot.alive = False
                self._counters["replica_scale_downs"] += 1
            self._fail_over(slot)
            with self._lock:
                live = sum(1 for s in self._slots if s.alive)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_SCALE_DOWN, party="router", replica=idx,
                      live=live)

    # -- what the replicas share ----------------------------------------- #
    @property
    def stage_index(self) -> Any:
        return getattr(self._slots[0].runtime, "stage_index", None)

    @property
    def plan(self) -> Any:
        return getattr(self._slots[0].runtime, "plan", None)

    @property
    def cfg(self) -> Any:
        return self._slots[0].runtime.cfg

    @property
    def mode(self) -> Any:
        return getattr(self._slots[0].runtime, "mode", None)

    @property
    def party(self) -> str:
        return self._slots[0].runtime.party

    @property
    def device(self) -> Optional[torch.device]:
        """Where the replicas compute (one card, or the CPU)."""
        return getattr(self._slots[0].runtime, "device", None)

    @property
    def server_stage(self) -> Any:
        return getattr(self._slots[0].runtime, "server_stage", None)

    @property
    def params(self) -> Any:
        """The first live replica's parameters (after a sync, every live
        replica's)."""
        return self._first_live().params

    # -- the hooks the CLI installs, on every replica --------------------- #
    def _install_hooks(self, runtime: Any) -> None:
        if hasattr(runtime, "on_step"):
            runtime.on_step = self._on_step
        runtime.on_reply = self._on_reply

    @property
    def on_step(self) -> Optional[Callable[[int], None]]:
        return self._on_step

    @on_step.setter
    def on_step(self, fn: Optional[Callable[[int], None]]) -> None:
        self._on_step = fn
        for r in self.replicas:
            self._install_hooks(r)

    @property
    def on_reply(self) -> Optional[Callable[[int, str, int], None]]:
        return self._on_reply

    @on_reply.setter
    def on_reply(self, fn: Optional[Callable[[int, str, int], None]]
                 ) -> None:
        self._on_reply = fn
        for r in self.replicas:
            self._install_hooks(r)

    # -- the party surface ------------------------------------------------ #
    def split_step(self, activations: Any, labels: Any, step: int,
                   client_id: int = 0) -> Tuple[Any, float]:
        return self._call(client_id, lambda r: r.split_step(
            activations, labels, step, client_id), step_done=True)

    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        return self._call(client_id, lambda r: r.u_forward(
            activations, step, client_id))

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        return self._call(client_id, lambda r: r.u_backward(
            feat_grads, step, client_id), step_done=True)

    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0, *, device: bool = False) -> Any:
        return self._call(client_id, lambda r: r.hop_forward(
            x, step, mb, client_id, device=device))

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0, *, device: bool = False) -> Any:
        # a middle stage's microbatch backward is its unit of group
        # progress (M a step): the sync cadence ticks on it
        return self._call(client_id, lambda r: r.hop_backward(
            g_out, step, mb, client_id, device=device), step_done=True)

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0, *,
                 device: bool = False) -> Tuple[Any, Any]:
        return self._call(client_id, lambda r: r.hop_loss(
            x, labels, step, mb, client_id, device=device), step_done=True)

    def predict(self, activations: Any, client_id: int = 0) -> Any:
        return self._call(client_id,
                          lambda r: r.predict(activations, client_id))

    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        # no client identity on this op: the first live replica (the
        # group replicates the split serve path)
        return self._call_first_live(lambda r: r.aggregate(
            params, epoch, loss, step, num_examples))

    def replay_lookup(self, client_id: int, op: str,
                      step: int) -> Tuple[Optional[bytes], Optional[Any]]:
        return self._call(client_id,
                          lambda r: r.replay_lookup(client_id, op, step))

    def attach_reply_body(self, client_id: int, op: str, step: int,
                          body: bytes) -> None:
        self._call(client_id, lambda r: r.attach_reply_body(
            client_id, op, step, body))

    def note_wire_compression(self, raw_bytes: int, wire_bytes: int) -> None:
        self._call_first_live(
            lambda r: r.note_wire_compression(raw_bytes, wire_bytes))

    def health(self) -> Dict[str, Any]:
        """The first live replica's health, group-summed coalescing
        counters and the ``replicas`` block (JAX's keys: ``n``, ``live``,
        ``handoff``, ``sync_every``, ``step_max`` and the router's
        counters)."""
        live = self.live_replicas()
        info = dict(self._slots[live[0]].runtime.health())
        coalescing: Dict[str, Any] = {}
        step_max = -1
        for idx in live:
            sub_health = self._slots[idx].runtime.health()
            # the trained state may sit on any live replica: the group's
            # step is the furthest one
            step_max = max(step_max, int(sub_health.get("step", -1)))
            for k, v in (sub_health.get("coalescing") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    coalescing[k] = coalescing.get(k, 0) + v
                else:
                    coalescing.setdefault(k, v)
        if coalescing:
            info["coalescing"] = coalescing
        info["replicas"] = {
            "n": len(self._slots), "live": live,
            "handoff": self.handoff_mode,
            "sync_every": self.sync_every,
            "step_max": step_max,
            **self.counters()}
        return info

    def metrics(self) -> Dict[str, Any]:
        """The group registry (reroute/handoff histograms, router
        counters, ``replicas_live``) with every live replica's counters
        summed and broken out as ``labeled`` series with a ``replica``
        label, and the replicas' histograms summed (the telemetry ring's
        window percentiles read the group's tails)."""
        snap = self.registry.snapshot()
        for name, value in self.counters().items():
            snap["counters"][f"{name}_total"] = float(value)
        live = self.live_replicas()
        snap.setdefault("gauges", {})[spans.REPLICAS_LIVE] = float(len(live))
        labeled = snap.setdefault("labeled", [])
        hists = snap.setdefault("histograms", {})
        for idx in live:
            sub = self._slots[idx].runtime.metrics()
            for k, v in sub.get("counters", {}).items():
                snap["counters"][k] = snap["counters"].get(k, 0.0) + v
                labeled.append({"name": k, "type": "counter",
                                "labels": {"replica": str(idx)},
                                "value": float(v)})
            for k, v in sub.get("gauges", {}).items():
                labeled.append({"name": k, "type": "gauge",
                                "labels": {"replica": str(idx)},
                                "value": float(v)})
            for k, h in sub.get("histograms", {}).items():
                have = hists.get(k)
                if have is None:
                    hists[k] = {"buckets": h.get("buckets"),
                                "cumulative": list(h.get("cumulative", [])),
                                "sum": float(h.get("sum", 0.0)),
                                "count": int(h.get("count", 0))}
                elif len(have.get("cumulative", [])) == len(
                        h.get("cumulative", [])):
                    have["cumulative"] = [
                        a + b for a, b in zip(have["cumulative"],
                                              h["cumulative"])]
                    have["sum"] = float(have["sum"]) + float(
                        h.get("sum", 0.0))
                    have["count"] = int(have["count"]) + int(
                        h.get("count", 0))
        return snap

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def flush_deferred(self) -> int:
        return sum(self._slots[i].runtime.flush_deferred()
                   for i in self.live_replicas())

    def export_state(self) -> Any:
        """The group's model state: the live replicas synced first (one
        parameter set), then the first live replica's caught-up state."""
        self.sync_now()
        return self._first_live().export_state()

    def export_runtime_extras(self, step: int) -> Dict[str, Any]:
        """One group-wide sidecar: every live replica's resolved replay
        entries and EF residuals (client streams are disjoint under
        sticky routing), lineage monotonic across the group."""
        replay: list = []
        wire_ef: list = []
        for idx in self.live_replicas():
            sub = self._slots[idx].runtime.export_runtime_extras(step)
            replay.extend(ckpt.decode_obj(sub.get("replay")) or [])
            wire_ef.extend(ckpt.decode_obj(sub.get("wire_ef")) or [])
            with self._lock:
                self._ckpt_lineage = max(self._ckpt_lineage,
                                         int(sub.get("lineage", 0)))
        with self._lock:
            self._ckpt_lineage += 1
            lineage = self._ckpt_lineage
        # clapping replicas contribute no EF records: the key is omitted
        return ckpt.build_extras(step, lineage, replay=replay,
                                 wire_ef=(wire_ef or None))

    def capture_runtime_extras(self, step: int
                               ) -> Callable[[], Dict[str, Any]]:
        """The checkpointer's form of :meth:`export_runtime_extras`."""
        payload = self.export_runtime_extras(step)
        return lambda: payload

    def resume_from(self, state: Any, step: int,
                    extras: Optional[Dict[str, Any]] = None) -> None:
        """Restore every live replica from one checkpoint: one state for
        all, the whole sidecar into each (a duplicate is served from
        cache wherever its client routes)."""
        for idx in self.live_replicas():
            self._slots[idx].runtime.resume_from(state, step, extras)
        if extras is not None:
            with self._lock:
                self._ckpt_lineage = max(self._ckpt_lineage,
                                         int(extras.get("lineage", 0)))

    def trace_metadata(self) -> Dict[str, Any]:
        """The MFU sidecar over the live replicas: each program's calls,
        model FLOPs and traced seconds summed (the replicas share one
        card, so the group's rate is the card's)."""
        from split_learning_tpu_torch.utils.flops import mfu
        live = self.live_replicas()
        metas = [self._slots[i].runtime.trace_metadata() for i in live]
        out = dict(metas[0])
        peak = out.get("peak_flops_per_device")
        programs: Dict[str, Dict[str, Any]] = {}
        for meta in metas:
            for name, p in meta.get("programs", {}).items():
                acc = programs.setdefault(name, {
                    "calls": 0, "model_flops": 0.0, "dispatch_s": 0.0})
                acc["calls"] += p["calls"]
                acc["model_flops"] += p["model_flops"]
                acc["dispatch_s"] += p["dispatch_s"]
        for acc in programs.values():
            secs = acc["dispatch_s"]
            rate = acc["model_flops"] / secs if secs > 0 else None
            acc["model_flops_per_sec"] = rate
            acc["mfu"] = mfu(rate, peak) if (peak and rate) else None
        out["programs"] = programs
        out["replicas"] = len(live)
        return out

    def close(self) -> None:
        # drain, don't drop: a fenced handoff still owns state its
        # successors need
        with self._lock:
            pending = [s for s in self._slots
                       if s.routable and not s.alive]
        for slot in pending:
            slot.handoff_done.wait(timeout=_HANDOFF_TIMEOUT_S)
        for slot in self._slots:
            if slot.alive:
                slot.runtime.close()

    # -- FedAvg replica sync ---------------------------------------------- #
    def _note_group_step(self) -> None:
        if self.sync_every <= 0:
            return
        with self._lock:
            self._steps_since_sync += 1
            due = self._steps_since_sync >= self.sync_every
            if due:
                self._steps_since_sync = 0
        if due:
            self.sync_now()

    @staticmethod
    def _caught_up_params(runtime: Any) -> Tuple[Dict[str, torch.Tensor],
                                                 ...]:
        # export_state flushes the deferred applies; the copy is taken
        # under the replica's lock, since its steps update in place
        with runtime._lock:
            state = runtime.export_state()
            if isinstance(state, ShardedState):
                # a sharded replica's whole leaves, gathered to the host
                return state.whole().params
            with torch.no_grad():
                return tuple({k: v.detach().clone() for k, v in st.items()}
                             for st in state.params)

    def sync_now(self) -> int:
        """Install the FedAvg mean of the live replicas' parameters into
        each of them (parameters only; optimizer moments stay local, as
        FedAvg's). One live replica is left as it is, so a one-replica
        group stays bit-identical to the bare runtime. Returns the number
        of replicas synced."""
        live = self.live_replicas()
        runtimes = [self._slots[i].runtime for i in live]
        if len(runtimes) <= 1:
            with self._lock:
                self._counters["replica_syncs"] += 1
            return len(runtimes)
        params = [self._caught_up_params(r) for r in runtimes]
        if self._sync_ef is not None and self._sync_ref is not None:
            # each replica sends ref + topk8(drift); the EF ledger repays
            # the dropped drift at the next sync. The first round is
            # dense (no reference yet)
            contribs = []
            raw_b = wire_b = 0
            for slot_idx, p in zip(live, params):
                # keyed by slot: a death never bleeds one replica's
                # residuals into another's
                rec, rb, wb = compressed_sync_contribution(
                    self._sync_ef, f"sync_replica{slot_idx}", p,
                    self._sync_ref, self.sync_density)
                raw_b += rb
                wire_b += wb
                contribs.append(rec)
            mean = fedavg_mean(contribs)
            raw_f, wire_f = float(raw_b), float(wire_b)
            with self._lock:
                self._counters["sync_raw_bytes"] += raw_f
                self._counters["sync_wire_bytes"] += wire_f
        else:
            mean = fedavg_mean(params)
        if self._sync_ef is not None:
            self._sync_ref = mean
        for r in runtimes:
            with r._lock:
                # a copy per replica: each updates its own in place
                adopt_params(r.state, mean, r.device)
        with self._lock:
            self._counters["replica_syncs"] += 1
        return len(runtimes)


def maybe_replicate(factory: Callable[[int], Any], n: int,
                    sync_every: int = 0, handoff: str = "live",
                    ckpt_dir: Optional[str] = None,
                    seed: int = 0,
                    sync_compress: Optional[str] = None,
                    sync_density: float = 0.1,
                    min_replicas: Optional[int] = None) -> Any:
    """``n <= 1``: ``factory(0)`` bare (no router, no group lock on the
    step path). ``n > 1``: ``n`` replicas from ``factory`` (same init per
    index) behind a :class:`ReplicaGroup`. ``min_replicas`` (an elastic
    run's floor) always gives a group, of ``max(n, min_replicas)``: the
    autoscaler adds and removes through its router."""
    if min_replicas is not None:
        n = max(int(n), int(min_replicas))
    elif n <= 1:
        return factory(0)
    return ReplicaGroup([factory(i) for i in range(n)],
                        sync_every=sync_every, handoff=handoff,
                        ckpt_dir=ckpt_dir, seed=seed,
                        sync_compress=sync_compress,
                        sync_density=sync_density)
