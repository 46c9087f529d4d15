"""Fleet-simulation harness: many cheap clients against one server or
replica group (counterpart of ``split_learning_tpu/runtime/fleet.py``).

Drives N ``LocalTransport`` clients (thread-pooled: a client here is one
pending step event, not a trainer) through deterministic per-client
arrival processes and records per-tenant p50/p99 queue wait and step
latency from the metrics histograms. Arrival processes, each seeded per
client (the same offsets as JAX's for the same seed):

- ``poisson``: exponential inter-arrivals at ``rate_hz`` per client;
- ``burst``: arrivals clump in groups of ``burst_size`` separated by
  quiet gaps (the window flusher's worst case, continuous batching's
  best);
- ``diurnal``: a slow sinusoidal modulation of the poisson rate.

Chaos composes through ``make_transport`` (a ``ChaosTransport`` around
each client's wire); ``Backpressure`` reschedules the step by its advised
delay instead of burning a retry; ``kill_replica_at`` kills one replica
of the group mid-load; an autoscaler is poked after every completed step.

``python -m split_learning_tpu_torch.runtime.fleet`` is the runnable
face, with ``scripts/fleet_sim.py``'s flags (plus ``--device``): it
builds split-CNN server replicas on the card (``--device cpu`` for the
CPU), warms them, runs the fleet and prints fleet_sim's JSON summary
(per-tenant and pooled p50/p99, dropped steps, the ``utilization``,
``replication``, ``telemetry`` and ``autoscale`` blocks).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.obs.metrics import (
    Registry, histogram_percentile)
from split_learning_tpu_torch.transport.base import (
    Backpressure, TransportError)

# cut-layer payload shape of the split CNN; the harness shares ONE
# activations/labels pair across the whole fleet: offered load is about
# arrival times and admission, not per-client data
CUT_SHAPE = (26, 26, 32)

# pooled-across-tenants histogram suffix: the fleet-level p99 the bench
# gate compares (per-tenant tails have 1/tenants the samples — noisier)
OVERALL = "overall"


@dataclasses.dataclass
class FleetConfig:
    """One fleet run: who arrives, when, and how hard."""

    n_clients: int = 64
    tenants: int = 1
    steps_per_client: int = 3
    arrival: str = "poisson"          # poisson | burst | diurnal
    rate_hz: float = 50.0             # per-client mean arrival rate
    burst_size: int = 8               # burst mode: arrivals per clump
    diurnal_period_s: float = 2.0     # diurnal mode: one "day"
    seed: int = 0
    workers: int = 16
    batch: int = 8
    # client ids are offset..offset+n_clients-1: a warmup fleet against
    # the SAME server uses a disjoint id range (offset by a multiple of
    # ``tenants``, preserving the tenant mapping) so the strict step
    # handshake never sees a step replayed across phases
    client_id_offset: int = 0
    max_retries: int = 6              # transient TransportError budget
    backpressure_budget_s: float = 30.0  # max cumulative 429 waiting/step
    trace: bool = True                # per-request server queue-wait
    # replica chaos: with a ReplicaGroup handed to the harness, kill one
    # replica after N completed fleet steps (0 = never); the failover
    # happens mid-load, under the router's fence, while the rest of the
    # fleet keeps arriving
    kill_replica_at: int = 0
    kill_replica: int = -1            # index; -1 = busiest by assignment

    def __post_init__(self) -> None:
        if self.arrival not in ("poisson", "burst", "diurnal"):
            raise ValueError(
                f"arrival must be poisson|burst|diurnal "
                f"(got {self.arrival!r})")
        if self.n_clients < 1 or self.steps_per_client < 1:
            raise ValueError("need at least one client and one step")
        if self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0 (got {self.rate_hz})")


@dataclasses.dataclass
class FleetResult:
    """What a run proves: per-tenant latency tails + integrity counters."""

    counters: Dict[str, float]
    per_tenant: Dict[int, Dict[str, float]]
    # pooled across tenants: N× the per-tenant sample count, so the p99
    # the bench gate compares isn't one tenant's single worst sample
    overall: Dict[str, float]
    losses: Dict[Tuple[int, int], float]   # (client_id, step) -> loss
    wall_s: float

    @property
    def mean_loss(self) -> float:
        return (sum(self.losses.values()) / len(self.losses)
                if self.losses else float("nan"))


def arrival_offsets(cfg: FleetConfig, client_id: int) -> List[float]:
    """The client's deterministic arrival schedule: absolute offsets (s)
    from fleet start for each of its steps. Seeded per (seed, client_id)
    so a rerun — or a chaos-wrapped twin — offers the identical load."""
    rng = random.Random(cfg.seed * 1_000_003 + client_id)
    mean_gap = 1.0 / cfg.rate_hz
    t = rng.random() * mean_gap  # desynchronized start
    out: List[float] = []
    for k in range(cfg.steps_per_client):
        out.append(t)
        if cfg.arrival == "poisson":
            t += rng.expovariate(cfg.rate_hz)
        elif cfg.arrival == "burst":
            # clump burst_size arrivals ~together, then a gap long
            # enough to keep the mean rate: worst case for a window
            # flusher, best case for continuous batching
            if (k + 1) % cfg.burst_size:
                t += mean_gap * 0.02 * rng.random()
            else:
                t += mean_gap * cfg.burst_size * (0.75 + 0.5 * rng.random())
        else:  # diurnal
            phase = 2.0 * math.pi * (t / cfg.diurnal_period_s)
            rate = cfg.rate_hz * (0.55 + 0.45 * math.sin(phase))
            t += rng.expovariate(max(rate, 1e-6))
    return out


class FleetHarness:
    """Runs one fleet against a transport factory.

    ``make_transport(client_id)`` returns the client's wire — plain
    ``LocalTransport(server)`` for a clean run, a ChaosTransport wrap
    for a faulty twin. Per-client steps are strictly sequential (the
    server's step handshake requires it); the fleet-level interleaving
    comes from the arrival schedules.
    """

    def __init__(self, cfg: FleetConfig,
                 make_transport: Callable[[int], Any],
                 group: Any = None,
                 autoscaler: Any = None) -> None:
        self.cfg = cfg
        self._make_transport = make_transport
        # the ReplicaGroup behind the transports, when the caller runs
        # one — only needed for the kill_replica_at chaos hook
        self._group = group
        # the autoscaler, when the caller runs one: poked after each
        # completed step (maybe_scale is cheap and self-throttling
        # — it evaluates at most once per telemetry window)
        self._autoscaler = autoscaler
        self._killed = False
        self._steps_done = 0
        self.registry = Registry()
        rs = np.random.RandomState(cfg.seed)
        self._acts = rs.randn(cfg.batch, *CUT_SHAPE).astype(np.float32)
        self._labels = rs.randint(0, 10, (cfg.batch,)).astype(np.int64)
        self._cond = obs_locks.make_condition("FleetHarness._cond")
        # (due, seq, client_id, step) — seq breaks due-time ties FIFO
        self._heap: List[Tuple[float, int, int, int]] = []
        self._seq = 0
        self._inflight = 0
        self._losses: Dict[Tuple[int, int], float] = {}
        off = cfg.client_id_offset
        self._schedules = {off + c: arrival_offsets(cfg, off + c)
                           for c in range(cfg.n_clients)}

    # -- scheduler ----------------------------------------------------- #
    def _push(self, due: float, client_id: int, step: int) -> None:
        with self._cond:
            heapq.heappush(self._heap, (due, self._seq, client_id, step))
            self._seq += 1
            self._cond.notify()

    def _pop_due(self) -> Optional[Tuple[int, int]]:
        """Next (client_id, step) whose due time has arrived; None when
        the fleet is drained. Waiting happens on the held condition, so
        an earlier-due push wakes us instead of oversleeping."""
        with self._cond:
            while True:
                if not self._heap and self._inflight == 0:
                    return None
                now = time.monotonic()
                if self._heap and self._heap[0][0] <= now:
                    due, _, client_id, step = heapq.heappop(self._heap)
                    self._inflight += 1
                    return client_id, step
                timeout = (min(self._heap[0][0] - now, 0.2)
                           if self._heap else 0.2)
                self._cond.wait(timeout=timeout)

    def _done_one(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    # -- one step ------------------------------------------------------ #
    def _run_step(self, transport: Any, client_id: int, step: int) -> None:
        cfg = self.cfg
        tenant = client_id % cfg.tenants
        reg = self.registry
        retries = 0
        bp_waited = 0.0
        # per-call server queue-wait: the traced transport folds the
        # server's spans into its stats as span_<name>_s counters; this
        # client's transport is driven serially by one worker, so the
        # before/after delta is exactly this step's queue wait
        qw_key = f"span_{spans.QUEUE_WAIT}_s"
        qw0 = transport.stats.counters.get(qw_key, 0.0)
        t0 = time.perf_counter()
        while True:
            try:
                _, loss = transport.split_step(
                    self._acts, self._labels, step, client_id)
                break
            except Backpressure as exc:
                reg.incr("fleet_backpressure_total")
                reg.incr(f"fleet_backpressure_t{tenant}")
                if bp_waited >= cfg.backpressure_budget_s:
                    reg.incr("fleet_dropped_steps")
                    reg.incr(f"fleet_dropped_t{tenant}")
                    return
                delay = min(max(exc.retry_after_s, 1e-3),
                            cfg.backpressure_budget_s - bp_waited)
                bp_waited += delay
                time.sleep(delay)
            except TransportError:
                retries += 1
                reg.incr("fleet_retries_total")
                if retries > cfg.max_retries:
                    reg.incr("fleet_dropped_steps")
                    reg.incr(f"fleet_dropped_t{tenant}")
                    return
        dt = time.perf_counter() - t0
        reg.observe(f"fleet_step_latency_t{tenant}", dt)
        reg.observe(f"fleet_step_latency_{OVERALL}", dt)
        reg.incr("fleet_steps_total")
        reg.incr(f"fleet_steps_t{tenant}")
        if cfg.trace:
            # server-side queue wait (enqueue -> group pickup), the
            # number continuous batching exists to shrink
            qw = transport.stats.counters.get(qw_key, 0.0) - qw0
            if qw > 0.0:
                reg.observe(f"fleet_queue_wait_t{tenant}", qw)
                reg.observe(f"fleet_queue_wait_{OVERALL}", qw)
        loss_f = float(loss)  # materialize outside the scheduler lock
        with self._cond:
            self._losses[(client_id, step)] = loss_f
        if self._group is not None and cfg.kill_replica_at > 0:
            self._maybe_kill_replica()
        if self._autoscaler is not None:
            # on this worker thread, holding no scheduler lock — a
            # scale-down's quiesce must be able to drain the other
            # workers' in-flight calls (the _maybe_kill_replica rule)
            try:
                self._autoscaler.maybe_scale()
            except Exception as exc:
                # a control-plane fault must not kill the data-plane
                # worker; the summary's count and the autoscale gate
                # make it visible
                self._autoscaler.note_error("step_hook", exc)

    def _maybe_kill_replica(self) -> None:
        """The chaos trigger: once the fleet has completed
        ``kill_replica_at`` steps, kill one replica — on this worker
        thread, holding no scheduler lock, so the handoff's quiesce can
        drain the other workers' in-flight calls."""
        with self._cond:
            self._steps_done += 1
            due = (not self._killed
                   and self._steps_done >= self.cfg.kill_replica_at)
            if due:
                self._killed = True
        if not due:
            return
        victim = self.cfg.kill_replica
        if victim < 0:
            # the busiest replica: the one most measured clients are
            # assigned to — deterministic given the rendezvous routes
            counts: Dict[int, int] = {}
            for c in self._schedules:
                r = self._group.assignment(c)
                counts[r] = counts.get(r, 0) + 1
            victim = max(sorted(counts), key=lambda r: counts[r])
        self.registry.incr("fleet_replica_kills")
        self._group.kill(victim)

    def _worker(self) -> None:
        transports: Dict[int, Any] = {}
        while True:
            item = self._pop_due()
            if item is None:
                return
            client_id, step = item
            tr = transports.get(client_id)
            if tr is None:
                # per-worker cache: LocalTransports are cheap, and
                # chaos wrappers keep their per-(path, step) attempt
                # counters coherent because a client's steps are
                # sequential (never two workers in the same step)
                tr = transports[client_id] = self._make_transport(client_id)
            try:
                self._run_step(tr, client_id, step)
            finally:
                nxt = step + 1
                if nxt < self.cfg.steps_per_client:
                    sched = self._t_start + self._schedules[client_id][nxt]
                    self._push(max(sched, time.monotonic()), client_id, nxt)
                self._done_one()

    # -- entry point --------------------------------------------------- #
    def run(self) -> FleetResult:
        cfg = self.cfg
        tracer_was_on = obs_trace.get_tracer() is not None
        if cfg.trace and not tracer_was_on:
            obs_trace.enable(
                max_spans=max(200_000,
                              cfg.n_clients * cfg.steps_per_client * 12))
        self._t_start = time.monotonic()
        for c in self._schedules:
            self._push(self._t_start + self._schedules[c][0], c, 0)
        threads = [obs_locks.make_thread(self._worker,
                                         name=f"slt-fleet-{i}", daemon=True)
                   for i in range(cfg.workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.monotonic() - self._t_start
        if cfg.trace and not tracer_was_on:
            obs_trace.disable()
        return self._result(wall)

    def _result(self, wall_s: float) -> FleetResult:
        snap = self.registry.snapshot()
        counters = dict(snap["counters"])
        counters.setdefault("fleet_steps_total", 0.0)
        counters.setdefault("fleet_dropped_steps", 0.0)
        counters.setdefault("fleet_backpressure_total", 0.0)
        per_tenant: Dict[int, Dict[str, float]] = {}
        for t in range(self.cfg.tenants):
            row: Dict[str, float] = {
                "steps": counters.get(f"fleet_steps_t{t}", 0.0),
                "dropped": counters.get(f"fleet_dropped_t{t}", 0.0),
                "backpressure": counters.get(f"fleet_backpressure_t{t}", 0.0),
            }
            for stem, label in (("fleet_step_latency", "step"),
                                ("fleet_queue_wait", "queue_wait")):
                hist = snap["histograms"].get(f"{stem}_t{t}")
                if hist:
                    row[f"{label}_p50_ms"] = (
                        histogram_percentile(hist, 50) * 1e3)
                    row[f"{label}_p99_ms"] = (
                        histogram_percentile(hist, 99) * 1e3)
            per_tenant[t] = row
        overall: Dict[str, float] = {}
        for stem, label in (("fleet_step_latency", "step"),
                            ("fleet_queue_wait", "queue_wait")):
            hist = snap["histograms"].get(f"{stem}_{OVERALL}")
            if hist:
                overall[f"{label}_p50_ms"] = (
                    histogram_percentile(hist, 50) * 1e3)
                overall[f"{label}_p99_ms"] = (
                    histogram_percentile(hist, 99) * 1e3)
        return FleetResult(counters=counters, per_tenant=per_tenant,
                           overall=overall,
                           losses=dict(self._losses), wall_s=wall_s)


def run_fleet(cfg: FleetConfig,
              make_transport: Callable[[int], Any],
              group: Any = None,
              autoscaler: Any = None) -> FleetResult:
    """One-call wrapper: build the harness, run it, return the result."""
    return FleetHarness(cfg, make_transport, group=group,
                        autoscaler=autoscaler).run()


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def warm_fleet(server: Any, make_transport: Callable[[int], Any],
               cfg: FleetConfig, max_rounds: int = 3) -> int:
    """Warm the server so a measured run sees steady-state dispatch: the
    first call of each group shape (cuDNN's algorithm search, the
    caching allocator's first blocks, the kernels' first launches) lands
    here instead of in the measured queue-wait tail.

    Shape priming is deterministic: a coalesced group's signature (the
    server's ``compile_count``) depends only on the pow2-padded *total*
    row count, so one oversized-batch request primes the shape a
    k-request group would. Every bucket a group of 1..max_group
    ``cfg.batch``-row requests can pad to gets one priming step; short
    burst fleets afterwards warm threads, transports and the replay path
    until the compile count is stable.

    Warmup clients use id ranges disjoint from (and above) the measured
    fleet's, offset by multiples of ``cfg.tenants`` to preserve the
    tenant mapping, so the strict step handshake never collides across
    phases. Returns the number of warmup rounds run (shape priming
    counts as one round)."""
    tenants = max(cfg.tenants, 1)
    # first id safely above the measured range, tenant-aligned
    base = cfg.client_id_offset + cfg.n_clients
    base += (-base) % tenants
    rounds = 0
    coalescer = getattr(server, "_coalescer", None)
    if coalescer is not None:
        rounds += 1
        buckets = sorted({_pow2(k * cfg.batch)
                          for k in range(1, coalescer.max_group + 1)})
        rs = np.random.RandomState(cfg.seed + 1)
        for i, rows in enumerate(buckets):
            acts = rs.randn(rows, *CUT_SHAPE).astype(np.float32)
            labels = rs.randint(0, 10, (rows,)).astype(np.int64)
            make_transport(base + i).split_step(acts, labels, 0, base + i)
        base += len(buckets) + (-(base + len(buckets))) % tenants
    warm_n = max(tenants * 4, 8)
    prev = None
    for round_i in range(max_rounds):
        warm_cfg = dataclasses.replace(
            cfg, n_clients=warm_n, steps_per_client=2, trace=False,
            arrival="burst", rate_hz=max(cfg.rate_hz * 8, 20.0),
            burst_size=max(cfg.burst_size, 8),
            client_id_offset=base + round_i * warm_n,
            seed=cfg.seed + 7919 * (round_i + 1))
        run_fleet(warm_cfg, make_transport)
        rounds += 1
        compiles = server.health().get("coalescing", {}).get(
            "compile_count", 0)
        if compiles == prev:
            break
        prev = compiles
    return rounds


# --------------------------------------------------------------------- #
# the runnable face: scripts/fleet_sim.py's flags and JSON summary
# --------------------------------------------------------------------- #

def build_server(args: Any, autoscale_cfg: Optional[Dict[str, Any]] = None):
    """The split CNN's server party, replicated per ``--replicas`` (a
    group from ``--autoscale-min`` replicas up under ``--autoscale``):
    ``(server or group, replica factory)``. Every replica is drawn from
    the same seed."""
    import torch

    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime.replica import maybe_replicate
    from split_learning_tpu_torch.runtime.server import ServerRuntime
    from split_learning_tpu_torch.utils.config import Config
    cfg = Config(mode="split", batch_size=args.batch,
                 num_clients=args.num_client_slots)
    plan = get_plan(mode="split")

    def make_replica(_idx: int) -> ServerRuntime:
        return ServerRuntime(
            plan, cfg, torch.Generator().manual_seed(args.seed),
            strict_steps=True, coalesce_max=args.coalesce_max,
            coalesce_window_ms=args.window_ms, batching=args.batching,
            tenants=args.tenants, quota=args.quota, slo_ms=args.slo_ms,
            device=args.device)

    floor = None if autoscale_cfg is None else autoscale_cfg["min_replicas"]
    return maybe_replicate(make_replica, args.replicas, seed=args.seed,
                           min_replicas=floor), make_replica


def _make_factory(server: Any, args: Any) -> Callable[[int], Any]:
    from split_learning_tpu_torch.transport import (
        ChaosPolicy, ChaosTransport, LocalTransport)
    if not args.chaos:
        return lambda cid: LocalTransport(server)

    def factory(cid: int) -> Any:
        # a seeded policy per client: the chaos twin offers the same
        # arrivals and a deterministic fault schedule
        policy = ChaosPolicy(args.chaos_spec,
                             seed=args.chaos_seed * 1_000_003 + cid)
        return ChaosTransport(LocalTransport(server), policy)
    return factory


def _compile_count(server: Any, group: Any) -> int:
    """Group-wide over every replica (a killed one's count stays)."""
    runtimes = [server] if group is None else group.replicas
    total = 0
    for r in runtimes:
        try:
            total += r.health().get("coalescing", {}).get("compile_count", 0)
        except Exception:
            pass
    return total


def _replay_counters(server: Any, group: Any) -> Optional[Dict[str, Any]]:
    runtimes = [server] if group is None else group.replicas
    total: Dict[str, Any] = {}
    for r in runtimes:
        sub = r.replay.counters() if r.replay is not None else None
        for k, v in (sub or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                total[k] = total.get(k, 0) + v
    return total or None


def _hist_ms(snap: Dict[str, Any], name: str) -> Dict[str, Any]:
    hist = snap.get("histograms", {}).get(name)
    if not hist or not hist.get("count"):
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": round(histogram_percentile(hist, 50) * 1e3, 3),
            "p99_ms": round(histogram_percentile(hist, 99) * 1e3, 3)}


def autoscale_summary(autoscale_cfg: Optional[Dict[str, Any]],
                      autoscaler: Any, group: Any, wall_s: float,
                      n0: int) -> Dict[str, Any]:
    """fleet_sim's ``autoscale`` block (the same keys with the
    false/empty/null arm when off)."""
    block: Dict[str, Any] = {
        "enabled": False, "min_replicas": None, "max_replicas": None,
        "cooldown_s": None, "decisions": 0, "scale_ups": 0,
        "scale_downs": 0, "events": [], "replica_seconds": None,
        "static_peak_replica_seconds": None, "peak_replicas": None,
        "final_replicas": None, "p99_ms_trajectory": [],
        "pump_errors": 0, "step_hook_errors": 0, "last_error": None}
    if autoscaler is None:
        return block
    block.update(autoscaler.summary())
    block["enabled"] = True
    block["min_replicas"] = int(autoscale_cfg["min_replicas"])
    block["max_replicas"] = int(autoscale_cfg["max_replicas"])
    block["cooldown_s"] = float(autoscale_cfg["cooldown_s"])
    running = peak = n0
    for ev in block["events"]:
        running += 1 if ev["direction"] == "up" else -1
        peak = max(peak, running)
    block["peak_replicas"] = peak
    block["final_replicas"] = len(group.live_replicas())
    block["replica_seconds"] = round(sum(group.replica_seconds().values()), 3)
    block["static_peak_replica_seconds"] = round(peak * wall_s, 3)
    return block


_HANDOFF_KEYS = ("replica_routes", "replica_reroutes", "replica_deaths",
                 "replica_handoffs", "handoff_replay_entries",
                 "handoff_ef_entries", "handoff_deferred_flushed",
                 "replica_syncs", "replica_fenced_waits")


def replication_summary(args: Any, group: Any,
                        res: FleetResult) -> Dict[str, Any]:
    """fleet_sim's ``replication`` block (the same keys for a bare
    server: zero counters, null latencies, one replica's seconds)."""
    block: Dict[str, Any] = {
        "replicas": args.replicas, "kill_replica_at": args.kill_replica_at,
        "kills": int(res.counters.get("fleet_replica_kills", 0)),
        "live_replicas": [0], "handoff": {k: 0 for k in _HANDOFF_KEYS},
        "reroute_wait": {"p50_ms": None, "p99_ms": None},
        "handoff_latency": {"p50_ms": None, "p99_ms": None},
        "replica_seconds": round(res.wall_s, 3), "per_replica": []}
    if group is None:
        return block
    counters = group.counters()
    seconds = group.replica_seconds()
    block["replica_seconds"] = round(sum(seconds.values()), 3)
    block["live_replicas"] = group.live_replicas()
    block["handoff"] = {k: int(counters.get(k, 0)) for k in _HANDOFF_KEYS}
    snap = group.registry.snapshot()
    block["reroute_wait"] = _hist_ms(snap, spans.REPLICA_REROUTE_WAIT)
    block["handoff_latency"] = _hist_ms(snap, spans.REPLICA_HANDOFF_LATENCY)
    live = set(block["live_replicas"])
    assigned: Dict[int, int] = {}
    for cid in range(args.clients):
        rid = group.assignment(cid)
        assigned[rid] = assigned.get(rid, 0) + 1
    for i, r in enumerate(group.replicas):
        block["per_replica"].append({
            "replica": i, "alive": i in live,
            "assigned_clients": assigned.get(i, 0),
            "alive_s": round(seconds.get(i, 0.0), 3),
            "replay": (r.replay.counters() if r.replay is not None
                       else None),
            "admission": r.health().get("admission")})
    return block


def setup_telemetry(args: Any, server: Any, force: bool = False) -> Any:
    """A telemetry ring over the server's (or group's) metrics when
    ``--telemetry``, ``SLT_TELEMETRY`` or the autoscaler (``force``) asks
    for one, ``--slo-ms`` its SLO where the env sets none. The ring, or
    None."""
    from split_learning_tpu_torch.obs import telemetry as obs_telemetry
    return obs_telemetry.start(
        server.metrics, party="server", force=force or args.telemetry,
        interval_s=args.telemetry_interval_s, default_slo_ms=args.slo_ms,
        tenants=args.tenants)


def telemetry_summary(ring: Any) -> Dict[str, Any]:
    """fleet_sim's ``telemetry`` block (the same keys when off)."""
    block: Dict[str, Any] = {
        "enabled": ring is not None, "interval_s": None, "windows": 0,
        "p99_ms_trajectory": [], "burn_peak": None, "slo_alerts": [],
        "bottleneck_histogram": {}}
    if ring is None:
        return block
    ring.advance(force=True)   # close the window in progress
    windows = ring.windows()
    block["interval_s"] = ring.interval_s
    block["windows"] = len(windows)
    burn_peak = None
    for w in windows:
        pct = w.get("percentiles", {}).get(spans.DISPATCH)
        block["p99_ms_trajectory"].append(
            round(pct["p99"], 3) if pct else None)
        for name, v in w.get("gauges", {}).items():
            if name.startswith(spans.SLO_BURN_FAST):
                burn_peak = v if burn_peak is None else max(burn_peak, v)
        hists = w.get("histograms", {})
        shares = {"queue_wait": float(hists.get(spans.QUEUE_WAIT, {})
                                      .get("sum", 0.0)),
                  "compute": float(hists.get(spans.DISPATCH, {})
                                   .get("sum", 0.0))}
        if any(v > 0 for v in shares.values()):
            kind = max(shares, key=lambda k: shares[k])
            block["bottleneck_histogram"][kind] = (
                block["bottleneck_histogram"].get(kind, 0) + 1)
    block["burn_peak"] = None if burn_peak is None else round(burn_peak, 4)
    if ring.slo is not None:
        block["slo_alerts"] = ring.slo.alerts()
    return block


def parse_args(argv: Optional[List[str]] = None) -> Any:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m split_learning_tpu_torch.runtime.fleet",
        description="Fleet simulation: N LocalTransport clients against "
                    "in-process split-CNN server replicas; prints a JSON "
                    "summary of per-tenant latency tails.")
    ap.add_argument("--device", default="cuda",
                    help="where the server replicas compute (cuda or cpu)")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--tenants", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3, help="steps per client")
    ap.add_argument("--arrival", choices=("poisson", "burst", "diurnal"),
                    default="burst")
    ap.add_argument("--rate", type=float, default=0.05,
                    help="per-client mean arrival rate (Hz)")
    ap.add_argument("--burst-size", type=int, default=2)
    ap.add_argument("--batching", choices=("window", "continuous"),
                    default="continuous")
    ap.add_argument("--coalesce-max", type=int, default=4)
    ap.add_argument("--window-ms", type=float, default=50.0)
    ap.add_argument("--quota", type=float, default=None,
                    help="per-tenant admitted steps/s (token bucket)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-tenant SLO -> EDF deadline priority")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--num-client-slots", type=int, default=1 << 20)
    ap.add_argument("--no-warm", action="store_true",
                    help="skip warm_fleet (first calls land in the run)")
    ap.add_argument("--chaos", action="store_true",
                    help="wrap every client wire in ChaosTransport")
    ap.add_argument("--chaos-spec", default="drop_resp=0.05,dup=0.02")
    ap.add_argument("--chaos-seed", type=int, default=7)
    ap.add_argument("--replicas", type=int, default=1,
                    help="server replicas behind the sticky router")
    ap.add_argument("--kill-replica-at", type=int, default=0,
                    help="kill the busiest replica once the fleet has "
                         "completed this many steps (needs --replicas > 1)")
    ap.add_argument("--gate-dropped-steps", action="store_true",
                    help="exit 1 unless no step was dropped and every "
                         "scheduled step completed")
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--telemetry-interval-s", type=float, default=None)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--autoscale-min", type=int, default=None)
    ap.add_argument("--autoscale-max", type=int, default=None)
    ap.add_argument("--autoscale-cooldown-s", type=float, default=None)
    ap.add_argument("--gate-autoscale", action="store_true",
                    help="exit 1 unless the run saw >= 1 scale-up and "
                         ">= 1 scale-down and no scaling fault "
                         "(needs --autoscale)")
    return ap.parse_args(argv)


def run_sim(args: Any) -> Tuple[int, Optional[Dict[str, Any]]]:
    """One fleet_sim run: ``(rc, summary)``; rc 2 on a refused flag
    combination (summary None), 1 on a failed gate."""
    import sys

    from split_learning_tpu_torch.obs import dispatch_debug
    from split_learning_tpu_torch.obs import telemetry as obs_telemetry
    from split_learning_tpu_torch.runtime import autoscale as rt_autoscale
    from split_learning_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)  # no GPU for "cuda": raise before any work
    if args.kill_replica_at > 0 and args.replicas < 2:
        print("[fleet_sim] --kill-replica-at needs --replicas > 1",
              file=sys.stderr)
        return 2, None
    autoscale_cfg = rt_autoscale.args_config(args)
    if args.gate_autoscale and autoscale_cfg is None:
        print("[fleet_sim] --gate-autoscale needs --autoscale",
              file=sys.stderr)
        return 2, None
    # the watchdog on before the replicas are built: each binds it then
    was_on = dispatch_debug.enabled()
    dispatch_debug.force(True)
    server, make_replica = build_server(args, autoscale_cfg)
    group = server if (args.replicas > 1
                       or autoscale_cfg is not None) else None
    factory = _make_factory(server, args)
    fcfg = FleetConfig(
        n_clients=args.clients, tenants=args.tenants,
        steps_per_client=args.steps, arrival=args.arrival,
        rate_hz=args.rate, burst_size=args.burst_size, seed=args.seed,
        workers=args.workers, batch=args.batch,
        kill_replica_at=args.kill_replica_at)
    ring = setup_telemetry(args, server, force=autoscale_cfg is not None)
    autoscaler = None
    n0 = len(group.live_replicas()) if group is not None else 1
    try:
        warm_rounds = 0 if args.no_warm else warm_fleet(server, factory,
                                                        fcfg)
        if autoscale_cfg is not None:
            # built after the warm-up: its windows are history, not signal
            autoscaler = rt_autoscale.Autoscaler(
                group, make_replica,
                rt_autoscale.policy_from_config(autoscale_cfg), ring,
                coalesce_max=args.coalesce_max, slo_ms=args.slo_ms)
            # idle windows (no step completions to poke the per-step
            # hook) reach the policy through the pump: scale-downs
            autoscaler.start(ring.interval_s)
        compiles_before = _compile_count(server, group)
        res = run_fleet(fcfg, factory, group=group, autoscaler=autoscaler)
        if autoscaler is not None:
            autoscaler.close()  # no scale event mid-summary
        health = server.health()
        coalescing = health.get("coalescing", {})
        compiles_after = _compile_count(server, group)
        replay = _replay_counters(server, group)
        replication = replication_summary(args, group, res)
        telemetry = telemetry_summary(ring)
        autoscale_block = autoscale_summary(autoscale_cfg, autoscaler,
                                            group, res.wall_s, n0)
        dispatch = dispatch_debug.tracker().gauges()
    finally:
        dispatch_debug.force(was_on)
        if not was_on:
            dispatch_debug.uninstall()
        if autoscaler is not None:
            autoscaler.close()
        if ring is not None:
            obs_telemetry.stop()
        server.close()

    expected = args.clients * args.steps
    completed = int(res.counters.get("fleet_steps_total", 0))
    dropped = int(res.counters.get("fleet_dropped_steps", 0))
    adm = health.get("admission")
    reject_rate = None
    if adm is not None:
        offered = (adm.get("admission_admitted", 0.0)
                   + adm.get("admission_rejected", 0.0))
        reject_rate = (adm.get("admission_rejected", 0.0) / offered
                       if offered else 0.0)
    occupancy = float(coalescing.get("mean_occupancy", 0.0) or 0.0)
    step_p99 = res.overall.get("step_p99_ms")
    p99_over_slo = (step_p99 / args.slo_ms
                    if args.slo_ms and step_p99 is not None else None)
    summary = {
        "config": {
            "clients": args.clients, "tenants": args.tenants,
            "steps_per_client": args.steps, "arrival": args.arrival,
            "rate_hz": args.rate, "burst_size": args.burst_size,
            "batching": args.batching, "coalesce_max": args.coalesce_max,
            "window_ms": args.window_ms, "quota": args.quota,
            "slo_ms": args.slo_ms, "seed": args.seed,
            "chaos": bool(args.chaos), "replicas": args.replicas,
            "kill_replica_at": args.kill_replica_at,
            "autoscale": autoscale_cfg is not None,
            "device": str(args.device)},
        "warm_rounds": warm_rounds,
        "wall_s": round(res.wall_s, 3),
        "steps_expected": expected,
        "steps_completed": completed,
        "dropped_steps": dropped,
        "backpressure_total": int(
            res.counters.get("fleet_backpressure_total", 0)),
        "retries_total": int(res.counters.get("fleet_retries_total", 0)),
        "mean_loss": None if completed == 0 else round(res.mean_loss, 6),
        "compiles_in_run": compiles_after - compiles_before,
        "overall": {k: round(v, 3) for k, v in res.overall.items()},
        "per_tenant": {
            str(t): {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in row.items()}
            for t, row in res.per_tenant.items()},
        "admission": adm,
        "utilization": {
            "mean_occupancy": round(occupancy, 3),
            "steady_state_occupancy": round(
                occupancy / max(args.coalesce_max, 1), 4),
            "admission_reject_rate": (None if reject_rate is None
                                      else round(reject_rate, 4)),
            "step_p99_over_slo": (None if p99_over_slo is None
                                  else round(p99_over_slo, 3)),
            "slo_attained": (None if p99_over_slo is None
                             else bool(p99_over_slo <= 1.0))},
        "replay": replay,
        "replication": replication,
        "telemetry": telemetry,
        "autoscale": autoscale_block,
        "dispatch": dispatch,
    }
    rc = 0
    if args.gate_dropped_steps:
        if dropped != 0 or completed != expected:
            print(f"[fleet_sim] GATE FAILED: dropped={dropped} "
                  f"completed={completed}/{expected}", file=sys.stderr)
            rc = 1
        else:
            print(f"[fleet_sim] gate ok: {completed}/{expected} steps, "
                  "0 dropped", file=sys.stderr)
    if args.gate_autoscale:
        ups = autoscale_block["scale_ups"]
        downs = autoscale_block["scale_downs"]
        errors = (autoscale_block["pump_errors"]
                  + autoscale_block["step_hook_errors"])
        if ups < 1 or downs < 1 or errors:
            print(f"[fleet_sim] AUTOSCALE GATE FAILED: scale_ups={ups} "
                  f"scale_downs={downs} errors={errors} "
                  f"({autoscale_block['last_error']})", file=sys.stderr)
            rc = 1
        else:
            print(f"[fleet_sim] autoscale gate ok: {ups} up / {downs} down",
                  file=sys.stderr)
    return rc, summary


def main(argv: Optional[List[str]] = None) -> int:
    import json
    rc, summary = run_sim(parse_args(argv))
    if summary is not None:
        print(json.dumps(summary, indent=1))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
