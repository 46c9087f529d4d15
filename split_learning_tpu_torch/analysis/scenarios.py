"""slt-check scenarios of the PyTorch port (counterpart of
``split_learning_tpu/analysis/scenarios.py``): small concurrent
workloads over the port's REAL runtime objects, on the CPU.

Each scenario is a function ``fn(ctx) -> dict`` driving the actual
runtime objects (ReplayCache, RequestCoalescer/ContinuousBatcher,
AdmissionController, CircuitBreaker, FleetHarness, ServerRuntime with a
stub dispatch, _DeferredApply, ReplicaGroup, and StageRuntime's hops
with a stub stage program) under the cooperative
scheduler in sched.py: the objects construct their locks, events,
conditions and threads through the ``obs.locks`` seam, so every sync op
is a yield point the explorer preempts around. Scenarios emit semantic
notes (``ctx.note``) that the invariants in invariants.py assert over;
end-of-run state checks can just ``assert`` -- a failure rides the
``no_errors`` generic invariant and carries the schedule id.

Registration: decorate with :func:`scenario`; the engine's ``--check``
discovers everything in :data:`SCENARIOS`. Per-scenario knobs (budget,
preemption bound, dfs/random mode, seed) are JAX's (``stage_hop_claims``,
the port's own, takes the server scenarios' 300 and 2), so the default full
sweep is exhaustive where the space is small and seeded-random where it
is not -- and always deterministic.

Scenarios tag racy *non-primitive* shared state (plain attribute reads
the dependence relation cannot see) with ``ctx.step(tag)`` so the
sleep-set pruner keeps both orders of the race.

This module alone of the analysis package imports numpy, torch and the
runtime (sched and invariants are pinned stdlib-only); the engine loads
it only under ``--check``. Scenarios whose objects import torch declare
``requires="torch"``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from split_learning_tpu_torch.analysis.sched import Ctx

__all__ = ["Scenario", "SCENARIOS", "scenario",
           "CrashScenario", "CRASH_SCENARIOS", "crash_scenario"]


def _importable(requires: Optional[str]) -> bool:
    if requires is None:
        return True
    try:
        __import__(requires)
        return True
    except Exception:  # pragma: no cover - the port always has torch
        return False


@dataclass
class Scenario:
    """One registered scenario plus its exploration knobs."""

    name: str
    fn: Callable[[Ctx], Optional[Dict[str, Any]]]
    invariants: Tuple[str, ...] = ()
    budget: int = 200
    bound: Optional[int] = 3
    mode: str = "dfs"          # dfs | random
    seed: int = 0
    requires: Optional[str] = None  # "torch" gates on importability
    doc: str = ""

    def available(self) -> bool:
        return _importable(self.requires)


SCENARIOS: Dict[str, Scenario] = {}


def scenario(name: str, *, invariants: Tuple[str, ...] = (),
             budget: int = 200, bound: Optional[int] = 3,
             mode: str = "dfs", seed: int = 0,
             requires: Optional[str] = None) -> Callable:
    def wrap(fn: Callable[[Ctx], Optional[Dict[str, Any]]]) -> Callable:
        SCENARIOS[name] = Scenario(
            name=name, fn=fn, invariants=invariants, budget=budget,
            bound=bound, mode=mode, seed=seed, requires=requires,
            doc=(fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__
            else "")
        return fn
    return wrap


def _tiny_batch() -> Tuple[np.ndarray, np.ndarray]:
    acts = np.zeros((1, 4), dtype=np.float32)
    labels = np.zeros((1,), dtype=np.int64)
    return acts, labels


# --------------------------------------------------------------------- #
# ReplayCache: the exactly-once claim lifecycle
# --------------------------------------------------------------------- #

@scenario("replay_dup_storm", invariants=("exactly_once_claims",),
          budget=400, bound=3)
def replay_dup_storm(ctx: Ctx) -> Dict[str, Any]:
    """Three duplicate deliveries of one step race begin(): exactly one
    wins the claim and applies; losers block on the in-flight future and
    are served the single materialized value."""
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    cache = ReplayCache(window=4)
    key = (7, "split_step", 3)

    def deliver(tag: str) -> None:
        entry, owner = cache.begin(*key)
        ctx.note("begin", key=key, owner=owner, who=tag)
        if owner:
            ctx.step("apply")  # the materialization the dup must not redo
            ctx.note("apply", key=key)
            cache.resolve(entry, "grad-v1")
            ctx.note("resolve", key=key, value="grad-v1")
        else:
            value = cache.wait(entry, timeout=30.0)
            ctx.note("wait_return", key=key, value=value)

    workers = [ctx.spawn(deliver, t, name=f"dup-{t}") for t in "abc"]
    for w in workers:
        w.join()
    assert cache.contains(*key)
    return {"hits": cache.hits}


@scenario("replay_fail_retry",
          invariants=("exactly_once_claims", "reclaimable_429"),
          budget=400, bound=3)
def replay_fail_retry(ctx: Ctx) -> Dict[str, Any]:
    """The claim winner is refused (admission 429) and fail()s its
    entry; the released claim must be re-ownable so a retry — from
    either thread — applies the step exactly once."""
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    cache = ReplayCache(window=4)
    key = (9, "split_step", 1)
    box = {"refused": False}

    def deliver(tag: str) -> None:
        for _ in range(3):
            entry, owner = cache.begin(*key)
            ctx.note("begin", key=key, owner=owner, who=tag)
            if owner:
                if not box["refused"]:
                    box["refused"] = True
                    ctx.note("backpressure", key=key)
                    cache.fail(entry, RuntimeError("429: over quota"))
                    ctx.step("retry")  # the advised-delay retry window
                    continue
                ctx.note("apply", key=key)
                cache.resolve(entry, "grad-v1")
                ctx.note("resolve", key=key, value="grad-v1")
                return
            try:
                value = cache.wait(entry, timeout=30.0)
            except RuntimeError:
                ctx.step("retry")  # owner 429'd: retry to re-own
                continue
            ctx.note("wait_return", key=key, value=value)
            return
        raise AssertionError(f"{tag} exhausted retries without a reply")

    workers = [ctx.spawn(deliver, t, name=f"retry-{t}") for t in "ab"]
    for w in workers:
        w.join()
    return {"refused": box["refused"]}


# --------------------------------------------------------------------- #
# coalescer: condition handoff + EDF pickup
# --------------------------------------------------------------------- #

def _stub_dispatch(ctx: Ctx, record_pickup: bool = False
                   ) -> Callable[[list, str], None]:
    """A dispatch that resolves every request (the coalescer contract)
    and notes pickups; runs on the flusher thread."""
    def dispatch(group: list, reason: str) -> None:
        if record_pickup:
            ctx.note("pickup",
                     group=[(r.deadline, r.seq) for r in group],
                     reason=reason)
        for r in group:
            ctx.note("resolved", key=(r.client_id, r.step))
            r.result = (r.acts, 0.5)
            r.done.set()
    return dispatch


@scenario("coalesce_window_handoff", invariants=("all_resolved",),
          budget=300, bound=2)
def coalesce_window_handoff(ctx: Ctx) -> Dict[str, Any]:
    """Two submitters race the window flusher's condition handoff
    (submit's notify_all vs _collect_group's timed wait): every request
    must come back resolved exactly once, through any interleaving of
    arrivals, window expiry, and close()."""
    from split_learning_tpu_torch.runtime.coalesce import RequestCoalescer
    co = RequestCoalescer(_stub_dispatch(ctx), max_group=2,
                          window_s=0.05, mode="window")
    acts, labels = _tiny_batch()

    def submit(client_id: int) -> None:
        ctx.note("enqueue", key=(client_id, 0))
        co.submit(acts, labels, 0, client_id, timeout=60.0)

    workers = [ctx.spawn(submit, c, name=f"sub-{c}") for c in (1, 2)]
    for w in workers:
        w.join()
    co.close(timeout=30.0)
    return dict(co.counters())


@scenario("continuous_edf",
          invariants=("edf_pickup_order", "all_resolved"),
          budget=400, bound=2)
def continuous_edf(ctx: Ctx) -> Dict[str, Any]:
    """Three deadline-stamped submitters race the continuous batcher:
    whatever subset is queued at each pickup must come out earliest-
    deadline-first, equal deadlines in arrival (seq) order."""
    from split_learning_tpu_torch.runtime.coalesce import ContinuousBatcher
    co = ContinuousBatcher(_stub_dispatch(ctx, record_pickup=True),
                           max_group=2)
    acts, labels = _tiny_batch()
    base = ctx.clock.monotonic()

    def submit(client_id: int, deadline_off: float) -> None:
        ctx.note("enqueue", key=(client_id, 0))
        co.submit(acts, labels, 0, client_id, timeout=60.0,
                  deadline=base + deadline_off)

    # two tight-SLO tenants tie at +2.0; the batch tenant's +5.0 must
    # never overtake them
    workers = [ctx.spawn(submit, 1, 5.0, name="batch"),
               ctx.spawn(submit, 2, 2.0, name="tight-a"),
               ctx.spawn(submit, 3, 2.0, name="tight-b")]
    for w in workers:
        w.join()
    co.close(timeout=30.0)
    return dict(co.counters())


# --------------------------------------------------------------------- #
# admission: token-bucket race
# --------------------------------------------------------------------- #

@scenario("admission_bucket_race", invariants=("admission_conservation",),
          budget=300, bound=3)
def admission_bucket_race(ctx: Ctx) -> Dict[str, Any]:
    """Two clients of one tenant race a bucket holding exactly one
    token: exactly one admits, the loser's Backpressure carries a
    positive retry delay, and the in-flight depth drains to zero."""
    from split_learning_tpu_torch.runtime.admission import AdmissionController
    from split_learning_tpu_torch.transport.base import Backpressure
    ac = AdmissionController(tenants=1, quota=1.0, burst=1.0,
                             slo_ms=50.0, clock=ctx.clock.monotonic)
    ctx.note("max_admits", tenant=0, n=1)

    def step(client_id: int) -> None:
        try:
            deadline = ac.admit(client_id)
        except Backpressure as exc:
            assert exc.retry_after_s > 0.0
            ctx.note("rejected", tenant=0)
            return
        ctx.note("admitted", tenant=0)
        assert deadline is not None and deadline > ctx.clock.monotonic()
        ctx.step("inflight")  # the dispatch the slot is charged for
        ac.complete(client_id)
        ctx.note("completed", tenant=0)

    workers = [ctx.spawn(step, c, name=f"cl-{c}") for c in (0, 2)]
    for w in workers:
        w.join()
    depth = ac.gauges()["admission_queue_depth_t0"]
    ctx.note("final_depth", tenant=0, depth=int(depth))
    return dict(ac.counters())


# --------------------------------------------------------------------- #
# breaker: open/probe/half-open handoff
# --------------------------------------------------------------------- #

@scenario("breaker_probe_race", budget=300, bound=2)
def breaker_probe_race(ctx: Ctx) -> Dict[str, Any]:
    """Two clients trip the breaker open, then race before_attempt()'s
    probe loop while the server recovers: no schedule may deadlock or
    strand a prober, and the breaker must end CLOSED after the
    survivors' record_success."""
    from split_learning_tpu_torch.runtime.breaker import CircuitBreaker, CLOSED
    from split_learning_tpu_torch.transport.base import TransportError
    server_up = {"ok": False}

    def probe() -> None:
        ctx.step("health")  # racy read of the server's health flag
        if not server_up["ok"]:
            raise TransportError("still down")

    br = CircuitBreaker(probe, failure_threshold=2,
                        probe_initial_s=0.5, probe_cap_s=1.0,
                        probe_jitter=0.0, max_open_s=30.0,
                        rng=random.Random(0), sleep=ctx.clock.sleep)

    def client(tag: str) -> None:
        br.record_failure()  # two of these open the breaker
        br.before_attempt()  # probes until the server answers
        br.record_success()

    def recover() -> None:
        ctx.sleep(1.0)
        ctx.step("health")
        server_up["ok"] = True

    workers = [ctx.spawn(client, t, name=f"cl-{t}") for t in "ab"]
    workers.append(ctx.spawn(recover, name="server"))
    for w in workers:
        w.join()
    # which schedules open the breaker varies (a fast success resets
    # the failure count), but every open must have reclosed by the end
    assert br.state == CLOSED, f"breaker ended {br.state}"
    assert (br.counters["breaker_reclosed"] ==
            br.counters["breaker_opened"]), dict(br.counters)
    return dict(br.counters)


# --------------------------------------------------------------------- #
# fleet: scheduler-heap condition handoff
# --------------------------------------------------------------------- #

class _StubTransport:
    """A model-free wire: split_step echoes the activations. `stats` is
    the surface FleetHarness reads queue waits from."""

    def __init__(self) -> None:
        from split_learning_tpu_torch.transport.base import TransportStats
        self.stats = TransportStats()

    def split_step(self, acts: Any, labels: Any, step: int,
                   client_id: int) -> Tuple[Any, float]:
        return acts, 0.25


@scenario("fleet_handoff", budget=250, bound=2, mode="random", seed=11)
def fleet_handoff(ctx: Ctx) -> Dict[str, Any]:
    """A tiny fleet (2 clients x 2 steps, 2 workers) drives the event
    heap's push/pop-due/done-one condition handoff: every scheduled step
    must run exactly once and both workers must terminate — the drained
    check (`not heap and inflight == 0`) must hold through every
    interleaving of pops, pushes, and completions."""
    from split_learning_tpu_torch.runtime.fleet import FleetConfig, FleetHarness
    cfg = FleetConfig(n_clients=2, tenants=1, steps_per_client=2,
                      workers=2, batch=1, rate_hz=50.0, seed=3,
                      trace=False)
    harness = FleetHarness(cfg, lambda cid: _StubTransport())
    result = harness.run()
    steps = result.counters["fleet_steps_total"]
    assert steps == 4.0, f"fleet ran {steps} steps, scheduled 4"
    assert len(result.losses) == 4
    return {"steps": steps}


# --------------------------------------------------------------------- #
# server: the real split_step claim/coalesce path (stub dispatch)
# --------------------------------------------------------------------- #

def _stub_server(ctx: Ctx, quota: Optional[float] = None) -> Any:
    """A ServerRuntime shell: the real split_step coalescer path (replay
    claims, admission, continuous batcher) over a dispatch stub that
    resolves groups without a model. Built with __new__ so no model is
    constructed; the requests land on the CPU."""
    import torch
    from split_learning_tpu_torch.runtime.admission import AdmissionController
    from split_learning_tpu_torch.runtime.coalesce import ContinuousBatcher
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.server import ServerRuntime

    srv = ServerRuntime.__new__(ServerRuntime)
    srv.mode = "split"
    srv.device = torch.device("cpu")
    srv._mesh = None      # one device: no sharded reply
    srv._mesh_data = 1
    srv._deferred = None  # coupled path: no deferred-apply queue
    srv.replay = ReplayCache(window=8)
    srv._admission = (None if quota is None else AdmissionController(
        tenants=1, quota=quota, burst=quota,
        clock=ctx.clock.monotonic))

    def dispatch(group: list, reason: str) -> None:
        for r in group:
            ctx.note("apply", key=(r.client_id, r.step))
            ctx.note("resolved", key=(r.client_id, r.step))
            r.result = (r.acts, 0.75)
            r.done.set()

    srv._coalescer = ContinuousBatcher(dispatch, max_group=2)
    return srv


@scenario("server_split_claims",
          invariants=("exactly_once_claims", "all_resolved"),
          budget=300, bound=2, requires="torch")
def server_split_claims(ctx: Ctx) -> Dict[str, Any]:
    """Duplicate deliveries race the REAL ServerRuntime.split_step
    coalescer path: the retry that loses the replay claim must block on
    the in-flight future and receive the one dispatched result — never
    a second dispatch of the same (client, step)."""
    srv = _stub_server(ctx)
    acts, labels = _tiny_batch()

    def deliver(client_id: int, step: int, tag: str) -> None:
        if tag == "dup":
            ctx.step("wire")  # the retransmit window
        else:
            ctx.note("enqueue", key=(client_id, step))
        _, loss = srv.split_step(acts, labels, step, client_id)
        ctx.note("got", key=(client_id, step), value=loss, who=tag)
        assert loss == 0.75

    workers = [ctx.spawn(deliver, 0, 1, "orig", name="orig"),
               ctx.spawn(deliver, 0, 1, "dup", name="dup"),
               ctx.spawn(deliver, 1, 1, "other", name="other")]
    for w in workers:
        w.join()
    srv._coalescer.close(timeout=30.0)
    applies = [f for k, f in ctx.sched.notes if k == "apply"
               and f["key"] == (0, 1)]
    assert len(applies) == 1, f"step (0,1) dispatched {len(applies)}x"
    return {"hits": srv.replay.hits}


@scenario("server_backpressure_reclaim",
          invariants=("reclaimable_429", "exactly_once_claims"),
          budget=300, bound=2, requires="torch")
def server_backpressure_reclaim(ctx: Ctx) -> Dict[str, Any]:
    """A 429'd step on the real split_step path must release its replay
    claim (replay.fail in the except path) so the advised retry re-owns
    and applies it exactly once — the claim must never wedge a refused
    step forever."""
    from split_learning_tpu_torch.transport.base import Backpressure
    srv = _stub_server(ctx, quota=1.0)  # bucket holds exactly 1 token
    acts, labels = _tiny_batch()

    def deliver(client_id: int, tag: str) -> None:
        for _ in range(3):
            try:
                srv.split_step(acts, labels, 1, client_id)
                return
            except Backpressure as exc:
                key = (client_id, 1)
                ctx.note("backpressure", key=key)
                ctx.clock.sleep(exc.retry_after_s + 0.01)
        raise AssertionError(f"{tag}: retries exhausted")

    # same tenant (tenant 0 is client_id % 1): two steps, one token —
    # someone eats a 429 and must still land its step via the retry
    workers = [ctx.spawn(deliver, 0, "a", name="cl-a"),
               ctx.spawn(deliver, 2, "b", name="cl-b")]
    for w in workers:
        w.join()
    srv._coalescer.close(timeout=30.0)
    applied = {f["key"] for k, f in ctx.sched.notes if k == "apply"}
    assert applied == {(0, 1), (2, 1)}, f"applied: {applied}"
    return {"hits": srv.replay.hits}


# --------------------------------------------------------------------- #
# decoupled backward: the deferred-apply queue (SLT108)
# --------------------------------------------------------------------- #

@scenario("deferred_apply_storm",
          invariants=("deferred_apply_exactly_once",
                      "exactly_once_claims"),
          budget=400, bound=3)
def deferred_apply_storm(ctx: Ctx) -> Dict[str, Any]:
    """Replay-duplicate deliveries race the real _DeferredApply queue
    (lag=1) and a mid-run close()-style flush: only the claim owner may
    enqueue a step's weight update, every enqueued update applies
    exactly once and in enqueue order, and the final drain leaves the
    queue empty — through every interleaving of pushes, lag drains, the
    racing flush, and the duplicate's wait."""
    from split_learning_tpu_torch.obs import locks as obs_locks
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.server import _DeferredApply

    # the runtime hands _DeferredApply its own (reentrant) apply lock;
    # mirror that shape so push/drain happen inside the lock-held
    # window exactly as split_step does
    lock = obs_locks.make_lock("ServerRuntime._lock")

    def apply_fn(entry: Dict[str, Any]) -> None:
        ctx.note("da_apply", key=entry["step"])

    dq = _DeferredApply(apply_fn, 1, lock)
    cache = ReplayCache(window=8)

    def deliver(step: int, tag: str) -> None:
        if tag == "dup":
            ctx.step("wire")  # the retransmit window
        entry, owner = cache.begin(0, "split_step", step)
        ctx.note("begin", key=(0, step), owner=owner, who=tag)
        if owner:
            with lock:  # split_step's lock-held reply window
                ctx.note("da_enqueue", key=step)
                dq.push({"step": step})
                dq.drain_over_lag()
            ctx.note("apply", key=(0, step))
            cache.resolve(entry, step)
            ctx.note("resolve", key=(0, step), value=step)
        else:
            value = cache.wait(entry, timeout=30.0)
            ctx.note("wait_return", key=(0, step), value=value)

    def closer() -> None:
        # a mid-run flush barrier (predict/checkpoint/close) racing the
        # reply path: drained, never dropped
        ctx.step("close")
        dq.flush()

    workers = [ctx.spawn(deliver, 1, "orig", name="s1"),
               ctx.spawn(deliver, 1, "dup", name="s1-dup"),
               ctx.spawn(deliver, 2, "orig", name="s2"),
               ctx.spawn(closer, name="closer")]
    for w in workers:
        w.join()
    dq.flush()  # end-of-run close(): everything must land
    ctx.note("da_final_depth", depth=dq.depth())
    return dict(dq.counters())

# --------------------------------------------------------------------- #
# MPMD pipeline hops: per-stage replay claims under dup/drop
# --------------------------------------------------------------------- #

@scenario("pipeline_hop_chain",
          invariants=("pipeline_hops_exactly_once",
                      "exactly_once_claims"),
          budget=400, bound=3)
def pipeline_hop_chain(ctx: Ctx) -> Dict[str, Any]:
    """A 3-stage chain's hop traffic (2 microbatches, one step) under a
    racing duplicate re-deliverer and a dropped-response retry: each
    stage owns a real ReplayCache keyed by the composite hop seq, the
    per-wire FIFO deliverers send microbatches in order (the runner's
    worker-queue discipline), and causality events gate loss-after-fwd
    and bwd-after-loss exactly as cotangents do — every hop must apply
    exactly once, in mb order per (stage, dir), through every
    interleaving of the deliverers, the dup, and the retry."""
    from split_learning_tpu_torch.obs import locks as obs_locks
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.stage import hop_seq

    M, step = 2, 5
    caches = {1: ReplayCache(window=8), 2: ReplayCache(window=8)}
    ops = {("fwd", 1): "hop_fwd", ("fwd", 2): "hop_loss",
           ("bwd", 1): "hop_bwd"}

    def deliver(stage: int, direction: str, mb: int, tag: str) -> None:
        """One wire delivery: claim the composite seq on the stage's
        cache; only the owner 'runs the stage program' (notes
        hop_apply); losers and post-done retries are served the cached
        value. ``drop`` redelivers after a resolved first attempt —
        the lost-response retry path."""
        op = ops[(direction, stage)]
        key = (0, op, hop_seq(step, mb))
        if tag == "orig":
            ctx.note("hop_sent", stage=stage, dir=direction, step=step,
                     mb=mb)
        else:
            ctx.step("wire")  # the retransmit window
        entry, owner = caches[stage].begin(*key)
        ctx.note("begin", key=key, owner=owner, who=f"{tag}-s{stage}")
        if owner:
            ctx.note("hop_apply", stage=stage, dir=direction, step=step,
                     mb=mb)
            ctx.note("apply", key=key)
            caches[stage].resolve(entry, f"y:{stage}:{direction}:{mb}")
            ctx.note("resolve", key=key,
                     value=f"y:{stage}:{direction}:{mb}")
        else:
            value = caches[stage].wait(entry, timeout=30.0)
            ctx.note("wait_return", key=key, value=value)

    # causality events: loss(mb) needs fwd(mb)'s activation, bwd(mb)
    # needs loss(mb)'s cotangent — same dataflow as the real runner
    fwd_ev = [obs_locks.make_event(f"fwd{m}") for m in range(M)]
    loss_ev = [obs_locks.make_event(f"loss{m}") for m in range(M)]

    def wire1_fwd() -> None:
        for mb in range(M):
            deliver(1, "fwd", mb, "orig")
            fwd_ev[mb].set()

    def wire2_loss() -> None:
        for mb in range(M):
            fwd_ev[mb].wait(timeout=30.0)
            deliver(2, "fwd", mb, "orig")
            loss_ev[mb].set()

    def wire1_bwd() -> None:
        for mb in range(M):
            loss_ev[mb].wait(timeout=30.0)
            deliver(1, "bwd", mb, "orig")

    def chaos() -> None:
        # a duplicated fwd delivery and a dropped-response loss retry:
        # both must be absorbed by the stage claims, never re-applied
        fwd_ev[0].wait(timeout=30.0)
        deliver(1, "fwd", 0, "dup")
        loss_ev[M - 1].wait(timeout=30.0)
        deliver(2, "fwd", M - 1, "drop")

    workers = [ctx.spawn(wire1_fwd, name="w1-fwd"),
               ctx.spawn(wire2_loss, name="w2-loss"),
               ctx.spawn(wire1_bwd, name="w1-bwd"),
               ctx.spawn(chaos, name="chaos")]
    for w in workers:
        w.join()
    for stage, cache in caches.items():
        for mb in range(M):
            assert cache.contains(0, ops[("fwd", stage)],
                                  hop_seq(step, mb))
    return {"hits_s1": caches[1].hits, "hits_s2": caches[2].hits}


@scenario("onefb_hop_order",
          invariants=("onefb_hop_order", "exactly_once_claims"),
          budget=400, bound=2)
def onefb_hop_order(ctx: Ctx) -> Dict[str, Any]:
    """The 1F1B injection discipline over a 3-stage chain's hop
    traffic (4 microbatches, warmup W = min(S, M) = 3): a driver thread
    injects the warmup burst, then strictly one new forward per drained
    cotangent — noting ``inflight(depth, bound)`` at every injection —
    while the per-wire FIFO deliverers move each microbatch fwd ->
    loss -> bwd through real per-stage ReplayCaches and a chaos thread
    re-delivers a forward and retries a dropped backward response.
    Through every interleaving: hops apply exactly once in mb order,
    never a backward before its forward, and the in-flight depth never
    exceeds W (SLT115)."""
    from split_learning_tpu_torch.obs import locks as obs_locks
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.stage import hop_seq

    M, W, step = 4, 3, 7
    caches = {1: ReplayCache(window=8), 2: ReplayCache(window=8)}
    ops = {("fwd", 1): "hop_fwd", ("fwd", 2): "hop_loss",
           ("bwd", 1): "hop_bwd"}

    def deliver(stage: int, direction: str, mb: int, tag: str) -> None:
        op = ops[(direction, stage)]
        key = (0, op, hop_seq(step, mb))
        if tag == "orig":
            ctx.note("hop_sent", stage=stage, dir=direction, step=step,
                     mb=mb)
        else:
            ctx.step("wire")  # the retransmit window
        entry, owner = caches[stage].begin(*key)
        ctx.note("begin", key=key, owner=owner, who=f"{tag}-s{stage}")
        if owner:
            ctx.note("hop_apply", stage=stage, dir=direction, step=step,
                     mb=mb)
            ctx.note("apply", key=key)
            caches[stage].resolve(entry, f"y:{stage}:{direction}:{mb}")
            ctx.note("resolve", key=key,
                     value=f"y:{stage}:{direction}:{mb}")
        else:
            value = caches[stage].wait(entry, timeout=30.0)
            ctx.note("wait_return", key=key, value=value)

    # the 1F1B gates: inj (driver released mb onto the wire), fwd/loss
    # (causality, as cotangents flow), drain (cotangent back at stage 0)
    inj_ev = [obs_locks.make_event(f"inj{m}") for m in range(M)]
    fwd_ev = [obs_locks.make_event(f"fwd{m}") for m in range(M)]
    loss_ev = [obs_locks.make_event(f"loss{m}") for m in range(M)]
    drain_ev = [obs_locks.make_event(f"drain{m}") for m in range(M)]

    def driver() -> None:
        # warmup burst, then one inject per drained cotangent — the
        # runner's inject() discipline, depth noted AFTER each inject
        depth = 0
        for m in range(W):
            depth += 1
            ctx.note("inflight", depth=depth, bound=W)
            inj_ev[m].set()
        for m in range(M):
            drain_ev[m].wait(timeout=30.0)
            depth -= 1
            nxt = W + m
            if nxt < M:
                depth += 1
                ctx.note("inflight", depth=depth, bound=W)
                inj_ev[nxt].set()

    def wire1_fwd() -> None:
        for mb in range(M):
            inj_ev[mb].wait(timeout=30.0)
            deliver(1, "fwd", mb, "orig")
            fwd_ev[mb].set()

    def wire2_loss() -> None:
        for mb in range(M):
            fwd_ev[mb].wait(timeout=30.0)
            deliver(2, "fwd", mb, "orig")
            loss_ev[mb].set()

    def wire1_bwd() -> None:
        for mb in range(M):
            loss_ev[mb].wait(timeout=30.0)
            deliver(1, "bwd", mb, "orig")
            drain_ev[mb].set()

    def chaos() -> None:
        # a duplicated forward delivery and a dropped-response backward
        # retry: the stage claims absorb both, the window never grows
        fwd_ev[0].wait(timeout=30.0)
        deliver(1, "fwd", 0, "dup")
        drain_ev[0].wait(timeout=30.0)
        deliver(1, "bwd", 0, "drop")

    workers = [ctx.spawn(driver, name="driver"),
               ctx.spawn(wire1_fwd, name="w1-fwd"),
               ctx.spawn(wire2_loss, name="w2-loss"),
               ctx.spawn(wire1_bwd, name="w1-bwd"),
               ctx.spawn(chaos, name="chaos")]
    for w in workers:
        w.join()
    for mb in range(M):
        assert caches[1].contains(0, "hop_fwd", hop_seq(step, mb))
        assert caches[1].contains(0, "hop_bwd", hop_seq(step, mb))
        assert caches[2].contains(0, "hop_loss", hop_seq(step, mb))
    return {"hits_s1": caches[1].hits, "hits_s2": caches[2].hits}


# --------------------------------------------------------------------- #
# replica failover handoff: kill across the claim lifecycle
# --------------------------------------------------------------------- #

@scenario("replica_death_handoff",
          invariants=("handoff_exactly_once", "exactly_once_claims"),
          budget=300, bound=2, requires="torch")
def replica_death_handoff(ctx: Ctx) -> Dict[str, Any]:
    """A 2-replica group under a mid-run chaos kill: clients deliver
    (and re-deliver) steps through the REAL ReplicaGroup router —
    sticky rendezvous routing, the handoff fence, quiesce, extras
    capture, replay migration — while the victim dies at every explored
    schedule point across the claim lifecycle: before the claim, inside
    the claim window, after resolve, during the duplicate's retransmit,
    and after the re-route. Exactly-once must hold group-wide: the
    migrated entries make the successor serve the duplicate the
    original materialized reply instead of re-running the step."""
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.replica import ReplicaGroup

    class _StubReplica:
        """The claim lifecycle of ServerRuntime.split_step, minus the model:
        a real ReplayCache decides ownership, only the owner 'runs the
        program' (notes apply), duplicates block on the entry — the
        surface _fail_over captures and migrates is the real one."""

        def __init__(self, idx: int) -> None:
            self.idx = idx
            self.replay = ReplayCache(window=8)
            self._steps = 0

        def health(self) -> Dict[str, Any]:
            return {"step": self._steps, "status": "serving"}

        def split_step(self, acts: Any, labels: Any, step: int,
                       client_id: int = 0) -> Any:
            key = (client_id, "split_step", step)
            entry, owner = self.replay.begin(client_id, "split_step",
                                             step)
            ctx.note("begin", key=key, owner=owner, replica=self.idx)
            if not owner:
                value = self.replay.wait(entry, timeout=30.0)
                ctx.note("wait_return", key=key, value=value,
                         replica=self.idx)
                return value
            ctx.step("claim")  # the kill can land inside the window
            self._steps += 1
            ctx.note("apply", key=key, replica=self.idx)
            value = ("reply", client_id, step, self.idx)
            self.replay.resolve(entry, value)
            ctx.note("resolve", key=key, value=value, replica=self.idx)
            return value

        def flush_deferred(self) -> int:
            return 0

        def export_runtime_extras(self, step: int) -> Dict[str, Any]:
            from split_learning_tpu_torch.runtime import checkpoint as _ckpt
            return _ckpt.build_extras(
                step, 1, replay=self.replay.export_state(), wire_ef=[])

        def close(self) -> None:
            pass

    group = ReplicaGroup([_StubReplica(i) for i in range(2)])
    victim = group.assignment(0)  # the replica client 0 lives on
    # a bystander client on the OTHER replica: its route must survive
    # the handoff unmoved (sticky routing is minimal-churn)
    other = next(c for c in range(1, 8)
                 if group.assignment(c) != victim)

    def deliver(cid: int, step: int, tag: str) -> None:
        if tag == "dup":
            ctx.step("wire")  # the retransmit window
        group.split_step(None, None, step, cid)

    def killer() -> None:
        ctx.step("kill")  # explored against every lifecycle point
        group.kill(victim)

    workers = [ctx.spawn(deliver, 0, 1, "orig", name="c0-orig"),
               ctx.spawn(deliver, 0, 1, "dup", name="c0-dup"),
               ctx.spawn(deliver, other, 1, "orig", name="c-other"),
               ctx.spawn(killer, name="killer")]
    for w in workers:
        w.join()
    counters = group.counters()
    assert counters["replica_handoffs"] == 1, counters
    assert group.live_replicas() == [1 - victim]
    # stickiness: the bystander never moved off its surviving replica
    assert group.assignment(other) == 1 - victim
    return {"handoffs": int(counters["replica_handoffs"]),
            "migrated": int(counters["handoff_replay_entries"]),
            "fenced_waits": int(counters["replica_fenced_waits"])}


@scenario("scale_down_inflight_race",
          invariants=("scale_down_exactly_once", "exactly_once_claims"),
          budget=300, bound=2, requires="torch")
def scale_down_inflight_race(ctx: Ctx) -> Dict[str, Any]:
    """A policy-driven scale-down racing live traffic AND the breaker
    probe cycle: while client 0 delivers a step (and its
    duplicate retransmit) to a 2-replica group, an autoscaler thread
    retires the replica client 0 lives on via ``remove_replica`` — the
    same fence/quiesce/capture/merge/reroute handoff a death takes —
    and a prober thread runs health probes throughout. Explored at
    every schedule point: the retirement can land before the claim,
    inside the claim window, after resolve, or during the duplicate's
    retransmit. Exactly-once must hold group-wide and the retired
    replica must never apply a step after the scale-down commits (the
    fence precedes the capture — a later apply would be state the
    merge never saw). The probe cycle takes the same scale lock, so it
    can neither declare a death mid-scale nor observe a half-fenced
    slot."""
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.replica import ReplicaGroup

    class _StubReplica:
        """ServerRuntime's claim lifecycle minus the model (the
        replica_death_handoff stub): a real ReplayCache decides
        ownership, only the owner notes apply, duplicates block on the
        entry."""

        def __init__(self, idx: int) -> None:
            self.idx = idx
            self.replay = ReplayCache(window=8)
            self._steps = 0

        def health(self) -> Dict[str, Any]:
            return {"step": self._steps, "status": "serving"}

        def split_step(self, acts: Any, labels: Any, step: int,
                       client_id: int = 0) -> Any:
            key = (client_id, "split_step", step)
            entry, owner = self.replay.begin(client_id, "split_step",
                                             step)
            ctx.note("begin", key=key, owner=owner, replica=self.idx)
            if not owner:
                value = self.replay.wait(entry, timeout=30.0)
                ctx.note("wait_return", key=key, value=value,
                         replica=self.idx)
                return value
            ctx.step("claim")  # the retirement can land in the window
            self._steps += 1
            ctx.note("apply", key=key, replica=self.idx)
            value = ("reply", client_id, step, self.idx)
            self.replay.resolve(entry, value)
            ctx.note("resolve", key=key, value=value, replica=self.idx)
            return value

        def flush_deferred(self) -> int:
            return 0

        def export_runtime_extras(self, step: int) -> Dict[str, Any]:
            from split_learning_tpu_torch.runtime import checkpoint as _ckpt
            return _ckpt.build_extras(
                step, 1, replay=self.replay.export_state(), wire_ef=[])

        def close(self) -> None:
            pass

    group = ReplicaGroup([_StubReplica(i) for i in range(2)])
    victim = group.assignment(0)  # the replica client 0 lives on
    other = next(c for c in range(1, 8)
                 if group.assignment(c) != victim)

    def deliver(cid: int, step: int, tag: str) -> None:
        if tag == "dup":
            ctx.step("wire")  # the retransmit window
        group.split_step(None, None, step, cid)

    def scaler() -> None:
        ctx.step("scale")  # explored against every lifecycle point
        group.remove_replica(victim)
        ctx.note("scale_down", replica=victim)

    def prober() -> None:
        # the breaker probe cycle must serialize with the scale op on
        # the scale lock — probing mid-retirement is a legal schedule
        for _ in range(2):
            ctx.step("probe")
            for idx in group.live_replicas():
                group.probe(idx)

    workers = [ctx.spawn(deliver, 0, 1, "orig", name="c0-orig"),
               ctx.spawn(deliver, 0, 1, "dup", name="c0-dup"),
               ctx.spawn(deliver, other, 1, "orig", name="c-other"),
               ctx.spawn(scaler, name="scaler"),
               ctx.spawn(prober, name="prober")]
    for w in workers:
        w.join()
    counters = group.counters()
    assert counters["replica_scale_downs"] == 1, counters
    assert counters["replica_deaths"] == 0, counters
    assert group.live_replicas() == [1 - victim]
    # stickiness: the bystander never moved off its surviving replica
    assert group.assignment(other) == 1 - victim
    return {"scale_downs": int(counters["replica_scale_downs"]),
            "handoffs": int(counters["replica_handoffs"]),
            "migrated": int(counters["handoff_replay_entries"]),
            "fenced_waits": int(counters["replica_fenced_waits"])}


@scenario("sharded_stage_handoff",
          invariants=("sharded_handoff_reshard", "exactly_once_claims"),
          budget=300, bound=2, requires="torch")
def sharded_stage_handoff(ctx: Ctx) -> Dict[str, Any]:
    """A 2-replica group of a SHARDED pipeline stage under a mid-run
    kill: hop deliveries (and a duplicate retransmit) flow
    through the real ReplicaGroup hop router — sticky rendezvous
    routing, the handoff fence, quiesce, extras capture, replay
    migration — while the victim dies at every explored point of the
    hop claim lifecycle. Exactly-once must hold group-wide over the
    composite ``(client, op, step*STRIDE+mb)`` keys, AND every migrated
    reply a successor serves must be re-scattered onto the SUCCESSOR's
    mesh — never handed out with the dead replica's placement (a
    sharded stage's device buffers die with it; only the host-encoded
    capture survives, and the successor's serve is an H2D re-scatter
    onto its own devices)."""
    import torch
    from split_learning_tpu_torch.parallel.mesh import local_devices
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.replica import ReplicaGroup
    from split_learning_tpu_torch.runtime.stage import MB_STRIDE, hop_seq

    ranks = local_devices("cpu")
    ndev = len(ranks)

    class _ResharedReplay(ReplayCache):
        """The successor's side of the handoff merge: ``put`` is the
        one entry point migrated records arrive through (born resolved,
        first-apply-wins), so the re-scatter onto the owner's mesh —
        and its note — live here."""

        def __init__(self, owner: Any) -> None:
            super().__init__(window=8)
            self._owner = owner

        def put(self, cid: int, op: str, st: int, result: Any) -> Any:
            ctx.note("migrate", key=(int(cid), str(op), int(st)),
                     dst=self._owner.placement)
            return super().put(cid, op, st, result)

    class _ShardedStageStub:
        """StageRuntime's hop-claim lifecycle minus the programs: a
        real ReplayCache decides ownership over the composite hop keys,
        only the owner notes apply, and serve-side placement is modeled
        by a real copy of a tiny buffer onto the replica's OWN rank —
        the re-scatter a sharded successor performs on a migrated host
        reply."""

        def __init__(self, idx: int) -> None:
            self.idx = idx
            self.stage_index = 1
            self.replay = _ResharedReplay(self)
            self._seq = -1
            # distinct placements when the host ranks allow: the
            # reshard the invariant tracks is host bytes -> THIS rank
            self.rank = idx % ndev
            self.device = ranks[self.rank]
            self.placement = f"replica{idx}/rank{self.rank}"
            ctx.note("mesh_of", replica=idx, mesh=self.placement)

        def health(self) -> Dict[str, Any]:
            return {"step": max(self._seq // MB_STRIDE, -1),
                    "status": "serving"}

        def _rescatter(self) -> None:
            buf = torch.from_numpy(np.zeros((1,), np.float32)).to(
                self.device)
            assert buf.device == self.device

        def hop_forward(self, x: Any, step: int, mb: int = 0,
                        client_id: int = 0, *,
                        device: bool = False) -> Any:
            seq = hop_seq(step, mb)
            key = (client_id, "hop_fwd", seq)
            entry, owner = self.replay.begin(client_id, "hop_fwd", seq)
            ctx.note("begin", key=key, owner=owner, replica=self.idx)
            if not owner:
                value = self.replay.wait(entry, timeout=30.0)
                self._rescatter()
                ctx.note("wait_return", key=key, value=value,
                         replica=self.idx, placement=self.placement)
                return value
            ctx.step("claim")  # the kill can land inside the window
            self._seq = max(self._seq, seq)
            ctx.note("apply", key=key, replica=self.idx)
            value = ("reply", client_id, seq, self.idx)
            self.replay.resolve(entry, value)
            ctx.note("resolve", key=key, value=value, replica=self.idx,
                     placement=self.placement)
            return value

        def flush_deferred(self) -> int:
            return 0

        def export_runtime_extras(self, step: int) -> Dict[str, Any]:
            from split_learning_tpu_torch.runtime import checkpoint as _ckpt
            return _ckpt.build_extras(
                step, 1, replay=self.replay.export_state(), wire_ef=[])

        def close(self) -> None:
            pass

    group = ReplicaGroup([_ShardedStageStub(i) for i in range(2)])
    victim = group.assignment(0)  # the replica client 0 lives on
    # a bystander client on the OTHER replica: its route must survive
    # the handoff unmoved (sticky routing is minimal-churn)
    other = next(c for c in range(1, 8)
                 if group.assignment(c) != victim)

    def deliver(cid: int, mb: int, tag: str) -> None:
        if tag == "dup":
            ctx.step("wire")  # the retransmit window
        group.hop_forward(None, 1, mb, cid)

    def killer() -> None:
        ctx.step("kill")  # explored against every lifecycle point
        group.kill(victim)

    workers = [ctx.spawn(deliver, 0, 0, "orig", name="c0-orig"),
               ctx.spawn(deliver, 0, 0, "dup", name="c0-dup"),
               ctx.spawn(deliver, other, 0, "orig", name="c-other"),
               ctx.spawn(killer, name="killer")]
    for w in workers:
        w.join()
    counters = group.counters()
    assert counters["replica_handoffs"] == 1, counters
    assert group.live_replicas() == [1 - victim]
    # stickiness: the bystander never moved off its surviving replica
    assert group.assignment(other) == 1 - victim
    return {"handoffs": int(counters["replica_handoffs"]),
            "migrated": int(counters["handoff_replay_entries"]),
            "fenced_waits": int(counters["replica_fenced_waits"])}


@scenario("stage_hop_claims",
          invariants=("exactly_once_claims", "admission_conservation"),
          budget=300, bound=2, requires="torch")
def stage_hop_claims(ctx: Ctx) -> Dict[str, Any]:
    """The REAL ``StageRuntime.hop_forward`` and ``hop_loss`` (their
    claim, admission and lock lifecycle; ROADMAP faults 14 and 15) under
    a duplicate forward and a raised stage program. A middle and a last
    stage are shells (built with __new__, so no model) whose stage
    program is a stub on the CPU behind a real ReplayCache and
    AdmissionController, both noting what they do. The duplicate forward
    must be served the owner's reply without running the program again;
    the loss hop whose program raises must release its admission slot
    and its claim, so that the retry re-owns it and the program runs
    exactly once; every admit is completed. This is a port scenario: the
    JAX package drives the same lifecycle through stubs only."""
    from collections import OrderedDict
    from types import SimpleNamespace

    import torch
    from split_learning_tpu_torch.obs import locks as obs_locks
    from split_learning_tpu_torch.runtime.admission import AdmissionController
    from split_learning_tpu_torch.runtime.party import _DeferredApply
    from split_learning_tpu_torch.runtime.replay import ReplayCache
    from split_learning_tpu_torch.runtime.stage import StageRuntime, hop_seq

    M, step = 2, 1

    def token(value: Any) -> Any:
        # a comparable stand-in for a reply (a tensor, or the loss hop's
        # (gradient, loss) pair)
        if isinstance(value, tuple):
            return tuple(token(v) for v in value)
        if isinstance(value, torch.Tensor):
            return tuple(round(float(v), 6) for v in value.flatten())
        return round(float(value), 6)

    class _Replay(ReplayCache):
        def begin(self, client_id: int, op: str, st: int) -> Any:
            entry, owner = super().begin(client_id, op, st)
            ctx.note("begin", key=entry.key, owner=owner)
            return entry, owner

        def resolve(self, entry: Any, result: Any) -> None:
            super().resolve(entry, result)
            ctx.note("resolve", key=entry.key, value=token(result))

        def fail(self, entry: Any, error: BaseException) -> None:
            super().fail(entry, error)
            ctx.note("fail", key=entry.key)

        def wait(self, entry: Any, timeout: float = 120.0) -> Any:
            result = super().wait(entry, timeout)
            ctx.note("wait_return", key=entry.key, value=token(result))
            return result

    class _Admission(AdmissionController):
        def admit(self, client_id: int) -> Optional[float]:
            deadline = super().admit(client_id)
            ctx.note("admitted", tenant=self.tenant_of(client_id))
            return deadline

        def complete(self, client_id: int) -> None:
            super().complete(client_id)
            ctx.note("completed", tenant=self.tenant_of(client_id))

    class _Program:
        """The stage program: ``x * w``, keyed by the hop seq its input
        carries; it raises once for each seq in ``boom``."""

        def __init__(self, op: str, boom: Tuple[int, ...] = ()) -> None:
            self.op, self.boom = op, set(boom)

        def apply(self, params: Any, x: Any) -> Any:
            seq = int(x.detach()[0, 0])
            if seq in self.boom:
                self.boom.discard(seq)
                raise RuntimeError(f"{self.op} program raised at {seq}")
            ctx.step("program")  # the launch window, under the lock
            ctx.note("apply", key=(0, self.op, seq))
            return x * params["w"]

    def shell(index: int, op: str, boom: Tuple[int, ...] = ()) -> Any:
        st = StageRuntime.__new__(StageRuntime)
        st.party, st.stage_index = f"stage{index}", index
        st.is_last = op == "hop_loss"
        st.microbatches, st.strict_steps = M, True
        st.device = torch.device("cpu")
        st._mesh, st._mesh_data, st._dd, st._ddtok = None, 1, None, None
        st._lock = obs_locks.make_lock("StageRuntime._lock")
        st.replay = _Replay(window=8)
        st._admission = _Admission(tenants=1, quota=100.0, burst=100.0,
                                   clock=ctx.clock.monotonic)
        st.state = SimpleNamespace(params=[{"w": torch.tensor(2.0)}])
        st._stage = _Program(op, boom)
        st._recs, st._last_seq, st._seq_floor = OrderedDict(), {}, -1
        st._hops = {"hop_fwd": 0, "hop_bwd": 0, "hop_loss": 0}
        st._deferred = _DeferredApply(
            lambda e: ctx.note("deferred_apply", step=e["step"]), 0,
            st._lock)
        return st

    mid = shell(1, "hop_fwd")
    last = shell(2, "hop_loss", boom=(hop_seq(step, 0),))

    def batch(mb: int) -> Any:
        return torch.full((1, 3), float(hop_seq(step, mb)))

    labels = torch.zeros((1,), dtype=torch.int64)
    fwd_done = [obs_locks.make_event(f"fwd{m}") for m in range(M)]

    def wire_fwd() -> None:
        for mb in range(M):
            mid.hop_forward(batch(mb), step, mb, 0)
            fwd_done[mb].set()

    def dup_fwd() -> None:
        ctx.step("wire")  # the retransmit window
        mid.hop_forward(batch(0), step, 0, 0)

    def wire_loss() -> None:
        for mb in range(M):
            fwd_done[mb].wait(timeout=30.0)
            try:
                last.hop_loss(batch(mb), labels, step, mb, 0)
            except RuntimeError:
                ctx.note("program_raised", mb=mb)
                last.hop_loss(batch(mb), labels, step, mb, 0)

    workers = [ctx.spawn(wire_fwd, name="w1-fwd"),
               ctx.spawn(dup_fwd, name="w1-dup"),
               ctx.spawn(wire_loss, name="w2-loss")]
    for w in workers:
        w.join()
    for st in (mid, last):
        depth = st._admission.gauges()["admission_queue_depth_t0"]
        ctx.note("final_depth", tenant=0, depth=int(depth))
    assert mid._hops["hop_fwd"] == M and last._hops["hop_loss"] == M, (
        mid._hops, last._hops)
    assert last._deferred.counters()["deferred_applied"] == 1
    return {"hits": mid.replay.hits + last.replay.hits}


# --------------------------------------------------------------------- #
# crash–restart scenarios (slt-crash, SLT109–112)
# --------------------------------------------------------------------- #

@dataclass
class CrashScenario:
    """One registered crash–restart scenario: a workload
    ``fn(ctx, store)`` the explorer kills at every sampled transition,
    and a ``recover(ctx, store, pre_run)`` that rebuilds a server from
    the DurableStore survivors and replays the client's uncertain
    window. Explored by ``explore_crashes`` (budget = base
    interleavings, crash_budget = killed replays of those bases)."""

    name: str
    workload: Callable[..., Optional[Dict[str, Any]]]
    recover: Callable[..., Optional[Dict[str, Any]]]
    invariants: Tuple[str, ...] = ()
    budget: int = 12
    crash_budget: int = 170
    bound: Optional[int] = 2
    requires: Optional[str] = None
    doc: str = ""

    def available(self) -> bool:
        return _importable(self.requires)


CRASH_SCENARIOS: Dict[str, CrashScenario] = {}


def crash_scenario(name: str, *, recover: Callable,
                   invariants: Tuple[str, ...] = (),
                   budget: int = 12, crash_budget: int = 170,
                   bound: Optional[int] = 2,
                   requires: Optional[str] = None) -> Callable:
    def wrap(fn: Callable) -> Callable:
        CRASH_SCENARIOS[name] = CrashScenario(
            name=name, workload=fn, recover=recover,
            invariants=invariants, budget=budget,
            crash_budget=crash_budget, bound=bound, requires=requires,
            doc=(fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__
            else "")
        return fn
    return wrap


_CKPT_DIR = "ckpt"


class _CrashRig:
    """The server half the crash scenarios drive: a real ReplayCache,
    an ``applied`` list standing in for the params, a monotonic
    checkpoint lineage, and (optionally) a real _DeferredApply queue —
    all synchronized by one runtime lock so the checkpoint capture is a
    consistent cut: any step whose reply was resolved into the cache is
    also in ``applied`` at capture time (apply/push and resolve happen
    in the same lock hold; deferred queues are flushed under the lock
    before the snapshot). That cut is what makes serving a post-restart
    duplicate from the restored cache sound."""

    def __init__(self, ctx: Ctx, deferred_lag: Optional[int] = None
                 ) -> None:
        from split_learning_tpu_torch.obs import locks as obs_locks
        from split_learning_tpu_torch.runtime.replay import ReplayCache
        self.ctx = ctx
        self.lock = obs_locks.make_lock("CrashRig._lock")
        self.cache = ReplayCache(window=16, max_total=128)
        self.applied: list = []
        self.lineage = 0
        self.dq = None
        if deferred_lag is not None:
            from split_learning_tpu_torch.runtime.server import _DeferredApply

            def apply_fn(entry: Dict[str, Any]) -> None:
                ctx.note("c_apply", key=entry["key"])
                self.applied.append(entry["key"])

            self.dq = _DeferredApply(apply_fn, deferred_lag, self.lock)

    def handle(self, cid: int, op: str, step: int) -> Any:
        """One delivery of one step: claim, apply (direct or via the
        deferred queue), resolve — duplicates wait on the in-flight
        future or hit the done entry."""
        key = (cid, op, step)
        entry, owner = self.cache.begin(*key)
        if owner:
            body = f"r:{cid}:{op}:{step}".encode("utf-8")
            with self.lock:
                if self.dq is not None:
                    # reply-first: the update queues, the reply ships
                    self.dq.push({"key": key})
                    self.dq.drain_over_lag()
                else:
                    self.ctx.step("apply")
                    self.ctx.note("c_apply", key=key)
                    self.applied.append(key)
                # resolve inside the same hold as the apply/push: the
                # checkpoint capture must never see a resolved reply
                # whose update it did not also capture
                self.cache.resolve(entry, f"r:{cid}:{op}:{step}")
                self.cache.attach_body(cid, op, step, body)
            return entry.result
        return self.cache.wait(entry, timeout=30.0)

    def client(self, cid: int, steps: Tuple[int, ...],
               op: str = "split_step") -> None:
        """The client protocol: send, receive, ack — with a wire yield
        between reply and ack so a crash can strand a replied-but-
        unacked step."""
        for step in steps:
            key = (cid, op, step)
            self.ctx.note("c_sent", key=key)
            value = self.handle(cid, op, step)
            self.ctx.note("c_reply", key=key, value=value)
            self.ctx.step("wire")
            self.ctx.note("c_ack", key=key)

    def checkpoint(self, store: Any, step: int) -> None:
        """Flush-deferred-then-capture under the lock, publish via the
        real tmp+fsync+rename writer outside it, note the commit in the
        same slice as the rename (no yield between — the noted commit
        set IS the durable set)."""
        from split_learning_tpu_torch.runtime.checkpoint import (
            EXTRAS_VERSION, encode_obj, finalize_extras, write_extras)
        with self.lock:
            if self.dq is not None:
                self.dq.flush()
            depth = self.dq.depth() if self.dq is not None else 0
            self.ctx.note("c_save_capture", step=step, depth=depth)
            self.lineage += 1
            lineage = self.lineage
            captured = list(self.applied)
            payload = finalize_extras({
                "version": EXTRAS_VERSION, "step": int(step),
                "lineage": lineage,
                "replay": encode_obj(self.cache.export_state()),
                "state": encode_obj(captured)})
        write_extras(_CKPT_DIR, payload, fs=store)
        self.ctx.note("c_commit", step=step, lineage=lineage,
                      captured=captured)

    def flush(self) -> None:
        if self.dq is not None:
            with self.lock:
                self.dq.flush()


def _crash_recover(deferred_lag: Optional[int] = None) -> Callable:
    """Build the shared recovery protocol: restore the newest durable
    checkpoint (replay cache + captured set), then replay the client's
    uncertain window — every sent step not in the captured set is
    retried (it must re-apply exactly once); every captured step is
    retried too and must be absorbed by the restored replay cache, its
    reply bit-identical for steps the client already acked."""
    def recover(ctx: Ctx, store: Any, pre: Any) -> Dict[str, Any]:
        from split_learning_tpu_torch.runtime.checkpoint import (
            decode_obj, read_latest_extras)
        payload = read_latest_extras(_CKPT_DIR, fs=store)
        rig = _CrashRig(ctx, deferred_lag=deferred_lag)
        captured: set = set()
        if payload is None:
            ctx.note("c_restore", step=None, lineage=None, torn=False)
        else:
            ctx.note("c_restore", step=payload["step"],
                     lineage=payload["lineage"], torn=False)
            rig.cache.restore_state(decode_obj(payload["replay"]))
            captured = set(decode_obj(payload["state"]))
            rig.lineage = payload["lineage"]
        sent: list = []
        acked: set = set()
        for kind, f in pre.notes:
            if kind == "c_sent":
                sent.append(tuple(f["key"]))
            elif kind == "c_ack":
                acked.add(tuple(f["key"]))
        for key in sent:
            value = rig.handle(*key)
            if key in captured and key in acked:
                ctx.note("c_replay_reply", key=key, value=value)
        rig.flush()
        return {"restored_step": payload["step"] if payload else None,
                "replayed": len(sent)}
    return recover


@crash_scenario("crash_replay_dup_storm",
                recover=_crash_recover(),
                invariants=("durable_exactly_once",
                            "checkpoint_atomicity",
                            "replay_recovery_bit_identical"),
                budget=12, crash_budget=170, bound=2, requires="torch")
def crash_replay_dup_storm(ctx: Ctx, store: Any) -> Dict[str, Any]:
    """Two clients and a duplicate delivery race one mid-run checkpoint;
    a crash at any transition must lose no acked step, double-apply
    none, and serve post-restart duplicates the byte-identical reply."""
    rig = _CrashRig(ctx)

    def dup() -> None:
        ctx.step("wire")  # the retransmit window
        rig.handle(0, "split_step", 1)

    workers = [ctx.spawn(rig.client, 0, (1, 2), name="cl-0"),
               ctx.spawn(rig.client, 1, (1,), name="cl-1"),
               ctx.spawn(dup, name="dup"),
               ctx.spawn(rig.checkpoint, store, 1, name="ckptr")]
    for w in workers:
        w.join()
    rig.checkpoint(store, 2)
    return {"applied": len(rig.applied)}


@crash_scenario("crash_deferred_queue",
                recover=_crash_recover(deferred_lag=1),
                invariants=("durable_exactly_once",
                            "checkpoint_atomicity",
                            "replay_recovery_bit_identical",
                            "flush_before_save"),
                budget=12, crash_budget=170, bound=2, requires="torch")
def crash_deferred_queue(ctx: Ctx, store: Any) -> Dict[str, Any]:
    """Reply-first decoupled backward under crashes: replies ship while
    weight updates sit in the deferred queue (lag=1), a checkpoint
    races the stream — the capture must flush the queue first, and a
    crash that vaporizes queued updates must be healed by the client's
    replay, never by a double-apply."""
    rig = _CrashRig(ctx, deferred_lag=1)

    workers = [ctx.spawn(rig.client, 0, (1, 2, 3), name="cl-0"),
               ctx.spawn(rig.checkpoint, store, 1, name="ckptr")]
    for w in workers:
        w.join()
    rig.flush()
    rig.checkpoint(store, 3)
    return {"applied": len(rig.applied)}


@crash_scenario("crash_ckpt_race",
                recover=_crash_recover(),
                invariants=("durable_exactly_once",
                            "checkpoint_atomicity",
                            "replay_recovery_bit_identical"),
                budget=12, crash_budget=170, bound=2, requires="torch")
def crash_ckpt_race(ctx: Ctx, store: Any) -> Dict[str, Any]:
    """Back-to-back checkpoints race a two-step client: crash points
    inside the tmp-write/fsync/rename sequence must leave either the
    old or the new sidecar fully intact (never a torn one accepted),
    with the restore observing exactly the newest committed lineage."""
    rig = _CrashRig(ctx)

    def ckptr() -> None:
        rig.checkpoint(store, 1)
        rig.checkpoint(store, 2)

    workers = [ctx.spawn(rig.client, 0, (1, 2), name="cl-0"),
               ctx.spawn(ckptr, name="ckptr")]
    for w in workers:
        w.join()
    return {"applied": len(rig.applied)}
