"""Concurrency invariants slt-check asserts over every explored schedule.

Each invariant is a function ``fn(run) -> None`` that raises
:class:`Violation` when the
:class:`~split_learning_tpu_torch.analysis.sched.Run` breaks it. They read two surfaces:

- the run's built-in diagnoses (``run.deadlock``, ``run.stalled``,
  ``run.error``, ``run.thread_errors``), and
- semantic **notes** the scenario emitted via ``ctx.note(kind, ...)``
  while driving the real runtime objects — e.g. ``("begin", {"key":
  ..., "owner": True})`` when a thread wins a ReplayCache claim.

The generic invariants (:data:`GENERIC`) apply to every scenario; the
named ones are opted into per scenario via the registry in
scenarios.py. tests/test_torch_port_sched.py reuses both against
deliberately broken toy objects to prove each invariant actually fires.

Stdlib-only (tests/test_torch_port_analysis.py pins it): invariants see
note tuples and plain dicts, never arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["Violation", "INVARIANTS", "GENERIC", "check_run",
           "RULE_OF_INVARIANT"]


class Violation(AssertionError):
    """One invariant broken on one schedule — carries the replayable id."""

    def __init__(self, invariant: str, schedule_id: str,
                 message: str) -> None:
        self.invariant = invariant
        self.schedule_id = schedule_id
        self.message = message
        super().__init__(f"[{invariant}] {message} "
                         f"(replay: --schedule {schedule_id})")


def _notes(run: Any, kind: str) -> List[Dict[str, Any]]:
    return [fields for k, fields in run.notes if k == kind]


# --------------------------------------------------------------------- #
# generic invariants — every scenario, every schedule
# --------------------------------------------------------------------- #

def deadlock_free(run: Any) -> None:
    """No schedule may end with a lock wait-for cycle."""
    if run.deadlock:
        cycle = " -> ".join(t["name"] for t in run.deadlock["cycle"])
        raise Violation("deadlock_free", run.schedule_id,
                        f"lock cycle {cycle}")


def no_lost_wakeup(run: Any) -> None:
    """No schedule may end with threads blocked forever on a condition
    or event that nothing will ever signal (and no lock cycle to blame
    — that is :func:`deadlock_free`'s finding)."""
    if run.stalled and not run.deadlock:
        who = ", ".join(f"{t['name']}@{t['op']}({t['obj']})"
                        for t in run.stalled)
        raise Violation("no_lost_wakeup", run.schedule_id,
                        f"threads stuck with nothing runnable: {who}")


def no_errors(run: Any) -> None:
    """Scenario code and its spawned threads completed without raising
    (scenarios that *expect* an exception catch it and note it)."""
    if run.error is not None:
        raise Violation("no_errors", run.schedule_id,
                        f"scenario raised {run.error!r}")
    if run.thread_errors:
        who = "; ".join(f"{e['name']}: {e['error']}"
                        for e in run.thread_errors)
        raise Violation("no_errors", run.schedule_id,
                        f"thread raised: {who}")


GENERIC: Tuple[Callable[[Any], None], ...] = (
    deadlock_free, no_lost_wakeup, no_errors)


# --------------------------------------------------------------------- #
# named invariants — opted into by scenario
# --------------------------------------------------------------------- #

def exactly_once_claims(run: Any) -> None:
    """ReplayCache claim lifecycle under a duplicate storm: per key,
    exactly one ``begin`` wins ownership per claim generation, the apply
    runs exactly once per resolved claim, and every duplicate's ``wait``
    returns the owner's single materialized value.

    Notes read: ``begin(key, owner)``, ``apply(key)``, ``resolve(key,
    value)``, ``wait_return(key, value)``."""
    owners: Dict[Any, int] = {}
    applies: Dict[Any, int] = {}
    resolved: Dict[Any, List[Any]] = {}
    for f in _notes(run, "begin"):
        if f.get("owner"):
            owners[f["key"]] = owners.get(f["key"], 0) + 1
    for f in _notes(run, "apply"):
        applies[f["key"]] = applies.get(f["key"], 0) + 1
    for f in _notes(run, "resolve"):
        resolved.setdefault(f["key"], []).append(f.get("value"))
    # a fail()ed or 429'd claim is released, so a retry legitimately
    # re-owns the key; both note kinds mark that release
    fails = ({f["key"] for f in _notes(run, "fail")}
             | {f["key"] for f in _notes(run, "backpressure")})
    for key, n in applies.items():
        if n > 1:
            raise Violation(
                "exactly_once_claims", run.schedule_id,
                f"step {key} applied {n} times — the update ran twice")
    for key, n in owners.items():
        if n > 1 and key not in fails:
            raise Violation(
                "exactly_once_claims", run.schedule_id,
                f"step {key} claimed by {n} owners with no fail between")
    for f in _notes(run, "wait_return"):
        vals = resolved.get(f["key"], [])
        if f.get("value") not in vals:
            raise Violation(
                "exactly_once_claims", run.schedule_id,
                f"duplicate of {f['key']} returned {f.get('value')!r}, "
                f"not the owner's resolved value {vals!r}")


def edf_pickup_order(run: Any) -> None:
    """Continuous-mode group pickup is earliest-deadline-first with
    arrival order breaking ties: within each dispatched group, requests
    are nondecreasing in ``(deadline ?? inf, seq)``, and no queued
    request with an earlier deadline than the group head was left
    behind at pickup time.

    Notes read: ``pickup(group=[(deadline_or_None, seq), ...],
    left=[(deadline_or_None, seq), ...])``."""
    def sortkey(pair: Any) -> Tuple[float, int]:
        deadline, seq = pair
        return (float("inf") if deadline is None else deadline, seq)

    for f in _notes(run, "pickup"):
        group = [tuple(p) for p in f["group"]]
        if group != sorted(group, key=sortkey):
            raise Violation(
                "edf_pickup_order", run.schedule_id,
                f"group picked up out of EDF order: {group}")
        left = [tuple(p) for p in f.get("left", ())]
        if group and left:
            head = min(sortkey(p) for p in group)
            overtaken = [p for p in left if sortkey(p) < head]
            if overtaken:
                raise Violation(
                    "edf_pickup_order", run.schedule_id,
                    f"queued request(s) {overtaken} had earlier deadlines "
                    f"than the picked head {group[0]}")


def reclaimable_429(run: Any) -> None:
    """A step refused by admission (429/Backpressure) must release its
    replay claim so the advised retry can re-own it: every noted
    ``backpressure(key)`` is followed by the key being re-owned and
    finally applied exactly once.

    Notes read: ``backpressure(key)``, ``begin(key, owner)``,
    ``apply(key)``."""
    bp_keys = [f["key"] for f in _notes(run, "backpressure")]
    applies: Dict[Any, int] = {}
    for f in _notes(run, "apply"):
        applies[f["key"]] = applies.get(f["key"], 0) + 1
    for key in bp_keys:
        if applies.get(key, 0) != 1:
            raise Violation(
                "reclaimable_429", run.schedule_id,
                f"step {key} hit backpressure and was applied "
                f"{applies.get(key, 0)} times (want exactly 1: the "
                f"refused claim must be released for the retry)")


def admission_conservation(run: Any) -> None:
    """Token/depth accounting closes: every admit is paired with a
    complete (the in-flight depth gauge drains to zero), and admits
    never exceed what the bucket could have issued.

    Notes read: ``admitted(tenant)``, ``completed(tenant)``,
    ``final_depth(tenant, depth)``, optional ``max_admits(tenant, n)``."""
    admits: Dict[Any, int] = {}
    completes: Dict[Any, int] = {}
    for f in _notes(run, "admitted"):
        admits[f["tenant"]] = admits.get(f["tenant"], 0) + 1
    for f in _notes(run, "completed"):
        completes[f["tenant"]] = completes.get(f["tenant"], 0) + 1
    for t, n in admits.items():
        if completes.get(t, 0) != n:
            raise Violation(
                "admission_conservation", run.schedule_id,
                f"tenant {t}: {n} admits vs {completes.get(t, 0)} "
                f"completes — in-flight slots leaked")
    for f in _notes(run, "final_depth"):
        if f["depth"] != 0:
            raise Violation(
                "admission_conservation", run.schedule_id,
                f"tenant {f['tenant']} ended with in-flight depth "
                f"{f['depth']} (want 0)")
    for f in _notes(run, "max_admits"):
        if admits.get(f["tenant"], 0) > f["n"]:
            raise Violation(
                "admission_conservation", run.schedule_id,
                f"tenant {f['tenant']} admitted "
                f"{admits.get(f['tenant'], 0)} steps, bucket only held "
                f"{f['n']}")


def all_resolved(run: Any) -> None:
    """Every request handed to the coalescer/fleet came back resolved
    exactly once — no waiter was dropped and none was double-resolved.

    Notes read: ``enqueue(key)``, ``resolved(key)``."""
    submitted = [f["key"] for f in _notes(run, "enqueue")]
    resolved: Dict[Any, int] = {}
    for f in _notes(run, "resolved"):
        resolved[f["key"]] = resolved.get(f["key"], 0) + 1
    for key in submitted:
        n = resolved.get(key, 0)
        if n != 1:
            raise Violation(
                "all_resolved", run.schedule_id,
                f"request {key} resolved {n} times (want exactly 1)")


def deferred_apply_exactly_once(run: Any) -> None:
    """Decoupled-backward queue discipline: every weight update
    the reply path enqueued is applied exactly once, applies happen in
    enqueue order (the drain is FIFO — out-of-order application breaks
    the delayed-gradient semantics the staleness bound is stated for),
    and a drain that ran to completion (``final_depth``) left nothing
    behind.

    Notes read: ``da_enqueue(key)``, ``da_apply(key)``,
    ``da_final_depth(depth)``."""
    enq = [f["key"] for f in _notes(run, "da_enqueue")]
    applied = [f["key"] for f in _notes(run, "da_apply")]
    counts: Dict[Any, int] = {}
    for key in applied:
        counts[key] = counts.get(key, 0) + 1
    for key, n in counts.items():
        if n > 1:
            raise Violation(
                "deferred_apply_exactly_once", run.schedule_id,
                f"deferred apply {key} ran {n} times — the weight "
                f"update double-applied")
        if key not in enq:
            raise Violation(
                "deferred_apply_exactly_once", run.schedule_id,
                f"deferred apply {key} ran but was never enqueued")
    for f in _notes(run, "da_final_depth"):
        if f["depth"] != 0:
            raise Violation(
                "deferred_apply_exactly_once", run.schedule_id,
                f"drain finished with {f['depth']} update(s) still "
                f"queued (want 0: close()/flush must not strand applies "
                f"whose replies already shipped)")
        missing = [k for k in enq if counts.get(k, 0) != 1]
        if missing:
            raise Violation(
                "deferred_apply_exactly_once", run.schedule_id,
                f"enqueued update(s) {missing} never applied despite a "
                f"completed drain")
    # FIFO order: the applied sequence must be the enqueue sequence
    # restricted to applied keys (prefix if the run ended mid-queue)
    expect = [k for k in enq if k in counts]
    if applied != expect:
        raise Violation(
            "deferred_apply_exactly_once", run.schedule_id,
            f"applies ran out of enqueue order: {applied} vs {expect}")


def pipeline_hops_exactly_once(run: Any) -> None:
    """MPMD hop discipline: every microbatch's forward hop and
    backward-cotangent hop is applied exactly once per stage under
    duplicate/dropped deliveries, applies land in microbatch order per
    (stage, direction, step) — the per-wire FIFO workers guarantee it,
    and the GPipe accumulation order depends on it — and no
    microbatch's cotangent applies before its forward residual exists.

    Notes read: ``hop_sent(stage, dir, step, mb)`` once per intended
    hop; ``hop_apply(stage, dir, step, mb)`` from replay-claim owners
    only (a duplicate served from the cache must not re-note)."""
    sent = [(f["stage"], f["dir"], f["step"], f["mb"])
            for f in _notes(run, "hop_sent")]
    applies = [(f["stage"], f["dir"], f["step"], f["mb"])
               for f in _notes(run, "hop_apply")]
    counts: Dict[Any, int] = {}
    for key in applies:
        counts[key] = counts.get(key, 0) + 1
    for key, n in counts.items():
        if n > 1:
            raise Violation(
                "pipeline_hops_exactly_once", run.schedule_id,
                f"hop {key} applied {n} times — a duplicate delivery "
                f"re-ran the stage program")
        if key not in sent:
            raise Violation(
                "pipeline_hops_exactly_once", run.schedule_id,
                f"hop {key} applied but was never sent")
    for key in sent:
        if counts.get(key, 0) != 1:
            raise Violation(
                "pipeline_hops_exactly_once", run.schedule_id,
                f"hop {key} applied {counts.get(key, 0)} times (want "
                f"exactly 1: drops must be healed by retry, dups by "
                f"the replay claim)")
    # microbatch order per (stage, dir, step): the apply sequence must
    # be nondecreasing in mb — FIFO wire workers never reorder
    seq: Dict[Any, List[int]] = {}
    for stage, d, step, mb in applies:
        seq.setdefault((stage, d, step), []).append(mb)
    for key, mbs in seq.items():
        if mbs != sorted(mbs):
            raise Violation(
                "pipeline_hops_exactly_once", run.schedule_id,
                f"stage/dir/step {key} applied microbatches out of "
                f"order: {mbs}")
    # causality: a cotangent needs its forward residual — bwd(mb) after
    # fwd(mb) at the same stage and step
    pos = {key: i for i, key in enumerate(applies)}
    for stage, d, step, mb in applies:
        if d == "bwd":
            fwd = (stage, "fwd", step, mb)
            if fwd in pos and pos[fwd] > pos[(stage, d, step, mb)]:
                raise Violation(
                    "pipeline_hops_exactly_once", run.schedule_id,
                    f"stage {stage} step {step} mb {mb}: backward hop "
                    f"applied before its forward residual existed")


def onefb_hop_order(run: Any) -> None:
    """1F1B steady-state hop discipline: the schedule changes
    *when* microbatches enter the wire, never *what* the wire must
    guarantee — so every hop still applies exactly once, in microbatch
    order per (stage, dir, step), and no cotangent ever applies before
    its forward residual (never backward-before-forward). On top of
    that, 1F1B's whole point is the bounded window: after the warmup of
    W = min(S, M) forwards, one new microbatch may enter only after a
    cotangent drained, so the in-flight depth never exceeds W.

    Notes read: everything ``pipeline_hops_exactly_once`` reads, plus
    ``inflight(depth, bound)`` emitted by the driver at every injection
    point (depth AFTER the inject; bound = W)."""
    try:
        pipeline_hops_exactly_once(run)
    except Violation as v:
        raise Violation("onefb_hop_order", run.schedule_id, v.message)
    for f in _notes(run, "inflight"):
        if f["depth"] > f["bound"]:
            raise Violation(
                "onefb_hop_order", run.schedule_id,
                f"in-flight depth {f['depth']} exceeds the 1F1B window "
                f"{f['bound']} — a forward injected before its slot's "
                f"cotangent drained")


# --------------------------------------------------------------------- #
# crash–restart invariants (slt-crash) — read the ("crash", ...) marker
# a CrashRun inserts between the killed workload and the recovery phase
# --------------------------------------------------------------------- #

def _split_crash(run: Any) -> Tuple[List[Tuple[str, Dict[str, Any]]],
                                    List[Tuple[str, Dict[str, Any]]],
                                    Dict[str, Any]]:
    """Split ``run.notes`` at the first ``("crash", ...)`` marker into
    (pre-crash notes, post-restart notes, marker fields). A run without
    the marker (a plain interleaving) is all-pre."""
    for i, (kind, fields) in enumerate(run.notes):
        if kind == "crash":
            return list(run.notes[:i]), list(run.notes[i + 1:]), dict(fields)
    return list(run.notes), [], {}


def _kinds(notes: List[Tuple[str, Dict[str, Any]]],
           kind: str) -> List[Dict[str, Any]]:
    return [fields for k, fields in notes if k == kind]


def _key(f: Dict[str, Any]) -> Any:
    k = f["key"]
    return tuple(k) if isinstance(k, list) else k


def durable_exactly_once(run: Any) -> None:
    """No acked step is lost and none double-applied across a crash:
    for every step the client sent, the update lands in the durable
    timeline exactly once — either captured by the checkpoint the
    recovery restored, or re-applied exactly once after restart (the
    client replays steps past the restore point and retries its
    in-flight step; a captured step's retry must be served from the
    restored replay cache, not re-applied).

    Notes read: pre ``c_sent(key)``; post ``c_apply(key)``; post
    ``c_restore(step, lineage)``; pre ``c_commit(step, lineage,
    captured=[keys...])``."""
    pre, post, _ = _split_crash(run)
    sent = {_key(f) for f in _kinds(pre, "c_sent")}
    restores = _kinds(post, "c_restore")
    restored = restores[-1] if restores else None
    surviving: set = set()
    if restored is not None and restored.get("step") is not None:
        want = (restored["step"], restored.get("lineage"))
        for f in _kinds(pre, "c_commit"):
            if (f["step"], f.get("lineage")) == want:
                surviving = {tuple(k) if isinstance(k, list) else k
                             for k in f.get("captured", ())}
    post_applies: Dict[Any, int] = {}
    for f in _kinds(post, "c_apply"):
        post_applies[_key(f)] = post_applies.get(_key(f), 0) + 1
    for key, n in post_applies.items():
        if n > 1:
            raise Violation(
                "durable_exactly_once", run.schedule_id,
                f"step {key} applied {n} times after restart — the "
                f"update double-applied")
    for key in sorted(sent):
        landed = (1 if key in surviving else 0) + post_applies.get(key, 0)
        if landed == 0:
            raise Violation(
                "durable_exactly_once", run.schedule_id,
                f"step {key} was sent but its update is in neither the "
                f"restored checkpoint nor the post-restart applies — "
                f"lost across the crash")
        if landed > 1:
            raise Violation(
                "durable_exactly_once", run.schedule_id,
                f"step {key} survived in the checkpoint AND re-applied "
                f"after restart — double-applied "
                f"(captured={key in surviving}, "
                f"post={post_applies.get(key, 0)})")


def checkpoint_atomicity(run: Any) -> None:
    """A restore observes a committed checkpoint or nothing: never a
    torn file, never a lineage that regressed, and exactly the newest
    commit whose rename completed before the crash (commit notes are
    emitted in the same scheduler slice as the rename, so the noted set
    IS the durable set).

    Notes read: pre ``c_commit(step, lineage)``; post
    ``c_restore(step, lineage, torn)``."""
    pre, post, _ = _split_crash(run)
    commits = [(f["step"], f.get("lineage"))
               for f in _kinds(pre, "c_commit")]
    for a, b in zip(commits, commits[1:]):
        if b <= a:
            raise Violation(
                "checkpoint_atomicity", run.schedule_id,
                f"checkpoint lineage not strictly increasing: "
                f"{a} then {b}")
    for f in _kinds(post, "c_restore"):
        if f.get("torn"):
            raise Violation(
                "checkpoint_atomicity", run.schedule_id,
                f"recovery accepted a torn checkpoint at step "
                f"{f.get('step')} — checksum/rename discipline broken")
        got = (f.get("step"), f.get("lineage"))
        want = max(commits) if commits else (None, None)
        if got != want:
            raise Violation(
                "checkpoint_atomicity", run.schedule_id,
                f"restore observed checkpoint {got}, newest durable "
                f"commit was {want}")


def replay_recovery_bit_identical(run: Any) -> None:
    """A duplicate of an already-replied step, retried after restart,
    is served the byte-identical reply from the restored replay cache —
    never recomputed into a different value, never a miss for a step
    the restored checkpoint captured.

    Notes read: pre ``c_reply(key, value)``; post
    ``c_replay_reply(key, value)``."""
    pre, post, _ = _split_crash(run)
    first: Dict[Any, Any] = {}
    for f in _kinds(pre, "c_reply"):
        first.setdefault(_key(f), f.get("value"))
    for f in _kinds(post, "c_replay_reply"):
        key = _key(f)
        if key not in first:
            raise Violation(
                "replay_recovery_bit_identical", run.schedule_id,
                f"restored replay cache served step {key} that was "
                f"never replied before the crash")
        if f.get("value") != first[key]:
            raise Violation(
                "replay_recovery_bit_identical", run.schedule_id,
                f"step {key} replayed as {f.get('value')!r} after "
                f"restart, original reply was {first[key]!r} — not "
                f"bit-identical")


def handoff_exactly_once(run: Any) -> None:
    """Failover-handoff discipline: with a replica dying at any
    point of the claim lifecycle, every (client, op, step) is applied
    exactly once GROUP-WIDE — the dead replica's migrated replay entries
    must make its clients' successors serve duplicates from cache, never
    re-run them — and every duplicate's wait returns a value some
    replica actually resolved (one materialized reply per key, wherever
    the client was routed).

    Notes read: ``begin(key, owner, replica)``, ``apply(key,
    replica)``, ``resolve(key, value, replica)``, ``wait_return(key,
    value, replica)``."""
    applies: Dict[Any, List[Any]] = {}
    for f in _notes(run, "apply"):
        applies.setdefault(f["key"], []).append(f.get("replica"))
    resolved: Dict[Any, List[Any]] = {}
    for f in _notes(run, "resolve"):
        resolved.setdefault(f["key"], []).append(f.get("value"))
    for key, replicas in applies.items():
        if len(replicas) > 1:
            where = sorted(set(r for r in replicas if r is not None))
            if len(where) > 1:
                raise Violation(
                    "handoff_exactly_once", run.schedule_id,
                    f"step {key} applied on replicas {where} — the "
                    f"handoff rerouted the client but its claim did not "
                    f"migrate, so the step re-ran on the successor")
            raise Violation(
                "handoff_exactly_once", run.schedule_id,
                f"step {key} applied {len(replicas)} times on one "
                f"replica")
    for key in {f["key"] for f in _notes(run, "begin")}:
        n = len(applies.get(key, []))
        if n != 1:
            raise Violation(
                "handoff_exactly_once", run.schedule_id,
                f"step {key} applied {n} times group-wide (want exactly "
                f"1 across the death and the re-route)")
    for f in _notes(run, "wait_return"):
        vals = resolved.get(f["key"], [])
        if f.get("value") not in vals:
            raise Violation(
                "handoff_exactly_once", run.schedule_id,
                f"duplicate of {f['key']} was served {f.get('value')!r} "
                f"on replica {f.get('replica')}, which no replica ever "
                f"resolved — not the one materialized reply")


def scale_down_exactly_once(run: Any) -> None:
    """Elastic scale-down discipline: a policy-driven
    ``remove_replica`` is the same fence/quiesce/capture/merge/reroute
    handoff as a death, so every (client, op, step) must apply exactly
    once group-wide and every duplicate's wait must return the one
    materialized reply — AND the retired replica must never apply a
    step after its ``scale_down`` note: the fence precedes the capture,
    so an apply landing afterwards would be state the merge already
    missed.

    Notes read: ``begin(key, owner, replica)``, ``apply(key,
    replica)``, ``resolve(key, value, replica)``, ``wait_return(key,
    value, replica)``, ``scale_down(replica)``."""
    handoff_exactly_once(run)
    retired: set = set()
    for kind, fields in run.notes:
        if kind == "scale_down":
            retired.add(fields.get("replica"))
        elif kind == "apply" and fields.get("replica") in retired:
            raise Violation(
                "scale_down_exactly_once", run.schedule_id,
                f"step {fields.get('key')} applied on replica "
                f"{fields.get('replica')} AFTER that replica's "
                f"scale-down committed — the fence precedes the "
                f"capture, so this apply is state the handoff merge "
                f"never saw")


def sharded_handoff_reshard(run: Any) -> None:
    """Sharded-stage failover discipline: everything
    :func:`handoff_exactly_once` demands — here over the composite hop
    keys ``(client, op, step*STRIDE+mb)`` — plus the placement half of
    the handoff: a migrated reply served by a successor must have been
    re-scattered onto the SUCCESSOR's mesh during the handoff merge,
    and every serve must hand out the serving replica's own placement,
    never the dead replica's (a stale device buffer outliving its mesh
    is exactly the bug a host-encoded capture exists to prevent).

    Notes read: the SLT114 set (``begin(key, owner, replica)``,
    ``apply(key, replica)``, ``resolve(key, value, replica)``,
    ``wait_return(key, value, replica)``), plus ``mesh_of(replica,
    mesh)`` noted once per replica at build, ``migrate(key, dst)``
    noted by the handoff merge per installed entry, and a
    ``placement`` field on ``resolve``/``wait_return``."""
    handoff_exactly_once(run)
    mesh_of: Dict[Any, Any] = {}
    for f in _notes(run, "mesh_of"):
        mesh_of[f.get("replica")] = f.get("mesh")
    resolved_on: Dict[Any, Any] = {}
    for f in _notes(run, "resolve"):
        resolved_on.setdefault(f["key"], f.get("replica"))
    migrated: Dict[Any, Any] = {}
    for f in _notes(run, "migrate"):
        migrated[f["key"]] = f.get("dst")
    for f in _notes(run, "wait_return"):
        serving = f.get("replica")
        own_mesh = mesh_of.get(serving)
        if f.get("placement") != own_mesh:
            raise Violation(
                "sharded_handoff_reshard", run.schedule_id,
                f"duplicate of {f['key']} served from replica "
                f"{serving} with placement {f.get('placement')!r}; the "
                f"replica's own mesh is {own_mesh!r} — a stale buffer "
                f"outlived its mesh")
        origin = resolved_on.get(f["key"])
        if origin is None or origin == serving:
            continue
        dst = migrated.get(f["key"])
        if dst is None:
            raise Violation(
                "sharded_handoff_reshard", run.schedule_id,
                f"duplicate of {f['key']} served by replica {serving} "
                f"but resolved on replica {origin} with no migrated "
                f"entry — the handoff merge never carried it over")
        if dst != own_mesh:
            raise Violation(
                "sharded_handoff_reshard", run.schedule_id,
                f"entry {f['key']} migrated with placement {dst!r}, "
                f"but the serving replica's mesh is {own_mesh!r} — the "
                f"captured extras were not re-scattered onto the "
                f"successor's mesh")


def flush_before_save(run: Any) -> None:
    """Checkpoint capture happens only after the deferred-apply queue
    drained: a snapshot taken with updates still queued persists params
    that are missing replies the server already shipped.

    Notes read: ``c_save_capture(step, depth)`` (either phase)."""
    for f in _notes(run, "c_save_capture"):
        if f.get("depth", 0) != 0:
            raise Violation(
                "flush_before_save", run.schedule_id,
                f"checkpoint at step {f.get('step')} captured with "
                f"{f['depth']} deferred update(s) still queued — "
                f"flush-before-save broken")


INVARIANTS: Dict[str, Callable[[Any], None]] = {
    "deadlock_free": deadlock_free,
    "no_lost_wakeup": no_lost_wakeup,
    "no_errors": no_errors,
    "exactly_once_claims": exactly_once_claims,
    "edf_pickup_order": edf_pickup_order,
    "reclaimable_429": reclaimable_429,
    "admission_conservation": admission_conservation,
    "all_resolved": all_resolved,
    "deferred_apply_exactly_once": deferred_apply_exactly_once,
    "pipeline_hops_exactly_once": pipeline_hops_exactly_once,
    "onefb_hop_order": onefb_hop_order,
    "durable_exactly_once": durable_exactly_once,
    "checkpoint_atomicity": checkpoint_atomicity,
    "replay_recovery_bit_identical": replay_recovery_bit_identical,
    "flush_before_save": flush_before_save,
    "handoff_exactly_once": handoff_exactly_once,
    "scale_down_exactly_once": scale_down_exactly_once,
    "sharded_handoff_reshard": sharded_handoff_reshard,
}

# --check findings flow through slt-lint's waiver/exit-code machinery;
# each invariant maps onto a pseudo-rule id in the SLT1xx block (the
# static rules own SLT0xx)
RULE_OF_INVARIANT: Dict[str, str] = {
    "deadlock_free": "SLT104",
    "no_lost_wakeup": "SLT102",
    "no_errors": "SLT100",
    "exactly_once_claims": "SLT101",
    "edf_pickup_order": "SLT103",
    "reclaimable_429": "SLT105",
    "admission_conservation": "SLT106",
    "all_resolved": "SLT107",
    "deferred_apply_exactly_once": "SLT108",
    "durable_exactly_once": "SLT109",
    "checkpoint_atomicity": "SLT110",
    "replay_recovery_bit_identical": "SLT111",
    "flush_before_save": "SLT112",
    "pipeline_hops_exactly_once": "SLT113",
    "handoff_exactly_once": "SLT114",
    "onefb_hop_order": "SLT115",
    "scale_down_exactly_once": "SLT116",
    "sharded_handoff_reshard": "SLT117",
}


def check_run(run: Any, named: Tuple[str, ...] = ()) -> List[Violation]:
    """Apply the generic invariants plus ``named`` ones to one run;
    return every violation (does not stop at the first — one schedule
    can break several)."""
    out: List[Violation] = []
    fns = list(GENERIC) + [INVARIANTS[n] for n in named
                           if INVARIANTS[n] not in GENERIC]
    for fn in fns:
        try:
            fn(run)
        except Violation as v:
            out.append(v)
    return out
