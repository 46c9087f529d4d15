"""slt-check — deterministic cooperative scheduler + interleaving explorer.

The dynamic-er half of slt-lint: the static rules (rules.py) prove lock
*syntax*, the watchdogs (obs/locks.py, obs/dispatch_debug.py) catch
violations that happen to occur on one schedule — this module checks the
runtime's concurrency invariants across *all* schedules a bounded search
can reach. It is a stateless model checker in the CHESS tradition:

- **Cooperative scheduling.** Scenario code (analysis/scenarios.py) runs
  on real Python threads, but exactly one thread is runnable at a time.
  Every synchronization operation — lock acquire/release, condition
  wait/notify, event wait/set, thread spawn/join, and explicit
  ``ctx.step()`` markers — is a yield point where the thread parks and
  the scheduler picks who runs next. The runtime objects under test are
  the *real* ones: they construct their primitives through the
  ``obs.locks`` seam (``make_lock`` / ``make_event`` / ``make_condition``
  / ``make_thread``), and :class:`install` swaps that seam for the
  cooperative classes below for the duration of one explored schedule.
- **Virtual time.** ``time.monotonic``/``perf_counter`` read a virtual
  clock; timed waits register a deadline and time out only at
  *quiescence* (no thread enabled), when the clock jumps to the earliest
  deadline. Timeouts therefore model "slower than everything else",
  schedules stay finite, and wall clock never leaks into a trace.
- **Exhaustive-by-default exploration.** DFS over scheduling decisions
  under a bounded-preemption budget, with sleep-set pruning (sound for
  the safety properties checked here); a seeded-random mode covers
  larger scenarios. Every completed schedule has a replayable trace id
  — ``scenario:<base62 choices>`` — and :func:`run_schedule` with the
  decoded choices re-executes that interleaving bit-for-bit, which is
  how a violation's counterexample becomes a regression test.
- **Deadlock/stall detection.** When nothing is enabled and no deadline
  is pending, the scheduler builds the wait-for graph: a lock cycle is
  reported as a deadlock (with the cycle), a cond/event waiter with no
  cycle as a stall — the lost-wakeup shape.

Stdlib-only (tests/test_torch_port_analysis.py pins it): scenarios carry
the numpy/torch/runtime imports, this module only schedules them.
"""

from __future__ import annotations

import hashlib
import importlib
import threading as _real_threading
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

__all__ = [
    "SchedAbort", "ScheduleError", "Scheduler", "Ctx", "Run",
    "run_schedule", "explore", "ExploreResult",
    "encode_choices", "decode_choices", "install",
    "DurableStore", "CrashRun", "run_crash_schedule", "explore_crashes",
    "CrashExploreResult",
]

# scheduling decisions -> trace-id characters; thread ids index into
# this (a scenario with >62 managed threads is not a "small scenario")
_B62 = ("0123456789"
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_B62_INV = {c: i for i, c in enumerate(_B62)}


class SchedAbort(BaseException):
    """Raised inside managed threads at teardown so finally-blocks
    unwind and no thread outlives its schedule. BaseException: runtime
    ``except Exception`` handlers must not swallow it."""


class ScheduleError(RuntimeError):
    """A forced replay diverged from the recorded schedule (stale id
    against changed code) or a scenario exceeded the transition cap."""


def encode_choices(choices: Tuple[int, ...]) -> str:
    return "".join(_B62[c] for c in choices)


def decode_choices(text: str) -> Tuple[int, ...]:
    try:
        return tuple(_B62_INV[c] for c in text)
    except KeyError as exc:
        raise ScheduleError(f"bad schedule id character: {exc}") from None


# --------------------------------------------------------------------- #
# virtual time
# --------------------------------------------------------------------- #

class VirtualClock:
    """The ``time`` facade managed modules see. Reads are free (never a
    yield point); ``sleep`` parks the caller until quiescence advances
    the clock past its deadline."""

    def __init__(self, sched: "Scheduler", start: float = 1000.0) -> None:
        self._sched = sched
        self.now = start

    def monotonic(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self._sched.op_sleep(max(float(seconds), 0.0))


# --------------------------------------------------------------------- #
# managed threads and cooperative primitives
# --------------------------------------------------------------------- #

class _TState:
    """One managed thread: the real thread plus its scheduling state."""

    __slots__ = ("tid", "name", "real", "gate", "state", "pending",
                 "deadline", "notified", "timed_out", "error", "daemon",
                 "started")

    def __init__(self, tid: int, name: str) -> None:
        self.tid = tid
        self.name = name
        self.real: Optional[_real_threading.Thread] = None
        self.gate = _real_threading.Event()
        # unstarted -> parked <-> running -> finished
        self.state = "unstarted"
        self.pending: Optional[Tuple[Any, ...]] = None  # (kind, oid, ...)
        self.deadline: Optional[float] = None
        self.notified = False   # cond: moved off the waiter list
        self.timed_out = False  # last blocking op ended by the clock
        self.error: Optional[BaseException] = None
        self.daemon = True
        self.started = False


class SchedLock:
    """Cooperative Lock/RLock. One acquire or release == one scheduler
    transition; blocking acquires are enabled only while the lock is
    free (or reentrantly self-owned)."""

    def __init__(self, sched: "Scheduler", name: str,
                 reentrant: bool) -> None:
        self._sched = sched
        self.oid = sched.register_obj(name)
        self.name = name
        self.reentrant = reentrant
        self.owner: Optional[int] = None
        self.depth = 0
        sched.index_lock(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._sched.op_acquire(self, blocking=blocking)

    def release(self) -> None:
        self._sched.op_release(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self.owner is not None

    def __repr__(self) -> str:
        return (f"<SchedLock {self.name!r} owner={self.owner} "
                f"depth={self.depth}>")


class SchedCondition:
    """Cooperative ``threading.Condition``. ``wait`` is two transitions
    — release-and-block, then notified/timed-out reacquire — so a racing
    notify can land exactly in the window the lost-wakeup bugs need.
    Waiters wake FIFO (deterministic; the explorer varies order by
    scheduling, not by wake order)."""

    def __init__(self, sched: "Scheduler", name: str,
                 lock: Optional[SchedLock] = None) -> None:
        self._sched = sched
        self.name = name
        self._lock = (lock if lock is not None
                      else SchedLock(sched, name + ".lock", True))
        self.oid = sched.register_obj(name)
        self.waiters: List[int] = []

    # lock surface (threading.Condition delegates these)
    def acquire(self, *a: Any, **kw: Any) -> bool:
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self._lock.__enter__()

    def __exit__(self, *exc: Any) -> None:
        self._lock.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._sched.op_cond_wait(self, timeout)

    def wait_for(self, predicate: Callable[[], Any],
                 timeout: Optional[float] = None) -> Any:
        # CPython's loop, against the virtual clock
        endtime: Optional[float] = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = self._sched.clock.monotonic() + waittime
                else:
                    waittime = endtime - self._sched.clock.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._sched.op_notify(self, n)

    def notify_all(self) -> None:
        self._sched.op_notify(self, None)

    def __repr__(self) -> str:
        return f"<SchedCondition {self.name!r} waiters={self.waiters}>"


class SchedEvent:
    """Cooperative ``threading.Event``."""

    def __init__(self, sched: "Scheduler", name: str) -> None:
        self._sched = sched
        self.oid = sched.register_obj(name)
        self.name = name
        self.flag = False
        sched.index_event(self)

    def is_set(self) -> bool:
        return self.flag

    def set(self) -> None:
        self._sched.op_event_set(self)

    def clear(self) -> None:
        self._sched.op_event_clear(self)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._sched.op_event_wait(self, timeout)

    def __repr__(self) -> str:
        return f"<SchedEvent {self.name!r} set={self.flag}>"


class SchedThread:
    """Cooperative ``threading.Thread``: start/join are transitions, the
    body runs only when scheduled."""

    def __init__(self, sched: "Scheduler", target: Callable[..., Any],
                 name: str, daemon: bool, args: Tuple[Any, ...]) -> None:
        self._sched = sched
        self._target = target
        self._args = args
        self.ts = sched.register_thread(name)
        self.ts.daemon = daemon
        self.name = self.ts.name

    def start(self) -> None:
        self._sched.op_spawn(self.ts, self._target, self._args)

    def join(self, timeout: Optional[float] = None) -> None:
        self._sched.op_join(self.ts, timeout)

    def is_alive(self) -> bool:
        return self.ts.started and self.ts.state != "finished"

    @property
    def daemon(self) -> bool:
        return self.ts.daemon

    @daemon.setter
    def daemon(self, value: bool) -> None:
        self.ts.daemon = value


class _Factory:
    """What ``obs.locks.install_checker`` receives: primitive
    constructors bound to one scheduler. Calls from threads the
    scheduler does not manage (another suite's daemon racing a test)
    fall through to the real primitives."""

    def __init__(self, sched: "Scheduler") -> None:
        self._sched = sched

    def _managed(self) -> bool:
        return self._sched.current() is not None

    def lock(self, name: str, *, reentrant: bool = True) -> Any:
        if not self._managed():
            return (_real_threading.RLock() if reentrant
                    else _real_threading.Lock())
        return SchedLock(self._sched, name, reentrant)

    def event(self, name: str = "event") -> Any:
        if not self._managed():
            return _real_threading.Event()
        return SchedEvent(self._sched, name)

    def condition(self, name: str) -> Any:
        if not self._managed():
            return _real_threading.Condition()
        lock = SchedLock(self._sched, name + ".lock", True)
        return SchedCondition(self._sched, name, lock)

    def thread(self, target: Callable[..., Any], *, name: str,
               daemon: bool = True) -> Any:
        if not self._managed():
            return _real_threading.Thread(target=target, name=name,
                                          daemon=daemon)
        return SchedThread(self._sched, target, name, daemon, ())


# --------------------------------------------------------------------- #
# the scheduler
# --------------------------------------------------------------------- #

class Scheduler:
    """Runs one schedule of one scenario: serializes managed threads,
    records every transition, and (at decision points — more than one
    thread enabled) either follows ``forced`` choices, asks the seeded
    ``rand``, or takes the DFS default (stay on the current thread)."""

    def __init__(self, *, forced: Tuple[int, ...] = (),
                 sleep_plan: Tuple[FrozenSet[int], ...] = (),
                 bound: Optional[int] = None,
                 rand: Any = None,
                 max_transitions: int = 50_000,
                 crash_at: Optional[int] = None) -> None:
        self.forced = tuple(forced)
        self.sleep_plan = tuple(sleep_plan)
        self.bound = bound
        self.rand = rand
        self.max_transitions = max_transitions
        # crash injection (slt-crash): kill the simulated process once
        # this many transitions have executed — every thread dies at its
        # next yield point, nothing else of the run survives
        self.crash_at = crash_at
        self.crashed = False

        self.clock = VirtualClock(self)
        self.factory = _Factory(self)
        self.threads: List[_TState] = []
        self.obj_names: List[str] = []
        self.trace: List[Tuple[int, str, str]] = []   # (tid, kind, obj)
        self.notes: List[Tuple[str, Dict[str, Any]]] = []
        self.decisions: List[int] = []    # chosen tid per decision point
        self.points: List[Dict[str, Any]] = []
        self.sleeping: set = set()        # tids slept by the DFS plan
        self.preemptions = 0
        self.aborting = False
        self.pruned: Optional[str] = None   # "sleep" | "bound"
        self.deadlock: Optional[Dict[str, Any]] = None
        self.stalled: Optional[List[Dict[str, Any]]] = None
        self.leaked: List[str] = []
        self.transitions = 0
        self._locks: Dict[int, SchedLock] = {}
        self._events: Dict[int, SchedEvent] = {}
        self._last: Optional[int] = None  # tid that ran the last slice
        self._control = _real_threading.Event()
        self._tls = _real_threading.local()
        self._step_tokens: Dict[str, int] = {}
        self._begin_oid = self.register_obj("begin")

    # -- registries ---------------------------------------------------- #

    def register_obj(self, name: str) -> int:
        self.obj_names.append(name)
        return len(self.obj_names) - 1

    def index_lock(self, lock: SchedLock) -> None:
        self._locks[lock.oid] = lock

    def index_event(self, event: SchedEvent) -> None:
        self._events[event.oid] = event

    def register_thread(self, name: str) -> _TState:
        ts = _TState(len(self.threads), name)
        self.threads.append(ts)
        return ts

    def current(self) -> Optional[_TState]:
        return getattr(self._tls, "ts", None)

    def _me(self) -> _TState:
        ts = self.current()
        assert ts is not None, "sync op from an unmanaged thread"
        return ts

    def step_token(self, tag: str) -> int:
        """One shared pseudo-object per ``ctx.step`` tag: steps with the
        same tag are mutually dependent (sleep-set wakeups see them)."""
        oid = self._step_tokens.get(tag)
        if oid is None:
            oid = self._step_tokens[tag] = self.register_obj(f"step:{tag}")
        return oid

    def note(self, kind: str, **fields: Any) -> None:
        self.notes.append((kind, fields))

    # -- thread-side protocol ------------------------------------------ #

    def _park(self, ts: _TState, pending: Tuple[Any, ...],
              deadline: Optional[float] = None) -> None:
        """Register the thread's next op and hand control back. Returns
        once the scheduler grants this thread its next slice."""
        if self.aborting:
            raise SchedAbort()
        ts.timed_out = False
        ts.pending = pending
        ts.deadline = deadline
        ts.state = "parked"
        self._control.set()
        ts.gate.wait()
        ts.gate.clear()
        if self.aborting:
            raise SchedAbort()
        ts.state = "running"
        ts.pending = None
        ts.deadline = None

    def _perform(self, ts: _TState, kind: str, oid: int) -> None:
        self.trace.append((ts.tid, kind, self.obj_names[oid]))

    # -- op implementations (called on managed threads) ----------------- #

    def op_acquire(self, lock: SchedLock, blocking: bool = True) -> bool:
        ts = self._me()
        if self.aborting:
            return True
        kind = "acquire" if blocking else "try_acquire"
        self._park(ts, (kind, lock.oid))
        self._perform(ts, kind, lock.oid)
        if lock.owner is None or (lock.reentrant and lock.owner == ts.tid):
            lock.owner = ts.tid
            lock.depth += 1
            return True
        assert not blocking, "granted a blocked acquire"
        return False

    def op_release(self, lock: SchedLock) -> None:
        ts = self._me()
        if self.aborting:
            return
        self._park(ts, ("release", lock.oid))
        self._perform(ts, "release", lock.oid)
        if lock.owner != ts.tid:
            raise RuntimeError(f"release of un-owned lock {lock.name!r}")
        lock.depth -= 1
        if lock.depth == 0:
            lock.owner = None

    def op_cond_wait(self, cond: SchedCondition,
                     timeout: Optional[float]) -> bool:
        ts = self._me()
        if self.aborting:
            raise SchedAbort()
        lock = cond._lock
        if lock.owner != ts.tid:
            raise RuntimeError("cond.wait on un-acquired lock")
        # transition 1: release the lock and join the waiter list
        self._park(ts, ("cond_enter", cond.oid, lock.oid))
        self._perform(ts, "cond_enter", cond.oid)
        saved_depth = lock.depth
        lock.owner, lock.depth = None, 0
        cond.waiters.append(ts.tid)
        ts.notified = False
        deadline = (self.clock.monotonic() + timeout
                    if timeout is not None else None)
        # transition 2: reacquire once notified or timed out (a timed-
        # out wait still reacquires before returning, like the real one)
        self._park(ts, ("cond_block", cond.oid, lock.oid), deadline)
        self._perform(ts, "cond_wake", cond.oid)
        timed_out = ts.timed_out and not ts.notified
        if ts.tid in cond.waiters:  # timeout path: withdraw ourselves
            cond.waiters.remove(ts.tid)
        lock.owner, lock.depth = ts.tid, saved_depth
        ts.notified = False
        ts.timed_out = False
        return not timed_out

    def op_notify(self, cond: SchedCondition, n: Optional[int]) -> None:
        ts = self.current()
        if self.aborting or ts is None:
            self._do_notify(cond, n)
            return
        kind = "notify_all" if n is None else "notify"
        self._park(ts, (kind, cond.oid))
        self._perform(ts, kind, cond.oid)
        self._do_notify(cond, n)

    def _do_notify(self, cond: SchedCondition, n: Optional[int]) -> None:
        count = len(cond.waiters) if n is None else max(int(n), 0)
        woken = cond.waiters[:count]
        del cond.waiters[:count]
        for tid in woken:
            self.threads[tid].notified = True

    def op_event_set(self, event: SchedEvent) -> None:
        ts = self.current()
        if self.aborting or ts is None:
            event.flag = True
            return
        self._park(ts, ("set", event.oid))
        self._perform(ts, "set", event.oid)
        event.flag = True

    def op_event_clear(self, event: SchedEvent) -> None:
        ts = self.current()
        if self.aborting or ts is None:
            event.flag = False
            return
        self._park(ts, ("clear", event.oid))
        self._perform(ts, "clear", event.oid)
        event.flag = False

    def op_event_wait(self, event: SchedEvent,
                      timeout: Optional[float]) -> bool:
        ts = self._me()
        if self.aborting:
            if not event.flag:
                raise SchedAbort()
            return True
        deadline = (self.clock.monotonic() + timeout
                    if timeout is not None else None)
        self._park(ts, ("event_wait", event.oid), deadline)
        self._perform(ts, "event_wait", event.oid)
        hit = event.flag
        ts.timed_out = False
        return hit

    def op_sleep(self, seconds: float) -> None:
        ts = self.current()
        if ts is None or self.aborting:
            return
        oid = self.step_token("sleep")
        self._park(ts, ("sleep", oid), self.clock.monotonic() + seconds)
        self._perform(ts, "sleep", oid)
        ts.timed_out = False

    def op_spawn(self, child: _TState, target: Callable[..., Any],
                 args: Tuple[Any, ...]) -> None:
        ts = self._me()
        if self.aborting:
            raise SchedAbort()
        if child.started:
            raise RuntimeError("threads can only be started once")
        child.started = True
        oid = self.register_obj(f"thread:{child.name}")
        self._park(ts, ("spawn", oid))
        self._perform(ts, "spawn", oid)
        self._launch(child, target, args)

    def op_join(self, child: _TState, timeout: Optional[float]) -> None:
        ts = self._me()
        if self.aborting:
            return
        oid = self.register_obj(f"join:{child.name}")
        deadline = (self.clock.monotonic() + timeout
                    if timeout is not None else None)
        self._park(ts, ("join", oid, child.tid), deadline)
        self._perform(ts, "join", oid)
        ts.timed_out = False

    def op_step(self, tag: str) -> None:
        """Explicit yield point for scenario/fixture code: models a
        shared-state touch the explorer may preempt around."""
        ts = self._me()
        if self.aborting:
            raise SchedAbort()
        oid = self.step_token(tag)
        self._park(ts, ("step", oid))
        self._perform(ts, "step", oid)

    # -- driver --------------------------------------------------------- #

    def _launch(self, ts: _TState, target: Callable[..., Any],
                args: Tuple[Any, ...]) -> None:
        def body() -> None:
            self._tls.ts = ts
            try:
                # first slice starts like any other: wait to be chosen
                self._park(ts, ("begin", self._begin_oid))
                target(*args)
            except SchedAbort:
                pass
            except BaseException as exc:  # noqa: BLE001 — recorded, the
                ts.error = exc            # run (not the suite) fails
            finally:
                ts.state = "finished"
                ts.pending = None
                self._control.set()

        ts.started = True
        ts.real = _real_threading.Thread(
            target=body, name=f"slt-check-{ts.name}", daemon=True)
        ts.real.start()

    def _lock_free_for(self, oid: int, tid: int) -> bool:
        lock = self._locks.get(oid)
        if lock is None:
            return True
        return lock.owner is None or (lock.reentrant and lock.owner == tid)

    def _enabled(self, ts: _TState) -> bool:
        p = ts.pending
        if p is None:
            return False
        kind = p[0]
        if kind == "acquire":
            return self._lock_free_for(p[1], ts.tid)
        if kind == "cond_block":
            return ((ts.notified or ts.timed_out)
                    and self._lock_free_for(p[2], ts.tid))
        if kind == "event_wait":
            ev = self._events.get(p[1])
            return bool(ev is not None and ev.flag) or ts.timed_out
        if kind == "join":
            return (self.threads[p[2]].state == "finished"
                    or ts.timed_out)
        if kind == "sleep":
            return ts.timed_out
        return True  # release/notify/set/clear/step/spawn/begin/...

    def _wake_dependent_sleepers(self, op: Tuple[Any, ...]) -> None:
        """Sleep-set rule: executing a transition wakes any slept thread
        whose own pending op touches one of the same objects."""
        if not self.sleeping:
            return
        oids = {x for x in op[1:] if isinstance(x, int)}
        for tid in list(self.sleeping):
            p = self.threads[tid].pending
            if p is not None and oids.intersection(
                    x for x in p[1:] if isinstance(x, int)):
                self.sleeping.discard(tid)

    def run(self, main: Callable[[], Any]) -> None:
        """Drive ``main`` (plus whatever it spawns) to completion under
        this schedule. Called with the seam already installed."""
        root = self.register_thread("main")
        self._launch(root, main, ())
        decision_i = 0
        try:
            while True:
                self._control.wait()
                self._control.clear()
                if any(t.state == "running"
                       or (t.real is not None and t.state == "unstarted")
                       for t in self.threads):
                    # mid-slice, or a just-launched OS thread that has
                    # not reached its first park yet: deciding now would
                    # compute the enabled set without it — the thread's
                    # visibility would depend on OS thread-start timing,
                    # and a replayed prefix could legitimately diverge
                    continue
                if root.state == "finished":
                    return
                if (self.crash_at is not None and not self.crashed
                        and self.transitions >= self.crash_at):
                    # the crash point: stop granting slices and let the
                    # finally-teardown abort every thread — in-memory
                    # state is gone, only DurableStore survivors remain
                    self.crashed = True
                    return
                if self.transitions >= self.max_transitions:
                    raise ScheduleError(
                        f"schedule exceeded {self.max_transitions} "
                        f"transitions — runaway scenario")
                parked = [t for t in self.threads if t.state == "parked"]
                enabled = [t for t in parked if self._enabled(t)]
                if not enabled:
                    if self._fire_earliest_deadline(parked):
                        self._control.set()
                        continue
                    self._diagnose_stuck(parked)
                    return
                chosen = self._choose(enabled, decision_i)
                if chosen is None:
                    return  # pruned
                if len(enabled) > 1:
                    decision_i += 1
                self._grant(chosen)
        finally:
            self._teardown()

    def _fire_earliest_deadline(self, parked: List[_TState]) -> bool:
        timed = [t for t in parked if t.deadline is not None]
        if not timed:
            return False
        t = min(timed, key=lambda x: (x.deadline, x.tid))
        self.clock.now = max(self.clock.now, t.deadline)
        t.timed_out = True
        t.deadline = None
        return True

    def _diagnose_stuck(self, parked: List[_TState]) -> None:
        """No thread enabled, no deadline pending: deadlock (lock
        wait-for cycle) or stall (lost wakeup)."""
        waits_on: Dict[int, int] = {}  # tid -> lock owner it waits on
        for t in parked:
            p = t.pending
            if p is None:
                continue
            lock_oid = None
            if p[0] == "acquire":
                lock_oid = p[1]
            elif p[0] == "cond_block" and (t.notified or t.timed_out):
                lock_oid = p[2]
            if lock_oid is not None:
                lock = self._locks.get(lock_oid)
                if lock is not None and lock.owner is not None:
                    waits_on[t.tid] = lock.owner
        cycle = _find_cycle(waits_on)
        info = [{"tid": t.tid, "name": t.name,
                 "op": t.pending[0] if t.pending else None,
                 "obj": (self.obj_names[t.pending[1]]
                         if t.pending else None)}
                for t in parked]
        if cycle:
            self.deadlock = {
                "cycle": [{"tid": tid, "name": self.threads[tid].name}
                          for tid in cycle],
                "threads": info,
            }
        else:
            self.stalled = info

    def _choose(self, enabled: List[_TState],
                decision_i: int) -> Optional[_TState]:
        enabled = sorted(enabled, key=lambda t: t.tid)
        enabled_tids = [t.tid for t in enabled]
        decision = len(enabled) > 1
        # sleep additions planned by the DFS parent apply at this
        # decision index — also during a forced prefix, so the sleeping
        # set evolves identically on the replayed path
        if decision and decision_i < len(self.sleep_plan):
            self.sleeping |= set(self.sleep_plan[decision_i])
        if decision and decision_i < len(self.forced):
            tid = self.forced[decision_i]
            if tid not in enabled_tids:
                raise ScheduleError(
                    f"schedule replay diverged: thread {tid} not enabled "
                    f"at decision {decision_i} (enabled: {enabled_tids})")
            chosen = self.threads[tid]
            self._account(chosen, enabled_tids, [], decision)
            return chosen
        schedulable = [t for t in enabled if t.tid not in self.sleeping]
        # bounded preemption: once the budget is spent, an enabled
        # current thread must keep running
        over_budget = (self.bound is not None
                       and self.preemptions >= self.bound
                       and self._last in enabled_tids)
        if over_budget:
            schedulable = [t for t in schedulable if t.tid == self._last]
        if not schedulable:
            self.pruned = "bound" if over_budget else "sleep"
            return None
        schedulable_tids = [t.tid for t in schedulable]
        if self.rand is not None and decision:
            chosen = schedulable[self.rand.randrange(len(schedulable))]
        elif self._last in schedulable_tids:
            chosen = self.threads[self._last]
        else:
            chosen = schedulable[0]
        self._account(chosen, enabled_tids, schedulable_tids, decision)
        return chosen

    def _account(self, chosen: _TState, enabled_tids: List[int],
                 schedulable_tids: List[int], decision: bool) -> None:
        if (self._last is not None and chosen.tid != self._last
                and self._last in enabled_tids):
            self.preemptions += 1
        if decision:
            self.decisions.append(chosen.tid)
            self.points.append({
                "enabled": enabled_tids,
                "schedulable": schedulable_tids,
                "chosen": chosen.tid,
                "sleeping": frozenset(self.sleeping),
            })
        self._last = chosen.tid
        self.transitions += 1

    def _grant(self, ts: _TState) -> None:
        if ts.pending is not None:
            # this grant executes the pending op: wake slept threads
            # whose next op is dependent with it
            self._wake_dependent_sleepers(ts.pending)
        ts.state = "running"
        ts.gate.set()

    def _teardown(self) -> None:
        """Abort every still-live managed thread so finally-blocks
        unwind; join the real threads; record leaks."""
        self.aborting = True
        for _ in range(200):
            live = [t for t in self.threads
                    if t.real is not None and t.state != "finished"]
            if not live:
                break
            for t in live:
                t.gate.set()
            self._control.wait(timeout=0.05)
            self._control.clear()
        for t in self.threads:
            if t.real is not None:
                t.real.join(timeout=2.0)
                if t.real.is_alive():
                    self.leaked.append(t.name)


def _find_cycle(waits_on: Dict[int, int]) -> Optional[List[int]]:
    for start in waits_on:
        seen: List[int] = []
        tid = start
        while tid in waits_on and tid not in seen:
            seen.append(tid)
            tid = waits_on[tid]
        if tid in seen:
            return seen[seen.index(tid):]
    return None


# --------------------------------------------------------------------- #
# seam installation
# --------------------------------------------------------------------- #

class install:
    """Context manager: point ``obs.locks``' seam at ``sched`` and give
    the managed runtime modules the virtual clock. Restores everything
    on exit — one schedule's cooperative world never leaks into the
    next (or into an unrelated test)."""

    # modules whose ``time`` attribute is swapped for the virtual clock
    # (they read time.monotonic/perf_counter on the paths under test;
    # admission and the breaker also take injectable clocks/sleeps,
    # which scenarios pass explicitly)
    _TIME_MODULES = (
        "split_learning_tpu_torch.runtime.coalesce",
        "split_learning_tpu_torch.runtime.fleet",
        "split_learning_tpu_torch.runtime.breaker",
    )

    def __init__(self, sched: Scheduler) -> None:
        self._sched = sched
        self._prev_factory: Any = None
        self._prev_time: List[Tuple[Any, Any]] = []

    def __enter__(self) -> "install":
        from split_learning_tpu_torch.obs import locks as obs_locks
        self._prev_factory = obs_locks.install_checker(self._sched.factory)
        for name in self._TIME_MODULES:
            try:
                mod = importlib.import_module(name)
            except ImportError:  # pragma: no cover — gated scenario deps
                continue
            self._prev_time.append((mod, mod.time))
            mod.time = self._sched.clock
        return self

    def __exit__(self, *exc: Any) -> None:
        from split_learning_tpu_torch.obs import locks as obs_locks
        obs_locks.install_checker(self._prev_factory)
        for mod, prev in self._prev_time:
            mod.time = prev
        self._prev_time.clear()


# --------------------------------------------------------------------- #
# scenario-facing API
# --------------------------------------------------------------------- #

class Ctx:
    """What a scenario function receives: spawn/step/note plus the
    cooperative primitives for toy fixtures."""

    def __init__(self, sched: Scheduler) -> None:
        self.sched = sched
        self.clock = sched.clock

    def spawn(self, fn: Callable[..., Any], *args: Any,
              name: Optional[str] = None) -> SchedThread:
        th = SchedThread(self.sched, fn, name or fn.__name__, True, args)
        th.start()
        return th

    def step(self, tag: str) -> None:
        self.sched.op_step(tag)

    def note(self, kind: str, **fields: Any) -> None:
        self.sched.note(kind, **fields)

    def sleep(self, seconds: float) -> None:
        self.clock.sleep(seconds)

    # toy-fixture primitives (seeded-violation tests build broken
    # objects from these instead of going through obs.locks)
    def lock(self, name: str, reentrant: bool = False) -> SchedLock:
        return SchedLock(self.sched, name, reentrant)

    def event(self, name: str) -> SchedEvent:
        return SchedEvent(self.sched, name)

    def condition(self, name: str) -> SchedCondition:
        return SchedCondition(self.sched, name)


class Run:
    """One completed (or pruned/stuck) schedule of one scenario."""

    def __init__(self, scenario: str, sched: Scheduler,
                 state: Optional[Dict[str, Any]],
                 error: Optional[BaseException]) -> None:
        self.scenario = scenario
        self.state = state if state is not None else {}
        self.error = error
        self.trace = list(sched.trace)
        self.notes = list(sched.notes)
        self.decisions = tuple(sched.decisions)
        self.points = sched.points
        self.pruned = sched.pruned
        self.deadlock = sched.deadlock
        self.stalled = sched.stalled
        self.leaked = sched.leaked
        self.transitions = sched.transitions
        self.preemptions = sched.preemptions
        self.thread_errors = [
            {"name": t.name, "error": repr(t.error)}
            for t in sched.threads if t.error is not None]

    @property
    def schedule_id(self) -> str:
        return f"{self.scenario}:{encode_choices(self.decisions)}"

    def trace_fingerprint(self) -> str:
        """Stable digest of the full interleaving — two runs with equal
        fingerprints executed bit-for-bit the same transitions."""
        h = hashlib.sha256()
        for tid, kind, obj in self.trace:
            h.update(f"{tid}|{kind}|{obj}\n".encode())
        return h.hexdigest()[:16]


def run_schedule(scenario_name: str,
                 scenario_fn: Callable[[Ctx], Optional[Dict[str, Any]]],
                 *, forced: Tuple[int, ...] = (),
                 sleep_plan: Tuple[FrozenSet[int], ...] = (),
                 bound: Optional[int] = None,
                 rand: Any = None) -> Run:
    """Execute one schedule of ``scenario_fn`` and return its Run."""
    sched = Scheduler(forced=forced, sleep_plan=sleep_plan, bound=bound,
                      rand=rand)
    result: Dict[str, Any] = {}
    error: List[Optional[BaseException]] = [None]

    def main() -> None:
        ctx = Ctx(sched)
        try:
            out = scenario_fn(ctx)
            if out:
                result.update(out)
        except SchedAbort:
            raise
        except BaseException as exc:  # noqa: BLE001 — surfaced on Run
            error[0] = exc

    with install(sched):
        sched.run(main)
    return Run(scenario_name, sched, result, error[0])


# --------------------------------------------------------------------- #
# exploration
# --------------------------------------------------------------------- #

class ExploreResult:
    def __init__(self, scenario: str) -> None:
        self.scenario = scenario
        self.schedule_ids: List[str] = []
        self.pruned = 0
        self.exhausted = False    # DFS frontier emptied within budget
        self.max_preemptions = 0
        self.max_transitions = 0
        self.runs_with_errors = 0
        self.sample: Dict[str, str] = {}  # schedule_id -> fingerprint

    @property
    def schedules(self) -> int:
        return len(self.schedule_ids)

    def summary(self) -> Dict[str, Any]:
        explored = self.schedules
        total = explored + self.pruned
        return {
            "schedules": explored,
            "pruned": self.pruned,
            "pruning_ratio": (self.pruned / total) if total else 0.0,
            "exhausted": self.exhausted,
            "max_preemptions": self.max_preemptions,
            "max_transitions": self.max_transitions,
        }


def explore(scenario_name: str,
            scenario_fn: Callable[[Ctx], Optional[Dict[str, Any]]],
            *, budget: int = 200,
            bound: Optional[int] = 3,
            mode: str = "dfs",
            seed: int = 0,
            on_run: Optional[Callable[[Run], None]] = None
            ) -> ExploreResult:
    """Explore up to ``budget`` distinct schedules of one scenario.

    ``mode="dfs"``: depth-first over decision points under the
    preemption ``bound``, sleep sets pruning equivalent sibling
    subtrees. ``mode="random"``: ``budget`` seeded-random schedules
    (deduplicated by id) — the fallback for scenarios whose DFS
    frontier outgrows the budget. ``on_run`` sees every completed
    (non-pruned) Run — the invariant hook."""
    res = ExploreResult(scenario_name)
    seen: set = set()

    def finish(run: Run) -> None:
        sid = run.schedule_id
        if sid in seen:
            return
        seen.add(sid)
        res.schedule_ids.append(sid)
        res.max_preemptions = max(res.max_preemptions, run.preemptions)
        res.max_transitions = max(res.max_transitions, run.transitions)
        if run.error is not None or run.thread_errors:
            res.runs_with_errors += 1
        if len(res.sample) < 4:
            res.sample[sid] = run.trace_fingerprint()
        if on_run is not None:
            on_run(run)

    if mode == "random":
        import random as _random
        rng = _random.Random(seed)
        attempts = 0
        while len(res.schedule_ids) < budget and attempts < budget * 3:
            attempts += 1
            run = run_schedule(scenario_name, scenario_fn,
                               rand=_random.Random(rng.randrange(2**31)))
            if run.pruned is None:
                finish(run)
        return res

    # DFS: stack of (forced decision prefix, sleep additions per point)
    stack: List[Tuple[Tuple[int, ...], Tuple[FrozenSet[int], ...]]] = [
        ((), ())]
    while stack:
        if len(res.schedule_ids) >= budget:
            return res
        forced, sleep_plan = stack.pop()
        run = run_schedule(scenario_name, scenario_fn,
                           forced=forced, sleep_plan=sleep_plan,
                           bound=bound)
        if run.pruned is not None:
            res.pruned += 1
        else:
            finish(run)
        # alternatives at every decision point past the forced prefix,
        # pushed shallow-to-deep so the pop order stays depth-first
        for j in range(len(forced), len(run.decisions)):
            pt = run.points[j]
            chosen = pt["chosen"]
            slept = set(pt["sleeping"])
            newly = [chosen]
            for alt in pt["schedulable"]:
                if alt == chosen or alt in slept:
                    continue
                child_plan = list(sleep_plan)
                while len(child_plan) < j:
                    child_plan.append(frozenset())
                child_plan.append(frozenset(newly))
                stack.append((tuple(run.decisions[:j]) + (alt,),
                              tuple(child_plan)))
                newly.append(alt)
    res.exhausted = True
    return res


# --------------------------------------------------------------------- #
# crash–restart model checking (slt-crash)
# --------------------------------------------------------------------- #

class DurableStore:
    """The checkpoint-directory abstraction that survives a crash.

    Duck-types the fs seam ``runtime/checkpoint.py``'s extras writer
    takes (``put``/``fsync``/``rename``/``listdir``/``read``), so the
    REAL tmp-write + fsync + rename code path runs under the explorer.
    Every mutating op is a yield point (same-path ops share a step
    token, so sleep sets see their dependence), and ``put`` is two
    transitions — a crash between them models a half-written file.

    Crash semantics are the deterministic worst case: content that was
    fsynced (and not overwritten since) survives intact; anything else
    survives TORN — a prefix of the in-flight bytes, the adversarial
    "some of it hit the disk" outcome. ``rename`` is atomic (journaled
    metadata), but renaming an un-fsynced file carries the torn risk
    with it — exactly the missing-fsync bug class."""

    def __init__(self) -> None:
        # path -> {"content": live bytes-as-str, "durable": last fsynced}
        self._files: Dict[str, Dict[str, Optional[str]]] = {}
        self._sched: Optional[Scheduler] = None

    def bind(self, sched: Optional[Scheduler]) -> None:
        """Attach to the scheduler driving the current phase (the store
        itself outlives schedulers — that is the point)."""
        self._sched = sched

    def _yield(self, kind: str, path: str) -> None:
        s = self._sched
        if s is None:
            return
        ts = s.current()
        if ts is None:
            return
        oid = s.step_token(f"fs:{path}")
        s._park(ts, (kind, oid))
        s._perform(ts, kind, oid)

    # -- mutating ops (each a crash-point-eligible transition) ---------- #
    def put(self, path: str, text: str) -> None:
        self._yield("fs_put_begin", path)
        f = self._files.setdefault(path, {"content": None, "durable": None})
        f["content"] = text[: max(1, len(text) // 2)]  # torn window
        self._yield("fs_put_commit", path)
        f["content"] = text

    def fsync(self, path: str) -> None:
        self._yield("fs_fsync", path)
        f = self._files.get(path)
        if f is None:
            raise OSError(f"fsync of missing file: {path}")
        f["durable"] = f["content"]

    def rename(self, src: str, dst: str) -> None:
        self._yield("fs_rename", src)
        f = self._files.pop(src, None)
        if f is None:
            raise OSError(f"rename of missing file: {src}")
        self._files[dst] = f

    # -- read surface (free, like clock reads) -------------------------- #
    def listdir(self, directory: str) -> List[str]:
        prefix = directory.rstrip("/") + "/"
        return sorted({p[len(prefix):] for p in self._files
                       if p.startswith(prefix)
                       and "/" not in p[len(prefix):]})

    def read(self, path: str) -> str:
        f = self._files.get(path)
        if f is None or f["content"] is None:
            raise OSError(f"no such durable file: {path}")
        return f["content"]

    def exists(self, path: str) -> bool:
        return path in self._files

    # ------------------------------------------------------------------ #
    def crash(self) -> None:
        """Collapse to the post-crash disk image, in place."""
        survivors: Dict[str, Dict[str, Optional[str]]] = {}
        for path, f in self._files.items():
            content = f["content"]
            if content is None:
                continue
            if content == f["durable"]:
                survivors[path] = {"content": content, "durable": content}
            else:
                half = content[: len(content) // 2]
                survivors[path] = {"content": half, "durable": half}
        self._files = survivors
        self._sched = None


class CrashRun:
    """One crash–restart schedule: a workload phase, killed at
    ``crash_at`` transitions (or run to completion for the
    clean-restart path), then a recovery phase on a FRESH scheduler
    over the surviving DurableStore. Duck-types :class:`Run` for the
    invariant checkers; ``notes`` carries a ``("crash", {...})`` marker
    between the phases so invariants can split pre from post."""

    def __init__(self, scenario: str, pre: Run, post: Optional[Run],
                 crash_at: Optional[int], crashed: bool,
                 id_choices: Tuple[int, ...]) -> None:
        self.scenario = scenario
        self.pre = pre
        self.post = post
        self.crash_at = crash_at
        self.crashed = crashed
        self.state = dict(pre.state)
        self.error = pre.error
        self.notes = list(pre.notes)
        self.notes.append(("crash", {"at": crash_at, "clean": not crashed}))
        marker = "crash" if crashed else "restart"
        self.trace = (list(pre.trace)
                      + [(-1, marker, f"@{crash_at}" if crashed
                          else "@clean")])
        # the base schedule's full choices, not pre's (possibly
        # crash-truncated) recording: replaying the id must re-force the
        # SAME base interleaving up to the crash point
        self.decisions = tuple(id_choices)
        self.points = pre.points
        self.pruned = pre.pruned
        self.deadlock = pre.deadlock
        self.stalled = pre.stalled
        self.leaked = list(pre.leaked)
        self.transitions = pre.transitions
        self.preemptions = pre.preemptions
        self.thread_errors = list(pre.thread_errors)
        if post is not None:
            self.state.update(post.state)
            self.error = self.error or post.error
            self.notes.extend(post.notes)
            self.trace.extend(post.trace)
            self.deadlock = self.deadlock or post.deadlock
            self.stalled = self.stalled or post.stalled
            self.leaked.extend(post.leaked)
            self.transitions += post.transitions
            self.thread_errors.extend(post.thread_errors)

    @property
    def schedule_id(self) -> str:
        base = f"{self.scenario}:{encode_choices(self.decisions)}"
        if self.crash_at is None:
            return base
        return f"{base}@crash:{self.crash_at}"

    def trace_fingerprint(self) -> str:
        """Both phases plus the crash marker — bit-for-bit replay means
        equal fingerprints across the whole crash–restart schedule."""
        h = hashlib.sha256()
        for tid, kind, obj in self.trace:
            h.update(f"{tid}|{kind}|{obj}\n".encode())
        return h.hexdigest()[:16]


def run_crash_schedule(scenario_name: str,
                       workload_fn: Callable[..., Optional[Dict[str, Any]]],
                       recover_fn: Callable[..., Optional[Dict[str, Any]]],
                       *, forced: Tuple[int, ...] = (),
                       sleep_plan: Tuple[FrozenSet[int], ...] = (),
                       bound: Optional[int] = None,
                       crash_at: Optional[int] = None,
                       store: Optional[DurableStore] = None) -> CrashRun:
    """Execute one crash–restart schedule.

    Phase 1 runs ``workload_fn(ctx, store)`` under ``forced``/
    ``sleep_plan``/``bound`` with the crash injected after ``crash_at``
    transitions (None: run to completion — the clean-restart path).
    The store then collapses to its post-crash image (no-op on a clean
    exit), and phase 2 runs ``recover_fn(ctx, store, pre_run)`` on a
    fresh scheduler under the DEFAULT deterministic schedule — so a
    crash schedule is fully determined by (choices, crash point) and
    its id ``scenario:<choices>@crash:<point>`` replays bit-for-bit."""
    store = store if store is not None else DurableStore()
    sched = Scheduler(forced=forced, sleep_plan=sleep_plan, bound=bound,
                      crash_at=crash_at)
    store.bind(sched)
    result: Dict[str, Any] = {}
    error: List[Optional[BaseException]] = [None]

    def main() -> None:
        ctx = Ctx(sched)
        try:
            out = workload_fn(ctx, store)
            if out:
                result.update(out)
        except SchedAbort:
            raise
        except BaseException as exc:  # noqa: BLE001 — surfaced on Run
            error[0] = exc

    with install(sched):
        sched.run(main)
    pre = Run(scenario_name, sched, result, error[0])
    crashed = sched.crashed
    if crashed:
        # threads died mid-op by design; their aborts are not errors,
        # and a workload killed mid-wait is neither deadlocked nor
        # stalled — recovery decides whether anything was LOST
        pre.error = None
        pre.thread_errors = []
        store.crash()
    id_choices = tuple(forced) if crash_at is not None else pre.decisions
    if pre.pruned is not None:
        return CrashRun(scenario_name, pre, None, crash_at, crashed,
                        id_choices)

    sched2 = Scheduler()
    store.bind(sched2)
    result2: Dict[str, Any] = {}
    error2: List[Optional[BaseException]] = [None]

    def main2() -> None:
        ctx2 = Ctx(sched2)
        try:
            out = recover_fn(ctx2, store, pre)
            if out:
                result2.update(out)
        except SchedAbort:
            raise
        except BaseException as exc:  # noqa: BLE001 — surfaced on Run
            error2[0] = exc

    with install(sched2):
        sched2.run(main2)
    post = Run(scenario_name, sched2, result2, error2[0])
    return CrashRun(scenario_name, pre, post, crash_at, crashed,
                    id_choices)


class CrashExploreResult:
    def __init__(self, scenario: str) -> None:
        self.scenario = scenario
        self.schedule_ids: List[str] = []
        self.pruned = 0
        self.exhausted = False    # base-interleaving DFS emptied
        self.bases = 0            # distinct base interleavings
        self.crash_schedules = 0  # (base, crash point) schedules run
        self.max_preemptions = 0
        self.max_transitions = 0
        self.runs_with_errors = 0
        self.sample: Dict[str, str] = {}  # schedule_id -> fingerprint

    @property
    def schedules(self) -> int:
        return len(self.schedule_ids)

    def summary(self) -> Dict[str, Any]:
        explored = self.schedules
        total = explored + self.pruned
        return {
            "schedules": explored,
            "pruned": self.pruned,
            "pruning_ratio": (self.pruned / total) if total else 0.0,
            "exhausted": self.exhausted,
            "max_preemptions": self.max_preemptions,
            "max_transitions": self.max_transitions,
            "bases": self.bases,
            "crash_schedules": self.crash_schedules,
        }


def explore_crashes(scenario_name: str,
                    workload_fn: Callable[..., Optional[Dict[str, Any]]],
                    recover_fn: Callable[..., Optional[Dict[str, Any]]],
                    *, budget: int = 40,
                    bound: Optional[int] = 3,
                    crash_budget: int = 200,
                    on_run: Optional[Callable[[CrashRun], None]] = None
                    ) -> CrashExploreResult:
    """Interleavings × crash points, deterministically.

    Stage 1 DFS-explores up to ``budget`` base interleavings of the
    workload (each also runs the clean-restart recovery — the crash-off
    durability check). Stage 2 replays each base with the crash
    injected at transition points spread evenly over the base's length,
    ``crash_budget`` schedules in total. ``on_run`` sees every
    completed CrashRun — the invariant hook."""
    res = CrashExploreResult(scenario_name)
    seen: set = set()

    def finish(crun: CrashRun) -> None:
        sid = crun.schedule_id
        if sid in seen:
            return
        seen.add(sid)
        res.schedule_ids.append(sid)
        res.max_preemptions = max(res.max_preemptions, crun.preemptions)
        res.max_transitions = max(res.max_transitions, crun.transitions)
        if crun.error is not None or crun.thread_errors:
            res.runs_with_errors += 1
        if len(res.sample) < 4:
            res.sample[sid] = crun.trace_fingerprint()
        if on_run is not None:
            on_run(crun)

    # stage 1: base interleavings (same DFS + sleep sets as explore())
    bases: List[Tuple[Tuple[int, ...], Tuple[FrozenSet[int], ...], int]] = []
    stack: List[Tuple[Tuple[int, ...], Tuple[FrozenSet[int], ...]]] = [
        ((), ())]
    while stack:
        if len(bases) >= budget:
            break
        forced, sleep_plan = stack.pop()
        crun = run_crash_schedule(scenario_name, workload_fn, recover_fn,
                                  forced=forced, sleep_plan=sleep_plan,
                                  bound=bound, crash_at=None)
        if crun.pruned is not None:
            res.pruned += 1
        else:
            bases.append((crun.decisions, sleep_plan,
                          crun.pre.transitions))
            finish(crun)
        for j in range(len(forced), len(crun.pre.decisions)):
            pt = crun.points[j]
            chosen = pt["chosen"]
            slept = set(pt["sleeping"])
            newly = [chosen]
            for alt in pt["schedulable"]:
                if alt == chosen or alt in slept:
                    continue
                child_plan = list(sleep_plan)
                while len(child_plan) < j:
                    child_plan.append(frozenset())
                child_plan.append(frozenset(newly))
                stack.append((tuple(crun.pre.decisions[:j]) + (alt,),
                              tuple(child_plan)))
                newly.append(alt)
    res.exhausted = not stack
    res.bases = len(bases)

    # stage 2: crash points, spread evenly across each base's length
    if bases:
        per_base = max(1, -(-crash_budget // len(bases)))  # ceil
        for decisions, sleep_plan, ntrans in bases:
            if res.crash_schedules >= crash_budget:
                break
            if ntrans <= 1:
                continue
            stride = max(1, -(-(ntrans - 1) // per_base))
            for k in range(1, ntrans, stride):
                if res.crash_schedules >= crash_budget:
                    break
                crun = run_crash_schedule(
                    scenario_name, workload_fn, recover_fn,
                    forced=decisions, sleep_plan=sleep_plan, bound=bound,
                    crash_at=k)
                res.crash_schedules += 1
                if crun.pruned is not None:
                    res.pruned += 1
                else:
                    finish(crun)
    return res
