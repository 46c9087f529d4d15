"""Lock-discipline watchdog, the dynamic half of slt-lint (counterpart
of ``split_learning_tpu/obs/locks.py``).

The static rules (``split_learning_tpu_torch/analysis/``) prove what they
can at the AST level; this module checks the rest at runtime. With
``SLT_LOCK_DEBUG=1`` the runtime, coalescer, admission, fleet and
replay-cache locks become :class:`InstrumentedLock`\\ s that

* record the per-thread acquisition stack and register every observed
  nested-acquisition pair in a process-wide :class:`LockGraph`,
* report a **lock-order inversion** the moment an edge ``B -> A``
  appears after ``A -> B`` was ever observed (the two orders need not
  race: seeing both on any schedule is a deadlock waiting for the
  interleaving),
* report **hold-time budget** violations when ``SLT_LOCK_BUDGET_MS`` is
  set (off by default: a first step's kernel build runs under the
  runtime lock for seconds),
* feed hold times into the ``lock_hold`` histogram of a metrics
  registry.

Each report trips the flight recorder (``obs/flight.py`` :func:`trip`).
With the variable unset :func:`make_lock` returns the plain
``threading`` primitive: zero overhead and identical behaviour.

The same constructors are the model checker's seam
(``analysis/sched.py``): while slt-check explores a schedule it installs
a factory (:func:`install_checker`) and every lock, event, condition
and thread the runtime builds through :func:`make_lock`,
:func:`make_event`, :func:`make_condition` and :func:`make_thread` is a
cooperative, scheduler-controlled one.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from split_learning_tpu_torch.obs import spans


def enabled() -> bool:
    """Whether lock instrumentation is on (read per call so tests can
    flip the env var; locks themselves bind at construction)."""
    return os.environ.get("SLT_LOCK_DEBUG", "") not in ("", "0")


def _env_budget_s() -> Optional[float]:
    raw = os.environ.get("SLT_LOCK_BUDGET_MS", "")
    return float(raw) / 1e3 if raw else None


class LockGraph:
    """Acquisition-order edges + violation reports, shared across all
    instrumented locks that point at it.

    Edges are keyed ``(outer, inner)`` — "``inner`` was acquired while
    ``outer`` was held" — and remember the thread that first exhibited
    them, so an inversion report names both witnesses."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.edges: Dict[Tuple[str, str], str] = {}
        self.violations: List[Dict[str, Any]] = []

    def note_acquire(self, name: str, held: List[str]) -> None:
        thread = threading.current_thread().name
        with self._lock:
            for outer in held:
                if outer == name:
                    continue  # reentrant re-acquire, not an ordering edge
                self.edges.setdefault((outer, name), thread)
                rev = self.edges.get((name, outer))
                if rev is not None and not self._seen(name, outer):
                    self._report({
                        "kind": "lock-order-inversion",
                        "locks": (outer, name),
                        "forward_thread": rev,
                        "reverse_thread": thread,
                        "message": (
                            f"lock-order inversion: {name!r} -> {outer!r} "
                            f"(thread {rev}) vs {outer!r} -> {name!r} "
                            f"(thread {thread})"),
                    })

    def note_hold(self, name: str, seconds: float,
                  budget_s: Optional[float]) -> None:
        if budget_s is None or seconds <= budget_s:
            return
        with self._lock:
            self._report({
                "kind": "hold-budget",
                "locks": (name,),
                "seconds": seconds,
                "budget_s": budget_s,
                "message": (f"hold-budget violation: {name!r} held "
                            f"{seconds * 1e3:.1f} ms > budget "
                            f"{budget_s * 1e3:.1f} ms"),
            })

    def _seen(self, a: str, b: str) -> bool:
        pair = tuple(sorted((a, b)))
        return any(v["kind"] == "lock-order-inversion"
                   and tuple(sorted(v["locks"])) == pair
                   for v in self.violations)

    def _report(self, violation: Dict[str, Any]) -> None:
        # caller holds self._lock
        self.violations.append(violation)
        print(f"[slt-lock] {violation['message']}", file=sys.stderr)
        # the flight recorder's watchdog trigger: trip() never raises and
        # takes no lock, so calling it holding self._lock is safe
        from split_learning_tpu_torch.obs import flight as obs_flight
        obs_flight.trip("lock", violation["message"])

    def clear(self) -> None:
        with self._lock:
            self.edges.clear()
            self.violations.clear()


_default_graph = LockGraph()


def default_graph() -> LockGraph:
    """The process-wide graph :func:`make_lock` locks report into."""
    return _default_graph


# every InstrumentedLock held by the current thread, outermost first;
# module-global so ordering is seen across *different* graphs' locks too
_held = threading.local()


def _held_stack() -> List[str]:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


class InstrumentedLock:
    """Drop-in for ``threading.Lock``/``RLock`` with acquisition-stack
    bookkeeping. Works as the lock of a ``threading.Condition`` (it
    implements the ``_release_save``/``_acquire_restore``/``_is_owned``
    protocol), which is how the coalescer's condition variable gets
    instrumented without touching its wait logic."""

    def __init__(self, name: str, *, reentrant: bool = True,
                 graph: Optional[LockGraph] = None,
                 registry: Optional[Any] = None,
                 budget_s: Any = "env") -> None:
        self.name = name
        self._inner: Any = threading.RLock() if reentrant else threading.Lock()
        self._graph = graph if graph is not None else _default_graph
        self._registry = registry
        self._budget_s = _env_budget_s() if budget_s == "env" else budget_s
        self._tl = threading.local()

    # -- bookkeeping ---------------------------------------------------- #

    def _depth(self) -> int:
        return getattr(self._tl, "depth", 0)

    def _note_acquired(self) -> None:
        d = self._depth()
        if d == 0:
            stack = _held_stack()
            self._graph.note_acquire(self.name, list(stack))
            stack.append(self.name)
            self._tl.t0 = time.perf_counter()
        self._tl.depth = d + 1

    def _note_released(self) -> None:
        d = self._depth()
        if d == 1:
            seconds = time.perf_counter() - getattr(self._tl, "t0", 0.0)
            stack = _held_stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break
            self._graph.note_hold(self.name, seconds, self._budget_s)
            if self._registry is not None:
                self._registry.observe(spans.LOCK_HOLD, seconds)
        self._tl.depth = max(d - 1, 0)

    # -- lock protocol --------------------------------------------------- #

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else self._depth() > 0

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name!r} depth={self._depth()}>"

    # -- threading.Condition protocol ------------------------------------ #

    def _is_owned(self) -> bool:
        return self._depth() > 0

    def _release_save(self) -> Tuple[Any, int]:
        # Condition.wait fully releases regardless of recursion depth;
        # account it as a complete release so hold time and the held
        # stack stay truthful across the wait
        d = self._depth()
        if d > 0:
            self._tl.depth = 1
            self._note_released()
        self._tl.depth = 0
        saver = getattr(self._inner, "_release_save", None)
        if saver is not None:
            return saver(), d
        self._inner.release()
        return None, d

    def _acquire_restore(self, saved: Tuple[Any, int]) -> None:
        state, d = saved
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None:
            restorer(state)
        else:
            self._inner.acquire()
        self._tl.depth = 0
        self._note_acquired()
        self._tl.depth = max(d, 1)


# --------------------------------------------------------------------- #
# model-checker interposition (analysis/sched.py)
#
# slt-check installs a factory here for the duration of one explored
# schedule; every primitive the runtime constructs through the seam
# below becomes a cooperative, scheduler-controlled object, so each
# acquire/release/wait/notify/set is a yield point the explorer can
# branch on. With no factory installed the functions return the plain
# ``threading`` primitives (or InstrumentedLock under SLT_LOCK_DEBUG=1)
# — zero overhead on the production path, same off-path convention as
# chaos and tracing.

_checker: Optional[Any] = None


def install_checker(factory: Optional[Any]) -> Optional[Any]:
    """Install (or, with ``None``, remove) the cooperative-scheduler
    primitive factory. Returns the previous factory so callers can
    restore it; analysis/sched.py wraps this in a try/finally."""
    global _checker
    prev = _checker
    _checker = factory
    return prev


def checker_installed() -> bool:
    return _checker is not None


def make_lock(name: str, *, reentrant: bool = True,
              registry: Optional[Any] = None,
              graph: Optional[LockGraph] = None) -> Any:
    """Construct the lock a runtime component should use: the plain
    ``threading`` primitive when the watchdog is off (zero overhead —
    the wire and the numerics cannot change), an
    :class:`InstrumentedLock` reporting into ``graph`` (default: the
    process-wide graph) when ``SLT_LOCK_DEBUG=1``, or the
    model checker's cooperative lock while slt-check is exploring."""
    if _checker is not None:
        return _checker.lock(name, reentrant=reentrant)
    if not enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return InstrumentedLock(name, reentrant=reentrant, registry=registry,
                            graph=graph)


def make_event(name: str = "event") -> Any:
    """Event twin of :func:`make_lock`: a plain ``threading.Event``
    normally, the model checker's cooperative event while slt-check is
    exploring. Events are future-completion latches (replay entries,
    coalesce request ``done``), so they carry no ordering graph and the
    SLT_LOCK_DEBUG watchdog leaves them plain. ``name`` documents the
    call site."""
    if _checker is not None:
        return _checker.event(name)
    return threading.Event()


def make_condition(name: str) -> Any:
    """Condition twin of :func:`make_lock`: a ``threading.Condition``
    over a reentrant :func:`make_lock` lock (so the watchdog instruments
    the underlying mutex via the ``_release_save`` protocol), or the
    model checker's cooperative condition while slt-check is exploring."""
    if _checker is not None:
        return _checker.condition(name)
    return threading.Condition(make_lock(name))


def make_thread(target: Any, *, name: str, daemon: bool = True) -> Any:
    """Thread twin of :func:`make_lock`: a plain ``threading.Thread``
    normally, a scheduler-managed thread while slt-check is exploring
    (spawn/join become yield points and the explorer serializes it with
    every other managed thread)."""
    if _checker is not None:
        return _checker.thread(target, name=name, daemon=daemon)
    return threading.Thread(target=target, name=name, daemon=daemon)
