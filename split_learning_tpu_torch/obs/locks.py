"""Lock-discipline watchdog (counterpart of
``split_learning_tpu/obs/locks.py``, less the model checker's seam).

With ``SLT_LOCK_DEBUG=1`` the runtime and replay-cache locks become
:class:`InstrumentedLock`\\ s that record the per-thread acquisition
stack in a process-wide :class:`LockGraph`, report a lock-order
inversion the moment an edge ``B -> A`` appears after ``A -> B``, report
hold times above ``SLT_LOCK_BUDGET_MS`` (off by default), and feed hold
times into the ``lock_hold`` histogram of a metrics registry. With the
variable unset, :func:`make_lock` returns the plain ``threading``
primitive: zero overhead and identical behaviour.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from split_learning_tpu_torch.obs import spans


def enabled() -> bool:
    """Whether lock instrumentation is on (read per call; locks bind at
    construction)."""
    return os.environ.get("SLT_LOCK_DEBUG", "") not in ("", "0")


def _env_budget_s() -> Optional[float]:
    raw = os.environ.get("SLT_LOCK_BUDGET_MS", "")
    return float(raw) / 1e3 if raw else None


class LockGraph:
    """Acquisition-order edges and violation reports. Edges are keyed
    ``(outer, inner)`` ("``inner`` was acquired while ``outer`` was
    held") and remember the thread that first showed them."""

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
                "kind": "hold-budget", "locks": (name,),
                "seconds": seconds, "budget_s": budget_s,
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

    def clear(self) -> None:
        with self._lock:
            self.edges.clear()
            self.violations.clear()


_default_graph = LockGraph()


def default_graph() -> LockGraph:
    """The process-wide graph :func:`make_lock` locks report into."""
    return _default_graph


# every InstrumentedLock held by the current thread, outermost first
_held = threading.local()


def _held_stack() -> List[str]:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


class InstrumentedLock:
    """Drop-in for ``threading.Lock``/``RLock`` with acquisition-stack
    bookkeeping."""

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

    def _depth(self) -> int:
        return getattr(self._tl, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = self._depth()
            if d == 0:
                stack = _held_stack()
                self._graph.note_acquire(self.name, list(stack))
                stack.append(self.name)
                self._tl.t0 = time.perf_counter()
            self._tl.depth = d + 1
        return got

    def release(self) -> None:
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
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name!r} depth={self._depth()}>"


def make_lock(name: str, *, reentrant: bool = True,
              registry: Optional[Any] = None,
              graph: Optional[LockGraph] = None) -> Any:
    """The lock a runtime component should use: the plain ``threading``
    primitive when the watchdog is off, an :class:`InstrumentedLock`
    when ``SLT_LOCK_DEBUG=1``."""
    if not enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return InstrumentedLock(name, reentrant=reentrant, registry=registry,
                            graph=graph)


def make_event(name: str = "event") -> threading.Event:
    """Event twin of :func:`make_lock`: a plain ``threading.Event`` (the
    future-completion latch of a replay entry). ``name`` documents the
    call site."""
    del name
    return threading.Event()
