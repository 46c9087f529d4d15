"""Dispatch-hygiene watchdog (counterpart of
``split_learning_tpu/obs/dispatch_debug.py``).

Off unless ``SLT_DISPATCH_DEBUG=1`` (or :func:`force` for in-process
runs). When on, the runtimes attach the process-wide
:class:`DispatchTracker`, which

* counts kernel builds: each ``nvcc`` run of
  ``ops/common.py:load_kernels`` adds one to ``slt_compile_count`` (a
  cached build runs no ``nvcc`` and counts nothing), the counterpart of
  JAX's XLA compile events;
* flags a **steady-state violation** when, inside a step scope whose
  per-key ordinal is >= 2 and whose input signature has been seen
  before, a kernel build runs or the scope's kernel launches
  (``ops/common.py:LAUNCHES``, counted per thread) differ from the
  previous scope of that key and signature: the first call of a program
  may build, a second may still settle, anything later is a per-step
  change in what runs;
* catches a device-to-host sync inside a step scope and outside an
  :func:`expected_d2h` region at its site, through
  ``torch.cuda.set_sync_debug_mode``, and counts it into
  ``slt_unexpected_d2h_total``. A sync inside an :func:`expected_d2h`
  region counts into ``slt_expected_d2h_total`` instead.

``torch.cuda.set_sync_debug_mode`` is process-wide where JAX's transfer
guard is scoped, so the tracker never sets it to ``"error"``: it sets
``"warn"``, and PyTorch raises that warning on the thread that made the
synchronising call. :func:`install` puts a hook in front of
``warnings.showwarning`` that judges the warning by the calling
thread's own state (its scope stack and its ``expected_d2h`` depth, both
thread-local), so a scope on one thread never flags another thread's
sanctioned read (the server's handler threads, the chain's hop
threads). A sync on a thread in no scope is ignored, as JAX's guard
ignores transfers outside its scopes; the hook prints none of these
warnings. The violation is counted and
reported (stderr and a flight-recorder trip), not raised.

PyTorch runs a backward's CUDA nodes (K1b, K6, a custom
``autograd.Function``'s backward) on its autograd device thread, which
is in no scope. So a step scope turns autograd's multithreading off on
its own thread (``torch.autograd.set_multithreading_enabled(False)``,
thread-local): the scope's backward runs on the scope's thread, and its
launches and syncs are judged there. This moves the backward's host-side
dispatch onto the caller while the watchdog is on, and nothing when it
is off; the kernels, their order on the stream and the numbers are the
same.

On the CPU nothing synchronises and no kernel is built: the mode is set
only where CUDA is available, and the CPU tests drive the reporting
machinery with warnings of the same text from chosen threads.

With the gate off, every hook in the runtimes is ``None``-gated and
:func:`step_scope`/:func:`expected_d2h` hand back one shared
``nullcontext``: no overhead and bit-for-bit the same numbers.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import warnings
from typing import Any, Callable, Dict, Hashable, List, Optional

# a retrace on the second call of a program can be legitimate; from the
# third on it cannot (JAX's rule, kept)
_STEADY_ORDINAL = 2

# the text of PyTorch's sync-debug warning ("called a synchronizing CUDA
# operation"), matched as a substring
SYNC_WARNING = "synchronizing CUDA operation"

_forced = False


def enabled() -> bool:
    """Whether dispatch instrumentation is on (env read per call so tests
    can flip it; runtimes bind their tracker at construction)."""
    return (_forced
            or os.environ.get("SLT_DISPATCH_DEBUG", "") not in ("", "0"))


def force(flag: bool) -> None:
    """In-process override of the env gate."""
    global _forced
    _forced = bool(flag)


_tokens = itertools.count(1)


def token() -> int:
    """Process-unique instance token for step-scope keys (``id(self)``
    would recycle after gc and hand a successor the dead instance's
    ordinals)."""
    return next(_tokens)


class DispatchTracker:
    """Build, launch and sync accounting shared by every runtime that
    attaches while the watchdog is on. Scopes are keyed by any hashable
    (runtimes pass ``(token, program)``) and count a per-key local
    ordinal, never the wire step."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tl = threading.local()
        self.compile_count = 0
        self.unexpected_d2h = 0
        self.expected_d2h = 0
        self.violations: List[Dict[str, Any]] = []
        self._ordinals: Dict[Hashable, int] = {}
        self._sigs: Dict[Hashable, set] = {}
        self._last_launches: Dict[Hashable, Dict[str, int]] = {}
        self._flagged: set = set()

    # -- per-thread state ---------------------------------------------- #
    def _stack(self) -> List[Dict[str, Any]]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    def _allow_depth(self) -> int:
        return getattr(self._tl, "allow", 0)

    # -- step scopes ---------------------------------------------------- #
    @contextlib.contextmanager
    def scope(self, key: Hashable, sig: Hashable = None,
              fresh: Optional[bool] = None):
        """Mark one dispatch of the program ``key``. ``sig`` is the call's
        input signature; the first time each signature shows up the scope
        is *fresh* and a build or a new launch pattern in it is legitimate
        at any ordinal. Callers that track signatures themselves pass
        ``fresh``."""
        with self._mu:
            ordinal = self._ordinals.get(key, 0)
            self._ordinals[key] = ordinal + 1
            if fresh is None:
                if sig is None:
                    fresh = ordinal == 0
                else:
                    seen = self._sigs.setdefault(key, set())
                    fresh = sig not in seen
                    seen.add(sig)
        rec = {"key": key, "sig": sig, "ordinal": ordinal,
               "fresh": bool(fresh), "launches": {}}
        stack = self._stack()
        stack.append(rec)
        import torch
        try:
            # the backward's CUDA nodes run on this thread, not on
            # PyTorch's autograd device thread, where a launch or a sync
            # would be out of this scope's sight
            with torch.autograd.set_multithreading_enabled(False):
                yield rec
        finally:
            stack.pop()
            self._close_scope(rec)

    def _steady(self, rec: Dict[str, Any]) -> bool:
        return rec["ordinal"] >= _STEADY_ORDINAL and not rec["fresh"]

    def _close_scope(self, rec: Dict[str, Any]) -> None:
        mark = (rec["key"], rec["sig"])
        with self._mu:
            before = self._last_launches.get(mark)
            self._last_launches[mark] = dict(rec["launches"])
            if (before is None or before == rec["launches"]
                    or not self._steady(rec)):
                return
            self._flag(rec, "steady-state-launch-change", (
                f"steady-state launch change: scope {rec['key']!r} at "
                f"local ordinal {rec['ordinal']} launched "
                f"{rec['launches']} where the previous call of that "
                f"signature launched {before}"))

    def _flag(self, rec: Dict[str, Any], kind: str, message: str) -> None:
        # caller holds self._mu
        mark = (rec["key"], rec["ordinal"], kind)
        if mark in self._flagged:
            return
        self._flagged.add(mark)
        self._report({"kind": kind, "key": rec["key"],
                      "ordinal": rec["ordinal"], "message": message})

    # -- hooks (ops/common.py and the sync warnings) -------------------- #
    def on_launch(self, name: str) -> None:
        """One kernel launch on this thread (``LaunchCounts.add``)."""
        stack = self._stack()
        if stack:
            counts = stack[-1]["launches"]
            counts[name] = counts.get(name, 0) + 1

    def on_build(self, n: int) -> None:
        """``n`` nvcc runs on this thread (``load_kernels``)."""
        with self._mu:
            self.compile_count += int(n)
        stack = self._stack()
        rec = stack[-1] if stack else None
        if rec is None or not self._steady(rec):
            return
        with self._mu:
            self._flag(rec, "steady-state-build", (
                f"steady-state kernel build: {n} nvcc run(s) inside step "
                f"scope {rec['key']!r} at local ordinal {rec['ordinal']} "
                "with a previously-seen signature"))

    def on_sync(self, message: str) -> bool:
        """One synchronising CUDA call on this thread (PyTorch's
        sync-debug warning). Returns whether the tracker took it: a
        sanctioned read (inside :meth:`allow`) or a violation (inside a
        scope); a sync on a thread in neither is left alone."""
        if self._allow_depth() > 0:
            with self._mu:
                self.expected_d2h += 1
            return True
        stack = self._stack()
        if not stack:
            return False
        rec = stack[-1]
        with self._mu:
            self.unexpected_d2h += 1
            self._report({
                "kind": "unexpected-d2h", "key": rec["key"],
                "ordinal": rec["ordinal"],
                "message": (f"unexpected device-to-host sync inside step "
                            f"scope {rec['key']!r}: {message}")})
        return True

    @contextlib.contextmanager
    def allow(self):
        """A sanctioned materialisation site on this thread."""
        self._tl.allow = self._allow_depth() + 1
        try:
            yield
        finally:
            self._tl.allow -= 1

    # -- reporting ------------------------------------------------------ #
    def _report(self, violation: Dict[str, Any]) -> None:
        # caller holds self._mu
        self.violations.append(violation)
        print(f"[slt-dispatch] {violation['message']}", file=sys.stderr)
        try:
            from split_learning_tpu_torch.obs import flight as obs_flight
            obs_flight.trip("dispatch", violation["message"])
        except Exception:
            pass

    def gauges(self) -> Dict[str, float]:
        """The watchdog's /metrics contribution (render_prometheus adds
        the ``slt_`` prefix)."""
        with self._mu:
            steady = sum(1 for v in self.violations
                         if v["kind"].startswith("steady-state"))
            return {"compile_count": float(self.compile_count),
                    "unexpected_d2h_total": float(self.unexpected_d2h),
                    "expected_d2h_total": float(self.expected_d2h),
                    "steady_state_recompiles": float(steady)}

    def clear(self) -> None:
        with self._mu:
            self.compile_count = 0
            self.unexpected_d2h = 0
            self.expected_d2h = 0
            self.violations.clear()
            self._ordinals.clear()
            self._sigs.clear()
            self._last_launches.clear()
            self._flagged.clear()


_default_tracker = DispatchTracker()


def tracker() -> DispatchTracker:
    """The process-wide tracker :func:`attach` hands to runtimes."""
    return _default_tracker


# ------------------------------------------------------------------ #
# installation: the launch/build hooks and the sync-warning hook
# ------------------------------------------------------------------ #

_installed = False
_install_lock = threading.Lock()
_saved: Dict[str, Any] = {}


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    text = str(message)
    if SYNC_WARNING in text:
        # the tracker's own "warn" mode raised it: counted where it
        # counts, never printed (every sync of the process warns)
        _default_tracker.on_sync(text)
        return
    _saved["showwarning"](message, category, filename, lineno, file, line)


def install() -> None:
    """Hook the tracker into ``LAUNCHES``, ``load_kernels`` and the
    warnings machinery, and set the sync debug mode to ``"warn"`` where
    CUDA is available (idempotent)."""
    global _installed
    import torch

    from split_learning_tpu_torch.ops import common
    with _install_lock:
        if _installed:
            return
        common.LAUNCHES.hook = _default_tracker.on_launch
        common.BUILD_HOOK = _default_tracker.on_build
        _saved["showwarning"] = warnings.showwarning
        warnings.showwarning = _showwarning
        # every occurrence, not once per call site: each one is a sync
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        if torch.cuda.is_available():
            _saved["mode"] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _installed = True


def uninstall() -> None:
    """Undo :func:`install`: hooks off, the previous sync debug mode."""
    global _installed
    import torch

    from split_learning_tpu_torch.ops import common
    with _install_lock:
        if not _installed:
            return
        common.LAUNCHES.hook = None
        common.BUILD_HOOK = None
        warnings.showwarning = _saved.pop("showwarning")
        warnings.filters[:] = [
            f for f in warnings.filters
            if not (f[0] == "always" and f[1] is not None
                    and SYNC_WARNING in f[1].pattern)]
        if "mode" in _saved:
            torch.cuda.set_sync_debug_mode(_saved.pop("mode"))
        _installed = False


def attach() -> Optional[DispatchTracker]:
    """What a runtime binds at construction: the installed process-wide
    tracker when the watchdog is on, ``None`` (the sentinel every hook
    gates on) otherwise."""
    if not enabled():
        return None
    install()
    return _default_tracker


# ------------------------------------------------------------------ #
# hot-path helpers (None-gated, one shared nullcontext when off)
# ------------------------------------------------------------------ #

_NULL_CTX = contextlib.nullcontext()


def step_scope(t: Optional[DispatchTracker], key: Hashable,
               sig_fn: Optional[Callable[[], Hashable]] = None,
               fresh: Optional[bool] = None):
    """``with dispatch_debug.step_scope(self._dd, (self._ddtok, "x"),
    ...)`` around a program's launches. ``sig_fn`` is evaluated only when
    the watchdog is on."""
    if t is None:
        return _NULL_CTX
    return t.scope(key, sig=sig_fn() if sig_fn is not None else None,
                   fresh=fresh)


def expected_d2h(t: Optional[DispatchTracker]):
    """Mark a sanctioned host read (the loss, the reply); the shared
    no-op when the watchdog is off."""
    if t is None:
        return _NULL_CTX
    return t.allow()


def signature(*xs: Any) -> tuple:
    """The shapes and dtypes of ``xs``: a scope's input signature."""
    return tuple((tuple(getattr(x, "shape", ())), str(getattr(x, "dtype",
                                                              type(x))))
                 for x in xs)
