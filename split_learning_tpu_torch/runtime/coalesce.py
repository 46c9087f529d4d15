"""Server-side request coalescing: dynamic batching of split-step traffic
(counterpart of ``split_learning_tpu/runtime/coalesce.py``).

Concurrent ``split_step`` calls enqueue and block on a future; one
flusher thread takes up to ``max_group`` same-shape requests (or what
arrived within ``window_s``) and hands them to ONE batched dispatch over
the concatenated batch (BASELINE config 3: many clients, one server).

Semantics, as in JAX: the group applies a single server update on the
group-mean loss instead of N sequential updates. Each client still gets
the gradient of its own segment-mean loss (the group gradient rescaled
by group/segment rows, exact for per-example losses) and its own
segment-mean loss, so the client's math is unchanged and a group of one
reproduces the serialized step. ``max_group=1`` servers build no
coalescer at all (the serialized path, bit for bit).

Two flush policies share the queue (``mode``):

- ``"window"``: block for a head request, then wait out ``window_s``
  from its arrival for peers.
- ``"continuous"`` (:class:`ContinuousBatcher`): never sleep on a timer
  while work is queued. The moment the previous group's dispatch
  returns (the dispatch only launches work on the card), the next group
  is whatever is queued now, picked earliest-deadline-first on the
  ``deadline`` the admission layer stamped (``runtime/admission.py``),
  ties in arrival order.

This is the queue half, host code only: the batched math is injected as
``dispatch`` (``ServerRuntime._dispatch_group``). A request's ``acts``
and ``labels`` are numpy arrays or tensors, kept as they were given; a
result may be a value or a zero-argument thunk that :meth:`submit`
redeems on the waiter's thread (the group's one host read, off the
flusher). The counters (``groups_flushed``, ``flush_full``,
``flush_window``, ``flush_continuous``, ``requests_coalesced``,
``compile_count`` from the dispatcher, and the derived
``mean_occupancy``) keep JAX's names.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.base import TransportStats


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n: JAX pads its groups to these buckets so
    its jit cache sees O(log max_batch) shapes; the port counts the same
    signatures (``compile_count``) without padding."""
    if n < 1:
        raise ValueError(f"bucket size must be positive (got {n})")
    return 1 << (n - 1).bit_length()


def _dtype_name(x: Any) -> str:
    """A dtype's name, the same for a numpy array and a tensor."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _tail(x: Any) -> tuple:
    return tuple(int(d) for d in tuple(x.shape)[1:])


@dataclass
class CoalesceRequest:
    """One enqueued split step waiting for its group to flush."""

    acts: Any
    labels: Any
    step: int
    client_id: int
    done: threading.Event = field(
        default_factory=lambda: obs_locks.make_event("CoalesceRequest.done"))
    # a value, or a zero-arg thunk submit() redeems on the waiter thread
    result: Optional[Any] = None
    error: Optional[BaseException] = None
    # obs, set by submit() only while tracing is on: the caller's trace
    # id, the enqueue time, and the dispatcher's span timings
    trace_id: Optional[str] = None
    t_enqueue: Optional[float] = None
    server_spans: Optional[dict] = None
    # EDF priority (continuous mode): the monotonic-clock SLO deadline
    # the admission layer stamped; None sorts last
    deadline: Optional[float] = None
    # arrival sequence, stamped under the queue lock: the EDF tie-breaker
    seq: int = 0

    def shape_key(self) -> tuple:
        """Requests coalesce only when all but the row count match."""
        return (_tail(self.acts), _dtype_name(self.acts),
                _tail(self.labels), _dtype_name(self.labels))


class RequestCoalescer:
    """FIFO queue + flusher thread turning concurrent requests into groups.

    ``dispatch(group, flush_reason)`` must resolve every request of the
    group (set ``result`` or ``error`` and fire ``done``); each request
    reaches exactly one dispatch, in arrival order within a shape class.
    A request of another shape than the group's head waits for the next
    group. A dispatch that raises fails every waiter of its group with
    that error, and the flusher lives on."""

    def __init__(self, dispatch: Callable[[List[CoalesceRequest], str], None],
                 max_group: int, window_s: float,
                 mode: str = "window") -> None:
        if max_group < 2:
            raise ValueError(
                f"coalescing needs max_group >= 2 (got {max_group}); "
                "max_group=1 is the serialized path: don't build a "
                "coalescer for it")
        if window_s < 0:
            raise ValueError(f"window must be >= 0 (got {window_s})")
        if mode not in ("window", "continuous"):
            raise ValueError(
                f"mode must be 'window' or 'continuous' (got {mode!r})")
        self._dispatch = dispatch
        self.max_group = max_group
        self.window_s = window_s
        self.mode = mode
        self.stats = TransportStats()
        self._queue: List[CoalesceRequest] = []
        self._arrivals = 0  # next CoalesceRequest.seq
        self._cond = obs_locks.make_condition("RequestCoalescer._cond")
        self._closed = False
        self._thread = obs_locks.make_thread(
            self._run, name="slt-coalescer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def submit(self, acts: Any, labels: Any, step: int, client_id: int,
               timeout: float = 120.0, trace_id: Optional[str] = None,
               t_enqueue: Optional[float] = None,
               deadline: Optional[float] = None) -> Any:
        """Enqueue one request and block until its group's dispatch
        resolves it; a server-side error re-raises in the caller's
        thread. ``acts``/``labels`` are kept as given (numpy or
        tensors)."""
        req = CoalesceRequest(acts, labels, step, client_id,
                              trace_id=trace_id, t_enqueue=t_enqueue,
                              deadline=deadline)
        with self._cond:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            req.seq = self._arrivals
            self._arrivals += 1
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify_all()
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_GROUP_FORM, step=int(step),
                      client_id=int(client_id), party="server",
                      depth=depth)
        if not req.done.wait(timeout=timeout):
            raise TimeoutError(
                f"coalesced split_step for client {client_id} step {step} "
                f"not flushed within {timeout}s")
        if req.error is None and callable(req.result):
            # the dispatch only launched the group's work; THIS waiter
            # redeems the group's host read, off the flusher
            req.result = req.result()
        if req.server_spans is not None:
            from split_learning_tpu_torch.obs import trace as obs_trace
            obs_trace.CTX.server_spans = req.server_spans
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    # ------------------------------------------------------------------ #
    def _collect_group(self) -> Optional[Tuple[List[CoalesceRequest], str]]:
        """Block for a head request, then form the next group by mode.
        Returns None only at shutdown."""
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained

            if self.mode == "continuous":
                # EDF: undeadlined requests sort last, arrival order
                # breaks ties
                order = sorted(
                    range(len(self._queue)),
                    key=lambda i: (
                        self._queue[i].deadline
                        if self._queue[i].deadline is not None
                        else float("inf"), self._queue[i].seq))
                key = self._queue[order[0]].shape_key()
                group: List[CoalesceRequest] = []
                taken = set()
                for i in order:
                    if len(group) >= self.max_group:
                        break
                    if self._queue[i].shape_key() == key:
                        group.append(self._queue[i])
                        taken.add(i)
                self._queue = [r for i, r in enumerate(self._queue)
                               if i not in taken]
                reason = ("full" if len(group) >= self.max_group
                          else "continuous")
                return group, reason

            key = self._queue[0].shape_key()
            deadline = time.monotonic() + self.window_s

            def take_matching(group: List[CoalesceRequest]) -> None:
                remaining = []
                for r in self._queue:
                    if len(group) < self.max_group and r.shape_key() == key:
                        group.append(r)
                    else:
                        remaining.append(r)
                self._queue = remaining

            group = []
            take_matching(group)
            while len(group) < self.max_group and not self._closed:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                self._cond.wait(timeout=budget)
                take_matching(group)
            reason = "full" if len(group) >= self.max_group else "window"
            return group, reason

    def _run(self) -> None:
        while True:
            got = self._collect_group()
            if got is None:
                return
            group, reason = got
            fl = obs_flight.get_recorder()
            if fl is not None:
                fl.record(spans.FL_GROUP_PICKUP, step=int(group[0].step),
                          client_id=int(group[0].client_id),
                          party="server", size=len(group), reason=reason)
            t0 = time.perf_counter()
            try:
                self._dispatch(group, reason)
            except BaseException as exc:  # noqa: BLE001 (the flusher
                # must live on: every waiter gets the failure)
                for r in group:
                    if not r.done.is_set():
                        r.error = exc
                        r.done.set()
            self.stats.record(time.perf_counter() - t0)
            self.stats.incr("groups_flushed")
            self.stats.incr("requests_coalesced", len(group))
            self.stats.incr(f"flush_{reason}")

    # ------------------------------------------------------------------ #
    def counters(self) -> dict:
        """Snapshot for /health: the raw counters and the mean occupancy
        (requests per flushed group)."""
        with self.stats._lock:
            c = dict(self.stats.counters)
        groups = c.get("groups_flushed", 0)
        c["mean_occupancy"] = (
            c.get("requests_coalesced", 0) / groups if groups else 0.0)
        return c

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting requests, flush what is queued, join the
        flusher, then fail anything still queued with a terminal error,
        so no waiter hangs out its whole timeout. Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        with self._cond:
            leftovers, self._queue = self._queue, []
        for r in leftovers:
            if not r.done.is_set():
                r.error = RuntimeError("coalescer closed before dispatch")
                r.done.set()


class ContinuousBatcher(RequestCoalescer):
    """A :class:`RequestCoalescer` pinned to continuous mode. ``window_s``
    exists so both modes build alike; continuous collection never waits
    on it."""

    def __init__(self, dispatch: Callable[[List[CoalesceRequest], str], None],
                 max_group: int, window_s: float = 0.0) -> None:
        super().__init__(dispatch, max_group, window_s, mode="continuous")
