"""PipelineRunner: the hub that drives the K-stage chain (counterpart of
``split_learning_tpu/runtime/pipeline_runner.py``).

Stage 0 trains here (the data owner); stages 1..S-1 are
:class:`~split_learning_tpu_torch.runtime.stage.StageRuntime` parties
reached through one transport each (``LocalTransport``,
``DeviceTransport``, ``HttpTransport``, a ``ChaosTransport`` around any),
and the hub relays each microbatch's cut tensors from stage to stage.

Schedules (``SCHEDULES``): GPipe injects all M microbatches of a step at
once; 1F1B injects W = min(S, M), then one more for each drained
cotangent. Both run every microbatch of a step on the same parameters
and accumulate in microbatch order, so their losses are bit-equal; they
differ in how many microbatches are in flight. Each wire gets two worker
threads, one forward and one backward, fed by FIFO queues, so hops of a
(stage, direction) leave in microbatch order. The tick math is JAX's:
T = M + S - 1 ticks a step, an ideal bubble of (S - 1) / (M + S - 1),
which ``stage_report`` sets beside the measured one (1 - wire-busy /
wall).

Stage 0's weight gradient: the hub keeps each microbatch's autograd
graph from its forward (the step's parameters do not change until the
step's one update) and, once all M cotangents are back, pulls them
through in microbatch order and sums the parameter gradients, which is
the arithmetic of JAX's ``_bwd_acc`` (each microbatch's vjp at the
step's parameters, added in microbatch order); then one update (K2
under SGD). The last stage's loss hop scales its reply by 1/M, so the
sum is the gradient of the batch mean.

What crosses a wire: a transport of the port gets the cut tensor as it
is (on the card it stays a CUDA tensor, and a compressed wire packs it
there, K3 or K4s), as the two-party client hands its transport the
activations; a transport of another framework (JAX's, duck-typed) gets
host numpy, for every wire of the chain, as JAX's runner does. The
replies come back where the payload lived.

Faults: a ``TransportError`` (a drop, a 5xx, a lost reply) is retried up
to ``hop_retries`` times with backoff, and the stages' replay caches make
the retry exactly-once; a ``Backpressure`` waits its advised delay; a
``ProtocolError`` is permanent and propagates. A step that does not
drain within ``step_timeout_s`` raises ``TransportError``.

The adaptive density controller (``density_controller``, one
``transport.density.DensityController`` shared with the chain's
transports) gets the step's mean loss between steps, when no hop is in
flight. ``telemetry_registry`` (None unless the launcher binds a
``Registry`` for the telemetry ring) gets, as in JAX, each hop call's
time under ``wire``, each step's under ``step_total``, the
``hub_steps_total`` counter and the controller's densities; the
per-stage report carries each in-process stage's MFU from its
``trace_metadata`` (None off-trace, over HTTP and on the CPU).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.runtime.client import _input, _received
from split_learning_tpu_torch.runtime.party import ProtocolError
from split_learning_tpu_torch.runtime.state import (
    TrainState, check_config, init_params, make_state, make_tx)
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError)
from split_learning_tpu_torch.utils.arrays import to_host
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device

# bounded retry of one hop delivery: covers chaos's max_faults_per_key
# (2) with room for a real transient on top
DEFAULT_HOP_RETRIES = 4

# the hub's schedules: GPipe (all M in flight) or 1F1B (warmup, then
# one forward per drained cotangent)
SCHEDULES = ("gpipe", "1f1b")


def pipeline_ticks(microbatches: int, num_stages: int) -> int:
    """Clock length of a step, T = M + S - 1, for both schedules: the
    step's update is a barrier, and 1F1B's last cotangent still lands at
    tick M + S - 1."""
    return int(microbatches) + int(num_stages) - 1


def bubble_fraction(microbatches: int, num_stages: int) -> float:
    """Idle ticks over all ticks of the ideal schedule:
    (S - 1) / (M + S - 1), the same for GPipe and 1F1B."""
    s = int(num_stages)
    return (s - 1) / float(pipeline_ticks(microbatches, s))


def onefb_warmup(microbatches: int, num_stages: int) -> int:
    """1F1B's warmup depth W = min(S, M): enough forwards to fill every
    stage, never more than there are microbatches."""
    return min(int(num_stages), int(microbatches))


class _HopWorker(threading.Thread):
    """One direction of one wire: pops ``(step, mb, payload...)`` jobs in
    FIFO order and runs the hop (which pushes downstream). A failed job
    parks its exception on the runner, which unblocks the step."""

    def __init__(self, name: str, runner: "PipelineRunner", fn) -> None:
        super().__init__(name=name, daemon=True)
        self.q: "queue.Queue" = queue.Queue()
        self._runner = runner
        self._fn = fn
        self.busy_s = 0.0
        self.calls = 0
        self.durations: List[float] = []

    def run(self) -> None:
        try:
            if self._runner.device.type == "cuda":
                # every launch of this thread on the runner's card
                torch.cuda.set_device(self._runner.device)
        except BaseException as exc:  # noqa: BLE001 (parked, re-raised)
            self._runner._park_error(exc)
        while True:
            job = self.q.get()
            if job is None:
                return
            try:
                t0 = time.perf_counter()
                self._fn(*job)
                dt = time.perf_counter() - t0
                self.busy_s += dt
                self.calls += 1
                self.durations.append(dt)
                reg = self._runner.telemetry_registry
                if reg is not None:
                    reg.observe(spans.WIRE, dt)
            except BaseException as exc:  # noqa: BLE001 (parked, re-raised)
                self._runner._park_error(exc)


class PipelineRunner:
    """Drives stage 0 here and S-1 remote stages through their
    transports, M microbatches in flight a step.

    ``transports[i]`` reaches stage ``i + 1``. ``init`` is a
    ``torch.Generator`` or per-stage dicts for the whole plan
    (:func:`~split_learning_tpu_torch.runtime.state.init_params`); the
    hub keeps stage 0. ``sample_input`` keeps the JAX signature.
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: Any,
                 transports: Sequence[Any],
                 microbatches: int = 1,
                 client_id: int = 0,
                 hop_retries: int = DEFAULT_HOP_RETRIES,
                 step_timeout_s: float = 300.0,
                 schedule: str = "gpipe",
                 device: DeviceLike = "cuda") -> None:
        if plan.num_stages < 2:
            raise ValueError("a pipeline chain needs >= 2 stages")
        if len(transports) != plan.num_stages - 1:
            raise ValueError(
                f"need one transport per remote stage "
                f"({plan.num_stages - 1}; got {len(transports)})")
        self.microbatches = int(microbatches)
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1 (got {microbatches})")
        self.schedule = str(schedule)
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r} "
                f"(expected one of {SCHEDULES})")
        check_config(cfg)
        del sample_input  # a flax-style init needs no sample
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the hop workers pin this card by its index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.plan = plan
        self.cfg = cfg
        self.client_id = int(client_id)
        self.transports = list(transports)
        self.hop_retries = int(hop_retries)
        self.step_timeout_s = float(step_timeout_s)
        # every wire device-native: the trace metadata's flag; payloads
        # go as tensors to every transport of the port, as numpy to all
        # when one wire is another framework's
        self._device_native = all(
            getattr(t, "device_native", False) for t in self.transports)
        self._host_wire = not all(
            isinstance(t, Transport) for t in self.transports)
        self._stage0 = plan.stages[0]
        self._tx = make_tx(cfg)
        # dispatch watchdog: None unless SLT_DISPATCH_DEBUG / force()
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()
        self.state: TrainState = make_state(
            init_params(plan, init, self.device, (0,)), self._tx)

        self._err_lock = threading.Lock()
        self._errs: List[BaseException] = []
        self._losses: Dict[Tuple[int, int], float] = {}
        self._done_q: "queue.Queue" = queue.Queue()
        self._fwd_workers: List[_HopWorker] = []
        self._bwd_workers: List[_HopWorker] = []
        self._spawn_workers()
        self.steps_done = 0
        self._wall_s = 0.0
        # the adaptive density controller the launcher binds under
        # --compress-density auto; None otherwise
        self.density_controller = None
        # the telemetry ring's registry (the launcher binds one); None
        # costs nothing
        self.telemetry_registry = None

    @property
    def params(self) -> Params:
        """Stage 0's parameters (live tensors)."""
        return self.state.params[0]

    # ------------------------------------------------------------------ #
    def _park_error(self, exc: BaseException) -> None:
        with self._err_lock:
            self._errs.append(exc)
        self._done_q.put(("err", exc))   # unblock the step loop

    def _wire(self, fn, *args):
        """One hop, with bounded retry of transient faults (the stage's
        replay cache makes a redelivery exactly-once); a
        ``ProtocolError`` is permanent."""
        delay = 0.05
        for attempt in range(self.hop_retries + 1):
            try:
                return fn(*args)
            except Backpressure as bp:
                if attempt >= self.hop_retries:
                    raise
                time.sleep(bp.retry_after_s or delay)
            except ProtocolError:
                raise
            except TransportError:
                if attempt >= self.hop_retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    def _spawn_workers(self) -> None:
        W = len(self.transports)
        self._bwd_workers = [None] * max(W - 1, 0)

        def make_fwd(i: int):
            t = self.transports[i]
            if i == W - 1:
                def last_hop(step, mb, x, labels):
                    g, loss = self._wire(t.hop_loss, x, labels, step, mb,
                                         self.client_id)
                    # the host read, off the lock
                    with obs_dispatch.expected_d2h(self._dd):
                        loss_host = float(loss)
                    with self._err_lock:
                        self._losses[(step, mb)] = loss_host
                    if W == 1:
                        self._done_q.put((step, mb, g))
                    else:
                        self._bwd_workers[W - 2].q.put((step, mb, g))
                return last_hop

            def mid_hop(step, mb, x, labels):
                y = self._wire(t.hop_forward, x, step, mb, self.client_id)
                self._fwd_workers[i + 1].q.put((step, mb, y, labels))
            return mid_hop

        def make_bwd(i: int):
            t = self.transports[i]

            def bwd_hop(step, mb, g):
                g_in = self._wire(t.hop_backward, g, step, mb,
                                  self.client_id)
                if i == 0:
                    self._done_q.put((step, mb, g_in))
                else:
                    self._bwd_workers[i - 1].q.put((step, mb, g_in))
            return bwd_hop

        self._fwd_workers = [_HopWorker(f"pipe-fwd-{i + 1}", self,
                                        make_fwd(i)) for i in range(W)]
        for i in range(W - 1):
            self._bwd_workers[i] = _HopWorker(f"pipe-bwd-{i + 1}", self,
                                              make_bwd(i))
        for w in self._fwd_workers + self._bwd_workers:
            w.start()

    def _payload(self, t: torch.Tensor) -> Any:
        return to_host(t) if self._host_wire else t.detach()

    # ------------------------------------------------------------------ #
    def step(self, x: Any, y: Any, step: Optional[int] = None) -> float:
        """One training step: M microbatches through the chain, one
        stage-0 update. Returns the batch loss (the mean of the
        microbatches' mean losses: equal-size microbatches)."""
        M = self.microbatches
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if int(x.shape[0]) % M != 0:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by microbatches {M}")
        step_i = self.steps_done if step is None else int(step)
        with self._err_lock:
            if self._errs:
                raise self._errs[0]
        t_wall0 = time.perf_counter()
        mbsz = int(x.shape[0]) // M
        x_dev = _input(x, self.device)
        params = self.state.params[0]
        acts: Dict[int, torch.Tensor] = {}

        def inject(m: int) -> None:
            """Stage 0's forward of microbatch m (its graph kept for the
            backward), its payload onto wire 0. Every injection of a step
            sees the same parameters: the update follows the drain."""
            xm = x_dev[m * mbsz:(m + 1) * mbsz]
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "pipe_fwd0"),
                    sig_fn=lambda: obs_dispatch.signature(xm)), \
                    torch.enable_grad():
                a = self._stage0.apply(params, xm)
            acts[m] = a
            with obs_dispatch.expected_d2h(self._dd):
                payload = self._payload(a)
            self._fwd_workers[0].q.put(
                (step_i, m, payload, y[m * mbsz:(m + 1) * mbsz]))

        # GPipe streams all M forwards out up front; 1F1B stops at the
        # warmup depth and injects one forward per drained cotangent
        warm = M if self.schedule == "gpipe" else onefb_warmup(
            M, self.plan.num_stages)
        for m in range(warm):
            inject(m)
        next_m = warm
        cts: Dict[int, Any] = {}
        deadline = time.monotonic() + self.step_timeout_s
        while len(cts) < M:
            try:
                item = self._done_q.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TransportError(
                    f"pipeline stalled: step {step_i} got "
                    f"{len(cts)}/{M} cotangents within "
                    f"{self.step_timeout_s:.0f}s") from None
            if item[0] == "err":
                raise item[1]
            s, m, g = item
            if s != step_i:  # a stale item of an aborted step
                continue
            cts[m] = g
            if next_m < M:   # 1F1B's steady state
                inject(next_m)
                next_m += 1
        # accumulate in microbatch order (deterministic), update once
        leaves = list(params.values())
        acc: Optional[List[torch.Tensor]] = None
        for m in range(M):
            g = _received(cts[m], self.device).to(acts[m].dtype)
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "pipe_bwd0"),
                    sig_fn=lambda: obs_dispatch.signature(g)):
                gp = torch.autograd.grad(acts[m], leaves, g)
                acc = list(gp) if acc is None else [
                    a + b for a, b in zip(acc, gp)]
        # cuDNN may hand conv weight grads back channels-last; K2 walks
        # each leaf in its parameter's (contiguous) order
        with obs_dispatch.step_scope(self._dd, (self._ddtok, "pipe_apply0"),
                                     sig_fn=lambda: len(acc)):
            self._tx.update(self.state, [a.contiguous() for a in acc])
        with self._err_lock:
            losses = [self._losses.pop((step_i, m)) for m in range(M)]
        self.steps_done += 1
        step_wall = time.perf_counter() - t_wall0
        self._wall_s += step_wall
        reg = self.telemetry_registry
        if reg is not None:
            reg.observe(spans.STEP_TOTAL, step_wall)
            reg.incr("hub_steps_total")
        loss_mean = float(np.mean(losses))
        dc = self.density_controller
        if dc is not None:
            # rungs move here, between steps, when no hop reads a density
            dc.note_loss(loss_mean)
            if reg is not None:
                for wire, d in dc.densities().items():
                    reg.set_gauge(f"{spans.WIRE_DENSITY}_{wire}", d)
        return loss_mean

    def predict(self, x: Any) -> np.ndarray:
        """Forward only through the whole chain (each stage's predict
        behind its own flush barrier); the outputs as host numpy."""
        with torch.no_grad():
            out = self._payload(self._stage0.apply(
                self.state.params[0], _input(x, self.device)))
        for t in self.transports:
            out = t.predict(out, self.client_id)
        return to_host(out) if isinstance(out, torch.Tensor) else \
            np.asarray(out)

    # -- accounting ----------------------------------------------------- #
    def _warmup(self) -> int:
        return (self.microbatches if self.schedule == "gpipe"
                else onefb_warmup(self.microbatches, self.plan.num_stages))

    def stage_report(self) -> List[Dict[str, Any]]:
        """Per remote stage: JAX's measured bubble (1 - the wire's busy
        time over the hub's wall time, clipped at 0), the ideal one, the
        schedule and its warmup depth, the hop replies' median, the
        stage's deferred-apply depth (from its health), and a compressed
        wire's byte ratio and current density.

        The busy time is host time: each hop worker's calls, lock waits
        and host work included, and the wire's two workers run at once,
        so their sum can pass the wall time. ``busy_share_forward`` and
        ``busy_share_backward`` are each worker's busy time over the wall
        time, unclipped; the device's own idle time is not in this
        report."""
        theo = bubble_fraction(self.microbatches, self.plan.num_stages)
        out = []
        for i, t in enumerate(self.transports):
            fwd = self._fwd_workers[i]
            bwd = (self._bwd_workers[i]
                   if i < len(self._bwd_workers) else None)
            busy = fwd.busy_s + (bwd.busy_s if bwd is not None else 0.0)
            durs = sorted(fwd.durations
                          + (bwd.durations if bwd is not None else []))
            depth, mesh_info = None, None
            try:
                h = t.health()
                depth = h.get("counters", {}).get("deferred_apply_depth")
                mesh_info = h.get("mesh")
            except Exception:  # noqa: BLE001 (the report is best-effort)
                pass
            # the stage's MFU: the best of its traced programs'
            mfu_val = None
            srv = getattr(t, "server", None)
            if srv is not None and hasattr(srv, "trace_metadata"):
                mfus = [p["mfu"] for p in
                        srv.trace_metadata()["programs"].values()
                        if p.get("mfu") is not None]
                mfu_val = max(mfus) if mfus else None
            row = {
                "stage": i + 1,
                "schedule": self.schedule,
                "warmup_depth": self._warmup(),
                "bubble_fraction": (max(0.0, 1.0 - busy / self._wall_s)
                                    if self._wall_s > 0 else None),
                "busy_share_forward": (fwd.busy_s / self._wall_s
                                       if self._wall_s > 0 else None),
                "busy_share_backward": (
                    bwd.busy_s / self._wall_s
                    if bwd is not None and self._wall_s > 0 else None),
                "bubble_theoretical": theo,
                "bubble_theoretical_gpipe": theo,
                "bubble_theoretical_1f1b": theo,
                "reply_p50_ms": (durs[len(durs) // 2] if durs else 0.0)
                * 1e3,
                "hop_calls": fwd.calls + (bwd.calls if bwd else 0),
                "deferred_apply_depth": depth,
                # the stage's mesh; a meshless stage the one-device
                # layout, as mesh_axes(None)
                "mesh": mesh_info or {"devices": 1, "data": 1},
                "mfu": mfu_val,
            }
            summ = t.stats.summary()
            if summ.get("compress_wire_bytes"):
                row["compression_ratio"] = summ.get("compression_ratio")
                row["compress_raw_bytes"] = summ["compress_raw_bytes"]
                row["compress_wire_bytes"] = summ["compress_wire_bytes"]
            dc = self.density_controller
            wid = getattr(t, "wire_id", None) or getattr(
                getattr(t, "inner", None), "wire_id", None)
            if dc is not None and wid is not None:
                row["density"] = dc.densities().get(wid)
            out.append(row)
        return out

    def trace_metadata(self) -> Dict[str, Any]:
        """The chain's sidecar: schedule, ticks, the per-stage report and,
        under the adaptive controller, its whole trajectory."""
        meta = {
            "num_stages": self.plan.num_stages,
            "microbatches": self.microbatches,
            "schedule": self.schedule,
            "warmup_depth": self._warmup(),
            "device_native": self._device_native,
            "ticks_per_step": pipeline_ticks(self.microbatches,
                                             self.plan.num_stages),
            "steps": self.steps_done,
            "stages": self.stage_report(),
        }
        if self.density_controller is not None:
            meta["density"] = self.density_controller.snapshot()
        return meta

    def close(self) -> None:
        """Stop the hop workers (the transports stay the caller's)."""
        for w in self._fwd_workers + self._bwd_workers:
            w.q.put(None)
        for w in self._fwd_workers + self._bwd_workers:
            w.join(timeout=5)
