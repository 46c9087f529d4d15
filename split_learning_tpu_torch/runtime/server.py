"""Server-party runtime (counterpart of
``split_learning_tpu/runtime/server.py`` ``ServerRuntime``): the top
half of the split step, the U-shaped trunk's two hops, and FedAvg.

- ``split_step`` is the reference's ``/forward_pass`` handler
  (``src/server_part.py:25-58``): take the cut activations and labels,
  run the server stage forward, the cross-entropy, the backward and one
  update of the party's own optimizer (``runtime/state.py`` ``make_tx``
  over its own stage, clipping over its own leaves), and return the
  cut-layer gradient with the loss. On the card the loss is K1
  (``ops/cross_entropy.py``) and an SGD update K2 (``ops/sgd.py``).
- ``u_forward`` and ``u_backward`` (mode ``"u_split"``, BASELINE config
  5): the server owns the middle stage, the trunk; labels and logits
  stay with the client. Hop 1 runs the trunk forward and keeps its
  input as the residual of ``(client_id, step)``; hop 2 recomputes the
  trunk forward with autograd, as JAX's ``jax.vjp`` does, pulls the
  client's feature gradient through it, updates the trunk and returns
  the input's gradient. A residual pins its input only, never a graph:
  at most ``MAX_PENDING_RESIDUALS`` per client (FIFO) and
  ``MAX_TOTAL_RESIDUALS`` in all. The recompute doubles the trunk's
  forward launches (K5 on the U-shaped LM: 2 x ``server_depth`` a step).
- ``aggregate`` (mode ``"federated"``, ``/aggregate_weights``,
  ``src/server_part.py:60-93``): the server keeps the whole composition,
  and :class:`FedAvgAggregator` averages rounds of ``cfg.num_clients``
  submissions (weighted by example counts when every client sends one)
  on the server's device. The wire carries JAX's tree (a tuple of flax
  trees, HWIO and ``[in, out]`` kernels, :mod:`interop`); the server
  averages in that layout, adopts the mean into its own state in the
  port's layout, and replies with the mean copied to the host once.
- ``health`` (``src/server_part.py:95-102``).

Beyond the reference, as in JAX: a per-client step handshake (a step at
or below the last one is a ``ProtocolError``, 409; an op of another mode
is one with status 400) and the replay cache, which serves a duplicate
of an applied step its original reply instead of applying it twice (a
duplicate hop 1 keeps its residual).

The reply lives where the request lived: numpy activations get a numpy
gradient back (JAX's contract, which a JAX client needs; a bfloat16 one
as numpy's ``ml_dtypes`` bfloat16, :mod:`utils.arrays`), a tensor gets a
tensor on its own device. The in-process wire decodes on the server's
device, so on the card the down-wire encodes from a CUDA tensor. The
FedAvg reply is always host numpy.

The lock covers the handshake and the launch of the step; the reply is
materialised (the loss read, a host copy for a numpy caller) after it
is released, as JAX's ``overlap`` default does (``overlap=False``, the
``--no-overlap`` escape hatch, reads it inside the lock). ``aggregate``
waits for its round outside the lock: waiting under it would deadlock
concurrent clients. The parameters are updated in place, and a later
step's kernels queue behind this one's on the same stream, so nothing
reads them early.

The server under many clients (BASELINE config 3), split mode only, as
in JAX:

- **Request coalescing** (``coalesce_max > 1``; ``batching`` ``"window"``
  or ``"continuous"``, :mod:`runtime.coalesce`): concurrent split steps
  of one shape wait in a queue, and a flusher thread runs each group as
  one step (:meth:`ServerRuntime._dispatch_group`) over the concatenated
  rows: one K1 forward, one K1 backward and one update (K2 under SGD) a
  group, where G serialized clients cost G of each. The port compiles
  nothing, so a group is not padded: the mean of K1 over the group's
  real rows is JAX's group objective (its weights are 1/total on real
  rows, 0 on padding), each client gets its rows of the cut gradient
  times ``total / rows`` and the mean of its own rows' losses
  (:func:`~split_learning_tpu_torch.ops.cross_entropy.cross_entropy_rows`).
  ``compile_count`` still counts JAX's pow2 signatures, so /health reads
  as JAX's does for the same arrivals. The flusher only launches; the
  group's one host read (the row losses) is made by the first waiter
  (:class:`_GroupD2H`). A failure in the flusher reaches each waiting
  client as its error. Classifier plans only: JAX's group step cannot
  run the causal LM (its per-token losses ``[B, T]`` meet weights
  ``[B]``), so an LM plan with ``coalesce_max > 1`` is refused.
- **Admission** (``tenants``, ``quota``, ``slo_ms``;
  :mod:`runtime.admission`): an over-quota step raises ``Backpressure``
  (429 with ``Retry-After`` over HTTP) before it touches the state, and
  an admitted one carries its EDF deadline into the continuous batcher.
- **The decoupled backward** (2BP; ``decouple_bwd``, ``apply_lag``): the
  reply is the gradient of the activations only (the forward, K1's pair,
  no weight gradient), and the step's update is queued
  (:class:`~split_learning_tpu_torch.runtime.party._DeferredApply`) and
  drained after the reply, at most ``apply_lag`` entries behind. The
  deferred apply differentiates the loss with respect to the parameters
  its reply used, then updates the live state. The updates are in
  place, so the parameters a queued entry used are kept copy-on-write:
  an apply about to mutate tensors that a queued entry still references
  first gives those entries a clone. At lag 0 the apply drains in the
  reply's lock window and nothing is cloned. A 2BP step on the split
  CNN under SGD launches K1's forward and backward twice and K2 once.

Checkpoints (``runtime/party.py``): ``on_step(acked)`` runs under the
lock after each op that updates the state, as in JAX; ``resume_from``
re-arms the handshake so the next accepted op is at the restored step
or later, and drops the U-shaped residuals and a partial FedAvg round.

Observability, as in JAX: with the flight recorder on, each step
journals its dispatch and reply (``FL_DISPATCH``, ``FL_REPLY``; a
coalesced group one ``FL_DISPATCH``) and each deferred apply
``FL_DEFER_APPLY``; with tracing on, each program's model FLOPs and
window feed :meth:`~PartyRuntime.trace_metadata` (``split_step``,
``reply_grad``, ``coalesced_step``, ``group_reply``).

The mesh (``mesh=``, :class:`~split_learning_tpu_torch.runtime.party.
PartyRuntime`), as JAX's sharded server: the server stage's state is laid
out by the party's ``SpecLayout`` (a
:class:`~split_learning_tpu_torch.runtime.state.ShardedState`), and
every server program runs on it unchanged: the stage's ops scatter the
batch over the ``data`` rows and each row's work over its ``model``
ranks (``parallel/tensor.py``), and gather the logits to the first
rank, where the loss (K1) runs once a step on the whole batch; the
update sums each leaf's gradient over the rows and updates every row
and rank (K2 ``data x model`` launches under SGD). A serialized batch
must tile ``data`` (400 otherwise); a coalesced group pads to a multiple
of ``data`` with rows the loss leaves out (JAX's zero weights);
``predict`` pads and trims; host replies leave through the party's
``_host_gather``. A mesh of one device is ``mesh=None``, bit for bit.
"""

from __future__ import annotations

import sys
import time
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from split_learning_tpu_torch import __version__
from split_learning_tpu_torch.core.stage import (
    Params, SplitPlan, remat_plan)
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import locks as obs_locks
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.models.transformer import LMHeadStage
from split_learning_tpu_torch.ops.cross_entropy import (
    cross_entropy_rows, fused_cross_entropy)
from split_learning_tpu_torch.runtime.coalesce import (
    CoalesceRequest, RequestCoalescer, pow2_bucket)
from split_learning_tpu_torch.runtime.party import (
    PartyRuntime, ProtocolError, _DeferredApply, mesh_axes, rows_of)
from split_learning_tpu_torch.runtime.state import (
    adopt_params, check_config, fedavg_mean, init_params, leaves_of,
    make_state, make_tx)
from split_learning_tpu_torch.utils.arrays import host_tree, tree_map
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike


def _is_lm(stage: Any) -> bool:
    """Whether a stage ends in the causal LM's per-token head."""
    return any(isinstance(m, LMHeadStage) for m in stage.module.modules())


def _shape_key(a: Any) -> str:
    """A leaf's shape as a string (a tuple would read as a subtree)."""
    return "x".join(str(int(d)) for d in np.shape(a))


class ServerRuntime(PartyRuntime):
    """Holds the server-owned state and serves the ops of its mode:
    ``split_step`` and ``predict`` (``"split"``), ``u_forward``,
    ``u_backward`` and ``predict`` (``"u_split"``), ``aggregate``
    (``"federated"``). Thread-safe: all state transitions happen under
    one lock.

    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan (see :func:`~split_learning_tpu_torch.runtime.state.init_params`);
    the server keeps its own stage, or in federated mode the whole
    composition. ``sample_input`` keeps the JAX signature. ``device``
    defaults to ``"cuda"`` and raises without a GPU.

    The knobs of the server under many clients take JAX's names and
    checks: ``coalesce_max`` (> 1 turns coalescing on; split mode,
    classifier plans), ``coalesce_window_ms``, ``batching`` (``"window"``
    or ``"continuous"``, which needs ``coalesce_max >= 2``), ``tenants``,
    ``quota``, ``slo_ms``, ``decouple_bwd`` (split mode), ``apply_lag``
    (>= 0, > 0 only with ``decouple_bwd``) and ``overlap``.

    ``d2h_delay_s`` (JAX's synthetic transfer-cost knob, default 0: no
    cost) adds a pause before every host read of a reply;
    ``d2h_single_channel`` queues those pauses FIFO on one simulated
    host DMA channel (``ServerRuntime._d2h_chan``), so N reads cost N
    windows of wall clock, instead of letting them overlap."""

    # bounds on residuals awaiting their hop-2 u_backward: per client
    # (FIFO: one client's backlog never evicts another's live residual)
    # and in all (orphans of clients that died between hops are
    # reclaimed by other clients' traffic)
    MAX_PENDING_RESIDUALS = 8
    MAX_TOTAL_RESIDUALS = 64

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: Any = None, strict_steps: bool = True,
                 coalesce_max: int = 1,
                 coalesce_window_ms: float = 2.0,
                 replay_window: int = 8,
                 overlap: bool = True,
                 batching: str = "window",
                 tenants: int = 1,
                 quota: Optional[Any] = None,
                 slo_ms: Optional[Any] = None,
                 decouple_bwd: bool = False,
                 apply_lag: int = 0,
                 mesh: Optional[Any] = None,
                 ef_mode: str = "topk8",
                 d2h_delay_s: float = 0.0,
                 d2h_single_channel: bool = False,
                 device: DeviceLike = "cuda") -> None:
        super().__init__(cfg, party="server",
                         lock_name="ServerRuntime._lock", mesh=mesh,
                         replay_window=replay_window, tenants=tenants,
                         quota=quota, slo_ms=slo_ms, ef_mode=ef_mode)
        check_config(cfg)
        del sample_input  # a flax-style init needs no sample
        self.device = self._place(device)
        self.plan = plan
        self.mode = cfg.mode
        self.strict_steps = strict_steps
        self.overlap = bool(overlap)
        self._d2h_delay_s = float(d2h_delay_s)
        # single-channel contention model: reservations are booked under
        # this leaf lock (it never wraps another acquire); the wait itself
        # runs unlocked
        self._d2h_single = bool(d2h_single_channel)
        self._d2h_chan_lock = obs_locks.make_lock(
            "ServerRuntime._d2h_chan", reentrant=False)
        self._d2h_chan_free_at = 0.0
        if coalesce_max > 1 and cfg.mode != "split":
            raise ValueError(
                f"coalesce_max={coalesce_max} is split-mode only (the "
                "batched group step computes the loss server-side); mode "
                f"is {cfg.mode!r}")
        if batching not in ("window", "continuous"):
            raise ValueError(
                f"batching must be 'window' or 'continuous' "
                f"(got {batching!r})")
        if batching == "continuous" and coalesce_max < 2:
            raise ValueError(
                "continuous batching runs inside the coalescer: raise "
                f"coalesce_max to >= 2 (got {coalesce_max})")
        self.batching = batching
        self.decouple_bwd = bool(decouple_bwd)
        self.apply_lag = int(apply_lag)
        # the FLOP count of a traced program reads the plan as written;
        # under remat the served stage recomputes its forward in the
        # backward (core/stage.py remat_plan)
        self._flops_plan = plan
        if cfg.remat:
            plan = remat_plan(plan)
            self.plan = plan
        if self.apply_lag < 0:
            raise ValueError(f"apply_lag must be >= 0 (got {apply_lag})")
        if self.apply_lag > 0 and not self.decouple_bwd:
            raise ValueError(
                f"apply_lag={apply_lag} needs decouple_bwd=True (the "
                "deferred-apply queue only exists on a decoupled server)")
        if self.decouple_bwd and cfg.mode != "split":
            raise ValueError(
                "decouple_bwd is split-mode only (the reply/apply split "
                "decouples the classic split step, where the server "
                f"computes the loss); mode is {cfg.mode!r}")
        # per-client step handshake: the last acknowledged step, and the
        # floor below which no client's step is accepted
        self._last_step: Dict[int, int] = {}
        self._step_floor = -1
        self._tx = make_tx(cfg)
        self._agg: Optional[FedAvgAggregator] = None
        if cfg.mode == "federated":
            # the federated server keeps the full model
            # (ref src/model_def.py:56-57)
            self.server_stage = None
            self._stage = None
            fed_params = init_params(plan, init, self.device)
            self.state = make_state(fed_params, self._tx)
            self._agg = FedAvgAggregator(cfg.num_clients)
            # the shapes of JAX's tree of this composition: a submission
            # of another layout is refused before it joins a round
            self._fed_shapes = tree_map(_shape_key,
                                        params_to_jax(fed_params))
        else:
            server_idx = plan.stages_of("server")
            if len(server_idx) != 1 or (
                    cfg.mode == "split"
                    and server_idx[0] != plan.num_stages - 1):
                raise ValueError(
                    "the server owns exactly one stage, in split mode the "
                    f"last (mode {cfg.mode!r}, plan owners {plan.owners})")
            self.server_stage = server_idx[0]
            self._stage = plan.stages[self.server_stage]
            self.state = self._new_state(plan, init, (self.server_stage,))
            if coalesce_max > 1 and _is_lm(self._stage):
                raise ValueError(
                    "request coalescing takes classifier plans only: the "
                    "reference's group step multiplies per-token losses "
                    "[B, T] by per-example weights [B], which fails to "
                    "broadcast or, where it broadcasts, scales the "
                    "gradient by T; serve the causal LM with "
                    "coalesce_max=1 (2BP and the pipelined client run it)")
        self._coalescer: Optional[RequestCoalescer] = None
        if self.decouple_bwd:
            self._deferred = _DeferredApply(self._apply_deferred_entry,
                                            self.apply_lag, self._lock)
        if coalesce_max > 1:
            # the distinct pow2 group signatures JAX would compile: the
            # compile_count counter /health reports
            self._coalesce_shapes: set = set()
            self._coalescer = RequestCoalescer(
                self._dispatch_group, coalesce_max,
                coalesce_window_ms / 1e3, mode=batching)
        # the U-shaped step's residuals: the trunk input of (client, step)
        self._u_residual: Dict[Tuple[int, int], torch.Tensor] = {}
        # called under the lock with the acknowledged step after every
        # step op that updates the state (JAX's checkpoint hook)
        self.on_step: Optional[Callable[[int], None]] = None

    @property
    def params(self) -> Any:
        """The server stage's parameters (live tensors; on a mesh the
        ``ShardedParam`` view); in federated mode the whole composition,
        one dict per stage. Read under the lock: on a decoupled server
        this is the live state the queued updates land on."""
        with self._lock:
            if self.mode == "federated":
                return self.state.params
            return self.state.params[0]

    def _mode_guard(self, op: str, mode: str) -> None:
        """An op of another mode is a request this server cannot take
        (400, ref ``src/server_part.py:31-36``)."""
        if self.mode != mode:
            raise ProtocolError(f"{op} called in mode {self.mode!r}",
                                status=400)

    # ------------------------------------------------------------------ #
    def _check_step(self, step: int, client_id: int = 0) -> None:
        last = max(self._last_step.get(client_id, -1), self._step_floor)
        if self.strict_steps and step <= last:
            raise ProtocolError(
                f"non-monotonic step {step} from client {client_id} "
                f"(last seen {last}); client restarted or replayed: "
                "refusing to desync")

    def _step(self, params: Params, acts: torch.Tensor,
              labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, loss, backward and the update, in place, at
        ``params`` (the live stage, read by the caller under the lock);
        returns the cut gradient and the loss, on the device,
        unsynchronised."""
        leaves = leaves_of((params,))
        acts = acts.requires_grad_(True)
        with torch.enable_grad():
            loss = fused_cross_entropy(self._stage.apply(params, acts),
                                       labels)
            *g_params, g_acts = torch.autograd.grad(loss, leaves + [acts])
        # cuDNN may hand conv weight grads back channels-last; K2 walks
        # each leaf in its parameter's (contiguous) order
        self._tx.update(self.state, [g.contiguous() for g in g_params])
        return g_acts, loss.detach()

    def _exactly_once(self, client_id: int, op: str, step: int,
                      run: Callable[[], Any]) -> Any:
        """``run()`` once per ``(client_id, op, step)``: a duplicate
        delivery (lost response, retried request) blocks on the first
        one's replay entry and is served its one reply. A failed ``run``
        releases the claim, so a retry can re-own the step, and hands the
        error to anyone blocked on it."""
        if self.replay is None:
            return run()
        entry, owner = self.replay.begin(client_id, op, step)
        if not owner:
            return self.replay.wait(entry)
        try:
            res = run()
        except BaseException as exc:
            self.replay.fail(entry, exc)
            raise
        self.replay.resolve(entry, res)
        return res

    def split_step(self, activations: Any, labels: Any, step: int,
                   client_id: int = 0) -> Tuple[Any, float]:
        self._mode_guard("split_step", "split")
        tr = obs_trace.get_tracer()
        times: List[float] = []

        def run() -> Tuple[Any, float]:
            admitted = False
            try:
                deadline = None
                if self._admission is not None:
                    # the quota gate: a Backpressure here releases the
                    # replay claim (_exactly_once), so the advised retry
                    # re-owns the step
                    deadline = self._admission.admit(client_id)
                    admitted = True
                if self._coalescer is not None:
                    return self._coalesced(activations, labels, step,
                                           client_id, deadline, tr)
                return self._serialized(activations, labels, step,
                                        client_id, tr, times)
            finally:
                if admitted:
                    self._admission.complete(client_id)

        res = self._exactly_once(client_id, "split_step", step, run)
        if tr is not None and times:   # not for a duplicate's replay
            self._record_server_spans(tr, *times, step, client_id)
            if self._deferred is not None:
                # the client-visible reply window: the reply's launch to
                # the reply in hand
                rw = times[3] - times[1]
                tr.record(spans.REPLY_GRAD, times[1], rw,
                          trace_id=obs_trace.CTX.trace_id, party="server",
                          tid=client_id, step=step)
                self._metrics.observe(spans.REPLY_GRAD, rw)
        return res

    def _serialized(self, activations: Any, labels: Any, step: int,
                    client_id: int, tr: Any, times: List[float]
                    ) -> Tuple[Any, float]:
        """One client's step under the lock: coupled (:meth:`_step`), or
        on a decoupled server the reply (:meth:`_reply`) with its update
        queued and the over-lag tail drained behind it."""
        t_q0 = time.perf_counter() if tr is not None else 0.0
        with self._lock:
            t_d0 = time.perf_counter() if tr is not None else 0.0
            win = self._window_open() if tr is not None else None
            self._check_step(step, client_id)
            self._check_batch_rows(rows_of(activations), rows_of(labels))
            acts = self._to_dev(activations)
            labels_dev = self._to_dev(labels, torch.int64)
            fwd_params = self.state.params[0]
            read = None
            if self._deferred is not None:
                with obs_dispatch.step_scope(
                        self._dd, (self._ddtok, "reply_grad"),
                        sig_fn=lambda: obs_dispatch.signature(
                            acts, labels_dev)):
                    g_acts, loss = self._reply(fwd_params, acts,
                                               labels_dev)
                if win is not None:
                    # the reply's window: the queued update is not in it
                    win = self._window_close(win)
                # the reply's host read is queued before the update's
                # launches, so reading it never waits for them
                host = not isinstance(activations, torch.Tensor)
                read = _HostRead(loss, *((g_acts,) if host else ()))
                # a replayed duplicate never gets here (the replay claim),
                # so it never queues a second apply
                self._deferred.push({
                    "kind": "single", "step": step, "client_id": client_id,
                    "fwd_params": fwd_params, "acts": acts,
                    "labels": labels_dev})
                self._deferred.drain_over_lag()
            else:
                with obs_dispatch.step_scope(
                        self._dd, (self._ddtok, "split_step"),
                        sig_fn=lambda: obs_dispatch.signature(
                            acts, labels_dev)):
                    g_acts, loss = self._step(fwd_params, acts,
                                              labels_dev)
                if win is not None:
                    win = self._window_close(win)
            if not self.overlap:
                # --no-overlap: the host copy and the loss read inside
                # the lock
                self._sleep_d2h()
                with obs_dispatch.expected_d2h(self._dd):
                    res = self._reply_of(g_acts, loss, read, activations)
            # max(): with strict_steps off steps may arrive out of
            # order; the acknowledged step never regresses
            self._last_step[client_id] = max(
                self._last_step.get(client_id, -1), step)
            if self.on_step is not None:
                self.on_step(self._last_step[client_id])
            t_d1 = time.perf_counter() if tr is not None else 0.0
        program = "reply_grad" if self._deferred is not None \
            else "split_step"
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_DISPATCH, step=step, client_id=client_id,
                      party="server", program=program)
        if tr is not None:
            # shapes only: step_flops runs the program on meta copies
            self._note_flops(program, self._program_fn(program),
                             (fwd_params, acts, labels_dev), win)
        if self.overlap:
            # off the lock: the loss read waits for the step's kernels
            self._sleep_d2h()
            with obs_dispatch.expected_d2h(self._dd):
                res = self._reply_of(g_acts, loss, read, activations)
        times[:] = [t_q0, t_d0, t_d1,
                    time.perf_counter() if tr is not None else 0.0]
        if fl is not None:
            fl.record(spans.FL_REPLY, step=step, client_id=client_id,
                      party="server", op="split_step", coalesced=False)
        return res

    def _program_fn(self, program: str) -> Callable[..., Any]:
        """The pure form of a server program, for its FLOP count
        (:func:`~split_learning_tpu_torch.utils.flops.step_flops`): the
        forward, the loss and the gradients the program takes, from
        ``(params, acts, labels)``; nothing is updated."""
        rows = program in ("coalesced_step", "group_reply")
        wrt_params = program in ("split_step", "coalesced_step")

        def fn(params, acts, labels):
            acts = acts.detach().requires_grad_(True)
            params = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            logits = self._flops_plan.stages[self.server_stage].apply(
                params, acts)
            loss = (cross_entropy_rows(logits, labels)[0] if rows
                    else fused_cross_entropy(logits, labels))
            wrt = (list(params.values()) if wrt_params else []) + [acts]
            return torch.autograd.grad(loss, wrt)
        return fn

    def _reply_of(self, g_acts: torch.Tensor, loss: torch.Tensor,
                  read: Optional["_HostRead"], request: Any
                  ) -> Tuple[Any, float]:
        """The wire reply: the gradient in the request's kind and the loss
        as a float, from ``read`` where the 2BP reply queued one."""
        if read is None:
            return self._reply_value(g_acts, request), float(loss)
        host = read.get()
        g = host[1] if len(host) > 1 else g_acts
        return self._reply_value(g, request), float(host[0])

    def _reply(self, params: Params, acts: torch.Tensor,
               labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 2BP reply: forward, loss and the gradient of the
        activations only, at ``params`` (the live parameters, read by
        the caller under the lock); the weight gradient is left to the
        deferred apply."""
        acts = acts.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = fused_cross_entropy(
                self._stage.apply(params, acts), labels)
            (g_acts,) = torch.autograd.grad(loss, [acts])
        return g_acts, loss.detach()

    def _protect_queued(self) -> None:
        """Copy-on-write for the queued entries: an entry that still
        references the live parameters gets a clone of them before an
        update mutates them in place, so its apply differentiates at the
        parameters its reply used. One clone serves every such entry
        (they all saw the same weights). Under the (reentrant) lock, as
        every update it guards."""
        with self._lock:
            live = self.state.params[0]
            snap = None
            for entry in self._deferred.pending():
                if entry["fwd_params"] is live:
                    if snap is None:
                        with torch.no_grad():
                            snap = {k: v.detach().clone().requires_grad_(
                                True) for k, v in live.items()}
                    entry["fwd_params"] = snap

    def _apply_deferred_entry(self, entry: Dict[str, Any]) -> None:
        """One queued update (``_DeferredApply``'s drain, under the lock):
        the gradient of the entry's loss (one client's mean, or a group's
        mean over its rows: the same K1 mean) with respect to the
        parameters its reply used, then the optimizer's update of the
        live state. Launches only."""
        tr = obs_trace.get_tracer()
        t0 = time.perf_counter() if tr is not None else 0.0
        params = entry["fwd_params"]
        with torch.enable_grad():
            labels = entry["labels"]
            # a padded group's extra rows stay out of the loss
            loss = fused_cross_entropy(
                self._stage.apply(params, entry["acts"].detach())[
                    :labels.shape[0]], labels)
            g_params = torch.autograd.grad(loss, leaves_of((params,)))
        self._protect_queued()
        self._tx.update(self.state, [g.contiguous() for g in g_params])
        if tr is not None:
            dw = time.perf_counter() - t0
            tr.record(spans.DEFERRED_APPLY, t0, dw,
                      trace_id=obs_trace.CTX.trace_id, party="server",
                      tid=entry["client_id"], step=entry["step"])
            self._metrics.observe(spans.DEFERRED_APPLY, dw)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_DEFER_APPLY, step=entry["step"],
                      client_id=entry["client_id"], party="server",
                      kind=entry["kind"])

    # -- request coalescing ---------------------------------------------- #
    def _coalesced(self, activations: Any, labels: Any, step: int,
                   client_id: int, deadline: Optional[float], tr: Any
                   ) -> Tuple[Any, float]:
        """Queue one step for its group and wait for the group's reply.
        The batch moves to the device on the caller's thread, so the
        flusher only launches; the handshake runs at the group's
        dispatch, so a refused step fails its own client only."""
        self._check_batch_rows(rows_of(activations), rows_of(labels),
                               tile=False)
        acts = self._to_dev(activations)
        labels_dev = self._to_dev(labels, torch.int64)
        if labels_dev.dim() != 1:
            raise ProtocolError(
                "a coalescing server takes classifier labels [batch] "
                f"(got {tuple(labels_dev.shape)})", status=400)
        traced = tr is not None
        g, loss = self._coalescer.submit(
            acts, labels_dev, step, client_id,
            trace_id=obs_trace.CTX.trace_id if traced else None,
            t_enqueue=time.perf_counter() if traced else None,
            deadline=deadline)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_REPLY, step=step, client_id=client_id,
                      party="server", op="split_step", coalesced=True)
        return self._reply_value(g, activations), loss

    def _dispatch_group(self, group: List[CoalesceRequest],
                        reason: str) -> None:
        """The flusher's callback: one step for a same-shape group, on
        the flusher thread. One update on the group-mean loss; each
        client gets the gradient of its own rows' mean (the group's
        gradient times ``total / rows``) and the mean of its rows'
        losses, so a group of one is the serialized step. On a decoupled
        server the group's replies come first and its one update is
        queued behind them."""
        tr = obs_trace.get_tracer()
        t_pick = time.perf_counter() if tr is not None else 0.0
        with self._lock:
            t_lk0 = time.perf_counter() if tr is not None else 0.0
            admitted: List[CoalesceRequest] = []
            # a retry in the same window as its original (replay off):
            # the leader computes, followers share its reply
            leaders: Dict[Tuple[int, int], CoalesceRequest] = {}
            followers: Dict[Tuple[int, int], list] = {}
            for r in group:
                key = (r.client_id, r.step)
                if key in leaders:
                    followers.setdefault(key, []).append(r)
                    continue
                try:
                    self._check_step(r.step, r.client_id)
                    leaders[key] = r
                    admitted.append(r)
                except ProtocolError as exc:
                    r.error = exc
                    r.done.set()
            if not admitted:
                return
            sizes = [int(r.acts.shape[0]) for r in admitted]
            total = sum(sizes)
            head = admitted[0]
            # on a mesh the group pads to tile the data axis, as JAX's
            # pads its pow2 bucket; the padding rows stay out of the loss
            padded = pow2_bucket(total)
            if self._mesh_data > 1:
                padded = -(-max(padded, self._mesh_data)
                           // self._mesh_data) * self._mesh_data
            sig = ((padded,) + tuple(head.acts.shape[1:]),
                   str(head.acts.dtype), str(head.labels.dtype))
            if sig not in self._coalesce_shapes:
                self._coalesce_shapes.add(sig)
                self._coalescer.stats.incr("compile_count")
            t_d0 = time.perf_counter() if tr is not None else 0.0
            win = self._window_open() if tr is not None else None
            acts = torch.cat([r.acts.detach() for r in admitted])
            labels = torch.cat([r.labels for r in admitted])
            params = self.state.params[0]
            pad = padded - total if self._mesh_data > 1 else 0
            if pad:
                acts = torch.cat([acts, acts.new_zeros(
                    (pad,) + tuple(acts.shape[1:]))])
            acts.requires_grad_(True)
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "coalesced_step"),
                    sig_fn=lambda: sig):
                with torch.enable_grad():
                    logits = self._stage.apply(params, acts)
                    loss, rows = cross_entropy_rows(
                        logits[:total] if pad else logits, labels)
                    if self._deferred is not None:
                        (g_acts,) = torch.autograd.grad(loss, [acts])
                    else:
                        *g_params, g_acts = torch.autograd.grad(
                            loss, leaves_of((params,)) + [acts])
                if self._deferred is None:
                    self._tx.update(self.state,
                                    [g.contiguous() for g in g_params])
            if win is not None:
                win = self._window_close(win)
            pg = _GroupD2H(g_acts, rows, total, self._dd, self._sleep_d2h)
            if not self.overlap:
                pg.materialize()  # --no-overlap: the host read here
            dw = time.perf_counter() - t_d0 if tr is not None else 0.0
            program = ("group_reply" if self._deferred is not None
                       else "coalesced_step")
            fl = obs_flight.get_recorder()
            if fl is not None:
                # one event for the whole group; split_step journals
                # each member's reply
                fl.record(spans.FL_DISPATCH,
                          step=max(r.step for r in admitted),
                          party="server", program=program,
                          size=len(admitted), rows=total, reason=reason)
            off = 0
            for r, b in zip(admitted, sizes):
                thunk = pg.segment(off, b)
                r.result = thunk if self.overlap else thunk()
                off += b
                for f in followers.get((r.client_id, r.step), ()):
                    f.result = r.result
                    f.done.set()
                self._last_step[r.client_id] = max(
                    self._last_step.get(r.client_id, -1), r.step)
                if self.on_step is not None:
                    self.on_step(self._last_step[r.client_id])
                if tr is not None and r.t_enqueue is not None:
                    # each request's queue wait (the window included);
                    # the dispatch is one event shared by the group
                    qw = max(t_pick - r.t_enqueue, 0.0)
                    r.server_spans = {spans.QUEUE_WAIT: qw,
                                      spans.DISPATCH: dw}
                    for name, t0, secs in ((spans.QUEUE_WAIT,
                                            r.t_enqueue, qw),
                                           (spans.DISPATCH, t_d0, dw)):
                        tr.record(name, t0, secs, trace_id=r.trace_id,
                                  party="server", tid=r.client_id,
                                  step=r.step)
                        self._metrics.observe(name, secs)
                    self._metrics.incr("split_steps_total")
                r.done.set()
            if self._deferred is not None:
                # every member holds its reply; only now does the group's
                # update join the queue, and only the over-lag tail runs
                self._deferred.push({
                    "kind": "group", "step": max(r.step for r in admitted),
                    "client_id": -1, "fwd_params": params,
                    "acts": acts.detach(), "labels": labels})
                self._deferred.drain_over_lag()
            if tr is not None:
                self._metrics.observe(spans.LOCK_HOLD,
                                      time.perf_counter() - t_lk0)
        if tr is not None:
            # slt-lint: disable=SLT006 (shapes only: step_flops runs the program on meta copies, never these values)
            self._note_flops(program, self._program_fn(program),
                             (params, acts.detach(), labels), win)

    def _record_server_spans(self, tr, t_q0: float, t_d0: float,
                             t_d1: float, t_end: float, step: int,
                             client_id: int) -> None:
        """One step's server spans, into the tracer and the metrics, and
        published to ``CTX.server_spans`` for the transport."""
        qw, dw, hw = t_d0 - t_q0, t_d1 - t_d0, t_end - t_d1
        trace_id = obs_trace.CTX.trace_id
        for name, t0, secs in ((spans.QUEUE_WAIT, t_q0, qw),
                               (spans.DISPATCH, t_d0, dw),
                               (spans.D2H, t_d1, hw)):
            tr.record(name, t0, secs, trace_id=trace_id, party="server",
                      tid=client_id, step=step)
            self._metrics.observe(name, secs)
        self._metrics.observe(spans.LOCK_HOLD, dw)
        self._metrics.incr("split_steps_total")
        obs_trace.CTX.server_spans = {spans.QUEUE_WAIT: qw,
                                      spans.DISPATCH: dw, spans.D2H: hw}

    def predict(self, activations: Any, client_id: int = 0) -> Any:
        """Forward-only through the server stage: the logits. No step
        handshake; inference never desyncs training."""
        del client_id
        if self._stage is None:
            raise ProtocolError(f"predict called in mode {self.mode!r}",
                                status=400)
        with self._lock, torch.no_grad():
            if self._deferred is not None:
                # inference sees every update whose reply has left
                self._deferred.flush()
            x = self._to_dev(activations)
            n = int(x.shape[0])
            pad = (-n) % self._mesh_data
            if pad:
                # forward only, so padding is exact: rows to tile the
                # data axis, and only the real ones come back
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            # launched under the lock: a concurrent step's in-place
            # update queues behind this forward
            out = self._stage.apply(self.state.params[0], x)
        return self._reply_value(out, activations, rows=n if pad else None)

    # -- the U-shaped split -------------------------------------------- #
    def _keep_residual(self, client_id: int, step: int,
                       acts: torch.Tensor) -> None:
        """Store hop 1's input and evict: this client's oldest beyond
        MAX_PENDING_RESIDUALS, then the oldest of all beyond
        MAX_TOTAL_RESIDUALS (dicts keep insertion order)."""
        self._u_residual[(client_id, step)] = acts
        mine = [k for k in self._u_residual if k[0] == client_id]
        for key in mine[:max(len(mine) - self.MAX_PENDING_RESIDUALS, 0)]:
            del self._u_residual[key]
        overflow = len(self._u_residual) - self.MAX_TOTAL_RESIDUALS
        for key in list(self._u_residual)[:max(overflow, 0)]:
            del self._u_residual[key]

    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        """Hop 1: the trunk's forward on the client's activations; the
        input stays behind as the residual of ``(client_id, step)``. A
        duplicate is served the original features and keeps the residual
        (hop 2 may still be coming)."""
        self._mode_guard("u_forward", "u_split")

        def run() -> Any:
            with self._lock:
                self._check_step(step, client_id)
                rows = rows_of(activations)
                self._check_batch_rows(rows, rows)
                acts = self._to_dev(activations)
                with torch.no_grad():
                    feats = self._stage.apply(self.state.params[0], acts)
                self._keep_residual(client_id, step, acts)
            self._sleep_d2h()
            return self._reply_value(feats, activations)

        return self._exactly_once(client_id, "u_forward", step, run)

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        """Hop 2: the trunk's forward again under autograd on the stored
        input, the client's feature gradient pulled through it, one
        update of the trunk; returns the input's gradient. A duplicate is
        served the original reply (its residual was consumed: without the
        cache it would be the unknown step a lost response turns into)."""
        self._mode_guard("u_backward", "u_split")

        def run() -> Any:
            with self._lock:
                acts = self._u_residual.pop((client_id, step), None)
                if acts is None:
                    raise ProtocolError(
                        f"u_backward for unknown step {step} "
                        f"(client {client_id})")
                params = self.state.params[0]
                x_in = acts.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self._stage.apply(params, x_in)
                    *g_params, g_acts = torch.autograd.grad(
                        y, leaves_of((params,)) + [x_in],
                        self._to_dev(feat_grads, acts.dtype))
                # cuDNN may hand conv weight grads back channels-last
                self._tx.update(self.state,
                                [g.contiguous() for g in g_params])
                self._last_step[client_id] = max(
                    self._last_step.get(client_id, -1), step)
                if self.on_step is not None:
                    self.on_step(self._last_step[client_id])
            self._sleep_d2h()
            return self._reply_value(g_acts, feat_grads)

        return self._exactly_once(client_id, "u_backward", step, run)

    # -- federated ------------------------------------------------------- #
    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        """``/aggregate_weights``: join this round of FedAvg with
        ``params`` (JAX's tree; numpy or tensor leaves) and return the
        round's mean as host numpy, in that layout. ``num_examples``
        weights the submission. The server adopts the mean."""
        del epoch, loss
        self._mode_guard("aggregate", "federated")
        if num_examples is not None and num_examples <= 0:
            raise ProtocolError(
                f"num_examples must be positive (got {num_examples})",
                status=400)
        self._check_layout(params)
        tree = tree_map(self._to_dev, params)
        # submit() blocks until the round is full: outside the runtime
        # lock, or concurrent clients deadlock
        mean = self._agg.submit(
            tree, weight=(float(num_examples) if num_examples is not None
                          else None))
        with self._lock:
            adopt_params(self.state, params_from_jax(mean), self.device)
            self.state.step += 1
            self._last_step[0] = max(self._last_step.get(0, -1), step)
            if self.on_step is not None:
                self.on_step(step)
        return host_tree(mean)

    def _check_layout(self, params: Any) -> None:
        """A submission must be JAX's tree of this composition (the tuple
        of flax trees, HWIO and ``[in, out]`` kernels): the server adopts
        the mean into its own layout, and another tree would poison the
        round for every client (400)."""
        def leaf(a: Any, want: str) -> None:
            if _shape_key(a) != want:
                raise ValueError(f"leaf of shape {_shape_key(a)}, "
                                 f"want {want}")
        try:
            tree_map(leaf, params, self._fed_shapes)
        except (ValueError, TypeError, AttributeError) as exc:
            raise ProtocolError(
                "aggregate: params are not JAX's tree of this model "
                f"({exc})", status=400) from exc

    # -- PartyRuntime hooks ---------------------------------------------- #
    def _reset_protocol_state(self, step: int) -> None:
        self._last_step = {}
        self._step_floor = step - 1  # applies to every client_id
        self._u_residual.clear()

    def _post_resume_hook(self) -> None:
        if self._agg is not None:
            # drop pre-restore submissions: averaging stale params into
            # the first post-restore round would corrupt it
            self._agg = FedAvgAggregator(self._agg.num_clients)

    def _close_hook(self) -> None:
        # flush and join the coalescer before the base drains the
        # deferred queue: its last groups queue applies of their own
        if self._coalescer is not None:
            self._coalescer.close()

    # ------------------------------------------------------------------ #
    def health(self) -> Dict[str, Any]:
        """GET /health (``src/server_part.py:95-102``), plus ``step``: the
        highest client step this server has acknowledged."""
        model_type = ("FullModel" if self.mode == "federated"
                      else self._stage.name)
        with self._lock:
            step = max(max(self._last_step.values(), default=-1),
                       self._step_floor)
        info = {"status": "healthy", "mode": self.mode,
                "model_type": model_type, "step": step,
                "strict_steps": self.strict_steps,
                "version": __version__,
                "uptime_seconds": time.monotonic() - self._t_start}
        if self._coalescer is not None:
            info["coalescing"] = {
                "coalesce_max": self._coalescer.max_group,
                "coalesce_window_ms": self._coalescer.window_s * 1e3,
                "batching": self._coalescer.mode,
                **self._coalescer.counters()}
        if self._admission is not None:
            info["admission"] = {
                **self._admission.config(),
                **self._admission.counters(),
                **self._admission.gauges()}
        if self._deferred is not None:
            info["decoupled_bwd"] = {
                "apply_lag": self.apply_lag,
                **self._deferred.counters()}
        if self._mesh is not None:
            info["mesh"] = mesh_axes(self._mesh)
        return info

    def metrics(self) -> Dict[str, Any]:
        """The histogram/counter/gauge snapshot, with the acknowledged
        step, the coalescer's counters (``coalesce_*``), the admission
        and deferred-apply counters and the replay counters folded in."""
        snap = self._metrics.snapshot()
        h = self.health()
        snap["gauges"]["acked_step"] = float(h["step"])
        for k, v in h.get("coalescing", {}).items():
            if isinstance(v, (int, float)):
                snap["counters"][f"coalesce_{k}"] = float(v)
        self._fold_shared_metrics(snap)
        return snap


class _HostRead:
    """A host read queued on the stream where a reply's kernels end: a
    copy to pinned memory and an event behind it. :meth:`get` waits for
    that event only, so the read never waits for what is launched on the
    stream after it (a deferred apply, the next group). CPU tensors are
    read as they are."""

    __slots__ = ("_host", "_event")

    def __init__(self, *tensors: torch.Tensor) -> None:
        self._event = None
        if tensors and tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True).copy_(
                                          t, non_blocking=True)
                          for t in tensors]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach() for t in tensors]

    def get(self) -> List[torch.Tensor]:
        if self._event is not None:
            self._event.synchronize()
        return self._host


class _GroupD2H:
    """The host read of one coalesced group, made once, by the first
    waiter that redeems its thunk (JAX's ``_GroupD2H``): the flusher
    launches the group (and queues the copy of its row losses right
    behind it, :class:`_HostRead`) and moves on to the next group while
    this group's waiters share the copy. Each member's gradient segment
    stays where the group's gradient is (on the card for a card request)
    and is rescaled to its own rows' mean there."""

    __slots__ = ("_g", "_read", "_total", "_lock", "rows", "_dd",
                 "_sleep_d2h")

    def __init__(self, g_acts: torch.Tensor, rows: torch.Tensor,
                 total: int, dd: Any = None,
                 sleep_d2h: Optional[Callable[[], None]] = None) -> None:
        self._g = g_acts
        self._read: Optional[_HostRead] = _HostRead(rows)
        self._total = total
        self._lock = obs_locks.make_lock("_GroupD2H._lock", reentrant=False)
        self.rows: Optional[np.ndarray] = None
        self._dd = dd  # the dispatch watchdog, None when off
        self._sleep_d2h = sleep_d2h  # the runtime's synthetic D2H cost

    def materialize(self) -> None:
        with self._lock:
            if self.rows is None:
                if self._sleep_d2h is not None:
                    self._sleep_d2h()
                with obs_dispatch.expected_d2h(self._dd):
                    self.rows = self._read.get()[0].numpy()
                self._read = None

    def segment(self, off: int, b: int) -> Callable[[], Tuple[Any, float]]:
        """The thunk of the member at rows ``[off, off + b)``: its
        gradient times ``total / b`` and its rows' mean loss, as JAX's
        host arithmetic computes it (a float32 mean in numpy)."""
        def seg() -> Tuple[Any, float]:
            self.materialize()
            g = self._g[off:off + b] * (self._total / b)
            return g, float(self.rows[off:off + b].mean())
        return seg


class FedAvgAggregator:
    """FedAvg over rounds of ``num_clients`` submissions (JAX's).

    The reference aggregates by overwriting with the single client's
    weights (``src/server_part.py:81-83``); the mean of one submission is
    that overwrite. A round's mean is computed once, by the submitter
    that completes it, on the submissions' device (a ``torch.stack``
    mean, or a weighted sum), and kept under its round id until all
    ``num_clients`` members have read it: a slow waiter still reads its
    own round's mean, never a later one."""

    def __init__(self, num_clients: int) -> None:
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        self.num_clients = num_clients
        self._pending: list = []
        self._results: Dict[int, list] = {}  # round -> [mean, reads_left]
        self._round = 0
        self._cond = obs_locks.make_condition("FedAvgAggregator._cond")

    def _read_result(self, round_id: int) -> Any:
        slot = self._results[round_id]
        slot[1] -= 1
        if slot[1] <= 0:
            del self._results[round_id]
        return slot[0]

    def submit(self, params: Any, timeout: float = 120.0,
               weight: Optional[float] = None) -> Any:
        """Block until the round is full, then return the mean tree of
        the round this submission joined. ``weight`` is this client's
        FedAvg weight (None = uniform). A round is weighted only when
        every submission carries a weight; a mixed round falls back to
        uniform with a warning. A submission that times out is withdrawn
        and raises ``TimeoutError``."""
        if weight is not None and not weight > 0:
            # refused before touching shared state: a bad weight fails its
            # own client, never the round
            raise ValueError(f"FedAvg weight must be > 0 (got {weight})")
        entry = (object(), params, weight)  # token: a retry after a
        with self._cond:                     # timeout is not counted twice
            round_id = self._round
            self._pending.append(entry)
            if len(self._pending) >= self.num_clients:
                ws = [w for _, _, w in self._pending]
                if any(w is None for w in ws):
                    if any(w is not None for w in ws):
                        print("[fedavg] mixed weighted/unweighted round "
                              "(some clients omitted num_examples); "
                              "falling back to uniform averaging",
                              file=sys.stderr)
                    ws = None
                self._results[round_id] = [
                    fedavg_mean([p for _, p, _ in self._pending],
                                weights=ws),
                    self.num_clients]
                self._pending = []
                self._round += 1
                self._cond.notify_all()
            elif not self._cond.wait_for(lambda: self._round != round_id,
                                         timeout=timeout):
                self._pending = [e for e in self._pending
                                 if e[0] is not entry[0]]
                raise TimeoutError(
                    f"FedAvg round incomplete: {len(self._pending)}/"
                    f"{self.num_clients} clients reported")
            return self._read_result(round_id)
