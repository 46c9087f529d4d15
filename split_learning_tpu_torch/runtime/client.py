"""Client-party trainers (counterpart of
``split_learning_tpu/runtime/client.py``): the classic split client
``SplitClientTrainer``, the U-shaped client ``USplitClientTrainer`` and
the federated client ``FederatedClientTrainer``.

The split loop of ``train_split_learning()``
(``src/client_part.py:103-141``): forward the bottom stage, ship the
activations through the transport, receive the cut-layer gradient,
backpropagate it into the bottom stage, and take one step of the
party's own optimizer (``runtime/state.py`` ``make_tx`` over its own
stage, clipping over its own leaves; an SGD step is K2 on the card).
Every model family runs here, the CNN and both transformer families, in
float32 or bfloat16: the cut tensor crosses in the plan's dtype, and the
gradient comes back in it. The JAX client recomputes the stage forward
in its backward (a jitted ``vjp``); here autograd keeps the forward's
graph until the gradient arrives, which gives the same gradients.

The trainer hands a transport of the port its activations as they are:
a CUDA tensor on the card, a CPU tensor on the CPU, so the port's
``LocalTransport`` encodes them where they live. A transport of another
framework (duck-typed, such as JAX's) gets a host numpy array, a
bfloat16 one as numpy's ``ml_dtypes`` bfloat16 (:mod:`utils.arrays`).
The gradient may come back as numpy or as a tensor.

Failure policy is explicit (SURVEY.md §3.4), as in JAX: ``"raise"``
(default), ``"retry"`` (bounded, with exponential backoff, or the peer's
advised delay after a ``Backpressure``) or ``"skip"`` (the reference's
behaviour, but counted in ``dropped_batches``). A ``ProtocolError`` is
permanent and is never retried or skipped. An optional
:class:`~split_learning_tpu_torch.runtime.breaker.CircuitBreaker` shapes
when an attempt goes out: while it is open, the client probes
``/health`` instead of sending the step again.

:class:`USplitClientTrainer` (BASELINE config 5) owns the bottom stage
A and the head C of a ``(client, server, client)`` plan, both from the
shared-seed init: A's activations go up on hop 1 (``u_forward``), the
trunk's features come back, the head computes the loss on the client
(K1 on the card; labels and logits never leave it) and updates C, the
features' gradient goes up on hop 2 (``u_backward``), and the gradient
of A's output comes back into A's update. Each of A and C has its own
optimizer state (an SGD update of each is one K2 launch).

:class:`FederatedClientTrainer` is the reference's
``train_federated_learning`` (``src/client_part.py:143-198``): local
full-model steps (K1 pair and one K2 launch a step on the card), then
once an epoch one ``transport.aggregate`` weighted by the epoch's
example count. Its parameters cross in JAX's layout
(:func:`~split_learning_tpu_torch.interop.params_to_jax` out,
:func:`~split_learning_tpu_torch.interop.params_from_jax` back), so a
port client and a JAX server average the same leaves; the optimizer
state stays local.

Each trainer's share of a checkpoint is :meth:`export_states` (its
states under JAX's layout keys, ``client`` or ``client_a``/``client_c``,
and a topk8 wire's up-direction EF ledger) and comes back through
:meth:`restore_states`; ``train(start_step=, on_epoch_end=)`` resumes
the step counter and saves at each epoch's end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.runtime.state import (
    TrainState, adopt_params, check_config, init_params, leaves_of,
    make_state, make_tx, restore_state, state_tree)
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError)
from split_learning_tpu_torch.utils.arrays import from_host, to_host
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    epoch: int


class FailurePolicy:
    RAISE = "raise"
    RETRY = "retry"
    SKIP = "skip"


def _input(x: Any, device: torch.device) -> torch.Tensor:
    """Floating inputs as float32, token ids as they are."""
    x = torch.as_tensor(x).to(device)
    return x.float() if x.is_floating_point() else x


def _labels(y: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(y).to(device, torch.int64)


def _on_wire(transport: Any, t: torch.Tensor) -> Any:
    """What goes on the wire: the tensor itself to a transport of the
    port (it encodes where the tensor lives), host numpy to another
    framework's."""
    return (t.detach() if isinstance(transport, Transport)
            else to_host(t))


def _received(x: Any, device: torch.device) -> torch.Tensor:
    """A wire reply (numpy or a tensor) on ``device``: float32 or
    bfloat16 keep their dtype, another float becomes float32."""
    t = x.detach() if isinstance(x, torch.Tensor) else from_host(x)
    dtype = (t.dtype if t.dtype in (torch.float32, torch.bfloat16)
             else torch.float32)
    return t.to(device, dtype)


LEDGER_KEY = "client_wire_ef"


def _export_ledger(transport: Any) -> Optional[list]:
    """The transport's up-direction topk8 ledger as checkpoint records
    (``{"key", "res"}`` with tensor residuals), or None when its wire
    keeps none."""
    ef = getattr(transport, "_ef", None)
    if ef is None:
        return None
    return [{"key": rec["key"], "res": torch.as_tensor(rec["res"])}
            for rec in ef.export_state()]


def _restore_ledger(transport: Any, records: Optional[list]) -> None:
    ef = getattr(transport, "_ef", None)
    if ef is not None and records is not None:
        ef.restore_state([{"key": rec["key"], "res": np.asarray(rec["res"])}
                          for rec in records])


def _restore(states: Dict[str, TrainState], tree: Dict[str, Any]) -> None:
    for key, live in states.items():
        if key not in tree:
            raise KeyError(f"checkpoint has no {key!r} state; present: "
                           f"{sorted(tree)}")
        restore_state(live, tree[key])


def _epoch_iter(stack: contextlib.ExitStack, data_iter: Callable,
                prefetch: int, device: torch.device) -> Iterable:
    it: Iterable = data_iter()
    if prefetch > 0:
        from split_learning_tpu_torch.data.datasets import DevicePrefetch
        it = stack.enter_context(DevicePrefetch(it, depth=prefetch,
                                                device=device))
    return it


class SplitClientTrainer:
    """The classic 2-party split client (bottom stage A).

    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan (see :func:`~split_learning_tpu_torch.runtime.state.init_params`);
    the client keeps stage 0. ``retry_backoff`` is the base of the
    exponential wait between retries (0.5 -> 0.5, 1, 2 s ...).
    ``breaker`` is an optional circuit breaker (``runtime/breaker.py``)
    in front of every attempt. ``profiler`` is an optional
    ``utils.profiling.PhaseProfiler``: each step's ``compute_fwd``,
    ``transport`` and ``compute_bwd`` phases, as JAX's (on the card the
    compute phases end in a synchronise while it is set). ``device``
    defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 transport: Transport,
                 failure_policy: str = FailurePolicy.RAISE,
                 max_retries: int = 3,
                 retry_backoff: float = 0.5,
                 logger: Optional[Any] = None,
                 profiler: Optional[Any] = None,
                 client_id: int = 0,
                 breaker: Optional[Any] = None,
                 device: DeviceLike = "cuda") -> None:
        if plan.stages_of("client") != (0,):
            raise ValueError(
                "SplitClientTrainer expects the client to own exactly "
                "stage 0 (the U-shaped client is USplitClientTrainer)")
        if failure_policy not in (FailurePolicy.RAISE, FailurePolicy.RETRY,
                                  FailurePolicy.SKIP):
            raise ValueError(f"unknown failure_policy {failure_policy!r}")
        check_config(cfg)
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = cfg
        self.transport = transport
        self.failure_policy = failure_policy
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.logger = logger
        self.client_id = client_id
        self.breaker = breaker
        self.profiler = profiler  # the compute-against-transport split
        self._phase = (profiler.phase if profiler is not None
                       else (lambda _name: contextlib.nullcontext()))
        self.dropped_batches = 0
        self.stage = plan.stages[0]
        self._tx = make_tx(cfg)
        self._init = init
        self.state: Optional[TrainState] = None
        # dispatch watchdog: None unless SLT_DISPATCH_DEBUG / force()
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()

    @property
    def wire_ef(self) -> Optional[Any]:
        """The transport's up-direction error-feedback ledger, when its
        wire mode keeps one (topk8 or clapping)."""
        return getattr(self.transport, "_ef", None)

    @property
    def params(self) -> Params:
        """The client stage's parameters (live tensors)."""
        self.ensure_init()
        return self.state.params[0]

    def ensure_init(self, sample_x: Any = None) -> None:
        """Draw (or adopt) the client stage's parameters once.
        ``sample_x`` keeps the JAX signature; the init needs no sample."""
        del sample_x
        if self.state is None:
            self.state = make_state(
                init_params(self.plan, self._init, self.device, (0,)),
                self._tx)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_step(self, x: Any, y: Any, step: int) -> Optional[float]:
        """One split step; returns the loss, or None if the batch was
        dropped under the ``"skip"`` policy.

        With the global tracer on, the step gets a trace id (handed to
        the server through ``CTX``) and the spans client_fwd, transport,
        client_bwd, opt_apply and step_total; the synchronisations at
        their edges exist only while tracing."""
        tr = obs_trace.get_tracer()
        prof = self.profiler
        phase = self._phase
        self.ensure_init()
        tid = tr.new_trace_id(self.client_id, step) if tr is not None \
            else None
        t_step0 = time.perf_counter() if tr is not None else 0.0
        params = self.state.params[0]
        with phase("compute_fwd"):
            xin = _input(x, self.device)
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "client_fwd"),
                    sig_fn=lambda: obs_dispatch.signature(xin)), \
                    torch.enable_grad():
                acts = self.stage.apply(params, xin)
            labels = torch.as_tensor(y)
            with obs_dispatch.expected_d2h(self._dd):
                sent = _on_wire(self.transport, acts)
            if prof is not None:
                self._sync()
        if tr is not None:
            self._sync()
            tr.record(spans.CLIENT_FWD, t_step0,
                      time.perf_counter() - t_step0, trace_id=tid,
                      tid=self.client_id, step=step)

        attempt = 0
        while True:
            try:
                if self.breaker is not None:
                    # while open this probes /health (backoff and jitter)
                    # instead of sending the step to a dead server; it
                    # raises TransportError when its budget is spent
                    self.breaker.before_attempt()
                if tid is not None:
                    obs_trace.CTX.trace_id = tid
                t_tr0 = time.perf_counter() if tr is not None else 0.0
                try:
                    with phase("transport"):
                        g_acts, loss = self.transport.split_step(
                            sent, labels, step, self.client_id)
                finally:
                    if tid is not None:
                        obs_trace.CTX.trace_id = None
                if self.breaker is not None:
                    self.breaker.record_success()
                if tr is not None:
                    tr.record(spans.TRANSPORT, t_tr0,
                              time.perf_counter() - t_tr0, trace_id=tid,
                              tid=self.client_id, step=step)
                break
            except Backpressure as exc:
                # explicit flow control from a healthy server: wait the
                # peer's advised delay, not a blind backoff, and never
                # count it toward the breaker's threshold
                attempt += 1
                if (self.failure_policy == FailurePolicy.RETRY
                        and attempt <= self.max_retries):
                    if self.breaker is not None:
                        self.breaker.backpressure_wait(exc.retry_after_s)
                    elif exc.retry_after_s > 0:
                        time.sleep(exc.retry_after_s)
                    continue
                if self.failure_policy == FailurePolicy.SKIP:
                    self.dropped_batches += 1
                    return None
                raise
            except TransportError:
                if self.breaker is not None:
                    self.breaker.record_failure()
                attempt += 1
                if (self.failure_policy == FailurePolicy.RETRY
                        and attempt <= self.max_retries):
                    # with an open breaker the wait is its health probes;
                    # the blind sleep is for blips below its threshold
                    if self.retry_backoff > 0 and not (
                            self.breaker is not None
                            and self.breaker.state == "open"):
                        time.sleep(self.retry_backoff * 2 ** (attempt - 1))
                    continue
                if self.failure_policy == FailurePolicy.SKIP:
                    # reference behaviour: drop the batch, keep going
                    # (src/client_part.py:127-129), but count it
                    self.dropped_batches += 1
                    return None
                raise

        with phase("compute_bwd"):
            t_b0 = time.perf_counter() if tr is not None else 0.0
            g = _received(g_acts, self.device).to(acts.dtype)
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "client_bwd"),
                    sig_fn=lambda: obs_dispatch.signature(g)):
                grads = torch.autograd.grad(acts, list(params.values()), g)
            if tr is not None:
                self._sync()
                t_o0 = time.perf_counter()
                tr.record(spans.CLIENT_BWD, t_b0, t_o0 - t_b0,
                          trace_id=tid, tid=self.client_id, step=step)
            # cuDNN may hand conv weight grads back channels-last; K2
            # walks each leaf in its parameter's (contiguous) order
            with obs_dispatch.step_scope(
                    self._dd, (self._ddtok, "client_apply"),
                    sig_fn=lambda: len(grads)):
                self._tx.update(self.state,
                                [gr.contiguous() for gr in grads])
            if prof is not None or tr is not None:
                self._sync()  # only where the timing matters
        if tr is not None:
            t_end = time.perf_counter()
            tr.record(spans.OPT_APPLY, t_o0, t_end - t_o0, trace_id=tid,
                      tid=self.client_id, step=step)
            tr.record(spans.STEP_TOTAL, t_step0, t_end - t_step0,
                      trace_id=tid, tid=self.client_id, step=step)
        return float(loss)

    def train(self, data_iter: Callable[[], Iterable[Tuple[Any, Any]]],
              epochs: Optional[int] = None, start_step: int = 0,
              on_epoch_end: Optional[Callable[[int, int], None]] = None,
              prefetch: int = 0) -> List[StepRecord]:
        """Full training run (``train_split_learning``, 3 epochs by
        default). ``start_step`` seeds the client-authoritative step
        counter (resume); ``on_epoch_end(epoch, next_step)`` fires after
        each epoch (the checkpoint hook). ``prefetch`` > 0 wraps each
        epoch's iterator in a
        :class:`~split_learning_tpu_torch.data.datasets.DevicePrefetch` of
        that depth, so batch k+1's copy to the device runs under step
        k's round trip; the batches are the same."""
        records: List[StepRecord] = []
        step = start_step
        for epoch in range(epochs if epochs is not None else self.cfg.epochs):
            with contextlib.ExitStack() as stack:
                for x, y in _epoch_iter(stack, data_iter, prefetch,
                                        self.device):
                    loss = self.train_step(x, y, step)
                    if loss is not None:
                        records.append(StepRecord(step=step, loss=loss,
                                                  epoch=epoch))
                        if self.logger is not None:
                            self.logger.log_metric("loss", loss, step=step)
                    step += 1
            if on_epoch_end is not None:
                on_epoch_end(epoch, step)
        return records

    def export_states(self) -> Dict[str, Any]:
        """The client's share of a checkpoint: ``{"client": state}`` (a
        :func:`~split_learning_tpu_torch.runtime.state.state_tree`) and,
        on a topk8 wire, the up-direction EF ledger, without which a
        resumed topk8 run is not the uninterrupted one."""
        self.ensure_init()
        tree: Dict[str, Any] = {"client": state_tree(self.state)}
        ledger = _export_ledger(self.transport)
        if ledger is not None:
            tree[LEDGER_KEY] = ledger
        return tree

    def restore_states(self, tree: Dict[str, Any]) -> None:
        """Adopt :meth:`export_states`'s tree (restored from disk): the
        state in place, the ledger when the checkpoint has one."""
        self.ensure_init()
        _restore({"client": self.state}, tree)
        _restore_ledger(self.transport, tree.get(LEDGER_KEY))



class USplitClientTrainer:
    """U-shaped client: owns the bottom stage A and the head C; labels
    and logits never leave it (BASELINE config 5). ``init`` is a
    ``torch.Generator`` or per-stage dicts for the whole plan; the client
    keeps stages 0 and 2 (the trunk's, drawn in passing, are dropped).
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 transport: Transport, logger: Optional[Any] = None,
                 client_id: int = 0, device: DeviceLike = "cuda") -> None:
        if plan.owners != ("client", "server", "client"):
            raise ValueError("USplitClientTrainer expects owners "
                             "(client, server, client)")
        check_config(cfg)
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = cfg
        self.transport = transport
        self.logger = logger
        self.client_id = client_id
        self._tx = make_tx(cfg)
        self._init = init
        self.state_a: Optional[TrainState] = None
        self.state_c: Optional[TrainState] = None
        self.stage_a, _, self.stage_c = plan.stages

    def ensure_init(self, sample_x: Any = None) -> None:
        """Draw (or adopt) stages A and C once. ``sample_x`` keeps the
        JAX signature."""
        del sample_x
        if self.state_a is None:
            params_a, params_c = init_params(self.plan, self._init,
                                             self.device, (0, 2))
            self.state_a = make_state((params_a,), self._tx)
            self.state_c = make_state((params_c,), self._tx)

    @property
    def params(self) -> Tuple[Params, Params]:
        """Stages A and C's parameters (live tensors)."""
        self.ensure_init()
        return self.state_a.params[0], self.state_c.params[0]

    def export_states(self) -> Dict[str, Any]:
        """``{"client_a": ..., "client_c": ...}`` (JAX's layout keys) and,
        on a topk8 wire, the client's EF ledger of both hops."""
        self.ensure_init()
        tree: Dict[str, Any] = {"client_a": state_tree(self.state_a),
                                "client_c": state_tree(self.state_c)}
        ledger = _export_ledger(self.transport)
        if ledger is not None:
            tree[LEDGER_KEY] = ledger
        return tree

    def restore_states(self, tree: Dict[str, Any]) -> None:
        self.ensure_init()
        _restore({"client_a": self.state_a, "client_c": self.state_c}, tree)
        _restore_ledger(self.transport, tree.get(LEDGER_KEY))

    def train_step(self, x: Any, y: Any, step: int) -> float:
        self.ensure_init()
        params_a = self.state_a.params[0]
        params_c = self.state_c.params[0]
        with torch.enable_grad():
            acts = self.stage_a.apply(params_a, _input(x, self.device))
        # hop 1: activations -> trunk features
        feats = _received(self.transport.u_forward(
            _on_wire(self.transport, acts), step, self.client_id),
            self.device)
        feats.requires_grad_(True)
        # the head: loss and gradients here, labels stay on the client
        leaves_c = list(params_c.values())
        with torch.enable_grad():
            loss = fused_cross_entropy(self.stage_c.apply(params_c, feats),
                                       _labels(y, self.device))
            *g_c, g_feats = torch.autograd.grad(loss, leaves_c + [feats])
        self._tx.update(self.state_c, [g.contiguous() for g in g_c])
        # hop 2: feature gradient -> activation gradient (the server
        # updates the trunk on the way)
        g_acts = _received(self.transport.u_backward(
            _on_wire(self.transport, g_feats), step, self.client_id),
            self.device)
        grads = torch.autograd.grad(acts, list(params_a.values()),
                                    g_acts.to(acts.dtype))
        # cuDNN may hand conv weight grads back channels-last
        self._tx.update(self.state_a, [g.contiguous() for g in grads])
        return float(loss.detach())

    def train(self, data_iter: Callable[[], Iterable[Tuple[Any, Any]]],
              epochs: Optional[int] = None, start_step: int = 0,
              on_epoch_end: Optional[Callable[[int, int], None]] = None
              ) -> List[StepRecord]:
        records: List[StepRecord] = []
        step = start_step
        for epoch in range(epochs if epochs is not None else self.cfg.epochs):
            for x, y in data_iter():
                loss = self.train_step(x, y, step)
                records.append(StepRecord(step=step, loss=loss, epoch=epoch))
                if self.logger is not None:
                    self.logger.log_metric("loss", loss, step=step)
                step += 1
            if on_epoch_end is not None:
                on_epoch_end(epoch, step)
        return records


class FederatedClientTrainer:
    """Federated client (``src/client_part.py:143-198``): local
    full-model epochs, a weight sync through the transport after each.
    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan. ``device`` defaults to ``"cuda"`` and raises without a GPU.

    ``losses`` keeps every step's loss; :meth:`train` records one
    ``StepRecord`` an epoch (its mean loss), as JAX's does."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 transport: Transport, logger: Optional[Any] = None,
                 device: DeviceLike = "cuda") -> None:
        check_config(cfg)
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = cfg
        self.transport = transport
        self.logger = logger
        self._tx = make_tx(cfg)
        self._init = init
        self.state: Optional[TrainState] = None
        self.losses: List[float] = []

    def ensure_init(self, sample_x: Any = None) -> None:
        del sample_x
        if self.state is None:
            self.state = make_state(
                init_params(self.plan, self._init, self.device), self._tx)

    @property
    def params(self) -> Tuple[Params, ...]:
        """Every stage's parameters (live tensors)."""
        self.ensure_init()
        return self.state.params

    def export_states(self) -> Dict[str, Any]:
        """``{"client": state}``: the whole model and its optimizer."""
        self.ensure_init()
        return {"client": state_tree(self.state)}

    def restore_states(self, tree: Dict[str, Any]) -> None:
        self.ensure_init()
        _restore({"client": self.state}, tree)

    def train_step(self, x: Any, y: Any) -> float:
        """One local step of the whole model; returns the loss."""
        self.ensure_init()
        leaves = leaves_of(self.state.params)
        with torch.enable_grad():
            loss = fused_cross_entropy(
                self.plan.apply(self.state.params, _input(x, self.device)),
                _labels(y, self.device))
            grads = torch.autograd.grad(loss, leaves)
        self._tx.update(self.state, [g.contiguous() for g in grads])
        value = float(loss.detach())
        self.losses.append(value)
        return value

    def sync(self, epoch: int, loss: float, step: int,
             num_examples: Optional[int]) -> None:
        """One FedAvg round: the parameters up in JAX's layout, the mean
        adopted in its own dtypes (the optimizer state stays)."""
        self.ensure_init()
        agg = self.transport.aggregate(params_to_jax(self.state.params),
                                       epoch, loss, step,
                                       num_examples=num_examples)
        adopt_params(self.state, params_from_jax(agg), self.device)

    def train(self, data_iter: Callable[[], Iterable[Tuple[Any, Any]]],
              epochs: Optional[int] = None, start_step: int = 0,
              on_epoch_end: Optional[Callable[[int, int], None]] = None
              ) -> List[StepRecord]:
        records: List[StepRecord] = []
        step = start_step
        for epoch in range(epochs if epochs is not None else self.cfg.epochs):
            epoch_losses: List[float] = []
            n_examples = 0
            for x, y in data_iter():
                epoch_losses.append(self.train_step(x, y))
                n_examples += len(y)
                step += 1
            avg_loss = (float(np.mean(epoch_losses)) if epoch_losses
                        else float("nan"))
            # per-epoch sync (src/client_part.py:171-194), weighted by
            # this client's example count (canonical FedAvg)
            self.sync(epoch, avg_loss, step, n_examples or None)
            records.append(StepRecord(step=step, loss=avg_loss, epoch=epoch))
            if self.logger is not None:
                self.logger.log_metric("loss", avg_loss, step=step)
                self.logger.log_metric("epoch", epoch, step=step)
            if on_epoch_end is not None:
                on_epoch_end(epoch, step)
        return records
