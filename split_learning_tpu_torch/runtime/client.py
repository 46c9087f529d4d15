"""Client-party trainer of the classic split (counterpart of
``split_learning_tpu/runtime/client.py`` ``SplitClientTrainer``).

The split loop of ``train_split_learning()``
(``src/client_part.py:103-141``): forward the bottom stage, ship the
activations through the transport, receive the cut-layer gradient,
backpropagate it into the bottom stage, and take one SGD step (K2 on the
card). The JAX client recomputes the stage forward in its backward
(a jitted ``vjp``); here autograd keeps the forward's graph until the
gradient arrives, which gives the same gradients.

The trainer hands the transport its activations as they are: a CUDA
tensor on the card, a CPU tensor on the CPU, so the port's
``LocalTransport`` encodes them where they live, and a JAX transport
(which calls ``np.asarray``) still takes the CPU ones. The gradient may
come back as numpy or as a tensor.

Failure policy is explicit (SURVEY.md §3.4), as in JAX: ``"raise"``
(default), ``"retry"`` (bounded, with exponential backoff, or the peer's
advised delay after a ``Backpressure``) or ``"skip"`` (the reference's
behaviour, but counted in ``dropped_batches``). A ``ProtocolError`` is
permanent and is never retried or skipped. An optional
:class:`~split_learning_tpu_torch.runtime.breaker.CircuitBreaker` shapes
when an attempt goes out: while it is open, the client probes
``/health`` instead of sending the step again.

The U-shaped and federated clients wait for ROADMAP item 11.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (
    Any, Callable, Iterable, List, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.runtime.state import (
    TrainState, check_config, init_params, make_state, make_tx)
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError)
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


class SplitClientTrainer:
    """The classic 2-party split client (bottom stage A).

    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan (see :func:`~split_learning_tpu_torch.runtime.state.init_params`);
    the client keeps stage 0. ``retry_backoff`` is the base of the
    exponential wait between retries (0.5 -> 0.5, 1, 2 s ...).
    ``breaker`` is an optional circuit breaker (``runtime/breaker.py``)
    in front of every attempt. ``device`` defaults to ``"cuda"`` and
    raises without a GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 transport: Transport,
                 failure_policy: str = FailurePolicy.RAISE,
                 max_retries: int = 3,
                 retry_backoff: float = 0.5,
                 logger: Optional[Any] = None,
                 client_id: int = 0,
                 breaker: Optional[Any] = None,
                 device: DeviceLike = "cuda") -> None:
        if plan.stages_of("client") != (0,):
            raise ValueError(
                "SplitClientTrainer expects the client to own exactly "
                "stage 0 (the U-shaped client is ROADMAP item 11)")
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
        self.dropped_batches = 0
        self.stage = plan.stages[0]
        self._tx = make_tx(cfg)
        self._init = init
        self.state: Optional[TrainState] = None

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

    def _to_device(self, x: Any) -> torch.Tensor:
        """Floating inputs as float32, token ids as they are."""
        x = torch.as_tensor(x).to(self.device)
        return x.float() if x.is_floating_point() else x

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
        self.ensure_init()
        tid = tr.new_trace_id(self.client_id, step) if tr is not None \
            else None
        t_step0 = time.perf_counter() if tr is not None else 0.0
        params = self.state.params[0]
        with torch.enable_grad():
            acts = self.stage.apply(params, self._to_device(x))
        labels = torch.as_tensor(y)
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
                    g_acts, loss = self.transport.split_step(
                        acts.detach(), labels, step, self.client_id)
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

        t_b0 = time.perf_counter() if tr is not None else 0.0
        if not isinstance(g_acts, torch.Tensor):  # a numpy reply: copy it
            g_acts = torch.tensor(np.asarray(g_acts))
        g = g_acts.to(self.device, torch.float32)
        grads = torch.autograd.grad(acts, list(params.values()), g)
        if tr is not None:
            self._sync()
            t_o0 = time.perf_counter()
            tr.record(spans.CLIENT_BWD, t_b0, t_o0 - t_b0, trace_id=tid,
                      tid=self.client_id, step=step)
        # cuDNN may hand conv weight grads back channels-last; K2 walks
        # each leaf in its parameter's (contiguous) order
        self._tx.update(self.state, [gr.contiguous() for gr in grads])
        if tr is not None:
            self._sync()
            t_end = time.perf_counter()
            tr.record(spans.OPT_APPLY, t_o0, t_end - t_o0, trace_id=tid,
                      tid=self.client_id, step=step)
            tr.record(spans.STEP_TOTAL, t_step0, t_end - t_step0,
                      trace_id=tid, tid=self.client_id, step=step)
        return float(loss)

    def train(self, data_iter: Callable[[], Iterable[Tuple[Any, Any]]],
              epochs: Optional[int] = None, start_step: int = 0,
              on_epoch_end: Optional[Callable[[int, int], None]] = None
              ) -> List[StepRecord]:
        """Full training run (``train_split_learning``, 3 epochs by
        default). ``start_step`` seeds the client-authoritative step
        counter; ``on_epoch_end(epoch, next_step)`` fires after each
        epoch."""
        records: List[StepRecord] = []
        step = start_step
        for epoch in range(epochs if epochs is not None else self.cfg.epochs):
            for x, y in data_iter():
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

