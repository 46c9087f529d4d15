"""Pipelined split client: W batches in flight over the transport
(counterpart of ``split_learning_tpu/runtime/pipelined_client.py``).

The reference's loop is lock-step, one batch in flight and the client
idle for the whole round trip (``src/client_part.py:110-133``). Here a
window of W cut-layer exchanges stays in flight, so the client's work
and the wire overlap.

Semantics, as in JAX:

- **Bounded staleness.** The forward of step k runs at the parameters
  that have absorbed the gradients of steps <= k - W. W=1 is
  :class:`~split_learning_tpu_torch.runtime.client.SplitClientTrainer`.
- **Consistent gradients.** Each in-flight step keeps the parameters
  its forward used; its backward recomputes the forward at those
  parameters (:func:`~split_learning_tpu_torch.core.stage.
  stage_backward`), and the delayed update applies to the current
  state. The port's updates are in place (K2 under SGD), so the
  parameters are kept copy-on-write: an update about to mutate tensors
  that an in-flight step still references first gives that step a
  clone. At W=1 nothing is cloned.
- **Ordered application.** Replies are applied in step order, whatever
  order they complete in.
- **Server side.** Requests may arrive out of order, so the server runs
  with ``strict_steps=False`` when W > 1.

Failure policy is RAISE: a fault in the window raises from
:meth:`train`; :meth:`close` joins the lanes. Lane k sends through
transport k: the one given for lane 0, ``transport_factory()`` for the
others when it is given, else the same transport (the port's
``HttpTransport`` keeps one connection per calling thread).
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from split_learning_tpu_torch.core.stage import Params, stage_backward
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.runtime.client import (
    LEDGER_KEY, StepRecord, _epoch_iter, _export_ledger, _input, _on_wire,
    _received, _restore, _restore_ledger)
from split_learning_tpu_torch.runtime.state import (
    TrainState, check_config, init_params, make_state, make_tx, state_tree)
from split_learning_tpu_torch.transport.base import (
    Transport, TransportStats)
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


class PipelinedSplitClientTrainer:
    """Split client with a depth-W in-flight window over the transport.
    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan; the client keeps stage 0. ``device`` defaults to ``"cuda"``
    and raises without a GPU."""

    def __init__(self, plan: Any, cfg: Config, init: Any,
                 transport: Transport, depth: int = 2,
                 transport_factory: Optional[Callable[[], Transport]] = None,
                 logger: Optional[Any] = None, client_id: int = 0,
                 device: DeviceLike = "cuda") -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if plan.stages_of("client") != (0,):
            raise ValueError("PipelinedSplitClientTrainer expects the "
                             "client to own exactly stage 0")
        check_config(cfg)
        self.device = resolve_device(device)
        self.plan = plan
        self.cfg = cfg
        self.depth = depth
        self.logger = logger
        self.client_id = client_id
        self.stage = plan.stages[0]
        self._tx = make_tx(cfg)
        self._init = init
        self.state: Optional[TrainState] = None
        self._transports: List[Transport] = [transport]
        for _ in range(depth - 1):
            self._transports.append(
                transport_factory() if transport_factory else transport)
        self._pool = ThreadPoolExecutor(max_workers=depth,
                                        thread_name_prefix="slt-lane")
        # the in-flight steps: [params its forward used, input, future,
        # step, the cut's dtype], oldest first
        self._window: List[list] = []

    @property
    def transport(self) -> Transport:
        """Lane 0's transport."""
        return self._transports[0]

    @property
    def params(self) -> Params:
        self.ensure_init()
        return self.state.params[0]

    def ensure_init(self, sample_x: Any = None) -> None:
        """Draw (or adopt) the client stage's parameters once (the
        shared-seed convention of ``SplitClientTrainer``)."""
        del sample_x
        if self.state is None:
            self.state = make_state(
                init_params(self.plan, self._init, self.device, (0,)),
                self._tx)

    # ------------------------------------------------------------------ #
    def _submit(self, lane: int, acts: torch.Tensor, y: Any,
                step: int) -> Future:
        transport = self._transports[lane]
        sent = _on_wire(transport, acts)
        # a copy: the lane sends it up to depth - 1 batches later, and a
        # loader may recycle its buffer
        labels = torch.as_tensor(y).clone()
        tr = obs_trace.get_tracer()
        if tr is None:
            return self._pool.submit(transport.split_step, sent, labels,
                                     step, self.client_id)
        # traced: the trace id rides the lane thread's CTX
        tid = tr.new_trace_id(self.client_id, step)

        def call():
            obs_trace.CTX.trace_id = tid
            t0 = time.perf_counter()
            try:
                out = transport.split_step(sent, labels, step,
                                           self.client_id)
            finally:
                obs_trace.CTX.trace_id = None
            tr.record(spans.TRANSPORT, t0, time.perf_counter() - t0,
                      trace_id=tid, tid=lane, step=step)
            return out

        return self._pool.submit(call)

    def _protect_window(self) -> None:
        """Copy-on-write: in-flight steps that still reference the live
        parameters get one clone of them before an update mutates them
        in place."""
        live = self.state.params[0]
        snap = None
        for entry in self._window:
            if entry[0] is live:
                if snap is None:
                    with torch.no_grad():
                        snap = {k: v.detach().clone()
                                for k, v in live.items()}
                entry[0] = snap

    def _apply(self, entry: list) -> float:
        """Apply one completed exchange, in step order: the backward
        recomputed at the parameters its forward used, the update on the
        current state."""
        params_then, xd, future, _, acts_dtype = entry
        g_acts, loss = future.result()
        tr = obs_trace.get_tracer()
        t0 = time.perf_counter() if tr is not None else 0.0
        g = _received(g_acts, self.device).to(acts_dtype)
        grads = stage_backward(self.stage, params_then, xd, g)
        self._protect_window()
        self._tx.update(self.state,
                        [grads[k].contiguous() for k in params_then])
        if tr is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tr.record(spans.CLIENT_BWD, t0, time.perf_counter() - t0,
                      tid=self.client_id)
        return float(loss)

    def train(self, data_iter: Callable[[], Iterable[Tuple[Any, Any]]],
              epochs: Optional[int] = None, start_step: int = 0,
              on_epoch_end: Optional[Callable[[int, int], None]] = None,
              prefetch: int = 0) -> List[StepRecord]:
        """Full run; the window drains at every epoch's end, so
        ``on_epoch_end`` (the checkpoint hook) sees a quiesced client.
        ``prefetch`` > 0 wraps each epoch's iterator in a
        ``DevicePrefetch`` of that depth."""
        records: List[StepRecord] = []
        step = start_step
        for epoch in range(epochs if epochs is not None else self.cfg.epochs):
            self._window = []
            with contextlib.ExitStack() as stack:
                for x, y in _epoch_iter(stack, data_iter, prefetch,
                                        self.device):
                    self.ensure_init()
                    if len(self._window) == self.depth:
                        entry = self._window.pop(0)
                        self._record(records, entry[3], epoch,
                                     self._apply(entry))
                    tr = obs_trace.get_tracer()
                    t_f0 = time.perf_counter() if tr is not None else 0.0
                    # the input on the device: the recomputed backward
                    # reads it up to depth - 1 batches later
                    xd = _input(x, self.device)
                    params = self.state.params[0]
                    with torch.no_grad():
                        acts = self.stage.apply(params, xd)
                    if tr is not None:
                        tr.record(spans.CLIENT_FWD, t_f0,
                                  time.perf_counter() - t_f0,
                                  tid=self.client_id, step=step)
                    lane = step % self.depth
                    self._window.append(
                        [params, xd, self._submit(lane, acts, y, step),
                         step, acts.dtype])
                    step += 1
                while self._window:  # drain
                    entry = self._window.pop(0)
                    self._record(records, entry[3], epoch,
                                 self._apply(entry))
            if on_epoch_end is not None:
                on_epoch_end(epoch, step)
        return records

    def _record(self, records: List[StepRecord], step: int, epoch: int,
                loss: float) -> None:
        records.append(StepRecord(step=step, loss=loss, epoch=epoch))
        if self.logger is not None:
            self.logger.log_metric("loss", loss, step=step)

    # -- checkpoints (the window is empty between epochs) ---------------- #
    def export_states(self) -> Dict[str, Any]:
        """``{"client": state}`` and, with one transport on a topk8 wire,
        its up-direction EF ledger (lanes with transports of their own
        keep one ledger each, which a checkpoint does not carry)."""
        self.ensure_init()
        tree: Dict[str, Any] = {"client": state_tree(self.state)}
        if len({id(t) for t in self._transports}) == 1:
            ledger = _export_ledger(self.transport)
            if ledger is not None:
                tree[LEDGER_KEY] = ledger
        return tree

    def restore_states(self, tree: Dict[str, Any]) -> None:
        self.ensure_init()
        _restore({"client": self.state}, tree)
        _restore_ledger(self.transport, tree.get(LEDGER_KEY))

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for t in {id(t): t for t in self._transports[1:]
                  if t is not self.transport}.values():
            t.close()

    @property
    def stats(self) -> TransportStats:
        """Merged stats over every lane's transport (each counted once)."""
        unique = {id(t): t for t in self._transports}
        return TransportStats.merged([t.stats for t in unique.values()])
