"""Server-party runtime: the top half of the split step (counterpart of
``split_learning_tpu/runtime/server.py`` ``ServerRuntime``, split mode).

``split_step`` is the reference's ``/forward_pass`` handler
(``src/server_part.py:25-58``): take the cut activations and labels,
run the server stage forward, the cross-entropy, the backward and one
update of the party's own optimizer (``runtime/state.py`` ``make_tx``
over its own stage, clipping over its own leaves), and return the
cut-layer gradient with the loss. On the card the loss is K1
(``ops/cross_entropy.py``) and an SGD update K2 (``ops/sgd.py``), as in
the fused trainer. The cut tensor is taken in the dtype it arrives in
(bfloat16 for a bfloat16 plan) and its gradient returned in that dtype.
Beyond the reference, as in JAX: a per-client step handshake (a step at or below the last one is a
``ProtocolError``, 409) and the replay cache, which serves a duplicate
of an applied step its original reply instead of applying it twice.

The reply lives where the request lived: numpy activations get a numpy
gradient back (JAX's contract, which a JAX client needs; a bfloat16 one
as numpy's ``ml_dtypes`` bfloat16, :mod:`utils.arrays`), a tensor gets a
tensor on its own device. The in-process wire decodes on the server's
device, so on the card the down-wire encodes from a CUDA tensor.

The lock covers the handshake and the launch of the step; the reply is
materialised (the loss read, a host copy for a numpy caller) after it
is released, as JAX's ``overlap`` default does. The parameters are
updated in place, and a later step's kernels queue behind this one's on
the same stream, so nothing reads them early.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: request coalescing (``coalesce_max > 1``) and multi-tenant
admission (``tenants``, ``quota``, ``slo_ms``), item 14; the decoupled
backward (``decouple_bwd``, ``apply_lag``), item 14; a ``mesh``, item 18;
the U-shaped and federated servers with ``u_forward``/``u_backward`` and
``aggregate``, items 11 and 15.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch import __version__
from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.runtime.party import (
    PartyRuntime, ProtocolError, not_ported)
from split_learning_tpu_torch.runtime.state import (
    check_config, init_params, make_state, make_tx)
from split_learning_tpu_torch.utils.arrays import from_host, to_host
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


def _rows(x: Any) -> int:
    shape = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) \
        else tuple(x.shape)
    return int(shape[0]) if shape else 0


def _reply_like(value: torch.Tensor, request: Any) -> Any:
    """``value`` in the kind of ``request``: numpy for a numpy request, a
    tensor on the request's device otherwise."""
    if isinstance(request, torch.Tensor):
        return value.to(request.device)
    return to_host(value)


class ServerRuntime(PartyRuntime):
    """Holds the server-owned stage state and serves ``split_step`` and
    ``predict``. Thread-safe: all state transitions happen under one
    lock.

    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan (see :func:`~split_learning_tpu_torch.runtime.state.init_params`);
    the server keeps its own stage. ``sample_input`` keeps the JAX
    signature. ``device`` defaults to ``"cuda"`` and raises without a
    GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: Any = None, strict_steps: bool = True,
                 coalesce_max: int = 1,
                 replay_window: int = 8,
                 tenants: int = 1,
                 quota: Optional[Any] = None,
                 slo_ms: Optional[Any] = None,
                 decouple_bwd: bool = False,
                 apply_lag: int = 0,
                 mesh: Optional[Any] = None,
                 ef_mode: str = "topk8",
                 device: DeviceLike = "cuda") -> None:
        if coalesce_max > 1:
            raise not_ported("request coalescing (coalesce_max > 1)",
                             "item 14")
        if decouple_bwd or apply_lag:
            raise not_ported("the decoupled backward (decouple_bwd, "
                             "apply_lag)", "item 14")
        if cfg.mode == "u_split":
            raise not_ported("the U-shaped server (mode 'u_split')",
                             "item 11")
        if cfg.mode == "federated":
            raise not_ported("the federated server and FedAvg (mode "
                             "'federated')", "items 11 and 15")
        super().__init__(cfg, party="server",
                         lock_name="ServerRuntime._lock", mesh=mesh,
                         replay_window=replay_window, tenants=tenants,
                         quota=quota, slo_ms=slo_ms, ef_mode=ef_mode)
        check_config(cfg)
        del sample_input  # a flax-style init needs no sample
        self.device = resolve_device(device)
        self.plan = plan
        self.mode = cfg.mode
        self.strict_steps = strict_steps
        # per-client step handshake: the last acknowledged step
        self._last_step: Dict[int, int] = {}
        server_idx = plan.stages_of("server")
        if len(server_idx) != 1 or server_idx[0] != plan.num_stages - 1:
            raise ValueError("the split server owns exactly the last stage "
                             f"(plan owners {plan.owners})")
        self.server_stage = server_idx[0]
        self._stage = plan.stages[self.server_stage]
        self._tx = make_tx(cfg)
        self.state = make_state(
            init_params(plan, init, self.device, (self.server_stage,)),
            self._tx)

    @property
    def params(self) -> Params:
        """The server stage's parameters (live tensors)."""
        return self.state.params[0]

    # ------------------------------------------------------------------ #
    def _to_dev(self, x: Any, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """``x`` on the device, in ``dtype`` (None: a float32 or bfloat16
        tensor keeps its dtype, another float becomes float32)."""
        t = from_host(x) if not isinstance(x, torch.Tensor) else x.detach()
        if dtype is None:
            dtype = (t.dtype if t.dtype in (torch.float32, torch.bfloat16)
                     else torch.float32)
        return t.to(self.device, dtype)

    def _check_step(self, step: int, client_id: int = 0) -> None:
        last = self._last_step.get(client_id, -1)
        if self.strict_steps and step <= last:
            raise ProtocolError(
                f"non-monotonic step {step} from client {client_id} "
                f"(last seen {last}); client restarted or replayed: "
                "refusing to desync")

    def _step(self, acts: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, loss, backward and the update, in place; returns the
        cut gradient and the loss, on the device, unsynchronised."""
        params = self.state.params[0]
        leaves = list(params.values())
        acts = acts.requires_grad_(True)
        with torch.enable_grad():
            loss = fused_cross_entropy(self._stage.apply(params, acts),
                                       labels)
            *g_params, g_acts = torch.autograd.grad(loss, leaves + [acts])
        # cuDNN may hand conv weight grads back channels-last; K2 walks
        # each leaf in its parameter's (contiguous) order
        self._tx.update(self.state, [g.contiguous() for g in g_params])
        return g_acts, loss.detach()

    def split_step(self, activations: Any, labels: Any, step: int,
                   client_id: int = 0) -> Tuple[Any, float]:
        # duplicate delivery (lost response, retried request): claim the
        # step exactly once; losers block on the winner's entry and are
        # served its one reply
        entry = None
        if self.replay is not None:
            entry, owner = self.replay.begin(client_id, "split_step", step)
            if not owner:
                return self.replay.wait(entry)
        tr = obs_trace.get_tracer()
        try:
            t_q0 = time.perf_counter() if tr is not None else 0.0
            with self._lock:
                t_d0 = time.perf_counter() if tr is not None else 0.0
                self._check_step(step, client_id)
                self._check_batch_rows(_rows(activations), _rows(labels))
                g_acts, loss = self._step(
                    self._to_dev(activations),
                    self._to_dev(labels, torch.int64))
                # max(): with strict_steps off steps may arrive out of
                # order; the acknowledged step never regresses
                self._last_step[client_id] = max(
                    self._last_step.get(client_id, -1), step)
                t_d1 = time.perf_counter() if tr is not None else 0.0
            # off the lock: the loss read waits for the step's kernels
            res = (_reply_like(g_acts, activations), float(loss))
            if entry is not None:
                self.replay.resolve(entry, res)
            if tr is not None:
                self._record_server_spans(
                    tr, t_q0, t_d0, t_d1, time.perf_counter(), step,
                    client_id)
            return res
        except BaseException as exc:
            # no reply was produced: release the claim so a retry can
            # re-own the step, and hand the error to anyone blocked on it
            if entry is not None:
                self.replay.fail(entry, exc)
            raise

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
        with self._lock, torch.no_grad():
            # launched under the lock: a concurrent step's in-place
            # update queues behind this forward
            out = self._stage.apply(self.state.params[0],
                                    self._to_dev(activations))
        return _reply_like(out, activations)

    # -- ops of the other modes ----------------------------------------- #
    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        raise not_ported("u_forward (the U-shaped split)", "item 11")

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        raise not_ported("u_backward (the U-shaped split)", "item 11")

    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        raise not_ported("aggregate (FedAvg)", "items 11 and 15")

    # ------------------------------------------------------------------ #
    def health(self) -> Dict[str, Any]:
        """GET /health (``src/server_part.py:95-102``), plus ``step``: the
        highest client step this server has acknowledged."""
        with self._lock:
            step = max(self._last_step.values(), default=-1)
        return {"status": "healthy", "mode": self.mode,
                "model_type": self._stage.name, "step": step,
                "strict_steps": self.strict_steps,
                "version": __version__,
                "uptime_seconds": time.monotonic() - self._t_start}

    def metrics(self) -> Dict[str, Any]:
        """The histogram/counter/gauge snapshot, with the acknowledged
        step and the replay counters folded in."""
        snap = self._metrics.snapshot()
        snap["gauges"]["acked_step"] = float(self.health()["step"])
        self._fold_shared_metrics(snap)
        return snap
