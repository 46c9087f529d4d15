"""StageRuntime: one party of the K-stage chain (counterpart of
``split_learning_tpu/runtime/stage.py``).

The two-party split (``runtime/server.py``) has one cut. The chain
generalises it to K stages, each its own party with its own optimizer:
a ``StageRuntime`` owns stage ``i`` (0 < i < K) of a ``SplitPlan`` and
serves three hop ops to the pipeline runner
(``runtime/pipeline_runner.py``):

- ``hop_forward(x, step, mb)``: the stage's forward on one microbatch;
  the input is kept as the residual of ``(client, step)``, beside the
  step's parameters, pinned at the step's first hop.
- ``hop_backward(g, step, mb)``: the reply of the decoupled backward
  (2BP): ``d(loss)/d(x)`` for one microbatch at once, from the pinned
  residual (the forward is recomputed under autograd, as JAX's
  ``jax.vjp`` recomputes it); the weight gradient is left to the step's
  deferred apply.
- ``hop_loss(x, labels, step, mb)``: the last stage's hop: forward, the
  microbatch's mean cross-entropy (K1 on the card) and the cut gradient,
  times 1/M so that the M contributions of a step sum to the gradient of
  the batch mean. At M 1 the multiply is skipped, so a chain at M 1 and
  lag 0 is bit-equal to driving the stages one after another.

The weight update is a step's, not a microbatch's: every microbatch of
a step runs on the parameters pinned at its first hop (GPipe), and when
the step's M-th residual lands one entry joins the port's
:class:`~split_learning_tpu_torch.runtime.party._DeferredApply` queue.
Its apply recomputes the M microbatches' forwards at the pinned
parameters, sums their weight gradients in microbatch order and updates
the live state once (K2 under SGD), at most ``apply_lag`` steps behind.
The update is in place, so pinned parameters are kept copy-on-write:
an apply about to mutate tensors that a queued entry or a pending step
still references first gives them a clone (at lag 0 nothing is pinned
then and nothing is cloned).

Exactly-once: each hop is claimed in the replay cache under ``(client,
op, hop_seq(step, mb))``, so a duplicate delivery is served the one
reply and never queues a second update; below the replay window the
strict per-``(client, op)`` sequence check raises ``ProtocolError``.

The reply lives where the request lived (numpy for numpy, a tensor on
the request's device): a CUDA request on the stage's card gets the
stage's own tensor back, which is what ``transport/device.py`` relays.
The hop ops keep JAX's ``device`` keyword for its signature only; it
changes nothing. Every state transition and launch runs under the
party's reentrant lock; the host read of a reply happens after it is
released.

Observability, as in JAX: with tracing on, the forward hop's window
feeds the ``dispatch`` histogram and the backward and loss hops'
``reply_grad`` (the fleet view's compute), and each hop's model FLOPs
and window feed :meth:`~PartyRuntime.trace_metadata` (programs
``hop_fwd``, ``hop_bwd``, ``hop_loss``), which the chain's runner reads
as the stage's MFU; with the flight recorder on, each reply journals
``FL_STAGE_REPLY`` and each deferred apply ``FL_DEFER_APPLY``.

The mesh (``mesh=``), as in JAX: each stage has its own, and a hop's
payload moves from one stage's layout onto the next's at the next
stage's :meth:`~PartyRuntime._to_dev` (on the device wire a move
between the ranks' devices, never through the host). The stage's state
is laid out by its ``SpecLayout``
(:class:`~split_learning_tpu_torch.runtime.state.ShardedState`): its
ops scatter a microbatch over the ``data`` rows and each row over the
``model`` ranks, and its deferred apply updates every row and rank. A
hop's microbatch must tile ``data`` (400 otherwise); ``predict`` pads
its rows to the ``data`` multiple and trims them. /health carries the
mesh (``mesh_axes``), which the runner's ``stage_report`` shows.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from split_learning_tpu_torch import __version__
from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.runtime.party import (
    PartyRuntime, ProtocolError, _DeferredApply, mesh_axes, rows_of)
from split_learning_tpu_torch.runtime.state import (
    check_config, leaves_of, make_tx)
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike

# the composite replay/chaos key: one monotonic sequence per (step, mb)
MB_STRIDE = 1 << 16

# pending per-step residual records kept before the step's deferred
# entry forms: a bounded FIFO; a backward for an evicted step is a
# protocol error
MAX_PENDING_STEPS = 8


def hop_seq(step: int, mb: int) -> int:
    """The composite (step, microbatch) ordinal every hop is keyed by."""
    return int(step) * MB_STRIDE + int(mb)


class StageRuntime(PartyRuntime):
    """One middle or last stage of the chain. Thread-safe: HTTP handler
    threads and the runner's hop workers may call concurrently.

    ``init`` is a ``torch.Generator`` or per-stage dicts for the whole
    plan (:func:`~split_learning_tpu_torch.runtime.state.init_params`);
    the stage keeps its own. ``sample_input`` keeps the JAX signature.
    ``microbatches`` must be the runner's M (the 1/M scaling and the
    entry's arity); ``apply_lag`` is this stage's own staleness bound in
    steps. ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, plan: SplitPlan, stage_index: int, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: Any = None,
                 strict_steps: bool = True,
                 microbatches: int = 1,
                 apply_lag: int = 0,
                 replay_window: int = 8,
                 tenants: int = 1,
                 quota: Optional[Any] = None,
                 slo_ms: Optional[Any] = None,
                 mesh: Optional[Any] = None,
                 ef_mode: str = "topk8",
                 device: DeviceLike = "cuda") -> None:
        if not 0 < stage_index < plan.num_stages:
            raise ValueError(
                f"stage_index must be in [1, {plan.num_stages - 1}] "
                f"(stage 0 is the client's; got {stage_index})")
        super().__init__(cfg, party=f"stage{int(stage_index)}",
                         lock_name="StageRuntime._lock", mesh=mesh,
                         replay_window=replay_window, tenants=tenants,
                         quota=quota, slo_ms=slo_ms, ef_mode=ef_mode)
        check_config(cfg)
        del sample_input  # a flax-style init needs no sample
        self.device = self._place(device)
        self.plan = plan
        self.stage_index = int(stage_index)
        self.strict_steps = strict_steps
        self.microbatches = int(microbatches)
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1 (got {microbatches})")
        self.apply_lag = int(apply_lag)
        if self.apply_lag < 0:
            raise ValueError(f"apply_lag must be >= 0 (got {apply_lag})")
        self.is_last = self.stage_index == plan.num_stages - 1
        self._stage = plan.stages[self.stage_index]
        self._tx = make_tx(cfg)
        self.state = self._new_state(plan, init, (self.stage_index,))
        self._deferred = _DeferredApply(
            self._apply_deferred_entry, self.apply_lag, self._lock)
        # per-(client, step) residual records: the pinned parameters and
        # the per-microbatch inputs and cotangents (or labels), until the
        # step's deferred entry forms
        self._recs: "OrderedDict[Tuple[int, int], Dict[str, Any]]" = (
            OrderedDict())
        # the strict hop handshake: per (client, op) the last composite seq
        self._last_seq: Dict[Tuple[int, str], int] = {}
        self._seq_floor = -1
        self._hops = {"hop_fwd": 0, "hop_bwd": 0, "hop_loss": 0}

    @property
    def params(self) -> Params:
        """The stage's parameters (live tensors), read under the lock."""
        with self._lock:
            return self.state.params[0]

    # ------------------------------------------------------------------ #
    def _check_seq(self, op: str, seq: int, client_id: int) -> None:
        last = max(self._last_seq.get((client_id, op), -1),
                   self._seq_floor)
        if self.strict_steps and seq <= last:
            raise ProtocolError(
                f"non-monotonic hop seq {seq} for {op} from client "
                f"{client_id} at stage {self.stage_index} (last seen "
                f"{last}); duplicate outside the replay window: refusing "
                "to desync")

    def _rec_for(self, client_id: int, step: int) -> Dict[str, Any]:
        """The step's residual record, pinning the live parameters on its
        first hop (every microbatch of a step runs on the same weights)."""
        key = (int(client_id), int(step))
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                rec = {"params": self.state.params[0], "xs": {}, "gs": {},
                       "ys": {}}
                self._recs[key] = rec
                while len(self._recs) > MAX_PENDING_STEPS:
                    self._recs.popitem(last=False)
            return rec

    def _maybe_queue_apply(self, rec: Dict[str, Any], key_done: str,
                           client_id: int, step: int) -> None:
        """When the step's last residual lands, queue one deferred update
        holding the M residuals and drain the over-lag tail."""
        done = rec[key_done]
        if len(done) != self.microbatches:
            return
        mbs = range(self.microbatches)
        self._recs.pop((int(client_id), int(step)), None)
        self._deferred.push({
            "kind": "stage", "step": int(step), "client_id": int(client_id),
            "fwd_params": rec["params"],
            "xs": [rec["xs"][m] for m in mbs],
            "cts": [done[m] for m in mbs]})
        self._deferred.drain_over_lag()

    def _protect_pinned(self) -> None:
        """Copy-on-write: queued entries and pending steps that reference
        the live parameters get one clone of them before an update
        mutates them in place."""
        with self._lock:
            live = self.state.params[0]
            holders = ([(e, "fwd_params") for e in self._deferred.pending()]
                       + [(r, "params") for r in self._recs.values()])
            pinned = [(box, key) for box, key in holders
                      if box[key] is live]
            if pinned:
                with torch.no_grad():
                    snap = {k: v.detach().clone().requires_grad_(True)
                            for k, v in live.items()}
                for box, key in pinned:
                    box[key] = snap

    def _weight_grads(self, entry: Dict[str, Any]) -> List[torch.Tensor]:
        """The sum over the entry's microbatches, in microbatch order, of
        each microbatch's weight gradient at the pinned parameters: the
        forward recomputed under autograd, then the loss (last stage,
        times 1/M for M > 1) or the stored cotangent pulled through."""
        params = entry["fwd_params"]
        leaves = leaves_of((params,))
        m = self.microbatches
        g_sum: Optional[List[torch.Tensor]] = None
        for x, ct in zip(entry["xs"], entry["cts"]):
            with torch.enable_grad():
                out = self._stage.apply(params, x.detach())
                if self.is_last:
                    loss = fused_cross_entropy(out, ct)
                    if m > 1:
                        loss = loss * (1.0 / m)
                    gp = torch.autograd.grad(loss, leaves)
                else:
                    gp = torch.autograd.grad(out, leaves, ct.to(out.dtype))
            g_sum = list(gp) if g_sum is None else [
                a + b for a, b in zip(g_sum, gp)]
        return g_sum

    def _apply_deferred_entry(self, entry: Dict[str, Any]) -> None:
        """One queued update (the queue's drain, under the lock):
        launches only."""
        tr = obs_trace.get_tracer()
        t0 = time.perf_counter() if tr is not None else 0.0
        grads = self._weight_grads(entry)
        self._protect_pinned()
        # cuDNN may hand conv weight grads back channels-last; K2 walks
        # each leaf in its parameter's (contiguous) order
        self._tx.update(self.state, [g.contiguous() for g in grads])
        if tr is not None:
            dw = time.perf_counter() - t0
            tr.record(spans.DEFERRED_APPLY, t0, dw,
                      trace_id=obs_trace.CTX.trace_id, party=self.party,
                      tid=entry["client_id"], step=entry["step"])
            self._metrics.observe(spans.DEFERRED_APPLY, dw)
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_DEFER_APPLY, step=entry["step"],
                      client_id=entry["client_id"], party=self.party,
                      kind=entry["kind"])

    # -- observability ------------------------------------------------- #
    def _hop_fn(self, op: str):
        """The pure form of a hop's program, for its FLOP count: the
        forward, and for ``hop_bwd``/``hop_loss`` the gradient of the
        input the reply carries, from ``(params, x, ct)``."""
        def fn(params, x, ct):
            if op == "hop_fwd":
                with torch.no_grad():
                    return self._stage.apply(params, x)
            x = x.detach().requires_grad_(True)
            y = self._stage.apply(params, x)
            if op == "hop_loss":
                return torch.autograd.grad(fused_cross_entropy(y, ct), [x])
            return torch.autograd.grad(y, [x], ct.to(y.dtype))
        return fn

    def _journal_reply(self, op: str, step: int, mb: int,
                       client_id: int) -> None:
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_STAGE_REPLY, step=int(step),
                      client_id=int(client_id), party=self.party, op=op,
                      stage=self.stage_index, mb=int(mb))

    # -- the three hop ops --------------------------------------------- #
    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0, *, device: bool = False) -> Any:
        """Forward one microbatch through this stage; the input is kept
        for the step's backward. On the last stage a plain forward at the
        live parameters, with no residual (the chain's predict path)."""
        del device   # JAX's keyword: the reply follows the request
        seq = hop_seq(step, mb)
        entry = None
        if self.replay is not None:
            entry, owner = self.replay.begin(client_id, "hop_fwd", seq)
            if not owner:
                return self.replay.wait(entry)
        tr = obs_trace.get_tracer()
        admitted = False
        try:
            if self._admission is not None:
                self._admission.admit(client_id)
                admitted = True
            with self._lock:
                t0 = time.perf_counter() if tr is not None else 0.0
                win = self._window_open() if tr is not None else None
                self._check_seq("hop_fwd", seq, client_id)
                rows = rows_of(x)
                self._check_batch_rows(rows, rows)
                x_dev = self._to_dev(x)
                if not self.is_last:
                    rec = self._rec_for(client_id, step)
                    params = rec["params"]
                else:
                    params = self.state.params[0]
                with obs_dispatch.step_scope(
                        self._dd, (self._ddtok, "hop_fwd"),
                        sig_fn=lambda: obs_dispatch.signature(x_dev)), \
                        torch.no_grad():
                    y = self._stage.apply(params, x_dev)
                if win is not None:
                    win = self._window_close(win)
                if not self.is_last:
                    rec["xs"][int(mb)] = x_dev
                self._last_seq[(client_id, "hop_fwd")] = seq
                self._hops["hop_fwd"] += 1
            with obs_dispatch.expected_d2h(self._dd):
                out = self._reply_value(y, x)   # off the lock
            if tr is not None:
                # the forward's window, the fleet view's compute input
                self._metrics.observe(spans.DISPATCH,
                                      time.perf_counter() - t0)
                self._note_flops("hop_fwd", self._hop_fn("hop_fwd"),
                                 (params, x_dev, None), win)
            if entry is not None:
                self.replay.resolve(entry, out)
            if admitted:
                admitted = False
                self._admission.complete(client_id)
            self._journal_reply("hop_fwd", step, mb, client_id)
            return out
        except BaseException as exc:
            # pair the admit before releasing the claim: fail() is the
            # last replay-visible act on the path (SLT002)
            if admitted:
                self._admission.complete(client_id)
            if entry is not None:
                self.replay.fail(entry, exc)
            raise

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0, *, device: bool = False) -> Any:
        """The 2BP reply: ``d(loss)/d(x)`` of one microbatch at once,
        from the pinned residual; the step's update is queued once its
        last cotangent lands."""
        del device   # JAX's keyword: the reply follows the request
        if self.is_last:
            raise ProtocolError(
                f"hop_backward on the last stage {self.stage_index}; the "
                "loss hop already returned its cotangent", status=400)
        seq = hop_seq(step, mb)
        entry = None
        if self.replay is not None:
            entry, owner = self.replay.begin(client_id, "hop_bwd", seq)
            if not owner:
                return self.replay.wait(entry)
        tr = obs_trace.get_tracer()
        try:
            with self._lock:
                t0 = time.perf_counter() if tr is not None else 0.0
                win = self._window_open() if tr is not None else None
                self._check_seq("hop_bwd", seq, client_id)
                rows = rows_of(g_out)
                self._check_batch_rows(rows, rows)
                rec = self._recs.get((int(client_id), int(step)))
                if rec is None or int(mb) not in rec["xs"]:
                    raise ProtocolError(
                        f"unknown pipeline residual for step {step} mb "
                        f"{mb} at stage {self.stage_index} (evicted or "
                        "never forwarded)")
                g_dev = self._to_dev(g_out)
                x_in = rec["xs"][int(mb)].detach().requires_grad_(True)
                with obs_dispatch.step_scope(
                        self._dd, (self._ddtok, "hop_bwd"),
                        sig_fn=lambda: obs_dispatch.signature(g_dev)), \
                        torch.enable_grad():
                    y = self._stage.apply(rec["params"], x_in)
                    (g_in,) = torch.autograd.grad(y, [x_in],
                                                  g_dev.to(y.dtype))
                if win is not None:
                    win = self._window_close(win)
                rec["gs"][int(mb)] = g_dev
                self._maybe_queue_apply(rec, "gs", client_id, step)
                self._last_seq[(client_id, "hop_bwd")] = seq
                self._hops["hop_bwd"] += 1
            with obs_dispatch.expected_d2h(self._dd):
                out = self._reply_value(g_in, g_out)
            if tr is not None:
                rw = time.perf_counter() - t0
                tr.record(spans.REPLY_GRAD, t0, rw,
                          trace_id=obs_trace.CTX.trace_id,
                          party=self.party, tid=client_id, step=step)
                self._metrics.observe(spans.REPLY_GRAD, rw)
                self._note_flops("hop_bwd", self._hop_fn("hop_bwd"),
                                 (rec["params"], x_in, g_dev), win)
            if entry is not None:
                self.replay.resolve(entry, out)
            self._journal_reply("hop_bwd", step, mb, client_id)
            return out
        except BaseException as exc:
            if entry is not None:
                self.replay.fail(entry, exc)
            raise

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0, *, device: bool = False
                 ) -> Tuple[Any, Any]:
        """The last stage's hop: forward and the microbatch's mean
        cross-entropy; the (1/M-scaled) cut gradient and the loss reply
        at once, the weight update is deferred."""
        del device   # JAX's keyword: the reply follows the request
        if not self.is_last:
            raise ProtocolError(
                f"hop_loss on non-last stage {self.stage_index}; only "
                f"stage {self.plan.num_stages - 1} owns the loss",
                status=400)
        seq = hop_seq(step, mb)
        entry = None
        if self.replay is not None:
            entry, owner = self.replay.begin(client_id, "hop_loss", seq)
            if not owner:
                return self.replay.wait(entry)
        tr = obs_trace.get_tracer()
        admitted = False
        try:
            if self._admission is not None:
                self._admission.admit(client_id)
                admitted = True
            with self._lock:
                t0 = time.perf_counter() if tr is not None else 0.0
                win = self._window_open() if tr is not None else None
                self._check_seq("hop_loss", seq, client_id)
                self._check_batch_rows(rows_of(x), rows_of(labels))
                rec = self._rec_for(client_id, step)
                x_dev = self._to_dev(x)
                y_dev = self._to_dev(labels, torch.int64)
                x_in = x_dev.detach().requires_grad_(True)
                with obs_dispatch.step_scope(
                        self._dd, (self._ddtok, "hop_loss"),
                        sig_fn=lambda: obs_dispatch.signature(
                            x_in, y_dev)), torch.enable_grad():
                    loss = fused_cross_entropy(
                        self._stage.apply(rec["params"], x_in), y_dev)
                    (g_x,) = torch.autograd.grad(loss, [x_in])
                if self.microbatches > 1:
                    g_x = g_x * (1.0 / self.microbatches)
                if win is not None:
                    win = self._window_close(win)
                loss = loss.detach()
                rec["xs"][int(mb)] = x_dev
                rec["ys"][int(mb)] = y_dev
                self._maybe_queue_apply(rec, "ys", client_id, step)
                self._last_seq[(client_id, "hop_loss")] = seq
                self._hops["hop_loss"] += 1
            # off the lock: the loss edge, the chain's one host read
            with obs_dispatch.expected_d2h(self._dd):
                res = (self._reply_value(g_x, x), float(loss))
            if tr is not None:
                rw = time.perf_counter() - t0
                tr.record(spans.REPLY_GRAD, t0, rw,
                          trace_id=obs_trace.CTX.trace_id,
                          party=self.party, tid=client_id, step=step)
                self._metrics.observe(spans.REPLY_GRAD, rw)
                self._note_flops("hop_loss", self._hop_fn("hop_loss"),
                                 (rec["params"], x_dev, y_dev), win)
            if entry is not None:
                self.replay.resolve(entry, res)
            if admitted:
                admitted = False
                self._admission.complete(client_id)
            self._journal_reply("hop_loss", step, mb, client_id)
            return res
        except BaseException as exc:
            # pair the admit before releasing the claim: fail() is the
            # last replay-visible act on the path (SLT002)
            if admitted:
                self._admission.complete(client_id)
            if entry is not None:
                self.replay.fail(entry, exc)
            raise

    def predict(self, x: Any, client_id: int = 0) -> Any:
        """Forward only, no residual, no handshake, behind the flush
        barrier: a read of the stage's parameters sees every update whose
        reply has left."""
        del client_id
        with self._lock, torch.no_grad():
            self._deferred.flush()
            x_dev = self._to_dev(x)
            n = int(x_dev.shape[0])
            pad = (-n) % self._mesh_data
            if pad:
                # forward only, so padding is exact: rows to tile the
                # data axis, and only the real ones come back
                x_dev = torch.cat([x_dev, x_dev.new_zeros(
                    (pad,) + tuple(x_dev.shape[1:]))])
            out = self._stage.apply(self.state.params[0], x_dev)
        return self._reply_value(out, x, rows=n if pad else None)

    # -- PartyRuntime hooks --------------------------------------------- #
    def _reset_protocol_state(self, step: int) -> None:
        self._recs.clear()
        self._last_seq = {}
        self._seq_floor = int(step) * MB_STRIDE - 1

    # ------------------------------------------------------------------ #
    def counters(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._hops)
            out["pending_steps"] = len(self._recs)
        out.update(self._deferred.counters())
        if self.replay is not None:
            out.update(self.replay.counters())
        return out

    def health(self) -> Dict[str, Any]:
        """GET /health of a stage party (JAX's keys): its role, index and
        M, and ``step``, the highest step any hop of which it has
        acknowledged (or re-armed to by a resume)."""
        uptime = time.monotonic() - self._t_start
        with self._lock:
            seq = max(max(self._last_seq.values(), default=-1),
                      self._seq_floor)
        info = {
            "status": "ok",
            "role": "stage",
            "stage_index": self.stage_index,
            "stage_name": self._stage.name,
            "is_last": self.is_last,
            "microbatches": self.microbatches,
            "apply_lag": self.apply_lag,
            "step": max(seq // MB_STRIDE, -1),
            "uptime_s": uptime,
            "uptime_seconds": uptime,
            "version": __version__,
            "counters": self.counters(),
        }
        if self._mesh is not None:
            info["mesh"] = mesh_axes(self._mesh)
        return info

    def metrics(self) -> Dict[str, Any]:
        """The metrics snapshot: hop, deferred and replay counts as
        ``_total`` counters, depths as gauges, the stage index."""
        snap = self._metrics.snapshot()
        gauge_keys = ("pending_steps", "deferred_apply_depth",
                      "replay_cache_size")
        for k, v in self.counters().items():
            if k in gauge_keys:
                snap["gauges"][k] = float(v)
            else:
                snap["counters"][f"{k}_total"] = float(v)
        snap["gauges"]["stage_index"] = float(self.stage_index)
        self._fold_shared_metrics(snap)
        return snap
