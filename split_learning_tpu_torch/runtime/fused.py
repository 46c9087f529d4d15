"""Fused split trainer (counterpart of ``split_learning_tpu/runtime/fused.py``).

The whole split step runs in one process on one device: client stage
forward, the cut tensor handed on as a tensor, server stage forward, the
fused cross-entropy, backward, and one update of ``make_tx``'s optimizer
over both halves (``runtime/state.py``: SGD with momentum, coupled L2,
adam or adamw, at a constant or scheduled lr, clipped over the whole
model's global norm). On CUDA every step launches the cross-entropy
kernels (forward and backward, once per microbatch, on float32 or
bfloat16 logits), under SGD the SGD kernel once per table of up to 896
leaves (float32 and bfloat16 mixed; adam and adamw run plain
``_foreach`` arithmetic and launch none), and, for a transformer plan
with ``attn="flash"``, the flash-attention forward (K5) and backward
(K6) once per block and microbatch; on the CPU the same step runs their
plain versions.

``cfg.dtype`` is the plan's compute dtype, which the caller builds the
plan with (``get_plan(..., dtype=cfg.dtype)``): ``"bfloat16"`` is flax's
mixed precision, float32 parameters (and a bfloat16 ``pos`` table) with
bfloat16 activations and logits.

The model families are the CNN plans and the two transformer families
(``transformer``: ``[B, T]`` token ids to ``[B, classes]``;
``transformer_lm``: ``[B, T]`` to ``[B, T, vocab]``, labels ``[B, T]``,
the loss a mean over all B*T tokens). Token ids reach the plan as the
integers they are; floating inputs are cast to float32.

Where the JAX trainer compiles one XLA program per step (and a
``lax.scan`` per epoch), this one runs eagerly: ``train_epoch`` is a
Python loop over the leading step axis that launches the steps back to
back and stacks their device losses, with no host sync; ``train
--scan-steps N`` hands it N batches a chunk and reads the N losses once.
It captures no CUDA graph: a graph of the chunk replayed N times is a
later performance change (ROADMAP P2). The state is updated in place;
:meth:`FusedSplitTrainer.export_states` and
:meth:`~FusedSplitTrainer.restore_states` carry it through a checkpoint.

``cfg.remat`` trains through :func:`~split_learning_tpu_torch.core.
stage.remat_plan`: each stage's forward runs again in the backward
(under a flash-attention plan K5 launches twice a block a step; the
loss, K1, lies outside every stage and launches once). :meth:`step_flops`
counts the plan without the recompute, as JAX's count does.

The dispatch watchdog (``obs/dispatch_debug.py``), when on, scopes each
step (``fused_step``) and each chunk (``fused_epoch``); the loss read of
:meth:`train_step` is its sanctioned host read.

Config values the port cannot run yet raise ``NotImplementedError``
naming the ROADMAP item that brings them (:func:`check_supported`).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan, remat_plan
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.runtime.state import (
    TrainState, check_config, init_params, leaves_of, make_state, make_tx,
    restore_state, state_tree)
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for every value the fused trainer
    cannot run: a transport other than ``fused`` (the two-party path is
    ``SplitClientTrainer`` over ``LocalTransport`` or ``HttpTransport``),
    ``num_clients > 1`` (JAX's fused trainer reads it as the ``data``
    axis of a device mesh), and
    :func:`~split_learning_tpu_torch.runtime.state.check_config`."""
    if cfg.transport != "fused":
        raise NotImplementedError(
            f"not ported yet: transport {cfg.transport!r} in the fused "
            "trainer (the two-party path, ROADMAP items 8-12, is "
            "SplitClientTrainer over LocalTransport or HttpTransport)")
    if cfg.num_clients > 1:
        raise NotImplementedError(
            "not ported yet: num_clients > 1 in the fused trainer "
            "(data-parallel mesh: ROADMAP item 18)")
    check_config(cfg)


class FusedSplitTrainer:
    """Single-process split training on one device.

    ``init`` is a ``torch.Generator`` (fresh flax-style init, drawn on the
    CPU) or per-stage parameter dicts to start from, e.g. carried over
    from the JAX package with :mod:`split_learning_tpu_torch.interop`.
    ``sample_input`` keeps the JAX signature; a flax-style init needs no
    sample. ``device`` defaults to ``"cuda"`` and raises without a GPU."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: np.ndarray,
                 device: DeviceLike = "cuda") -> None:
        check_supported(cfg)
        self.device = resolve_device(device)
        # grads recompute the stage forwards under remat; the FLOP count
        # reads the plan as written
        self._flops_plan = plan
        self.plan = remat_plan(plan) if cfg.remat else plan
        self.cfg = cfg
        self._tx = make_tx(cfg)
        self.state: TrainState = make_state(
            init_params(plan, init, self.device), self._tx)
        self._flops_cache: Dict[Tuple[Any, ...], float] = {}
        # dispatch watchdog: None unless SLT_DISPATCH_DEBUG / force()
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()

    # ----------------------------------------------------------------- #
    def _to_device(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Floating inputs as float32, token ids as they are (JAX's
        ``train_step`` passes ``x`` unchanged); labels as int64."""
        x = torch.as_tensor(x).to(self.device)
        if x.is_floating_point():
            x = x.float()
        y = torch.as_tensor(y).to(self.device, torch.int64)
        return x, y

    def _loss_and_grads(self, x: torch.Tensor, y: torch.Tensor):
        params = self.state.params
        leaves = leaves_of(params)

        def value_and_grad(xb, yb):
            loss = fused_cross_entropy(self.plan.apply(params, xb), yb)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        mb = self.cfg.microbatches
        if mb == 1:
            return value_and_grad(x, y)
        # gradient accumulation over microbatches, as the JAX scan: per
        # microbatch mean CE, grads summed then divided by mb, loss averaged
        xs = x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))
        ys = y.reshape((mb, y.shape[0] // mb) + tuple(y.shape[1:]))
        g_sum = [torch.zeros_like(t) for t in leaves]
        l_sum = torch.zeros((), device=self.device)
        for i in range(mb):
            loss, grads = value_and_grad(xs[i], ys[i])
            g_sum = [a + g for a, g in zip(g_sum, grads)]
            l_sum = l_sum + loss
        return l_sum / mb, [g / mb for g in g_sum]

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, grads = self._loss_and_grads(x, y)
        # cuDNN returns the conv weight grads in channels_last when its input
        # is channels_last; the SGD kernel walks each leaf in its params'
        # (contiguous) order
        self._tx.update(self.state, [g.contiguous() for g in grads])
        return loss

    def train_step_async(self, x, y) -> torch.Tensor:
        """One step; returns the loss as a device scalar, with no host sync."""
        x, y = self._to_device(x, y)
        with obs_dispatch.step_scope(
                self._dd, (self._ddtok, "fused_step"),
                sig_fn=lambda: obs_dispatch.signature(x, y)):
            return self._step(x, y)

    def train_step(self, x, y) -> float:
        """One step on the batch; returns the loss as a Python float."""
        loss = self.train_step_async(x, y)
        with obs_dispatch.expected_d2h(self._dd):
            return float(loss)

    def train_epoch(self, xs, ys) -> torch.Tensor:
        """Run ``xs.shape[0]`` steps back to back; returns the per-step
        loss series (a device tensor, not synchronised)."""
        xs, ys = self._to_device(xs, ys)
        pairs = [(xs[i], ys[i]) for i in range(xs.shape[0])]
        with obs_dispatch.step_scope(
                self._dd, (self._ddtok, "fused_epoch"),
                sig_fn=lambda: (len(pairs),)
                + obs_dispatch.signature(*pairs[0])):
            return torch.stack([self._step(x, y) for x, y in pairs])

    def step_flops(self, x, y) -> float:
        """Model FLOPs of one step on the batch ``(x, y)`` (forward and
        backward over every microbatch; the update adds none), counted
        from the step's own loss and gradients on meta copies
        (:func:`~split_learning_tpu_torch.utils.flops.step_flops`), K5
        and K6 included; cached per batch shape and dtype."""
        from split_learning_tpu_torch.utils.flops import step_flops
        x, y = self._to_device(x, y)
        key = (tuple(x.shape), str(x.dtype), tuple(y.shape))
        cache = self._flops_cache
        if key not in cache:
            mb = self.cfg.microbatches

            def step(params, xb, yb):
                leaves = leaves_of(params)
                xs = xb.reshape((mb, xb.shape[0] // mb) + tuple(xb.shape[1:]))
                ys = yb.reshape((mb, yb.shape[0] // mb) + tuple(yb.shape[1:]))
                for i in range(mb):
                    loss = fused_cross_entropy(
                        self._flops_plan.apply(params, xs[i]), ys[i])
                    torch.autograd.grad(loss, leaves)
            params = tuple({k: v.detach().requires_grad_(True)
                            for k, v in st.items()}
                           for st in self.state.params)
            cache[key] = step_flops(step, params, x, y)
        return cache[key]

    @property
    def params(self) -> Tuple[Params, ...]:
        return self.state.params

    def export_states(self) -> Dict[str, Any]:
        """The checkpoint tree of the ``fused`` layout: ``{"trainer":
        state_tree(state)}``."""
        return {"trainer": state_tree(self.state)}

    def restore_states(self, tree: Dict[str, Any]) -> None:
        """Restore :meth:`export_states`'s tree in place (each leaf in its
        saved dtype, the schedule's count with it)."""
        restore_state(self.state, tree["trainer"])
