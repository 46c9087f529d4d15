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
Python loop over the leading step axis. CUDA graphs over the step come
later. The state is updated in place.

Config values the port cannot run yet raise ``NotImplementedError``
naming the ROADMAP item that brings them (:func:`check_supported`).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.runtime.state import (
    TrainState, check_config, init_params, leaves_of, make_state, make_tx)
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for every value the fused trainer
    cannot run: a transport other than ``fused`` (the two-party path is
    ``SplitClientTrainer`` over ``LocalTransport`` or ``HttpTransport``),
    and
    :func:`~split_learning_tpu_torch.runtime.state.check_config`."""
    if cfg.transport != "fused":
        raise NotImplementedError(
            f"not ported yet: transport {cfg.transport!r} in the fused "
            "trainer (the two-party path, ROADMAP items 8-12, is "
            "SplitClientTrainer over LocalTransport or HttpTransport)")
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
        self.plan = plan
        self.cfg = cfg
        self._tx = make_tx(cfg)
        self.state: TrainState = make_state(
            init_params(plan, init, self.device), self._tx)

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

    def train_step_async(self, x, y) -> torch.Tensor:
        """One step; returns the loss as a device scalar, with no host sync."""
        x, y = self._to_device(x, y)
        loss, grads = self._loss_and_grads(x, y)
        # cuDNN returns the conv weight grads in channels_last when its input
        # is channels_last; the SGD kernel walks each leaf in its params'
        # (contiguous) order
        self._tx.update(self.state, [g.contiguous() for g in grads])
        return loss

    def train_step(self, x, y) -> float:
        """One step on the batch; returns the loss as a Python float."""
        return float(self.train_step_async(x, y))

    def train_epoch(self, xs, ys) -> torch.Tensor:
        """Run ``xs.shape[0]`` steps; returns the per-step loss series
        (a device tensor, not synchronised)."""
        xs, ys = self._to_device(xs, ys)
        return torch.stack([self.train_step_async(xs[i], ys[i])
                            for i in range(xs.shape[0])])

    @property
    def params(self) -> Tuple[Params, ...]:
        return self.state.params
