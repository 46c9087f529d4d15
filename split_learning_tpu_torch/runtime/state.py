"""Training state and the optimizer (counterpart of ``split_learning_tpu/runtime/state.py``).

The JAX state is an immutable pytree threaded through pure steps. Here
:class:`TrainState` holds the live tensors, and the optimizer updates
the parameters and the momentum trace **in place** (under
``torch.no_grad``) through the fused SGD kernel.

Only what the fused trainer runs is ported: constant-lr SGD with
optional momentum, with optax.trace semantics and a zero-initialised
trace (m <- mu*m + g; p <- p - lr*m). Schedules, coupled L2, adam/adamw
and clipping raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from split_learning_tpu_torch.core.stage import Params
from split_learning_tpu_torch.ops.sgd import fused_sgd_step, init_trace

OPTIMIZER_ITEM = "ROADMAP item 10"


def leaves_of(params: Sequence[Params]) -> List[torch.Tensor]:
    """Every parameter tensor, in stage order then dict order."""
    return [t for stage in params for t in stage.values()]


@dataclasses.dataclass
class TrainState:
    """Live training state: per-stage params, momentum trace, step count.

    ``trace`` is one tensor per leaf of ``leaves_of(params)``, or None
    without momentum."""

    params: Tuple[Params, ...]
    trace: Optional[List[torch.Tensor]]
    step: int = 0


class SGD:
    """Constant-lr SGD with optional momentum, applied in place."""

    def __init__(self, lr: float, momentum: float = 0.0) -> None:
        self.lr = float(lr)
        self.momentum = float(momentum)

    def init(self, leaves: Sequence[torch.Tensor]
             ) -> Optional[List[torch.Tensor]]:
        return init_trace(leaves) if self.momentum else None

    def update(self, state: TrainState,
               grads: Sequence[torch.Tensor]) -> None:
        """Apply ``grads`` to ``state`` in place and count the step."""
        fused_sgd_step(leaves_of(state.params), grads, state.trace,
                       self.lr, self.momentum)
        state.step += 1


def sgd(lr: float, momentum: float = 0.0) -> SGD:
    """The reference's optimizer: SGD(lr=0.01), no momentum by default."""
    return SGD(lr, momentum)


def make_lr(cfg) -> float:
    """The learning rate from Config: a constant (schedules not ported)."""
    if cfg.warmup_steps or cfg.decay_steps:
        raise NotImplementedError(
            "lr warmup/decay schedules are not ported yet "
            f"({OPTIMIZER_ITEM})")
    return cfg.lr


def make_tx(cfg) -> SGD:
    """Optimizer from Config: plain (momentum-)SGD at a constant lr."""
    if cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet "
            f"({OPTIMIZER_ITEM})")
    if cfg.weight_decay or cfg.grad_clip_norm:
        raise NotImplementedError(
            "weight_decay and grad_clip_norm are not ported yet "
            f"({OPTIMIZER_ITEM})")
    return sgd(make_lr(cfg), cfg.momentum)


def make_state(params: Sequence[Params], tx: SGD) -> TrainState:
    params = tuple(params)
    return TrainState(params=params, trace=tx.init(leaves_of(params)))
