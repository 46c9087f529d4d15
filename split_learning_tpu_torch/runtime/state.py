"""Training state and the optimizer (counterpart of ``split_learning_tpu/runtime/state.py``).

The JAX state is an immutable pytree threaded through pure steps. Here
:class:`TrainState` holds the live tensors, and the optimizer updates
the parameters and the momentum trace **in place** (under
``torch.no_grad``) through the fused SGD kernel.

Only what the trainers run is ported: constant-lr SGD with optional
momentum, with optax.trace semantics and a zero-initialised trace
(m <- mu*m + g; p <- p - lr*m). Schedules, coupled L2, adam/adamw and
clipping raise ``NotImplementedError`` naming the ROADMAP item.

Beside it, what every trainer and party shares: :func:`check_config`,
the Config values the port cannot run yet, and :func:`init_params`, a
party's own stages from a seed or from given per-stage dicts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
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


def check_config(cfg) -> None:
    """Raise ``NotImplementedError`` for every Config value (other than
    the transport, which each trainer checks) the port cannot run."""
    unsupported = [
        (cfg.num_clients > 1,
         "num_clients > 1 (data-parallel mesh: ROADMAP item 18)"),
        (cfg.model_parallel > 1,
         "model_parallel > 1 (tensor parallelism: ROADMAP item 18)"),
        (cfg.seq_parallel > 1,
         "seq_parallel > 1 (context parallelism: ROADMAP item 21)"),
        (cfg.remat, "remat (ROADMAP item 16)"),
        (cfg.dtype != "float32",
         f"dtype {cfg.dtype!r} (mixed precision: ROADMAP item 14)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")
    make_tx(cfg)  # optimizer, schedule, weight decay and clipping checks


def init_params(plan: SplitPlan,
                init: Union[torch.Generator, Sequence[Params]],
                device: torch.device,
                stages: Optional[Sequence[int]] = None
                ) -> Tuple[Params, ...]:
    """The parameters of ``stages`` (default: all), as float32 leaves on
    ``device`` that require grad.

    ``init`` is a ``torch.Generator``, from which the whole plan is drawn
    on the CPU (so each party, keeping only its own stages, starts where
    a one-process run from the same seed would, as the JAX parties do
    from one PRNG key), or per-stage dicts for every stage of the plan,
    e.g. the JAX init carried over with
    :func:`split_learning_tpu_torch.interop.params_from_jax`."""
    if isinstance(init, torch.Generator):
        params = plan.init(init, torch.zeros(1))
    else:
        params = tuple(init)
        if len(params) != plan.num_stages:
            raise ValueError(f"expected {plan.num_stages} per-stage param "
                             f"dicts, got {len(params)}")
    keep = range(plan.num_stages) if stages is None else stages
    return tuple(
        {k: torch.as_tensor(v).detach().to(device, torch.float32).clone()
         .requires_grad_(True) for k, v in params[i].items()}
        for i in keep)
