"""Stage abstraction (counterpart of ``split_learning_tpu/core/stage.py``).

A model is an ordered sequence of stages; the "full model" is their
composition, so split and monolithic training run the same functions on
the same parameters. As in the JAX package, a stage's parameters live
outside it: ``apply(params, x)`` runs the stage's ``nn.Module`` with
``params`` (a ``{name: tensor}`` dict, the module's ``state_dict`` keys)
through ``torch.func.functional_call``. The module itself is built on
the ``meta`` device and only describes the architecture.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

Params = Dict[str, torch.Tensor]

# flax's lecun_normal draws a normal truncated to +-2 std and rescales it
# by this constant (the std of a standard normal truncated to [-2, 2]), so
# that the kept values have variance exactly 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _draw(module: nn.Module, name: str, shape, generator: torch.Generator
          ) -> torch.Tensor:
    """One leaf of ``module`` (parameter ``name``) with flax's default."""
    t = torch.empty(shape, dtype=torch.float32)
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return t.fill_(1.0 if name == "weight" else 0.0)
    if isinstance(module, nn.Embedding):
        # default_embed_init: variance_scaling(1, "fan_in", "normal",
        # out_axis=0), whose fan_in for a [vocab, dim] table is dim
        return t.normal_(0.0, math.sqrt(1.0 / shape[1]), generator=generator)
    if name == "bias":
        return t.zero_()
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        fan_in = math.prod(shape[1:])
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        return nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std,
                                     b=2.0 * std, generator=generator)
    # a raw parameter (the transformer's positional table):
    # initializers.normal(0.02)
    return t.normal_(0.0, 0.02, generator=generator)


def flax_like_init(module: nn.Module, generator: torch.Generator) -> Params:
    """Fresh parameters with flax's default distributions.

    Dense and conv weights: lecun_normal (truncated normal, variance
    1 / fan_in, where fan_in is the weight's size over its output
    dimension; the ViT's patch conv: ``patch * patch * channels``);
    biases zero. LayerNorm and GroupNorm: scale 1, bias 0. Embedding
    tables: normal with variance 1 / dim. A raw parameter (the
    transformer's and the ViT's ``pos`` table): normal(0.02). Drawn on
    the CPU from ``generator`` in ``named_parameters`` order, in float32,
    then cast to the parameter's own dtype (float32 but for ``pos`` in a
    bf16 plan, which flax creates in the plan dtype). The bits cannot
    match JAX's PRNG; parity tests carry JAX parameters across instead
    (:mod:`split_learning_tpu_torch.interop`).
    """
    params: Params = {}
    for prefix, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            params[key] = _draw(mod, name, p.shape, generator).to(p.dtype)
    return params


@dataclasses.dataclass(frozen=True, eq=False)
class Stage:
    """One differentiable segment of a split model.

    ``apply`` is safe from concurrent threads (clients of one plan in a
    thread pool, HTTP handlers): ``functional_call`` swaps the given
    parameters into the shared module for the call, so calls of one
    stage hold its lock for the forward. The graph a forward records
    holds the tensors themselves, so backward passes run unlocked."""

    name: str
    module: nn.Module  # architecture only (meta device); params live outside
    _lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    def init(self, generator: torch.Generator, sample: torch.Tensor
             ) -> Params:
        """Fresh parameters on ``sample``'s device."""
        return {k: v.to(sample.device)
                for k, v in flax_like_init(self.module, generator).items()}

    def apply(self, params: Params, x: torch.Tensor, **kw):
        """Run the module with ``params``. Keyword arguments pass through
        to its ``forward``, as ``from_flax`` passes them to
        ``module.apply``: the transformer stages take their KV-cache
        modes this way (``cache_len=``/``decode_cache=``/``pos=``)."""
        with self._lock:
            return torch.func.functional_call(self.module, params, (x,), kw)


def stage_backward(stage: Stage, params: Params, x: torch.Tensor,
                   g_out: torch.Tensor, input_grad: bool = False):
    """Rematerialised backward through one stage: re-run the forward on
    detached copies of ``params`` and pull the transported cotangent
    ``g_out`` through it with ``torch.autograd.backward``. Returns the
    parameter gradients, keyed like ``params``; with ``input_grad`` the
    pair ``(parameter gradients, gradient of x)``, as the U-shaped
    server's ``u_backward`` needs (JAX's ``jax.vjp`` over both)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    x_in = x.detach()
    if input_grad:
        x_in.requires_grad_(True)
    with torch.enable_grad():
        y = stage.apply(leaves, x_in)
        torch.autograd.backward(y, g_out)
    grads = {k: v.grad for k, v in leaves.items()}
    return (grads, x_in.grad) if input_grad else grads


@dataclasses.dataclass(frozen=True, eq=False)
class SplitPlan:
    """An ordered pipeline of stages plus the ownership split.

    ``owners[i]`` is the party owning stage i ("client" or "server"):
    ("client", "server") for the classic split, ("client", "server",
    "client") for the U-shape."""

    stages: Tuple[Stage, ...]
    owners: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.stages) != len(self.owners):
            raise ValueError("stages and owners must have equal length")
        for o in self.owners:
            if o not in ("client", "server"):
                raise ValueError(f"unknown owner {o!r}")

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def stages_of(self, owner: str) -> Tuple[int, ...]:
        return tuple(i for i, o in enumerate(self.owners) if o == owner)

    def init(self, generator: torch.Generator, sample: torch.Tensor
             ) -> Tuple[Params, ...]:
        """Initialise every stage from one generator, in stage order."""
        return tuple(stage.init(generator, sample) for stage in self.stages)

    def apply(self, params: Sequence[Params], x: torch.Tensor) -> torch.Tensor:
        """Monolithic forward = composition of all stages."""
        if len(params) != self.num_stages:
            raise ValueError(
                f"expected {self.num_stages} per-stage param dicts, "
                f"got {len(params)}")
        for stage, p in zip(self.stages, params):
            x = stage.apply(p, x)
        return x

    def apply_range(self, params: Sequence[Params], x: torch.Tensor,
                    start: int, stop: Optional[int] = None) -> torch.Tensor:
        """Run stages [start, stop): one party's contiguous span."""
        stop = self.num_stages if stop is None else stop
        for i in range(start, stop):
            x = self.stages[i].apply(params[i], x)
        return x
