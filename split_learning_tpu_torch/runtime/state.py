"""Training state and the optimizer (counterpart of
``split_learning_tpu/runtime/state.py``).

The JAX state is an immutable pytree threaded through pure steps. Here
:class:`TrainState` holds the live tensors, and the optimizer updates
the parameters and its own state **in place** (under ``torch.no_grad``).

:func:`make_tx` builds what the JAX ``make_tx`` builds, as optax computes
it, from the same Config fields:

- ``sgd``: optax.sgd with optional momentum, and coupled L2
  (``weight_decay``: ``g + wd * p`` ahead of the trace). The update is
  the fused SGD kernel (K2, ``ops/sgd.py``): one launch a step over
  every leaf. It mirrors JAX's Pallas ``fused_sgd_step``, whose trace is
  float32 for every leaf and which updates a bfloat16 leaf in float32;
  optax's own trace takes the leaf's dtype, so the two differ on a
  bfloat16 leaf only, by the rounding of its trace.
- ``adam`` and ``adamw``: optax.adam / optax.adamw (b1 0.9, b2 0.999,
  eps 1e-8; adamw's decoupled ``+ wd * p`` on every leaf, before the lr
  scale), with moments in each leaf's dtype, as optax keeps them. Plain
  PyTorch ``_foreach`` arithmetic, grouped by dtype; no kernel (the JAX
  package computes adam in optax/XLA too).
- the learning rate of :func:`make_lr`: constant, linear warmup then
  constant, or linear warmup then cosine decay to 0 at ``decay_steps``,
  read at optax's count (0 at the first update, so a warmup's first lr
  is 0) and computed in float32 as optax's schedule computes it;
- ``grad_clip_norm``: optax.clip_by_global_norm, first in the chain, over
  the leaves this optimizer updates: the whole model in the fused
  trainer, each party's own stages in the two-party runtimes.

Scalars meet a bfloat16 leaf rounded to bfloat16 first, as JAX's weak
types do, and every operation rounds to the leaf's dtype. XLA may keep
excess precision between fused operations, so a bfloat16 leaf agrees
with optax within an ulp, not bit for bit. Under ``jit`` XLA also turns
the schedule's division by a constant into a multiplication by its
reciprocal: :func:`make_lr` follows the schedule as optax writes it
(bit for bit with optax called eagerly).

Beside it, what every trainer and party shares: :func:`check_config`,
the Config values the port cannot run yet, :func:`init_params`, a
party's own stages from a seed or from given per-stage dicts, and the
parameter averaging of the federated server and the multi-client runner:
:func:`fedavg_mean` (JAX's, dtype rule included) and
:func:`compressed_sync_contribution` (a party's topk8 delta through the
wire codec, on the card for CUDA leaves); and the checkpoint form of a
state, :func:`state_tree` (a tree ``torch.load(weights_only=True)``
reads back) and :func:`restore_state` (back in place, each leaf in the
dtype it was saved in, the schedule's count with them).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.ops.sgd import fused_sgd_step, init_trace
from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, tp_leaf_sharding)
from split_learning_tpu_torch.parallel.tensor import ShardedParam
from split_learning_tpu_torch.utils.arrays import from_host, tree_map

_F32 = np.float32
LR = Union[float, Callable[[int], float]]


def leaves_of(params: Sequence[Params]) -> List[torch.Tensor]:
    """Every parameter tensor, in stage order then dict order; a leaf on
    a mesh (:class:`~split_learning_tpu_torch.parallel.tensor.
    ShardedParam`) gives the tensors its ops read, its shards."""
    out: List[torch.Tensor] = []
    for stage in params:
        for t in stage.values():
            if isinstance(t, ShardedParam):
                out.extend(t.leaves())
            else:
                out.append(t)
    return out


@dataclasses.dataclass
class TrainState:
    """Live training state: per-stage params, the optimizer's state and
    the step count (optax's count: the updates taken so far).

    ``opt_state`` is what the optimizer's ``init`` returned: the momentum
    trace (one float32 tensor per leaf of ``leaves_of(params)``) or None
    for SGD, the moment lists ``(mu, nu)`` for adam/adamw."""

    params: Tuple[Params, ...]
    opt_state: Any
    step: int = 0


# --------------------------------------------------------------------- #
# learning-rate schedules, in float32 as optax computes them
# --------------------------------------------------------------------- #
def _linear(count: int, init: float, end: float, steps: int) -> _F32:
    """optax.linear_schedule (polynomial, power 1)."""
    if steps <= 0:
        return _F32(init)
    frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
    return _F32(init - end) * frac + _F32(end)


def _cosine(count: int, init: float, steps: int) -> _F32:
    """optax.cosine_decay_schedule with alpha 0, exponent 1. The cosine
    of the float32 argument, correctly rounded, is what XLA's float32
    cosine gives."""
    x = _F32(math.pi) * _F32(min(count, steps)) / _F32(steps)
    decay = _F32(0.5) * (_F32(1) + _F32(math.cos(float(x))))
    return _F32(init) * (_F32(1.0) * decay + _F32(0.0))


class Schedule:
    """The lr at optax's count: linear warmup from 0 over ``warmup``
    steps, then the constant ``lr`` (``decay`` 0) or a cosine decay to 0
    by step ``decay``, which counts the warmup (``warmup_cosine_decay_
    schedule(0, lr, warmup, decay, 0)``)."""

    def __init__(self, lr: float, warmup: int, decay: int = 0) -> None:
        self.lr, self.warmup, self.decay = float(lr), int(warmup), int(decay)

    def __call__(self, count: int) -> float:
        count = int(count)
        if count < self.warmup:
            value = _linear(count, 0.0, self.lr, self.warmup)
        elif self.decay:
            value = _cosine(count - self.warmup, self.lr,
                            self.decay - self.warmup)
        else:
            value = _F32(self.lr)
        return float(value)


def make_lr(cfg) -> LR:
    """Learning rate from Config: the constant ``lr``, or a
    :class:`Schedule` (linear warmup over ``warmup_steps``, then constant
    or, with ``decay_steps``, cosine decay to 0 by that total step)."""
    if not (cfg.warmup_steps or cfg.decay_steps):
        return cfg.lr
    return Schedule(cfg.lr, cfg.warmup_steps, cfg.decay_steps)


# --------------------------------------------------------------------- #
# the optimizers
# --------------------------------------------------------------------- #
def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a weak-typed scalar meets a leaf."""
    if dtype == torch.float32:
        return float(_F32(x))
    return float(torch.tensor(x, dtype=torch.float32).to(dtype).float())


def _by_dtype(tensors: Sequence[torch.Tensor]
              ) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _pick(seq: Sequence[Any], idx: Sequence[int]) -> List[Any]:
    return [seq[i] for i in idx]


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place and without a host sync: every
    gradient becomes ``g / norm * max_norm`` when the global norm is not
    below ``max_norm``, else stays as it is (a division and a product by
    1). Each leaf's sum of squares is rounded to its dtype, as optax's
    ``jnp.sum`` of a bfloat16 leaf is, and the sums add in float32.
    Gradients may lie on several devices (the stages of a pipeline):
    the sums add on the first one's."""
    groups: Dict[Tuple[torch.device, torch.dtype], List[int]] = {}
    for i, g in enumerate(grads):
        groups.setdefault((g.device, g.dtype), []).append(i)
    total = None
    for (_, dtype), idx in groups.items():
        norms = torch._foreach_norm(_pick(grads, idx), 2,
                                    dtype=torch.float32)
        sq = torch.stack(norms).square().to(dtype).float().sum()
        total = sq if total is None else total + sq.to(total.device)
    norm = total.sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    den = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for (dev, dtype), idx in groups.items():
        part = _pick(grads, idx)
        torch._foreach_div_(part, den.to(dev, dtype))
        torch._foreach_mul_(part, mul.to(dev, dtype))


class _Optimizer:
    """Clipping and the schedule, shared by both update rules."""

    def __init__(self, lr: LR, grad_clip_norm: float = 0.0) -> None:
        self.lr = lr
        self.grad_clip_norm = float(grad_clip_norm)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates."""
        return self.lr(count) if callable(self.lr) else float(self.lr)

    def init(self, leaves: Sequence[torch.Tensor]) -> Any:
        raise NotImplementedError

    def _apply(self, state: TrainState, leaves: List[torch.Tensor],
               grads: List[torch.Tensor], lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, state: Union[TrainState, "ShardedState"],
               grads: Sequence[torch.Tensor], clip: bool = True) -> None:
        """Apply ``grads`` to ``state`` in place and count the step. The
        gradients are this step's own: clipping scales them in place.
        A :class:`ShardedState` takes gradients in ``leaves_of`` order of
        its parameters (:meth:`ShardedState.update`)."""
        if isinstance(state, ShardedState):
            state.update(self, grads)
            return
        leaves = leaves_of(state.params)
        grads = list(grads)
        if len(grads) != len(leaves):
            raise ValueError("one gradient per parameter leaf")
        if clip and self.grad_clip_norm:
            clip_by_global_norm(grads, self.grad_clip_norm)
        self._apply(state, leaves, grads, self.lr_at(state.step))
        state.step += 1


class SGD(_Optimizer):
    """optax.sgd (+ coupled L2) through the fused SGD kernel."""

    def __init__(self, lr: LR, momentum: float = 0.0,
                 weight_decay: float = 0.0,
                 grad_clip_norm: float = 0.0) -> None:
        super().__init__(lr, grad_clip_norm)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)

    def init(self, leaves: Sequence[torch.Tensor]
             ) -> Optional[List[torch.Tensor]]:
        return init_trace(leaves) if self.momentum else None

    def _apply(self, state, leaves, grads, lr) -> None:
        if self.weight_decay:
            # optax.add_decayed_weights ahead of the trace: g + wd * p
            for dtype, idx in _by_dtype(leaves).items():
                decayed = torch._foreach_mul(
                    _pick(leaves, idx), _in_dtype(self.weight_decay, dtype))
                torch._foreach_add_(_pick(grads, idx), decayed)
        fused_sgd_step(leaves, grads, state.opt_state, lr, self.momentum)


class Adam(_Optimizer):
    """optax.adam, or optax.adamw with ``weight_decay`` (decoupled)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr: LR, weight_decay: float = 0.0,
                 grad_clip_norm: float = 0.0) -> None:
        super().__init__(lr, grad_clip_norm)
        self.weight_decay = float(weight_decay)

    def init(self, leaves: Sequence[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return ([torch.zeros_like(p) for p in leaves],
                [torch.zeros_like(p) for p in leaves])

    def _apply(self, state, leaves, grads, lr) -> None:
        mu_all, nu_all = state.opt_state
        count = state.step + 1
        # 1 - b**count in float32; each leaf divides by it in its dtype
        bc1 = float(_F32(1) - _F32(self.B1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(self.B2) ** _F32(count))
        groups: Dict[Tuple[torch.dtype, torch.dtype], List[int]] = {}
        for i, p in enumerate(leaves):
            groups.setdefault((p.dtype, mu_all[i].dtype), []).append(i)
        for (dtype, m_dtype), idx in groups.items():
            c = lambda x: _in_dtype(x, dtype)  # noqa: E731
            p, g = _pick(leaves, idx), _pick(grads, idx)
            mu, nu = _pick(mu_all, idx), _pick(nu_all, idx)
            # mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
            g1 = torch._foreach_mul(g, c(1 - self.B1))
            torch._foreach_mul_(mu, _in_dtype(self.B1, m_dtype))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, c(1 - self.B2))
            torch._foreach_mul_(nu, _in_dtype(self.B2, m_dtype))
            if m_dtype != dtype:
                # the moments of a leaf whose dtype an adopted FedAvg
                # mean changed (bfloat16 to float32): optax takes b * m
                # in the moment's dtype and the sum promotes, so from
                # this update on the moments are in the leaf's dtype
                mu = [m.to(dtype) for m in mu]
                nu = [m.to(dtype) for m in nu]
                for j, i in enumerate(idx):
                    mu_all[i], nu_all[i] = mu[j], nu[j]
            torch._foreach_add_(mu, g1)
            torch._foreach_add_(nu, g2)
            # u = mu_hat / (sqrt(nu_hat) + eps)
            den = torch._foreach_div(nu, c(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c(self.EPS))
            u = torch._foreach_div(mu, c(bc1))
            torch._foreach_div_(u, den)
            if self.weight_decay:
                torch._foreach_add_(
                    u, torch._foreach_mul(p, c(self.weight_decay)))
            torch._foreach_mul_(u, c(-lr))
            torch._foreach_add_(p, u)


def sgd(lr: LR, momentum: float = 0.0) -> SGD:
    """The reference's optimizer: SGD(lr=0.01), no momentum by default."""
    return SGD(lr, momentum)


def make_tx(cfg) -> _Optimizer:
    """Optimizer from Config, the one construction site every trainer
    shares (JAX's ``make_tx``): ``sgd`` with momentum and coupled L2,
    ``adam``, or ``adamw`` with decoupled weight decay, each at the lr
    of :func:`make_lr` and behind ``grad_clip_norm``'s clipping."""
    lr = make_lr(cfg)
    if cfg.optimizer == "sgd":
        return SGD(lr, cfg.momentum, cfg.weight_decay, cfg.grad_clip_norm)
    if cfg.optimizer == "adam":
        return Adam(lr, 0.0, cfg.grad_clip_norm)
    if cfg.optimizer == "adamw":
        return Adam(lr, cfg.weight_decay, cfg.grad_clip_norm)
    raise ValueError(f"Unknown optimizer: {cfg.optimizer!r}")


def make_state(params: Sequence[Params], tx: _Optimizer) -> TrainState:
    params = tuple(params)
    return TrainState(params=params, opt_state=tx.init(leaves_of(params)))


class ShardedState:
    """A training state laid out on a mesh (JAX's ``SpecLayout.state``
    placement of a ``TrainState``): per ``data`` row in ``rows`` and
    ``model`` rank, a :class:`TrainState` of that rank's own leaves on
    its device. A leaf :func:`~split_learning_tpu_torch.parallel.mesh.
    tp_leaf_sharding` splits is a slice there, every other leaf a whole
    copy; the optimizer's state (momentum trace, Adam moments) is made
    from those leaves, so it shards with its weights, and every rank
    counts the step.

    :attr:`params` is the view the models run: per stage ``{name:
    ShardedParam}`` (:mod:`split_learning_tpu_torch.parallel.tensor`),
    whose ops run on each rank's leaves; ``leaves_of`` of it gives the
    tensors to differentiate. :meth:`update` takes their gradients in
    that order and updates each rank in place, one optimizer call (one
    K2 launch under SGD) a rank. :meth:`whole` and :meth:`load` carry the
    state through a checkpoint as whole leaves, so a save restores onto
    any mesh. Over a ``seq`` axis the fused trainer keeps the state (this
    one, or a plain :class:`TrainState`) on seq coordinate 0 and each
    step hands every seq rank its copy of the leaves through
    ``parallel/tensor.py`` ``seq_view``, whose backward sums the seq
    ranks' gradients into these leaves: JAX's replication over ``seq``,
    updated once a rank here."""

    def __init__(self, params: Sequence[Params], tx: "_Optimizer",
                 mesh: Mesh, rows: Optional[Sequence[int]] = None) -> None:
        self.mesh = mesh
        self.rows = (list(range(mesh.shape.get(DATA_AXIS, 1)))
                     if rows is None else [int(r) for r in rows])
        self.n_model = int(mesh.shape.get(MODEL_AXIS, 1))
        self.devices = [mesh.axis_devices(MODEL_AXIS, **{DATA_AXIS: d})
                        for d in self.rows]
        self.dims = tuple({k: tp_leaf_sharding(mesh, v, k).dim
                           for k, v in stage.items()} for stage in params)
        self.ranks: List[List[TrainState]] = [
            [make_state(tuple(
                {k: self._piece(v, dims[k], m).detach().to(dev).clone()
                 .requires_grad_(True) for k, v in stage.items()}
                for stage, dims in zip(params, self.dims)), tx)
             for m, dev in enumerate(devs)]
            for devs in self.devices]
        self._view: Optional[Tuple[Dict[str, ShardedParam], ...]] = None

    def _piece(self, t: Any, dim: Optional[int], m: int) -> torch.Tensor:
        t = torch.as_tensor(t)
        return t if dim is None else t.chunk(self.n_model, dim)[m]

    @property
    def _flat_dims(self) -> List[Optional[int]]:
        return [d for stage in self.dims for d in stage.values()]

    @property
    def params(self) -> Tuple[Dict[str, ShardedParam], ...]:
        """Per stage ``{name: ShardedParam}`` over the ranks' live
        leaves; the same objects until :meth:`load` replaces leaves."""
        if self._view is None:
            self._view = tuple(
                {k: ShardedParam([[st.params[i][k] for st in row]
                                  for row in self.ranks], dims[k])
                 for k in dims}
                for i, dims in enumerate(self.dims))
        return self._view

    @property
    def step(self) -> int:
        return self.ranks[0][0].step

    @step.setter
    def step(self, value: int) -> None:
        for row in self.ranks:
            for st in row:
                st.step = int(value)

    @torch.no_grad()
    def update(self, tx: "_Optimizer", grads: Sequence[torch.Tensor]
               ) -> None:
        """One update from ``grads`` (``leaves_of(self.params)`` order):
        each leaf's gradient summed over the ``data`` rows (each row's
        share of the batch's loss), clipped over the global norm with
        every split leaf and every replicated leaf counted once, then
        applied on every row and rank to its own leaves. A replicated
        leaf's copies take the same gradient, so they stay equal."""
        it = iter(grads)
        n_rows = len(self.rows)
        per_leaf: List[List[torch.Tensor]] = []   # per leaf, per rank
        for dim in self._flat_dims:
            width = 1 if dim is None else self.n_model
            gs = [[next(it) for _ in range(width)] for _ in range(n_rows)]
            summed = []
            for m in range(width):
                acc = gs[0][m]
                for row in gs[1:]:
                    acc = acc + row[m].to(acc.device)
                summed.append(acc)
            per_leaf.append(summed)
        if next(it, None) is not None:
            raise ValueError("one gradient per sharded parameter leaf")
        if tx.grad_clip_norm:
            clip_by_global_norm([g for gs in per_leaf for g in gs],
                                tx.grad_clip_norm)
        for ri, row in enumerate(self.ranks):
            for m, st in enumerate(row):
                g_rm = []
                for gs, live in zip(per_leaf, leaves_of(st.params)):
                    g = gs[m] if len(gs) > 1 else gs[0]
                    # a copy for every rank but the gradient's own, so
                    # no two ranks' updates share a tensor
                    own = ri == 0 and (len(gs) > 1 or m == 0)
                    g_rm.append(g.contiguous() if own
                                else g.to(live.device, copy=True))
                tx.update(st, g_rm, clip=False)

    def whole(self) -> TrainState:
        """The first row's state with whole leaves on the host: each
        split leaf's shards (and its optimizer mirrors') concatenated in
        rank order, a replicated leaf's first copy."""
        ranks = self.ranks[0]
        flat = self._flat_dims

        def cat(ts: Sequence[torch.Tensor], dim: Optional[int]
                ) -> torch.Tensor:
            ts = [t.detach().cpu() for t in ts]
            return ts[0].clone() if dim is None else torch.cat(ts, dim)

        params = tuple(
            {k: cat([st.params[i][k] for st in ranks], dims[k])
             for k in dims} for i, dims in enumerate(self.dims))
        opt = ranks[0].opt_state

        def mirrors(pick: Callable[[TrainState], List[torch.Tensor]]
                    ) -> List[torch.Tensor]:
            return [cat([pick(st)[idx] for st in ranks], dim)
                    for idx, dim in enumerate(flat)]

        if opt is None:
            whole_opt = None
        elif isinstance(opt, tuple):
            whole_opt = (mirrors(lambda st: st.opt_state[0]),
                         mirrors(lambda st: st.opt_state[1]))
        else:
            whole_opt = mirrors(lambda st: st.opt_state)
        return TrainState(params=params, opt_state=whole_opt,
                          step=ranks[0].step)

    def load(self, tree: Dict[str, Any]) -> None:
        """Restore a whole :func:`state_tree` onto every row and rank: each
        split leaf and mirror cut to the rank's slice."""
        def cut(stages: Sequence[Dict[str, Any]], m: int
                ) -> List[Dict[str, torch.Tensor]]:
            return [{k: self._piece(v, dims[k], m) for k, v in st.items()}
                    for st, dims in zip(stages, self.dims)]

        opt = tree["opt_state"]
        for row in self.ranks:
            for m, st in enumerate(row):
                sub_opt = (None if opt is None else
                           {key: cut(val, m) for key, val in opt.items()})
                restore_state(st, {"params": cut(tree["params"], m),
                                   "opt_state": sub_opt,
                                   "step": tree["step"]})
        self._view = None

    def adopt(self, params: Sequence[Params]) -> None:
        """Make the whole ``params`` (a FedAvg mean) the live leaves of
        every row and rank, each rank its slice (see
        :func:`adopt_params`)."""
        for devs, row in zip(self.devices, self.ranks):
            for m, (dev, st) in enumerate(zip(devs, row)):
                st.params = tuple(
                    {k: self._piece(_as_leaf_tensor(new[k]), dims[k], m)
                     .to(dev, copy=True).requires_grad_(True)
                     for k in live}
                    for live, new, dims in zip(st.params, params,
                                               self.dims))
        self._view = None

    def rank_bytes(self) -> List[List[int]]:
        """Parameter bytes held by each row's ranks (by rank, not by
        device: virtual ranks share one)."""
        return [[sum(t.numel() * t.element_size()
                     for t in leaves_of(st.params)) for st in row]
                for row in self.ranks]


def _per_stage(params: Sequence[Params], flat: Sequence[torch.Tensor]
               ) -> List[Dict[str, torch.Tensor]]:
    """A list in ``leaves_of(params)`` order as one dict per stage,
    keyed as the parameters are."""
    it = iter(flat)
    return [{k: next(it) for k in stage} for stage in params]


def state_tree(state: Union[TrainState, "ShardedState"]
               ) -> Dict[str, Any]:
    """``state`` as a tree ``torch.load(weights_only=True)`` reads back:
    ``{"params": [one dict per stage], "opt_state": ..., "step": int}``.
    The optimizer's state is None (SGD without momentum), ``{"trace":
    [...]}`` (the momentum trace) or ``{"mu": [...], "nu": [...]}``
    (adam/adamw), each a dict per stage keyed by parameter name. The
    tensors are the live ones: :class:`~split_learning_tpu_torch.runtime.
    checkpoint.Checkpointer` snapshots them. A :class:`ShardedState`
    gives its whole leaves (:meth:`ShardedState.whole`)."""
    if isinstance(state, ShardedState):
        state = state.whole()
    params = [dict(stage) for stage in state.params]
    opt = state.opt_state
    if opt is None:
        opt_tree = None
    elif isinstance(opt, tuple):
        opt_tree = {"mu": _per_stage(state.params, opt[0]),
                    "nu": _per_stage(state.params, opt[1])}
    else:
        opt_tree = {"trace": _per_stage(state.params, opt)}
    return {"params": params, "opt_state": opt_tree, "step": int(state.step)}


def _restore_leaf(live: torch.Tensor, saved: torch.Tensor, what: str,
                  grad: bool) -> torch.Tensor:
    """``saved`` in ``live``'s place: copied into it when the dtypes
    agree, else a new tensor of the saved dtype on its device (a bf16
    leaf a weighted FedAvg round made float32 stays float32)."""
    saved = torch.as_tensor(saved)
    if tuple(saved.shape) != tuple(live.shape):
        raise ValueError(f"{what}: saved shape {tuple(saved.shape)}, live "
                         f"{tuple(live.shape)}")
    if saved.dtype == live.dtype:
        with torch.no_grad():
            live.copy_(saved)
        return live
    return saved.to(live.device).clone().requires_grad_(grad)


def restore_state(state: Union[TrainState, "ShardedState"],
                  tree: Dict[str, Any]) -> None:
    """Restore a :func:`state_tree` into ``state`` in place: every
    parameter and moment keeps the dtype it was saved in, and the step
    count (optax's count, which the lr schedule and Adam's bias
    correction read) comes back with them. A tree of another model or
    optimizer raises ``ValueError``. A :class:`ShardedState` takes the
    whole tree and splits it onto its ranks (:meth:`ShardedState.load`)."""
    if isinstance(state, ShardedState):
        state.load(tree)
        return
    saved_params = list(tree["params"])
    if len(saved_params) != len(state.params) or any(
            set(s) != set(live)
            for s, live in zip(saved_params, state.params)):
        raise ValueError(
            "checkpoint parameters do not match this model: saved "
            f"{[sorted(s) for s in saved_params]}, live "
            f"{[sorted(live) for live in state.params]}")
    for i, (live, saved) in enumerate(zip(state.params, saved_params)):
        for k in live:
            live[k] = _restore_leaf(live[k], saved[k], f"params[{i}].{k}",
                                    True)
    opt, saved_opt = state.opt_state, tree["opt_state"]
    kind = (None if opt is None else "adam" if isinstance(opt, tuple)
            else "trace")
    saved_kind = (None if saved_opt is None else
                  "adam" if "mu" in saved_opt else "trace")
    if kind != saved_kind:
        raise ValueError(f"checkpoint optimizer state is {saved_kind!r}, "
                         f"this optimizer's is {kind!r}")

    def refill(flat: List[torch.Tensor], stages: Sequence[Dict[str, Any]],
               what: str) -> None:
        saved_flat = [stage[k] for stage, live in zip(stages, state.params)
                      for k in live]
        for j, s in enumerate(saved_flat):
            flat[j] = _restore_leaf(flat[j], s, f"{what}[{j}]", False)

    if kind == "adam":
        refill(opt[0], saved_opt["mu"], "mu")
        refill(opt[1], saved_opt["nu"], "nu")
    elif kind == "trace":
        refill(opt, saved_opt["trace"], "trace")
    state.step = int(tree["step"])


def adopt_params(state: TrainState, params: Sequence[Params],
                 device: torch.device) -> None:
    """Make ``params`` (a FedAvg mean, per-stage dicts) the live
    parameters of ``state``: a copy of each leaf on ``device`` in the
    mean's own dtype, as JAX's parties adopt the mean's tree (a weighted
    mean, or a compressed sync's, turns a bfloat16 leaf into float32; see
    :func:`fedavg_mean`). The optimizer state stays; :class:`Adam`'s
    moments follow a leaf whose dtype changed at the next update. Each
    stage keeps its own key order, the order of the optimizer's state.
    A :class:`ShardedState` takes the whole mean onto each of its ranks,
    cut as its leaves are (``device`` is then unused)."""
    if isinstance(state, ShardedState):
        state.adopt(params)
        return
    state.params = tuple(
        {k: _as_leaf_tensor(new[k]).to(device, copy=True)
         .requires_grad_(True) for k in live}
        for live, new in zip(state.params, params))


def check_config(cfg) -> None:
    """Raise for a Config the optimizer cannot build (an unknown
    optimizer). ``num_clients`` is the federated server's round size,
    the multi-client runner's client count and the fused trainer's
    ``data`` axis; ``model_parallel`` and ``seq_parallel`` the fused
    trainer's ``model`` and ``seq`` axes."""
    make_tx(cfg)


def _plan_dtypes(plan: SplitPlan, i: int) -> Dict[str, torch.dtype]:
    return {k: p.dtype
            for k, p in plan.stages[i].module.named_parameters()}


def init_params(plan: SplitPlan,
                init: Union[torch.Generator, Sequence[Params]],
                device: torch.device,
                stages: Optional[Sequence[int]] = None
                ) -> Tuple[Params, ...]:
    """The parameters of ``stages`` (default: all), on ``device``, each
    leaf in the plan's own dtype for it (float32, but for a bfloat16
    plan's ``pos`` table, which flax creates in bfloat16), requiring grad.

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
    out = []
    for i in keep:
        dtypes = _plan_dtypes(plan, i)
        out.append({
            k: torch.as_tensor(v).detach()
            .to(device, dtypes.get(k, torch.float32)).clone()
            .requires_grad_(True) for k, v in params[i].items()})
    return tuple(out)


# --------------------------------------------------------------------- #
# parameter averaging: the federated server and the multi-client runner
# --------------------------------------------------------------------- #
def _as_leaf_tensor(x: Any) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else from_host(x)


def _result_dtype(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """``jnp.result_type(*dtypes, float32)`` over floating dtypes: at
    least float32, float64 where a leaf is."""
    return (torch.float64 if torch.float64 in dtypes else torch.float32)


def fedavg_mean(params_list: Sequence[Any],
                weights: Optional[Sequence[float]] = None) -> Any:
    """FedAvg (JAX's ``fedavg_mean``): the leafwise mean over parameter
    trees, or with ``weights`` (canonically each client's example count)
    the weighted mean. One tree is returned as it is. Leaves are tensors
    (averaged on their device) or numpy arrays (on the CPU); the result's
    leaves are tensors.

    The dtype is JAX's on each path: the uniform mean keeps a leaf's
    dtype (``jnp.mean`` of a bfloat16 stack is bfloat16, summed in
    float32), the weighted one is at least float32 (the weights are
    normalised in float64, then a ``tensordot`` in ``result_type(leaves,
    float32)``), so a bfloat16 leaf comes back float32."""
    if len(params_list) == 1:
        return params_list[0]
    if weights is None:
        def mean(*xs):
            return torch.stack([_as_leaf_tensor(x) for x in xs]).mean(0)
        return tree_map(mean, *params_list)
    if len(weights) != len(params_list):
        raise ValueError(f"{len(weights)} weights for "
                         f"{len(params_list)} param trees")
    w = np.asarray(weights, dtype=np.float64)
    if not (w > 0).all():
        raise ValueError(f"weights must be positive (got {weights})")
    w = w / w.sum()

    def wmean(*xs):
        ts = [_as_leaf_tensor(x) for x in xs]
        acc = _result_dtype([t.dtype for t in ts])
        stack = torch.stack([t.to(acc) for t in ts])
        return torch.tensordot(torch.as_tensor(w, dtype=acc,
                                               device=stack.device),
                               stack, dims=1)

    return tree_map(wmean, *params_list)


def compressed_sync_contribution(ef: Any, tag: Any, params: Any, ref: Any,
                                 density: float) -> Tuple[Any, int, int]:
    """One party's contribution to a compressed parameter sync (JAX's):
    the drift from the last agreed mean, ``params - ref``, through the
    topk8 wire codec, and the receiver's reconstruction ``ref + delta'``.
    The error-feedback ledger ``ef`` is keyed ``(tag, leaf_index)`` at
    decay 1.0 (a parameter delta must be repaid in full), so the dropped
    drift rides into the next sync. CUDA leaves encode on the card (the
    five topk8 select launches a leaf) and decode there; the leaves come
    back float32, as JAX's do. Returns ``(reconstruction, raw_bytes,
    wire_bytes)``."""
    from split_learning_tpu_torch.transport import codec
    counter = itertools.count()
    totals = [0, 0]

    def one(p, r):
        i = next(counter)
        p32 = _as_leaf_tensor(p).float()
        r32 = _as_leaf_tensor(r).to(p32.device, torch.float32)
        packed = ef.compress((tag, i), (p32 - r32).contiguous(), density,
                             decay=1.0)
        rb, wb = codec.compressed_leaf_bytes(packed)
        totals[0] += rb
        totals[1] += wb
        return r32 + codec.decompress_tree(packed, p32.device)

    out = tree_map(one, params, ref)
    return out, totals[0], totals[1]
