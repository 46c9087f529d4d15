"""GPipe over the ``pipe`` axis of a mesh (counterpart of
``split_learning_tpu/parallel/pipeline.py``).

:class:`PipelinedTrainer` trains a :class:`~split_learning_tpu_torch.
core.stage.SplitPlan` with stage s on pipe rank s of every ``data`` row:
M microbatches run on GPipe's M + S - 1 ticks, each cut tensor moving to
the next rank's device (JAX's ``ppermute``), and autograd generates the
reverse schedule, the cut gradients' hops included, as JAX's scan
transpose does. The loss is the plain ``cross_entropy`` over the
concatenated logits of a row, scaled by its share of the global batch;
the gradients sum over the rows (:func:`~.distributed.sum_over_rows`)
and every row applies the same ``make_tx`` update, so the replicas stay
equal. JAX's pipeline reaches no Pallas kernel and this one has no
kernel of its own; the update is the port's optimizer (under SGD, K2 on
the card, once per row and device a step).

What decides the numbers is kept from JAX: a cut tensor travels in the
cut's dtype (the result type of the non-last stages' outputs: bf16
under mixed precision), and a later stage whose input is integer ids
receives them through a float32 cut when that dtype could not hold them
exactly. JAX's flat ``max_elems`` buffer and ``lax.switch`` exist to fit
heterogeneous stages into one SPMD program; each rank here runs its own
stage, so neither is needed.

:func:`make_hop_shift` is JAX's per-hop shuttle for the K-stage chain's
``DeviceTransport(mesh=)``: a device-to-device copy from pipe rank
``src`` to ``dst``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch.core.losses import cross_entropy
from split_learning_tpu_torch.core.stage import Params, SplitPlan, remat_plan
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.parallel.distributed import (
    process_index, sum_over_rows)
from split_learning_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, Mesh
from split_learning_tpu_torch.runtime.state import (
    TrainState, clip_by_global_norm, init_params, leaves_of, make_state,
    make_tx, restore_state, state_tree)
from split_learning_tpu_torch.utils.config import Config


def _cut_dtype(out_dtypes: Sequence[torch.dtype],
               in_dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """JAX's buffer dtype: the result type of the cut tensors' dtypes,
    promoted to float32 when a later stage takes integer ids and the cut
    dtype's mantissa is shorter than float32's."""
    cut = out_dtypes[:-1] or out_dtypes
    dtype = cut[0]
    for d in cut[1:]:
        dtype = torch.promote_types(dtype, d)
    if (any(not d.is_floating_point for d in in_dtypes[1:])
            and torch.finfo(dtype).eps > torch.finfo(torch.float32).eps):
        dtype = torch.float32
    return dtype


class PipelinedTrainer:
    """GPipe training of a SplitPlan over a (data, pipe) mesh.

    ``init`` is a ``torch.Generator`` or per-stage parameter dicts, as
    for :class:`~split_learning_tpu_torch.runtime.fused.
    FusedSplitTrainer`; every data row starts from it. Across processes
    each process runs the rows it owns."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: np.ndarray, mesh: Mesh,
                 microbatches: Optional[int] = None) -> None:
        if PIPE_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {PIPE_AXIS!r} axis")
        n_pipe = mesh.shape[PIPE_AXIS]
        if n_pipe != plan.num_stages:
            raise ValueError(
                f"pipe axis size {n_pipe} != num stages {plan.num_stages}")
        self.plan = remat_plan(plan) if cfg.remat else plan
        self.cfg = cfg
        self.mesh = mesh
        self.M = microbatches if microbatches is not None else cfg.microbatches
        n_data = mesh.shape.get(DATA_AXIS, 1)
        local_b = cfg.batch_size // n_data
        if local_b % self.M != 0:
            raise ValueError(
                f"microbatches ({self.M}) must divide the per-client batch "
                f"({local_b} = batch_size {cfg.batch_size} / {n_data} clients)")
        self.mb_size = local_b // self.M
        self.rows = mesh.local_rows(process_index())
        # the clip spans every stage, so it runs here, across devices,
        # and each device's update runs unclipped
        self._tx = make_tx(cfg.replace(grad_clip_norm=0.0))
        S = plan.num_stages
        self._devs = {d: [mesh.device(**{DATA_AXIS: d, PIPE_AXIS: s})
                          for s in range(S)] for d in self.rows}
        if isinstance(init, torch.Generator):
            init = plan.init(init, torch.zeros(1))
        self.states: Dict[int, TrainState] = {}
        for d in self.rows:
            params = tuple(init_params(plan, init, dev, stages=[s])[0]
                           for s, dev in enumerate(self._devs[d]))
            self.states[d] = make_state(params, self._tx)
        self._stage_dtypes(sample_input)
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()

    def _stage_dtypes(self, sample_input: np.ndarray) -> None:
        """Each stage's input and output dtypes, from one example run
        through the plan on the meta device (JAX's ``eval_shape``)."""
        x = torch.as_tensor(np.asarray(sample_input[:1]))
        if x.is_floating_point():
            x = x.float()
        x = x.to("meta")
        meta = [{k: v.to("meta") for k, v in st.items()}
                for st in self.states[self.rows[0]].params]
        ins, outs = [], []
        with torch.no_grad():
            for stage, p in zip(self.plan.stages, meta):
                ins.append(x.dtype)
                x = stage.apply(p, x)
                outs.append(x.dtype)
        self._in_dtypes = ins
        self.buf_dtype = _cut_dtype(outs, ins)
        self.logits_dtype = outs[-1]

    # ----------------------------------------------------------------- #
    @property
    def state(self) -> TrainState:
        """The first local row's replica (what a checkpoint saves)."""
        return self.states[self.rows[0]]

    @property
    def params(self) -> Tuple[Params, ...]:
        return self.state.params

    def _row_loss(self, d: int, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        """Row ``d``'s GPipe forward over its shard and its share of the
        global mean loss."""
        plan, M, S, devs = self.plan, self.M, self.plan.num_stages, \
            self._devs[d]
        params = self.states[d].params
        xs = x.to(devs[0]).chunk(M, 0)
        recv: List[List[Optional[torch.Tensor]]] = [[None] * M
                                                    for _ in range(S)]
        logits: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):          # GPipe's clock ticks
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                inp = xs[m] if s == 0 else recv[s][m]
                out = plan.stages[s].apply(params[s], inp)
                if s == S - 1:
                    logits[m] = out.to(self.logits_dtype)
                    continue
                cut = out.to(self.buf_dtype).to(devs[s + 1])
                if not self._in_dtypes[s + 1].is_floating_point:
                    cut = cut.to(self._in_dtypes[s + 1])
                recv[s + 1][m] = cut
        ce = cross_entropy(torch.cat(logits, 0), y.to(devs[-1]))
        return ce * (M * self.mb_size) / self.cfg.batch_size

    def _update(self, state: TrainState,
                grads: List[torch.Tensor]) -> None:
        """``make_tx``'s update, one call per device over the stages it
        holds (one launch of K2 a device under SGD on the card)."""
        if self.cfg.grad_clip_norm:
            clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        sizes = [len(st) for st in state.params]
        bounds = np.cumsum([0] + sizes)
        by_dev: Dict[torch.device, List[int]] = {}
        for s, st in enumerate(state.params):
            by_dev.setdefault(next(iter(st.values())).device, []).append(s)
        for stages in by_dev.values():
            idx = [j for s in stages for j in range(bounds[s], bounds[s + 1])]
            sub = TrainState(params=tuple(state.params[s] for s in stages),
                             opt_state=_slice_opt(state.opt_state, idx),
                             step=state.step)
            self._tx.update(sub, [grads[j] for j in idx])
        state.step += 1

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n_data = self.mesh.shape.get(DATA_AXIS, 1)
        xs, ys = x.chunk(n_data, 0), y.chunk(n_data, 0)
        losses, grads = [], []
        for d in self.rows:
            loss = self._row_loss(d, xs[d], ys[d])
            leaves = leaves_of(self.states[d].params)
            grads.append(list(torch.autograd.grad(loss, leaves)))
            losses.append([loss.detach().reshape(1)])
        total = sum_over_rows(grads)
        for d in self.rows:
            mine = [g.to(p.device) for g, p in
                    zip(total, leaves_of(self.states[d].params))]
            self._update(self.states[d], [g.contiguous() for g in mine])
        return sum_over_rows(losses)[0][0]

    def train_step(self, x: np.ndarray, y: np.ndarray) -> float:
        """One GPipe step on the global batch; the global mean loss."""
        x = torch.as_tensor(np.asarray(x))
        if x.is_floating_point():
            x = x.float()
        y = torch.as_tensor(np.asarray(y)).to(torch.int64)
        with obs_dispatch.step_scope(
                self._dd, (self._ddtok, "pipeline_step"),
                sig_fn=lambda: obs_dispatch.signature(x, y)):
            loss = self._step(x, y)
        with obs_dispatch.expected_d2h(self._dd):
            return float(loss)

    def export_states(self) -> Dict[str, Any]:
        """The checkpoint tree of the ``pipeline`` layout, one replica:
        ``{"trainer": state_tree(state)}``."""
        return {"trainer": state_tree(self.state)}

    def restore_states(self, tree: Dict[str, Any]) -> None:
        """Restore :meth:`export_states`'s tree into every local row."""
        for st in self.states.values():
            restore_state(st, tree["trainer"])


def _slice_opt(opt_state: Any, idx: Sequence[int]) -> Any:
    """The optimizer state of the leaves ``idx`` (the same tensors):
    None, a momentum trace list, or adam's ``(mu, nu)``."""
    if opt_state is None:
        return None
    if isinstance(opt_state, tuple):
        return tuple(_slice_opt(part, idx) for part in opt_state)
    return [opt_state[j] for j in idx]


def make_hop_shift(mesh: Mesh, src: int, dst: int) -> Callable:
    """``fn(x)`` moving ``x`` from pipe rank ``src`` to pipe rank ``dst``
    of the first data row: a device-to-device copy (JAX's jitted
    ``ppermute``)."""
    if PIPE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh must have a {PIPE_AXIS!r} axis")
    n = mesh.shape[PIPE_AXIS]
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(
            f"hop {src}->{dst} outside the pipe axis (size {n})")
    if src == dst:
        raise ValueError("hop shift needs distinct src/dst ranks")
    target = mesh.device(**{PIPE_AXIS: dst})

    def shift(x: torch.Tensor) -> torch.Tensor:
        return x.to(target)

    return shift
