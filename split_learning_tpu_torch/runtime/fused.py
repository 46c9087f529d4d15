"""Fused split trainer (counterpart of ``split_learning_tpu/runtime/fused.py``).

The whole split step runs in one process, on one device or over a
mesh (below): client stage
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

The mesh (``mesh=``, :mod:`split_learning_tpu_torch.parallel.mesh`),
as JAX's ``data`` and ``seq`` axes. Each ``data`` row holds a replica of
the state on its first device and takes its equal shard of the global
batch; its loss and gradients are its shard's mean, the rows' gradients
are averaged (summed in row order on the first row's device, then
across processes: :func:`~split_learning_tpu_torch.parallel.
distributed.sum_over_rows`) and every row applies the same update, so
the replicas stay bit-equal and the step is JAX's global-batch mean.
K1 launches once per row and microbatch, K2 once per row (under SGD).
The ``seq`` axis is the plan's: a transformer or ViT built with
``attn="ring"|"ring_flash"|"ulysses"`` and the mesh shards each
attention over the row's ``seq`` ranks (``ops/ring_attention.py``) and
gathers its output; the rest of the step runs on the row's tensors
whole (JAX also partitions that along T). The ``model`` axis is tensor
parallelism (JAX's ``tp_leaf_sharding`` placement): each row's replica
is a :class:`~split_learning_tpu_torch.runtime.state.ShardedState` over
the row's model ranks, whose ops run per rank on each rank's shard
(``parallel/tensor.py``); the logits are gathered to the row's first
rank, where K1 runs once per row and microbatch, and K2 updates each
rank's own leaves in one launch a rank (``data x model`` a step under
SGD). A mesh with both a ``model`` and a ``seq`` axis raises
``NotImplementedError`` (ROADMAP item 18.2). A checkpoint saves one
replica's whole leaves and restores into every row, on any mesh.

Config values the port cannot run yet raise ``NotImplementedError``
naming the ROADMAP item that brings them (:func:`check_supported`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params, SplitPlan, remat_plan
from split_learning_tpu_torch.obs import dispatch_debug as obs_dispatch
from split_learning_tpu_torch.ops.cross_entropy import fused_cross_entropy
from split_learning_tpu_torch.parallel.distributed import (
    process_index, sum_over_rows)
from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, data_row)
from split_learning_tpu_torch.runtime.state import (
    ShardedState, TrainState, check_config, init_params, leaves_of,
    make_state, make_tx, restore_state, state_tree)
from split_learning_tpu_torch.utils.config import Config
from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for every value the fused trainer
    cannot run: a transport other than ``fused`` (the two-party path is
    ``SplitClientTrainer`` over ``LocalTransport`` or ``HttpTransport``)
    and :func:`~split_learning_tpu_torch.runtime.state.check_config`.
    ``num_clients`` is the ``data`` axis of the mesh the caller builds."""
    if cfg.transport != "fused":
        raise NotImplementedError(
            f"not ported yet: transport {cfg.transport!r} in the fused "
            "trainer (the two-party path, ROADMAP items 8-12, is "
            "SplitClientTrainer over LocalTransport or HttpTransport)")
    check_config(cfg)


class FusedSplitTrainer:
    """Split training in one process, on one device or over a mesh.

    ``init`` is a ``torch.Generator`` (fresh flax-style init, drawn on the
    CPU) or per-stage parameter dicts to start from, e.g. carried over
    from the JAX package with :mod:`split_learning_tpu_torch.interop`.
    ``sample_input`` keeps the JAX signature; a flax-style init needs no
    sample. ``device`` defaults to ``"cuda"`` and raises without a GPU;
    with a ``mesh`` each data row runs on its own first device and
    ``device`` is not used."""

    def __init__(self, plan: SplitPlan, cfg: Config,
                 init: Union[torch.Generator, Sequence[Params]],
                 sample_input: np.ndarray,
                 device: DeviceLike = "cuda",
                 mesh: Optional[Mesh] = None) -> None:
        check_supported(cfg)
        tp = mesh is not None and MODEL_AXIS in mesh.axis_names
        if tp and SEQ_AXIS in mesh.axis_names:
            raise NotImplementedError(
                "not ported yet: a mesh with both a model and a seq axis "
                "(tensor with context parallelism, ROADMAP item 18.2)")
        self.mesh = mesh
        if mesh is None:
            self.rows: List[int] = [0]
            self._devs = {0: resolve_device(device)}
        else:
            self.rows = mesh.local_rows(process_index())
            self._devs = {d: mesh.device(**{DATA_AXIS: d})
                          for d in self.rows}
            for dev in self._devs.values():
                resolve_device(dev)
        self.device = self._devs[self.rows[0]]
        # grads recompute the stage forwards under remat; the FLOP count
        # reads the plan as written
        self._flops_plan = plan
        self.plan = remat_plan(plan) if cfg.remat else plan
        self.cfg = cfg
        self._tx = make_tx(cfg)
        if isinstance(init, torch.Generator) and mesh is not None:
            init = plan.init(init, torch.zeros(1))   # one draw, every row
        if tp:
            # each rank takes its slice from the host: no rank holds a
            # whole split leaf
            whole = init_params(plan, init, torch.device("cpu"))
            self.states: Dict[int, Any] = {
                d: ShardedState(whole, self._tx, mesh, rows=[d])
                for d in self.rows}
        else:
            self.states = {
                d: make_state(init_params(plan, init, dev), self._tx)
                for d, dev in self._devs.items()}
        self._flops_cache: Dict[Tuple[Any, ...], float] = {}
        # dispatch watchdog: None unless SLT_DISPATCH_DEBUG / force()
        self._dd = obs_dispatch.attach()
        self._ddtok = obs_dispatch.token()

    @property
    def state(self) -> Union[TrainState, ShardedState]:
        """The state (the first local row's replica on a mesh)."""
        return self.states[self.rows[0]]

    # ----------------------------------------------------------------- #
    def _to_device(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Floating inputs as float32, token ids as they are (JAX's
        ``train_step`` passes ``x`` unchanged); labels as int64. On a
        mesh they stay on the host until :meth:`_step` shards them."""
        dev = self.device if self.mesh is None else "cpu"
        x = torch.as_tensor(x).to(dev)
        if x.is_floating_point():
            x = x.float()
        y = torch.as_tensor(y).to(dev, torch.int64)
        return x, y

    def _loss_and_grads(self, state: TrainState, x: torch.Tensor,
                        y: torch.Tensor):
        params = state.params
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
        l_sum = torch.zeros((), device=x.device)
        for i in range(mb):
            loss, grads = value_and_grad(xs[i], ys[i])
            g_sum = [a + g for a, g in zip(g_sum, grads)]
            l_sum = l_sum + loss
        return l_sum / mb, [g / mb for g in g_sum]

    def _step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # cuDNN returns the conv weight grads in channels_last when its input
        # is channels_last; the SGD kernel walks each leaf in its params'
        # (contiguous) order
        if self.mesh is None:
            loss, grads = self._loss_and_grads(self.state, x, y)
            self._tx.update(self.state, [g.contiguous() for g in grads])
            return loss
        n = self.mesh.shape.get(DATA_AXIS, 1)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{n} data rows")
        xs, ys = x.chunk(n, 0), y.chunk(n, 0)
        losses, grads = [], []
        for d in self.rows:
            dev = self._devs[d]
            with data_row(self.mesh, d):
                loss, g = self._loss_and_grads(
                    self.states[d], xs[d].to(dev), ys[d].to(dev))
            losses.append([loss.reshape(1)])
            grads.append(list(g))
        # the mean over equal shards, computed once and copied to every
        # row: the replicas take the same update
        mean = [g / n for g in sum_over_rows(grads)]
        for d in self.rows:
            live = leaves_of(self.states[d].params)
            self._tx.update(self.states[d],
                            [g.to(t.device).contiguous()
                             for g, t in zip(mean, live)])
        return (sum_over_rows(losses)[0] / n)[0]

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
        if self.mesh is not None:   # one row's share of the global batch
            n = self.mesh.shape.get(DATA_AXIS, 1)
            x, y = x.chunk(n, 0)[0], y.chunk(n, 0)[0]
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
            with (data_row(self.mesh, self.rows[0]) if self.mesh is not None
                  else contextlib.nullcontext()):
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
        saved dtype, the schedule's count with it), into every row."""
        for st in self.states.values():
            restore_state(st, tree["trainer"])
