"""A JAX training state continued by the port, and back, on the CPU.

JAX's fused trainer takes ``K`` steps; its ``TrainState`` goes through
JAX's own ``Checkpointer`` and comes back as ``restore_raw`` gives it
(numpy leaves, optax's chain as nested lists with ``None`` for its
empty states). ``interop.train_state_from_jax`` turns it into the port's
``state_tree``, ``restore_state`` loads it into a port trainer started
from another seed, and both trainers take ``M`` more steps on the same
batches:

- SGD with momentum 0.9 on the CNN (the trace through the SGD kernel's
  plain version) and AdamW with warmup, cosine decay and clipping on the
  CNN and the float32 LM: losses within 1e-4 and the optimizer state
  (trace or both moments) within 1e-6 of JAX's after the ``M`` steps;
  the schedule resumes at JAX's count, so the lr of each step is JAX's;
- the bf16 LM under AdamW (``pos`` and its moments bf16): the state
  loads bit for bit, the losses stay within two bf16 ulps at the loss's
  magnitude (``bf16_loss_tol``, as the bf16 trainer tests), and every
  moment keeps JAX's dtype. Its moments after the steps are not held to
  1e-6: they follow gradients through bf16 activations, which the two
  frameworks round at different places (up to 1.8e-4 apart here, and
  the attention's key biases, whose true gradient is zero, are rounding
  noise on both sides).

``train_state_to_jax`` of the carried state rebuilds JAX's raw tree
(structure, dtypes and bits) for every configuration, and JAX continues
a port-trained state: the port trains ``M`` steps from JAX's state,
JAX adopts the result (``tree_unflatten`` onto its live ``TrainState``)
and both take ``M`` more, within the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.checkpoint import Checkpointer as JaxCkpt
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import (
    train_state_from_jax, train_state_to_jax)
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    FusedSplitTrainer, restore_state, state_tree)
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_train_bf16 import bf16_loss_tol

K, M = 3, 3
LM_SIZE = dict(vocab=64, d_model=32, num_heads=2, client_depth=1,
               server_depth=1, max_len=64, attn="full")
RECIPES = {
    "sgd_momentum": dict(lr=0.02, momentum=0.9),
    "adamw_schedule": dict(optimizer="adamw", lr=3e-3, weight_decay=0.1,
                           warmup_steps=2, decay_steps=2 * K + 2 * M,
                           grad_clip_norm=1.0),
}
CASES = [("split_cnn", "float32", "sgd_momentum"),
         ("split_cnn", "float32", "adamw_schedule"),
         ("transformer_lm", "float32", "adamw_schedule"),
         ("transformer_lm", "bfloat16", "adamw_schedule")]


def _data(model, n):
    if model == "split_cnn":
        ds = jds.synthetic("mnist", n_train=8 * n, n_test=8, seed=5)
        return list(jds.batches(ds.train, 8, seed=5))
    ds = jds.synthetic_lm(n_train=4 * n, n_test=4, vocab=64, seq_len=16,
                          seed=6)
    return list(jds.batches(ds.train, 4, seed=6))


def _setup(model, dtype, recipe, tmp_path):
    data = _data(model, K + 2 * M)
    size = LM_SIZE if model != "split_cnn" else {}
    kw = dict(model=model, batch_size=len(data[0][1]), dtype=dtype,
              **RECIPES[recipe])
    jcfg = JaxConfig(kernels="xla", **kw)
    jtr = JaxFusedSplitTrainer(jax_get_plan(model=model, dtype=dtype, **size),
                               jcfg, jax.random.PRNGKey(0),
                               jnp.asarray(data[0][0]))
    for x, y in data[:K]:
        jtr.train_step(x, y)
    ck = JaxCkpt(str(tmp_path / "jax"))
    ck.save(K, {"trainer": jtr.state})
    raw = jax.tree_util.tree_map(np.asarray, ck.restore_raw(K)["trainer"])
    ck.close()
    cfg = Config(transport="fused", **kw)
    tr = FusedSplitTrainer(get_plan(model=model, dtype=dtype, **size), cfg,
                           torch.Generator().manual_seed(7), data[0][0],
                           device="cpu")
    return data, jtr, raw, tr, cfg


def _assert_states_close(port_tree, jax_tree, values=True):
    """Every optimizer-state leaf of the port in JAX's dtype and, with
    ``values``, within 1e-6 of JAX's."""
    opt, jopt = port_tree["opt_state"], jax_tree["opt_state"]
    assert port_tree["step"] == jax_tree["step"]
    assert sorted(opt) == sorted(jopt)
    for kind in opt:
        for stage, jstage in zip(opt[kind], jopt[kind]):
            assert sorted(stage) == sorted(jstage)
            for name, t in stage.items():
                j = jstage[name]
                assert t.dtype == j.dtype, (kind, name, t.dtype, j.dtype)
                if values:
                    np.testing.assert_allclose(
                        t.float().numpy(), j.float().numpy(), atol=1e-6,
                        err_msg=f"{kind} {name}")


def _assert_losses(losses, j_losses, dtype):
    if dtype == "bfloat16":
        tol = np.array([bf16_loss_tol(v) for v in j_losses])
        assert (np.abs(np.asarray(losses) - j_losses) <= tol).all(), \
            (losses, j_losses)
    else:
        np.testing.assert_allclose(losses, j_losses, atol=1e-4)


@pytest.mark.parametrize("model,dtype,recipe", CASES)
def test_port_continues_a_jax_run(model, dtype, recipe, tmp_path):
    data, jtr, raw, tr, cfg = _setup(model, dtype, recipe, tmp_path)
    tree = train_state_from_jax(raw)
    assert tree["step"] == K
    restore_state(tr.state, tree)
    assert tr.state.step == K
    # loaded bit for bit: parameters and optimizer state
    loaded = state_tree(tr.state)
    for part in ("params", "opt_state"):
        for a, b in zip(jax.tree_util.tree_leaves(loaded[part]),
                        jax.tree_util.tree_leaves(tree[part])):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b)
    tail = data[K:K + M]
    j_losses = [jtr.train_step(x, y) for x, y in tail]
    losses = [tr.train_step(x, y) for x, y in tail]
    _assert_losses(losses, j_losses, dtype)
    _assert_states_close(state_tree(tr.state),
                         train_state_from_jax(jax.tree_util.tree_map(
                             np.asarray, jtr.state._asdict())),
                         values=dtype == "float32")


@pytest.mark.parametrize("model,dtype,recipe", CASES)
def test_train_state_to_jax_round_trips_bit_for_bit(model, dtype, recipe,
                                                    tmp_path):
    data, jtr, raw, tr, cfg = _setup(model, dtype, recipe, tmp_path)
    back = train_state_to_jax(train_state_from_jax(raw), cfg)
    leaves, treedef = jax.tree_util.tree_flatten(raw)
    b_leaves, b_treedef = jax.tree_util.tree_flatten(back)
    assert b_treedef == treedef
    for a, b in zip(leaves, b_leaves):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        assert np.asarray(b).shape == np.asarray(a).shape
        assert np.asarray(b).tobytes() == np.asarray(a).tobytes()


@pytest.mark.parametrize("model,dtype,recipe", CASES[:2] + CASES[3:])
def test_jax_continues_a_port_run(model, dtype, recipe, tmp_path):
    data, jtr, raw, tr, cfg = _setup(model, dtype, recipe, tmp_path)
    restore_state(tr.state, train_state_from_jax(raw))
    for x, y in data[K:K + M]:
        tr.train_step(x, y)
    carried = train_state_to_jax(state_tree(tr.state), cfg)
    live = jtr.state
    # the live TrainState's field order, not the raw dict's sorted keys
    fields = (carried["params"], carried["opt_state"], carried["step"])
    jtr.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(live),
        [jnp.asarray(v) for v in jax.tree_util.tree_leaves(fields)])
    assert int(jtr.state.step) == K + M
    tail = data[K + M:K + 2 * M]
    j_losses = [jtr.train_step(x, y) for x, y in tail]
    losses = [tr.train_step(x, y) for x, y in tail]
    _assert_losses(losses, j_losses, dtype)
