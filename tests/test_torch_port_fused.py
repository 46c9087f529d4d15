"""The port's FusedSplitTrainer against the JAX one on its Pallas kernels.

Both start from the same flax init (carried across with
``split_learning_tpu_torch.interop``) and see the same seeded batches;
the JAX side runs ``Config(kernels="pallas")`` with the kernels in
interpret mode on the CPU. Five-step loss series agree within 1e-4, the
bar of tests/test_torch_parity.py's training-curve check, and the final
params within rtol 1e-4 / atol 1e-6, the bar of tests/test_ops.py's
Pallas-vs-XLA trainer check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.fused import (
    FusedSplitTrainer, check_supported)
from split_learning_tpu_torch.utils.config import Config

BATCH, STEPS = 16, 5


def _data():
    ds = jax_synthetic("mnist", n_train=BATCH * STEPS, n_test=16, seed=3)
    return list(jax_batches(ds.train, BATCH, seed=3))


@pytest.mark.parametrize("mode,momentum,microbatches", [
    ("split", 0.0, 1),
    ("u_split", 0.0, 1),
    ("split", 0.9, 1),
    ("split", 0.0, 2),
])
def test_fused_trainer_matches_jax_pallas(mode, momentum, microbatches):
    data = _data()
    kw = dict(mode=mode, batch_size=BATCH, momentum=momentum,
              microbatches=microbatches)
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(mode=mode), JaxConfig(kernels="pallas", **kw),
        jax.random.PRNGKey(0), jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(mode=mode), Config(transport="fused", **kw),
        params_from_jax(jtrainer.params), data[0][0], device="cpu")

    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)

    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jtrainer.params))
    got = jax.tree_util.tree_leaves(params_to_jax(trainer.params))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_train_epoch_equals_train_steps():
    data = _data()[:3]
    cfg = Config(transport="fused", batch_size=BATCH, momentum=0.9)
    plan = get_plan()
    a = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(1),
                          data[0][0], device="cpu")
    b = FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(1),
                          data[0][0], device="cpu")
    stepwise = [a.train_step(x, y) for x, y in data]
    series = b.train_epoch(np.stack([x for x, _ in data]),
                           np.stack([y for _, y in data]))
    assert series.shape == (3,)
    assert series.tolist() == stepwise
    assert a.state.step == b.state.step == 3
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


@pytest.mark.parametrize("kw,item", [
    (dict(transport="local"), "items 8-12"),
    (dict(model_parallel=2), "item 18"),
])
def test_unported_config_values_raise(kw, item):
    cfg = Config(**{"transport": "fused", **kw})
    with pytest.raises(NotImplementedError, match=item):
        check_supported(cfg)


@pytest.mark.parametrize("field", ["num_clients", "seq_parallel"])
def test_mesh_config_values_are_accepted(field):
    """``num_clients`` and ``seq_parallel`` (refused before the mesh
    slice) are the axes of the mesh the caller builds: accepted, and a
    step on a 2-rank CPU mesh of that axis trains (the numbers are
    tests/test_torch_port_mesh_fused.py's)."""
    from split_learning_tpu_torch.parallel.mesh import make_mesh
    cfg = Config(transport="fused", batch_size=4, **{field: 2})
    check_supported(cfg)
    gen = torch.Generator().manual_seed(0)
    if field == "num_clients":
        mesh = make_mesh(num_clients=2, device="cpu")
        plan, x = get_plan(), np.zeros((4, 28, 28, 1), np.float32)
        y = np.zeros(4, np.int64)
    else:
        mesh = make_mesh(seq_parallel=2, device="cpu")
        plan = get_plan(model="transformer_lm", d_model=16, num_heads=2,
                        attn="ring", mesh=mesh)
        x = np.zeros((4, 8), np.int32)
        y = np.zeros((4, 8), np.int64)
    trainer = FusedSplitTrainer(plan, cfg, gen, x, mesh=mesh)
    assert np.isfinite(trainer.train_step(x, y))


def test_remat_config_is_accepted():
    """``remat`` trains through ``remat_plan`` (the recompute's numbers
    are tests/test_torch_port_scan_remat.py's)."""
    cfg = Config(transport="fused", remat=True)
    check_supported(cfg)
    trainer = FusedSplitTrainer(get_plan(), cfg,
                                torch.Generator().manual_seed(0), None,
                                device="cpu")
    assert all(s.remat for s in trainer.plan.stages)
