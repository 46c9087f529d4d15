"""ResNet-18 training and bfloat16 in the port against the JAX package's,
on the CPU (the modules and plans are in tests/test_torch_port_resnet.py,
whose cached JAX inits this file shares). Tolerances:

- 3 fused SGD steps at batch 8: losses within 1e-4 of JAX's (the
  parity bar). The parameters are held as the whole model's summed
  update, within a relative L2 distance of 2e-2 of JAX's plan trained
  in float64 (3 plain SGD steps at lr 0.01 from the same parameters).
  Not JAX's float32 trainer, and not tighter: the losses reach 9.5 at
  the third step, and gradients that large through ReLU kinks that
  float32 rounding flips move single channels' updates by percents.
  JAX's own float32 run is 1.0e-2 from the float64 one (4.5% of the
  largest update in its worst leaf); the port's is 1.2e-3 on 8
  intra-op threads and 5.2e-3 on one (the summation order moves which
  kinks flip). At batch 4 neither float32 implementation holds the
  losses to 1e-4: the second loss jumps to 13.4, and the third is
  1.1e-2 (JAX) and 4.8e-3 (the port) from a float64 run's.
- bfloat16 logits: 4 bfloat16 ulps at the largest logit's magnitude
  (conv outputs and activations are rounded to 8 bits at every layer,
  at other places in XLA and in PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_resnet import _jax_plan_params, _x

UPDATE_TOL = 2e-2   # the summed update's relative L2 distance


def test_fused_sgd_steps_match_jax():
    """3 fused SGD steps at batch 8 against JAX's trainer on its Pallas
    kernels (interpret mode), from one init."""
    ds = jax_synthetic("cifar10", n_train=24, n_test=4, seed=3)
    data = list(jax_batches(ds.train, 8, seed=3))
    kw = dict(model="resnet18", batch_size=8)
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(model="resnet18"), JaxConfig(kernels="pallas", **kw),
        jax.random.PRNGKey(0), jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(model="resnet18"), Config(transport="fused", **kw),
        params_from_jax(jtrainer.params), data[0][0], device="cpu")
    jtrainer_init = jax.tree_util.tree_map(np.asarray, jtrainer.params)
    init = jax.tree_util.tree_leaves(jtrainer_init)
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)
    with jax.enable_x64(True):
        plan64 = jax_get_plan(model="resnet18", dtype=jnp.float64)

        def loss64(params, x, y):
            logp = jax.nn.log_softmax(plan64.apply(params, x))
            return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

        grad64 = jax.jit(jax.grad(loss64))
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      jtrainer_init)
        for x, y in data:
            g = grad64(wide, jnp.asarray(x, jnp.float64), jnp.asarray(y))
            wide = jax.tree_util.tree_map(lambda p, d: p - 0.01 * d, wide, g)
        want = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, wide))
    got = jax.tree_util.tree_leaves(params_to_jax(trainer.params))
    assert len(got) == len(want) == len(init) == 62
    gap = sum(np.sum((a - b) ** 2.0) for a, b in zip(got, want))
    size = sum(np.sum((b - p0) ** 2.0) for b, p0 in zip(want, init))
    assert (gap / size) ** 0.5 <= UPDATE_TOL


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_bf16_forward_matches_jax():
    """A bfloat16 plan (float32 parameters, bf16 compute) from the same
    float32 parameters: bf16 logits within 4 bf16 ulps at their largest
    magnitude; the cut tensor is bf16."""
    jplan, jparams = _jax_plan_params("resnet18", "split", "bfloat16")
    plan = get_plan(model="resnet18", mode="split", dtype="bfloat16")
    x = _x(2, seed=8)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)).astype(
        jnp.float32))
    params = params_from_jax(jparams)
    with torch.no_grad():
        cut = plan.apply_range(params, torch.from_numpy(x), 0, 1)
        got = plan.apply(params, torch.from_numpy(x))
    assert cut.dtype == got.dtype == torch.bfloat16
    assert tuple(cut.shape) == (2, 32, 32, 64)
    tol = 4 * _bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
