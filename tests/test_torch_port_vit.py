"""The ViT (models/vit.py) in the port against the JAX package's, on the
CPU.

Parameters start in JAX (flax init) and cross to the port through
``interop``; inputs are numpy arrays from a seed. JAX's ``attn="flash"``
runs its Pallas kernels in interpret mode, as its own tests run them on
the CPU; the port's flash runs the kernels' plain versions. Tolerances:

- float32 forward (the patch stem, a plan's logits): 2e-5, the bar of
  tests/test_torch_parity.py;
- ``stage_backward`` gradients: rtol 1e-4 and atol 1e-5 of the stage's
  largest entry (tests/test_torch_port_resnet.py takes the leaf's): the
  key projections' bias has a zero gradient in exact arithmetic (softmax
  ignores a per-row shift of the scores), so both sides give rounding
  noise of about 1e-6 there, as chip_smoke.py's ``TWIN_UPDATE_FLOOR``
  notes;
- 3 fused SGD steps: losses within 1e-4 (the parity bar), parameters
  within rtol 1e-4 / atol 1e-6 (tests/test_torch_port_fused.py's bar);
- bfloat16 logits: 4 bfloat16 ulps at the largest logit's magnitude.

The patch stem is held at MNIST's 28x28x1 (T 49, a ragged tail in the
flash kernel's 64-row block on the card) and CIFAR-10's 32x32x3 (T 64):
a conv whose NCHW output were reshaped without the permute back to NHWC
would put the tokens out of order against ``pos``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.core.stage import stage_backward as jax_stage_backward
from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_model as jax_get_model
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.models import vit as jvit
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.core.stage import stage_backward
from split_learning_tpu_torch.interop import (
    params_from_jax, params_to_jax, stage_from_jax)
from split_learning_tpu_torch.models import get_model, get_plan
from split_learning_tpu_torch.models import vit as tvit
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

TOL = 2e-5
IMAGES = {"mnist": (28, 1, 49), "cifar10": (32, 3, 64)}


def _x(b=2, hw=28, c=1, seed=0):
    return np.random.RandomState(seed).randn(b, hw, hw, c).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_plan_params(mode, attn, dtype="float32", hw=28, c=1):
    plan = jax_get_plan(model="vit", mode=mode, attn=attn, dtype=dtype)
    params = jax.jit(plan.init)(jax.random.PRNGKey(0),
                                jnp.asarray(_x(2, hw, c)))
    return plan, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("image", list(IMAGES))
def test_patch_embed_matches_jax(image):
    hw, c, t = IMAGES[image]
    x = _x(2, hw, c, seed=1)
    jmod = jvit.PatchEmbedStage(d_model=32, num_heads=2, depth=1)
    jparams = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jmod.apply(jparams, jnp.asarray(x)))
    params = stage_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert params["patch.weight"].shape == (32, c, 4, 4)
    assert params["pos"].shape == (256, 32)
    tmod = tvit.PatchEmbedStage(32, 2, 1, channels=c)
    with torch.no_grad():
        got = torch.func.functional_call(tmod, params, (torch.from_numpy(x),))
    assert tuple(got.shape) == want.shape == (2, t, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("hw,kw,match", [(30, {}, "patches"),
                                         (28, {"max_tokens": 16},
                                          "max_tokens")])
def test_patch_embed_value_errors_match_jax(hw, kw, match):
    x = np.zeros((1, hw, hw, 1), np.float32)
    with pytest.raises(ValueError, match=match):
        jvit.PatchEmbedStage(d_model=16, num_heads=2, depth=1, **kw).init(
            jax.random.PRNGKey(0), jnp.asarray(x))
    params = get_plan(model="vit", max_tokens=kw.get("max_tokens", 256),
                      d_model=16, num_heads=2).init(
        torch.Generator().manual_seed(0), torch.zeros(1))
    with pytest.raises(ValueError, match=match):
        get_plan(model="vit", d_model=16, num_heads=2,
                 **kw).stages[0].apply(params[0], torch.from_numpy(x))


@pytest.mark.parametrize("attn", ["full", "flash"])
@pytest.mark.parametrize("mode", ["split", "u_split", "federated"])
def test_plan_logits_and_stage_grads_match_jax(mode, attn):
    jplan, jparams = _jax_plan_params(mode, attn)
    plan = get_plan(model="vit", mode=mode, attn=attn)
    assert plan.owners == jplan.owners
    assert [s.name for s in plan.stages] == [s.name for s in jplan.stages]
    for role in ("client", "server"):
        assert get_model(role, mode=mode, model="vit")[1] == \
            jax_get_model(role, mode=mode, model="vit")[1]
    params = params_from_jax(jparams)
    x = _x(2, seed=2)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = plan.apply(params, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    h, rs = jnp.asarray(x), np.random.RandomState(3)
    for i, (jst, st) in enumerate(zip(jplan.stages, plan.stages)):
        out = jst.apply(jparams[i], h)
        g_out = rs.randn(*out.shape).astype(np.float32)
        want_g = stage_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_stage_backward(jst, jparams[i], h,
                                           jnp.asarray(g_out))))
        got_g = stage_backward(st, params[i], torch.tensor(np.asarray(h)),
                               torch.from_numpy(g_out))
        assert got_g.keys() == want_g.keys()
        top = max(v.abs().max().item() for v in want_g.values())
        for k in got_g:
            np.testing.assert_allclose(
                got_g[k].numpy(), want_g[k].numpy(), rtol=1e-4,
                atol=1e-5 * top, err_msg=f"stage {i} {k}")
        h = out


@pytest.mark.parametrize("mode", ["split", "u_split"])
def test_fused_steps_match_jax(mode):
    """3 fused SGD steps on synthetic CIFAR-10 at batch 8, from one init:
    JAX's trainer on its Pallas cross-entropy and SGD (interpret mode)
    with dense attention, the port with ``attn="flash"`` (its plain
    version on the CPU, which is dense float32 attention)."""
    ds = jax_synthetic("cifar10", n_train=24, n_test=4, seed=3)
    data = list(jax_batches(ds.train, 8, seed=3))
    kw = dict(model="vit", mode=mode, batch_size=8)
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(model="vit", mode=mode),
        JaxConfig(kernels="pallas", **kw), jax.random.PRNGKey(0),
        jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(model="vit", mode=mode, attn="flash", channels=3),
        Config(transport="fused", attn="flash", **kw),
        params_from_jax(jtrainer.params), data[0][0], device="cpu")
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jtrainer.params))
    got = jax.tree_util.tree_leaves(params_to_jax(trainer.params))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_bf16_forward_matches_jax():
    """A bfloat16 plan at CIFAR-10's shape: the ``pos`` table is bf16 in
    both, the cut tensor bf16 ``[B, 64, d]``, the logits within 4 bf16
    ulps of JAX's at their largest magnitude."""
    jplan, jparams = _jax_plan_params("split", "flash", "bfloat16", 32, 3)
    assert jparams[0]["params"]["pos"].dtype.name == "bfloat16"
    plan = get_plan(model="vit", attn="flash", dtype="bfloat16", channels=3)
    params = params_from_jax(jparams)
    assert params[0]["pos"].dtype == torch.bfloat16
    x = _x(2, 32, 3, seed=4)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)).astype(
        jnp.float32))
    with torch.no_grad():
        cut = plan.apply_range(params, torch.from_numpy(x), 0, 1)
        got = plan.apply(params, torch.from_numpy(x))
    assert cut.dtype == got.dtype == torch.bfloat16
    assert tuple(cut.shape) == (2, 64, 64)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=4 * _bf16_ulp(np.abs(want).max()))
    # a fresh bf16 init keeps the dtypes flax gives its leaves
    fresh = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    assert {k: v.dtype for k, v in fresh[0].items()} == {
        k: v.dtype for k, v in params[0].items()}
