"""ResNet-18 (models/resnet.py) in the port against the JAX package's, on
the CPU.

Parameters start in JAX (flax init, jitted and cached per plan: an
eager init of ResNet-18 takes about 15 s) and cross to the port through
``interop``; inputs are numpy arrays from a seed. Tolerances:

- float32 forward (a block, the stem, the head, a plan's logits):
  2e-5, tests/test_torch_parity.py's bar. Every conv output is
  renormalised by a GroupNorm, so the 17 normalised convs do not add up
  their rounding; the observed gap is about 2e-6.
- ``stage_backward`` gradients: rtol 1e-4, as
  tests/test_torch_port_models.py holds the CNN's, and atol 1e-5 of the
  leaf's largest entry (entries reach 300: float32 sums over 2048
  positions), against JAX's gradient evaluated in float64 (the same
  plan built at ``dtype=float64`` under ``jax.enable_x64``, the same
  parameters, input and cotangent). JAX's own float32 gradient is not
  the reference: at these inputs one pre-activation of ``block1a.gn1``
  sits within float32 rounding of the ReLU's kink, and JAX's float32
  forward puts it on the other side of zero than float64 does, which
  moves that channel's ``gn1.bias`` gradient by 1.13 of 130 (and the
  leaves below it); the port's float32 gradient is within 2.5e-4 of
  the float64 one everywhere.

The fused steps and the bfloat16 forward are in
tests/test_torch_port_resnet_train.py.

The stride-2 block is the SAME-padding trap: flax pads a 3x3 conv at
stride 2 on an even size by (0, 1), PyTorch's ``padding=1`` by (1, 1),
with the same output shape; the test shows the symmetric pad misses
JAX by far more than the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from split_learning_tpu.core.stage import stage_backward as jax_stage_backward
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.models import resnet as jres
from split_learning_tpu_torch.core.stage import stage_backward
from split_learning_tpu_torch.interop import (
    params_from_jax, stage_from_jax)
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.models import resnet as tres

TOL = 2e-5
CUTS = {"split": ("resnet18", "split"), "u_split": ("resnet18", "u_split"),
        "4stage": ("resnet18_4stage", "split")}


def _x(b=2, hw=32, c=3, seed=0):
    return np.random.RandomState(seed).randn(b, hw, hw, c).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_plan_params(model, mode, dtype="float32"):
    plan = jax_get_plan(model=model, mode=mode, dtype=dtype)
    params = jax.jit(plan.init)(jax.random.PRNGKey(0), jnp.asarray(_x()))
    return plan, jax.tree_util.tree_map(np.asarray, params)


def _module_out(jmod, tmod, x_nhwc, key=1):
    """A flax module and its port twin on one NHWC input: JAX's output,
    the port's (NHWC) and the port's parameters."""
    jparams = jmod.init(jax.random.PRNGKey(key), jnp.asarray(x_nhwc))
    want = np.asarray(jmod.apply(jparams, jnp.asarray(x_nhwc)))
    params = stage_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = torch.func.functional_call(tmod, params, (x,))
    return want, got.permute(0, 2, 3, 1).numpy(), params


@pytest.mark.parametrize("cin,features,stride", [(64, 64, 1), (64, 128, 2)])
def test_basic_block_matches_jax(cin, features, stride):
    x = _x(2, 16, cin, seed=2)
    want, got, params = _module_out(
        jres.BasicBlock(features, stride=stride),
        tres.BasicBlock(cin, features, stride, torch.float32), x)
    assert got.shape == want.shape == (2, 16 // stride, 16 // stride,
                                       features)
    assert ("proj.weight" in params) == (stride == 2)
    np.testing.assert_allclose(got, want, atol=TOL)
    if stride == 2:
        # the trap: PyTorch's symmetric padding gives the same shape over
        # windows one pixel off, far outside the tolerance
        block = tres.BasicBlock(cin, features, stride, torch.float32)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            mine = torch.func.functional_call(block.conv1, {
                "weight": params["conv1.weight"]}, (xt,))
            naive = F.conv2d(xt, params["conv1.weight"], stride=2, padding=1)
        assert mine.shape == naive.shape
        assert (mine - naive).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("part", ["stem", "head"])
def test_stem_and_head_match_jax(part):
    """The stages' NHWC entry points: Stem [B,32,32,3] -> [B,32,32,64]
    and Head [B,8,8,256] -> [B,10] (layer4 at stride 2, pool, fc)."""
    jmod, tmod, x, leaves = {
        "stem": (jres.Stem(), tres.Stem(), _x(2, seed=4), 15),
        "head": (jres.Head(), tres.Head(), _x(2, 8, 256, seed=5), 17)}[part]
    jparams = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jmod.apply(jparams, jnp.asarray(x)))
    params = stage_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert len(params) == leaves
    with torch.no_grad():
        got = torch.func.functional_call(tmod, params, (torch.from_numpy(x),))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("cut", list(CUTS))
def test_plan_logits_and_stage_grads_match_jax(cut):
    model, mode = CUTS[cut]
    jplan, jparams = _jax_plan_params(model, mode)
    plan = get_plan(model=model, mode=mode)
    assert plan.owners == jplan.owners
    assert [s.name for s in plan.stages] == [s.name for s in jplan.stages]
    params = params_from_jax(jparams)
    assert sum(v.numel() for p in params for v in p.values()) == 11_173_962
    x = _x(2, seed=6)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = plan.apply(params, torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # each stage's backward from its own input and a random cotangent,
    # against JAX's in float64
    h, rs = jnp.asarray(x), np.random.RandomState(7)
    for i, (jst, st) in enumerate(zip(jplan.stages, plan.stages)):
        out = jst.apply(jparams[i], h)
        g_out = rs.randn(*out.shape).astype(np.float32)
        with jax.enable_x64(True):
            st64 = jax_get_plan(model=model, mode=mode,
                                dtype=jnp.float64).stages[i]
            wide = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), (jparams[i], h, g_out))
            want_g = stage_from_jax(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), jax.jit(
                    lambda *a: jax_stage_backward(st64, *a))(*wide)))
        got_g = stage_backward(st, params[i], torch.tensor(np.asarray(h)),
                               torch.from_numpy(g_out))
        assert got_g.keys() == want_g.keys()
        for k in got_g:
            want_k = want_g[k].numpy()
            np.testing.assert_allclose(
                got_g[k].numpy(), want_k, rtol=1e-4,
                atol=1e-5 * np.abs(want_k).max(), err_msg=f"stage {i} {k}")
        h = out
