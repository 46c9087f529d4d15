"""The port's CNN, ResNet-18 and ViT plans against the JAX package's, on
the CPU.

Parameters start in JAX (flax init, jitted and cached per plan and seed:
an eager ResNet-18 init takes about 15 s) and cross to the port through
``split_learning_tpu_torch.interop``; inputs are numpy arrays from a
seed, MNIST-shaped but for ResNet-18's 32x32x3. Logits are held to 2e-5,
the bar of tests/test_torch_parity.py's weight-export check (f32
convolutions in two libraries sum in different orders). The ResNet and
ViT modules and paths have their own files
(tests/test_torch_port_resnet.py, tests/test_torch_port_vit.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.core.stage import stage_backward as jax_stage_backward
from split_learning_tpu.models import get_model as jax_get_model
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu_torch.core.stage import stage_backward
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_model, get_plan

PLANS = [("split_cnn", "split"), ("split_cnn", "u_split"),
         ("split_cnn_chain3", "split"), ("resnet18", "split"),
         ("resnet18", "u_split"), ("resnet18_4stage", "split"),
         ("vit", "split"), ("vit", "u_split"), ("vit", "federated")]
IMAGE = {"resnet18": (32, 3), "resnet18_4stage": (32, 3)}


def _x(b=8, seed=0, model="split_cnn"):
    hw, c = IMAGE.get(model, (28, 1))
    return np.random.RandomState(seed).randn(b, hw, hw, c).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(model, mode, seed=0):
    plan = jax_get_plan(model=model, mode=mode)
    params = jax.jit(plan.init)(jax.random.PRNGKey(seed),
                                jnp.asarray(_x(model=model)))
    return plan, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("model,mode", PLANS)
def test_interop_round_trip_bit_exact(model, mode):
    _, jparams = _jax_params(model, mode)
    back = params_to_jax(params_from_jax(jparams))
    flat_a = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,mode", PLANS)
def test_logits_match_jax(model, mode):
    jplan, jparams = _jax_params(model, mode)
    x = _x(8, seed=1, model=model)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)))
    plan = get_plan(model=model, mode=mode)
    with torch.no_grad():
        got = plan.apply(params_from_jax(jparams), torch.from_numpy(x))
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_cut_tensor_is_nhwc_and_matches_jax():
    jplan, jparams = _jax_params("split_cnn", "split")
    x = _x(4, seed=2)
    want = np.asarray(jplan.apply_range(jparams, jnp.asarray(x), 0, 1))
    plan = get_plan()
    with torch.no_grad():
        cut = plan.apply_range(params_from_jax(jparams),
                               torch.from_numpy(x), 0, 1)
    assert tuple(cut.shape) == (4, 26, 26, 32) == want.shape
    np.testing.assert_allclose(cut.numpy(), want, atol=1e-5)


def test_stage_backward_matches_jax():
    """The cotangent splice through server stage B (the party-boundary
    backward) gives JAX's parameter gradients."""
    jplan, jparams = _jax_params("split_cnn", "split")
    rs = np.random.RandomState(3)
    cut = np.maximum(rs.randn(4, 26, 26, 32), 0).astype(np.float32)
    g_out = rs.randn(4, 10).astype(np.float32)
    want = jax_stage_backward(jplan.stages[1], jparams[1], jnp.asarray(cut),
                              jnp.asarray(g_out))
    plan = get_plan()
    got = stage_backward(plan.stages[1], params_from_jax(jparams)[1],
                         torch.from_numpy(cut), torch.from_numpy(g_out))
    want_t = params_from_jax([want])[0]
    assert got.keys() == want_t.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want_t[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(model="split_cnn", mode="bogus"),
    dict(model="no_such_model", mode="split"),
    dict(model="split_cnn_chain3", mode="u_split"),
    dict(model="split_cnn", mode="split", d_model=64),
])
def test_get_plan_value_errors_match_jax(kw):
    with pytest.raises(ValueError):
        jax_get_plan(**kw)
    with pytest.raises(ValueError):
        get_plan(**kw)


@pytest.mark.parametrize("role,mode", [("client", "split"),
                                       ("server", "u_split"),
                                       ("client", "federated"),
                                       ("nobody", "split")])
def test_get_model_matches_jax(role, mode):
    if role == "nobody":
        with pytest.raises(ValueError):
            jax_get_model(role, mode=mode)
        with pytest.raises(ValueError):
            get_model(role, mode=mode)
        return
    jplan, jowned = jax_get_model(role, mode=mode)
    plan, owned = get_model(role, mode=mode)
    assert owned == jowned
    assert plan.owners == jplan.owners
    assert [s.name for s in plan.stages] == [s.name for s in jplan.stages]


def test_unported_family_raises_not_implemented():
    """The ResNet-18 plans (2, 3 and 4 stages) and the ViT's, once
    refused (ROADMAP item 20), build in float32 and bfloat16 with JAX's
    owners and stage names. The ViT's ``auto`` attention, once refused
    too, builds and gives JAX's logits (its context-parallel forms build
    since the mesh slice)."""
    for model, mode in PLANS[3:]:
        jplan = jax_get_plan(model=model, mode=mode)
        for dtype in ("float32", "bfloat16"):
            plan = get_plan(model=model, mode=mode, dtype=dtype)
            assert plan.owners == jplan.owners
            assert [s.name for s in plan.stages] == \
                [s.name for s in jplan.stages]
    jplan = jax_get_plan(model="vit", attn="auto")
    jparams = jplan.init(jax.random.PRNGKey(0), jnp.asarray(_x(2)))
    want = np.asarray(jplan.apply(jparams, jnp.asarray(_x(2, seed=1))))
    with torch.no_grad():
        got = get_plan(model="vit", attn="auto").apply(
            params_from_jax(jparams), torch.from_numpy(_x(2, seed=1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    for attn in ("ring", "ulysses"):   # the mesh slice: they build
        assert get_plan(model="vit", attn=attn).num_stages == 2


@pytest.mark.parametrize("model,mode", PLANS)
def test_fresh_init_has_flax_statistics(model, mode):
    """Per-leaf std within 10% of flax's (biases zero in both)."""
    _, jparams = _jax_params(model, mode, seed=4)
    want = params_from_jax(jparams)
    plan = get_plan(model=model, mode=mode)
    got = plan.init(torch.Generator().manual_seed(4), torch.zeros(1))
    assert [p.keys() for p in got] == [p.keys() for p in want]
    for g_stage, w_stage in zip(got, want):
        for k in g_stage:
            g, w = g_stage[k], w_stage[k]
            assert g.shape == w.shape and g.dtype == torch.float32
            if k.endswith("bias"):
                assert not g.any() and not w.any()
            elif w.std().item() == 0:
                # a norm's scale: flax's ones (GroupNorm, LayerNorm)
                assert torch.equal(g, w), k
            else:
                assert abs(g.std().item() / w.std().item() - 1) < 0.10, k
                if k != "pos":   # normal(0.02), not truncated
                    # truncation at 2 std of the underlying normal, both
                    # sides
                    assert g.abs().max() <= w.abs().max() * 1.05, k
