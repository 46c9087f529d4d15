"""The port's kernel wrappers (CPU path) against the JAX Pallas kernels.

On the CPU the JAX kernels run in Pallas interpret mode, as in
tests/test_ops.py, and the port runs its plain versions: the
cross-entropy's plain PyTorch loss and the kernel math of
``ce_forward_plain``/``ce_backward_plain``, and ``sgd_step_plain``.
Inputs are numpy arrays from a seed. The CUDA kernels themselves are held
to these plain versions on the card by chip_smoke.py.

Tolerances: cross-entropy atol 1e-6 / rtol 1e-5 in float32 (exp, log and
the row sums round in another order); SGD rtol 1e-6 / atol 1e-7 (the same
arithmetic, one rounding per operation, so only ulp-level differences
from the two libraries' float32 kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.ops.cross_entropy import (
    fused_cross_entropy as jax_fused_ce, reference_cross_entropy)
from split_learning_tpu.ops.sgd import (
    fused_sgd_step as jax_fused_sgd, init_trace as jax_init_trace,
    reference_sgd_step)
from split_learning_tpu_torch.core.losses import cross_entropy
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.ops.common import LAUNCHES
from split_learning_tpu_torch.ops.cross_entropy import (
    CrossEntropyFunction, ce_backward_plain, ce_forward_plain,
    fused_cross_entropy)
from split_learning_tpu_torch.ops.sgd import fused_sgd_step, init_trace
from split_learning_tpu_torch.runtime.state import leaves_of

CE_TOL = dict(rtol=1e-5, atol=1e-6)


def _ce_inputs(b, c, seed=0):
    rs = np.random.RandomState(seed)
    logits = (3.0 * rs.randn(b, c)).astype(np.float32)
    labels = rs.randint(0, c, (b,)).astype(np.int64)
    return logits, labels


@pytest.mark.parametrize("b", [1, 8, 64, 1025])
@pytest.mark.parametrize("c", [10, 130])
def test_ce_plain_matches_jax_pallas(b, c):
    """B = 1025 takes the JAX kernel's gridded path."""
    logits, labels = _ce_inputs(b, c, seed=b + c)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    j_loss, j_grad = jax.value_and_grad(jax_fused_ce)(jl, jy)
    r_loss, r_grad = jax.value_and_grad(reference_cross_entropy)(jl, jy)

    x = torch.from_numpy(logits).requires_grad_(True)
    y = torch.from_numpy(labels)
    loss = fused_cross_entropy(x, y)
    (grad,) = torch.autograd.grad(loss, x)
    k_loss, lse = ce_forward_plain(x.detach(), y)
    k_grad = ce_backward_plain(x.detach(), y, lse, torch.ones(()))

    for want_loss, want_grad in ((j_loss, j_grad), (r_loss, r_grad)):
        for got_loss, got_grad in ((loss, grad), (k_loss, k_grad)):
            np.testing.assert_allclose(got_loss.detach().numpy(),
                                       np.asarray(want_loss), **CE_TOL)
            np.testing.assert_allclose(got_grad.numpy(),
                                       np.asarray(want_grad), **CE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_function_on_cpu_matches_autograd_of_plain(dtype):
    logits, labels = _ce_inputs(33, 17, seed=5)
    y = torch.from_numpy(labels)
    x1 = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    x2 = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    before = LAUNCHES.snapshot()
    l1 = CrossEntropyFunction.apply(x1, y)
    (2.0 * l1).backward()
    l2 = cross_entropy(x2, y)
    (2.0 * l2).backward()
    assert LAUNCHES.snapshot() == before  # CPU tensors launch nothing
    assert l1.dtype == torch.float32 and x1.grad.dtype == dtype
    tol = CE_TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(l1.detach().numpy(), l2.detach().numpy(),
                               **CE_TOL)
    np.testing.assert_allclose(x1.grad.float().numpy(),
                               x2.grad.float().numpy(), **tol)


def test_ce_rejects_bad_shapes():
    with pytest.raises(ValueError):
        CrossEntropyFunction.apply(torch.zeros(4, 3), torch.zeros(5).long())


def _cnn_tree(rs):
    """A flax-shaped tree with the split CNN's six leaves."""
    def leaf(*shape):
        return rs.randn(*shape).astype(np.float32)
    return ({"params": {"conv1": {"kernel": leaf(3, 3, 1, 32),
                                  "bias": leaf(32)}}},
            {"params": {"conv2": {"kernel": leaf(3, 3, 32, 64),
                                  "bias": leaf(64)},
                        "fc": {"kernel": leaf(9216, 10), "bias": leaf(10)}}})


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_plain_matches_jax_pallas_over_steps(momentum):
    rs = np.random.RandomState(7)
    lr = 0.01
    j_params = jax.tree_util.tree_map(jnp.asarray, _cnn_tree(rs))
    r_params = j_params
    j_trace = jax_init_trace(j_params) if momentum else None
    r_trace = j_trace
    params = params_from_jax(_cnn_tree(np.random.RandomState(7)))
    leaves = leaves_of(params)
    trace = init_trace(leaves) if momentum else None
    for _ in range(5):
        g_tree = _cnn_tree(rs)
        j_grads = jax.tree_util.tree_map(jnp.asarray, g_tree)
        j_params, j_trace = jax_fused_sgd(j_params, j_grads, j_trace, lr,
                                          momentum)
        r_params, r_trace = reference_sgd_step(r_params, j_grads, r_trace,
                                               lr, momentum)
        fused_sgd_step(leaves, leaves_of(params_from_jax(g_tree)), trace,
                       lr, momentum)
    got = jax.tree_util.tree_leaves(params_to_jax(params))
    for want_tree in (j_params, r_params):
        want = jax.tree_util.tree_leaves(want_tree)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_sgd_rejects_misaligned_lists():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError):
        fused_sgd_step(p, [], None, 0.1)
    with pytest.raises(ValueError):
        fused_sgd_step(p, [torch.zeros(3)], None, 0.1, momentum=0.9)
