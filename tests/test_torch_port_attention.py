"""The port's attention against the JAX package's, on the CPU.

``flash_attention`` / ``flash_attention_with_lse`` run their plain
version here (the CUDA kernel needs the card); the JAX functions run
their Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. Inputs are numpy arrays from a seed. Tolerance 2e-5 on O and LSE:
both sides compute in float32, in different summation orders (one dense
softmax against blockwise online rescaling).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.ops.flash_attention import (
    flash_attention as jax_flash, flash_attention_with_lse as jax_flash_lse)
from split_learning_tpu.ops.ring_attention import (
    full_attention as jax_full)
from split_learning_tpu_torch.ops.common import NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_with_lse)
from split_learning_tpu_torch.ops.ring_attention import (
    full_attention, ring_attention, ulysses_attention)

TOL = 2e-5
SHAPES = [(t, d) for t in (1, 37, 128) for d in (16, 128)]
MASKS = [(False, False), (True, False), (True, True)]


def _qkv(t, d, b=1, h=2, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal,strict", MASKS,
                         ids=["full", "causal", "strict"])
@pytest.mark.parametrize("t,d", SHAPES)
def test_flash_with_lse_matches_jax(t, d, causal, strict):
    q, k, v = _qkv(t, d)
    o_j, lse_j = jax_flash_lse(*map(jnp.asarray, (q, k, v)), causal=causal,
                               strict=strict)
    o, lse = flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal, strict=strict)
    assert o.shape == (1, t, 2, d) and lse.shape == (1, t, 2)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=TOL,
                               rtol=0)
    if strict:  # row 0 sees no key: the identity of the log-space merge
        assert (o[:, 0] == 0).all()
        assert (lse[:, 0] == NEG_BIG).all()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_and_full_attention(causal):
    q, k, v = _qkv(37, 16, b=2, seed=1)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal))
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    np.testing.assert_allclose(flash_attention(*tq, causal=causal).numpy(),
                               want, atol=TOL)
    np.testing.assert_allclose(full_attention(*tq, causal=causal).numpy(),
                               want, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 37])
def test_full_attention_matches_jax(t, causal):
    q, k, v = _qkv(t, 16, b=2, seed=2)
    want = np.asarray(jax_full(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_bf16_output_dtype_and_plain_is_differentiable():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 16))
    o, lse = flash_attention_with_lse(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    qg = q.clone().requires_grad_(True)
    flash_attention(qg, k, v, causal=True).sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


def test_strict_without_causal_raises_like_jax():
    q, k, v = _qkv(8, 16)
    with pytest.raises(ValueError, match="requires causal"):
        jax_flash_lse(*map(jnp.asarray, (q, k, v)), strict=True)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                 strict=True)


def test_head_dim_above_256_raises():
    x = torch.zeros(1, 2, 1, 257)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention])
def test_sequence_parallel_forms_raise(fn):
    x = torch.zeros(1, 2, 1, 4)
    with pytest.raises(NotImplementedError, match="item 21"):
        fn(x, x, x)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wrapper_launches_k6_for_grad_requiring_input(cuda_device):
    """A CUDA input that requires grad runs the kernels both ways (K5,
    then K6) and never the plain backward: its gradient matches the
    CPU's plain one."""
    from split_learning_tpu_torch.ops.common import LAUNCHES
    from split_learning_tpu_torch.ops.flash_attention import BWD_NAMES, NAME
    q = torch.randn(1, 8, 2, 16, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, device=cuda_device)
    LAUNCHES.reset()
    o = flash_attention(q, k, k, causal=True)
    (g,) = torch.autograd.grad(o.sum(), q)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {NAME: 1, **{n: 1 for n in BWD_NAMES}}
    qc = q.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(
        flash_attention(qc, k.cpu(), k.cpu(), causal=True).sum(), qc)
    np.testing.assert_allclose(o.detach().cpu().numpy(),
                               flash_attention(qc, k.cpu(), k.cpu(),
                                               causal=True).detach().numpy(),
                               atol=TOL)
    np.testing.assert_allclose(g.cpu().numpy(), want.numpy(), atol=TOL)
