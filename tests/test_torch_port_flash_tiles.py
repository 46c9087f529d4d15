"""The arithmetic of the tensor-core flash kernels, on the CPU.

The CUDA kernels (``csrc/flash_tiles.cuh``) need the card. What can be
held here is the arithmetic they were designed around:

(a) bf16. The kernels hand P and dS to their second products rounded to
    bf16, as the JAX package's Pallas kernels do, and the plain versions
    now round at the same places. The plain forward and backward are held
    to the Pallas kernels (interpret mode, both backward forms) on the
    same numpy-seeded bf16 inputs, with cotangents on O and the LSE.
    Tolerance ``BF16_TOL`` = 1.6e-2, absolute and relative: two bf16 ulps
    of a value below 2. Each side rounds its float32 result to bf16 once
    (one ulp apart at most for equal sums) and the sums differ by the
    occasional P or dS entry that rounds the other way, because Pallas
    forms P blockwise against a running max and the plain version against
    the final LSE. Before the plain versions rounded P and dS, the same
    comparison needed 3e-2 (tests/test_torch_port_flash_bwd.py).

(b) float32. The kernels take each float32 product as three TF32
    tensor-core products (3xTF32): a = hi + lo with hi = a rounded to
    nearest at 10 mantissa bits and lo = (a - hi) rounded the same way,
    a*b ~ lo*hi + hi*lo + hi*hi, summed in float32. A numpy emulation on
    random 64 x 128 tiles stays within 2e-6 of the largest entry of the
    float64 product; one TF32 product alone misses 2e-5, the card's
    float32 tolerance. That is why float32 inputs do not run as plain
    TF32.

(c) The float32 loss series of the small LM trainer (``attn="flash"``)
    stays within 1e-4 of the JAX trainer's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.ops.flash_attention import (
    _as_operand, _probs_and_dscores, flash_attention_bwd_plain,
    flash_attention_with_lse_plain, flash_bwd_delta_plain)
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

jfa = importlib.import_module("split_learning_tpu.ops.flash_attention")
BF16_TOL = 1.6e-2


# --------------------------------------------------------------------- #
# (a) bf16: the plain versions round where the JAX kernels round

@pytest.fixture(params=["onepass", "split"])
def jax_form(request, monkeypatch):
    """The JAX backward form under test (part of ``_make_flash``'s cache
    key, so each gets its own build)."""
    if request.param == "split":
        monkeypatch.setenv("SLT_FLASH_ONEPASS_T", "0")
    else:
        monkeypatch.delenv("SLT_FLASH_ONEPASS_T", raising=False)
    return request.param


def _bf16_inputs(t, d, seed):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(1, t, 2, d).astype(np.float32) for _ in range(4))
    return q, k, v, do, rs.randn(1, t, 2).astype(np.float32)


@pytest.mark.parametrize("causal,strict", [(True, False), (True, True)],
                         ids=["causal", "strict"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [64, 100])
def test_bf16_plain_rounds_where_the_jax_kernels_round(jax_form, t, d,
                                                       causal, strict):
    q, k, v, do, g_lse = _bf16_inputs(t, d, seed=t + d)
    f = lambda a, b, c: jfa.flash_attention_with_lse(
        a, b, c, causal=causal, strict=strict)
    (o_j, lse_j), vjp = jax.vjp(
        f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    grads_j = vjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(g_lse)))

    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    o, lse = flash_attention_with_lse_plain(*bf, causal, strict)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_j, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-3,
                               rtol=0)
    # the backward from JAX's own forward outputs, so that only the
    # backward's arithmetic is compared
    o_t = torch.from_numpy(np.asarray(o_j, np.float32)).bfloat16()
    lse_t = torch.from_numpy(np.array(lse_j))
    grads = flash_attention_bwd_plain(
        *bf, o_t, lse_t, torch.from_numpy(do).bfloat16(),
        torch.from_numpy(g_lse), causal, strict)
    for got, want in zip(grads, grads_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


def test_plain_operands_are_bf16_values_and_float32_is_untouched():
    """P and dS reach the second products as bf16 values for bf16 inputs
    (every entry survives a round trip through bf16), and for float32
    inputs the rounding is the identity."""
    q, k, v, do, g_lse = (torch.from_numpy(x)
                          for x in _bf16_inputs(40, 16, seed=7))
    for dtype in (torch.bfloat16, torch.float32):
        a = [x.to(dtype) for x in (q, k, v, do)]
        o, lse = flash_attention_with_lse_plain(*a[:3], True)
        delta = flash_bwd_delta_plain(o, a[3], g_lse)
        p, ds = _probs_and_dscores(*a, lse, delta, True, False)
        assert p.dtype == ds.dtype == torch.float32
        for x in (p, ds):
            y = _as_operand(x, dtype)
            if dtype == torch.float32:
                assert torch.equal(x, y)
            else:
                assert torch.equal(y, y.bfloat16().float())
                assert not torch.equal(x, y)


# --------------------------------------------------------------------- #
# (b) float32: the 3xTF32 split, emulated in numpy

def _tf32(x):
    """float32 rounded to nearest (ties away from zero) at TF32's 10
    mantissa bits, as ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tiles(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(64, 128).astype(np.float32),
            rs.randn(64, 128).astype(np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_3xtf32_split_holds_float32_and_plain_tf32_does_not(seed):
    a, b = _tiles(seed)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    top = np.abs(exact).max()
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    # the small terms first, float32 sums; a product of two TF32 values
    # is exact in float32
    three = (a_lo @ b_hi.T + a_hi @ b_lo.T) + a_hi @ b_hi.T
    assert three.dtype == np.float32
    assert np.abs(three - exact).max() <= 2e-6 * top
    one = a_hi @ b_hi.T
    assert np.abs(one - exact).max() > 2e-5 * top


def test_tf32_rounding_is_to_nearest_at_ten_bits():
    x = np.float32(1.0) + np.float32(2.0 ** -11)      # a tie: away from 0
    assert _tf32(np.array([x, -x])).tolist() == [1.0 + 2.0 ** -10,
                                                 -1.0 - 2.0 ** -10]
    y = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi, lo = _split(y)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0 ** -11)
    assert np.all(np.abs(y - hi - lo) <= np.abs(y) * 2.0 ** -21)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)


# --------------------------------------------------------------------- #
# (c) the small LM trainer's float32 loss series against JAX's

@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_lm_trainer_float32_losses_match_jax(momentum):
    size = dict(vocab=64, d_model=32, num_heads=2, client_depth=1,
                server_depth=1, max_len=64)
    ds = jds.synthetic_lm(n_train=16, n_test=4, vocab=64, seq_len=24,
                          seed=5)
    data = list(jds.batches(ds.train, 4, seed=5))
    kw = dict(mode="split", model="transformer_lm", attn="flash",
              batch_size=4, lr=0.1, momentum=momentum)
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(model="transformer_lm", mode="split", attn="flash",
                     **size),
        JaxConfig(kernels="xla", **kw), jax.random.PRNGKey(1),
        jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(model="transformer_lm", mode="split", attn="flash", **size),
        Config(transport="fused", **kw), params_from_jax(jtrainer.params),
        data[0][0], device="cpu")
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)
    assert losses[-1] < losses[0]
