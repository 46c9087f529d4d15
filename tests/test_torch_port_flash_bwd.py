"""The port's flash-attention backward against the JAX package's, on the CPU.

The JAX side is ``jax.vjp`` of ``flash_attention_with_lse``, whose
custom VJP runs the Pallas backward in interpret mode, in both of its
forms: the one-pass kernel (the default at these sizes) and the
two-kernel split (``SLT_FLASH_ONEPASS_T=0``). The port's side is its
plain backward, ``flash_attention_bwd_plain``, called directly and
through autograd of ``flash_attention_with_lse`` (the CUDA kernel K6
needs the card; its plain version is what runs here). Cotangents go on
both outputs, O and the LSE. Inputs are numpy arrays from a seed.

Tolerance 1e-5 (absolute and relative) in float32: both sides
accumulate in float32, the Pallas kernels blockwise and the plain
version in one dense sum per product. The bf16 case holds the port to
3e-2: the Pallas kernels round P and dS to bf16 before their products,
the port's kernel and plain version keep them in float32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu_torch.ops.common import NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_with_lse,
    flash_attention_with_lse_plain, flash_bwd_cuda, flash_bwd_delta_cuda,
    flash_bwd_delta_plain, flash_bwd_dkv_cuda, flash_bwd_dkv_plain,
    flash_bwd_dq_cuda, flash_bwd_dq_plain, flash_fwd_cuda)

# the JAX ops package re-exports the function flash_attention, which
# shadows the submodule of that name
jfa = importlib.import_module("split_learning_tpu.ops.flash_attention")
MASKS = [(False, False), (True, False), (True, True)]
TOL = 1e-5


def _inputs(t, d=16, b=1, h=2, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    g_lse = rs.randn(b, t, h).astype(np.float32)
    return q, k, v, do, g_lse


def _jax_vjp(q, k, v, do, g_lse, causal, strict, dtype=jnp.float32):
    f = lambda a, b, c: jfa.flash_attention_with_lse(
        a, b, c, causal=causal, strict=strict)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (o, lse), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(do, dtype), jnp.asarray(g_lse)))
    return [np.asarray(x, np.float32) for x in (o, lse, *grads)]


@pytest.fixture(params=["onepass", "split"])
def jax_form(request, monkeypatch):
    """The JAX backward form under test; the form is part of
    ``_make_flash``'s cache key, so each gets its own build."""
    if request.param == "split":
        monkeypatch.setenv("SLT_FLASH_ONEPASS_T", "0")
    else:
        monkeypatch.delenv("SLT_FLASH_ONEPASS_T", raising=False)
    return request.param


@pytest.mark.parametrize("causal,strict", MASKS,
                         ids=["full", "causal", "strict"])
@pytest.mark.parametrize("t", [1, 7, 64, 130])
def test_backward_matches_jax_vjp(jax_form, t, causal, strict):
    q, k, v, do, g_lse = _inputs(t)
    onepass = jfa._resolve_block(t, 16, jnp.float32, bh=2)[1]
    assert onepass == (jax_form == "onepass")
    o_j, lse_j, *grads_j = _jax_vjp(q, k, v, do, g_lse, causal, strict)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = flash_attention_with_lse(tq, tk, tv, causal, strict)
    np.testing.assert_allclose(o.detach().numpy(), o_j, atol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(), lse_j, atol=TOL,
                               rtol=0)
    tdo, tg = torch.from_numpy(do), torch.from_numpy(g_lse)
    auto = torch.autograd.grad((o, lse), (tq, tk, tv), (tdo, tg))
    plain = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                      o.detach(), lse.detach(), tdo, tg,
                                      causal, strict)
    for got_a, got_p, want in zip(auto, plain, grads_j):
        assert got_a.dtype == torch.float32
        np.testing.assert_allclose(got_a.numpy(), want, atol=TOL, rtol=TOL)
        assert torch.equal(got_a, got_p)
    if strict:   # row 0 has no key (lse = NEG_BIG): no gradient reaches q
        assert (lse[:, 0] == NEG_BIG).all() and (auto[0][:, 0] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_output_only_cotangent_matches_jax_flash(causal):
    """``flash_attention`` (O only): the LSE gets no cotangent, as in
    JAX's ``flash_attention``, whose VJP has no LSE output."""
    q, k, v, do, _ = _inputs(37, d=32, b=2, seed=1)
    f = lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got = torch.autograd.grad(flash_attention(tq, tk, tv, causal),
                              (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_lse_only_cotangent_and_dense_autograd():
    """Only the LSE is used: ``do`` is None inside the backward. The
    result equals autograd through the plain forward's dense math."""
    q, k, v, _, g_lse = _inputs(20, seed=2)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    _, lse = flash_attention_with_lse(*leaves, causal=True)
    got = torch.autograd.grad(lse, leaves, torch.from_numpy(g_lse))
    ref = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    # autograd through the dense plain forward: exp(NEG_BIG - m) is 0
    with torch.enable_grad():
        _, lse_d = _dense_with_lse(*ref)
    want = torch.autograd.grad(lse_d, ref[:2], torch.from_numpy(g_lse))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)
    assert not got[2].any()   # the LSE does not depend on v


def _dense_with_lse(q, k, v):
    """Causal softmax attention written with differentiable ops only."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), NEG_BIG)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o, lse.permute(0, 2, 1)


def test_bf16_backward_tracks_jax():
    q, k, v, do, g_lse = _inputs(64, seed=3)
    *_, dq_j, dk_j, dv_j = _jax_vjp(q, k, v, do, g_lse, True, False,
                                    jnp.bfloat16)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    o, lse = flash_attention_with_lse_plain(*bf, causal=True)
    grads = flash_attention_bwd_plain(*bf, o, lse,
                                      torch.from_numpy(do).bfloat16(),
                                      torch.from_numpy(g_lse), causal=True)
    for g, w in zip(grads, (dq_j, dk_j, dv_j)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.parametrize("causal,strict", MASKS,
                         ids=["full", "causal", "strict"])
def test_plain_launch_parts_compose_to_the_whole(causal, strict):
    """The plain parts the card holds each K6 launch to (delta, dK/dV,
    dQ) give the whole plain backward bit for bit."""
    q, k, v, do, g_lse = (torch.from_numpy(x) for x in _inputs(33, seed=4))
    o, lse = flash_attention_with_lse_plain(q, k, v, causal, strict)
    delta = flash_bwd_delta_plain(o, do, g_lse)
    parts = (flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, strict),
             *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, strict))
    whole = flash_attention_bwd_plain(q, k, v, o, lse, do, g_lse, causal,
                                      strict)
    assert all(torch.equal(a, b) for a, b in zip(parts, whole))


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never fall back to the plain versions: a CPU tensor
    is refused before any build or launch."""
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_fwd_cuda(x, x, x, causal=True)
    row = x[..., 0]
    for launch, args in ((flash_bwd_cuda, (x, x, x, x, row, x, row)),
                         (flash_bwd_delta_cuda, (x, x, row)),
                         (flash_bwd_dkv_cuda, (x, x, x, x, row, row)),
                         (flash_bwd_dq_cuda, (x, x, x, x, row, row))):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            launch(*args)
