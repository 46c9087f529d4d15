"""The port's sequence-parallel attention against JAX's, on the CPU.

The same numpy-seeded ``[B, T, H, D]`` inputs go through JAX's
``ring_attention``/``ulysses_attention`` on the 8-device CPU mesh that
tests/conftest.py forces (its flash blocks are the Pallas kernels in
interpret mode, as tests/test_ring_attention.py runs them) and through
the port's on a mesh of CPU ranks of the same shape (data 2 x seq n,
n 2 and 4). Forward and q/k/v gradients of ``sum(out * w)`` agree
within 2e-5 (tests/test_torch_parity.py's bar), every form: the dense
and the flash blocks, causal or not, striped and contiguous, Ulysses
dense and on the flash kernels.

Also: a strict-causal block's row 0 (no live key: ``o`` 0, LSE
NEG_BIG, gradients finite through the log-space merge, the LSE's
cotangent included) against JAX's kernel; the no-``seq``-axis
fallbacks; ``block_impl="auto"``'s resolution; the argument checks; the
stripe permutation; a data row's own seq devices inside ``data_row``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from split_learning_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_lse)
from split_learning_tpu.ops.ring_attention import (
    _resolve_block_impl as jax_resolve, full_attention as jax_full,
    ring_attention as jax_ring, stripe_permutation as jax_stripe,
    ulysses_attention as jax_ulysses)
from split_learning_tpu_torch.ops.common import NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    flash_attention_with_lse)
from split_learning_tpu_torch.ops.ring_attention import (
    _merge, _resolve_block_impl, full_attention, ring_attention,
    stripe_permutation, ulysses_attention)
from split_learning_tpu_torch.parallel.mesh import data_row, make_mesh

B, T, H, D = 4, 16, 4, 8
TOL = 2e-5


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))


def _meshes(n):
    jmesh = JaxMesh(np.asarray(jax.devices()[:2 * n]).reshape(2, n),
                    ("data", "seq"))
    return jmesh, make_mesh(num_clients=2, seq_parallel=n, device="cpu")


def _jax_run(fn, q, k, v, w):
    """JAX's output and q/k/v gradients of ``sum(fn(q, k, v) * w)``."""
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_run(fn, q, k, v, w):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(port, jax_res, tol=TOL):
    (o, gs), (jo, jgs) = port, jax_res
    np.testing.assert_allclose(o, jo, rtol=tol, atol=tol)
    for g, jg in zip(gs, jgs):
        np.testing.assert_allclose(g, jg, rtol=tol, atol=tol)


RING_CASES = [(impl, causal, layout)
              for impl in ("dense", "flash")
              for causal, layout in ((False, "contiguous"),
                                     (True, "contiguous"),
                                     (True, "striped"))]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl,causal,layout", RING_CASES)
def test_ring_matches_jax(n, impl, causal, layout):
    q, k, v, w = _inputs(n)
    jmesh, mesh = _meshes(n)
    kw = dict(causal=causal, block_impl=impl, layout=layout)
    want = _jax_run(lambda a, b, c: jax_ring(a, b, c, mesh=jmesh, **kw),
                    q, k, v, w)
    got = _port_run(lambda a, b, c: ring_attention(a, b, c, mesh=mesh, **kw),
                    q, k, v, w)
    _close(got, want)
    # and both are attention: the dense reference within the same bar
    dense = jax_full(q, k, v, causal=causal)
    np.testing.assert_allclose(got[0], np.asarray(dense), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(n, impl, causal):
    q, k, v, w = _inputs(10 + n)
    jmesh, mesh = _meshes(n)
    kw = dict(causal=causal, block_impl=impl)
    want = _jax_run(lambda a, b, c: jax_ulysses(a, b, c, mesh=jmesh, **kw),
                    q, k, v, w)
    got = _port_run(
        lambda a, b, c: ulysses_attention(a, b, c, mesh=mesh, **kw),
        q, k, v, w)
    _close(got, want)


def test_strict_block_row_zero_matches_jax():
    """A strict-causal block (a striped ring's hop from a later rank):
    row 0 has no key, so ``o`` is 0 and the LSE NEG_BIG; with a
    cotangent on both outputs the gradients equal JAX's kernel's, and
    merging the block into an empty partial (the ring's first merge)
    leaves everything finite with no NaN in the backward."""
    q, k, v, w = _inputs(3)
    wl = np.random.RandomState(4).randn(B, T, H).astype(np.float32)

    def jloss(a, b, c):
        o, lse = jax_flash_lse(a, b, c, causal=True, strict=True)
        return jnp.sum(o * w) + jnp.sum(jnp.maximum(lse, -1e4) * wl)

    jo, jlse = jax_flash_lse(q, k, v, causal=True, strict=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = flash_attention_with_lse(qt, kt, vt, causal=True, strict=True)
    loss = (o * torch.tensor(w)).sum() \
        + (lse.clamp(min=-1e4) * torch.tensor(wl)).sum()
    g = torch.autograd.grad(loss, (qt, kt, vt))
    assert (o[:, 0] == 0).all() and (lse[:, 0] == NEG_BIG).all()
    np.testing.assert_array_equal(lse[:, 0].detach().numpy(),
                                  np.asarray(jlse)[:, 0])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=TOL, atol=TOL)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    o0 = torch.zeros(B, T, H, D)
    lse0 = torch.full((B, T, H), NEG_BIG)
    om, lm = _merge(o0, lse0, *flash_attention_with_lse(
        qt, kt, vt, causal=True, strict=True))
    assert torch.isfinite(om).all() and (om[:, 0] == 0).all()
    assert (lm[:, 0] <= NEG_BIG / 2).all()
    gm = torch.autograd.grad((om * torch.tensor(w)).sum(), (qt, kt, vt))
    assert all(torch.isfinite(x).all() for x in gm)


@pytest.mark.parametrize("fn,jfn", [(ring_attention, jax_ring),
                                    (ulysses_attention, jax_ulysses)])
@pytest.mark.parametrize("impl", ["dense", "flash", "auto"])
def test_no_seq_axis_falls_back(fn, jfn, impl):
    """No mesh, or a mesh without ``seq``: the single-device math
    (dense, or the flash kernels for ``block_impl="flash"``), as JAX's."""
    q, k, v, w = _inputs(5)
    for causal in (False, True):
        want = np.asarray(jfn(q, k, v, mesh=None, causal=causal,
                              block_impl=impl))
        for mesh in (None, make_mesh(num_clients=2, device="cpu")):
            got = fn(*map(torch.tensor, (q, k, v)), mesh=mesh,
                     causal=causal, block_impl=impl).numpy()
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_auto_block_impl_resolution(monkeypatch):
    """JAX's memory rule and its SLT_FLASH_AUTO_T override resolve alike
    (JAX's speed rule applies on the TPU only)."""
    monkeypatch.delenv("SLT_FLASH_AUTO_T", raising=False)
    cases = [("dense", 4, 1 << 20, 1 << 20, 4, 4),
             ("flash", 4, 8, 8, 4, 4), ("auto", 4, 32, 32, 4, 4),
             ("auto", 4, 1 << 20, 1 << 20, 4, 4),
             ("auto", 16, 4096, 1 << 22, 2, 4)]
    for args in cases:
        want = jax_resolve(*args)
        assert _resolve_block_impl(*args) == want
    monkeypatch.setenv("SLT_FLASH_AUTO_T", "256")
    for args in (("auto", 4, 256, 256, 4, 4), ("auto", 4, 128, 128, 4, 4)):
        assert _resolve_block_impl(*args) == jax_resolve(*args)
    # a mesh ring with "auto" resolves per rank: flash past the override,
    # and then striped (a causal flash ring), bit-equal to that request
    q, k, v, _ = _inputs(6)
    mesh = make_mesh(seq_parallel=2, device="cpu")
    monkeypatch.setenv("SLT_FLASH_AUTO_T", "4")
    args = [torch.tensor(x) for x in (q, k, v)]
    auto = ring_attention(*args, mesh=mesh, causal=True)
    explicit = ring_attention(*args, mesh=mesh, causal=True,
                              block_impl="flash", layout="striped")
    assert torch.equal(auto, explicit)


def test_argument_checks_and_permutation():
    x = torch.zeros(2, 8, 3, 4)
    mesh = make_mesh(seq_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="block_impl"):
        ring_attention(x, x, x, block_impl="bogus")
    with pytest.raises(ValueError, match="layout"):
        ring_attention(x, x, x, layout="bogus")
    with pytest.raises(ValueError, match="block_impl"):
        ulysses_attention(x, x, x, block_impl="bogus")
    with pytest.raises(ValueError, match="divisible by the seq axis"):
        ulysses_attention(x, x, x, mesh=mesh)   # 3 heads over 2 ranks
    for t, n in ((16, 4), (12, 3), (8, 1)):
        np.testing.assert_array_equal(stripe_permutation(t, n),
                                      jax_stripe(t, n))
        perm = stripe_permutation(t, n)
        np.testing.assert_array_equal(perm[np.argsort(perm)], np.arange(t))


def test_data_row_uses_its_own_seq_devices():
    """Inside ``data_row(mesh, d)`` a form takes its inputs as row d's
    and shards them over that row's seq ranks only: the result is the
    row's slice of the whole-batch call."""
    q, k, v, _ = _inputs(7)
    mesh = make_mesh(num_clients=2, seq_parallel=2, device="cpu")
    args = [torch.tensor(x) for x in (q, k, v)]
    whole = ring_attention(*args, mesh=mesh, causal=True)
    with data_row(mesh, 1):
        row = ring_attention(*(a[B // 2:] for a in args), mesh=mesh,
                             causal=True)
    torch.testing.assert_close(row, whole[B // 2:], rtol=0, atol=0)
    torch.testing.assert_close(whole, full_attention(*args, causal=True),
                               rtol=TOL, atol=TOL)
