"""The port's optimizer (``runtime/state.py``) against optax, on the CPU.

- ``make_lr`` against the optax schedules the JAX ``make_lr`` builds,
  called eagerly, bit for bit over steps 0-40: warmup then constant,
  warmup then cosine, cosine with no warmup.
- ``make_tx`` against the JAX ``make_tx`` (optax, its update jitted as
  the JAX trainers run it) on one tree of float32 leaves and one
  bfloat16 leaf, over 1 and 10 updates with seeded gradients, for sgd
  with and without momentum, coupled L2 and clipping, adam, adamw at
  weight decay 0 and 0.1, and a clip that triggers and one that does
  not. The port's SGD with momentum mirrors JAX's Pallas kernel, whose
  trace is float32 for every leaf, where optax's trace takes the leaf's
  dtype: its reference is the same optax chain with the trace in
  float32 (``accumulator_dtype``), which is that kernel's arithmetic.
  Over ten steps at lr 0.1 a bfloat16 trace drifts two ulps from it.

Tolerances. A float32 leaf within 1e-6 relative to its largest
magnitude (an entry that an update brings near 0 keeps the absolute
rounding of its larger neighbours): XLA sums the global norm in another
order and its jitted schedule multiplies by the reciprocal of a constant
where optax divides (an ulp of the lr at some steps). A bfloat16 leaf
within one bfloat16 ulp at its largest magnitude (2**-7 of it): K2
updates a bfloat16 leaf in float32 and rounds once, where optax rounds
the scaled update to bfloat16 first, and XLA may keep excess precision
between fused bfloat16 operations that the port rounds one at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from split_learning_tpu.runtime.state import make_lr as jax_make_lr
from split_learning_tpu.runtime.state import make_tx as jax_make_tx
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.runtime.state import (
    Adam, SGD, Schedule, TrainState, clip_by_global_norm, make_lr, make_state,
    make_tx)
from split_learning_tpu_torch.utils.config import Config

SHAPES = {"w1": (16, 8), "b1": (8,), "w2": (8, 5), "pos": (12, 8)}
BF16 = ("pos",)


@pytest.mark.parametrize("lr", [0.01, 3e-4, 0.05])
@pytest.mark.parametrize("warmup,decay", [(5, 0), (10, 0), (5, 30),
                                          (3, 17), (0, 40), (0, 10)])
def test_make_lr_bit_equal_to_optax(lr, warmup, decay):
    kw = dict(lr=lr, warmup_steps=warmup, decay_steps=decay)
    want = jax_make_lr(JaxConfig(**kw))
    got = make_lr(Config(**kw))
    assert isinstance(got, Schedule)
    for count in range(41):
        w = np.asarray(want(jnp.int32(count)), np.float32)
        g = np.float32(got(count))
        assert g.tobytes() == w.tobytes(), (count, g, w)


def test_make_lr_constant_without_schedule():
    assert make_lr(Config(lr=0.02)) == 0.02


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (rs.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_leaf(k, v):
    return jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)


def _port_leaf(k, v):
    """A copy: the port updates (and clips) in place, and a JAX array on
    the CPU may share the numpy buffer it was made from."""
    t = torch.tensor(np.asarray(v, np.float32))
    return t.bfloat16() if k in BF16 else t


def _host(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _jax_tx(jcfg):
    """The JAX ``make_tx``; for SGD with momentum, its chain with the
    trace in float32, as JAX's Pallas SGD keeps it."""
    if jcfg.optimizer != "sgd" or not jcfg.momentum:
        return jax_make_tx(jcfg)
    tx = optax.sgd(jax_make_lr(jcfg), momentum=jcfg.momentum,
                   accumulator_dtype=jnp.float32)
    if jcfg.weight_decay:
        tx = optax.chain(optax.add_decayed_weights(jcfg.weight_decay), tx)
    if jcfg.grad_clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip_norm), tx)
    return tx


def _run(kw, steps, grad_scale):
    """The same parameters and gradients through optax and the port."""
    p0 = _tree(0, 0.5)
    jparams = {k: _jax_leaf(k, v) for k, v in p0.items()}
    jtx = _jax_tx(JaxConfig(**kw))
    jstate = jtx.init(jparams)

    @jax.jit
    def jstep(params, state, grads):
        updates, state = jtx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    tx = make_tx(Config(**kw))
    state = make_state([{k: _port_leaf(k, v) for k, v in p0.items()}], tx)
    for i in range(steps):
        g = _tree(100 + i, grad_scale)
        jparams, jstate = jstep(jparams, jstate,
                                {k: _jax_leaf(k, v) for k, v in g.items()})
        tx.update(state, [_port_leaf(k, g[k]) for k in SHAPES])
    assert state.step == steps
    return jparams, state.params[0]


def _assert_close(jparams, params):
    for k in SHAPES:
        want, got = _host(jparams[k]), _host(params[k])
        assert params[k].dtype == (torch.bfloat16 if k in BF16
                                   else torch.float32)
        if k in BF16:
            ulp = 2.0 ** -7 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=ulp,
                                       err_msg=k)
        else:
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                       err_msg=k)


# grad scale 0.1 keeps the global norm (about 1.8) under a clip of 4.0
# and over a clip of 0.5
CASES = {
    "sgd": (dict(lr=0.1), 1.0),
    "sgd_momentum": (dict(lr=0.1, momentum=0.9), 1.0),
    "sgd_l2": (dict(lr=0.1, weight_decay=0.01), 1.0),
    "sgd_momentum_l2": (dict(lr=0.1, momentum=0.9, weight_decay=0.01), 1.0),
    "sgd_clip_triggers": (dict(lr=0.1, grad_clip_norm=0.5), 0.1),
    "sgd_momentum_l2_clip": (dict(lr=0.1, momentum=0.9, weight_decay=0.01,
                                  grad_clip_norm=0.5), 0.1),
    "sgd_momentum_warmup_cosine": (dict(lr=0.1, momentum=0.9, warmup_steps=3,
                                        decay_steps=12), 1.0),
    "adam": (dict(optimizer="adam", lr=1e-2), 1.0),
    "adamw_wd0": (dict(optimizer="adamw", lr=1e-2), 1.0),
    "adamw_wd01": (dict(optimizer="adamw", lr=1e-2, weight_decay=0.1), 1.0),
    "adamw_clip_triggers": (dict(optimizer="adamw", lr=1e-2,
                                 weight_decay=0.1, grad_clip_norm=0.5), 0.1),
    "adamw_clip_idle": (dict(optimizer="adamw", lr=1e-2, weight_decay=0.1,
                             grad_clip_norm=4.0), 0.1),
    "adamw_recipe": (dict(optimizer="adamw", lr=1e-2, weight_decay=0.1,
                          warmup_steps=2, decay_steps=10,
                          grad_clip_norm=1.0), 1.0),
}


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("case", sorted(CASES))
def test_make_tx_tracks_optax(case, steps):
    kw, grad_scale = CASES[case]
    _assert_close(*_run(kw, steps, grad_scale))


def test_optimizer_kinds_and_state_dtypes():
    leaves = [{k: _port_leaf(k, v) for k, v in _tree(0).items()}]
    sgd = make_tx(Config(momentum=0.9, weight_decay=0.01))
    assert isinstance(sgd, SGD)
    st = make_state(leaves, sgd)
    # K2's trace is float32 for every leaf, the bf16 one included
    assert all(m.dtype == torch.float32 for m in st.opt_state)
    adamw = make_tx(Config(optimizer="adamw", weight_decay=0.1))
    assert isinstance(adamw, Adam) and adamw.weight_decay == 0.1
    mu, nu = make_state(leaves, adamw).opt_state
    # optax's moments take each leaf's dtype
    assert [t.dtype for t in mu] == [t.dtype for t in nu] == [
        torch.bfloat16 if k in BF16 else torch.float32 for k in SHAPES]
    assert make_state(leaves, make_tx(Config())).opt_state is None


@pytest.mark.parametrize("max_norm,triggers", [(0.5, True), (50.0, False)])
def test_clip_by_global_norm_matches_optax(max_norm, triggers):
    g = _tree(7)
    jg = {k: _jax_leaf(k, v) for k, v in g.items()}
    want, _ = optax.clip_by_global_norm(max_norm).update(jg, None)
    got = [_port_leaf(k, g[k]) for k in SHAPES]
    before = [t.clone() for t in got]
    clip_by_global_norm(got, max_norm)
    for k, b, a in zip(SHAPES, before, got):
        if not triggers:
            assert torch.equal(a, b), k
        tol = 2.0 ** -8 if k in BF16 else 1e-6
        np.testing.assert_allclose(_host(a), _host(want[k]), rtol=tol,
                                   atol=1e-9, err_msg=k)


def test_update_counts_steps_and_checks_lengths():
    leaves = [{k: _port_leaf(k, v) for k, v in _tree(0).items()}]
    tx = make_tx(Config(optimizer="adam", lr=1e-3))
    st = make_state(leaves, tx)
    assert isinstance(st, TrainState) and st.step == 0
    with pytest.raises(ValueError, match="one gradient per parameter"):
        tx.update(st, [torch.zeros(3)])
    assert st.step == 0
