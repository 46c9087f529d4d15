"""The two-party transformer against the JAX pair, on the CPU.

``SplitClientTrainer`` + ``LocalTransport`` + ``ServerRuntime`` of the
port against the same three of JAX, on both transformer families, from
one flax init (carried across with ``interop.params_from_jax``) on the
same seeded batches. The client owns the embedding and block 0, the
server block 1 and the head; the LM's server gets labels ``[B, T]``.
Both parties run AdamW with warmup, cosine decay and clipping, each
clipping over its own stage (the JAX ``make_tx`` scope note). The cut
crosses in the plan's dtype: bfloat16 frames for a bfloat16 plan, where
JAX's side reads and writes ``ml_dtypes`` arrays.

Tolerances of the loss series: float32 within 1e-4 on the dense wires
and 1e-3 on the compressed ones (``PERF.md`` §2, the bar of
tests/test_torch_port_two_party.py). bfloat16 within two bfloat16 ulps at
the loss's magnitude on the dense wires (tests/test_torch_port_train_bf16.py
derives it; JAX's server runs optax's cross-entropy in bfloat16 where the
port's K1 runs in float32), and within ``BF16_WIRE_FACTOR`` (4) times
that on int8 and topk8. As the float32 bar widens tenfold for them: a
cut value an ulp from an int8 rounding boundary or from the top-k
threshold lands on either side, and a bfloat16 cut has many threshold
ties (8 significant bits), so one ulp of drift moves a whole kept value
in or out. Observed over three data seeds: up to 5.4 ulps on topk8 (the
classifier), 1.4 on int8. Mixed pairs, a port client through JAX's
transport to JAX's server and a JAX client through the port's to the
port's, train in bfloat16 and track the JAX pair within the same bounds.
The classifier's pairs are in tests/test_torch_port_two_party_transformer.py
and the HTTP half in tests/test_torch_port_two_party_lm_http.py; both
share these helpers.

Attention is ``"full"`` here, which keeps JAX's compile time small; the
flash path's training arithmetic is held in
tests/test_torch_port_train_bf16.py and on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import ServerRuntime, SplitClientTrainer
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_train_bf16 import bf16_loss_tol

WIRE_FIELDS = ("round_trips", "bytes_sent", "bytes_received")
B, T, V, STEPS = 4, 16, 64, 5
SIZE = dict(vocab=V, d_model=32, num_heads=2, client_depth=1,
            server_depth=1, max_len=64, attn="full")
OPTIM = dict(optimizer="adamw", lr=3e-3, weight_decay=0.1, warmup_steps=1,
             decay_steps=STEPS, grad_clip_norm=1.0)
F32_TOL = {None: 1e-4, "none": 1e-4, "int8": 1e-3, "topk8": 1e-3}
BF16_WIRE_FACTOR = 4


def _data(model):
    make = jds.synthetic_lm if model == "transformer_lm" \
        else jds.synthetic_tokens
    ds = make(n_train=B * STEPS, n_test=B, vocab=V, seq_len=T, seed=4)
    return list(jds.batches(ds.train, B, seed=4))


def _cfg(model, dtype):
    return dict(model=model, batch_size=B, dtype=dtype, **OPTIM)


def _jax_plan(model, dtype):
    return jax_get_plan(model=model, dtype=dtype, **SIZE)


def _plan(model, dtype):
    return get_plan(model=model, dtype=dtype, **SIZE)


def _init(model, dtype, data):
    return params_from_jax(_jax_plan(model, dtype).init(
        jax.random.PRNGKey(0), jnp.asarray(data[0][0])))


def _jax_server(model, dtype, data):
    return JaxServer(_jax_plan(model, dtype), JaxConfig(**_cfg(model, dtype)),
                     jax.random.PRNGKey(0), data[0][0])


def _jax_client(model, dtype, transport):
    return JaxClient(_jax_plan(model, dtype),
                     JaxConfig(**_cfg(model, dtype)), jax.random.PRNGKey(0),
                     transport)


def _port_server(model, dtype, data):
    return ServerRuntime(_plan(model, dtype), Config(**_cfg(model, dtype)),
                         _init(model, dtype, data), device="cpu")


def _port_client(model, dtype, data, transport):
    return SplitClientTrainer(_plan(model, dtype),
                              Config(**_cfg(model, dtype)),
                              _init(model, dtype, data), transport,
                              device="cpu")


def _train(client, data):
    return np.asarray([client.train_step(x, y, i)
                       for i, (x, y) in enumerate(data)])


@functools.lru_cache(maxsize=None)
def _jax_pair(model, dtype, compress):
    """The JAX pair's loss series and wire totals (one run per case)."""
    data = _data(model)
    jt = JaxLocal(_jax_server(model, dtype, data), compress=compress)
    losses = _train(_jax_client(model, dtype, jt), data)
    return losses, tuple(getattr(jt.stats, f) for f in WIRE_FIELDS)


def _assert_tracks(losses, j_losses, dtype, compress):
    if dtype == "float32":
        np.testing.assert_allclose(losses, j_losses,
                                   atol=F32_TOL[compress])
    else:
        wide = 1 if compress in (None, "none") else BF16_WIRE_FACTOR
        tol = np.array([wide * bf16_loss_tol(v) for v in j_losses])
        assert (np.abs(losses - j_losses) <= tol).all(), (losses, j_losses)


def assert_pair_tracks_jax(model, dtype, compress):
    """The port pair on ``model`` against the JAX pair: the loss series,
    the wire totals, the leaves' and moments' dtypes, the step counts."""
    data = _data(model)
    j_losses, j_wire = _jax_pair(model, dtype, compress)
    server = _port_server(model, dtype, data)
    transport = LocalTransport(server, compress=compress)
    client = _port_client(model, dtype, data, transport)
    losses = _train(client, data)
    _assert_tracks(losses, j_losses, dtype, compress)
    assert tuple(getattr(transport.stats, f) for f in WIRE_FIELDS) == j_wire
    # each party keeps its leaves in the plan's dtypes; the moments too
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert client.params["pos"].dtype == want
    assert all(v.dtype == torch.float32 for k, v in client.params.items()
               if k != "pos")
    assert all(v.dtype == torch.float32 for v in server.params.values())
    mu, nu = client.state.opt_state
    assert [m.dtype for m in mu] == [p.dtype for p in client.params.values()]
    assert client.state.step == server.state.step == STEPS


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_party_lm_tracks_jax_pair(dtype, compress):
    assert_pair_tracks_jax("transformer_lm", dtype, compress)


def test_the_cut_and_its_gradient_keep_bf16_on_the_wire():
    data = _data("transformer_lm")
    server = _port_server("transformer_lm", "bfloat16", data)
    seen = {}
    step = server.split_step

    def spy(acts, labels, *a, **kw):
        seen["acts"] = acts.dtype
        g, loss = step(acts, labels, *a, **kw)
        seen["grads"] = g.dtype
        return g, loss

    server.split_step = spy
    for compress in (None, "none", "int8", "topk8"):
        transport = LocalTransport(server, compress=compress)
        client = _port_client("transformer_lm", "bfloat16", data, transport)
        x, y = data[0]
        sent = {}
        client_split = transport.split_step

        def capture(acts, labels, *a, _f=client_split, **kw):
            sent["acts"] = acts.dtype
            g, loss = _f(acts, labels, *a, **kw)
            sent["grads"] = g.dtype
            return g, loss

        transport.split_step = capture
        server._last_step.clear()
        client.train_step(x, y, 0)
        assert seen == {"acts": torch.bfloat16, "grads": torch.bfloat16}
        assert sent == {"acts": torch.bfloat16, "grads": torch.bfloat16}


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_mixed_pairs_train_in_bf16(pair, compress):
    model, dtype = "transformer_lm", "bfloat16"
    data = _data(model)
    j_losses, _ = _jax_pair(model, dtype, compress)
    if pair == "port_client_jax_server":
        client = _port_client(model, dtype, data, JaxLocal(
            _jax_server(model, dtype, data), compress=compress))
    else:
        client = _jax_client(model, dtype, LocalTransport(
            _port_server(model, dtype, data), compress=compress))
    losses = _train(client, data)
    _assert_tracks(losses, j_losses, dtype, compress)
