"""The port's U-shaped split against the JAX package's, on the CPU.

``USplitClientTrainer`` + ``LocalTransport`` (or ``HttpTransport`` to a
``SplitHTTPServer``) + ``ServerRuntime(mode="u_split")`` of the port
against the same of JAX, from one flax init (carried across with
``interop.params_from_jax``) on the same seeded batches: the CNN (batch
8) and a small causal LM (d_model 32, 2 heads, 1 + 1 blocks, T 16,
vocab 64; ``attn="full"``, which keeps JAX's compile time small), in
float32 and bfloat16, over every wire mode. The client owns stage A and
the head C; labels and logits stay with it.

Tolerances of the loss series, the two-party ones
(tests/test_torch_port_two_party_lm.py): float32 within 1e-4 without a
wire and on the dense wire, 1e-3 on int8, topk8 and clapping; bfloat16
within two bfloat16 ulps at the loss's magnitude (``bf16_loss_tol``),
four times that on the compressed wires. The wire byte totals equal
JAX's, and the U-hop request frames are byte-equal to JAX's for the same
tensors, on the local wire and over HTTP.

The protocol, as the same script on both stacks where JAX has it: the
residual caps and FIFO evictions (per client and in all), an unknown
step (409) and an op of another mode (400), a duplicate hop 1 served
from the replay cache with its residual kept, an acknowledged step that
never goes backwards, and a chaos twin (duplicates and delays only: the
U client has no retry policy) that drops no batch.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ProtocolError as JaxProtocolError
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import USplitClientTrainer as JaxUClient
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.transport import codec as jax_codec
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    ProtocolError, ServerRuntime, USplitClientTrainer)
from split_learning_tpu_torch.transport import (
    ChaosPolicy, ChaosTransport, HttpTransport, LocalTransport,
    SplitHTTPServer, codec)
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_train_bf16 import bf16_loss_tol

MODELS = ("split_cnn", "transformer_lm")
WIRES = (None, "none", "int8", "topk8", "clapping")
WIRE_FIELDS = ("round_trips", "bytes_sent", "bytes_received")
STEPS, TIMEOUT = 4, 30.0
LM_B, LM_T, LM_V = 4, 16, 64
LM_SIZE = dict(vocab=LM_V, d_model=32, num_heads=2, client_depth=1,
               server_depth=1, max_len=64, attn="full")
F32_TOL = {None: 1e-4, "none": 1e-4, "int8": 1e-3, "topk8": 1e-3,
           "clapping": 1e-3}
BF16_WIRE_FACTOR = 4


@functools.lru_cache(maxsize=None)
def _data(model):
    if model == "split_cnn":
        ds = jds.synthetic("mnist", n_train=8 * STEPS, n_test=8, seed=3)
        return list(jds.batches(ds.train, 8, seed=3))
    ds = jds.synthetic_lm(n_train=LM_B * STEPS, n_test=LM_B, vocab=LM_V,
                          seq_len=LM_T, seed=4)
    return list(jds.batches(ds.train, LM_B, seed=4))


def _size(model):
    return LM_SIZE if model == "transformer_lm" else {}


# SGD for the CNN at an lr whose loss falls on these batches; the LM
# under AdamW with warmup, cosine decay and clipping, as its users
# configure it (tests/test_torch_port_two_party_lm.py)
LM_OPTIM = dict(optimizer="adamw", lr=3e-3, weight_decay=0.1,
                warmup_steps=1, decay_steps=STEPS, grad_clip_norm=1.0)


def _cfg(model, dtype):
    optim = LM_OPTIM if model == "transformer_lm" else dict(lr=0.002)
    return dict(mode="u_split", model=model, batch_size=8, dtype=dtype,
                **optim)


def _jax_plan(model, dtype):
    return jax_get_plan(model=model, mode="u_split", dtype=dtype,
                        **_size(model))


def _plan(model, dtype):
    return get_plan(model=model, mode="u_split", dtype=dtype, **_size(model))


@functools.lru_cache(maxsize=None)
def _init(model, dtype):
    """The JAX init in the port's layout (each party copies what it
    keeps, so one tuple serves every case)."""
    return params_from_jax(_jax_plan(model, dtype).init(
        jax.random.PRNGKey(0), jnp.asarray(_data(model)[0][0])))


def _jax_server(model, dtype):
    return JaxServer(_jax_plan(model, dtype), JaxConfig(**_cfg(model, dtype)),
                     jax.random.PRNGKey(0), _data(model)[0][0])


def _jax_client(model, dtype, transport):
    return JaxUClient(_jax_plan(model, dtype),
                      JaxConfig(**_cfg(model, dtype)), jax.random.PRNGKey(0),
                      transport)


def _port_server(model="split_cnn", dtype="float32", **kw):
    return ServerRuntime(_plan(model, dtype), Config(**_cfg(model, dtype)),
                         _init(model, dtype), device="cpu", **kw)


def _port_client(model, dtype, transport, client_id=0):
    return USplitClientTrainer(_plan(model, dtype),
                               Config(**_cfg(model, dtype)),
                               _init(model, dtype), transport,
                               client_id=client_id, device="cpu")


def _train(client, data):
    return np.asarray([client.train_step(x, y, i)
                       for i, (x, y) in enumerate(data)])


@functools.lru_cache(maxsize=None)
def _jax_pair(model, dtype, compress):
    """The JAX U pair's loss series and wire totals (one run a case)."""
    jt = JaxLocal(_jax_server(model, dtype), compress=compress)
    losses = _train(_jax_client(model, dtype, jt), _data(model))
    return losses, tuple(getattr(jt.stats, f) for f in WIRE_FIELDS)


def _assert_tracks(losses, j_losses, dtype, compress):
    if dtype == "float32":
        np.testing.assert_allclose(losses, j_losses, atol=F32_TOL[compress])
    else:
        wide = 1 if compress in (None, "none") else BF16_WIRE_FACTOR
        tol = np.array([wide * bf16_loss_tol(v) for v in j_losses])
        assert (np.abs(losses - j_losses) <= tol).all(), (losses, j_losses)


def assert_u_pair_tracks_jax_pair(model, dtype, compress):
    j_losses, j_wire = _jax_pair(model, dtype, compress)
    server = _port_server(model, dtype)
    transport = LocalTransport(server, compress=compress)
    client = _port_client(model, dtype, transport)
    losses = _train(client, _data(model))
    _assert_tracks(losses, j_losses, dtype, compress)
    assert tuple(getattr(transport.stats, f) for f in WIRE_FIELDS) == j_wire
    # each optimizer state counted its own updates; the leaves keep the
    # plan's dtypes
    assert (client.state_a.step == client.state_c.step
            == server.state.step == STEPS)
    assert server.health()["step"] == STEPS - 1
    assert not server._u_residual
    for stage in (*client.params, server.params):
        for k, v in stage.items():
            want = (torch.bfloat16 if dtype == "bfloat16" and k == "pos"
                    else torch.float32)
            assert v.dtype == want, k


@pytest.mark.parametrize("compress", WIRES)
@pytest.mark.parametrize("dtype", ["float32"])
@pytest.mark.parametrize("model", ["split_cnn"])
def test_u_pair_tracks_jax_pair(model, dtype, compress):
    assert_u_pair_tracks_jax_pair(model, dtype, compress)


def _capture_jax_local(transport, frames):
    """Record the frame JAX's ``LocalTransport`` encodes each way."""
    wire = transport._wire

    def capturing(payload):
        frames.append(jax_codec.encode(payload))
        return wire(payload)

    transport._wire = capturing


def _capture_port_local(transport, frames):
    wire = transport._wire

    def capturing(payload, device):
        frames.append(codec.encode(payload))
        return wire(payload, device)

    transport._wire = capturing


def _hop_tensors(dtype):
    rs = np.random.RandomState(7)
    acts = [rs.randn(8, 26, 26, 32).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        acts = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in acts]
    return acts


def _hops(transport, acts, as_tensor):
    """Three U steps of fixed tensors: hop 1 with ``acts``, hop 2 with a
    feature gradient derived from the features."""
    from split_learning_tpu_torch.utils.arrays import from_host, to_host
    for i, a in enumerate(acts):
        feats = transport.u_forward(from_host(a) if as_tensor else a, i)
        g = 0.01 * (to_host(feats) if isinstance(feats, torch.Tensor)
                    else np.asarray(feats))
        transport.u_backward(from_host(g) if as_tensor else g, i)


def assert_u_hop_frames_local(compress, dtype):
    """The same tensors through JAX's ``LocalTransport`` (numpy) and the
    port's (CPU tensors, as the trainer hands them), both to a port U
    server: every frame of both hops, each way, byte-equal over three
    steps (the error-feedback ledgers included)."""
    acts = _hop_tensors(dtype)
    frames = {"jax": [], "port": []}
    jt = JaxLocal(_port_server(dtype=dtype), compress=compress)
    _capture_jax_local(jt, frames["jax"])
    _hops(jt, acts, as_tensor=False)
    t = LocalTransport(_port_server(dtype=dtype), compress=compress)
    _capture_port_local(t, frames["port"])
    _hops(t, acts, as_tensor=True)
    assert len(frames["port"]) == 12
    assert frames["port"] == frames["jax"]
    for f in ("round_trips", "bytes_sent", "bytes_received"):
        assert getattr(t.stats, f) == getattr(jt.stats, f)


def _capture_http(server):
    bodies = []
    handler = server._httpd.RequestHandlerClass
    do_post = handler.do_POST

    def capturing(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        bodies.append((self.path, raw))
        self.rfile = io.BytesIO(raw)
        do_post(self)

    handler.do_POST = capturing
    return bodies


def _http_pair(server_rt, server_cls, transport_cls, client_fn, model,
               compress):
    srv = server_cls(server_rt).start()
    t = transport_cls(srv.url, timeout=TIMEOUT, compress=compress)
    try:
        return _train(client_fn(t), _data(model))
    finally:
        t.close()
        srv.stop()


def test_u_pair_over_http_tracks_jax_pair():
    j_losses, _ = _jax_pair("split_cnn", "float32", "topk8")
    server = _port_server()
    losses = _http_pair(server, SplitHTTPServer, HttpTransport,
                        lambda t: _port_client("split_cnn", "float32", t),
                        "split_cnn", "topk8")
    np.testing.assert_allclose(losses, j_losses, atol=F32_TOL["topk8"])
    assert server.health()["step"] == STEPS - 1


_ACTS = np.zeros((2, 26, 26, 32), np.float32)
_GRADS = np.zeros((2, 12 * 12 * 64), np.float32)


def _jax_u_server():
    plan = jax_get_plan(mode="u_split")
    return JaxServer(plan, JaxConfig(mode="u_split"), jax.random.PRNGKey(1),
                     np.zeros((8, 28, 28, 1), np.float32))


def _port_u_server():
    return ServerRuntime(get_plan(mode="u_split"), Config(mode="u_split"),
                         torch.Generator().manual_seed(1), device="cpu")


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_residual_cap_per_client_is_fifo(stack):
    server = _jax_u_server() if stack == "jax" else _port_u_server()
    t = (JaxLocal if stack == "jax" else LocalTransport)(server)
    err = JaxProtocolError if stack == "jax" else ProtocolError
    cap = server.MAX_PENDING_RESIDUALS
    assert cap == 8
    for s in range(cap + 3):
        t.u_forward(_ACTS, step=s)  # the client dies before every hop 2
    assert sorted(server._u_residual) == [(0, s) for s in range(3, cap + 3)]
    with pytest.raises(err) as exc:
        t.u_backward(_GRADS, step=0)   # evicted: unknown step
    assert exc.value.status == 409
    assert t.u_backward(_GRADS, step=cap + 2).shape == _ACTS.shape


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_residual_eviction_per_client_and_in_all(stack):
    """One client's backlog never evicts another's residual; the global
    cap (64) reclaims the oldest across clients."""
    server = _jax_u_server() if stack == "jax" else _port_u_server()
    t = (JaxLocal if stack == "jax" else LocalTransport)(server)
    n = server.MAX_PENDING_RESIDUALS + 3
    for cid in range(n):
        t.u_forward(_ACTS, step=0, client_id=cid)
    for cid in range(n):
        assert t.u_backward(_GRADS, step=0, client_id=cid).shape == \
            _ACTS.shape
    assert server.MAX_TOTAL_RESIDUALS == 64
    for cid in range(9):           # 9 clients x 8 steps = 72 > 64
        for s in range(1, 9):
            t.u_forward(_ACTS, step=s, client_id=cid)
    assert len(server._u_residual) == 64
    # the oldest of all went: client 0's steps 1-8
    assert not any(k[0] == 0 for k in server._u_residual)
    assert sum(k[0] == 1 for k in server._u_residual) == 8


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_mode_guards_and_unknown_step_over_http(stack):
    """Over a socket, each stack's server answers its own client: an op
    of another mode is a 400 (split_step on a U server, u_forward on a
    split server, aggregate on either), an unknown step a 409; both
    permanent (ProtocolError)."""
    if stack == "jax":
        u_srv = JaxHTTPServer(_jax_u_server()).start()
        split_rt = JaxServer(jax_get_plan(mode="split"), JaxConfig(),
                             jax.random.PRNGKey(1),
                             np.zeros((8, 28, 28, 1), np.float32))
        split_srv = JaxHTTPServer(split_rt).start()
        cls, err = JaxHttp, JaxProtocolError
    else:
        u_srv = SplitHTTPServer(_port_u_server()).start()
        split_srv = SplitHTTPServer(ServerRuntime(
            get_plan(), Config(), torch.Generator().manual_seed(1),
            device="cpu")).start()
        cls, err = HttpTransport, ProtocolError
    tu, ts = cls(u_srv.url, timeout=TIMEOUT), cls(split_srv.url,
                                                 timeout=TIMEOUT)
    try:
        statuses = []
        for call in (lambda: tu.split_step(_ACTS, np.zeros(2, np.int64), 0),
                     lambda: ts.u_forward(_ACTS, 0),
                     lambda: ts.u_backward(_GRADS, 0),
                     lambda: tu.aggregate({"w": np.zeros(2, np.float32)},
                                          0, 0.0, 0),
                     lambda: tu.u_backward(_GRADS, 5)):
            with pytest.raises(err) as exc:
                call()
            statuses.append(getattr(exc.value, "status", None))
        if stack == "port":
            assert statuses == [400, 400, 400, 400, 409]
        # the U server is healthy and reports its mode
        h = tu.health()
        assert (h["mode"], h["model_type"]) == ("u_split", "trunk_b")
    finally:
        tu.close()
        ts.close()
        u_srv.stop()
        split_srv.stop()


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_duplicate_hop1_is_replayed_and_keeps_its_residual(stack):
    server = _jax_u_server() if stack == "jax" else _port_u_server()
    t = (JaxLocal if stack == "jax" else LocalTransport)(server)
    acts = np.random.RandomState(0).randn(2, 26, 26, 32).astype(np.float32)
    f0 = np.asarray(t.u_forward(acts, step=0))
    f1 = np.asarray(t.u_forward(acts * 2, step=0))  # a duplicate delivery
    np.testing.assert_array_equal(f0, f1)           # the original reply
    assert server.replay.hits == 1
    assert list(server._u_residual) == [(0, 0)]     # kept for hop 2
    g = np.asarray(t.u_backward(0.01 * f0, step=0))
    g_dup = np.asarray(t.u_backward(5.0 * f0, step=0))  # duplicate hop 2
    np.testing.assert_array_equal(g, g_dup)
    assert server.replay.hits == 2 and not server._u_residual
    assert server.health()["step"] == 0


def test_duplicate_hop1_matches_jax_numbers():
    """The replayed features and the hop-2 gradient of the port's U
    server equal JAX's on the same init and tensors (float32, 1e-5)."""
    jserver = _jax_server("split_cnn", "float32")
    server = _port_server()
    acts = np.random.RandomState(0).randn(8, 26, 26, 32).astype(np.float32)
    got, want = [], []
    for srv, out in ((jserver, want), (server, got)):
        t = (JaxLocal if srv is jserver else LocalTransport)(srv)
        f = np.asarray(t.u_forward(acts, 0))
        out += [f, np.asarray(t.u_forward(acts, 0)),
                np.asarray(t.u_backward(0.01 * f, 0))]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_acknowledged_step_never_goes_backwards(stack):
    """With the strict handshake off, steps may complete out of order;
    the acknowledged step (what /health reports) stays at the highest."""
    if stack == "jax":
        server = JaxServer(jax_get_plan(mode="u_split"),
                           JaxConfig(mode="u_split"), jax.random.PRNGKey(1),
                           np.zeros((8, 28, 28, 1), np.float32),
                           strict_steps=False)
        t = JaxLocal(server)
    else:
        server = ServerRuntime(get_plan(mode="u_split"),
                               Config(mode="u_split"),
                               torch.Generator().manual_seed(1),
                               strict_steps=False, device="cpu")
        t = LocalTransport(server)
    for s in (3, 1):
        t.u_forward(_ACTS, step=s)
    t.u_backward(_GRADS, step=3)
    t.u_backward(_GRADS, step=1)
    assert server.health()["step"] == 3
    assert server._last_step == {0: 3}


def test_chaos_twin_drops_no_batch():
    """Duplicates and delays on both hops (the U client has no retry
    policy, so no fault that loses a reply): every duplicate is served
    from the replay cache, no batch is dropped, and the losses equal a
    clean run's bit for bit. The wire is int8, whose packing keeps no
    state: a duplicate through topk8 would fold the error-feedback
    residual twice, a different run by design."""
    data = _data("split_cnn")
    clean = _train(_port_client("split_cnn", "float32", LocalTransport(
        _port_server(), compress="int8")), data)
    server = _port_server()
    policy = ChaosPolicy("dup=0.4,delay=0.2:1", seed=3)
    chaos = ChaosTransport(LocalTransport(server, compress="int8"), policy)
    losses = _train(_port_client("split_cnn", "float32", chaos), data)
    np.testing.assert_array_equal(losses, clean)
    assert policy.injected.get("dup", 0) >= 1
    assert server.replay.hits == policy.injected["dup"]
    assert chaos.stats.counters["chaos_dup"] == policy.injected["dup"]
    assert server.health()["step"] == STEPS - 1


def test_chaos_wrapper_passes_the_three_ops_through():
    """``ChaosTransport`` draws faults on the U hops (their own paths in
    the schedule) and passes ``aggregate`` through untouched."""
    calls = []

    class Inner(LocalTransport):
        def __init__(self):
            super().__init__(server=None)

        def u_forward(self, a, step, client_id=0):
            calls.append(("u_forward", step, client_id))
            return a

        def u_backward(self, g, step, client_id=0):
            calls.append(("u_backward", step, client_id))
            return g

        def aggregate(self, params, epoch, loss, step, num_examples=None):
            calls.append(("aggregate", epoch, step, num_examples))
            return params

    policy = ChaosPolicy("dup=1.0", seed=0)
    chaos = ChaosTransport(Inner(), policy)
    assert chaos.u_forward(1, 5, 2) == 1
    assert chaos.u_backward(2, 5, 2) == 2
    assert chaos.aggregate({"w": 3}, 1, 0.5, 9, 64) == {"w": 3}
    # dup delivers each hop twice; aggregate once, never faulted
    assert calls == [("u_forward", 5, 2)] * 2 + [("u_backward", 5, 2)] * 2 \
        + [("aggregate", 1, 9, 64)]
    assert policy.draw("/u_forward", 5) == policy.draw("/u_forward", 5)


def test_evaluate_the_u_composition():
    """The launcher's ``--eval`` of a U run: ``evaluate`` over [A, trunk,
    C] equals JAX's on the same parameters (loss within 1e-5), and
    ``evaluate_remote`` with A and C around the server's trunk (the HTTP
    run's form) equals ``evaluate``."""
    from split_learning_tpu.runtime.evaluate import evaluate as jax_evaluate
    from split_learning_tpu_torch.runtime import evaluate, evaluate_remote
    ds = jds.synthetic("mnist", n_train=8, n_test=40, seed=5)
    jparams = _jax_plan("split_cnn", "float32").init(
        jax.random.PRNGKey(0), jnp.asarray(_data("split_cnn")[0][0]))
    params = params_from_jax(jparams)
    plan = _plan("split_cnn", "float32")
    got = evaluate(plan, params, ds.test, batch_size=16)
    want = jax_evaluate(_jax_plan("split_cnn", "float32"), jparams, ds.test,
                        batch_size=16)
    assert got["accuracy"] == want["accuracy"]
    assert got["examples"] == want["examples"] == 40
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    server = _port_server()
    remote = evaluate_remote(plan, [params[0], params[2]],
                             LocalTransport(server), ds.test, batch_size=16)
    assert remote["accuracy"] == got["accuracy"]
    np.testing.assert_allclose(remote["loss"], got["loss"], rtol=1e-6)
