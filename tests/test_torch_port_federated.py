"""The port's federated mode and FedAvg against the JAX package's, on
the CPU.

- ``fedavg_mean`` against JAX's on the same trees within 1e-6 (float32
  leaves; the uniform mean is a ``torch.stack(...).mean(0)`` and the
  weighted one a ``tensordot``, whose summation order may differ from
  XLA's by an ulp), bit for bit over 4 trees of 100,000 values on the
  CPU, and JAX's dtype rule on a bfloat16 leaf: the
  uniform path keeps bfloat16, the weighted path returns float32.
- ``FedAvgAggregator``, JAX's rules: a round of ``num_clients``
  submissions, results keyed by round id and freed after every member
  read them (a slow waiter reads its own round), a timed-out submission
  withdrawn (its retry never counts twice, uniform or weighted), a
  weight <= 0 refused, a mixed weighted/unweighted round uniform with
  JAX's warning.
- one federated client equals local training (JAX's
  ``tests/test_equivalence.py:100``), and tracks JAX's federated client
  within 1e-5 (per-epoch losses and parameters);
- two clients in threads over ``LocalTransport`` and over HTTP: after
  each epoch both hold the same parameters, the example-weighted mean of
  their pre-sync ones, and they track JAX's two-client run within 1e-5;
- the ``/aggregate_weights`` request frame of a port client byte-equal
  to a JAX client's (JAX's tree: sorted keys, HWIO and ``[in, out]``
  kernels), and the one-client reply byte-equal to JAX's server's;
- both mixed pairs (a port client with a JAX server, a JAX client with
  a port server, locally and over HTTP) and a mixed round (a JAX and a
  port client in one round of a port server) within 1e-5;
- a bfloat16 transformer LM under AdamW: after a weighted round both
  clients hold the float32 mean of the bfloat16 ``pos`` table, as JAX's
  adopt it, over two syncs (leaf dtypes equal to JAX's, the per-epoch
  losses within two bfloat16 ulps, the promoted leaf's moments float32),
  and the ``/aggregate_weights`` frames of both rounds byte-equal to two
  JAX clients'.
"""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import FederatedClientTrainer as JaxFedClient
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime.state import fedavg_mean as jax_fedavg_mean
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    FedAvgAggregator, FederatedClientTrainer, FusedSplitTrainer,
    ProtocolError, ServerRuntime, fedavg_mean)
from split_learning_tpu_torch.transport import (
    HttpTransport, LocalTransport, SplitHTTPServer)
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_train_bf16 import bf16_loss_tol
from test_torch_port_u_split import _capture_http

B, PER_EPOCH, EPOCHS, LR, TIMEOUT = 8, 3, 2, 0.002, 30.0
TOL = 1e-5


def _shards(n):
    """``n`` disjoint shards of the synthetic set, ``PER_EPOCH`` batches
    each."""
    ds = jds.synthetic("mnist", n_train=B * PER_EPOCH * n, n_test=8, seed=3)
    data = list(jds.batches(ds.train, B, seed=3))
    return [data[i * PER_EPOCH:(i + 1) * PER_EPOCH] for i in range(n)]


def _jax_cfg(n=1):
    return JaxConfig(mode="federated", batch_size=B, lr=LR, epochs=EPOCHS,
                     num_clients=n)


def _cfg(n=1):
    return Config(mode="federated", batch_size=B, lr=LR, epochs=EPOCHS,
                  num_clients=n)


def _sample():
    return np.zeros((B, 28, 28, 1), np.float32)


def _jax_init():
    return jax_get_plan(mode="federated").init(jax.random.PRNGKey(0),
                                               jnp.asarray(_sample()))


def _jax_server(n=1):
    return JaxServer(jax_get_plan(mode="federated"), _jax_cfg(n),
                     jax.random.PRNGKey(0), _sample())


def _port_server(n=1):
    return ServerRuntime(get_plan(mode="federated"), _cfg(n),
                         params_from_jax(_jax_init()), device="cpu")


def _jax_client(transport, n=1):
    return JaxFedClient(jax_get_plan(mode="federated"), _jax_cfg(n),
                        jax.random.PRNGKey(0), transport)


def _port_client(transport, n=1):
    return FederatedClientTrainer(get_plan(mode="federated"), _cfg(n),
                                  params_from_jax(_jax_init()), transport,
                                  device="cpu")


def _flat(params):
    """The leaves in JAX's order, as numpy (either stack's params)."""
    if isinstance(params[0], dict) and "params" not in params[0]:
        params = params_to_jax(params)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, params))]


def _run_clients(clients, shards):
    """Each client's ``train`` on its shard, in its own thread; the
    per-epoch records and each client's parameters before every sync."""
    out, errors = {}, []

    def run(i):
        try:
            out[i] = [r.loss for r in clients[i].train(
                lambda: iter(shards[i]), epochs=EPOCHS)]
        except Exception as exc:  # surfaced in the main thread
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60 if not errors else 1)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "a FedAvg round hung"
    return [out[i] for i in range(len(clients))]


# -- fedavg_mean ---------------------------------------------------------- #
def _trees(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"a": rs.randn(3, 4).astype(np.float32),
             "b": [rs.randn(5).astype(np.float32),
                   {"c": rs.randn(2, 2, 2).astype(np.float32)}]}
            for _ in range(n)]


@pytest.mark.parametrize("weights", [None, [3, 1, 2]])
def test_fedavg_mean_matches_jax(weights):
    trees = _trees(3)
    got = fedavg_mean(trees, weights=weights)
    want = jax_fedavg_mean(trees, weights=weights)
    for g, w in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, got)),
            jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
    # tensors on their device give the same mean; one tree is itself
    t_trees = [jax.tree_util.tree_map(torch.tensor, t) for t in trees]
    t_got = fedavg_mean(t_trees, weights=weights)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, t_got)),
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                             got))):
        np.testing.assert_array_equal(a, b)
    assert fedavg_mean(trees[:1]) is trees[0]


@pytest.mark.parametrize("weights", [None, [3, 1, 2, 5]])
def test_fedavg_mean_bit_equal_to_jax_on_large_leaves(weights):
    """4 trees of 100,000 float32 values: the mean bit for bit JAX's (a
    round's trees in one order; another order moves it by an ulp)."""
    rs = np.random.RandomState(2)
    trees = [{"w": rs.randn(100_000).astype(np.float32)} for _ in range(4)]
    got = fedavg_mean(trees, weights=weights)["w"].numpy()
    want = np.asarray(jax_fedavg_mean(trees, weights=weights)["w"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", [None, [3, 1]])
def test_fedavg_mean_bf16_leaf_dtype_follows_jax(weights):
    """JAX's dtype on each path, held as it is: the uniform mean of a
    bfloat16 leaf is bfloat16, the weighted one float32."""
    rs = np.random.RandomState(1)
    vals = [rs.randn(64).astype(np.float32) for _ in range(2)]
    j_trees = [{"pos": jnp.asarray(v, jnp.bfloat16)} for v in vals]
    p_trees = [{"pos": torch.tensor(v).to(torch.bfloat16)} for v in vals]
    want = jax_fedavg_mean(j_trees, weights=weights)["pos"]
    got = fedavg_mean(p_trees, weights=weights)["pos"]
    want_dtype = torch.bfloat16 if weights is None else torch.float32
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    assert got.dtype == want_dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-6)


def test_fedavg_mean_refuses_bad_weights():
    a, b = _trees(2)
    with pytest.raises(ValueError):
        fedavg_mean([a, b], weights=[1])
    with pytest.raises(ValueError):
        fedavg_mean([a, b], weights=[1, 0])
    with pytest.raises(ValueError):
        fedavg_mean([a, {"a": a["a"]}])


# -- FedAvgAggregator ----------------------------------------------------- #
def _w(v):
    return {"w": np.full((2,), v, np.float32)}


def test_aggregator_round_and_one_client_overwrite():
    agg = FedAvgAggregator(1)
    p = _w(7.0)
    assert agg.submit(p) is p     # one client: the reference's overwrite
    assert agg._results == {} and agg._round == 1
    with pytest.raises(ValueError):
        FedAvgAggregator(0)


def test_aggregator_results_keyed_by_round_and_freed():
    """A slow waiter preempted between its round completing and its
    wakeup still reads its own round's mean, and every slot is freed
    after its members read it."""
    agg = FedAvgAggregator(2)
    results = {}
    round1_done = threading.Event()
    read = agg._read_result

    def slow_read(round_id):
        # the slow waiter is preempted after its wakeup, before its read:
        # the lock is dropped so round 1 runs to completion underneath
        if threading.current_thread().name == "slow":
            agg._cond.release()
            try:
                assert round1_done.wait(timeout=30)
            finally:
                agg._cond.acquire()
        return read(round_id)

    agg._read_result = slow_read

    def submit(name, value):
        results[name] = agg.submit(_w(value))

    w0 = threading.Thread(target=submit, args=("slow", 1.0), name="slow")
    w0.start()
    deadline = time.monotonic() + 30
    while not agg._pending:
        assert time.monotonic() < deadline, "slow waiter never enqueued"
        time.sleep(0.001)
    submit("c0", 3.0)     # completes round 0: mean 2.0
    w1 = threading.Thread(target=submit, args=("r1a", 10.0))
    w1.start()
    submit("r1b", 30.0)   # completes round 1: mean 20.0
    w1.join(timeout=30)
    round1_done.set()
    w0.join(timeout=30)
    assert not w0.is_alive() and not w1.is_alive()
    np.testing.assert_allclose(np.asarray(results["slow"]["w"]), [2.0, 2.0])
    np.testing.assert_allclose(np.asarray(results["r1a"]["w"]),
                               [20.0, 20.0])
    assert agg._results == {} and agg._pending == []


@pytest.mark.parametrize("weighted", [False, True])
def test_aggregator_timeout_then_retry_never_double_counts(weighted):
    agg = FedAvgAggregator(2)
    with pytest.raises(TimeoutError):
        agg.submit(_w(100.0), timeout=0.05,
                   weight=1000.0 if weighted else None)
    assert agg._pending == []   # withdrawn
    results = {}

    def client(name, value, weight):
        results[name] = agg.submit(_w(value),
                                   weight=weight if weighted else None)

    t1 = threading.Thread(target=client, args=("retry", 2.0, 1.0))
    t2 = threading.Thread(target=client, args=("other", 6.0, 3.0))
    t1.start()
    t2.start()
    t1.join(timeout=30)
    t2.join(timeout=30)
    want = 5.0 if weighted else 4.0    # (2*1 + 6*3) / 4, or (2 + 6) / 2
    for name in ("retry", "other"):
        np.testing.assert_allclose(np.asarray(results[name]["w"]),
                                   [want, want])


def test_aggregator_refuses_bad_weight_and_mixes_to_uniform(capsys):
    agg = FedAvgAggregator(2)
    for bad in (0.0, -3.0, float("nan")):
        with pytest.raises(ValueError):
            agg.submit(_w(1.0), weight=bad)
    assert agg._pending == []
    results = {}
    t = threading.Thread(target=lambda: results.__setitem__(
        "c1", agg.submit(_w(1.0), weight=300.0)))
    t.start()
    results["c2"] = agg.submit(_w(4.0))     # no weight: a mixed round
    t.join(timeout=30)
    for res in results.values():
        np.testing.assert_allclose(np.asarray(res["w"]), [2.5, 2.5])
    assert "falling back to uniform averaging" in capsys.readouterr().err


# -- the federated server ------------------------------------------------- #
def test_server_weighted_round_matches_jax_and_adopts_the_mean():
    """Two clients submit JAX's tree with example counts 300 and 100:
    both get the weighted mean (JAX's numbers within 1e-6), the server's
    own state becomes it, and bad submissions are refused (400) without
    poisoning the round."""
    jserver, server = _jax_server(2), _port_server(2)
    rs = np.random.RandomState(0)
    base = jax.tree_util.tree_map(np.asarray, _jax_init())
    subs = [jax.tree_util.tree_map(
        lambda x: (x + rs.randn(*x.shape)).astype(np.float32), base)
        for _ in range(2)]
    got, want = {}, {}
    for srv, out in ((jserver, want), (server, got)):
        t = threading.Thread(target=lambda: out.__setitem__(
            0, srv.aggregate(subs[0], 0, 1.0, 1, num_examples=300)))
        t.start()
        out[1] = srv.aggregate(subs[1], 0, 1.0, 2, num_examples=100)
        t.join(timeout=30)
    for i in (0, 1):
        for a, b in zip(_flat(got[i]), _flat(want[i])):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(_flat(server.params), _flat(got[0])):
        np.testing.assert_array_equal(a, b)
    h = server.health()
    assert (h["mode"], h["model_type"], h["step"]) == (
        "federated", "FullModel", 2)
    for bad in (dict(params=subs[0], num_examples=0),
                dict(params={"w": np.zeros(2, np.float32)}),
                dict(params=params_from_jax(subs[0]))):
        with pytest.raises(ProtocolError) as exc:
            server.aggregate(bad["params"], 1, 1.0, 3,
                             num_examples=bad.get("num_examples"))
        assert exc.value.status == 400
    assert server._agg._pending == []
    with pytest.raises(ProtocolError, match="called in mode"):
        server.split_step(np.zeros((2, 26, 26, 32), np.float32),
                          np.zeros(2, np.int64), 0)
    with pytest.raises(ProtocolError, match="called in mode"):
        server.predict(np.zeros((2, 26, 26, 32), np.float32))


# -- federated clients ---------------------------------------------------- #
def test_single_client_equals_local_training_and_jax():
    """One client: FedAvg is the reference's overwrite, so federated
    training equals local training on the same batches; and the same
    run of JAX within 1e-5."""
    (data,) = _shards(1)
    client = _port_client(LocalTransport(_port_server()))
    records = client.train(lambda: iter(data), epochs=EPOCHS)
    assert [r.epoch for r in records] == [0, 1]
    assert [r.step for r in records] == [PER_EPOCH, 2 * PER_EPOCH]
    local = FusedSplitTrainer(get_plan(mode="federated"),
                              Config(transport="fused", batch_size=B, lr=LR),
                              params_from_jax(_jax_init()), None,
                              device="cpu")
    losses = [local.train_step(x, y) for _ in range(EPOCHS)
              for x, y in data]
    assert client.losses == losses
    for a, b in zip(_flat(client.params), _flat(local.params)):
        np.testing.assert_array_equal(a, b)
    jclient = _jax_client(JaxLocal(_jax_server()))
    j_records = jclient.train(lambda: iter(data), epochs=EPOCHS)
    np.testing.assert_allclose([r.loss for r in records],
                               [r.loss for r in j_records], atol=TOL)
    for a, b in zip(_flat(client.params), _flat(jclient.state.params)):
        np.testing.assert_allclose(a, b, atol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_two_clients():
    shards = _shards(2)
    server = _jax_server(2)
    # through the codec: JAX's aggregator hands both clients one mean
    # pytree, and each client's jitted step donates its state buffers
    clients = [_jax_client(JaxLocal(server, through_codec=True), 2)
               for _ in range(2)]
    losses = _run_clients(clients, shards)
    return losses, [c.state.params for c in clients]


@pytest.mark.parametrize("wire", ["local", "http"])
def test_two_clients_in_threads_track_jax(wire):
    shards = _shards(2)
    server = _port_server(2)
    srv = SplitHTTPServer(server).start() if wire == "http" else None
    transports = [LocalTransport(server) if srv is None else
                  HttpTransport(srv.url, timeout=TIMEOUT) for _ in range(2)]
    clients = [_port_client(t, 2) for t in transports]
    pre, post = {0: [], 1: []}, {0: [], 1: []}
    for i, c in enumerate(clients):
        sync = c.sync

        def spy(*a, _i=i, _sync=sync, _c=c, **kw):
            pre[_i].append(_flat(_c.params))
            _sync(*a, **kw)
            post[_i].append(_flat(_c.params))

        c.sync = spy
    try:
        losses = _run_clients(clients, shards)
    finally:
        for t in transports:
            t.close()
        if srv is not None:
            srv.stop()
    for e in range(EPOCHS):
        # both hold the same parameters, the weighted mean of their
        # pre-sync ones (equal example counts: the plain mean)
        for a, b, p0, p1 in zip(post[0][e], post[1][e], pre[0][e],
                                pre[1][e]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, (p0 + p1) / 2, rtol=0, atol=1e-6)
    for a, b in zip(_flat(server.params), post[0][-1]):
        np.testing.assert_array_equal(a, b)
    assert server.health()["step"] == EPOCHS * PER_EPOCH
    j_losses, j_params = _jax_two_clients()
    np.testing.assert_allclose(losses, j_losses, atol=TOL)
    for a, b in zip(post[0][-1], _flat(j_params[0])):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_aggregate_frames_byte_equal_to_jax():
    """The port client's ``/aggregate_weights`` request from the JAX init
    is byte-equal to a JAX client's (JAX's tree of numpy leaves, the
    same keys, loss, step and example count), and a one-client round's
    reply from the port server byte-equal to JAX's server's."""
    frames = {}
    for side in ("jax", "port"):
        rt = _jax_server() if side == "jax" else _port_server()
        cls = JaxHTTPServer if side == "jax" else SplitHTTPServer
        srv = cls(rt).start()
        bodies = _capture_http(srv)
        replies = []
        try:
            if side == "jax":
                t = JaxHttp(srv.url, timeout=TIMEOUT)
                params = jax.tree_util.tree_map(np.asarray, _jax_init())
                replies.append(t.aggregate(params, 0, 1.25, 3,
                                           num_examples=24))
            else:
                t = HttpTransport(srv.url, timeout=TIMEOUT)
                client = _port_client(t)
                client.sync(0, 1.25, 3, 24)
                replies.append(t.aggregate(params_to_jax(client.params), 1,
                                           1.25, 4, num_examples=24))
            t.close()
        finally:
            srv.stop()
        frames[side] = bodies[0]
        if side == "port":
            reply = replies[0]
        else:
            j_reply = replies[0]
    assert frames["port"][0] == "/aggregate_weights"
    assert frames["port"] == frames["jax"]
    from split_learning_tpu.transport import codec as jax_codec
    from split_learning_tpu_torch.transport import codec
    assert codec.encode({"model_state": reply}) == jax_codec.encode(
        {"model_state": j_reply})


@pytest.mark.parametrize("wire", ["local", "http"])
@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_mixed_pairs(pair, wire):
    (data,) = _shards(1)
    j_losses = [r.loss for r in _jax_client(JaxLocal(_jax_server())).train(
        lambda: iter(data), epochs=EPOCHS)]
    if pair == "port_client_jax_server":
        rt, srv_cls, t_cls, local = (_jax_server(), JaxHTTPServer,
                                     HttpTransport, JaxLocal)
        make = _port_client
    else:
        rt, srv_cls, t_cls, local = (_port_server(), SplitHTTPServer,
                                     JaxHttp, LocalTransport)
        make = _jax_client
    srv = srv_cls(rt).start() if wire == "http" else None
    t = local(rt) if srv is None else t_cls(srv.url, timeout=TIMEOUT)
    try:
        client = make(t)
        losses = [r.loss for r in client.train(lambda: iter(data),
                                               epochs=EPOCHS)]
    finally:
        if srv is not None:
            t.close()
            srv.stop()
    np.testing.assert_allclose(losses, j_losses, atol=TOL)


def test_mixed_round_jax_and_port_clients_average_the_same_leaves():
    """A JAX client and a port client in one FedAvg round of a port
    server: both adopt the same mean, which is the mean of their
    pre-sync parameters (JAX's layout on the wire)."""
    shards = _shards(2)
    server = _port_server(2)
    jclient = _jax_client(LocalTransport(server), 2)
    pclient = _port_client(LocalTransport(server), 2)
    losses = _run_clients([jclient, pclient], shards)
    assert all(np.isfinite(v) for run in losses for v in run)
    for a, b in zip(_flat(jclient.state.params), _flat(pclient.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    j_losses, _ = _jax_two_clients()
    np.testing.assert_allclose(losses, j_losses, atol=TOL)


# -- bfloat16: a weighted mean's float32 leaves are adopted ---------------- #
LM_B, LM_T, LM_V = 4, 16, 64
LM_SIZE = dict(vocab=LM_V, d_model=32, num_heads=2, client_depth=1,
               server_depth=1, max_len=64, attn="full")
LM_CFG = dict(mode="federated", model="transformer_lm", dtype="bfloat16",
              batch_size=LM_B, epochs=EPOCHS, num_clients=2,
              optimizer="adamw", lr=3e-3, weight_decay=0.1, warmup_steps=1,
              decay_steps=EPOCHS * PER_EPOCH, grad_clip_norm=1.0)


def _lm_shards():
    ds = jds.synthetic_lm(n_train=LM_B * PER_EPOCH * 2, n_test=LM_B,
                          vocab=LM_V, seq_len=LM_T, seed=4)
    data = list(jds.batches(ds.train, LM_B, seed=4))
    return [data[i * PER_EPOCH:(i + 1) * PER_EPOCH] for i in range(2)]


def _jax_lm_plan():
    return jax_get_plan(model="transformer_lm", mode="federated",
                        dtype="bfloat16", **LM_SIZE)


def _lm_plan():
    return get_plan(model="transformer_lm", mode="federated",
                    dtype="bfloat16", **LM_SIZE)


def _jax_lm_init(seed=0):
    return _jax_lm_plan().init(jax.random.PRNGKey(seed),
                               jnp.asarray(_lm_shards()[0][0][0]))


def _dtypes(tree):
    return [str(np.asarray(x).dtype) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


class _CopiedReply:
    """JAX's ``LocalTransport`` with each client's own host copy of the
    mean, its tuple kept: JAX's jitted step donates the state it adopts
    (one shared mean would be deleted under the other client), and the
    codec's round trip turns the tuple into a list, which optax's adamw
    refuses against its state's tuple."""

    def __init__(self, inner):
        self.inner = inner

    def aggregate(self, *args, **kwargs):
        return jax.tree_util.tree_map(
            np.array, self.inner.aggregate(*args, **kwargs))


def test_bf16_lm_clients_adopt_the_float32_mean_as_jax_does():
    shards = _lm_shards()
    sample = shards[0][0][0]
    jserver = JaxServer(_jax_lm_plan(), JaxConfig(**LM_CFG),
                        jax.random.PRNGKey(0), sample)
    jclients = [JaxFedClient(_jax_lm_plan(), JaxConfig(**LM_CFG),
                             jax.random.PRNGKey(0),
                             _CopiedReply(JaxLocal(jserver)))
                for _ in range(2)]
    server = ServerRuntime(_lm_plan(), Config(**LM_CFG),
                           params_from_jax(_jax_lm_init()), device="cpu")
    clients = [FederatedClientTrainer(_lm_plan(), Config(**LM_CFG),
                                      params_from_jax(_jax_lm_init()),
                                      LocalTransport(server), device="cpu")
               for _ in range(2)]
    before = _dtypes(params_to_jax(clients[0].params))
    assert "bfloat16" in before
    dtypes = {"jax": [], "port": []}
    for side, cs in (("jax", jclients), ("port", clients)):
        for c in cs:
            get = ((lambda c=c: c.state.params) if side == "jax" else
                   (lambda c=c: params_to_jax(c.params)))
            train = c.train
            c.train = functools.partial(
                train, on_epoch_end=lambda e, s, get=get, side=side:
                dtypes[side].append(_dtypes(get())))
    j_losses = _run_clients(jclients, shards)
    losses = _run_clients(clients, shards)
    # every epoch's sync: JAX's dtypes, the bfloat16 table now float32
    assert len(dtypes["port"]) == len(dtypes["jax"]) == 2 * EPOCHS
    assert dtypes["port"] == dtypes["jax"]
    assert all("bfloat16" not in d for d in dtypes["port"])
    assert _dtypes(params_to_jax(server.params)) == dtypes["jax"][-1]
    for got, want in zip(losses, j_losses):
        for a, b in zip(got, want):
            assert abs(a - b) <= bf16_loss_tol(b), (got, want)
    # the promoted leaf's Adam moments followed it to float32
    for c in clients:
        mu, nu = c.state.opt_state
        assert [m.dtype for m in mu] == [m.dtype for m in nu] == [
            p.dtype for p in c.state.params[0].values()] + [
            p.dtype for st in c.state.params[1:] for p in st.values()]


def test_bf16_aggregate_frames_of_two_weighted_rounds_byte_equal_to_jax():
    """Two clients from different inits, example counts 3 and 1, two
    rounds without local steps between, each side against its own
    server: every ``/aggregate_weights`` request byte-equal to JAX's
    clients' (the second round's carries the float32 mean of the
    bfloat16 table), and the replies equal."""
    inits = [_jax_lm_init(seed) for seed in (0, 1)]
    frames, replies = {}, {}
    for side in ("jax", "port"):
        if side == "jax":
            rt = JaxServer(_jax_lm_plan(), JaxConfig(**LM_CFG),
                           jax.random.PRNGKey(0), _lm_shards()[0][0][0])
            srv = JaxHTTPServer(rt).start()
        else:
            rt = ServerRuntime(_lm_plan(), Config(**LM_CFG),
                               params_from_jax(inits[0]), device="cpu")
            srv = SplitHTTPServer(rt).start()
        bodies = _capture_http(srv)
        out, errors = {}, []

        def in_turn(i, rt=rt):
            # client 1 submits after client 0 in each round: a round
            # averages in arrival order, which moves the mean by an ulp
            deadline = time.monotonic() + TIMEOUT
            while i == 1 and len(rt._agg._pending) != 1:
                assert time.monotonic() < deadline, "client 0 never came"
                time.sleep(0.005)

        def run(i, side=side, srv=srv, out=out, errors=errors):
            try:
                if side == "jax":
                    t = JaxHttp(srv.url, timeout=TIMEOUT)
                    tree = jax.tree_util.tree_map(np.asarray, inits[i])
                    for r in range(2):
                        in_turn(i)
                        tree = t.aggregate(tree, r, 1.0 + i, 10 * r + i,
                                           num_examples=3 - 2 * i)
                else:
                    t = HttpTransport(srv.url, timeout=TIMEOUT)
                    c = FederatedClientTrainer(
                        _lm_plan(), Config(**LM_CFG),
                        params_from_jax(inits[i]), t, device="cpu")
                    for r in range(2):
                        in_turn(i)
                        c.sync(r, 1.0 + i, 10 * r + i, 3 - 2 * i)
                    tree = params_to_jax(c.params)
                t.close()
                out[i] = tree
            except Exception as exc:  # surfaced in the main thread
                errors.append((i, exc))

        try:
            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            srv.stop()
        assert not errors, errors
        frames[side] = sorted(bodies)
        replies[side] = out
    assert len(frames["port"]) == 4
    assert all(path == "/aggregate_weights" for path, _ in frames["port"])
    assert frames["port"] == frames["jax"]
    for i in range(2):
        assert _dtypes(replies["port"][i]) == _dtypes(replies["jax"][i])
        assert "bfloat16" not in _dtypes(replies["port"][i])
        for a, b in zip(_flat(replies["port"][i]), _flat(replies["jax"][i])):
            np.testing.assert_array_equal(a, b)
