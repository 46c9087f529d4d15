"""The port's ``MultiClientSplitRunner`` against the JAX package's, on
the CPU: each case of tests/test_multi_client.py on the port, with the
JAX runner's numbers as the reference where the case computes numbers.

The clients start where JAX's do: client ``i`` of ``n > 1`` from
``fold_in(PRNGKey(0), i)``'s init, carried across with
``interop.params_from_jax`` (the runner's ``init`` callable), the
server from ``PRNGKey(0)``'s. Tolerances: losses within 1e-4 of JAX's
on the dense wire, 1e-3 on topk8 (``PERF.md`` §2); bottoms within 1e-5
after the dense sync. A compressed sync keeps the same selection as
JAX's on float32 drift, so its byte counters equal JAX's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime.multi_client import (
    MultiClientSplitRunner as JaxRunner)
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    FailurePolicy, MultiClientSplitRunner, ProtocolError, ServerRuntime,
    SplitClientTrainer, leaves_of)
from split_learning_tpu_torch.transport import (
    FaultInjector, FaultyTransport, LocalTransport)
from split_learning_tpu_torch.utils.config import Config

BATCH = 8
SAMPLE = np.zeros((BATCH, 28, 28, 1), np.float32)
TOL = {None: 1e-4, "topk8": 1e-3}


def _jax_init(key):
    return jax_get_plan(mode="split").init(key, jnp.asarray(SAMPLE))


def _client_init(n):
    def init(i):
        key = jax.random.PRNGKey(0)
        return params_from_jax(_jax_init(
            jax.random.fold_in(key, i) if n > 1 else key))
    return init


def _server(n_clients=2):
    return ServerRuntime(get_plan(), Config(batch_size=BATCH,
                                            num_clients=n_clients),
                         params_from_jax(_jax_init(jax.random.PRNGKey(0))),
                         device="cpu")


def make(n_clients=2, transport=LocalTransport, **kw):
    cfg = Config(mode="split", batch_size=BATCH, num_clients=n_clients)
    server = _server(n_clients)
    factory = kw.pop("factory", None) or (lambda i: transport(server))
    runner = MultiClientSplitRunner(get_plan(), cfg,
                                    _client_init(n_clients), factory,
                                    num_clients=n_clients, device="cpu",
                                    **kw)
    return server, runner


def jax_make(n_clients=2, **kw):
    cfg = JaxConfig(mode="split", batch_size=BATCH, num_clients=n_clients)
    plan = jax_get_plan(mode="split")
    server = JaxServer(plan, cfg, jax.random.PRNGKey(0), SAMPLE)
    factory = kw.pop("factory", None) or (lambda i: JaxLocal(server))
    runner = JaxRunner(plan, cfg, jax.random.PRNGKey(0),
                       transport_factory=factory, num_clients=n_clients,
                       **kw)
    return server, runner


def batches(n_clients, seed):
    rs = np.random.RandomState(seed)
    centers = rs.randn(10, 28 * 28).astype(np.float32)
    out = []
    for _ in range(n_clients):
        y = rs.randint(0, 10, (BATCH,))
        x = (centers[y] + 0.4 * rs.randn(BATCH, 28 * 28)).astype(np.float32)
        out.append((x.reshape(BATCH, 28, 28, 1), y.astype(np.int64)))
    return out


def _leaves(params):
    """A client's bottom as numpy in JAX's leaf order (either stack)."""
    if isinstance(params, dict) and "params" not in params:
        params = params_to_jax([params])[0]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, params))]


def _rounds(runner, n_clients, rounds, start=0):
    return [runner.train_round(batches(n_clients, seed=r))
            for r in range(start, start + rounds)]


def test_interleaved_clients_with_per_client_handshake():
    server, runner = make(2)
    losses = _rounds(runner, 2, 12)
    assert server._last_step == {0: 11, 1: 11}
    assert np.mean(losses[-1]) < np.mean(losses[0]) * 0.7
    _, jrunner = jax_make(2)
    np.testing.assert_allclose(losses, _rounds(jrunner, 2, 12),
                               atol=TOL[None])


def test_same_client_replay_served_from_cache_then_rejected():
    server, runner = make(1)
    orig = runner.train_round(batches(1, seed=0))[0]
    client = runner.clients[0]
    x, y = batches(1, seed=1)[0]
    assert client.train_step(x, y, step=0) == orig
    assert server.health()["step"] == 0
    assert server.replay.hits >= 1
    for r in range(1, server.replay.window + 2):
        runner.train_round(batches(1, seed=r))
    with pytest.raises(ProtocolError):
        client.train_step(x, y, step=0)


def test_bottom_sync_fedavg():
    _, runner = make(2, sync_bottoms_every=3)
    _, jrunner = jax_make(2, sync_bottoms_every=3)
    np.testing.assert_allclose(_rounds(runner, 2, 3), _rounds(jrunner, 2, 3),
                               atol=TOL[None])
    a, b = (_leaves(c.state.params[0]) for c in runner.clients)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(la, lb)
    for la, lj in zip(a, _leaves(jrunner.clients[0].state.params)):
        np.testing.assert_allclose(la, lj, atol=1e-5)


def test_bottom_sync_compressed_delta_from_reference():
    """The first sync is dense (bit-equal to the uncompressed runner's),
    later ones ship topk8 deltas from the last mean: the byte counters
    show the compression and equal JAX's, the cohort agrees exactly, and
    the bottoms track JAX's runner."""
    _, runner_c = make(2, sync_bottoms_every=3, sync_compress="topk8",
                       sync_density=0.1)
    _, runner_d = make(2, sync_bottoms_every=3)
    _rounds(runner_c, 2, 3)
    _rounds(runner_d, 2, 3)
    assert runner_c.sync_wire_bytes == 0
    for lc, ld in zip(leaves_of(runner_c.clients[0].state.params),
                      leaves_of(runner_d.clients[0].state.params)):
        assert torch.equal(lc, ld)
    _rounds(runner_c, 2, 3, start=3)
    assert runner_c.sync_raw_bytes > runner_c.sync_wire_bytes > 0
    a, b = (leaves_of(c.state.params) for c in runner_c.clients)
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)
    _, jrunner = jax_make(2, sync_bottoms_every=3, sync_compress="topk8",
                          sync_density=0.1)
    _rounds(jrunner, 2, 6)
    assert (runner_c.sync_raw_bytes, runner_c.sync_wire_bytes) == (
        jrunner.sync_raw_bytes, jrunner.sync_wire_bytes)
    for la, lj in zip(_leaves(runner_c.clients[0].state.params[0]),
                      _leaves(jrunner.clients[0].state.params)):
        np.testing.assert_allclose(la, lj, atol=1e-4)


def test_concurrent_clients_are_race_free():
    n_clients, n_steps = 4, 6
    server = _server(n_clients)
    init = _client_init(n_clients)
    clients = [SplitClientTrainer(get_plan(), Config(batch_size=BATCH),
                                  init(i), LocalTransport(server),
                                  client_id=i, device="cpu")
               for i in range(n_clients)]
    errors = []

    def run(i):
        try:
            data = batches(1, seed=100 + i)[0]
            for s in range(n_steps):
                assert np.isfinite(clients[i].train_step(*data, step=s))
        except Exception as exc:
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert server._last_step == {i: n_steps - 1 for i in range(n_clients)}


def test_concurrent_rounds_from_the_pool():
    """``concurrent=True``: every round's steps in flight at once from a
    thread pool; every step lands and the bottoms still sync."""
    server, runner = make(4, concurrent=True, sync_bottoms_every=2)
    try:
        losses = runner.train_rounds(
            [[batches(4, seed=r)[i] for r in range(4)] for i in range(4)])
    finally:
        runner.close()
    assert len(losses) == 4 and all(np.isfinite(v) for r in losses
                                    for v in r)
    assert server._last_step == {i: 3 for i in range(4)}
    ref = leaves_of(runner.clients[0].state.params)
    for c in runner.clients[1:]:
        for a, b in zip(leaves_of(c.state.params), ref):
            assert torch.equal(a, b)


def test_round_survives_client_dropout():
    server = _server(2)
    injector = FaultInjector(fail_steps={2, 3, 4})
    _, runner = make(2, factory=lambda i: (
        FaultyTransport(LocalTransport(server), injector) if i == 1
        else LocalTransport(server)))
    runner.clients[1].failure_policy = FailurePolicy.SKIP
    results = _rounds(runner, 2, 7)
    for r, losses in enumerate(results):
        assert np.isfinite(losses[0])
        if r in (2, 3, 4):
            assert losses[1] is None
        else:
            assert np.isfinite(losses[1])
    assert injector.injected == 3
    assert runner.clients[1].dropped_batches == 3
    assert server._last_step == {0: 6, 1: 6}


def test_sync_bottoms_skips_uninitialized_clients():
    server = _server(3)
    injector = FaultInjector(failure_rate=1.0)
    _, runner = make(3, sync_bottoms_every=2, factory=lambda i: (
        FaultyTransport(LocalTransport(server), injector) if i == 2
        else LocalTransport(server)))
    runner.clients[2].failure_policy = FailurePolicy.SKIP
    for r in range(4):
        assert runner.train_round(batches(3, seed=r))[2] is None
    a, b, c = (leaves_of(runner.clients[i].state.params) for i in range(3))
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)
    assert int(runner.clients[2].state.step) == 0
    assert any(not torch.equal(lc, la) for la, lc in zip(a, c))
    init2 = _client_init(3)(2)[0]
    for k, v in runner.clients[2].state.params[0].items():
        assert torch.equal(v, init2[k])   # untouched


def test_sync_bottoms_single_survivor_is_noop():
    _, runner = make(2)
    runner.train_round(batches(2, seed=0))
    before = [t.clone() for t in leaves_of(runner.clients[0].state.params)]
    runner.clients[1].state = None  # a never-recovered dropout
    runner.sync_bottoms()
    for a, b in zip(before, leaves_of(runner.clients[0].state.params)):
        assert torch.equal(a, b)


def test_dropout_with_topk8_wire_keeps_ef_consistent():
    """Client 1 flaps on the topk8 wire; client 0's error feedback stays
    its own: it keeps learning, and its losses track JAX's client 0."""
    def factories(server, injector, local):
        return lambda i: (
            FaultyTransport(local(server, compress="topk8", density=0.1),
                            injector) if i == 1
            else local(server, compress="topk8", density=0.1))

    server = _server(2)
    injector = FaultInjector(fail_steps={1, 3, 5})
    _, runner = make(2, factory=factories(server, injector, LocalTransport))
    runner.clients[1].failure_policy = FailurePolicy.SKIP
    losses = _rounds(runner, 2, 10)
    c0 = [v[0] for v in losses]
    assert all(np.isfinite(v) for v in c0)
    assert np.mean(c0[-3:]) < np.mean(c0[:3])
    assert sum(v[1] is None for v in losses) == 3

    from split_learning_tpu.runtime.client import (
        FailurePolicy as JaxFailurePolicy)
    from split_learning_tpu.transport.base import (
        FaultInjector as JaxInjector, FaultyTransport as JaxFaulty)
    jserver, _ = jax_make(2)
    jinj = JaxInjector(fail_steps={1, 3, 5})

    def jfactory(i):
        t = JaxLocal(jserver, compress="topk8", density=0.1)
        return JaxFaulty(t, jinj) if i == 1 else t

    _, jrunner = jax_make(2, factory=jfactory)
    jrunner.clients[1].failure_policy = JaxFailurePolicy.SKIP
    j_losses = _rounds(jrunner, 2, 10)
    np.testing.assert_allclose(c0, [v[0] for v in j_losses],
                               atol=TOL["topk8"])


def test_multi_client_transformer_lm():
    """Two LM clients share one server trunk (d_model 32, 1 + 1 blocks,
    T 16): per-client handshakes and FedAvg'd bottoms work on token
    sequences; the losses track JAX's runner."""
    from split_learning_tpu.data.datasets import synthetic_lm
    size = dict(vocab=64, d_model=32, num_heads=2, client_depth=1,
                server_depth=1, max_len=32, attn="full")
    ds = synthetic_lm(seq_len=16, n_train=64, vocab=64)
    sample = ds.train.x[:BATCH]
    jplan = jax_get_plan(model="transformer_lm", **size)

    def init(i):
        return params_from_jax(jplan.init(jax.random.fold_in(
            jax.random.PRNGKey(0), i), jnp.asarray(sample)))

    cfg = Config(mode="split", model="transformer_lm", batch_size=BATCH,
                 num_clients=2)
    server = ServerRuntime(get_plan(model="transformer_lm", **size), cfg,
                           params_from_jax(jplan.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(sample))),
                           device="cpu")
    runner = MultiClientSplitRunner(
        get_plan(model="transformer_lm", **size), cfg, init,
        lambda i: LocalTransport(server), sync_bottoms_every=2,
        device="cpu")
    jcfg = JaxConfig(mode="split", model="transformer_lm",
                     batch_size=BATCH, num_clients=2)
    jserver = JaxServer(jplan, jcfg, jax.random.PRNGKey(0), sample)
    jrunner = JaxRunner(jplan, jcfg, jax.random.PRNGKey(0),
                        transport_factory=lambda i: JaxLocal(jserver),
                        num_clients=2, sync_bottoms_every=2)
    for r in range(4):
        lo = BATCH * (2 * r) % 48
        rb = [(ds.train.x[lo:lo + BATCH], ds.train.y[lo:lo + BATCH]),
              (ds.train.x[lo + BATCH:lo + 2 * BATCH],
               ds.train.y[lo + BATCH:lo + 2 * BATCH])]
        losses = runner.train_round(rb)
        assert all(np.isfinite(v) for v in losses)
        np.testing.assert_allclose(losses, jrunner.train_round(rb),
                                   atol=TOL[None])
    for a, b in zip(leaves_of(runner.clients[0].state.params),
                    leaves_of(runner.clients[1].state.params)):
        assert torch.equal(a, b)
    assert server._last_step == {0: 3, 1: 3}


def test_weighted_fedavg_by_example_count():
    """End to end through the federated server's aggregate, in JAX's
    layout: a 300:100 round is the weighted mean (JAX's numbers), a
    round with one count missing is uniform, and a count of 0 is a 400
    that does not poison the round."""
    plan = get_plan(mode="federated")
    cfg = Config(mode="federated", num_clients=2, batch_size=8)
    runtime = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    layout = params_to_jax(runtime.params)
    p1 = jax.tree_util.tree_map(np.ones_like, layout)
    p2 = jax.tree_util.tree_map(lambda x: np.full_like(x, 4.0), layout)

    def round_of(n1, n2):
        results = {}
        t = threading.Thread(target=lambda: results.__setitem__(
            "c1", runtime.aggregate(p1, 0, 1.0, 1, num_examples=n1)))
        t.start()
        results["c2"] = runtime.aggregate(p2, 0, 1.0, 2, num_examples=n2)
        t.join(timeout=30)
        return results

    for (n1, n2), want in (((300, 100), 0.75 * 1.0 + 0.25 * 4.0),
                           ((300, None), 2.5)):
        for res in round_of(n1, n2).values():
            for leaf in jax.tree_util.tree_leaves(res):
                np.testing.assert_allclose(leaf, np.full_like(leaf, want),
                                           rtol=1e-6)
    # the server adopted the last mean, in its own layout
    for v in leaves_of(runtime.params):
        assert torch.allclose(v, torch.full_like(v, 2.5))
    with pytest.raises(ProtocolError) as exc:
        runtime.aggregate(p1, 2, 1.0, 5, num_examples=0)
    assert exc.value.status == 400
    assert runtime._agg._pending == []


def test_unported_runner_arguments_raise():
    # prefetch > 0 runs (DevicePrefetch): the same losses as without
    losses = [make(1)[1].train_rounds([[batches(1, 0)[0]]], prefetch=p)
              for p in (0, 2)]
    assert losses[0] == losses[1] and len(losses[0]) == 1
    # a profiler is shared by every client: each step's three phases
    from split_learning_tpu_torch.utils.profiling import PhaseProfiler
    prof = PhaseProfiler()
    _, runner = make(2, profiler=prof)
    runner.train_rounds([[batches(2, 0)[0]], [batches(2, 0)[1]]])
    assert {k: v["count"] for k, v in prof.summary().items()} == {
        "compute_fwd": 2, "transport": 2, "compute_bwd": 2}
    with pytest.raises(ValueError, match="sync compression"):
        make(1, sync_compress="int8")
    # train_rounds stops when a client's iterator drains
    server, runner = make(2)
    out = runner.train_rounds([[batches(2, 0)[0]] * 3,
                               [batches(2, 0)[1]] * 2])
    assert len(out) == 2 and server._last_step == {0: 1, 1: 1}


def test_stage_apply_is_thread_safe():
    """Fault 9: many threads run one stage on their own parameters (a
    short switch interval, more threads than cores): each forward equals
    its serial result; without the stage's lock a thread's forward could
    run on another's parameters, swapped into the shared module."""
    import sys
    plan = get_plan()
    stage = plan.stages[0]
    n = 16
    params = [plan.init(torch.Generator().manual_seed(i), torch.zeros(1))[0]
              for i in range(n)]
    x = torch.randn(2, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    want = [stage.apply(p, x) for p in params]
    got, errors = [None] * n, []

    def run(i):
        try:
            for _ in range(20):
                out = stage.apply(params[i], x)
                if not torch.equal(out, want[i]):
                    got[i] = out
                    return
            got[i] = want[i]
        except Exception as exc:
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(g is w for g, w in zip(got, want))
