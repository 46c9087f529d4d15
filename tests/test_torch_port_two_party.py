"""The port's two-party path against the JAX package, on the CPU.

``SplitClientTrainer`` + ``LocalTransport(ServerRuntime)`` of the port
against the same three of JAX, from the same flax init (carried across
with ``split_learning_tpu_torch.interop``) on the same batches:

- losses within 1e-4 with no wire (``compress=None``) and the dense wire
  (``"none"``): float32 drift between the frameworks; within 1e-3 with
  int8, topk8 and clapping, where a value near an int8 rounding boundary
  can land on the other side after that drift (observed: 2.3e-4 int8,
  2.7e-5 topk8 at batch 8);
- the wire byte totals of ``TransportStats`` equal JAX's;
- mixed pairs: a port client through JAX's transport to JAX's server, and
  a JAX client through the port's transport to the port's server, train
  and track the pure-JAX run within the same tolerances;
- protocol behaviour, run as the same script on both stacks: replay
  served from the cache, an out-of-order step refused (409), and
  ``FaultyTransport`` under the retry and skip policies.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ProtocolError as JaxProtocolError
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport import FaultInjector as JaxInjector
from split_learning_tpu.transport import FaultyTransport as JaxFaulty
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.runtime import (
    CircuitBreaker, ProtocolError, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.runtime.checkpoint import extras_valid
from split_learning_tpu_torch.runtime.party import _DeferredApply
from split_learning_tpu_torch.transport import (
    DensityController, FaultInjector, FaultyTransport, LocalTransport,
    TransportError)
from split_learning_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS = 8, 5
TOL = {None: 1e-4, "none": 1e-4, "int8": 1e-3, "topk8": 1e-3,
       "clapping": 1e-3}


def _data(batch=BATCH, steps=STEPS, seed=3):
    ds = jax_synthetic("mnist", n_train=batch * steps, n_test=8, seed=seed)
    return list(jax_batches(ds.train, batch, seed=seed))


def _jax_init(data):
    return jax_get_plan(mode="split").init(jax.random.PRNGKey(0),
                                           jnp.asarray(data[0][0]))


def _jax_stack(data, compress=None, batch=BATCH):
    cfg = JaxConfig(batch_size=batch)
    server = JaxServer(jax_get_plan(mode="split"), cfg,
                       jax.random.PRNGKey(0), data[0][0])
    transport = JaxLocal(server, compress=compress)
    return JaxClient(jax_get_plan(mode="split"), cfg, jax.random.PRNGKey(0),
                     transport), transport, server


def _port_server(data, batch=BATCH, **kw):
    return ServerRuntime(get_plan(), Config(batch_size=batch),
                         params_from_jax(_jax_init(data)), device="cpu",
                         **kw)


def _port_client(data, transport, batch=BATCH, **kw):
    return SplitClientTrainer(get_plan(), Config(batch_size=batch),
                              params_from_jax(_jax_init(data)), transport,
                              device="cpu", **kw)


def _train(client, data):
    return [client.train_step(x, y, i) for i, (x, y) in enumerate(data)]


@pytest.mark.parametrize("compress", [None, "none", "int8", "topk8",
                                      "clapping"])
def test_two_parties_match_jax(compress):
    data = _data()
    jclient, jtransport, jserver = _jax_stack(data, compress)
    j_losses = _train(jclient, data)
    server = _port_server(data)
    transport = LocalTransport(server, compress=compress)
    losses = _train(_port_client(data, transport), data)
    np.testing.assert_allclose(losses, j_losses, atol=TOL[compress])
    for field in ("round_trips", "bytes_sent", "bytes_received"):
        assert getattr(transport.stats, field) == getattr(
            jtransport.stats, field), field
    assert transport.stats.counters == jtransport.stats.counters
    if compress is None:
        want = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jserver.state.params))
        got = jax.tree_util.tree_leaves(params_to_jax([server.params]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    if compress in ("int8", "topk8", "clapping"):
        gauge = server.metrics()["gauges"]["wire_compression_ratio"]
        assert gauge == pytest.approx(
            transport.stats.summary()["compression_ratio"])


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_mixed_pairs_train(pair, compress):
    data = _data(batch=64, steps=8, seed=0)   # a run whose loss falls
    j_losses = _train(_jax_stack(data, compress, batch=64)[0], data)
    if pair == "port_client_jax_server":
        jserver = JaxServer(jax_get_plan(mode="split"),
                            JaxConfig(batch_size=64), jax.random.PRNGKey(0),
                            data[0][0])
        client = _port_client(data, JaxLocal(jserver, compress=compress),
                              batch=64)
    else:
        server = _port_server(data, batch=64)
        client = JaxClient(jax_get_plan(mode="split"),
                           JaxConfig(batch_size=64), jax.random.PRNGKey(0),
                           LocalTransport(server, compress=compress))
    losses = _train(client, data)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, j_losses, atol=TOL[compress])


def test_reply_lives_where_the_request_lived():
    """numpy in, numpy out (JAX's contract); a tensor in, a tensor out;
    predict's logits equal JAX's."""
    data = _data()
    server = _port_server(data)
    jserver = JaxServer(jax_get_plan(mode="split"), JaxConfig(),
                        jax.random.PRNGKey(0), data[0][0])
    acts = np.random.RandomState(0).randn(4, 26, 26, 32).astype(np.float32)
    want = jserver.predict(acts)
    for compress in (None, "int8"):
        t = LocalTransport(server, compress=compress)
        out_np = t.predict(acts)
        out_t = t.predict(torch.from_numpy(acts))
        assert isinstance(out_np, np.ndarray)
        assert isinstance(out_t, torch.Tensor)
        tol = 1e-5 if compress is None else 5e-2
        np.testing.assert_allclose(out_np, want, atol=tol)
        np.testing.assert_array_equal(out_t.numpy(), out_np)
    labels = np.arange(4) % 10
    g, loss = server.split_step(acts, labels, step=0)
    assert isinstance(g, np.ndarray) and g.shape == acts.shape
    g_t, _ = server.split_step(torch.from_numpy(acts), labels, step=1)
    assert isinstance(g_t, torch.Tensor) and g_t.shape == acts.shape


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_local_transport_takes_jax_arguments(call):
    """JAX's signature, in JAX's order: a positional second argument is
    ``through_codec``; ``ef_mode`` and ``wire_id`` are stored."""
    import inspect
    names = list(inspect.signature(LocalTransport).parameters)
    assert names == list(inspect.signature(JaxLocal).parameters)
    server = _port_server(_data())
    args = (True, "int8", 0.25, "clapping", None, "w1")
    if call == "positional":
        t = LocalTransport(server, *args)
    else:
        t = LocalTransport(server, **dict(zip(names[1:], args)))
    assert (t.through_codec, t.compress, t.density, t.ef_mode,
            t.wire_id) == (True, "int8", 0.25, "clapping", "w1")
    assert LocalTransport(server).wire_id == JaxLocal(server).wire_id == "cut"
    # the sixth is the adaptive density controller (ported), which then
    # gives the wire its density
    dc = DensityController(start_rung=0)
    t = LocalTransport(server, False, "topk8", 0.1, "topk8", dc, "hop1")
    assert t._density_now() == dc.density("hop1") == 0.4


def test_through_codec_round_trips_each_payload():
    """``through_codec`` runs the real encode and decode on the direct
    path: the same losses and gradients as without it, the reply in the
    request's kind, and no wire bytes counted (JAX's behaviour)."""
    data = _data()
    direct = LocalTransport(_port_server(data))
    codec_t = LocalTransport(_port_server(data), through_codec=True)
    acts = np.random.RandomState(1).randn(8, 26, 26, 32).astype(np.float32)
    labels = data[0][1]
    out = codec_t.predict(torch.from_numpy(acts))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), direct.predict(acts))
    g0, l0 = direct.split_step(acts, labels, step=0)
    g1, l1 = codec_t.split_step(acts, labels, step=0)
    assert isinstance(g1, np.ndarray) and l0 == l1
    np.testing.assert_array_equal(g0, g1)
    g2, _ = codec_t.split_step(torch.from_numpy(acts), labels, step=1)
    assert isinstance(g2, torch.Tensor)
    assert codec_t.stats.bytes_sent == codec_t.stats.bytes_received == 0


def _protocol_stack(side):
    sample = np.zeros((4, 28, 28, 1), np.float32)
    if side == "jax":
        server = JaxServer(jax_get_plan(mode="split"), JaxConfig(),
                           jax.random.PRNGKey(1), sample)
        return server, JaxLocal(server), JaxProtocolError
    server = ServerRuntime(get_plan(), Config(),
                           torch.Generator().manual_seed(1), device="cpu")
    return server, LocalTransport(server), ProtocolError


@pytest.mark.parametrize("side", ["jax", "port"])
def test_replay_served_from_cache_not_applied_twice(side):
    """JAX's tests/test_transport.py::test_step_handshake_replay_and_stale,
    run on both stacks."""
    server, t, perr = _protocol_stack(side)
    acts = np.zeros((4, 26, 26, 32), np.float32)
    labels = np.zeros((4,), np.int64)

    def first_leaf():
        if side == "port":
            return next(iter(server.params.values())).detach().numpy().copy()
        return np.asarray(jax.tree_util.tree_leaves(
            server.state.params)[0]).copy()

    g0, loss0 = t.split_step(acts, labels, step=5)
    after = first_leaf()
    g1, loss1 = t.split_step(acts, labels, step=5)  # duplicate delivery
    np.testing.assert_array_equal(g0, g1)
    assert loss0 == loss1
    np.testing.assert_array_equal(after, first_leaf())
    assert server.replay.hits == 1
    with pytest.raises(perr) as exc:
        t.split_step(acts, labels, step=3)  # never computed: stale
    assert exc.value.status == 409
    for s in range(6, 6 + server.replay.window + 1):
        t.split_step(acts, labels, step=s)
    with pytest.raises(perr):
        t.split_step(acts, labels, step=5)  # evicted: genuinely stale
    assert server.health()["step"] == 6 + server.replay.window


@pytest.mark.parametrize("policy,rate", [("skip", 0.0), ("retry", 0.4),
                                         ("skip", 0.4)])
def test_fault_policies_match_jax(policy, rate):
    """The same seeded faults give the same dropped batches, the same
    injected count and the same loss pattern on both stacks."""
    data = _data()
    fail_steps = {1, 2} if rate == 0.0 else None
    results = {}
    for side in ("jax", "port"):
        if side == "jax":
            server = JaxServer(jax_get_plan(mode="split"), JaxConfig(),
                               jax.random.PRNGKey(0), data[0][0])
            inj = JaxInjector(failure_rate=rate, seed=0,
                              fail_steps=fail_steps)
            client = JaxClient(jax_get_plan(mode="split"), JaxConfig(),
                               jax.random.PRNGKey(0),
                               JaxFaulty(JaxLocal(server), inj),
                               failure_policy=policy, retry_backoff=0.0)
        else:
            inj = FaultInjector(failure_rate=rate, seed=0,
                                fail_steps=fail_steps)
            client = _port_client(
                data, FaultyTransport(LocalTransport(_port_server(data)),
                                      inj),
                failure_policy=policy, retry_backoff=0.0)
        losses = _train(client, data)
        results[side] = (client.dropped_batches, inj.injected,
                         [loss is None for loss in losses], losses)
    assert results["port"][:3] == results["jax"][:3]
    kept = [(a, b) for a, b in zip(results["port"][3], results["jax"][3])
            if a is not None]
    np.testing.assert_allclose(*zip(*kept), atol=1e-4)
    if rate == 0.0:
        assert results["port"][0] == 2


def test_raise_policy_and_protocol_errors_are_permanent():
    data = _data()
    inj = FaultInjector(fail_steps={0})
    client = _port_client(
        data, FaultyTransport(LocalTransport(_port_server(data)), inj))
    with pytest.raises(TransportError):
        client.train_step(*data[0], 0)
    server = _port_server(data)
    skipper = _port_client(data, LocalTransport(server),
                           failure_policy="skip")
    skipper.train_step(*data[0], 3)
    with pytest.raises(ProtocolError):  # never skipped, never retried
        skipper.train_step(*data[1], 2)
    assert skipper.dropped_batches == 0
    with pytest.raises(ProtocolError) as exc:  # labels do not match rows
        server.split_step(np.zeros((4, 26, 26, 32), np.float32),
                          np.zeros((3,), np.int64), 9)
    assert exc.value.status == 400


def test_replay_lookup_serves_the_attached_frame():
    """The wire-server side of the cache: a duplicate is served the
    attached original frame, or the in-process reply without one."""
    server, t, _ = _protocol_stack("port")
    acts = np.zeros((4, 26, 26, 32), np.float32)
    labels = np.zeros((4,), np.int64)
    g, loss = t.split_step(acts, labels, step=0)
    body, result = server.replay_lookup(0, "split_step", 0)
    assert body is None and result[1] == loss
    server.attach_reply_body(0, "split_step", 0, b"frame")
    assert server.replay_lookup(0, "split_step", 0) == (b"frame", None)
    assert server.replay_lookup(0, "split_step", 1) == (None, None)
    counters = server.metrics()["counters"]
    assert counters["replay_hits_total"] == 1
    assert counters["replay_body_hits_total"] == 1


def test_tracing_records_both_parties(tmp_path):
    data = _data()
    server = _port_server(data)
    transport = LocalTransport(server, compress="int8")
    client = _port_client(data, transport)
    tracer = obs.enable()
    try:
        _train(client, data[:2])
    finally:
        obs.disable()
    names = {sp["name"] for sp in tracer.spans()}
    assert names == set(spans.ALL_SPANS)
    assert transport.stats.counters[f"span_{spans.DISPATCH}_n"] == 2
    assert 0.0 < tracer.fraction(spans.TRANSPORT) < 1.0
    assert tracer.phase_summary()[spans.STEP_TOTAL]["count"] == 2
    assert server.metrics()["counters"]["split_steps_total"] == 2
    import json
    events = json.loads(open(tracer.export_chrome(
        str(tmp_path / "trace.json"))).read())
    assert sum(ev["ph"] == "X" for ev in events) == len(tracer.spans())


def test_lock_watchdog_instruments_the_runtime(monkeypatch):
    """SLT_LOCK_DEBUG=1 swaps in instrumented locks: hold times reach the
    server's lock_hold histogram, and an inverted acquisition order is
    reported."""
    from split_learning_tpu_torch.obs import locks
    monkeypatch.setenv("SLT_LOCK_DEBUG", "1")
    data = _data()
    server = _port_server(data)
    assert isinstance(server._lock, locks.InstrumentedLock)
    _train(_port_client(data, LocalTransport(server)), data[:2])
    hist = server.metrics()["histograms"][spans.LOCK_HOLD]
    assert hist["count"] >= 2
    graph = locks.LockGraph()
    a = locks.make_lock("a", graph=graph)
    b = locks.make_lock("b", graph=graph)
    with a, b:
        pass
    assert not graph.violations
    with b, a:
        pass
    assert [v["kind"] for v in graph.violations] == ["lock-order-inversion"]


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "item 18"),
])
def test_unported_server_arguments_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ServerRuntime(get_plan(), Config(), torch.Generator().manual_seed(0),
                      device="cpu", **kw)


@pytest.mark.parametrize("kw,block", [
    (dict(coalesce_max=2), "coalescing"),
    (dict(tenants=2), "admission"),
    (dict(quota=5.0), "admission"),
    (dict(decouple_bwd=True), "decoupled_bwd"),
    (dict(decouple_bwd=True, apply_lag=1), "decoupled_bwd"),
])
def test_server_under_many_clients_arguments_build(kw, block):
    """Coalescing, admission and 2BP are ported (ROADMAP item 14): each
    builds and reports its /health block."""
    server = ServerRuntime(get_plan(), Config(),
                           torch.Generator().manual_seed(0), device="cpu",
                           **kw)
    try:
        assert block in server.health()
    finally:
        server.close()


def test_unported_modes_and_ops_raise():
    # the U-shaped and federated servers are ported: each mode builds
    for mode in ("u_split", "federated"):
        assert ServerRuntime(get_plan(mode=mode), Config(mode=mode),
                             torch.Generator().manual_seed(0),
                             device="cpu").health()["mode"] == mode
    server = ServerRuntime(get_plan(), Config(),
                           torch.Generator().manual_seed(0), device="cpu")
    t = LocalTransport(server)
    x = np.zeros((1, 26, 26, 32), np.float32)
    # their ops on a split server: the mode guard (400), never retried
    for call in (lambda: t.u_forward(x, 0), lambda: t.u_backward(x, 0),
                 lambda: t.aggregate({}, 0, 0.0, 0)):
        with pytest.raises(ProtocolError, match="called in mode") as exc:
            call()
        assert exc.value.status == 400
    # the chain's hop ops are ported; a two-party server has none, and
    # the transport's lookup of its op fails as JAX's LocalTransport's
    # does
    with pytest.raises(AttributeError, match="hop_forward"):
        t.hop_forward(x, 0)
    # the deferred-apply queue of 2BP is ported: FIFO, bounded by its lag
    seen = []
    queue = _DeferredApply(seen.append, 1, server._lock)
    queue.push({"step": 0})
    queue.push({"step": 1})
    assert queue.drain_over_lag() == 1 and seen == [{"step": 0}]
    assert queue.flush() == 1 and queue.depth() == 0
    # checkpoint resume and the extras sidecar are ported
    payload = server.export_runtime_extras(0)
    assert extras_valid(payload) and payload["step"] == 0
    server.resume_from(server.export_state(), 0, extras=payload)
    assert server.health()["step"] == -1
    # the adaptive density controller is ported: it sets the density
    dc = DensityController()
    assert LocalTransport(server, compress="topk8", density_controller=dc,
                          wire_id="hop1")._density_now() == 0.1
    breaker = CircuitBreaker(t.health)   # ported: accepted, not refused
    assert SplitClientTrainer(get_plan(), Config(),
                              torch.Generator().manual_seed(0), t,
                              breaker=breaker,
                              device="cpu").breaker is breaker
    with pytest.raises(ValueError, match="USplitClientTrainer"):
        SplitClientTrainer(get_plan(mode="u_split"), Config(),
                           torch.Generator().manual_seed(0), t, device="cpu")
    h = server.health()
    assert h["status"] == "healthy" and h["model_type"] == "part_b"


def _cli(*args, device="cpu"):
    cmd = [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
           "train", *args]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_cli_two_party_topk8_loss_falls(tmp_path):
    out = _cli("--transport", "local", "--compress", "topk8", "--steps", "10",
               "--dataset", "synthetic", "--data-dir", str(tmp_path),
               "--tracking", "stdout")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[transport] local compress=topk8 round_trips=10" in out.stdout
    lines = out.stdout.splitlines()
    first = float(next(ln for ln in lines if ln.startswith("[step 0] loss:"))
                  .split(":")[1])
    done = next(ln for ln in lines if ln.startswith("[done]"))
    assert "transport=local steps=10" in done
    assert float(done.split("final_loss=")[1].split()[0]) < first


def test_cli_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this machine has a GPU")
    out = _cli("--transport", "local", "--compress", "int8", "--steps", "1",
               "--dataset", "synthetic", "--data-dir", str(tmp_path),
               device=None)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert not any(tmp_path.iterdir())  # raised before touching data


@pytest.mark.parametrize("flags,item", [
    (["--model-parallel", "2"], "item 18"),
])
def test_cli_unported_flags_refuse(flags, item, tmp_path):
    """What the port still refuses on the local wire: the ``model`` axis
    (``--num-clients 2``, refused here before the mesh slice, runs: the
    test below)."""
    out = _cli("--transport", "local", "--steps", "1", "--dataset",
               "synthetic", "--data-dir", str(tmp_path), *flags)
    assert out.returncode == 2
    assert item in out.stderr


def test_cli_num_clients_runs_on_the_local_wire(tmp_path):
    out = _cli("--transport", "local", "--steps", "1", "--dataset",
               "synthetic", "--data-dir", str(tmp_path), "--num-clients", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[error]" not in out.stderr
