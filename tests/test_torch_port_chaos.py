"""The port's chaos wire and circuit breaker against the JAX package's
(``tests/test_chaos.py``), on the CPU:

- the spec grammar and the seeded, bounded schedule give JAX's faults at
  the same ``(path, step, attempt)`` keys;
- chaos off (a zero-rate policy) trains bitwise as the bare wire;
- a response lost after the server applied is recovered bit-identical
  over HTTP from the replay cache, and a client-side dup is served from
  it;
- the chaos twin (as ``chip_smoke.py`` phase 16 runs it on the card, at
  batch 8 and 8 steps): server-side ``drop_resp``, ``corrupt``,
  ``http500`` and ``drop_req`` under a retrying client with the breaker
  lose no batch, replay exactly the post-apply faults, resend every
  retried frame byte for byte, and give the clean run's losses;
- EF rollback then re-pack is bit-identical, on numpy and on tensors;
- the breaker's state machine and its give-up, and backpressure waits
  that leave it closed.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.transport.chaos import ChaosPolicy as JaxPolicy
from split_learning_tpu.transport.chaos import (
    parse_chaos_spec as jax_parse)
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    CircuitBreaker, FailurePolicy, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.runtime.breaker import CLOSED, HALF_OPEN, OPEN
from split_learning_tpu_torch.transport import (
    ChaosPolicy, ChaosTransport, HttpTransport, LocalTransport,
    SplitHTTPServer, TransportError, backoff_delays, codec)
from split_learning_tpu_torch.transport.chaos import parse_chaos_spec
from split_learning_tpu_torch.transport.codec import (
    TopK8EF, topk8_compress)
from split_learning_tpu_torch.utils.config import Config

BATCH, TIMEOUT = 8, 30.0
TWIN_SPEC = "drop_resp=0.2,corrupt=0.1,http500=0.1,drop_req=0.1"


def _data(steps=5, seed=3):
    ds = jax_synthetic("mnist", n_train=BATCH * steps, n_test=8, seed=seed)
    return list(jax_batches(ds.train, BATCH, seed=seed))


def _init(data):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(0), jnp.asarray(data[0][0])))


def _server(data):
    return ServerRuntime(get_plan(), Config(batch_size=BATCH), _init(data),
                         device="cpu")


def _client(data, transport, **kw):
    return SplitClientTrainer(get_plan(), Config(batch_size=BATCH),
                              _init(data), transport, device="cpu", **kw)


def _capture(server):
    """Every POST body the server receives, as (path, bytes), in order."""
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


def test_parse_chaos_spec_grammar():
    spec = "drop_resp=0.1,dup,delay=0.02:250"
    f = parse_chaos_spec(spec)
    assert list(f) == ["drop_resp", "dup", "delay"]
    assert f["drop_resp"] == (0.1, 50.0)
    assert f["dup"][0] == 0.05
    assert f["delay"] == (0.02, 250.0)
    assert f == jax_parse(spec)
    for bad, match in (("drop_response=0.1", "unknown chaos kind"),
                       ("dup=lots", "bad chaos rate"),
                       ("delay=0.1:soon", "bad chaos arg"),
                       ("dup=1.5", "in \\[0, 1\\]"),
                       ("dup=0.6,drop_resp=0.6", "sum to > 1")):
        with pytest.raises(ValueError, match=match):
            parse_chaos_spec(bad)
        with pytest.raises(ValueError, match=match):
            jax_parse(bad)


@pytest.mark.parametrize("spec,seed", [
    ("drop_resp=0.15,dup=0.1,http500=0.05", 7),
    (TWIN_SPEC, 0), ("delay=0.3:5,corrupt=0.3", 11)])
def test_schedule_is_jaxs_seeded_and_bounded(spec, seed):
    keys = [(p, s, a) for p in ("/forward_pass", "/u_backward")
            for s in range(60) for a in range(3)]
    port, jax_p = ChaosPolicy(spec, seed=seed), JaxPolicy(spec, seed=seed)
    sched = [port.draw(*k) for k in keys]
    assert sched == [jax_p.draw(*k) for k in keys]
    assert sched == [ChaosPolicy(spec, seed=seed).draw(*k) for k in keys]
    assert any(f is not None for f in sched)
    assert sched != [ChaosPolicy(spec, seed=seed + 1).draw(*k)
                     for k in keys]
    assert all(port.draw("/forward_pass", s, 2) is None for s in range(200))


def test_chaos_off_path_is_bitwise_the_bare_wire():
    data = _data()
    runs = {}
    for wrap in (False, True):
        transport = LocalTransport(_server(data), compress="int8")
        if wrap:
            transport = ChaosTransport(
                transport, ChaosPolicy("drop_resp=0.0", seed=3))
        client = _client(data, transport)
        runs[wrap] = [client.train_step(x, y, i)
                      for i, (x, y) in enumerate(data)]
    assert runs[True] == runs[False]


def test_lost_response_recovered_bit_identical_over_http():
    """The server applies step 0, the reply dies twice on the wire
    (drop_resp=1.0, two faults a key), the third attempt is served the
    original frame: the same gradient as a clean server's, one apply."""
    data = _data()
    runtime = _server(data)
    srv = SplitHTTPServer(runtime,
                          chaos=ChaosPolicy("drop_resp=1.0", seed=0)).start()
    clean_srv = SplitHTTPServer(_server(data)).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT, compress="topk8")
    clean = HttpTransport(clean_srv.url, timeout=TIMEOUT, compress="topk8")
    rs = np.random.RandomState(4)
    acts = torch.from_numpy(rs.randn(BATCH, 26, 26, 32).astype(np.float32))
    labels = rs.randint(0, 10, (BATCH,)).astype(np.int64)
    try:
        with pytest.raises(TransportError):
            t.split_step(acts, labels, 0)     # applied, reply lost
        assert runtime.health()["step"] == 0
        with pytest.raises(TransportError):
            t.split_step(acts, labels, 0)     # the cached reply lost too
        g, loss = t.split_step(acts, labels, 0)
        g_ref, loss_ref = clean.split_step(acts, labels, 0)
        assert torch.equal(g, g_ref) and loss == loss_ref
        assert runtime.health()["step"] == 0
        assert runtime.replay.body_hits == 2
        assert srv.chaos.injected == {"drop_resp": 2}
        # the client's EF ledger ends where a clean wire leaves it
        np.testing.assert_array_equal(t._ef.residual("acts").numpy(),
                                      clean._ef.residual("acts").numpy())
    finally:
        for x in (t, clean, srv, clean_srv):
            (x.close if hasattr(x, "close") else x.stop)()


def test_client_side_dup_served_from_replay_cache():
    data = _data()
    runtime = _server(data)
    transport = ChaosTransport(LocalTransport(runtime),
                               ChaosPolicy("dup=1.0", seed=0))
    g, loss = transport.split_step(np.ones((BATCH, 26, 26, 32), np.float32),
                                   np.zeros((BATCH,), np.int64), 0)
    assert np.all(np.isfinite(g))
    assert runtime.health()["step"] == 0
    assert runtime.replay.hits >= 1
    assert transport.stats.counters.get("chaos_dup") == 1


def test_client_side_chaos_over_http_retries_to_the_end():
    data = _data(steps=6)
    runtime = _server(data)
    srv = SplitHTTPServer(runtime).start()
    t = ChaosTransport(HttpTransport(srv.url, timeout=TIMEOUT),
                       ChaosPolicy("drop_resp=0.3,dup=0.2,drop_req=0.2",
                                   seed=5))
    try:
        client = _client(data, t, failure_policy=FailurePolicy.RETRY,
                         max_retries=3, retry_backoff=0.0,
                         breaker=CircuitBreaker(t.health, seed=0))
        losses = [client.train_step(x, y, i) for i, (x, y) in
                  enumerate(data)]
    finally:
        t.close()
        srv.stop()
    assert all(np.isfinite(losses)) and client.dropped_batches == 0
    assert runtime.health()["step"] == len(data) - 1
    assert sum(t.policy.injected.values()) > 0


def _twin_run(data, mode, spec):
    runtime = _server(data)
    chaos = ChaosPolicy(spec, seed=0) if spec else None
    srv = SplitHTTPServer(runtime, chaos=chaos).start()
    bodies = _capture(srv)
    t = HttpTransport(srv.url, timeout=TIMEOUT, compress=mode)
    try:
        client = _client(data, t, failure_policy=FailurePolicy.RETRY,
                         retry_backoff=0.0,
                         breaker=CircuitBreaker(t.health, seed=0))
        losses = [client.train_step(x, y, i)
                  for i, (x, y) in enumerate(data)]
        health = t.health()
    finally:
        t.close()
        srv.stop()
    return losses, client, runtime, chaos, bodies, health


@pytest.mark.parametrize("mode", ["int8", "topk8"])
def test_chaos_twin_matches_the_clean_run(mode):
    data = _data(steps=8)
    clean, *_ = _twin_run(data, mode, None)
    losses, client, runtime, chaos, bodies, health = _twin_run(
        data, mode, TWIN_SPEC)
    assert client.dropped_batches == 0
    assert health["step"] == len(data) - 1
    post_apply = chaos.injected.get("drop_resp", 0) + chaos.injected.get(
        "corrupt", 0)
    assert post_apply > 0 and sum(chaos.injected.values()) > post_apply
    assert runtime.replay.body_hits == post_apply
    assert len(bodies) == len(data) + sum(chaos.injected.values())
    # every retried frame is its first attempt's, byte for byte: the EF
    # rollback and re-pack reproduce it
    first = {}
    for _, body in bodies:
        step = int(codec.decode(body)["step"])
        assert first.setdefault(step, body) == body
    np.testing.assert_allclose(losses, clean, rtol=0, atol=1e-5)


def test_ef_rollback_then_repack_is_bit_identical():
    for kind in ("numpy", "tensor"):
        ef = TopK8EF()
        arr = np.random.RandomState(0).randn(64, 64).astype(np.float32)
        warm = np.random.RandomState(1).randn(64, 64).astype(np.float32)
        if kind == "tensor":
            arr, warm = torch.from_numpy(arr), torch.from_numpy(warm)
        ef.compress("k", warm, 0.05)          # a non-zero residual
        p1 = ef.compress("k", arr, 0.05)
        r1 = ef.residual("k")
        ef.rollback("k")
        p2 = ef.compress("k", arr, 0.05)
        assert p1.keys() == p2.keys()
        for key in p1:
            if isinstance(p1[key], np.ndarray):
                np.testing.assert_array_equal(p1[key], p2[key])
            else:
                assert p1[key] == p2[key]
        np.testing.assert_array_equal(np.asarray(r1),
                                      np.asarray(ef.residual("k")))
    d1, r1 = topk8_compress(arr, 0.05)
    d2, r2 = topk8_compress(arr, 0.05)
    np.testing.assert_array_equal(d1["q"], d2["q"])
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))


def test_backoff_delays_schedule_and_jitter():
    gen = backoff_delays(0.5, jitter=0.0)
    assert [next(gen) for _ in range(6)] == [0.5, 1.0, 2.0, 4.0, 5.0, 5.0]
    g1 = backoff_delays(0.5, jitter=0.5, rng=np.random.RandomState(0))
    g2 = backoff_delays(0.5, jitter=0.5, rng=np.random.RandomState(0))
    d1 = [next(g1) for _ in range(6)]
    assert d1 == [next(g2) for _ in range(6)]
    for base, d in zip([0.5, 1.0, 2.0, 4.0, 5.0, 5.0], d1):
        assert base <= d <= base * 1.5


def test_circuit_breaker_state_machine():
    up = {"ok": True}

    def probe():
        if not up["ok"]:
            raise TransportError("down")
        return {"status": "healthy"}

    slept = []
    br = CircuitBreaker(probe, failure_threshold=3, probe_jitter=0.0,
                        seed=0, sleep=slept.append)
    assert br.state == CLOSED
    br.before_attempt()
    assert slept == []
    br.record_failure()
    br.record_failure()
    assert br.state == CLOSED
    br.record_failure()
    assert br.state == OPEN and br.counters["breaker_opened"] == 1
    br.before_attempt()
    assert br.state == HALF_OPEN and br.counters["breaker_probes"] == 1
    assert slept == [0.5]
    br.record_failure()
    assert br.state == OPEN and br.counters["breaker_reopened"] == 1
    up["ok"] = False
    br.max_open_s = 1e9
    fails = {"n": 0}

    def flaky():
        fails["n"] += 1
        if fails["n"] < 3:
            raise TransportError("still down")

    br._probe = flaky
    br.before_attempt()     # two failed probes on the backoff, then up
    assert br.state == HALF_OPEN
    assert br.counters["breaker_probe_failures"] == 2
    assert slept[1:] == [0.5, 1.0, 2.0]
    br.record_success()
    assert br.state == CLOSED and br.counters["breaker_reclosed"] == 1
    with pytest.raises(ValueError):
        CircuitBreaker(probe, failure_threshold=0)


def test_circuit_breaker_gives_up_after_max_open_s():
    def dead():
        raise TransportError("down forever")

    br = CircuitBreaker(dead, failure_threshold=1, max_open_s=0.0,
                        probe_jitter=0.0, sleep=lambda _s: None)
    br.record_failure()
    assert br.state == OPEN
    with pytest.raises(TransportError, match="circuit open"):
        br.before_attempt()
    assert br.counters["breaker_probe_failures"] >= 1


def test_backpressure_wait_leaves_the_breaker_closed():
    slept = []
    br = CircuitBreaker(lambda: None, failure_threshold=1, sleep=slept.append)
    br.backpressure_wait(0.25)
    br.backpressure_wait(-1.0)
    assert br.state == CLOSED and slept == [0.25, 0.0]
    assert br.counters["breaker_backpressure_waits"] == 2


def test_trainer_with_breaker_probes_a_dead_server_and_skips():
    """Skip policy with an open breaker: the step's attempts go to
    /health probes, the batch is dropped and counted."""
    data = _data(steps=1)
    probes = []

    def probe():
        probes.append(1)
        raise TransportError("down")

    dead = HttpTransport("http://127.0.0.1:9", timeout=5)
    br = CircuitBreaker(probe, failure_threshold=1, max_open_s=0.0,
                        probe_jitter=0.0, sleep=lambda _s: None)
    client = _client(data, dead, failure_policy=FailurePolicy.SKIP,
                     breaker=br)
    assert client.breaker is br
    assert client.train_step(*data[0], 0) is None
    assert client.dropped_batches == 1 and br.state == OPEN
    assert client.train_step(*data[0], 1) is None   # probes, gives up
    assert probes and client.dropped_batches == 2
