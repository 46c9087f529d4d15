"""The port's HTTP wire against the JAX package's, over loopback sockets.

- a port client and a port server (``device="cpu"``) track the JAX
  client and JAX server from one init (carried across with
  ``interop.params_from_jax``) on the same batches: losses within the
  two-party tolerances (``TOL``: 1e-4 dense, 1e-3 compressed, as in
  ``tests/test_torch_port_two_party.py``), and equal round trips and
  wire bytes;
- mixed pairs over a real socket: a port client against a JAX
  ``SplitHTTPServer``, and a JAX ``HttpTransport`` against a port
  server, within the same tolerances of the JAX pair; the port client's
  request frames are byte-equal to the JAX client's for the same
  tensors;
- JAX's ``tests/test_http_transport.py`` and the ``/metrics`` part of
  ``tests/test_obs.py``, on the port: the health payload (with the
  port's version), the status mapping, ``wait_ready`` and its backoff,
  the Prometheus text byte-equal to JAX's ``render_prometheus``, and the
  trace spans folded across the wire.

Every server binds port 0 and stops in ``finally``; every transport has
a timeout.
"""

import http.client
import io
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.obs.metrics import (
    render_prometheus as jax_render_prometheus)
from split_learning_tpu.runtime import ProtocolError as JaxProtocolError
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport import TransportError as JaxTransportError
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import __version__, obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs.metrics import render_prometheus
from split_learning_tpu_torch.runtime import (
    ProtocolError, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import (
    Backpressure, DensityController, HttpTransport, LocalTransport,
    SplitHTTPServer, TransportError, codec)
from split_learning_tpu_torch.transport.http import CRC_HEADER
from split_learning_tpu_torch.utils.config import Config

BATCH, STEPS, TIMEOUT = 8, 5, 30.0
TOL = {"none": 1e-4, "int8": 1e-3, "topk8": 1e-3, "clapping": 1e-3}


def _data(batch=BATCH, steps=STEPS, seed=3):
    ds = jax_synthetic("mnist", n_train=batch * steps, n_test=8, seed=seed)
    return list(jax_batches(ds.train, batch, seed=seed))


def _jax_init(data):
    return jax_get_plan(mode="split").init(jax.random.PRNGKey(0),
                                           jnp.asarray(data[0][0]))


def _port_server(data, batch=BATCH, **kw):
    return ServerRuntime(get_plan(), Config(batch_size=batch),
                         params_from_jax(_jax_init(data)), device="cpu",
                         **kw)


def _jax_server(data, batch=BATCH):
    return JaxServer(jax_get_plan(mode="split"), JaxConfig(batch_size=batch),
                     jax.random.PRNGKey(0), data[0][0])


def _port_client(data, transport, batch=BATCH, **kw):
    return SplitClientTrainer(get_plan(), Config(batch_size=batch),
                              params_from_jax(_jax_init(data)), transport,
                              device="cpu", **kw)


def _jax_client(transport, batch=BATCH):
    return JaxClient(jax_get_plan(mode="split"), JaxConfig(batch_size=batch),
                     jax.random.PRNGKey(0), transport)


def _train(client, data):
    return [client.train_step(x, y, i) for i, (x, y) in enumerate(data)]


def _capture(server):
    """Record every POST body ``server`` (a port or JAX
    ``SplitHTTPServer``) receives, as ``(path, bytes)``, in order."""
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


def _run_pair(server_rt, server_cls, transport_cls, client_fn, data,
              compress):
    srv = server_cls(server_rt).start()
    t = transport_cls(srv.url, timeout=TIMEOUT, compress=compress)
    try:
        return _train(client_fn(t), data), t.stats
    finally:
        t.close()
        srv.stop()


@pytest.mark.parametrize("compress", ["none", "int8", "topk8", "clapping"])
def test_port_pair_over_http_tracks_jax_pair(compress):
    data = _data()
    j_losses, j_stats = _run_pair(_jax_server(data), JaxHTTPServer, JaxHttp,
                                  _jax_client, data, compress)
    server = _port_server(data)
    losses, stats = _run_pair(server, SplitHTTPServer, HttpTransport,
                              lambda t: _port_client(data, t), data,
                              compress)
    np.testing.assert_allclose(losses, j_losses, atol=TOL[compress])
    for field in ("round_trips", "bytes_sent", "bytes_received"):
        assert getattr(stats, field) == getattr(j_stats, field), field
    assert stats.counters == j_stats.counters
    assert server.health()["step"] == STEPS - 1
    if compress != "none":
        gauge = server.metrics()["gauges"]["wire_compression_ratio"]
        assert gauge == pytest.approx(stats.summary()["compression_ratio"])


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_mixed_pairs_over_a_socket(pair, compress):
    data = _data(batch=16, steps=6, seed=0)
    j_losses, _ = _run_pair(_jax_server(data, 16), JaxHTTPServer, JaxHttp,
                            lambda t: _jax_client(t, 16), data, compress)
    if pair == "port_client_jax_server":
        losses, _ = _run_pair(_jax_server(data, 16), JaxHTTPServer,
                              HttpTransport,
                              lambda t: _port_client(data, t, 16), data,
                              compress)
    else:
        losses, _ = _run_pair(_port_server(data, 16), SplitHTTPServer,
                              JaxHttp, lambda t: _jax_client(t, 16), data,
                              compress)
    np.testing.assert_allclose(losses, j_losses, atol=TOL[compress])


@pytest.mark.parametrize("compress", ["none", "int8", "topk8", "clapping"])
def test_request_frames_byte_equal_to_jax(compress):
    """The same cut tensors through the port's client (as CPU tensors,
    as the trainer hands them) and JAX's (as numpy): every request frame
    byte-equal, the error-feedback ledger included (three steps)."""
    data = _data()
    rs = np.random.RandomState(7)
    sends = [(rs.randn(BATCH, 26, 26, 32).astype(np.float32),
              rs.randint(0, 10, BATCH).astype(np.int64)) for _ in range(3)]
    frames = {}
    for side in ("jax", "port"):
        srv = SplitHTTPServer(_port_server(data)).start()
        bodies = _capture(srv)
        if side == "jax":
            t = JaxHttp(srv.url, timeout=TIMEOUT, compress=compress)
        else:
            t = HttpTransport(srv.url, timeout=TIMEOUT, compress=compress)
        try:
            for i, (acts, labels) in enumerate(sends):
                t.split_step(acts if side == "jax"
                             else torch.from_numpy(acts),
                             labels if side == "jax"
                             else torch.from_numpy(labels), i)
        finally:
            t.close()
            srv.stop()
        frames[side] = bodies
    assert len(frames["port"]) == 3
    assert frames["port"] == frames["jax"]


def test_http_matches_local_transport():
    """The same server math on either wire: HTTP == in-process codec."""
    data = _data()
    srv = SplitHTTPServer(_port_server(data)).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT)
    local = LocalTransport(_port_server(data), through_codec=True)
    rs = np.random.RandomState(3)
    acts = rs.randn(BATCH, 26, 26, 32).astype(np.float32)
    labels = rs.randint(0, 10, BATCH).astype(np.int64)
    try:
        g_http, l_http = t.split_step(acts, labels, 0)
        g_t, _ = t.split_step(torch.from_numpy(acts), labels, 1)
    finally:
        t.close()
        srv.stop()
    g_local, l_local = local.split_step(acts, labels, 0)
    assert isinstance(g_http, np.ndarray)   # numpy in, numpy out
    assert isinstance(g_t, torch.Tensor)    # a tensor in, a tensor out
    np.testing.assert_array_equal(g_http, g_local)
    assert l_http == l_local


def test_health_payload_and_off_path_routes():
    data = _data()
    srv = SplitHTTPServer(_port_server(data)).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT)
    try:
        h = t.health()
        assert h.pop("uptime_seconds") >= 0.0
        assert h == {"status": "healthy", "mode": "split",
                     "model_type": "part_b", "step": -1,
                     "strict_steps": True, "version": __version__}
        for path, err in (
                ("/debug/flight", "flight recorder off (SLT_FLIGHT/--flight)"),
                ("/telemetry", "telemetry off (SLT_TELEMETRY/--telemetry)"),
                ("/nowhere", "not found")):
            resp, content = t._request("GET", path)
            assert resp.status == 404
            assert codec.decode(content) == {"error": err}
    finally:
        t.close()
        srv.stop()


def test_status_mapping():
    """409 (a step below the replay window), 400 (a bad frame CRC, and
    an op of another mode: the U-shaped hops and FedAvg on a split
    server), 500 with the ROADMAP item for the ops the port does not
    serve, a refused connection; a duplicate within the window is served
    the original frame."""
    data = _data()
    runtime = _port_server(data)
    srv = SplitHTTPServer(runtime).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT)
    jt = JaxHttp(srv.url, timeout=TIMEOUT)
    acts = np.zeros((2, 26, 26, 32), np.float32)
    labels = np.zeros((2,), np.int64)
    try:
        g0, l0 = t.split_step(acts, labels, step=10)
        g1, l1 = t.split_step(acts, labels, step=10)  # duplicate delivery
        np.testing.assert_array_equal(g0, g1)
        assert l0 == l1 and runtime.replay.body_hits == 1
        for s in range(11, 11 + runtime.replay.window + 1):
            t.split_step(acts, labels, step=s)
        with pytest.raises(ProtocolError) as exc:
            t.split_step(acts, labels, step=10)   # evicted: stale
        assert exc.value.status == 409
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
        conn.request("POST", "/forward_pass", body=b"\x80",
                     headers={CRC_HEADER: "1"})
        resp = conn.getresponse()
        assert resp.status == 400
        assert codec.decode(resp.read()) == {
            "error": "frame checksum mismatch"}
        conn.close()
        # an op of another mode: the runtime's mode guard, a 400 (JAX's
        # client raises its ProtocolError for it without the status)
        for call in (lambda: jt.u_forward(acts, 0),
                     lambda: jt.aggregate({"w": np.zeros(2, np.float32)},
                                          0, 0.0, 99)):
            with pytest.raises(JaxProtocolError,
                               match="called in mode 'split'"):
                call()
        for call in (lambda: t.u_backward(acts, 0),
                     lambda: t.aggregate({"w": np.zeros(2, np.float32)},
                                         0, 0.0, 99)):
            with pytest.raises(ProtocolError,
                               match="called in mode 'split'") as exc:
                call()
            assert exc.value.status == 400
        # a hop op reaches the runtime, which a two-party server is not
        # (it has no hop ops): a server fault, a 500, as on JAX's server
        with pytest.raises(JaxTransportError, match="500.*hop_forward"):
            jt.hop_forward(acts, 0)
    finally:
        t.close()
        jt.close()
        srv.stop()
    dead = HttpTransport("http://127.0.0.1:9", timeout=5)
    with pytest.raises(TransportError):
        dead.health()
    with pytest.raises(TransportError):
        dead.split_step(acts, labels, 0)


class _RefusingRuntime:
    """A runtime whose admission refuses every step (the 429 path)."""

    def health(self):
        return {"status": "healthy", "mode": "split"}

    def split_step(self, activations, labels, step, client_id=0):
        raise Backpressure("tenant over quota", retry_after_s=0.25)


def test_backpressure_429_and_ef_rollback():
    srv = SplitHTTPServer(_RefusingRuntime()).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT, compress="topk8")
    acts = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    try:
        with pytest.raises(Backpressure) as exc:
            t.split_step(acts, np.zeros(4, np.int64), 0)
        assert exc.value.retry_after_s == pytest.approx(0.25)
        assert t._ef.residual("acts") is None   # the pack rolled back
    finally:
        t.close()
        srv.stop()


def test_lost_reply_maps_to_transport_error_and_reconnects():
    """A server that closes without a status line (a reply lost after
    apply) is a TransportError, and the next request on the same thread
    opens a fresh connection."""
    data = _data()
    runtime = _port_server(data)
    srv = SplitHTTPServer(runtime).start()
    handler = srv._httpd.RequestHandlerClass
    do_post, lost = handler.do_POST, {"n": 1}

    def dropping(self):
        if lost["n"]:
            lost["n"] -= 1
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.close_connection = True
            return
        do_post(self)

    handler.do_POST = dropping
    t = HttpTransport(srv.url, timeout=TIMEOUT)
    acts = np.zeros((2, 26, 26, 32), np.float32)
    labels = np.zeros((2,), np.int64)
    try:
        with pytest.raises(TransportError):
            t.split_step(acts, labels, 0)
        g, loss = t.split_step(acts, labels, 0)
        assert g.shape == acts.shape and np.isfinite(loss)
    finally:
        t.close()
        srv.stop()


def test_metrics_text_is_jax_render_prometheus():
    """``GET /metrics`` is JAX's exposition of the same snapshot plus the
    port's build-info line; the renderer is JAX's byte for byte,
    labelled series and escapes included."""
    snap = {
        "histograms": {"dispatch": {"buckets": (0.001, 0.01),
                                    "cumulative": [1, 3, 4], "sum": 0.25,
                                    "count": 4}},
        "phase_fractions": {"dispatch": 1.0},
        "counters": {"split_steps_total": 4.0, "2bad-name": 1.0},
        "gauges": {"acked_step": 3.0},
        "labeled": [{"name": "replica_steps", "labels": {
            "replica": 'a"b\\c\nd'}, "value": 2.0},
            {"name": "acked_step", "labels": {"r": "0"}, "value": 1.0,
             "type": "gauge"}]}
    assert render_prometheus(snap) == jax_render_prometheus(snap)

    class _Fixed:
        def health(self):
            return {"status": "healthy"}

        def metrics(self):
            return snap

    srv = SplitHTTPServer(_Fixed()).start()
    try:
        with urllib.request.urlopen(f"{srv.url}/metrics",
                                    timeout=10) as resp:
            assert "version=0.0.4" in resp.headers["Content-Type"]
            text = resp.read().decode()
    finally:
        srv.stop()
    assert text == (jax_render_prometheus(snap)
                    + f'slt_build_info{{version="{__version__}"}} 1\n')


def test_tracing_folds_server_spans_over_the_wire():
    data = _data()
    runtime = _port_server(data)
    srv = SplitHTTPServer(runtime).start()
    t = HttpTransport(srv.url, timeout=TIMEOUT, compress="int8")
    client = _port_client(data, t)
    tracer = obs.enable()
    try:
        _train(client, data[:3])
        with urllib.request.urlopen(f"{srv.url}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
    finally:
        obs.disable()
        t.close()
        srv.stop()
    names = {sp["name"] for sp in tracer.spans()}
    assert set(spans.ALL_SPANS) | {spans.ENCODE, spans.WIRE} == names
    for name in (spans.ENCODE, spans.WIRE, spans.QUEUE_WAIT,
                 spans.DISPATCH):
        assert t.stats.counters[f"span_{name}_s"] > 0.0
        assert t.stats.counters[f"span_{name}_n"] == 3
    assert "slt_split_steps_total 3" in text
    assert render_prometheus(runtime.metrics()).splitlines()[0] in text


def test_wait_ready_blocks_until_the_server_is_up():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    runtime = _port_server(_data())
    started = {}

    def late_start():
        time.sleep(0.8)
        started["server"] = SplitHTTPServer(runtime, port=port).start()

    th = threading.Thread(target=late_start)
    th.start()
    t = HttpTransport(f"http://127.0.0.1:{port}", timeout=5)
    try:
        t0 = time.monotonic()
        info = t.wait_ready(timeout=10.0, interval=0.1)
        assert time.monotonic() - t0 >= 0.5
        assert info["status"] == "healthy" and info["mode"] == "split"
    finally:
        th.join()
        t.close()
        started["server"].stop()


@pytest.mark.parametrize("stalls, timeout, ok", [
    (2, None, True),       # two lost handshakes, then a fresh socket
    (10**6, 0.2, False),   # a timeout shorter than one attempt: no retry
])
def test_stalled_handshake_retries_on_a_fresh_socket(monkeypatch, stalls,
                                                      timeout, ok):
    """A connect that times out is given up after ``CONNECT_ATTEMPT_S``
    and retried on a fresh socket within the transport's timeout (the
    request was never sent); the connected socket keeps the full
    timeout for the reply."""
    from split_learning_tpu_torch.transport import http as port_http
    real = http.client.HTTPConnection.connect
    seen = []

    def stalling_connect(conn):
        seen.append(conn.timeout)
        if len(seen) <= stalls:
            raise TimeoutError("timed out")
        real(conn)

    monkeypatch.setattr(http.client.HTTPConnection, "connect",
                        stalling_connect)
    srv = SplitHTTPServer(_port_server(_data())).start()
    t = HttpTransport(srv.url, timeout=timeout or TIMEOUT)
    try:
        if ok:
            assert t.health()["status"] == "healthy"
            assert t.connect_retries == stalls
            assert seen == [port_http.CONNECT_ATTEMPT_S] * (stalls + 1)
            (conn,) = t._conns
            assert conn.timeout == TIMEOUT
        else:
            with pytest.raises(TransportError, match="timed out"):
                t.health()
            assert t.connect_retries == 0 and len(seen) == 1
            assert seen[0] <= timeout
    finally:
        t.close()
        srv.stop()


def test_wait_ready_times_out():
    dead = HttpTransport("http://127.0.0.1:9", timeout=5)
    t0 = time.monotonic()
    with pytest.raises(TransportError):
        dead.wait_ready(timeout=0.5, interval=0.1)
    assert time.monotonic() - t0 < 5.0


def test_wait_ready_backoff_schedule(monkeypatch):
    """Virtual clock: the sleeps are the schedule, JAX's, doubling from
    ``interval`` to ``max_interval`` and clamped to the deadline."""
    slept = []
    clock = {"t": 0.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])

    def fake_sleep(s):
        slept.append(s)
        clock["t"] += s

    monkeypatch.setattr(time, "sleep", fake_sleep)
    dead = HttpTransport("http://127.0.0.1:9", timeout=5)
    with pytest.raises(TransportError):
        dead.wait_ready(timeout=10.0, interval=0.1, max_interval=5.0,
                        jitter=0.0)
    assert slept == pytest.approx([0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 3.7])
    jittered = []
    monkeypatch.setattr(time, "sleep", lambda s: jittered.append(s) or
                        clock.update(t=clock["t"] + s))
    clock["t"] = 0.0
    with pytest.raises(TransportError):
        dead.wait_ready(timeout=10.0, interval=0.1, jitter=0.5, seed=3)
    rs = np.random.RandomState(3)
    want = [0.1 * 2 ** i * (1 + 0.5 * rs.rand()) for i in range(3)]
    np.testing.assert_allclose(jittered[:3], want)


def test_unported_client_ops_and_arguments():
    t = HttpTransport("http://127.0.0.1:9", timeout=5)
    x = np.zeros((1, 4), np.float32)
    # the chain's hops, the U-shaped hops and FedAvg are ported: they
    # reach the socket
    for call in (lambda: t.hop_forward(x, 0), lambda: t.hop_loss(x, x, 0),
                 lambda: t.hop_backward(x, 0), lambda: t.u_forward(x, 0),
                 lambda: t.u_backward(x, 0),
                 lambda: t.aggregate({}, 0, 0.0, 0)):
        with pytest.raises(TransportError):
            call()
    # the adaptive controller is ported: it sets the wire's density
    dc = DensityController()
    wired = HttpTransport("http://127.0.0.1:9", compress="topk8",
                          density_controller=dc, wire_id="hop1")
    assert wired._density_now() == dc.density("hop1") == 0.1
    with pytest.raises(ValueError, match="pool_maxsize"):
        HttpTransport("http://127.0.0.1:9", pool_maxsize=0)
    with pytest.raises(ValueError, match="compression"):
        HttpTransport("http://127.0.0.1:9", compress="zip")
    with pytest.raises(ValueError, match="URL"):
        HttpTransport("127.0.0.1:9")
    assert HttpTransport("http://h:1/").wire_id == "http://h:1/"
    with pytest.raises(ValueError, match="compression"):
        SplitHTTPServer(object(), compress="zip")
