"""The port's flight recorder against the JAX package's
(``tests/test_flight.py``), on the CPU:

- the event names (``FL_*``, ``FLIGHT_EVENTS``) and the telemetry
  gauge names are JAX's, letter for letter;
- the same events recorded into the port's ring and JAX's give equal
  dumps (the per-process fields aside), ring overflow included;
- ``enable``/``disable``, ``SLT_FLIGHT`` (truthy, or a path), ``trip``
  from the lock watchdog and ``fatal`` behave as JAX's;
- with the recorder off a two-party run journals nothing and is
  bitwise the run with it on (losses and wire bytes);
- the dumps of a chaos run over HTTP render through the untouched
  ``scripts/postmortem.py``: duplicates served from the replay cache,
  "anomalies: none";
- mixed pairs (a JAX client against a port server, and the reverse),
  each party journaling into its own package's recorder, join by trace
  ID: every step's client send and server receive carry one ID;
- ``GET /debug/flight`` serves the live ring as JSON (404 while off).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu import obs as jax_obs
from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.obs import flight as jax_flight
from split_learning_tpu.obs import spans as jax_spans
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import flight, locks, spans
from split_learning_tpu_torch.runtime import (
    FailurePolicy, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import (
    ChaosPolicy, ChaosTransport, HttpTransport, LocalTransport,
    SplitHTTPServer)
from split_learning_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, STEPS, TIMEOUT = 8, 6, 30.0
# the per-process fields of a dump: everything else must be JAX's
VOLATILE = ("pid", "host", "captured_at")


@pytest.fixture(autouse=True)
def _recorders_off():
    """Every test starts and ends with both packages' recorders and
    tracers off."""
    for mod in (flight, jax_flight):
        mod.disable()
    obs.disable()
    jax_obs.disable()
    yield
    for mod in (flight, jax_flight):
        mod.disable()
    obs.disable()
    jax_obs.disable()


def _data(steps=STEPS, seed=3):
    ds = jax_synthetic("mnist", n_train=BATCH * steps, n_test=8, seed=seed)
    return list(jax_batches(ds.train, BATCH, seed=seed))


def _jax_init(data):
    return jax_get_plan(mode="split").init(jax.random.PRNGKey(0),
                                           jnp.asarray(data[0][0]))


def _server(data, **kw):
    return ServerRuntime(get_plan(), Config(batch_size=BATCH),
                         params_from_jax(_jax_init(data)), device="cpu",
                         **kw)


def _client(data, transport, **kw):
    return SplitClientTrainer(get_plan(), Config(batch_size=BATCH),
                              params_from_jax(_jax_init(data)), transport,
                              device="cpu", **kw)


def _strip(dump):
    out = {k: v for k, v in dump.items() if k not in VOLATILE}
    out["events"] = [{k: v for k, v in e.items() if k != "t"}
                     for e in dump["events"]]
    return out


def test_event_names_are_jaxs():
    names = [n for n in dir(jax_spans) if n.startswith("FL_")]
    assert names and all(getattr(spans, n) == getattr(jax_spans, n)
                         for n in names)
    assert spans.FLIGHT_EVENTS == jax_spans.FLIGHT_EVENTS
    for n in ("SLO_BURN_FAST", "SLO_BURN_SLOW", "REPLICAS_LIVE",
              "AUTOSCALE_DECISION", "MESH_META", "STAGE_META",
              "WIRE_DENSITY", "HOP_HOST_COPIES"):
        assert getattr(spans, n) == getattr(jax_spans, n)


@pytest.mark.parametrize("capacity", [4, 64])
def test_dump_equals_jaxs_on_the_same_events(capacity):
    """The same event stream through both recorders: equal dumps, the
    ring's overflow (``dropped``) included."""
    mine = flight.FlightRecorder(party="server", capacity=capacity)
    ref = jax_flight.FlightRecorder(party="server", capacity=capacity)
    stream = [(spans.FL_ADMIT, dict(step=s, client_id=s % 3, tenant=1,
                                    deadline=None)) for s in range(5)]
    stream += [(spans.FL_CLAIM_BEGIN, dict(step=2, client_id=1,
                                           trace_id="c1-s2", op="split_step",
                                           owner=True)),
               (spans.FL_CLOSE, dict(party="client")),
               (spans.FL_REPLY, dict(step=2, client_id=1, coalesced=False))]
    for name, kw in stream:
        mine.record(name, **kw)
        ref.record(name, **kw)
    got, want = mine.dump("manual"), ref.dump("manual")
    assert _strip(got) == _strip(want)
    assert got["dropped"] == max(len(stream) - capacity, 0)
    ts = [e["t"] for e in got["events"]]
    assert ts == sorted(ts)


def test_dump_json_is_atomic_and_reads_back(tmp_path):
    fl = flight.FlightRecorder(party="client", capacity=8)
    fl.record(spans.FL_SEND, step=0, client_id=0, trace_id="t0",
              path="/forward_pass")
    path = fl.dump_json(str(tmp_path / "d" / "f.json"), reason="exit")
    back = json.load(open(path))
    assert back["kind"] == "slt-flight-dump" and back["reason"] == "exit"
    assert back["events"][0]["name"] == spans.FL_SEND
    assert [p.name for p in (tmp_path / "d").iterdir()] == ["f.json"]


def test_switch_env_trip_and_fatal(tmp_path, monkeypatch):
    assert flight.get_recorder() is None and not flight.enabled()
    assert flight.trip("lock", "x") is None       # off: nothing
    assert flight.fatal("sigterm") is None
    monkeypatch.setenv("SLT_FLIGHT", "on")
    fl = flight.maybe_enable_from_env(party="server")
    assert fl is flight.get_recorder() and fl.dump_path is None
    flight.disable()
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("SLT_FLIGHT", path)
    monkeypatch.setenv("SLT_FLIGHT_CAPACITY", "16")
    fl = flight.maybe_enable_from_env(party="server")
    assert fl.dump_path == path and fl.capacity == 16
    assert flight.trip("lock", "m" * 900) == path
    dump = json.load(open(path))
    ev = dump["events"][-1]
    assert dump["reason"] == "watchdog:lock"
    assert ev["name"] == spans.FL_WATCHDOG_TRIP
    assert ev["fields"] == {"source": "lock", "message": "m" * 500}
    other = str(tmp_path / "fatal.json")
    assert flight.fatal("sigterm", "signal 15", path=other) == other
    assert json.load(open(other))["reason"] == "fatal:sigterm"
    # JAX's recorder on the same env gives the same configuration
    jfl = jax_flight.maybe_enable_from_env(party="server")
    assert (jfl.dump_path, jfl.capacity) == (fl.dump_path, fl.capacity)


def test_lock_watchdog_report_trips_the_recorder(tmp_path):
    fl = flight.enable(party="server", dump_path=str(tmp_path / "w.json"))
    graph = locks.LockGraph()
    graph.note_hold("ServerRuntime._lock", 0.5, budget_s=0.1)
    trips = [e for e in fl.events()
             if e["name"] == spans.FL_WATCHDOG_TRIP]
    assert len(trips) == 1 and "hold-budget" in trips[0]["fields"]["message"]
    assert json.load(open(tmp_path / "w.json"))["reason"] == "watchdog:lock"


def _local_run(data, compress, recorded):
    """A two-party run over LocalTransport: (losses, wire bytes, the
    events journaled)."""
    fl = flight.enable(party="proc") if recorded else None
    server = _server(data)
    t = LocalTransport(server, compress=compress)
    client = _client(data, t)
    losses = [client.train_step(x, y, i) for i, (x, y) in enumerate(data)]
    server.close()
    flight.disable()
    return losses, t.stats.summary(), (fl.events() if fl else [])


@pytest.mark.parametrize("compress", [None, "int8"])
def test_recorder_off_is_bitwise_the_recorded_run(compress):
    data = _data()
    off = _local_run(data, compress, False)
    on = _local_run(data, compress, True)
    assert off[0] == on[0]
    for key in ("round_trips", "bytes_sent", "bytes_received"):
        assert off[1].get(key) == on[1].get(key)
    assert off[2] == []
    names = {e["name"] for e in on[2]}
    assert {spans.FL_SEND, spans.FL_RECV, spans.FL_CLAIM_BEGIN,
            spans.FL_CLAIM_RESOLVE, spans.FL_DISPATCH, spans.FL_REPLY,
            spans.FL_CLOSE} <= names
    # every step's send and server dispatch journaled once
    for name in (spans.FL_SEND, spans.FL_DISPATCH):
        assert sorted(e["step"] for e in on[2] if e["name"] == name) == \
            list(range(STEPS))


def _postmortem(*paths):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "postmortem.py"),
         *paths], capture_output=True, text=True, timeout=120)


def test_chaos_run_over_http_renders_through_postmortem(tmp_path):
    """JAX's verify recipe on the port: a chaos twin over HTTP with a
    retrying client; the dump renders with its duplicates and ends
    "anomalies: none"."""
    data = _data(steps=8)
    fl = flight.enable(party="proc")
    srv = SplitHTTPServer(_server(data)).start()
    wire = ChaosTransport(HttpTransport(srv.url, timeout=TIMEOUT),
                          ChaosPolicy("drop_resp=0.3,dup=0.3", seed=3))
    try:
        client = _client(data, wire, failure_policy=FailurePolicy.RETRY,
                         max_retries=5, retry_backoff=0.0)
        losses = [client.train_step(x, y, i)
                  for i, (x, y) in enumerate(data)]
    finally:
        wire.close()
        srv.stop()
        srv.runtime.close()
    assert all(np.isfinite(losses)) and len(losses) == 8
    names = [e["name"] for e in fl.events()]
    assert spans.FL_CHAOS in names
    assert spans.FL_REPLAY_HIT in names or spans.FL_CLAIM_WAIT in names
    path = fl.dump_json(str(tmp_path / "chaos.flight.json"), reason="exit")
    out = _postmortem(path)
    assert out.returncode == 0, out.stderr
    assert "duplicates served from the replay cache" in out.stdout
    assert out.stdout.rstrip().splitlines()[-1].startswith(
        "anomalies: none")


def _by_trace(events, name, party):
    return {e["trace_id"]: e["step"] for e in events
            if e["name"] == name and e["party"] == party}


@pytest.mark.parametrize("pair", ["jax_client-port_server",
                                  "port_client-jax_server"])
def test_mixed_pair_joins_by_trace_id(pair, tmp_path):
    """Each party journals into its own package's recorder (both traced);
    the two dumps merge: every step's client send and server receive
    carry the same trace ID, and postmortem finds no anomaly."""
    data = _data(steps=4)
    jfl = jax_flight.enable(party="proc")
    pfl = flight.enable(party="proc")
    jax_obs.enable()
    obs.enable()
    if pair == "jax_client-port_server":
        srv = SplitHTTPServer(_server(data)).start()
        wire = JaxHttp(srv.url, timeout=TIMEOUT)
        client = JaxClient(jax_get_plan(mode="split"),
                           JaxConfig(batch_size=BATCH),
                           jax.random.PRNGKey(0), wire)
        client_fl, server_fl = jfl, pfl
    else:
        srv = JaxHTTPServer(JaxServer(jax_get_plan(mode="split"),
                                      JaxConfig(batch_size=BATCH),
                                      jax.random.PRNGKey(0), data[0][0]),
                            port=0).start()
        wire = HttpTransport(srv.url, timeout=TIMEOUT)
        client = _client(data, wire)
        client_fl, server_fl = pfl, jfl
    try:
        for i, (x, y) in enumerate(data):
            client.train_step(x, y, i)
    finally:
        wire.close()
        srv.stop()
    sent = _by_trace(client_fl.events(), spans.FL_SEND, "client")
    got = _by_trace(server_fl.events(), spans.FL_RECV, "server")
    assert len(sent) == len(data) and None not in sent
    assert sent == got
    paths = [client_fl.dump_json(str(tmp_path / "c.json"), reason="exit"),
             server_fl.dump_json(str(tmp_path / "s.json"),
                                 reason="fatal:sigterm")]
    out = _postmortem(*paths)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().splitlines()[-1].startswith(
        "anomalies: none")


def test_debug_flight_endpoint():
    data = _data(steps=2)
    srv = SplitHTTPServer(_server(data)).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(srv.url + "/debug/flight", timeout=10)
        assert exc.value.code == 404
        flight.enable(party="server")
        wire = HttpTransport(srv.url, timeout=TIMEOUT)
        client = _client(data, wire)
        for i, (x, y) in enumerate(data):
            client.train_step(x, y, i)
        wire.close()
        with urllib.request.urlopen(srv.url + "/debug/flight",
                                    timeout=10) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            dump = json.loads(resp.read())
    finally:
        srv.stop()
    assert dump["kind"] == "slt-flight-dump" and dump["reason"] == "http"
    recv = [e for e in dump["events"] if e["name"] == spans.FL_RECV
            and e["party"] == "server"]
    assert [e["step"] for e in recv] == [0, 1]


def test_concurrent_records_keep_a_dense_sequence():
    """More recording threads than cores, switching often: no event is
    lost and the sequence stays dense (the record path takes no lock)."""
    fl = flight.FlightRecorder(capacity=100_000)
    n = 4 * (os.cpu_count() or 4)

    def work(k):
        for i in range(500):
            fl.record(spans.FL_ADMIT, step=i, client_id=k)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    seqs = sorted(e["seq"] for e in fl.events())
    assert seqs == list(range(500 * n))
