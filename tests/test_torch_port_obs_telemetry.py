"""The port's telemetry plane against the JAX package's
(``tests/test_telemetry.py``), on the CPU:

- ``histogram_percentile`` and ``histogram_delta`` equal JAX's on the
  same snapshots, their edge cases included: an empty delta reads 0, a
  percentile in the +Inf slot clamps, a counter reset falls back to the
  post-reset value;
- the ring's windows (rates, deltas, percentiles, the idle intervals a
  late advance skips, a forced partial window) and the SLO tracker's
  burn pair and alerts equal JAX's on the same virtual clock and the
  same snapshots; ``env_config`` and ``tracker_from_config`` read the
  same environment alike;
- ``FleetCollector``'s merged view and per-window critical path equal
  JAX's on the same dumps, and over HTTP (``serve_telemetry``);
- a port server's ``GET /telemetry`` (404 while off) serves windows of
  its own steps, and the dump renders through the untouched
  ``scripts/slt_top.py --once``.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.obs import federate as jax_federate
from split_learning_tpu.obs import flight as jax_flight
from split_learning_tpu.obs import metrics as jax_metrics
from split_learning_tpu.obs import telemetry as jax_telemetry
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import federate, flight, metrics, spans
from split_learning_tpu_torch.obs import telemetry
from split_learning_tpu_torch.runtime import ServerRuntime, SplitClientTrainer
from split_learning_tpu_torch.transport import HttpTransport, SplitHTTPServer
from split_learning_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, TIMEOUT = 8, 30.0


@pytest.fixture(autouse=True)
def _planes_off():
    for mod in (telemetry, jax_telemetry):
        mod.disable()
    flight.disable()
    jax_flight.disable()
    obs.disable()
    yield
    for mod in (telemetry, jax_telemetry):
        mod.disable()
    flight.disable()
    jax_flight.disable()
    obs.disable()


def _hist(values):
    h = metrics.Histogram()
    for v in values:
        h.observe(v)
    return h.snapshot()


SNAPS = {
    "empty": {"buckets": metrics.DEFAULT_BUCKETS, "cumulative": [0] * 17,
              "sum": 0.0, "count": 0},
    "bare": {"buckets": (), "cumulative": [], "count": 0},
    "small": _hist([0.0002, 0.0004, 0.003, 0.02, 0.02, 0.3]),
    "inf": _hist([0.001, 50.0, 60.0, 70.0]),
    "one": _hist([0.004]),
}


@pytest.mark.parametrize("name", sorted(SNAPS))
@pytest.mark.parametrize("q", [0.0, 1.0, 50.0, 90.0, 95.0, 99.0, 100.0])
def test_histogram_percentile_equals_jaxs(name, q):
    snap = SNAPS[name]
    assert metrics.histogram_percentile(snap, q) == \
        jax_metrics.histogram_percentile(snap, q)
    if name == "inf" and q >= 99.0:
        assert metrics.histogram_percentile(snap, q) == 10.0  # clamped
    if name in ("empty", "bare"):
        assert metrics.histogram_percentile(snap, q) == 0.0


def test_histogram_percentile_refuses_a_bad_q():
    for mod in (metrics, jax_metrics):
        with pytest.raises(ValueError):
            mod.histogram_percentile(SNAPS["one"], 101.0)


@pytest.mark.parametrize("cur,prev", [
    ("small", None), ("small", "one"), ("small", "small"),
    ("one", "small"),            # a reset: the count went backwards
    ("inf", "one"), ("empty", "empty")])
def test_histogram_delta_equals_jaxs(cur, prev):
    c, p = SNAPS[cur], (SNAPS[prev] if prev else None)
    got = metrics.histogram_delta(c, p)
    want = jax_metrics.histogram_delta(c, p)
    assert got == want
    if cur == prev:
        assert got["count"] == 0 and metrics.histogram_percentile(
            got, 50.0) == 0.0
    if (cur, prev) == ("one", "small"):
        assert got["count"] == SNAPS["one"]["count"]   # post-reset value


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Party:
    """A party's cumulative ``metrics()`` stream, scripted per call."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.reg = metrics.Registry()
        self.calls = 0

    def snapshot(self):
        self.calls += 1
        n = int(self.rs.randint(0, 6))
        for _ in range(n):
            self.reg.observe(spans.DISPATCH, float(self.rs.choice(
                [0.002, 0.02, 0.2, 1.5])))
            self.reg.observe(spans.QUEUE_WAIT, float(self.rs.rand() * 0.01))
            self.reg.incr("split_steps_total")
            self.reg.incr("admission_admitted_t0")
        if self.rs.rand() < 0.3:
            self.reg.incr("admission_rejected_t0", 2)
        self.reg.set_gauge("admission_queue_depth", float(n))
        snap = self.reg.snapshot()
        if self.calls == 7:   # a restart: every counter falls back
            snap["counters"] = {k: 1.0 for k in snap["counters"]}
        return snap


TICKS = [0.2, 1.1, 1.3, 2.05, 4.9, 5.0, 6.2, 6.21, 9.7, 10.4, 10.9, 13.0,
         13.1, 14.2]


def _drive(mod, slo):
    clock = _Clock()
    party = _Party(seed=7)
    tracker = None
    if slo:
        tracker = mod.SLOTracker(
            [mod.SloObjective("latency", tenant=0, slo_ms=25.0,
                              target=0.9),
             mod.SloObjective("availability", tenant=0, target=0.95)],
            fast_windows=2, slow_windows=4, threshold=1.0)
    ring = mod.TelemetryRing(party.snapshot, party="server",
                             interval_s=1.0, capacity=8, clock=clock,
                             slo=tracker)
    appended = []
    for dt in TICKS:
        clock.t = 100.0 + dt
        appended.append(ring.advance())
    clock.t += 0.3
    appended.append(ring.advance(force=True))
    return appended, ring.dump()


@pytest.mark.parametrize("slo", [False, True])
def test_ring_and_slo_tracker_equal_jaxs_on_a_virtual_clock(slo):
    got = _drive(telemetry, slo)
    want = _drive(jax_telemetry, slo)
    assert got == want
    appended, dump = got
    assert dump["kind"] == "slt-telemetry" and len(dump["windows"]) == 8
    if slo:
        assert dump["slo"]["alerts"], "the scripted stream fires an alert"


def test_slo_alert_journals_into_the_flight_recorder():
    fl = flight.enable(party="server")
    tracker = telemetry.SLOTracker(
        [telemetry.SloObjective("latency", slo_ms=1.0, target=0.9)],
        fast_windows=1, slow_windows=1)
    h = _hist([0.5, 0.5])
    alerts = tracker.observe_window({"index": 3,
                                     "histograms": {spans.DISPATCH: h}})
    assert [a.state for a in alerts] == ["firing"]
    ev = [e for e in fl.events() if e["name"] == spans.FL_SLO_ALERT]
    assert len(ev) == 1 and ev[0]["fields"]["window_index"] == 3


@pytest.mark.parametrize("env", [
    {}, {"SLT_TELEMETRY": "1"},
    {"SLT_TELEMETRY": "on", "SLT_TELEMETRY_INTERVAL_S": "0.25",
     "SLT_TELEMETRY_CAPACITY": "30", "SLT_TELEMETRY_SLO_MS": "40",
     "SLT_TELEMETRY_BURN_THRESHOLD": "2"},
    {"SLT_TELEMETRY": "no"}])
def test_env_config_equals_jaxs(env, monkeypatch):
    for k in ("SLT_TELEMETRY", "SLT_TELEMETRY_INTERVAL_S",
              "SLT_TELEMETRY_CAPACITY", "SLT_TELEMETRY_SLO_MS",
              "SLT_TELEMETRY_BURN_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = telemetry.env_config()
    assert cfg == jax_telemetry.env_config()
    if cfg is not None:
        mine = telemetry.tracker_from_config(cfg, tenants=2)
        ref = jax_telemetry.tracker_from_config(cfg, tenants=2)
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert mine.dump() == ref.dump()


def _fleet_dumps(mod):
    """Hub, two stages and a server replica: rings driven on one virtual
    clock from scripted registries."""
    clock = _Clock()
    rs = np.random.RandomState(11)
    regs = {k: metrics.Registry() for k in ("hub", "s1", "s2", "r0")}

    def feed():
        for _ in range(int(rs.randint(1, 4))):
            regs["hub"].observe(spans.STEP_TOTAL, 0.5 + rs.rand())
            regs["hub"].observe(spans.WIRE, 0.3 + rs.rand() * 0.2)
            regs["hub"].incr("hub_steps_total")
            for k in ("s1", "s2"):
                regs[k].observe(spans.DISPATCH, rs.rand() * 0.2)
                regs[k].observe(spans.REPLY_GRAD, rs.rand() * 0.1)
                regs[k].observe(spans.QUEUE_WAIT, rs.rand() * 0.05)
            regs["r0"].incr("admission_admitted_t1")
            regs["r0"].incr("admission_rejected_t0")
    rings = {k: mod.TelemetryRing(r.snapshot, party=k, interval_s=1.0,
                                  capacity=16, clock=clock)
             for k, r in regs.items()}
    for t in (0.5, 1.2, 2.4, 3.1, 4.6, 6.0):
        feed()
        clock.t = 100.0 + t
        for ring in rings.values():
            ring.advance()
    return {k: ring.dump() for k, ring in rings.items()}


def _parties(dumps):
    return [{"role": "hub", "dump": dumps["hub"]},
            {"role": "stage", "stage": 1, "dump": dumps["s1"]},
            {"role": "stage", "stage": 2, "dump": dumps["s2"]},
            {"role": "server", "replica": 0, "dump": dumps["r0"]},
            {"role": "server", "replica": 1}]           # no source


def test_fleet_view_and_critical_path_equal_jaxs():
    dumps = _fleet_dumps(telemetry)
    assert dumps == _fleet_dumps(jax_telemetry)
    got = federate.FleetCollector(_parties(dumps)).collect()
    want = jax_federate.FleetCollector(_parties(dumps)).collect()
    assert got == want
    assert got["critical_path"] and got["bottlenecks"]
    assert got["parties"]["server.r1"]["error"]
    assert got["tenant_rates"]["t1"]["admission_admitted"] > 0
    for w in got["critical_path"]:
        assert w["bottleneck"]["party"] in ("hub", "stage1", "stage2",
                                            "server.r0")
    assert federate.split_tenant("admission_admitted_t12") == \
        ("admission_admitted", 12)
    assert federate.party_key("server", None, 3) == "server.r3"


def test_serve_telemetry_and_a_url_scrape():
    clock = _Clock()
    reg = metrics.Registry()
    ring = telemetry.TelemetryRing(reg.snapshot, party="hub",
                                   interval_s=1.0, clock=clock)
    srv, _ = federate.serve_telemetry(ring, port=0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        reg.observe(spans.STEP_TOTAL, 0.25)
        clock.t += 1.5
        view = federate.FleetCollector(
            [{"role": "hub", "url": url}]).collect()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nowhere", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert view["parties"]["hub"]["error"] is None
    assert view["parties"]["hub"]["windows"] == 1


def _data(steps, seed=3):
    ds = jax_synthetic("mnist", n_train=BATCH * steps, n_test=8, seed=seed)
    return list(jax_batches(ds.train, BATCH, seed=seed))


def test_port_server_telemetry_endpoint_and_slt_top(tmp_path):
    data = _data(6)
    init = params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(0), jnp.asarray(data[0][0])))
    runtime = ServerRuntime(get_plan(), Config(batch_size=BATCH), init,
                            device="cpu")
    srv = SplitHTTPServer(runtime).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(srv.url + "/telemetry", timeout=10)
        assert exc.value.code == 404
        obs.enable()     # the windows read the tracer-gated histograms
        clock = _Clock()
        ring = telemetry.TelemetryRing(runtime.metrics, party="server",
                                       interval_s=1.0, clock=clock)
        srv.telemetry = ring
        wire = HttpTransport(srv.url, timeout=TIMEOUT)
        client = SplitClientTrainer(get_plan(), Config(batch_size=BATCH),
                                    init, wire, device="cpu")
        for i, (x, y) in enumerate(data):
            client.train_step(x, y, i)
            clock.t += 0.4
        wire.close()
        with urllib.request.urlopen(srv.url + "/telemetry",
                                    timeout=10) as resp:
            dump = json.loads(resp.read())
    finally:
        srv.stop()
    windows = dump["windows"]
    assert dump["kind"] == "slt-telemetry" and windows
    steps = sum(w["counters"].get("split_steps_total", 0) for w in windows)
    assert steps == 6
    busy = [w for w in windows if w["percentiles"]]
    assert busy and {"p50", "p95", "p99"} <= set(
        busy[-1]["percentiles"][spans.DISPATCH])
    path = tmp_path / "server.json"
    path.write_text(json.dumps(dump))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "slt_top.py"),
         "--once", f"server={path}"], capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "server" in out.stdout and "SLO firing: none" in out.stdout


def test_global_ring_switch():
    assert telemetry.get_ring() is None and not telemetry.enabled()
    ring = telemetry.enable(metrics.Registry().snapshot, party="p",
                            interval_s=0.05)
    assert telemetry.get_ring() is ring
    ring.start_sampler()
    telemetry.disable()
    assert telemetry.get_ring() is None and ring._sampler is None
