"""The port's fleet harness (``runtime/fleet.py``) against JAX's, on the
CPU: the same arrival offsets for every process and seed; a 16-client
fleet of ``LocalTransport`` clients against the port's server, clean,
chaos-wrapped, and against a replica group with one replica killed
mid-load, every step completed and none dropped; ``warm_fleet``'s
rounds; and ``python -m split_learning_tpu_torch.runtime.fleet``,
fleet_sim's flags and JSON summary, with its gates.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from split_learning_tpu.runtime.fleet import FleetConfig as JaxFleetConfig
from split_learning_tpu.runtime.fleet import (
    arrival_offsets as jax_arrival_offsets)
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    ReplicaGroup, ServerRuntime, maybe_replicate)
from split_learning_tpu_torch.runtime.fleet import (
    FleetConfig, arrival_offsets, main, run_fleet, warm_fleet)
from split_learning_tpu_torch.transport import (
    ChaosPolicy, ChaosTransport, LocalTransport)
from split_learning_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arrival", ["poisson", "burst", "diurnal"])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_offsets_equal_jaxs(arrival, seed):
    kw = dict(n_clients=40, steps_per_client=12, arrival=arrival,
              rate_hz=3.0, burst_size=4, diurnal_period_s=1.5, seed=seed)
    cfg, jcfg = FleetConfig(**kw), JaxFleetConfig(**kw)
    for cid in range(40):
        assert arrival_offsets(cfg, cid) == jax_arrival_offsets(jcfg, cid)


def test_fleet_config_validates():
    with pytest.raises(ValueError, match="arrival"):
        FleetConfig(arrival="bursty")
    with pytest.raises(ValueError):
        FleetConfig(n_clients=0)
    with pytest.raises(ValueError, match="rate_hz"):
        FleetConfig(rate_hz=0.0)


def _server(_idx=0, **kw):
    return ServerRuntime(get_plan(), Config(batch_size=4,
                                            num_clients=1 << 20),
                         torch.Generator().manual_seed(1), device="cpu",
                         **kw)


CFG = FleetConfig(n_clients=16, tenants=2, steps_per_client=3,
                  arrival="burst", rate_hz=4.0, burst_size=2, seed=1,
                  workers=8, batch=4)


def _chaos(server):
    def make(cid):
        policy = ChaosPolicy("drop_resp=0.1,dup=0.1",
                             seed=7 * 1_000_003 + cid)
        return ChaosTransport(LocalTransport(server), policy)
    return make


@pytest.mark.parametrize("leg", ["clean", "chaos", "kill_replica",
                                 "kill_replica_chaos"])
def test_sixteen_client_fleet_drops_no_step(leg):
    group = None
    if leg.startswith("kill"):
        server = group = maybe_replicate(_server, 2)
        cfg = dataclasses.replace(CFG, kill_replica_at=10)
    else:
        server = _server(tenants=2)
        cfg = CFG
    make = (_chaos(server) if leg.endswith("chaos")
            else (lambda cid: LocalTransport(server)))
    res = run_fleet(cfg, make, group=group)
    c = res.counters
    assert c["fleet_steps_total"] == cfg.n_clients * cfg.steps_per_client
    assert c["fleet_dropped_steps"] == 0
    assert len(res.losses) == cfg.n_clients * cfg.steps_per_client
    assert all(np.isfinite(v) for v in res.losses.values())
    assert set(res.per_tenant) == {0, 1}
    for row in res.per_tenant.values():
        assert row["steps"] == 24 and row["step_p99_ms"] >= row[
            "step_p50_ms"] > 0
    assert res.overall["step_p99_ms"] > 0
    if group is not None:
        assert c["fleet_replica_kills"] == 1
        ctr = group.counters()
        assert ctr["replica_handoffs"] == 1 and ctr["replica_deaths"] == 1
        assert len(group.live_replicas()) == 1
        # every (client, step) applied once group-wide: each replica's
        # acknowledged steps, summed over its clients, are the fleet's
        applied = sum(len(r._last_step) for r in group.replicas)
        assert applied >= cfg.n_clients
    if leg.endswith("chaos"):
        assert c.get("fleet_retries_total", 0) > 0
    server.close()


def test_warm_fleet_primes_each_group_shape():
    server = _server(coalesce_max=4, coalesce_window_ms=5.0,
                     batching="continuous")
    rounds = warm_fleet(server, lambda cid: LocalTransport(server), CFG)
    assert 2 <= rounds <= 4
    # the pow2 buckets of 1..4 requests of 4 rows: 4, 8, 16
    assert server.health()["coalescing"]["compile_count"] >= 3
    server.close()


def test_fleet_with_an_autoscaler_is_poked_each_step():
    calls = []

    class Scaler:
        def maybe_scale(self):
            calls.append(1)
    server = ReplicaGroup([_server(i) for i in range(2)])
    res = run_fleet(dataclasses.replace(CFG, n_clients=4), lambda cid:
                    LocalTransport(server), autoscaler=Scaler())
    assert len(calls) == res.counters["fleet_steps_total"] == 12
    server.close()


def _sim(capsys, *flags):
    rc = main(["--device", "cpu", "--clients", "8", "--steps", "3",
               "--arrival", "burst", "--rate", "2.0", "--burst-size", "2",
               "--batch", "4", "--workers", "8", *flags])
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def test_fleet_sim_face_replicas_and_kill(capsys):
    rc, summary, err = _sim(capsys, "--tenants", "2", "--replicas", "2",
                            "--kill-replica-at", "6", "--gate-dropped-steps")
    assert rc == 0 and "gate ok: 24/24 steps, 0 dropped" in err
    assert summary["dropped_steps"] == 0 and summary["steps_completed"] == 24
    assert set(summary["per_tenant"]) == {"0", "1"}
    for key in ("step_p50_ms", "step_p99_ms"):
        assert key in summary["overall"]
        assert key in summary["per_tenant"]["0"]
    rep = summary["replication"]
    assert rep["kills"] == 1 and rep["handoff"]["replica_handoffs"] == 1
    assert rep["live_replicas"] != [0, 1]
    assert set(summary["utilization"]) == {
        "mean_occupancy", "steady_state_occupancy", "admission_reject_rate",
        "step_p99_over_slo", "slo_attained"}
    assert summary["dispatch"]["unexpected_d2h_total"] == 0
    assert summary["dispatch"]["steady_state_recompiles"] == 0


def _scripted_load(monkeypatch, slow_s=0.08, hold_timeout_s=60.0):
    """A load that holds for the windows each scale event needs, so that
    neither event waits on how fast this machine runs the steps.

    - Pressure, from the autoscaler's start to its first scale-up: every
      server step's loss takes ``slow_s`` more inside the dispatch span,
      well over the 30 ms SLO, so the first window with traffic reads p99
      over the SLO.
    - Hold, from that scale-up to the first scale-down: new requests wait
      at the group's door (before any replica takes them), so the pump's
      windows are idle until the policy retires a replica.
    - Then the remaining steps run as they come. A hold that outlasts
      ``hold_timeout_s`` lets the requests through, so a policy that never
      scales down fails the assertions instead of hanging."""
    import threading
    import time as _time

    from split_learning_tpu_torch.runtime import autoscale as rt_autoscale
    from split_learning_tpu_torch.runtime import server as server_mod
    phase = {"now": "off"}
    released = threading.Event()

    def slowed(fn):
        def call(*args, **kw):
            if phase["now"] == "pressure":
                _time.sleep(slow_s)
            return fn(*args, **kw)
        return call
    for name in ("fused_cross_entropy", "cross_entropy_rows"):
        monkeypatch.setattr(server_mod, name,
                            slowed(getattr(server_mod, name)))

    start = rt_autoscale.Autoscaler.start
    scale_up = rt_autoscale.Autoscaler._scale_up
    scale_down = rt_autoscale.Autoscaler._scale_down
    group_step = ReplicaGroup.split_step

    def start_(self, *a, **kw):
        phase["now"] = "pressure"
        return start(self, *a, **kw)

    def scale_up_(self, decision):
        scale_up(self, decision)
        if decision.executed and phase["now"] == "pressure":
            phase["now"] = "hold"

    def scale_down_(self, decision):
        scale_down(self, decision)
        if decision.executed:
            phase["now"] = "free"
            released.set()

    def split_step_(self, *a, **kw):
        if phase["now"] == "hold":
            released.wait(hold_timeout_s)
        return group_step(self, *a, **kw)
    monkeypatch.setattr(rt_autoscale.Autoscaler, "start", start_)
    monkeypatch.setattr(rt_autoscale.Autoscaler, "_scale_up", scale_up_)
    monkeypatch.setattr(rt_autoscale.Autoscaler, "_scale_down",
                        scale_down_)
    monkeypatch.setattr(ReplicaGroup, "split_step", split_step_)


def test_fleet_sim_face_autoscale_gate(capsys, monkeypatch):
    """The CLI face with ``--gate-autoscale``: a scale-up under pressure
    and a scale-down when the load lets go, with no step dropped. The
    load is scripted (:func:`_scripted_load`): both events followed the
    machine's speed before (a loaded run's first burst ran into the
    second, leaving no idle windows after the scale-up)."""
    _scripted_load(monkeypatch)
    rc, summary, err = _sim(
        capsys, "--steps", "6", "--rate", "1.0", "--burst-size", "3",
        "--autoscale", "--autoscale-min", "1", "--autoscale-max", "3",
        "--autoscale-cooldown-s", "0.2", "--telemetry-interval-s", "0.3",
        "--slo-ms", "30", "--gate-dropped-steps", "--gate-autoscale")
    block = summary["autoscale"]
    assert rc == 0, (err, block)
    assert block["enabled"] and block["scale_ups"] >= 1
    assert block["scale_downs"] >= 1 and summary["dropped_steps"] == 0
    assert block["pump_errors"] == block["step_hook_errors"] == 0
    assert block["last_error"] is None
    assert summary["telemetry"]["enabled"]
    assert block["peak_replicas"] <= 3 and block["final_replicas"] >= 1


def test_fleet_sim_face_counts_failed_scale_events(capsys, monkeypatch):
    # every scale-up fails: the run still completes its steps, but the
    # summary counts the faults and the autoscale gate fails on them
    def add_replica(self, factory):
        raise RuntimeError("spawn failed")
    monkeypatch.setattr(ReplicaGroup, "add_replica", add_replica)
    rc, summary, err = _sim(
        capsys, "--steps", "6", "--rate", "1.0", "--burst-size", "3",
        "--autoscale", "--autoscale-min", "1", "--autoscale-max", "3",
        "--autoscale-cooldown-s", "0.2", "--telemetry-interval-s", "0.3",
        "--slo-ms", "1", "--gate-autoscale")
    block = summary["autoscale"]
    assert rc == 1 and "AUTOSCALE GATE FAILED" in err
    assert block["scale_ups"] == 0
    assert block["pump_errors"] + block["step_hook_errors"] >= 1
    assert block["last_error"] == "RuntimeError: spawn failed"
    assert summary["dropped_steps"] == 0


def test_fleet_sim_face_refusals(capsys):
    assert main(["--device", "cpu", "--kill-replica-at", "3"]) == 2
    assert "needs --replicas > 1" in capsys.readouterr().err
    assert main(["--device", "cpu", "--gate-autoscale"]) == 2
    assert "needs --autoscale" in capsys.readouterr().err


def test_fleet_module_runs_as_a_program(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "split_learning_tpu_torch.runtime.fleet",
         "--device", "cpu", "--clients", "4", "--steps", "2", "--batch",
         "4", "--rate", "4.0", "--gate-dropped-steps", "--chaos",
         "--no-warm"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout)
    assert summary["config"]["chaos"] and summary["steps_completed"] == 8
