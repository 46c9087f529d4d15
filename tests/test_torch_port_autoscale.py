"""The port's elastic autoscaling (``runtime/autoscale.py``) against
JAX's, on the CPU.

- Every case of tests/test_autoscale.py runs again with its module's
  names (``AutoscalePolicy``, ``AutoscaleSignals``,
  ``signals_from_window``, ``Autoscaler``, ``ReplicaGroup``,
  ``ReplayCache``, ``maybe_replicate``, ``rendezvous_pick``, the
  ``autoscale`` module, ``spans``, ``OPEN``) bound to the port's: the
  policy's verdicts, the window reduction, the env and CLI configs, and
  the autoscaler's scale events on a group of JAX's stub replicas.
- The same signal series under the same clock gives the port's policy
  and JAX's the same decisions (direction, reason, live count), window
  by window, and ``signals_from_window`` the same signals.
- ``Autoscaler`` on a group of the port's ``ServerRuntime`` replicas
  scales up and down on window signals, journals ``fl_scale_*`` and sets
  the ``autoscale_decision`` gauge; a scale-down's victim hands its
  replay entries to the survivor.
"""

import inspect
import random
import time

import numpy as np
import pytest
import torch

import test_autoscale as jax_cases
from split_learning_tpu.runtime import autoscale as jax_autoscale
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.runtime import (
    ReplicaGroup, ServerRuntime, maybe_replicate, rendezvous_pick)
from split_learning_tpu_torch.runtime import autoscale as rt_autoscale
from split_learning_tpu_torch.runtime.autoscale import (
    Autoscaler, AutoscalePolicy, AutoscaleSignals, signals_from_window)
from split_learning_tpu_torch.runtime.breaker import OPEN
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.replica import ScaleRefused
from split_learning_tpu_torch.utils.config import Config

PORT_NAMES = {
    "AutoscalePolicy": AutoscalePolicy, "AutoscaleSignals": AutoscaleSignals,
    "signals_from_window": signals_from_window, "Autoscaler": Autoscaler,
    "ReplicaGroup": ReplicaGroup, "ReplayCache": ReplayCache,
    "maybe_replicate": maybe_replicate, "rendezvous_pick": rendezvous_pick,
    "rt_autoscale": rt_autoscale, "spans": spans, "OPEN": OPEN}
CASES = sorted(n for n in dir(jax_cases) if n.startswith("test_"))


def test_every_name_the_cases_use_is_bound_to_the_port():
    for name in PORT_NAMES:
        assert hasattr(jax_cases, name), name


@pytest.mark.parametrize("case", CASES)
def test_jax_case_holds_for_the_port(case, monkeypatch):
    for name, obj in PORT_NAMES.items():
        monkeypatch.setattr(jax_cases, name, obj)
    fn = getattr(jax_cases, case)
    kw = {"monkeypatch": monkeypatch} \
        if "monkeypatch" in inspect.signature(fn).parameters else {}
    fn(**kw)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _random_signals(rng):
    def maybe(v):
        return None if rng.random() < 0.3 else v
    return dict(occupancy=maybe(rng.random() * 1.2),
                reject_rate=maybe(rng.choice([0.0, 0.0, 0.005, 0.2])),
                burn=maybe(rng.random() * 2.0),
                p99_over_slo=maybe(rng.random() * 1.6))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hyst", [(1, 1), (1, 2), (2, 3)])
def test_decision_series_equals_jaxs(seed, hyst):
    """200 windows of random signals, the clock stepping 0.7 s a window,
    cooldowns 1 s up / 2 s down: the two policies agree on every call."""
    rng = random.Random(seed)
    clocks = _Clock(), _Clock()
    kw = dict(min_replicas=1, max_replicas=3, hysteresis_up=hyst[0],
              hysteresis_down=hyst[1], cooldown_up_s=1.0,
              cooldown_down_s=2.0)
    port = AutoscalePolicy(clock=clocks[0], **kw)
    ref = jax_autoscale.AutoscalePolicy(clock=clocks[1], **kw)
    n_live, moves = 1, 0
    for i in range(200):
        sig = _random_signals(rng)
        for c in clocks:
            c.t = 0.7 * i
        a = port.decide(AutoscaleSignals(window_index=i, **sig), n_live)
        b = ref.decide(jax_autoscale.AutoscaleSignals(window_index=i, **sig),
                       n_live)
        assert (a.direction, a.reason, a.n_live) == (
            b.direction, b.reason, b.n_live), i
        n_live += {"up": 1, "down": -1}.get(a.direction, 0)
        moves += a.direction != "hold"
    assert moves > 0


def test_signals_from_window_equal_jaxs():
    rng = np.random.RandomState(0)
    for i in range(50):
        window = {"index": i, "counters": {
            "coalesce_groups_flushed": float(rng.randint(0, 5)),
            "coalesce_requests_coalesced": float(rng.randint(0, 20)),
            spans.ADMISSION_ADMITTED: float(rng.randint(0, 9)),
            spans.ADMISSION_REJECTED: float(rng.randint(0, 3))},
            "gauges": ({f"{spans.SLO_BURN_FAST}_t0": float(rng.rand() * 2)}
                       if i % 2 else {}),
            "percentiles": ({spans.DISPATCH: {"p99": float(rng.rand() * 80)}}
                            if i % 3 else {})}
        for cm, slo in ((4, 30.0), (1, None)):
            a = signals_from_window(window, coalesce_max=cm, slo_ms=slo)
            b = jax_autoscale.signals_from_window(window, coalesce_max=cm,
                                                  slo_ms=slo)
            assert vars(a) == vars(b)


class _Ring:
    """A telemetry ring that hands out the windows it is given."""

    def __init__(self):
        self._windows = []

    def push(self, **sig_window):
        self._windows.append(dict(index=len(self._windows), **sig_window))

    def advance(self, force=False):
        return 0

    def windows(self, last=None):
        return self._windows[-last:] if last else list(self._windows)


def _server(_idx):
    return ServerRuntime(get_plan(), Config(batch_size=8),
                         torch.Generator().manual_seed(0), device="cpu")


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 26, 26, 32).astype(np.float32),
            rs.randint(0, 10, (8,)).astype(np.int64))


def test_autoscaler_on_a_port_group():
    rec = obs_flight.enable("test")
    try:
        group = ReplicaGroup([_server(0)])
        ring = _Ring()
        scaler = Autoscaler(group, _server, AutoscalePolicy(
            min_replicas=1, max_replicas=2, hysteresis_up=1,
            hysteresis_down=1, cooldown_up_s=0.0, cooldown_down_s=0.0,
            clock=_Clock()), ring, coalesce_max=4, slo_ms=10.0)
        for c in range(16):
            group.split_step(*_batch(c), 0, c)
        ring.push(counters={}, gauges={},
                  percentiles={spans.DISPATCH: {"p99": 25.0}})
        d = scaler.maybe_scale()
        assert d.direction == "up" and d.executed and d.replica == 1
        assert group.metrics()["gauges"][spans.AUTOSCALE_DECISION] == 1.0
        assert group.live_replicas() == [0, 1]
        for k, v in group.replicas[0].params.items():
            assert torch.equal(v, group.replicas[1].params[k])
        moved = [c for c in range(16) if group.assignment(c) == 1]
        assert moved
        # an idle window: the least-loaded (here the newcomer, on ties
        # the newest) retires through the handoff
        ring.push(counters={}, gauges={}, percentiles={})
        d = scaler.maybe_scale()
        assert d.direction == "down" and d.executed
        assert group.live_replicas() == [0] or group.live_replicas() == [1]
        assert group.metrics()["gauges"][spans.AUTOSCALE_DECISION] == -1.0
        # a client's step-0 duplicate after both moves: served, not applied
        survivor = group.replicas[group.live_replicas()[0]]
        before = survivor.health()["step"]
        _, loss = group.split_step(*_batch(999), 0, moved[0])
        assert np.isfinite(loss) and survivor.health()["step"] == before
        names = {e["name"] for e in rec.events()}
        assert {spans.FL_SCALE_DECISION, spans.FL_SCALE_UP,
                spans.FL_SCALE_DOWN, spans.FL_HANDOFF_BEGIN,
                spans.FL_HANDOFF_COMMIT} <= names
        assert scaler.summary()["scale_ups"] == 1
        assert scaler.summary()["scale_downs"] == 1
        group.close()
    finally:
        obs_flight.disable()


def _down_scaler(group):
    """An autoscaler whose next window asks for a scale-down."""
    ring = _Ring()
    scaler = Autoscaler(group, _server, AutoscalePolicy(
        min_replicas=1, max_replicas=2, hysteresis_up=1,
        hysteresis_down=1, cooldown_up_s=0.0, cooldown_down_s=0.0,
        clock=_Clock()), ring, coalesce_max=4, slo_ms=10.0)
    ring.push(counters={}, gauges={}, percentiles={})
    return scaler


@pytest.mark.parametrize("fault", ["refused", "past_the_fence"])
def test_a_scale_down_fault_past_the_fence_is_not_a_refusal(fault,
                                                            monkeypatch):
    group = ReplicaGroup([_server(0), _server(1)])
    scaler = _down_scaler(group)

    def remove_replica(idx):
        if fault == "refused":
            raise ScaleRefused(f"replica {idx} is mid-handoff")
        raise RuntimeError("the capture failed")
    monkeypatch.setattr(group, "remove_replica", remove_replica)
    if fault == "refused":
        d = scaler.maybe_scale()
        assert d.direction == "down" and not d.executed
        assert "blocked: replica" in d.reason
    else:
        with pytest.raises(RuntimeError, match="capture failed"):
            scaler.maybe_scale()
    assert scaler.scale_downs == 0
    group.close()


def test_the_pump_counts_the_faults_it_survives():
    group = ReplicaGroup([_server(0), _server(1)])
    scaler = _down_scaler(group)
    faults = []

    def maybe_scale():
        faults.append(1)
        raise RuntimeError("scale event failed")
    scaler.maybe_scale = maybe_scale
    scaler.start(0.05)
    deadline = time.monotonic() + 10.0
    while len(faults) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    scaler.close()
    block = scaler.summary()
    assert block["pump_errors"] == len(faults) >= 2
    assert block["step_hook_errors"] == 0
    assert block["last_error"] == "RuntimeError: scale event failed"
    group.close()
