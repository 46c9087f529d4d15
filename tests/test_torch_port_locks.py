"""The port's ``obs.locks`` seam and lock watchdog (counterpart of the
watchdog cases of tests/test_analysis.py), on the CPU.

- The seam: ``install_checker``/``checker_installed``; with no checker
  ``make_lock``/``make_event``/``make_condition``/``make_thread`` return
  plain ``threading`` primitives (an ``InstrumentedLock`` under
  ``SLT_LOCK_DEBUG=1``), with one they return the checker's.
- The seven runtime sites that built raw primitives now go through it
  (``AdmissionController._lock``, ``RequestCoalescer._cond`` and its
  thread, ``FleetHarness._cond`` and its workers, ``_GroupD2H._lock``,
  ``FedAvgAggregator._cond``) and ``ServerRuntime._d2h_chan`` is new: each
  instrumented under ``SLT_LOCK_DEBUG=1`` with JAX's name and
  reentrancy, and plain without it (JAX's
  ``test_make_lock_on_instruments_runtime_components``, held on the
  port's components).
- The watchdog itself: an inversion is reported once, hold budgets, a
  reentrant acquire, ``threading.Condition`` over an instrumented lock.
- The CNN loss series is bit-identical with the watchdog on and off
  (JAX's ``test_watchdog_loss_series_bit_identical``), and so is
  ``chip_smoke.py`` phase 32 (c)'s coalesced four-client round, whose
  instrumented locks it names; the port's concurrency suites report no
  inversion under the watchdog.
- ``d2h_single_channel`` serialises the synthetic transfers (JAX's
  tests/test_sharded_server.py case) and ``_GroupD2H`` pays the delay.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from split_learning_tpu_torch.obs import locks, spans
from split_learning_tpu_torch.obs.metrics import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RLOCK = type(threading.RLock())
_LOCK = type(threading.Lock())


@pytest.fixture()
def debug_on(monkeypatch):
    monkeypatch.setenv("SLT_LOCK_DEBUG", "1")


@pytest.fixture()
def debug_off(monkeypatch):
    monkeypatch.delenv("SLT_LOCK_DEBUG", raising=False)


def _server(**kw):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.utils.config import Config
    cfg = Config(mode=kw.pop("mode", "split"), batch_size=4, num_clients=1)
    return ServerRuntime(get_plan(mode=cfg.mode), cfg,
                         torch.Generator().manual_seed(0), device="cpu", **kw)


def _fleet():
    from split_learning_tpu_torch.runtime.fleet import (
        FleetConfig, FleetHarness)
    from split_learning_tpu_torch.transport.base import TransportStats

    class _Echo:
        def __init__(self):
            self.stats = TransportStats()

        def split_step(self, acts, labels, step, client_id):
            return acts, 0.25

    cfg = FleetConfig(n_clients=2, tenants=1, steps_per_client=2, workers=2,
                      batch=1, rate_hz=500.0, seed=3, trace=False)
    return FleetHarness(cfg, lambda cid: _Echo())


def _group_d2h():
    from split_learning_tpu_torch.runtime.server import _GroupD2H
    return _GroupD2H(torch.zeros(4, 3), torch.arange(4.0), 4)


def _sites():
    """name -> (builder, the lock of the built object, reentrant)."""
    from split_learning_tpu_torch.runtime.admission import (
        AdmissionController)
    from split_learning_tpu_torch.runtime.coalesce import RequestCoalescer
    from split_learning_tpu_torch.runtime.server import FedAvgAggregator

    def coalescer():
        co = RequestCoalescer(lambda group, reason: None, max_group=2,
                              window_s=0.0)
        co.close()
        return co

    return {
        "AdmissionController._lock": (
            lambda: AdmissionController(tenants=1, quota=1.0),
            lambda o: o._lock, True),
        "RequestCoalescer._cond": (coalescer, lambda o: o._cond._lock,
                                   True),
        "FleetHarness._cond": (_fleet, lambda o: o._cond._lock, True),
        "_GroupD2H._lock": (_group_d2h, lambda o: o._lock, False),
        "FedAvgAggregator._cond": (lambda: FedAvgAggregator(2),
                                   lambda o: o._cond._lock, True),
        "ServerRuntime._d2h_chan": (_server, lambda o: o._d2h_chan_lock,
                                    False),
    }


SITES = sorted(_sites())


@pytest.mark.parametrize("name", SITES)
def test_site_is_instrumented_under_lock_debug(debug_on, name):
    build, lock_of, reentrant = _sites()[name]
    obj = build()
    lk = lock_of(obj)
    assert isinstance(lk, locks.InstrumentedLock)
    assert lk.name == name
    assert isinstance(lk._inner, _RLOCK if reentrant else _LOCK)
    if hasattr(obj, "close") and name == "ServerRuntime._d2h_chan":
        obj.close()


@pytest.mark.parametrize("name", SITES)
def test_site_is_plain_without_lock_debug(debug_off, name):
    build, lock_of, reentrant = _sites()[name]
    obj = build()
    assert isinstance(lock_of(obj), _RLOCK if reentrant else _LOCK)
    if name == "ServerRuntime._d2h_chan":
        obj.close()


class _FakeChecker:
    """Records what the seam asks a checker for."""

    def __init__(self):
        self.made = []

    def lock(self, name, reentrant=True):
        self.made.append(("lock", name))
        return threading.RLock() if reentrant else threading.Lock()

    def event(self, name):
        self.made.append(("event", name))
        return threading.Event()

    def condition(self, name):
        self.made.append(("condition", name))
        return threading.Condition()

    def thread(self, target, name, daemon=True):
        self.made.append(("thread", name))
        return threading.Thread(target=target, name=name, daemon=daemon)


@pytest.fixture()
def checker():
    fake = _FakeChecker()
    prev = locks.install_checker(fake)
    try:
        yield fake
    finally:
        assert locks.install_checker(prev) is fake


def test_install_checker_returns_the_previous_factory():
    assert not locks.checker_installed()
    fake = _FakeChecker()
    assert locks.install_checker(fake) is None
    try:
        assert locks.checker_installed()
        other = _FakeChecker()
        assert locks.install_checker(other) is fake
        assert locks.install_checker(fake) is other
    finally:
        locks.install_checker(None)
    assert not locks.checker_installed()


def test_seam_returns_plain_primitives_without_a_checker(debug_off):
    assert isinstance(locks.make_lock("x"), _RLOCK)
    assert isinstance(locks.make_lock("x", reentrant=False), _LOCK)
    assert isinstance(locks.make_event("e"), threading.Event)
    cond = locks.make_condition("c")
    assert isinstance(cond, threading.Condition)
    assert isinstance(cond._lock, _RLOCK)
    th = locks.make_thread(lambda: None, name="t", daemon=True)
    assert isinstance(th, threading.Thread) and th.daemon
    assert th.name == "t"


def test_seam_condition_is_instrumented_under_lock_debug(debug_on):
    cond = locks.make_condition("c")
    assert isinstance(cond, threading.Condition)
    assert isinstance(cond._lock, locks.InstrumentedLock)
    assert isinstance(locks.make_event("e"), threading.Event)


def test_seam_asks_the_installed_checker(debug_on, checker):
    locks.make_lock("L")
    locks.make_event("E")
    locks.make_condition("C")
    locks.make_thread(lambda: None, name="T")
    assert checker.made == [("lock", "L"), ("event", "E"),
                            ("condition", "C"), ("thread", "T")]


def test_runtime_threads_go_through_the_seam(checker):
    """The coalescer's flusher and the fleet's workers are the checker's
    threads (spawn/join become yield points under slt-check)."""
    from split_learning_tpu_torch.runtime.coalesce import RequestCoalescer
    co = RequestCoalescer(lambda group, reason: None, max_group=2,
                          window_s=0.0)
    co.close()
    result = _fleet().run()
    assert result.counters["fleet_steps_total"] == 4.0
    made = set(checker.made)
    assert ("condition", "RequestCoalescer._cond") in made
    assert ("thread", "slt-coalescer") in made
    assert ("condition", "FleetHarness._cond") in made
    assert {("thread", "slt-fleet-0"), ("thread", "slt-fleet-1")} <= made


# --------------------------------------------------------------------- #
# the watchdog
# --------------------------------------------------------------------- #
def test_intentional_inversion_is_detected_once():
    g = locks.LockGraph()
    a = locks.InstrumentedLock("A", graph=g, budget_s=None)
    b = locks.InstrumentedLock("B", graph=g, budget_s=None)
    with a:
        with b:
            pass
    assert g.violations == []
    for _ in range(2):
        with b:
            with a:
                pass
    assert [v["kind"] for v in g.violations] == ["lock-order-inversion"]
    assert "A" in g.violations[0]["message"]


def test_hold_budget_violation():
    g = locks.LockGraph()
    h = locks.InstrumentedLock("H", graph=g, budget_s=0.001)
    with h:
        time.sleep(0.01)
    ok = locks.InstrumentedLock("OK", graph=g, budget_s=10.0)
    with ok:
        pass
    assert [v["kind"] for v in g.violations] == ["hold-budget"]


def test_reentrant_acquire_is_not_an_edge_and_hold_spans_outermost():
    g, reg = locks.LockGraph(), Registry()
    lk = locks.InstrumentedLock("R", graph=g, registry=reg, budget_s=None)
    with lk:
        with lk:
            assert lk.locked()
    assert g.violations == [] and g.edges == {}
    assert reg.snapshot()["histograms"][spans.LOCK_HOLD]["count"] == 1


def test_condition_interop_keeps_the_held_stack_truthful():
    g = locks.LockGraph()
    cv = threading.Condition(locks.InstrumentedLock("CV", graph=g,
                                                    budget_s=None))
    hits = []

    def waiter():
        with cv:
            while not hits:
                cv.wait(timeout=5.0)
            hits.append("woke")

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cv:
        hits.append("notified")
        cv.notify()
    th.join(timeout=5.0)
    assert not th.is_alive() and hits == ["notified", "woke"]
    assert g.violations == [] and locks._held_stack() == []


# --------------------------------------------------------------------- #
# the numerics do not move
# --------------------------------------------------------------------- #
def _series(monkeypatch, debug):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import SplitClientTrainer
    from split_learning_tpu_torch.transport import LocalTransport
    if debug:
        monkeypatch.setenv("SLT_LOCK_DEBUG", "1")
    else:
        monkeypatch.delenv("SLT_LOCK_DEBUG", raising=False)
    server = _server()
    assert isinstance(server._lock, locks.InstrumentedLock if debug
                      else _RLOCK)
    client = SplitClientTrainer(server.plan, server.cfg,
                                torch.Generator().manual_seed(1),
                                LocalTransport(server), device="cpu")
    rs = np.random.RandomState(7)
    try:
        return [client.train_step(
            rs.randn(4, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, 4).astype(np.int64), i) for i in range(3)]
    finally:
        server.close()


def test_watchdog_loss_series_bit_identical(monkeypatch):
    on = _series(monkeypatch, True)
    assert locks.default_graph().violations == []
    off = _series(monkeypatch, False)
    assert [float(v).hex() for v in on] == [float(v).hex() for v in off]


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_coalesced_round_bit_identical_and_named(monkeypatch):
    """chip_smoke.py phase 32 (c) at batch 8 on the CPU: the same groups
    every round, the same losses on and off, the three named locks
    instrumented, no violation, one group a round."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "BATCH", 8)
    monkeypatch.setenv("SLT_LOCK_DEBUG", "1")
    on = cs.watchdog_round("cpu", rounds=3)
    monkeypatch.delenv("SLT_LOCK_DEBUG")
    off = cs.watchdog_round("cpu", rounds=3)
    assert on["losses"] == off["losses"]
    assert all(np.isfinite(float.fromhex(v)) for r in on["losses"]
               for v in r)
    assert set(cs.WATCHDOG_LOCKS) <= set(on["locks"])
    assert "ServerRuntime._d2h_chan" in on["locks"]
    assert off["locks"] == [] and on["violations"] == []
    assert on["groups"] == off["groups"] == 3
    assert on["mean_occupancy"] == cs.MANY_CLIENTS


def test_concurrency_suites_report_no_inversion(monkeypatch):
    """Under the watchdog, a coalescing server with admission (continuous
    batching, four concurrent clients, a replayed duplicate), a 2BP
    server and the fleet harness record no lock-order inversion."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import SplitClientTrainer
    from split_learning_tpu_torch.transport import LocalTransport
    monkeypatch.setenv("SLT_LOCK_DEBUG", "1")
    graph = locks.default_graph()
    before = len(graph.violations)
    server = _server(coalesce_max=4, coalesce_window_ms=5.0,
                     batching="continuous", tenants=2, slo_ms=500.0)
    clients = [SplitClientTrainer(get_plan(), server.cfg,
                                  torch.Generator().manual_seed(i),
                                  LocalTransport(server), client_id=i,
                                  device="cpu") for i in range(4)]
    rs = np.random.RandomState(3)
    data = [(rs.randn(4, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, 4).astype(np.int64)) for _ in range(4)]
    errors = []

    def run(i):
        try:
            for s in range(3):
                clients[i].train_step(*data[i], step=s)
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    server.close()
    assert not errors, errors
    two_bp = _server(decouple_bwd=True, apply_lag=1)
    c = SplitClientTrainer(two_bp.plan, two_bp.cfg,
                           torch.Generator().manual_seed(5),
                           LocalTransport(two_bp), device="cpu")
    for s in range(3):
        c.train_step(*data[0], step=s)
    assert two_bp.params is two_bp.state.params[0]
    two_bp.flush_deferred()
    two_bp.close()
    assert _fleet().run().counters["fleet_steps_total"] == 4.0
    assert graph.violations[before:] == []


# --------------------------------------------------------------------- #
# the synthetic transfer cost
# --------------------------------------------------------------------- #
def test_d2h_single_channel_serializes_concurrent_transfers():
    delay = 0.05
    server = _server(d2h_delay_s=delay, d2h_single_channel=True)
    try:
        threads = [threading.Thread(target=server._sleep_d2h)
                   for _ in range(3)]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert time.monotonic() - t0 >= 3 * delay
        assert server._d2h_chan_free_at > 0.0
    finally:
        server.close()


def test_d2h_default_is_no_cost(monkeypatch):
    server = _server()
    try:
        assert server._d2h_delay_s == 0.0 and not server._d2h_single
        monkeypatch.setattr(time, "sleep", lambda s: pytest.fail("slept"))
        server._sleep_d2h()
        assert server._d2h_chan_free_at == 0.0
    finally:
        server.close()


def test_group_d2h_pays_the_synthetic_delay_once():
    from split_learning_tpu_torch.runtime.server import _GroupD2H
    calls = []
    pg = _GroupD2H(torch.ones(4, 3), torch.arange(4.0), 4,
                   sleep_d2h=lambda: calls.append(1))
    seg = pg.segment(0, 2)
    g, loss = seg()
    pg.segment(2, 2)()
    assert calls == [1]
    assert loss == float(np.float32(0.5))
    assert torch.equal(g, torch.ones(2, 3) * 2)
