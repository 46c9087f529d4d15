"""Admission control and continuous batching of the port against JAX's,
on the CPU (the cases of tests/test_admission.py, on the port).

- One scripted sequence of ``admit``/``complete`` under a virtual clock
  through JAX's and the port's ``AdmissionController``: every admission,
  refusal, ``retry_after_s``, deadline and counter equal (exact: both
  are the same float arithmetic in Python).
- The continuous batcher: EDF order, ties in arrival order, a lone
  request never waits on the window, ``close`` fails what is queued.
- ``Backpressure`` through the port's ``LocalTransport`` (the replay
  claim released for the retry), the skip policy, and the 429 with
  ``Retry-After`` over the port's HTTP server to JAX's ``HttpTransport``.
- A continuous single client is the serialized path within 1e-4.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.admission import (
    AdmissionController as JaxAdmission)
from split_learning_tpu.transport.base import Backpressure as JaxBackpressure
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    AdmissionController, ContinuousBatcher, RequestCoalescer, ServerRuntime,
    SplitClientTrainer)
from split_learning_tpu_torch.runtime.client import FailurePolicy
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.transport.base import Backpressure
from split_learning_tpu_torch.transport.http import SplitHTTPServer
from split_learning_tpu_torch.utils.config import Config

BATCH = 8
SAMPLE = np.zeros((BATCH, 28, 28, 1), np.float32)
SERIAL_TOL = 1e-4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _init(seed=0):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(seed), jnp.asarray(SAMPLE)))


def make_server(coalesce_max=1, window_ms=50.0, batching="window",
                tenants=1, quota=None, slo_ms=None):
    cfg = Config(mode="split", batch_size=BATCH, num_clients=64)
    plan = get_plan()
    server = ServerRuntime(plan, cfg, _init(0), coalesce_max=coalesce_max,
                           coalesce_window_ms=window_ms, batching=batching,
                           tenants=tenants, quota=quota, slo_ms=slo_ms,
                           device="cpu")
    return cfg, plan, server


def batch(seed, n=BATCH):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, (n,)).astype(np.int64))


def _cut(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(BATCH, 26, 26, 32).astype(np.float32),
            rs.randint(0, 10, (BATCH,)).astype(np.int64))


# --------------------------------------------------------------------- #
# the controller against JAX's, under a virtual clock
# --------------------------------------------------------------------- #

# (time step, op, client): a burst past the quota, a refill, both
# tenants, per-tenant SLOs, completes in between
SCRIPT = [(0.0, "admit", 0), (0.0, "admit", 0), (0.0, "admit", 0),
          (0.0, "admit", 1), (0.1, "admit", 2), (0.0, "complete", 0),
          (0.3, "admit", 0), (0.05, "admit", 0), (0.0, "admit", 1),
          (0.0, "admit", 1), (0.0, "admit", 3), (1.0, "complete", 1),
          (0.0, "admit", 1), (0.2, "admit", 0), (0.0, "complete", 2),
          (2.5, "admit", 0), (0.0, "admit", 0), (0.0, "admit", 0),
          (0.0, "admit", 0), (0.0, "complete", 0)]


def _replay(controller_cls, backpressure_cls):
    clock = FakeClock()
    ac = controller_cls(tenants=2, quota=[2.0, 4.0], burst=[2, 3],
                        slo_ms=[100.0, 250.0], clock=clock)
    out = []
    for dt, op, cid in SCRIPT:
        clock.advance(dt)
        if op == "complete":
            ac.complete(cid)
            out.append(("complete", cid))
            continue
        try:
            out.append(("admitted", cid, ac.admit(cid)))
        except backpressure_cls as exc:
            out.append(("refused", cid, exc.retry_after_s))
    return out, ac.counters(), ac.gauges(), ac.config()


def test_admission_decisions_equal_jax_under_a_virtual_clock():
    got = _replay(AdmissionController, Backpressure)
    want = _replay(JaxAdmission, JaxBackpressure)
    assert got == want
    kinds = [e[0] for e in got[0]]
    assert "refused" in kinds and "admitted" in kinds
    # refusals advise the time to the next token, deadlines carry the SLO
    refused = [e for e in got[0] if e[0] == "refused"]
    assert all(e[2] > 0 for e in refused)


def test_admission_rejects_bad_config():
    with pytest.raises(ValueError):
        AdmissionController(tenants=0)
    with pytest.raises(ValueError):
        AdmissionController(tenants=2, quota=[1.0])
    with pytest.raises(ValueError):
        AdmissionController(quota=0.0)
    with pytest.raises(ValueError):
        AdmissionController(quota=1.0, burst=0.5)


def test_token_bucket_refill_and_tenant_map():
    clock = FakeClock()
    ac = AdmissionController(tenants=2, quota=2.0, burst=2, clock=clock,
                             tenant_of=lambda cid: cid // 10)
    assert ac.tenant_of(13) == 1
    ac.admit(0)
    ac.admit(0)
    with pytest.raises(Backpressure) as exc:
        ac.admit(0)
    assert exc.value.retry_after_s == pytest.approx(0.5)
    ac.admit(10)  # the other tenant's bucket is full
    clock.advance(0.5)
    ac.admit(0)
    assert ac.counters()["admission_rejected_t0"] == 1.0
    assert ac.gauges()["admission_queue_depth_t0"] == 3.0


# --------------------------------------------------------------------- #
# the continuous batcher
# --------------------------------------------------------------------- #

def _resolve_all(group, reason):
    for r in group:
        r.result = (r.acts, float(len(group)))
        r.done.set()


def _wait_queued(coalescer, n, timeout=5.0):
    """Until ``n`` requests wait in the queue (a loaded machine may start
    a submitting thread late)."""
    until = time.time() + timeout
    while time.time() < until:
        with coalescer._cond:
            if len(coalescer._queue) >= n:
                return
        time.sleep(0.005)
    raise AssertionError(f"fewer than {n} requests queued")


def test_continuous_lone_submit_ignores_window():
    groups = []

    def dispatch(group, reason):
        groups.append((len(group), reason))
        _resolve_all(group, reason)

    cb = ContinuousBatcher(dispatch, max_group=4, window_s=3600.0)
    try:
        t0 = time.perf_counter()
        cb.submit(np.zeros((2, 3), np.float32), np.zeros((2,), np.int64),
                  0, 0)
        assert time.perf_counter() - t0 < 5.0
        assert groups == [(1, "continuous")]
    finally:
        cb.close()


def test_continuous_edf_order_and_adaptive_group():
    release, entered = threading.Event(), threading.Event()
    groups = []

    def dispatch(group, reason):
        groups.append([r.client_id for r in group])
        entered.set()
        release.wait(5.0)
        _resolve_all(group, reason)

    cb = ContinuousBatcher(dispatch, max_group=4)
    try:
        acts = np.zeros((1, 2), np.float32)
        labels = np.zeros((1,), np.int64)

        def submit(cid, deadline):
            return threading.Thread(
                target=cb.submit, args=(acts, labels, 0, cid),
                kwargs={"deadline": deadline}, daemon=True)

        threads = [submit(0, None)]
        threads[0].start()
        assert entered.wait(5.0)  # the first request holds the flusher
        for cid, dl in ((1, None), (2, 9.0), (3, 1.0)):
            threads.append(submit(cid, dl))
            threads[-1].start()
            _wait_queued(cb, len(threads) - 1)
        release.set()
        for th in threads:
            th.join(timeout=5.0)
        assert groups[0] == [0]
        assert groups[1] == [3, 2, 1]
    finally:
        cb.close()


def test_continuous_edf_equal_deadlines_pick_up_in_arrival_order():
    release, entered = threading.Event(), threading.Event()
    groups = []

    def dispatch(group, reason):
        groups.append([r.client_id for r in group])
        entered.set()
        release.wait(5.0)
        _resolve_all(group, reason)

    cb = ContinuousBatcher(dispatch, max_group=4)
    try:
        acts = np.zeros((1, 2), np.float32)
        labels = np.zeros((1,), np.int64)
        first = threading.Thread(target=cb.submit,
                                 args=(acts, labels, 0, 0), daemon=True)
        first.start()
        assert entered.wait(5.0)  # the first request holds the flusher
        threads = [first]
        for cid in (7, 5, 6):
            th = threading.Thread(target=cb.submit,
                                  args=(acts, labels, 0, cid),
                                  kwargs={"deadline": 4.0}, daemon=True)
            threads.append(th)
            th.start()
            _wait_queued(cb, len(threads) - 1)  # before the next one
        release.set()
        for th in threads:
            th.join(timeout=5.0)
        assert groups[0] == [0]
        assert groups[1] == [7, 5, 6]
    finally:
        cb.close()


def test_coalescer_close_fails_queued_requests():
    entered = threading.Event()
    release = threading.Event()

    def dispatch(group, reason):
        entered.set()
        release.wait(30.0)
        _resolve_all(group, reason)

    rc = RequestCoalescer(dispatch, max_group=2, window_s=0.05)
    acts = np.zeros((1, 2), np.float32)
    labels = np.zeros((1,), np.int64)
    t0 = threading.Thread(target=rc.submit, args=(acts, labels, 0, 0),
                          daemon=True)
    t0.start()
    assert entered.wait(5.0)
    err = {}

    def second():
        try:
            rc.submit(acts, labels, 0, 1)
        except RuntimeError as exc:
            err["exc"] = exc

    t1 = threading.Thread(target=second, daemon=True)
    t1.start()
    _wait_queued(rc, 1)
    t_close = time.perf_counter()
    rc.close(timeout=0.5)
    assert time.perf_counter() - t_close < 5.0
    t1.join(timeout=5.0)
    assert not t1.is_alive()
    assert "closed before dispatch" in str(err["exc"])
    release.set()
    t0.join(timeout=5.0)
    assert not t0.is_alive()


# --------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------- #

def test_continuous_single_client_matches_serialized():
    losses = {}
    for mode, cmax in (("serialized", 1), ("continuous", 4)):
        cfg, plan, server = make_server(
            coalesce_max=cmax,
            batching="continuous" if cmax > 1 else "window")
        try:
            client = SplitClientTrainer(plan, cfg, _init(1),
                                        LocalTransport(server), device="cpu")
            losses[mode] = [client.train_step(*batch(s), s)
                            for s in range(6)]
        finally:
            server.close()
    np.testing.assert_allclose(losses["continuous"], losses["serialized"],
                               rtol=0, atol=SERIAL_TOL)


def test_local_transport_surfaces_backpressure():
    """An over-quota step raises ``Backpressure`` through the local wire
    with a positive ``retry_after_s``, and releases its replay claim, so
    the same step trains once the bucket refills."""
    cfg, plan, server = make_server(tenants=1, quota=0.001)
    try:
        transport = LocalTransport(server)
        acts, labels = _cut()
        transport.split_step(acts, labels, 0)          # the burst token
        with pytest.raises(Backpressure) as exc_info:
            transport.split_step(acts, labels, 1)
        assert exc_info.value.retry_after_s > 0
        adm = server.health()["admission"]
        assert adm["admission_rejected"] == 1
        assert adm["admission_queue_depth_t0"] == 0
        server._admission._tokens[0] = 1.0
        g, loss = transport.split_step(acts, labels, 1)
        assert np.isfinite(loss)
        assert server.health()["admission"]["admission_admitted"] == 2
    finally:
        server.close()


def test_client_skip_policy_drops_on_backpressure():
    cfg, plan, server = make_server(tenants=1, quota=0.001)
    try:
        client = SplitClientTrainer(plan, cfg, _init(1),
                                    LocalTransport(server),
                                    failure_policy=FailurePolicy.SKIP,
                                    device="cpu")
        assert client.train_step(*batch(0), 0) is not None
        assert client.train_step(*batch(1), 1) is None
        assert client.dropped_batches == 1
    finally:
        server.close()


def test_http_429_retry_after_round_trip_to_a_jax_client():
    """The port's HTTP server maps ``Backpressure`` to 429 with
    ``Retry-After``; JAX's ``HttpTransport`` maps it back to its own
    ``Backpressure``."""
    cfg, plan, server = make_server(tenants=1, quota=0.001)
    http = SplitHTTPServer(server).start()
    transport = JaxHttp(http.url)
    try:
        acts, labels = _cut()
        g, loss = transport.split_step(acts, labels, 0)
        assert np.isfinite(loss) and g.shape == acts.shape
        with pytest.raises(JaxBackpressure) as exc_info:
            transport.split_step(acts, labels, 1)
        assert exc_info.value.retry_after_s > 0
        assert server.health()["admission"]["admission_rejected"] == 1
    finally:
        transport.close()
        http.stop()
        server.close()


def test_server_health_reports_admission_and_batching():
    cfg, plan, server = make_server(coalesce_max=4, batching="continuous",
                                    tenants=2, quota=50.0, slo_ms=250.0)
    try:
        h = server.health()
        assert h["coalescing"]["batching"] == "continuous"
        adm = h["admission"]
        assert adm["tenants"] == 2
        assert adm["quota"] == [50.0, 50.0]
        assert adm["slo_ms"] == [250.0, 250.0]
        m = server.metrics()
        assert "admission_admitted" in m["counters"]
        assert "admission_queue_depth_t0" in m["gauges"]
        assert "coalesce_groups_flushed" not in m["counters"]
    finally:
        server.close()


def test_server_rejects_continuous_without_coalescing():
    with pytest.raises(ValueError):
        make_server(coalesce_max=1, batching="continuous")
    with pytest.raises(ValueError):
        make_server(batching="sometimes")
