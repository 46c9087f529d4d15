"""Request coalescing of the port (``runtime/coalesce.py`` and
``ServerRuntime._dispatch_group``) against JAX's, on the CPU.

- The queue half: the cases of tests/test_coalesce.py that drive JAX's
  coalescer alone, on the port's (host code, no math).
- Group parity without threads: ``_dispatch_group`` called directly on
  a JAX server and on the port's, one flax init carried across, with
  groups of sizes [8, 8, 4], then [8], then [4, 4, 4, 4]. Each member's
  cut gradient and loss within 1e-5 of JAX's, and the server parameters
  after the three groups within 1e-5, for the split CNN and the
  transformer classifier. JAX pads each group to a power of two with
  zero-weight rows; the port runs the real rows only, whose mean is the
  same objective.
- A group of one is the serialized step within 1e-4 (the sequential
  client against a coalescing server); ``coalesce_max=1`` builds no
  coalescer and is the serialized path bit for bit.
- Threads: barrier-released clients coalesce (occupancy >= 2), a
  replayed step is served from the cache without poisoning its group,
  a stale step still 409s, HTTP handler threads coalesce, a failure in
  the flusher reaches every waiter as its error (no fallback).
- The LM refusal; one mixed pair (a JAX client through JAX's
  ``LocalTransport`` against the port's coalescing server, held to the
  JAX pair within 1e-4).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.runtime.coalesce import (
    CoalesceRequest as JaxRequest)
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    MultiClientSplitRunner, ProtocolError, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.runtime.coalesce import (
    CoalesceRequest, ContinuousBatcher, RequestCoalescer, pow2_bucket)
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.transport.base import TransportStats
from split_learning_tpu_torch.utils.config import Config

BATCH = 8
SAMPLE = np.zeros((BATCH, 28, 28, 1), np.float32)
GROUP_TOL = 1e-5   # a group against JAX's group
SERIAL_TOL = 1e-4  # a group of one against the serialized step


def batch(seed, n=BATCH):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, (n,))
    x = rs.randn(n, 28, 28, 1).astype(np.float32)
    return x, y.astype(np.int64)


def _init(seed=0):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(seed), jnp.asarray(SAMPLE)))


def make_server(coalesce_max=1, window_ms=50.0, n_clients=1, strict=True,
                **kw):
    cfg = Config(mode="split", batch_size=BATCH, num_clients=n_clients)
    plan = get_plan()
    server = ServerRuntime(plan, cfg, _init(0), strict_steps=strict,
                           coalesce_max=coalesce_max,
                           coalesce_window_ms=window_ms, device="cpu", **kw)
    return cfg, plan, server


def _client(plan, cfg, server, seed=1, client_id=0):
    return SplitClientTrainer(plan, cfg, _init(seed), LocalTransport(server),
                              client_id=client_id, device="cpu")


# --------------------------------------------------------------------- #
# the queue half (host code)
# --------------------------------------------------------------------- #

def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (1, 2, 3, 5, 8, 9, 33)] == \
        [1, 2, 4, 8, 8, 16, 64]
    with pytest.raises(ValueError):
        pow2_bucket(0)


def _resolve_all(group, reason):
    for r in group:
        r.result = (r.acts, float(len(group)))
        r.done.set()


def test_coalescer_full_and_window_flush_reasons():
    groups = []

    def dispatch(group, reason):
        groups.append((len(group), reason))
        _resolve_all(group, reason)

    # a long window: the second request must join the first on a loaded
    # machine; the lone request after them waits it out
    c = RequestCoalescer(dispatch, max_group=2, window_s=1.0)
    try:
        a = batch(0)
        t = threading.Thread(target=c.submit, args=(a[0], a[1], 0, 0))
        t.start()
        c.submit(a[0], a[1], 0, 1)
        t.join(timeout=10)
        _, n = c.submit(a[0], a[1], 1, 0)
        assert n == 1.0
        assert sorted(groups) == [(1, "window"), (2, "full")]
        counters = c.counters()
        assert counters["groups_flushed"] == 2
        assert counters["requests_coalesced"] == 3
        assert counters["flush_full"] == 1
        assert counters["flush_window"] == 1
        assert counters["mean_occupancy"] == pytest.approx(1.5)
    finally:
        c.close()


def test_coalescer_mixed_shapes_never_share_a_group():
    seen = []

    def dispatch(group, reason):
        seen.append({r.shape_key() for r in group})
        _resolve_all(group, reason)

    c = RequestCoalescer(dispatch, max_group=4, window_s=0.3)
    try:
        a, b = batch(0), batch(1, n=4)
        threads = [
            threading.Thread(target=c.submit, args=(a[0], a[1], 0, 0)),
            threading.Thread(target=c.submit,
                             args=(b[0].astype(np.float64), b[1], 0, 1)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert all(len(keys) == 1 for keys in seen)
        assert len(seen) == 2
    finally:
        c.close()


def test_shape_key_is_the_same_for_numpy_and_tensors():
    x, y = batch(0)
    a = CoalesceRequest(x, y, 0, 0)
    b = CoalesceRequest(torch.as_tensor(x), torch.as_tensor(y), 0, 1)
    assert a.shape_key() == b.shape_key()
    # JAX's key of the same arrays names the same tail shapes
    assert JaxRequest(x, y, 0, 0).shape_key()[0] == a.shape_key()[0]


def test_coalescer_dispatch_error_reaches_waiter_and_thread_survives():
    calls = {"n": 0}

    def dispatch(group, reason):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        _resolve_all(group, reason)

    c = RequestCoalescer(dispatch, max_group=2, window_s=0.01)
    try:
        a = batch(0)
        with pytest.raises(RuntimeError, match="boom"):
            c.submit(a[0], a[1], 0, 0)
        _, n = c.submit(a[0], a[1], 1, 0)
        assert n == 1.0
    finally:
        c.close()


def test_coalescer_config_and_close_contract():
    with pytest.raises(ValueError):
        RequestCoalescer(_resolve_all, max_group=1, window_s=0.01)
    with pytest.raises(ValueError):
        RequestCoalescer(_resolve_all, max_group=2, window_s=-1.0)
    with pytest.raises(ValueError):
        RequestCoalescer(_resolve_all, max_group=2, window_s=0.0,
                         mode="sometimes")
    c = RequestCoalescer(_resolve_all, max_group=2, window_s=0.01)
    c.close()
    c.close()  # idempotent
    a = batch(0)
    with pytest.raises(RuntimeError):
        c.submit(a[0], a[1], 0, 0)
    cb = ContinuousBatcher(_resolve_all, max_group=2)
    assert cb.mode == "continuous"
    cb.close()


def test_transport_stats_counters_merge_and_summary():
    a, b = TransportStats(), TransportStats()
    a.incr("groups_flushed")
    a.incr("requests_coalesced", 3)
    b.incr("groups_flushed", 2)
    m = TransportStats.merged([a, b])
    assert m.counters["groups_flushed"] == 3
    assert m.counters["requests_coalesced"] == 3
    assert a.summary()["groups_flushed"] == 1


# --------------------------------------------------------------------- #
# group parity with JAX, no threads
# --------------------------------------------------------------------- #

TINY_TF = dict(vocab=32, d_model=16, num_heads=2, client_depth=1,
               server_depth=1, max_len=16, attn="full")
GROUPS = ([8, 8, 4], [8], [4, 4, 4, 4])


def _family(model):
    """(JAX plan, port plan, the cut's tail shape, classes)."""
    if model == "split_cnn":
        return (jax_get_plan(mode="split"), get_plan(),
                (26, 26, 32), 10)
    return (jax_get_plan(model="transformer", **TINY_TF),
            get_plan(model="transformer", **TINY_TF), (8, 16), 2)


def _groups(tail, classes):
    rs = np.random.RandomState(7)
    out = []
    for g, sizes in enumerate(GROUPS):
        out.append([(rs.randn(b, *tail).astype(np.float32),
                     rs.randint(0, classes, (b,)).astype(np.int64),
                     g, i) for i, b in enumerate(sizes)])
    return out


def _run_groups(server, groups, make_request, result_of):
    replies = []
    for group in groups:
        reqs = [make_request(x, y, step, cid) for x, y, step, cid in group]
        server._dispatch_group(reqs, "full")
        for r in reqs:
            assert r.error is None, r.error
            res = r.result() if callable(r.result) else r.result
            replies.append(result_of(res))
    return replies


@pytest.fixture(scope="module", params=["split_cnn", "transformer"])
def group_case(request):
    """JAX's replies and server parameters after the three groups."""
    model = request.param
    jplan, plan, tail, classes = _family(model)
    sample = (jnp.zeros((BATCH, 28, 28, 1)) if model == "split_cnn"
              else jnp.zeros((2, 8), jnp.int32))
    init = jplan.init(jax.random.PRNGKey(3), sample)
    jcfg = JaxConfig(mode="split", model=model, batch_size=BATCH, lr=0.05)
    jserver = JaxServer(jplan, jcfg, jax.random.PRNGKey(3), sample,
                        coalesce_max=4)
    groups = _groups(tail, classes)
    want = _run_groups(
        jserver, groups, lambda x, y, s, c: JaxRequest(x, y, s, c),
        lambda res: (np.asarray(res[0]), res[1]))
    want_params = params_from_jax(
        [init[0], jserver.state.params])[1]
    jserver.close()
    return model, plan, init, groups, want, want_params


def test_dispatch_group_matches_jax(group_case):
    model, plan, init, groups, want, want_params = group_case
    cfg = Config(mode="split", model=model, batch_size=BATCH, lr=0.05)
    server = ServerRuntime(plan, cfg, params_from_jax(init),
                           coalesce_max=4, device="cpu")
    try:
        got = _run_groups(
            server, groups,
            lambda x, y, s, c: CoalesceRequest(torch.as_tensor(x),
                                               torch.as_tensor(y), s, c),
            lambda res: (res[0].numpy(), res[1]))
        assert len(got) == len(want) == sum(map(len, GROUPS))
        for (g, loss), (jg, jloss) in zip(got, want):
            np.testing.assert_allclose(g, jg, rtol=0, atol=GROUP_TOL)
            assert abs(loss - jloss) <= GROUP_TOL
        for k, v in server.params.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(want_params[k]), rtol=0,
                                       atol=GROUP_TOL, err_msg=k)
        c = server.health()["coalescing"]
        # the pow2 signatures JAX compiles: 32, 8 and 16 rows
        assert c["compile_count"] == 3
    finally:
        server.close()


# --------------------------------------------------------------------- #
# the serialized path and groups of one
# --------------------------------------------------------------------- #

def test_coalesce_max_1_is_the_serialized_path_bit_for_bit():
    losses = {}
    for name, kwargs in [("default", {}), ("max1", {"coalesce_max": 1})]:
        cfg, plan, server = make_server(**kwargs)
        if name == "max1":
            assert server._coalescer is None
        client = _client(plan, cfg, server)
        losses[name] = [client.train_step(*batch(s), step=s)
                        for s in range(4)]
        server.close()
    assert losses["default"] == losses["max1"]


@pytest.mark.parametrize("batching", ["window", "continuous"])
def test_groups_of_one_match_serialized(batching):
    """A sequential client against a coalescing server forms groups of
    one only; each is the serialized step within 1e-4."""
    series = {}
    for name, cmax in [("serialized", 1), ("coalesced", 4)]:
        cfg, plan, server = make_server(
            coalesce_max=cmax, window_ms=5.0,
            batching=batching if cmax > 1 else "window")
        client = _client(plan, cfg, server)
        series[name] = [client.train_step(*batch(s), step=s)
                        for s in range(6)]
        # close() joins the flusher: a group's counters are counted after
        # its waiters are released
        server.close()
        if cmax > 1:
            c = server.health()["coalescing"]
            assert c["groups_flushed"] == 6
            assert c[f"flush_{batching}"] == 6
            assert c["mean_occupancy"] == pytest.approx(1.0)
    np.testing.assert_allclose(series["coalesced"], series["serialized"],
                               rtol=0, atol=SERIAL_TOL)


# --------------------------------------------------------------------- #
# threads
# --------------------------------------------------------------------- #

def test_concurrent_clients_form_groups_and_health_reports_counters():
    n_clients, n_steps = 4, 5
    cfg, plan, server = make_server(coalesce_max=n_clients, window_ms=500.0,
                                    n_clients=n_clients)
    clients = [_client(plan, cfg, server, seed=10 + i, client_id=i)
               for i in range(n_clients)]
    barrier = threading.Barrier(n_clients)
    errors = []

    def run(i):
        try:
            data = batch(100 + i)
            for s in range(n_steps):
                barrier.wait(timeout=60)
                loss = clients[i].train_step(*data, step=s)
                assert np.isfinite(loss)
        except Exception as exc:  # surfaced on the main thread
            errors.append((i, exc))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert server._last_step == {i: n_steps - 1 for i in range(n_clients)}
    server.close()  # joins the flusher: its counters are final
    c = server.health()["coalescing"]
    assert c["coalesce_max"] == n_clients
    assert c["requests_coalesced"] == n_clients * n_steps
    assert c["mean_occupancy"] >= 2.0
    assert c["groups_flushed"] == \
        c.get("flush_full", 0) + c.get("flush_window", 0)


def test_replayed_step_served_from_cache_without_poisoning_the_group():
    cfg, plan, server = make_server(coalesce_max=2, window_ms=500.0,
                                    n_clients=2)
    clients = [_client(plan, cfg, server, seed=i, client_id=i)
               for i in range(2)]
    orig = clients[0].train_step(*batch(0), step=0)
    barrier = threading.Barrier(2)
    out = {}

    def replay():
        barrier.wait(timeout=30)
        out["replay"] = clients[0].train_step(*batch(1), step=0)

    def fresh():
        barrier.wait(timeout=30)
        out["fresh"] = clients[1].train_step(*batch(2), step=0)

    threads = [threading.Thread(target=replay),
               threading.Thread(target=fresh)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert out.get("replay") == orig
    assert server.replay.hits >= 1
    assert np.isfinite(out.get("fresh"))
    assert server._last_step == {0: 0, 1: 0}
    server.close()


def test_stale_step_below_replay_window_still_409s_in_group():
    cfg, plan, server = make_server(coalesce_max=2, window_ms=2.0)
    client = _client(plan, cfg, server)
    for s in range(1, server.replay.window + 3):
        client.train_step(*batch(s), step=s)
    with pytest.raises(ProtocolError):
        client.train_step(*batch(0), step=0)
    server.close()


def test_out_of_order_steps_with_strict_steps_false():
    cfg, plan, server = make_server(coalesce_max=4, window_ms=5.0,
                                    strict=False)
    client = _client(plan, cfg, server)
    for s in [5, 2, 7, 3]:
        assert np.isfinite(client.train_step(*batch(s), step=s))
    assert server._last_step == {0: 7}
    server.close()


def test_concurrent_runner_against_coalescing_server():
    n_clients = 4
    cfg, plan, server = make_server(coalesce_max=n_clients, window_ms=500.0,
                                    n_clients=n_clients)
    runner = MultiClientSplitRunner(
        plan, cfg, lambda i: _init(10 + i), lambda i: LocalTransport(server),
        num_clients=n_clients, concurrent=True, device="cpu")
    data = [batch(10 + i) for i in range(n_clients)]
    for _ in range(3):
        losses = runner.train_round(data)
        assert all(np.isfinite(loss) for loss in losses)
    assert server._last_step == {i: 2 for i in range(n_clients)}
    runner.close()
    server.close()
    assert server.health()["coalescing"]["mean_occupancy"] > 1.0


def test_http_concurrent_handler_threads_coalesce():
    from split_learning_tpu_torch.transport.http import (
        HttpTransport, SplitHTTPServer)
    n_clients = 2
    cfg, plan, runtime = make_server(coalesce_max=n_clients,
                                     window_ms=500.0, n_clients=n_clients)
    server = SplitHTTPServer(runtime).start()
    transports = [HttpTransport(server.url) for _ in range(n_clients)]
    try:
        clients = [SplitClientTrainer(plan, cfg, _init(i), transports[i],
                                      client_id=i, device="cpu")
                   for i in range(n_clients)]
        barrier = threading.Barrier(n_clients)
        errors, losses = [], {}

        def run(i):
            try:
                data = batch(20 + i)
                for s in range(2):
                    barrier.wait(timeout=60)
                    losses[(i, s)] = clients[i].train_step(*data, step=s)
            except Exception as exc:
                errors.append((i, exc))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(np.isfinite(loss) for loss in losses.values())
        # /health over the wire has the coalescing block
        assert transports[0].health()["coalescing"]["coalesce_max"] == 2
    finally:
        for tr in transports:
            tr.close()
        server.stop()
        runtime.close()
    c = runtime.health()["coalescing"]  # the flusher joined: final
    assert c["requests_coalesced"] == n_clients * 2
    assert c["mean_occupancy"] >= 1.0


def test_a_failed_group_reaches_every_waiter_as_its_error(monkeypatch):
    """A launch that fails in the flusher fails the group's clients with
    that error (no fallback to another path); the next group trains."""
    cfg, plan, server = make_server(coalesce_max=2, window_ms=300.0,
                                    n_clients=2)
    import split_learning_tpu_torch.runtime.server as srv_mod
    real = srv_mod.cross_entropy_rows
    armed = {"on": True}

    def failing(*a, **k):
        if armed["on"]:
            raise RuntimeError("kernel launch failed")
        return real(*a, **k)
    monkeypatch.setattr(srv_mod, "cross_entropy_rows", failing)
    transports = [LocalTransport(server) for _ in range(2)]
    errors = {}
    barrier = threading.Barrier(2)
    x, y = batch(0)
    acts = np.random.RandomState(0).randn(BATCH, 26, 26, 32).astype(
        np.float32)

    def run(i):
        barrier.wait(timeout=30)
        try:
            transports[i].split_step(acts, y, 0, i)
        except Exception as exc:
            errors[i] = exc

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(errors) == [0, 1]
    assert all("kernel launch failed" in str(e) for e in errors.values())
    assert server.state.step == 0
    armed["on"] = False
    # the claim was released: the same steps train now
    g, loss = transports[0].split_step(acts, y, 0, 0)
    assert np.isfinite(loss) and g.shape == acts.shape
    server.close()


# --------------------------------------------------------------------- #
# refusals and the mixed pair
# --------------------------------------------------------------------- #

def test_coalesce_requires_split_mode_and_a_classifier():
    with pytest.raises(ValueError, match="split-mode only"):
        ServerRuntime(get_plan(mode="federated"),
                      Config(mode="federated", num_clients=2),
                      torch.Generator().manual_seed(0), coalesce_max=2,
                      device="cpu")
    lm = get_plan(model="transformer_lm", **TINY_TF)
    with pytest.raises(ValueError, match="classifier plans only") as exc:
        ServerRuntime(lm, Config(model="transformer_lm"),
                      torch.Generator().manual_seed(0), coalesce_max=2,
                      device="cpu")
    assert "[B, T]" in str(exc.value)
    # the LM still serves serialized
    ServerRuntime(lm, Config(model="transformer_lm"),
                  torch.Generator().manual_seed(0), device="cpu").close()


def test_jax_client_against_the_port_coalescing_server():
    """JAX's client through JAX's ``LocalTransport`` (numpy in, numpy
    out) against the port's coalescing server (groups of one) tracks the
    JAX pair with JAX's coalescing server within 1e-4."""
    jcfg = JaxConfig(mode="split", batch_size=BATCH)
    jplan = jax_get_plan(mode="split")
    series = {}
    for name in ("jax", "port"):
        if name == "jax":
            server = JaxServer(jplan, jcfg, jax.random.PRNGKey(0), SAMPLE,
                               coalesce_max=4, coalesce_window_ms=5.0)
        else:
            _, _, server = make_server(coalesce_max=4, window_ms=5.0)
        client = JaxClient(jplan, jcfg, jax.random.PRNGKey(1),
                           JaxLocal(server))
        series[name] = [client.train_step(*batch(s), s) for s in range(4)]
        server.close()
        assert server.health()["coalescing"]["groups_flushed"] == 4
    np.testing.assert_allclose(series["port"], series["jax"], rtol=0,
                               atol=SERIAL_TOL)


def test_many_clients_modules_import_and_run_without_jax():
    """The slice's modules import with jax, flax, optax and ml_dtypes
    blocked, and run: two concurrent clients coalesce on a 2BP server
    with admission, and a pipelined client trains at depth 2."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from split_learning_tpu_torch.models import get_plan\n"
        "from split_learning_tpu_torch.runtime import (\n"
        "    MultiClientSplitRunner, PipelinedSplitClientTrainer,\n"
        "    ServerRuntime)\n"
        "from split_learning_tpu_torch.transport import LocalTransport\n"
        "from split_learning_tpu_torch.utils.config import Config\n"
        "g = lambda: torch.Generator().manual_seed(0)\n"
        "cfg = Config(num_clients=2)\n"
        "srv = ServerRuntime(get_plan(), cfg, g(), coalesce_max=2,\n"
        "                    coalesce_window_ms=200.0, decouple_bwd=True,\n"
        "                    apply_lag=1, tenants=2, quota=100.0,\n"
        "                    device='cpu')\n"
        "r = MultiClientSplitRunner(get_plan(), cfg, g(),\n"
        "    lambda i: LocalTransport(srv), concurrent=True, device='cpu')\n"
        "x = np.zeros((2, 28, 28, 1), np.float32)\n"
        "y = np.zeros(2, np.int64)\n"
        "assert all(np.isfinite(r.train_round([(x, y), (x, y)])))\n"
        "r.close(); srv.close()\n"
        "assert srv.health()['decoupled_bwd']['deferred_apply_depth'] == 0\n"
        "p = PipelinedSplitClientTrainer(get_plan(), Config(), g(),\n"
        "    LocalTransport(ServerRuntime(get_plan(), Config(), g(),\n"
        "                                 strict_steps=False,\n"
        "                                 device='cpu')),\n"
        "    depth=2, device='cpu')\n"
        "assert len(p.train(lambda: iter([(x, y)] * 3), epochs=1)) == 3\n"
        "p.close()\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] == 'split_learning_tpu')\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
