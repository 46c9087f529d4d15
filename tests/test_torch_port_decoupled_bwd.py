"""The decoupled backward (2BP) of the port's server against JAX's, on
the CPU (the cases of tests/test_decoupled_bwd.py, on the port).

The reply is the gradient of the activations only; the server's update
is queued behind it and drained at most ``apply_lag`` entries late.

- lag 0 is the coupled server bit for bit: the reply's and the apply's
  backward run the same operations as the coupled one's;
- lag 2 against JAX's lag-2 server over 6 steps, one flax init carried
  across: losses within 1e-4, the server's parameters within 1e-5 (the
  bar of the two-party float32 tests, ``PERF.md`` §2);
- the queue: depth never above the lag, ``close`` drains, an
  ``export_state`` or a checkpoint in a lag window flushes first,
  ``resume_from`` drops, a replayed duplicate is not applied twice, a
  coalesced group's replies land before its update;
- the aliasing guard: the port updates in place, so each queued entry
  must still see, when it is applied, the parameters its reply used
  (copy-on-write); the guard records them at reply time;
- the causal LM runs under 2BP (JAX's ``reply_fn`` uses the mean loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    Checkpointer, MultiClientSplitRunner, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.runtime.state import state_tree
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

BATCH = 4
SAMPLE = np.zeros((BATCH, 28, 28, 1), np.float32)
LOSS_TOL, PARAM_TOL = 1e-4, 1e-5


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(BATCH, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, BATCH).astype(np.int64))


def _init(seed):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(seed), jnp.asarray(SAMPLE)))


def _server(**kw):
    cfg = Config(mode="split", batch_size=BATCH, num_clients=2)
    return cfg, get_plan(), ServerRuntime(get_plan(), cfg, _init(2),
                                          device="cpu", **kw)


def _client(plan, cfg, server, seed=0):
    return SplitClientTrainer(plan, cfg, _init(seed), LocalTransport(server),
                              device="cpu")


def _series(steps=5, **kw):
    cfg, plan, server = _server(**kw)
    client = _client(plan, cfg, server)
    try:
        losses = [client.train_step(*_batch(i), i) for i in range(steps)]
        params = {k: v.detach().clone()
                  for k, v in server.export_state().params[0].items()}
        return losses, params, server
    finally:
        server.close()


@pytest.fixture(scope="module")
def jax_lag2():
    """JAX's lag-2 pair over 6 steps: losses and the flushed server
    parameters."""
    cfg = JaxConfig(mode="split", batch_size=BATCH, num_clients=2)
    plan = jax_get_plan(mode="split")
    server = JaxServer(plan, cfg, jax.random.PRNGKey(2), SAMPLE,
                       decouple_bwd=True, apply_lag=2)
    client = JaxClient(plan, cfg, jax.random.PRNGKey(0), JaxLocal(server))
    losses = [client.train_step(*_batch(i), i) for i in range(6)]
    params = params_from_jax(
        [client.state.params, server.export_state().params])[1]
    server.close()
    return losses, {k: np.asarray(v) for k, v in params.items()}


# --------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------- #

def test_lag0_bit_equal_to_the_coupled_server():
    """At lag 0 the update lands in the reply's lock window, from the
    same parameters: the loss series and the parameters are the coupled
    server's bit for bit."""
    coupled, p_c, _ = _series()
    lag0, p_0, srv = _series(decouple_bwd=True, apply_lag=0)
    assert coupled == lag0
    for k in p_c:
        assert torch.equal(p_c[k], p_0[k]), k
    dec = srv.health()["decoupled_bwd"]
    assert dec["deferred_enqueued"] == dec["deferred_applied"] == 5
    assert dec["deferred_apply_depth"] == 0


def test_lag2_matches_jax(jax_lag2):
    want_losses, want_params = jax_lag2
    losses, params, _ = _series(steps=6, decouple_bwd=True, apply_lag=2)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


def test_default_off_builds_no_queue_and_records_no_2bp_spans():
    cfg, plan, server = _server()
    client = _client(plan, cfg, server)
    try:
        assert server.decouple_bwd is False and server._deferred is None
        tr = obs.enable()
        try:
            client.train_step(*_batch(0), 0)
        finally:
            obs.disable()
        names = {s["name"] for s in tr.spans()}
        assert not names & {"reply_grad", "deferred_apply"}
        assert "decoupled_bwd" not in server.health()
        assert not any(k.startswith("deferred_")
                       for k in server.metrics()["counters"])
        assert server.flush_deferred() == 0
    finally:
        server.close()


def test_ctor_validation():
    with pytest.raises(ValueError, match="apply_lag"):
        _server(decouple_bwd=True, apply_lag=-1)
    with pytest.raises(ValueError, match="decouple_bwd"):
        _server(apply_lag=2)
    with pytest.raises(ValueError, match="split-mode only"):
        ServerRuntime(get_plan(mode="u_split"), Config(mode="u_split"),
                      torch.Generator().manual_seed(0), device="cpu",
                      decouple_bwd=True)


# --------------------------------------------------------------------- #
# the queue and its barriers
# --------------------------------------------------------------------- #

def test_lag_bounds_depth_and_export_flushes():
    lag = 2
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=lag)
    client = _client(plan, cfg, server)
    try:
        tr = obs.enable()
        try:
            for i in range(5):
                client.train_step(*_batch(i), i)
                dec = server.health()["decoupled_bwd"]
                assert dec["deferred_apply_depth"] == min(i + 1, lag)
        finally:
            obs.disable()
        snap = server.metrics()
        assert snap["histograms"]["reply_grad"]["count"] == 5
        assert snap["histograms"]["deferred_apply"]["count"] == 3
        names = [s["name"] for s in tr.spans()]
        assert names.count("reply_grad") == 5
        assert names.count("deferred_apply") == 3
        state = server.export_state()
        dec = server.health()["decoupled_bwd"]
        assert dec["deferred_apply_depth"] == 0
        assert dec["deferred_applied"] == dec["deferred_enqueued"] == 5
        assert state.step == 5
        # predict is a barrier too
        client.train_step(*_batch(5), 5)
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 1
        with torch.no_grad():
            acts = client.stage.apply(client.params,
                                      torch.as_tensor(_batch(0)[0]))
        server.predict(acts)
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 0
    finally:
        server.close()


def test_close_drains_rather_than_drops():
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=3)
    client = _client(plan, cfg, server)
    for i in range(2):
        client.train_step(*_batch(i), i)
    assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 2
    server.close()
    dec = server.health()["decoupled_bwd"]
    assert dec["deferred_apply_depth"] == 0
    assert dec["deferred_applied"] == 2
    assert server.state.step == 2


def test_checkpoint_in_a_lag_window_flushes_and_resume_drops(tmp_path):
    """A checkpoint taken with updates queued holds every applied update
    (``checkpoint`` flushes under the lock); a resume drops what is
    queued (gradients of the pre-restore lineage) instead of applying
    it; a server restarted from the checkpoint continues as the flushed
    original does, bit for bit."""
    def three_steps():
        cfg, plan, server = _server(decouple_bwd=True, apply_lag=2)
        client = _client(plan, cfg, server)
        for i in range(3):
            client.train_step(*_batch(i), i)
        return client, server

    def depth(server):
        return server.health()["decoupled_bwd"]["deferred_apply_depth"]

    client, server = three_steps()
    assert depth(server) == 2
    ckptr = Checkpointer(str(tmp_path))
    assert server.checkpoint(ckptr, 3)
    ckptr.close()
    assert depth(server) == 0
    saved = ckptr.restore_raw(3)["server"]
    assert saved["step"] == 3
    for k, v in state_tree(server.state)["params"][0].items():
        assert torch.equal(saved["params"][0][k], v), k
    want = [client.train_step(*_batch(i), i) for i in range(3, 6)]
    applied = server.health()["decoupled_bwd"]["deferred_applied"]
    assert depth(server) == 2
    server.resume_from(saved, 3)
    assert depth(server) == 0
    assert server.health()["decoupled_bwd"]["deferred_applied"] == applied
    server.close()
    # the restart: a fresh server adopts the checkpoint
    client_b, server_b = three_steps()
    server_b.close()
    _, _, server2 = _server(decouple_bwd=True, apply_lag=2)
    server2.resume_from(saved, 3)
    client_b.transport.server = server2
    try:
        got = [client_b.train_step(*_batch(i), i) for i in range(3, 6)]
    finally:
        server2.close()
    assert got == want


def test_replay_duplicate_is_not_applied_twice():
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=2)
    client = _client(plan, cfg, server)
    try:
        x, y = _batch(0)
        loss0 = client.train_step(x, y, 0)
        assert server.health()["decoupled_bwd"]["deferred_enqueued"] == 1
        # the retransmit: the claim is taken before the payload is read,
        # so even a garbage payload is served the cached reply
        _, loss_dup = server.split_step(np.zeros((1, 1), np.float32), y, 0,
                                        0)
        assert loss_dup == loss0
        assert server.health()["decoupled_bwd"]["deferred_enqueued"] == 1
        assert server.replay.hits >= 1
    finally:
        server.close()


def test_sync_bottoms_flushes_the_server_half():
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=3)
    runner = MultiClientSplitRunner(plan, cfg, lambda i: _init(i),
                                    lambda i: LocalTransport(server),
                                    num_clients=2, device="cpu")
    try:
        runner.train_round([_batch(0), _batch(1)])
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 2
        runner.sync_bottoms()
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 0
    finally:
        runner.close()
        server.close()


def test_group_replies_before_its_apply():
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=1,
                                coalesce_max=2, coalesce_window_ms=500.0)
    runner = MultiClientSplitRunner(plan, cfg, lambda i: _init(i),
                                    lambda i: LocalTransport(server),
                                    num_clients=2, concurrent=True,
                                    device="cpu")
    try:
        losses = runner.train_round([_batch(0), _batch(1)])
        assert all(np.isfinite(l) for l in losses)
        dec = server.health()["decoupled_bwd"]
        assert dec["deferred_apply_depth"] == 1
        assert dec["deferred_enqueued"] - dec["deferred_applied"] == 1
        assert server.flush_deferred() == 1
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 0
        losses2 = runner.train_round([_batch(2), _batch(3)])
        assert all(np.isfinite(l) for l in losses2)
    finally:
        runner.close()
        server.close()


# --------------------------------------------------------------------- #
# the aliasing guard
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("coalesce", [1, 2], ids=["single", "group"])
def test_queued_entries_keep_the_parameters_their_reply_used(coalesce):
    """Each reply's parameters are recorded (cloned) at reply time; when
    its entry is applied, the parameters it differentiates at must be
    those, bit for bit, although K2 (here the plain SGD) updated the live
    tensors in place in between. Fails without the copy-on-write."""
    cfg, plan, server = _server(decouple_bwd=True, apply_lag=2,
                                coalesce_max=coalesce,
                                coalesce_window_ms=1.0)
    at_reply, checked = [], []
    push = server._deferred.push

    def recording_push(entry):
        at_reply.append({k: v.detach().clone()
                         for k, v in entry["fwd_params"].items()})
        entry["_seq"] = len(at_reply) - 1
        push(entry)
    server._deferred.push = recording_push
    apply = server._deferred._apply

    def checking_apply(entry):
        want = at_reply[entry["_seq"]]
        for k, v in entry["fwd_params"].items():
            assert torch.equal(v, want[k]), (entry["_seq"], k)
        checked.append(entry["_seq"])
        apply(entry)
    server._deferred._apply = checking_apply
    client = _client(plan, cfg, server)
    try:
        for i in range(6):
            client.train_step(*_batch(i), i)
        server.flush_deferred()
    finally:
        server.close()
    assert checked == list(range(6))
    # the weights moved between replies: the guard compared something
    assert not all(torch.equal(at_reply[0][k], at_reply[5][k])
                   for k in at_reply[0])


# --------------------------------------------------------------------- #
# the causal LM under 2BP
# --------------------------------------------------------------------- #

LM = dict(vocab=32, d_model=16, num_heads=2, client_depth=1, server_depth=1,
          max_len=16, attn="full")


def test_lm_lag1_matches_jax():
    """The causal LM's server under 2BP at lag 1 (labels [B, T]; the
    reply's mean loss), 4 steps against JAX's: losses within 1e-4."""
    rs = np.random.RandomState(3)
    data = [(rs.randint(0, 32, (2, 8)).astype(np.int32),
             rs.randint(0, 32, (2, 8)).astype(np.int32)) for _ in range(4)]
    jplan = jax_get_plan(model="transformer_lm", **LM)
    jcfg = JaxConfig(mode="split", model="transformer_lm", batch_size=2,
                     lr=0.05)
    sample = jnp.zeros((2, 8), jnp.int32)
    jserver = JaxServer(jplan, jcfg, jax.random.PRNGKey(2), sample,
                        decouple_bwd=True, apply_lag=1)
    jclient = JaxClient(jplan, jcfg, jax.random.PRNGKey(0),
                        JaxLocal(jserver))
    want = [jclient.train_step(x, y, i) for i, (x, y) in enumerate(data)]
    jserver.close()
    plan = get_plan(model="transformer_lm", **LM)
    cfg = Config(mode="split", model="transformer_lm", batch_size=2, lr=0.05)
    server = ServerRuntime(plan, cfg, params_from_jax(
        jplan.init(jax.random.PRNGKey(2), sample)), device="cpu",
        decouple_bwd=True, apply_lag=1)
    client = SplitClientTrainer(plan, cfg, params_from_jax(
        jplan.init(jax.random.PRNGKey(0), sample)), LocalTransport(server),
        device="cpu")
    got = [client.train_step(x, y, i) for i, (x, y) in enumerate(data)]
    server.close()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
