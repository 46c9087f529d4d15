"""The port's sharded parties through the party core (``PartyRuntime(mesh=)``),
on the CPU: the cases of ``tests/test_party_runtime.py`` on the same mesh
shapes.

- The collapse: a one-device mesh is ``mesh=None``, bit for bit, on every
  server path (serialized, coalesced, 2BP at lag 0 and 2), on the U
  server and on both stage parties of the M 1 chain.
- A ``data 2`` middle stage of the 3-stage chain trains as the flat chain
  (JAX's bar, rtol 1e-4, atol 5e-4) and reports its mesh through the
  runner's ``stage_report``; so does a ``data 2 x model 2`` middle stage
  on the device wire, with no host copy on a hop.
- Replicated (2) x sharded (``data 2``) x 3 stages: a kill of the idle
  replica keeps the flat chain's series; a kill of the serving one
  drops no step.
- A sharded stage's checkpoint restores onto a flat successor and a flat
  one onto a sharded successor, each continuing the reference run; its
  ``predict`` pads an odd microbatch to the ``data`` multiple and trims.

The chain starts from JAX's init (``interop.params_from_jax``), as
``tests/test_torch_port_chain.py``'s does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.parallel.mesh import make_host_mesh
from split_learning_tpu_torch.runtime import (
    ServerRuntime, SplitClientTrainer, USplitClientTrainer)
from split_learning_tpu_torch.runtime.party import PartyRuntime
from split_learning_tpu_torch.runtime.pipeline_runner import PipelineRunner
from split_learning_tpu_torch.runtime.replica import maybe_replicate
from split_learning_tpu_torch.runtime.stage import StageRuntime
from split_learning_tpu_torch.transport import DeviceTransport
from split_learning_tpu_torch.transport.local import LocalTransport
from split_learning_tpu_torch.utils.config import Config

BATCH, SEED, M = 8, 2, 2
PARITY = dict(rtol=1e-4, atol=5e-4)   # tests/test_party_runtime.py's bar
_INIT = {}


def _init(model="split_cnn", mode="split"):
    key = (model, mode)
    if key not in _INIT:
        plan = jax_get_plan(model=model, mode=mode)
        _INIT[key] = params_from_jax(jax.device_get(plan.init(
            jax.random.PRNGKey(SEED), jnp.zeros((BATCH, 28, 28, 1)))))
    return _INIT[key]


def _batch(seed, batch=BATCH):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, batch).astype(np.int64))


def test_the_runtimes_share_the_mesh_core():
    assert issubclass(ServerRuntime, PartyRuntime)
    assert issubclass(StageRuntime, PartyRuntime)


# ---------------------------------------------------------------------- #
# the collapse: a one-device mesh is the unsharded party, bit for bit
# ---------------------------------------------------------------------- #

def _server_series(steps=4, mesh=None, **kw):
    cfg = Config(mode="split", batch_size=BATCH)
    plan = get_plan(mode="split")
    server = ServerRuntime(plan, cfg, _init(), device="cpu", mesh=mesh,
                           **kw)
    client = SplitClientTrainer(plan, cfg, _init(), LocalTransport(server),
                                device="cpu")
    try:
        return [client.train_step(*_batch(i), i) for i in range(steps)]
    finally:
        server.close()


@pytest.mark.parametrize("kw", [
    {}, dict(coalesce_max=4, coalesce_window_ms=5.0),
    dict(decouple_bwd=True, apply_lag=0),
    dict(decouple_bwd=True, apply_lag=2)],
    ids=["serialized", "coalesced", "2bp_lag0", "2bp_lag2"])
def test_mesh1_collapse_bit_identical_server_paths(kw):
    assert _server_series(**kw) == _server_series(
        mesh=make_host_mesh(data=1), **kw)


def test_mesh1_collapse_bit_identical_u_split():
    def series(mesh):
        cfg = Config(mode="u_split", batch_size=BATCH)
        plan = get_plan(mode="u_split")
        init = _init(mode="u_split")
        server = ServerRuntime(plan, cfg, init, device="cpu", mesh=mesh)
        client = USplitClientTrainer(plan, cfg, init,
                                     LocalTransport(server), device="cpu")
        try:
            return [client.train_step(*_batch(i), i) for i in range(3)]
        finally:
            server.close()
    assert series(None) == series(make_host_mesh(data=1))


# ---------------------------------------------------------------------- #
# the chain
# ---------------------------------------------------------------------- #

def _chain(mesh_mid=None, microbatches=M, replicas=1, mesh_last=None,
           wire=LocalTransport):
    cfg = Config(mode="split", model="split_cnn_chain3", batch_size=BATCH,
                 num_stages=3, microbatches=microbatches, seed=SEED)
    plan = get_plan(model="split_cnn_chain3", mode="split")
    init = _init("split_cnn_chain3")

    def factory(i, mesh):
        def make(_ridx=0):
            return StageRuntime(plan, i, cfg, init,
                                microbatches=microbatches, mesh=mesh,
                                device="cpu")
        return make

    parties = [maybe_replicate(factory(1, mesh_mid), replicas),
               maybe_replicate(factory(2, mesh_last), replicas)]
    runner = PipelineRunner(plan, cfg, init, None,
                            [wire(p) for p in parties],
                            microbatches=microbatches, device="cpu")
    return runner, parties


def _chain_series(steps=4, kill=None, **kw):
    runner, parties = _chain(**kw)
    try:
        losses = []
        for s in range(steps):
            if kill is not None and s == kill[0]:
                parties[0].kill(kill[1](parties[0].assignment(0)))
            losses.append(runner.step(*_batch(s), step=s))
        return losses, parties
    finally:
        runner.close()
        for p in parties:
            p.close()


def test_m1_chain_mesh1_bit_identical():
    legacy, _ = _chain_series(microbatches=1)
    m1, _ = _chain_series(microbatches=1, mesh_mid=make_host_mesh(data=1),
                          mesh_last=make_host_mesh(data=1))
    assert legacy == m1


@pytest.mark.parametrize("data,model,wire", [
    (2, 1, LocalTransport), (2, 2, DeviceTransport)],
    ids=["data2_local", "data2_x_model2_device"])
def test_sharded_middle_stage_float_parity(data, model, wire):
    """A sharded middle stage keeps the flat chain's series, and the
    runner's report shows each stage's mesh; on the device wire no hop
    copies through the host."""
    flat, _ = _chain_series()
    runner, parties = _chain(mesh_mid=make_host_mesh(data=data,
                                                     model=model),
                             wire=wire)
    try:
        sharded = [runner.step(*_batch(s), step=s) for s in range(4)]
        report = runner.stage_report()
        copies = [t.stats.counters.get(spans.HOP_HOST_COPIES, 0)
                  for t in runner.transports]
    finally:
        runner.close()
        for p in parties:
            p.close()
    np.testing.assert_allclose(sharded, flat, **PARITY)
    assert report[0]["mesh"]["data"] == data
    assert report[0]["mesh"].get("model", 1) == model
    assert report[1]["mesh"] == {"devices": 1, "data": 1}
    if wire is DeviceTransport:
        assert copies == [0, 0]


def test_replicated_sharded_chain_parity_across_idle_kill():
    flat, _ = _chain_series(steps=8)
    repl, parties = _chain_series(
        steps=8, mesh_mid=make_host_mesh(data=2), replicas=2,
        kill=(4, lambda serving: 1 - serving))
    np.testing.assert_allclose(repl, flat, **PARITY)
    assert parties[0].counters()["replica_handoffs"] == 1


def test_replicated_sharded_chain_zero_drop_on_serving_kill():
    repl, parties = _chain_series(
        steps=8, mesh_mid=make_host_mesh(data=2, model=2), replicas=2,
        kill=(4, lambda serving: serving))
    assert len(repl) == 8 and np.all(np.isfinite(repl))
    assert parties[0].counters()["replica_handoffs"] == 1
    assert parties[0].health()["step"] == 7


def test_sharded_stage_checkpoint_roundtrip_reshards():
    """A ``data 2 x model 2`` middle stage captured at step 4 resumes in
    a chain whose middle stage is flat, and a flat capture in a sharded
    successor: each continues the reference run."""
    ref, _ = _chain_series(steps=8, mesh_mid=make_host_mesh(data=2,
                                                            model=2))

    def resume_run(capture_mesh, resume_mesh, want_ranks):
        runner, parties = _chain(mesh_mid=capture_mesh)
        try:
            for s in range(4):
                runner.step(*_batch(s), step=s)
            states = [p.export_state() for p in parties]
            extras = [p.export_runtime_extras(4) for p in parties]
            client_state = runner.state
        finally:
            runner.close()
            for p in parties:
                p.close()
        runner2, parties2 = _chain(mesh_mid=resume_mesh)
        try:
            runner2.state = client_state
            runner2.steps_done = 4
            for p, st, ex in zip(parties2, states, extras):
                p.resume_from(st, 4, extras=ex)
            ranks = getattr(parties2[0].state, "ranks", [[None]])
            assert sum(len(row) for row in ranks) == want_ranks
            return [runner2.step(*_batch(s), step=s) for s in range(4, 8)]
        finally:
            runner2.close()
            for p in parties2:
                p.close()

    onto_flat = resume_run(make_host_mesh(data=2, model=2), None, 1)
    np.testing.assert_allclose(onto_flat, ref[4:], **PARITY)
    onto_sharded = resume_run(None, make_host_mesh(data=2, model=2), 4)
    np.testing.assert_allclose(onto_sharded, ref[4:], **PARITY)


def test_sharded_stage_predict_pads_and_trims():
    """A stage on ``data 2 x model 2`` pads an odd microbatch to the data
    multiple for ``predict`` and hands back only its rows: the flat
    stage's output."""
    cfg = Config(mode="split", model="split_cnn_chain3", batch_size=BATCH,
                 num_stages=3, seed=SEED)
    plan = get_plan(model="split_cnn_chain3", mode="split")
    init = _init("split_cnn_chain3")
    x = np.random.RandomState(4).randn(3, 28, 28, 1).astype(np.float32)
    cut = plan.stages[0].apply(init[0], torch.as_tensor(x)).detach().numpy()
    flat = StageRuntime(plan, 1, cfg, init, device="cpu")
    sharded = StageRuntime(plan, 1, cfg, init, device="cpu",
                           mesh=make_host_mesh(data=2, model=2))
    try:
        a, b = flat.predict(cut), sharded.predict(cut)
        assert a.shape == b.shape and a.shape[0] == 3
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    finally:
        flat.close()
        sharded.close()
