"""The port's sharded server (``ServerRuntime(mesh=)``) against JAX's, on
the CPU.

The cases of ``tests/test_sharded_server.py``, on the same mesh shapes
(the port's CPU ranks, JAX's forced host devices), each pair from JAX's
inits (``interop.params_from_jax``; the client's from key 0, the
server's from key 2, as JAX's test seeds them) on the same numpy-seeded
batches:

- a mesh of one device is ``mesh=None`` and every path (serialized,
  coalesced groups of one, 2BP at lag 0 and 2) is bit-identical to it;
- ``data 2`` and ``data 2 x model 2`` train as JAX's sharded server
  does, within JAX's bar (rtol 1e-4, atol 5e-4), the heavy leaves split
  over ``model``; coalesced and decoupled runs likewise; the U server
  runs on the mesh;
- a coalesced group pads to the ``data`` multiple with rows the loss
  leaves out; a serialized batch that does not tile ``data`` is a 400;
  ``predict`` pads and trims;
- ``host_gather``, the ``SpecLayout`` rules, the short-host remedy, the
  mesh in health, metrics and the trace metadata (with ``gather_bytes``
  and the ``FL_GATHER`` journal), none of it without a mesh, the
  federated refusal, and a resume that lays the state out again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.parallel.mesh import (
    make_host_mesh as jax_make_host_mesh)
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport.local import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import flight, spans
from split_learning_tpu_torch.parallel.distributed import (
    SpecLayout, server_state_layout)
from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, batch_sharding, host_gather, make_host_mesh)
from split_learning_tpu_torch.parallel.tensor import ShardedParam
from split_learning_tpu_torch.runtime import (
    ServerRuntime, SplitClientTrainer, USplitClientTrainer)
from split_learning_tpu_torch.runtime.server import ProtocolError
from split_learning_tpu_torch.runtime.state import (
    make_state, make_tx, state_tree)
from split_learning_tpu_torch.transport.local import LocalTransport
from split_learning_tpu_torch.utils.config import Config

BATCH = 4
PARITY = dict(rtol=1e-4, atol=5e-4)   # tests/test_sharded_server.py's bar


def _batch(seed=0, batch=BATCH):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, batch).astype(np.int64))


_INITS = {}


def _inits(mode="split"):
    """JAX's whole-plan inits of the client (key 0) and the server (key
    2), in the port's layout."""
    if mode not in _INITS:
        plan = jax_get_plan(mode=mode)
        x = jnp.zeros((BATCH, 28, 28, 1), jnp.float32)
        _INITS[mode] = tuple(
            params_from_jax(jax.device_get(plan.init(jax.random.PRNGKey(k),
                                                     x)))
            for k in (0, 2))
    return _INITS[mode]


def _server(batch=BATCH, **kw):
    cfg = Config(mode="split", batch_size=batch, num_clients=2)
    return cfg, ServerRuntime(get_plan(mode="split"), cfg, _inits()[1],
                              device="cpu", **kw)


def _series(steps=4, batch=BATCH, **kw):
    cfg, server = _server(batch=batch, **kw)
    client = SplitClientTrainer(get_plan(mode="split"), cfg, _inits()[0],
                                LocalTransport(server), device="cpu")
    try:
        return [client.train_step(*_batch(i, batch), i)
                for i in range(steps)], server
    finally:
        server.close()


def _jax_series(steps=4, batch=BATCH, **kw):
    cfg = JaxConfig(mode="split", batch_size=batch, num_clients=2)
    plan = jax_get_plan(mode="split")
    sample = np.zeros((batch, 28, 28, 1), np.float32)
    server = JaxServer(plan, cfg, jax.random.PRNGKey(2), sample, **kw)
    client = JaxClient(plan, cfg, jax.random.PRNGKey(0), JaxLocal(server))
    try:
        return [client.train_step(*_batch(i, batch), i)
                for i in range(steps)]
    finally:
        server.close()


# ---------------------------------------------------------------------- #
# mesh=1: the one-device mesh is the unsharded runtime, bit for bit
# ---------------------------------------------------------------------- #

def test_mesh1_is_normalized_and_bit_identical_fused():
    legacy, _ = _series()
    m1, srv = _series(mesh=make_host_mesh(data=1))
    assert srv._mesh is None
    assert legacy == m1


def test_mesh1_bit_identical_coalesced_groups_of_one():
    kw = dict(coalesce_max=4, coalesce_window_ms=5.0)
    legacy, _ = _series(**kw)
    m1, _ = _series(mesh=make_host_mesh(data=1), **kw)
    assert legacy == m1


@pytest.mark.parametrize("lag", [0, 2])
def test_mesh1_bit_identical_decoupled_bwd(lag):
    kw = dict(decouple_bwd=True, apply_lag=lag)
    legacy, _ = _series(**kw)
    m1, _ = _series(mesh=make_host_mesh(data=1), **kw)
    assert legacy == m1


# ---------------------------------------------------------------------- #
# data 2 and data 2 x model 2: JAX's sharded server, to its bar
# ---------------------------------------------------------------------- #

def test_data2_matches_jax_sharded_server():
    got, srv = _series(mesh=make_host_mesh(data=2))
    assert srv._mesh is not None and srv._mesh_data == 2
    np.testing.assert_allclose(
        got, _jax_series(mesh=jax_make_host_mesh(data=2)), **PARITY)
    np.testing.assert_allclose(got, _series()[0], **PARITY)


def test_data2_coalesced_and_decoupled_match():
    kw_c = dict(coalesce_max=4, coalesce_window_ms=5.0)
    d2_c, _ = _series(mesh=make_host_mesh(data=2), **kw_c)
    np.testing.assert_allclose(d2_c, _series(**kw_c)[0], **PARITY)
    kw_b = dict(decouple_bwd=True, apply_lag=2)
    d2_b, _ = _series(mesh=make_host_mesh(data=2), **kw_b)
    np.testing.assert_allclose(d2_b, _series(**kw_b)[0], **PARITY)
    np.testing.assert_allclose(
        d2_b, _jax_series(mesh=jax_make_host_mesh(data=2), **kw_b),
        **PARITY)


def test_tensor_parallel_mesh_shards_heavy_leaves_and_trains():
    got, srv = _series(mesh=make_host_mesh(data=2, model=2))
    params = srv.state.params[0]
    assert all(isinstance(p, ShardedParam) for p in params.values())
    assert {k for k, p in params.items() if p.shard_dim is not None} == {
        "conv2.weight", "fc.weight"}
    assert [len(row) for row in params["fc.weight"].grid] == [2, 2]
    np.testing.assert_allclose(
        got, _jax_series(mesh=jax_make_host_mesh(data=2, model=2)),
        **PARITY)
    for kw in (dict(coalesce_max=4, coalesce_window_ms=5.0),
               dict(decouple_bwd=True, apply_lag=0)):
        tp, _ = _series(mesh=make_host_mesh(data=2, model=2), **kw)
        np.testing.assert_allclose(tp, _series(**kw)[0], **PARITY)


def test_u_server_runs_on_a_mesh():
    """The U-shaped trunk's two hops on ``data 2 x model 2``: the
    unsharded series, to the bar."""
    def series(mesh):
        cfg = Config(mode="u_split", batch_size=BATCH)
        plan = get_plan(mode="u_split")
        client_init, server_init = _inits("u_split")
        server = ServerRuntime(plan, cfg, server_init, device="cpu",
                               mesh=mesh)
        client = USplitClientTrainer(plan, cfg, client_init,
                                     LocalTransport(server), device="cpu")
        try:
            return [client.train_step(*_batch(i), i) for i in range(3)]
        finally:
            server.close()
    np.testing.assert_allclose(series(make_host_mesh(data=2, model=2)),
                               series(None), **PARITY)


# ---------------------------------------------------------------------- #
# group sizing, the 400, predict
# ---------------------------------------------------------------------- #

def test_group_pads_to_data_axis_multiple_with_zero_weight_tail():
    """batch 2 on a data 4 mesh: the group rounds up to 4 rows, and the
    two padding rows leave the loss series at the unsharded values."""
    legacy, _ = _series(batch=2)
    padded, srv = _series(batch=2, coalesce_max=4, coalesce_window_ms=5.0,
                          mesh=make_host_mesh(data=4))
    np.testing.assert_allclose(padded, legacy, **PARITY)
    sigs = list(srv._coalesce_shapes)
    assert sigs, "group dispatch never ran"
    for shape, _, _ in sigs:
        assert shape[0] % 4 == 0, sigs


def test_serialized_nondivisible_batch_is_a_protocol_400():
    _, server = _server(mesh=make_host_mesh(data=2))
    try:
        acts = np.zeros((3, 26, 26, 32), np.float32)   # the cut's shape
        with pytest.raises(ProtocolError, match="data") as exc:
            server.split_step(acts, np.zeros((3,), np.int64), 0)
        assert exc.value.status == 400
    finally:
        server.close()


def test_predict_pads_and_trims_odd_batches():
    _, server0 = _server()
    _, server2 = _server(mesh=make_host_mesh(data=2, model=2))
    try:
        acts = np.random.RandomState(7).randn(3, 26, 26, 32).astype(
            np.float32)
        out0, out2 = server0.predict(acts), server2.predict(acts)
        assert out2.shape == out0.shape == (3, 10)
        np.testing.assert_allclose(out2, out0, rtol=1e-5, atol=1e-5)
    finally:
        server0.close()
        server2.close()


# ---------------------------------------------------------------------- #
# the sanctioned gather and the mesh helpers
# ---------------------------------------------------------------------- #

def test_host_gather_trims_and_passes_through():
    mesh = make_host_mesh(data=2)
    x = torch.arange(12.0).reshape(6, 2)
    parts = batch_sharding(mesh).split(x)
    np.testing.assert_array_equal(host_gather(parts), x.numpy())
    np.testing.assert_array_equal(host_gather(parts, rows=3),
                                  x[:3].numpy())
    h = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(host_gather(h, rows=2), h[:2])
    assert host_gather(torch.tensor(3.5)) == np.float32(3.5)


def test_make_host_mesh_reports_the_remedy_when_short_on_devices():
    with pytest.raises(RuntimeError, match="SLT_HOST_DEVICES"):
        make_host_mesh(data=64)
    with pytest.raises(RuntimeError, match="SLT_HOST_DEVICES"):
        make_host_mesh(data=4, model=4)


def test_spec_layout_rules():
    """JAX's rules on the port's leaves: a dense weight is ``[out, in]``
    where flax's kernel is ``[in, out]``, so JAX's column split is torch
    dim 0 and its row split torch dim 1."""
    layout = server_state_layout(make_host_mesh(data=2, model=2))
    assert isinstance(layout, SpecLayout)
    assert (layout.data, layout.model) == (2, 2)
    # column parallel: JAX's kernel [8, 64], its last dim divides
    assert layout.param(torch.zeros(64, 8)).spec == (MODEL_AXIS,)
    # row parallel: JAX's kernel [64, 5], only the contraction divides
    assert layout.param(torch.zeros(5, 64)).spec == (None, MODEL_AXIS)
    assert layout.param(torch.zeros(5)).spec == ()
    assert layout.batch().spec[0] == DATA_AXIS
    params = get_plan().init(torch.Generator().manual_seed(0),
                             torch.zeros(1))
    assert layout.describe(params)["1/fc.weight"] == str((MODEL_AXIS,))
    assert set(layout.state(make_state(params, make_tx(Config())))) == {
        f"{i}/{k}" for i, st in enumerate(params) for k in st}


# ---------------------------------------------------------------------- #
# observability
# ---------------------------------------------------------------------- #

def test_mesh_surfaces_in_health_metrics_and_trace_metadata():
    cfg, server = _server(mesh=make_host_mesh(data=2))
    client = SplitClientTrainer(get_plan(mode="split"), cfg, _inits()[0],
                                LocalTransport(server), device="cpu")
    rec = flight.enable()
    try:
        client.train_step(*_batch(0), 0)
        mesh_h = server.health()["mesh"]
        assert mesh_h["devices"] == 2 and mesh_h["data"] == 2
        gauges = server.metrics()["gauges"]
        assert gauges["mesh_devices"] == 2.0 and gauges["mesh_data"] == 2.0
        assert server.trace_metadata()["programs"] == {}
        obs.enable()
        try:
            client.train_step(*_batch(1), 1)
            # a host request (the HTTP wire's) is answered through the
            # sanctioned gather; the in-process wire's tensors are not
            acts = np.random.RandomState(2).randn(4, 26, 26, 32).astype(
                np.float32)
            g, _ = server.split_step(acts, np.zeros(4, np.int64), 2)
            assert isinstance(g, np.ndarray) and g.shape == acts.shape
        finally:
            obs.disable()
        meta = server.trace_metadata()
        assert meta["mesh"]["data"] == 2
        assert meta["gather_bytes"] > 0
        prog = meta["programs"]["split_step"]
        assert prog["calls"] >= 1 and prog["model_flops"] > 0
        assert meta["peak_flops_per_device"] is None and prog["mfu"] is None
        assert any(e["name"] == spans.FL_GATHER for e in rec.events())
    finally:
        flight.disable()
        server.close()


def test_unsharded_server_exports_no_mesh_or_gather_counters():
    cfg, server = _server()
    client = SplitClientTrainer(get_plan(mode="split"), cfg, _inits()[0],
                                LocalTransport(server), device="cpu")
    try:
        client.train_step(*_batch(0), 0)
        assert "mesh" not in server.health()
        assert "gather_bytes" not in server.metrics()["counters"]
        meta = server.trace_metadata()
        assert meta["mesh"] == {"devices": 1, "data": 1}
        assert meta["gather_bytes"] == 0
    finally:
        server.close()


def test_federated_mesh_is_rejected():
    cfg = Config(mode="federated", batch_size=BATCH, num_clients=2)
    with pytest.raises(ValueError, match="federated"):
        ServerRuntime(get_plan(mode="federated"), cfg,
                      torch.Generator().manual_seed(2), device="cpu",
                      mesh=make_host_mesh(data=2))


# ---------------------------------------------------------------------- #
# a resume lays the state out again
# ---------------------------------------------------------------------- #

def test_resume_from_reshards_and_continues():
    cfg, server = _server(mesh=make_host_mesh(data=2, model=2))
    client = SplitClientTrainer(get_plan(mode="split"), cfg, _inits()[0],
                                LocalTransport(server), device="cpu")
    try:
        client.train_step(*_batch(0), 0)
        # the checkpoint's form: whole leaves on the host
        tree = state_tree(server.export_state())
        assert tuple(tree["params"][0]["fc.weight"].shape) == (10, 9216)
        host = {"params": [{k: v.numpy() for k, v in st.items()}
                           for st in tree["params"]],
                "opt_state": None, "step": tree["step"]}
        server.resume_from(host, step=0)
        fc = server.state.params[0]["fc.weight"]
        assert [tuple(t.shape) for t in fc.grid[0]] == [(5, 9216)] * 2
        assert np.isfinite(client.train_step(*_batch(1), 1))
    finally:
        server.close()


# ---------------------------------------------------------------------- #
# the command line
# ---------------------------------------------------------------------- #

def test_cli_meshes_the_served_and_in_process_parties(tmp_path, capsys):
    """``--mesh-data 2 --mesh-model 2`` on the in-process server of the
    local wire, on the chain's in-process stages and on ``serve``: rc 0
    and the served party on the mesh; a mesh larger than the host's
    ranks exits 2 with the remedy, as JAX's does."""
    from split_learning_tpu_torch.launch import run
    base = ["train", "--device", "cpu", "--steps", "2", "--dataset",
            "synthetic", "--data-dir", str(tmp_path), "--batch-size", "8",
            "--tracking", "noop"]
    mesh = ["--mesh-data", "2", "--mesh-model", "2"]
    assert run.main(base + ["--transport", "local", *mesh]) == 0
    assert run.main(base + ["--model", "split_cnn_chain3", "--stages", "3",
                            "--transport", "device", "--microbatches", "2",
                            *mesh]) == 0
    capsys.readouterr()
    assert run.main(base + ["--transport", "local", "--mesh-data", "4",
                            "--mesh-model", "4"]) == 2
    assert "SLT_HOST_DEVICES" in capsys.readouterr().err
    runtime, server, _ = run.serve_party(run.parse_args(
        ["serve", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         *mesh]))
    try:
        assert runtime.health()["mesh"] == {"devices": 4, "data": 2,
                                            "pipe": 1, "model": 2}
    finally:
        server.stop()
        runtime.close()
