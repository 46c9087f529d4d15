"""The port's single-program GPipe pipeline against JAX's, on the CPU.

JAX's ``PipelinedTrainer`` runs on the 8-device CPU mesh that
tests/conftest.py forces; the port's on a mesh of CPU ranks of the same
(data, pipe) shape, from the same flax init (``interop``) and the same
numpy-seeded batches. 12-step losses agree within 1e-4 for the 2-stage
CNN (M 4), the U plan (3 stages, M 2), data 2 x pipe 2 (M 2) and the
LM (token ids injected into stage 0); the final parameters within rtol
1e-4 / atol 1e-5, JAX's own bar against the fused trainer
(tests/test_pipeline.py), and so do the port's pipeline against its own
fused trainer at the same microbatches. Also: the cut dtype rule (bf16
cuts, integer ids promoted to float32), ``make_hop_shift`` and
``DeviceTransport(mesh=)`` on the K-stage chain, the checkpoint tree.
"""

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from split_learning_tpu.parallel.pipeline import (
    PipelinedTrainer as JaxPipelinedTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.parallel.mesh import Mesh, make_mesh
from split_learning_tpu_torch.parallel.pipeline import (
    PipelinedTrainer, _cut_dtype, make_hop_shift)
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

STEPS, BATCH = 12, 16
LM = dict(vocab=32, d_model=16, num_heads=2, client_depth=1, server_depth=1)


def _cnn_data(seed=5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, (BATCH,)).astype(np.int64))
            for _ in range(STEPS)]


def _lm_data(seed=6, t=8):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 32, (BATCH, t)).astype(np.int32),
             rs.randint(0, 32, (BATCH, t)).astype(np.int64))
            for _ in range(STEPS)]


CASES = {
    "split_cnn_m4": ("split_cnn", "split", {}, 1, 4),
    "u_split_cnn_m2": ("split_cnn", "u_split", {}, 1, 2),
    "data2_pipe2_m2": ("split_cnn", "split", {}, 2, 2),
    "transformer_lm_m2": ("transformer_lm", "split", LM, 1, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax(case):
    model, mode, size, n_data, m = CASES[case]
    data = _lm_data() if model == "transformer_lm" else _cnn_data()
    kw = dict(mode=mode, batch_size=BATCH, microbatches=m,
              num_clients=n_data, lr=0.05)
    jplan = jax_get_plan(model=model, mode=mode, **size)
    s = jplan.num_stages
    jmesh = jax_make_mesh(num_clients=n_data, num_stages=s,
                          devices=jax.devices()[:n_data * s])
    jtrainer = JaxPipelinedTrainer(jplan, JaxConfig(**kw),
                                   jax.random.PRNGKey(11), data[0][0], jmesh)
    mesh = make_mesh(num_clients=n_data, num_stages=s, device="cpu")
    trainer = PipelinedTrainer(get_plan(model=model, mode=mode, **size),
                               Config(transport="pipeline", **kw),
                               params_from_jax(jtrainer.params), data[0][0],
                               mesh)
    assert trainer.buf_dtype == torch.float32 and trainer.mb_size == \
        jtrainer.mb_size
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jtrainer.params))
    got = jax.tree_util.tree_leaves(params_to_jax(trainer.params))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # every data row holds the same replica
    for d in trainer.rows[1:]:
        for a, b in zip(trainer.states[0].params, trainer.states[d].params):
            for k in a:
                assert torch.equal(a[k], b[k])


def test_pipeline_matches_the_fused_trainer():
    """JAX's bar (tests/test_pipeline.py): GPipe over 2 pipe ranks at M 4
    against the fused trainer at 4 microbatches, from one init."""
    data = _cnn_data(7)
    cfg = Config(transport="fused", batch_size=BATCH, microbatches=4,
                 lr=0.05)
    init = get_plan().init(torch.Generator().manual_seed(2), torch.zeros(1))
    fused = FusedSplitTrainer(get_plan(), cfg, init, None, device="cpu")
    pipe = PipelinedTrainer(get_plan(), cfg.replace(transport="pipeline"),
                            init, data[0][0],
                            make_mesh(num_stages=2, device="cpu"))
    for x, y in data:
        np.testing.assert_allclose(pipe.train_step(x, y),
                                   fused.train_step(x, y), rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(pipe.params, fused.params):
        for k in a:
            np.testing.assert_allclose(a[k].detach().numpy(),
                                       b[k].detach().numpy(), rtol=1e-4,
                                       atol=1e-5)


def test_cut_dtype_rule_matches_jax():
    """The cut travels in the result type of the non-last stages'
    outputs (bf16 under mixed precision), promoted to float32 when a
    later stage takes integer ids; on the bf16 LM plan, JAX's."""
    bf, f32 = torch.bfloat16, torch.float32
    assert _cut_dtype([bf, bf], [torch.int32, bf]) == bf
    assert _cut_dtype([bf, bf, bf], [f32, torch.int64, bf]) == f32
    assert _cut_dtype([bf, f32, bf], [f32, bf, f32]) == f32
    assert _cut_dtype([f32], [f32]) == f32
    x = _lm_data()[0][0]
    jtrainer = JaxPipelinedTrainer(
        jax_get_plan(model="transformer_lm", dtype="bfloat16", **LM),
        JaxConfig(batch_size=BATCH, microbatches=2, dtype="bfloat16"),
        jax.random.PRNGKey(0), x,
        jax_make_mesh(num_stages=2, devices=jax.devices()[:2]))
    trainer = PipelinedTrainer(
        get_plan(model="transformer_lm", dtype="bfloat16", **LM),
        Config(batch_size=BATCH, microbatches=2, dtype="bfloat16",
               transport="pipeline"),
        torch.Generator().manual_seed(0), x,
        make_mesh(num_stages=2, device="cpu"))
    assert str(jtrainer.buf_dtype) == "bfloat16" == str(
        trainer.buf_dtype).replace("torch.", "")
    assert np.isfinite(trainer.train_step(x, _lm_data()[0][1]))


def test_checks_and_checkpoint_tree():
    plan, data = get_plan(), _cnn_data(8)
    cfg = Config(transport="pipeline", batch_size=BATCH, microbatches=2)
    with pytest.raises(ValueError, match="'pipe' axis"):
        PipelinedTrainer(plan, cfg, torch.Generator(), data[0][0],
                         Mesh([torch.device("cpu")], ("data",)))
    with pytest.raises(ValueError, match="!= num stages"):
        PipelinedTrainer(plan, cfg, torch.Generator(), data[0][0],
                         make_mesh(num_stages=3, device="cpu"))
    with pytest.raises(ValueError, match="must divide"):
        PipelinedTrainer(plan, cfg, torch.Generator(), data[0][0],
                         make_mesh(num_stages=2, device="cpu"),
                         microbatches=3)
    mesh = make_mesh(num_clients=2, num_stages=2, device="cpu")

    def fresh():
        return PipelinedTrainer(plan, cfg.replace(num_clients=2),
                                torch.Generator().manual_seed(4),
                                data[0][0], mesh)

    a = fresh()
    full = [a.train_step(x, y) for x, y in data[:4]]
    b = fresh()
    half = [b.train_step(x, y) for x, y in data[:2]]
    c = fresh()
    c.restore_states(b.export_states())
    assert half + [c.train_step(x, y) for x, y in data[2:4]] == full


def test_hop_shift_and_the_meshed_device_wire():
    mesh = make_mesh(num_stages=3, device="cpu")
    with pytest.raises(ValueError, match="outside the pipe axis"):
        make_hop_shift(mesh, 0, 3)
    with pytest.raises(ValueError, match="distinct"):
        make_hop_shift(mesh, 1, 1)
    with pytest.raises(ValueError, match="'pipe' axis"):
        make_hop_shift(Mesh([torch.device("cpu")], ("data",)), 0, 1)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(make_hop_shift(mesh, 0, 2)(x), x)
    # the K-stage chain on DeviceTransport with a 3-rank pipe mesh: the
    # losses of the chain without one
    from test_torch_port_chain import drive, port_chain
    from split_learning_tpu_torch.transport.device import DeviceTransport
    plain = drive(port_chain(2, 0, transport="device"), 3)
    chain = port_chain(2, 0, transport="device",
                       wrap=lambda t: DeviceTransport(t.server, mesh=mesh))
    assert all(t._mesh is mesh for t in chain[2])
    assert drive(chain, 3) == plain
