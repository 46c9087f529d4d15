"""The port's meshed FusedSplitTrainer against JAX's, on the CPU.

JAX's trainer runs on the 8-device CPU mesh that tests/conftest.py
forces (flash blocks in Pallas interpret mode); the port's on a mesh of
CPU ranks of the same shape. Both start from the same flax init
(``interop.params_from_jax``) and see the same numpy-seeded batches.

- ``data 2 x seq 2``: the LM with ``ring_flash`` and with ``ulysses``,
  the ViT with ``ring``: 12-step losses within 1e-4 of JAX's.
- ``data 2``: the split CNN, 12 steps within 1e-4 of JAX's meshed
  trainer, and the two replicas bit-equal after every step.
- One replica checkpointed and restored onto the mesh continues as the
  uninterrupted run; ``train_epoch`` on the mesh equals the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.parallel.mesh import make_mesh
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

STEPS, BATCH, T, VOCAB = 12, 8, 16, 32
LM = dict(vocab=VOCAB, d_model=16, num_heads=2, client_depth=1,
          server_depth=1)
VIT = dict(d_model=16, num_heads=2, client_depth=1, server_depth=1)


def _lm_data(seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (BATCH, T)).astype(np.int32),
             rs.randint(0, VOCAB, (BATCH, T)).astype(np.int64))
            for _ in range(STEPS)]


def _img_data(seed=0, side=16):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, side, side, 1).astype(np.float32),
             rs.randint(0, 10, (BATCH,)).astype(np.int64))
            for _ in range(STEPS)]


def _pair(model, size, data, data_axis, seq_axis, **cfg_kw):
    """JAX's meshed trainer and the port's, from one init."""
    jmesh = jax_make_mesh(num_clients=data_axis, seq_parallel=seq_axis,
                          devices=jax.devices()[:data_axis * seq_axis])
    mesh = make_mesh(num_clients=data_axis, seq_parallel=seq_axis,
                     device="cpu")
    kw = dict(batch_size=BATCH, num_clients=data_axis,
              seq_parallel=seq_axis, lr=0.05, **cfg_kw)
    # the attention plans take the mesh (their seq axis); the CNN none
    jplan = jax_get_plan(model=model, **size, **(
        {"mesh": jmesh} if size else {}))
    jtrainer = JaxFusedSplitTrainer(jplan, JaxConfig(**kw),
                                    jax.random.PRNGKey(0),
                                    jnp.asarray(data[0][0]), mesh=jmesh)
    plan = get_plan(model=model, **size, **({"mesh": mesh} if size else {}))
    trainer = FusedSplitTrainer(plan, Config(transport="fused", **kw),
                                params_from_jax(jtrainer.params),
                                data[0][0], mesh=mesh)
    return jtrainer, trainer


def _replicas_equal(trainer):
    first = trainer.states[trainer.rows[0]]
    for d in trainer.rows[1:]:
        for a, b in zip(first.params, trainer.states[d].params):
            for k in a:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model,attn", [("transformer_lm", "ring_flash"),
                                        ("transformer_lm", "ulysses"),
                                        ("vit", "ring")])
def test_data_and_seq_axes_match_jax(model, attn):
    lm = model == "transformer_lm"
    data = _lm_data() if lm else _img_data()
    size = dict(LM if lm else VIT, attn=attn)
    jtrainer, trainer = _pair(model, size, data, 2, 2)
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = []
    for x, y in data:
        losses.append(trainer.train_step(x, y))
        _replicas_equal(trainer)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    assert len(trainer.rows) == 2 and trainer.state.step == STEPS


def test_data_axis_cnn_matches_jax_and_keeps_replicas_equal():
    data = _img_data(1, side=28)
    jtrainer, trainer = _pair("split_cnn", {}, data, 2, 1)
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = []
    for x, y in data:
        losses.append(trainer.train_step(x, y))
        _replicas_equal(trainer)
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-4)
    # the data-parallel step is the unsharded global-batch step
    jplain = JaxFusedSplitTrainer(jax_get_plan(), JaxConfig(
        batch_size=BATCH, lr=0.05), jax.random.PRNGKey(0),
        jnp.asarray(data[0][0]))
    plain = FusedSplitTrainer(get_plan(), Config(transport="fused",
                                                 batch_size=BATCH, lr=0.05),
                              params_from_jax(jplain.params), None,
                              device="cpu")
    np.testing.assert_allclose([plain.train_step(x, y) for x, y in data],
                               losses, rtol=0, atol=1e-4)


def test_checkpoint_saves_one_replica_and_resumes_onto_the_mesh():
    data = _lm_data(2)
    size = dict(LM, attn="ring")
    mesh = make_mesh(num_clients=2, seq_parallel=2, device="cpu")
    plan = get_plan(model="transformer_lm", mesh=mesh, **size)
    cfg = Config(transport="fused", batch_size=BATCH, num_clients=2,
                 seq_parallel=2, optimizer="adamw", lr=1e-2,
                 weight_decay=0.1)

    def fresh():
        return FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(3),
                                 data[0][0], mesh=mesh)

    a = fresh()
    full = [a.train_step(x, y) for x, y in data[:6]]
    b = fresh()
    half = [b.train_step(x, y) for x, y in data[:3]]
    tree = b.export_states()
    assert list(tree) == ["trainer"]
    c = fresh()
    c.restore_states(tree)
    _replicas_equal(c)
    rest = [c.train_step(x, y) for x, y in data[3:6]]
    assert half + rest == full
    # train_epoch (the --scan-steps chunk) on the mesh: the same steps
    d = fresh()
    series = d.train_epoch(np.stack([x for x, _ in data[:6]]),
                           np.stack([y for _, y in data[:6]]))
    assert series.tolist() == full


@pytest.mark.parametrize("model,seq", [("split_cnn", 2), ("vit", 2)])
def test_cli_seq_parallel_guards_warn_as_jax(model, seq, tmp_path, capsys):
    """``--seq-parallel`` on a model without a sequence axis, and on a
    ViT whose 49 patch tokens (28 x 28, patch 4) do not divide over it:
    JAX's warning, word for word, and the run goes on unsharded."""
    from split_learning_tpu.launch.run import main as jax_main
    from split_learning_tpu_torch.launch.run import main
    argv = ["train", "--model", model, "--dataset", "synthetic", "--steps",
            "1", "--batch-size", "4", "--tracking", "noop",
            "--seq-parallel", str(seq)]
    warns = []
    for runner, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        assert runner(argv + ["--data-dir", str(tmp_path / runner.__module__),
                              *extra]) == 0
        warns.append([ln for ln in capsys.readouterr().err.splitlines()
                      if ln.startswith("[warn] --seq-parallel")])
    assert warns[0] == warns[1] and len(warns[0]) == 1
