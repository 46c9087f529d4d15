"""The ``seq`` axis as JAX lays it out, alone and with the ``model``
axis, against JAX's meshed trainer on the CPU: the LM.

JAX puts a step's inputs on ``P(data, seq)``: every op but the attention
runs on a rank's T/n tokens, and GSPMD composes that with the ``model``
axis. The port partitions the step itself (``parallel/tensor.py``
``SeqBlocks``): each seq rank embeds, normalises, projects and takes its
loss on its own tokens, on its copy of the parameters (``seq_view``,
whose backward sums the ranks' gradients), and only the attention moves
blocks between ranks. JAX runs on the 8 CPU devices tests/conftest.py
forces (flash in Pallas interpret mode), the port on CPU ranks; both
start from one flax init (``interop.params_from_jax``) and numpy-seeded
batches.

- the LM at ``model 2 x seq 2`` and ``data 2 x model 2 x seq 2`` with
  ``ring``, ``ring_flash`` and ``ulysses``: 12-step losses within 1e-4
  of JAX's; Ulysses on each model rank's heads where they divide over
  ``seq``.

The ViT, bf16, hooks, checkpoint, FLOP and ``attn="auto"`` cases are in
tests/test_torch_port_seq_model_parts.py, which imports these helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.ops import ring_attention as ra
from split_learning_tpu_torch.parallel.mesh import make_mesh
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

STEPS, BATCH, T, VOCAB = 12, 8, 16, 32
LM = dict(vocab=VOCAB, d_model=16, num_heads=2, client_depth=1,
          server_depth=1)
VIT = dict(d_model=16, num_heads=2, client_depth=1, server_depth=1)
MESHES = {"model2_seq2": (1, 2, 2), "data2_model2_seq2": (2, 2, 2)}


def _lm_data(n=STEPS, seed=0, batch=BATCH):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, VOCAB, (batch, T)).astype(np.int32),
             rs.randint(0, VOCAB, (batch, T)).astype(np.int64))
            for _ in range(n)]


def _img_data(n=STEPS, seed=0, side=16):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, side, side, 1).astype(np.float32),
             rs.randint(0, 10, (BATCH,)).astype(np.int64))
            for _ in range(n)]


def _cfg_kw(shape, **kw):
    d, m, s = shape
    return {**dict(batch_size=BATCH, num_clients=d, model_parallel=m,
                   seq_parallel=s, lr=0.05), **kw}


def _pair(model, size, data, shape):
    """JAX's meshed trainer and the port's on a (data, model, seq) mesh
    of ``shape``, from one init."""
    d, m, s = shape
    jmesh = jax_make_mesh(num_clients=d, model_parallel=m, seq_parallel=s,
                          devices=jax.devices()[:d * m * s])
    jtr = JaxFusedSplitTrainer(
        jax_get_plan(model=model, mesh=jmesh, **size),
        JaxConfig(**_cfg_kw(shape)), jax.random.PRNGKey(0),
        jnp.asarray(data[0][0]), mesh=jmesh)
    mesh = make_mesh(num_clients=d, model_parallel=m, seq_parallel=s,
                     device="cpu")
    tr = FusedSplitTrainer(get_plan(model=model, mesh=mesh, **size),
                           Config(transport="fused", **_cfg_kw(shape)),
                           params_from_jax(jax.device_get(jtr.params)),
                           data[0][0], mesh=mesh)
    return jtr, tr


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("attn", ["ring", "ring_flash", "ulysses"])
def test_lm_on_model_and_seq_matches_jax(attn, mesh_name):
    data = _lm_data()
    jtr, tr = _pair("transformer_lm", dict(LM, attn=attn), data,
                    MESHES[mesh_name])
    want = [jtr.train_step(x, y) for x, y in data]
    got = [tr.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert tr.state.step == STEPS


def test_ulysses_on_each_model_ranks_heads(monkeypatch):
    """4 heads at ``model 2 x seq 2``: a model rank's 2 heads divide over
    the seq ranks, so each model rank runs Ulysses on its own heads (q,
    k and v projected once a model rank and seq rank), to JAX's
    12-step losses."""
    data = _lm_data()
    size = dict(LM, num_heads=4, attn="ulysses")
    jtr, tr = _pair("transformer_lm", size, data, (1, 2, 2))
    calls = []
    monkeypatch.setattr(ra, "_ulysses", lambda qs, *a, _u=ra._ulysses, **k:
                        calls.append(qs[0].shape) or _u(qs, *a, **k))
    want = [jtr.train_step(x, y) for x, y in data]
    got = [tr.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a block of [B, T/2, 2 heads, d] once a model rank and layer a step
    assert calls[:4] == [(BATCH, T // 2, 2, 4)] * 4
