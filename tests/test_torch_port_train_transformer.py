"""The port's FusedSplitTrainer on the transformer families against the
JAX trainer, on the CPU.

Both start from one flax init, carried across with
``split_learning_tpu_torch.interop``, and see the same seeded batches
of the JAX package's token datasets. The JAX references:

- ``transformer`` (``[B, 10]`` logits): ``Config(kernels="pallas")``,
  so the fused cross-entropy, the fused SGD and, with ``attn="flash"``,
  the flash forward and backward run as Pallas kernels in interpret
  mode;
- ``transformer_lm``: ``Config(kernels="xla")``. JAX's
  ``fused_cross_entropy`` takes 2-D logits only and raises on the LM's
  ``[B, T, V]``, so its trainer runs optax's CE (the mean over all B*T
  tokens) and optax's SGD, with the Pallas flash kernels in interpret
  mode under ``attn="flash"``.

The port runs its kernels' plain versions here (the cross-entropy over
the logits flattened to rows). Bars, as tests/test_torch_port_fused.py:
loss series within 1e-4 (tests/test_torch_parity.py's training-curve
bar) and final params within rtol 1e-4 / atol 1e-6 (tests/test_ops.py's
Pallas-vs-XLA trainer bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

B, T, V, STEPS, LR = 4, 16, 64, 3, 0.1
SIZE = dict(vocab=V, d_model=32, num_heads=2, client_depth=1,
            server_depth=1, max_len=64)
# tok, pos, two blocks of 16 and a head of 4 (LN, Dense), in either mode
LEAVES = 2 + 2 * 16 + 4
DATASET = {"transformer": jds.synthetic_tokens,
           "transformer_lm": jds.synthetic_lm}
KERNELS = {"transformer": "pallas", "transformer_lm": "xla"}


def _data(model):
    ds = DATASET[model](n_train=B * STEPS, n_test=B, vocab=V, seq_len=T,
                        seed=4)
    return list(jds.batches(ds.train, B, seed=4))


@pytest.mark.parametrize("model,attn,mode,momentum,microbatches", [
    ("transformer", "flash", "split", 0.0, 1),
    ("transformer", "full", "split", 0.0, 1),
    ("transformer", "flash", "u_split", 0.0, 1),
    ("transformer", "full", "u_split", 0.0, 1),
    ("transformer", "flash", "split", 0.9, 1),
    ("transformer_lm", "flash", "split", 0.0, 1),
    ("transformer_lm", "full", "split", 0.0, 1),
    ("transformer_lm", "flash", "u_split", 0.0, 1),
    ("transformer_lm", "full", "u_split", 0.0, 1),
    ("transformer_lm", "flash", "split", 0.0, 2),
])
def test_transformer_trainer_matches_jax(model, attn, mode, momentum,
                                         microbatches):
    data = _data(model)
    kw = dict(mode=mode, model=model, attn=attn, batch_size=B, lr=LR,
              momentum=momentum, microbatches=microbatches)
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(model=model, mode=mode, attn=attn, **SIZE),
        JaxConfig(kernels=KERNELS[model], **kw), jax.random.PRNGKey(0),
        jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(model=model, mode=mode, attn=attn, **SIZE),
        Config(transport="fused", **kw), params_from_jax(jtrainer.params),
        data[0][0], device="cpu")

    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)
    assert losses[-1] < losses[0]

    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jtrainer.params))
    got = jax.tree_util.tree_leaves(params_to_jax(trainer.params))
    assert len(got) == len(want) == LEAVES
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)



def test_lm_train_epoch_equals_train_steps():
    """``train_epoch`` over ``[S, B, T]`` token ids is the step loop."""
    data = _data("transformer_lm")
    cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                 batch_size=B, lr=LR, momentum=0.9)
    plan = get_plan(model="transformer_lm", attn="flash", **SIZE)
    a, b = (FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(2),
                              data[0][0], device="cpu") for _ in range(2))
    stepwise = [a.train_step(x, y) for x, y in data]
    series = b.train_epoch(np.stack([x for x, _ in data]),
                           np.stack([y for _, y in data]))
    assert series.tolist() == stepwise
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
