"""bfloat16 training of the causal LM and the float32 AdamW recipe in the
fused trainer, against the JAX trainer, on the CPU.

The LM half of tests/test_torch_port_train_bf16.py, whose docstring
gives the references and derives the bfloat16 tolerance (two bfloat16
ulps at the loss's magnitude): ``transformer_lm`` in bfloat16 with
``attn`` full and flash, under SGD with momentum and under AdamW with
warmup, cosine decay and clipping, against JAX's ``kernels="xla"``
trainer (optax's cross-entropy in bfloat16). Then the same AdamW recipe
in float32 on the classifier, the LM and the CNN, held to the float32
bar of the trainer tests, 1e-4.
"""

import numpy as np
import pytest

from test_torch_port_train_bf16 import OPTIM, _pair, assert_bf16_run_tracks_jax


@pytest.mark.parametrize("optim", sorted(OPTIM))
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_bf16_lm_training_tracks_jax(attn, optim):
    assert_bf16_run_tracks_jax("transformer_lm", attn, optim)


@pytest.mark.parametrize("model", ["transformer", "transformer_lm",
                                   "split_cnn"])
def test_float32_adamw_recipe_tracks_jax(model):
    losses, j_losses, _ = _pair(model, "flash", "float32", "adamw_recipe")
    np.testing.assert_allclose(losses, j_losses, atol=1e-4)
    assert losses[-1] < losses[0]
