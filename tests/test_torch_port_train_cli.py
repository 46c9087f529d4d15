"""Around the port's transformer training, on the CPU: the cross-entropy
over ``[B, T, V]`` logits against JAX's loss, gradients through the
embedding, the trainer's config check, and the ``train`` CLI on the
transformer families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.core.losses import cross_entropy as jax_ce
from split_learning_tpu_torch.models.transformer import Embed
from split_learning_tpu_torch.ops.cross_entropy import (
    CrossEntropyFunction, fused_cross_entropy)
from split_learning_tpu_torch.runtime.fused import check_supported
from split_learning_tpu_torch.utils.config import Config


def _lm_logits(b=3, t=5, v=11, seed=0):
    rs = np.random.RandomState(seed)
    return (3 * rs.randn(b, t, v)).astype(np.float32), rs.randint(
        0, v, (b, t)).astype(np.int64)


def test_cross_entropy_over_tokens_matches_jax():
    """Mean over every label element, as optax's; the value and the
    gradient, on the plain path and on the kernel's row form."""
    x, y = _lm_logits()
    want, want_g = jax.value_and_grad(jax_ce)(jnp.asarray(x), jnp.asarray(y))
    logits = torch.from_numpy(x).requires_grad_(True)
    loss = fused_cross_entropy(logits, torch.from_numpy(y))
    (g,) = torch.autograd.grad(loss, logits)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), atol=1e-7)
    # what the card runs: the kernels' math over [B*T, V] rows
    rows = CrossEntropyFunction.apply(logits.reshape(-1, 11),
                                      torch.from_numpy(y).reshape(-1))
    (g_rows,) = torch.autograd.grad(rows, logits)
    np.testing.assert_allclose(rows.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(g_rows.numpy(), np.asarray(want_g), atol=1e-7)


def test_cross_entropy_rejects_mismatched_labels():
    x, y = _lm_logits()
    with pytest.raises(ValueError, match="labels"):
        fused_cross_entropy(torch.from_numpy(x), torch.from_numpy(y[:, :-1]))


def test_embedding_gradient_skips_out_of_range_rows():
    """An id outside [-V, V) gives a NaN row (jnp.take's fill); the
    masked_fill that writes it passes no gradient back, so the table's
    gradient is that of the valid ids alone and stays finite."""
    emb = Embed(7, 4, torch.float32)
    table = torch.randn(7, 4, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1, 9, -2, 3], [-8, 1, 0, 6]])
    valid = (ids >= -7) & (ids < 7)
    w = table.clone().requires_grad_(True)
    out = torch.func.functional_call(emb, {"weight": w}, (ids,))
    assert torch.isnan(out[~valid]).all() and torch.isfinite(out[valid]).all()
    (g,) = torch.autograd.grad(out[valid].sum(), w)
    want = torch.zeros(7, 4)
    for i in ids[valid].tolist():
        want[i % 7] += 1.0
    assert torch.equal(g, want)


@pytest.mark.parametrize("model", ["transformer", "transformer_lm"])
@pytest.mark.parametrize("attn", ["full", "flash"])
def test_trainer_accepts_transformer_families(model, attn):
    check_supported(Config(transport="fused", model=model, attn=attn))


def _cli(*argv):
    from split_learning_tpu_torch.launch.run import main
    return main(["train", "--device", "cpu", "--tracking", "noop", *argv])


@pytest.mark.parametrize("model,dataset", [("transformer_lm", "lm"),
                                           ("transformer", "tokens")])
def test_cli_trains_transformer_on_cpu(model, dataset, tmp_path, capsys):
    rc = _cli("--model", model, "--dataset", dataset, "--seq-len", "32",
              "--d-model", "32", "--num-heads", "2", "--server-depth", "1",
              "--attn", "flash", "--steps", "3", "--batch-size", "4",
              "--lr", "0.1", "--eval", "--data-dir", str(tmp_path))
    out = capsys.readouterr().out
    assert rc == 0
    n = 512 * (32 if model == "transformer_lm" else 1)   # test labels
    assert "[eval] accuracy=" in out and f"n={n}" in out
    assert "steps=3 final_loss=" in out
    assert (tmp_path / "cache" / "datasets"
            / f"{dataset}-synthetic-t32.npz").exists()


@pytest.mark.parametrize("argv,msg", [
    (["--model", "split_cnn", "--dataset", "lm"], "token-shaped"),
    (["--dataset", "synthetic", "--seq-len", "16"], "--seq-len applies"),
    (["--model", "transformer_lm", "--dataset", "lm", "--seq-len", "0"],
     "must be positive"),
    (["--dataset", "synthetic", "--d-model", "32"], "no size overrides"),
    *((["--model", "transformer_lm", "--dataset", "lm", "--attn", attn],
       item) for attn, item in (("auto", "crossover"), ("ring", "item 21"),
                                ("ulysses", "item 21"))),
])
def test_cli_refuses_before_loading_data(argv, msg, tmp_path, capsys):
    assert _cli(*argv, "--steps", "1", "--data-dir", str(tmp_path)) == 2
    assert msg in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_cli_warns_that_a_cnn_ignores_attn(tmp_path, capsys):
    rc = _cli("--dataset", "synthetic", "--attn", "flash", "--steps", "1",
              "--batch-size", "8", "--data-dir", str(tmp_path))
    assert rc == 0
    assert "--attn 'flash' ignored" in capsys.readouterr().err
