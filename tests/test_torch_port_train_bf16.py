"""bfloat16 training and the full optimizer in the fused trainer, against
the JAX trainer, on the CPU.

Both start from one flax init of a ``dtype="bfloat16"`` plan (float32
parameters, a bfloat16 ``pos`` table), carried across with
``split_learning_tpu_torch.interop``, and see the same seeded batches.
The JAX references, as in tests/test_torch_port_train_transformer.py:

- ``transformer`` and the CNN: ``Config(kernels="pallas")``, the
  float32 fused cross-entropy over bfloat16 logits (K1's arithmetic)
  and, for constant-lr SGD, the float32-trace Pallas SGD (K2's); the
  kernels run in interpret mode;
- ``transformer_lm``: ``Config(kernels="xla")``: JAX's
  ``fused_cross_entropy`` takes 2-D logits only, so its trainer runs
  optax's cross-entropy, in bfloat16 on the bfloat16 logits, where the
  port's K1 computes in float32.

Configurations: SGD at lr 0.02 with momentum 0.9, and AdamW (weight decay 0.1)
with warmup 2, cosine decay to step 8 and clipping at 1.0 (the
transformer families' standard recipe in the JAX ``make_tx``), each
with ``attn`` full and flash; 8 steps. The classifier and the CNN are
here; the LM and the float32 AdamW series are in
tests/test_torch_port_train_bf16_lm.py, which shares these helpers.

Tolerance of the bfloat16 loss series: 2 bfloat16 ulps at the loss's
magnitude, ``2 * 2**(floor(log2(loss)) - 7)``: 0.0625 for losses in
[4, 8) (the LM at vocab 64), 0.03125 in [2, 4) (10 classes). The
activations and logits are bfloat16, each rounded to 8 significant bits
at its own magnitude, and the two frameworks round at other places
(XLA fuses and may keep excess precision; PyTorch rounds each op), so
one logit differs by an ulp or two at this size (the serving test holds
them to 1e-1). The cross-entropy of such logits moves by about as much
as one logit does, and the LM's optax loss is itself rounded to
bfloat16, an ulp of the loss. Eight updates later the parameters have
moved by less than the rounding: the largest gap observed is 0.030 at a
loss of 6.28 (the CNN's third step). For scale, JAX's own bfloat16
series differs from its float32 one by up to 0.18 here.

The CLI half runs ``train --device cpu`` on the fused and the local
transport with every new flag, and ``--trace``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

B, T, V, STEPS = 4, 16, 64, 8
SIZE = dict(vocab=V, d_model=32, num_heads=2, client_depth=1,
            server_depth=1, max_len=64)
KERNELS = {"transformer": "pallas", "transformer_lm": "xla",
           "split_cnn": "pallas"}
OPTIM = {
    "sgd_momentum": dict(lr=0.02, momentum=0.9),
    "adamw_recipe": dict(optimizer="adamw", lr=3e-3, weight_decay=0.1,
                         warmup_steps=2, decay_steps=8, grad_clip_norm=1.0),
}


def bf16_loss_tol(loss: float) -> float:
    """Two bfloat16 ulps at ``loss``'s magnitude."""
    return 2 * 2.0 ** (math.floor(math.log2(abs(loss))) - 7)


def _data(model):
    if model == "split_cnn":
        ds = jds.synthetic("mnist", n_train=16 * STEPS, n_test=16, seed=3)
        return list(jds.batches(ds.train, 16, seed=3))
    make = jds.synthetic_lm if model == "transformer_lm" \
        else jds.synthetic_tokens
    ds = make(n_train=B * STEPS, n_test=B, vocab=V, seq_len=T, seed=4)
    return list(jds.batches(ds.train, B, seed=4))


def _pair(model, attn, dtype, optim):
    data = _data(model)
    size = SIZE if model != "split_cnn" else {}
    if model != "split_cnn":
        size = dict(size, attn=attn)
    kw = dict(model=model, batch_size=len(data[0][1]), dtype=dtype,
              **OPTIM[optim])
    jtrainer = JaxFusedSplitTrainer(
        jax_get_plan(model=model, dtype=dtype, **size),
        JaxConfig(kernels=KERNELS[model], **kw), jax.random.PRNGKey(0),
        jnp.asarray(data[0][0]))
    trainer = FusedSplitTrainer(
        get_plan(model=model, dtype=dtype, **size),
        Config(transport="fused", **kw), params_from_jax(jtrainer.params),
        data[0][0], device="cpu")
    j_losses = [jtrainer.train_step(x, y) for x, y in data]
    losses = [trainer.train_step(x, y) for x, y in data]
    return np.asarray(losses), np.asarray(j_losses), trainer


BF16_CASES = [("transformer", a, o) for a in ("full", "flash")
              for o in OPTIM] + [("split_cnn", "full", o) for o in OPTIM]


def assert_bf16_run_tracks_jax(model, attn, optim):
    losses, j_losses, trainer = _pair(model, attn, "bfloat16", optim)
    tol = np.array([bf16_loss_tol(v) for v in j_losses])
    gap = np.abs(losses - j_losses)
    assert (gap <= tol).all(), (gap, tol)
    assert losses[-1] < losses[0]
    # float32 leaves stay float32 and the pos table bfloat16, as flax's
    for stage in trainer.params:
        for k, v in stage.items():
            assert str(v.dtype) == ("torch.bfloat16" if k == "pos"
                                    else "torch.float32"), k


@pytest.mark.parametrize("model,attn,optim", BF16_CASES)
def test_bf16_training_tracks_jax(model, attn, optim):
    assert_bf16_run_tracks_jax(model, attn, optim)


def _cli_lm(tmp_path, *extra):
    return ["train", "--device", "cpu", "--model", "transformer_lm",
            "--dataset", "lm", "--seq-len", "16", "--d-model", "32",
            "--num-heads", "2", "--client-depth", "1", "--server-depth",
            "1", "--attn", "flash", "--batch-size", "4", "--steps", "6",
            "--data-dir", str(tmp_path), "--tracking", "stdout", *extra]


def _first_and_final_loss(out):
    lines = out.splitlines()
    first = next(ln for ln in lines if ln.startswith("[step 0] loss:"))
    done = next(ln for ln in lines if ln.startswith("[done]"))
    assert " steps=6 " in done, done
    return (float(first.split(":")[1]),
            float(done.split("final_loss=")[1].split()[0]))


@pytest.mark.parametrize("transport", ["fused", "local"])
@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16", "--optimizer", "adamw", "--lr", "3e-3",
     "--weight-decay", "0.1", "--warmup-steps", "2", "--decay-steps", "6",
     "--grad-clip-norm", "1.0"],
    ["--optimizer", "adam", "--lr", "3e-3"],
    ["--dtype", "bfloat16", "--momentum", "0.9", "--weight-decay", "0.01",
     "--warmup-steps", "2", "--lr", "0.1"],
])
def test_cli_train_takes_the_optimizer_flags(transport, flags, tmp_path,
                                             capsys):
    rc = main(_cli_lm(tmp_path, "--transport", transport, *flags))
    out = capsys.readouterr().out
    assert rc == 0
    assert all(np.isfinite(_first_and_final_loss(out)))


def test_cli_trace_writes_its_file(tmp_path, capsys):
    path = tmp_path / "run.trace.json"
    rc = main(_cli_lm(tmp_path, "--transport", "local", "--trace",
                      str(path)))
    assert rc == 0
    assert "[trace]" in capsys.readouterr().err
    names = {e["name"] for e in json.loads(path.read_text())}
    assert {"client_fwd", "transport", "opt_apply"} <= names


@pytest.mark.parametrize("flags,msg", [
    (["--optimizer", "adam", "--weight-decay", "0.1"], "adamw"),
    (["--optimizer", "adamw", "--momentum", "0.9"], "momentum"),
    (["--warmup-steps", "5", "--decay-steps", "4"], "decay_steps"),
])
def test_cli_refuses_inconsistent_optimizer_flags(flags, msg, tmp_path,
                                                  capsys):
    assert main(_cli_lm(tmp_path, *flags)) == 2
    assert msg in capsys.readouterr().err
