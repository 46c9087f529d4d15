"""``train --scan-steps`` and ``--remat`` in the port, on the CPU.

- **Scan.** The CLI's ``--scan-steps 4`` logs the stepwise run's losses
  (and, under a schedule, its lrs) bit for bit, the tail of each epoch
  stepwise; seeded with JAX's init (``interop``), it tracks JAX's own
  ``--scan-steps 4`` run within JAX's 2e-3 (tests/test_cli.py); under
  ``--checkpoint-every`` both CLIs cap the chunk with the same warning
  and save at the same steps; a cap to 1 is the stepwise loop; other
  transports warn and ignore the flag.
- **Remat.** ``remat_plan`` trains bit-equal to the plain plan on the
  CPU (the CNN and the flash-attention LM), and within 1e-4 of JAX's
  ``remat_plan`` trainer from the same init (tests/test_precision_
  remat.py's bar); the LM's flash forward runs twice a block a step
  under remat (K5's 6 launches a step on the card, 3 without), its
  backward and the loss once; ``step_flops`` does not count the
  recompute; ``serve --remat`` rematerialises the served stage and an
  HTTP client trains against it.
"""

import os
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.launch.run import main as jax_main
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import checkpoint as jax_ckpt
from split_learning_tpu.runtime.fused import FusedSplitTrainer as JaxFused
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.launch import run
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.ops import cross_entropy as ce_mod
from split_learning_tpu_torch.ops import flash_attention as fa_mod
from split_learning_tpu_torch.runtime import checkpoint as ckpt_mod
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config
from test_torch_port_resume import (
    LAYOUTS, seed_from_jax, small_data, take_losses)

CNN = LAYOUTS["fused_cnn"][0]
LM = LAYOUTS["fused_lm"][0]
LM_SIZE = dict(d_model=32, num_heads=2, client_depth=1, server_depth=2,
               vocab=64, attn="flash")


def _port(data_dir, flags, *extra):
    rc = main(["train", "--device", "cpu", "--data-dir",
               small_data(data_dir), "--tracking", "jsonl", *flags, *extra])
    assert rc == 0
    losses = take_losses(data_dir)
    return losses


def _port_with_lr(tmp_path, flags, *extra):
    d = small_data(tmp_path)
    assert main(["train", "--device", "cpu", "--data-dir", d, "--tracking",
                 "jsonl", *flags, *extra]) == 0
    import json
    folder = os.path.join(d, "metrics")
    (name,) = os.listdir(folder)
    recs = [json.loads(line) for line in open(os.path.join(folder, name))]
    os.remove(os.path.join(folder, name))
    return [(r["key"], r["step"], r["value"]) for r in recs
            if r["key"] in ("loss", "lr")]


@pytest.mark.parametrize("flags,extra", [
    (CNN, ["--epochs", "2", "--steps", "7"]),     # 4 a chunk, tail of 3
    (LM, ["--epochs", "1", "--steps", "7"]),      # the schedule's lrs too
])
def test_scan_steps_bit_equal_to_stepwise(flags, extra, tmp_path):
    stepwise = _port_with_lr(tmp_path / "a", flags, *extra)
    scanned = _port_with_lr(tmp_path / "b", flags, *extra,
                            "--scan-steps", "4")
    assert scanned == stepwise
    assert [s for k, s, _ in stepwise if k == "loss"] == list(range(7))
    assert any(k == "lr" for k, _, _ in stepwise) == (flags is LM)


def test_scan_steps_tracks_jaxs_scan(tmp_path):
    """The port's scanned run from JAX's init (a port checkpoint at step
    0 resumed) against JAX's CLI with ``--scan-steps 4``, two epochs."""
    ck = tmp_path / "ck"
    seed_from_jax(ck, CNN, "fused")
    losses = _port(tmp_path / "p", CNN, "--epochs", "2", "--scan-steps",
                   "4", "--checkpoint-dir", str(ck), "--resume")
    assert jax_main(["train", "--data-dir", small_data(tmp_path / "j"),
                     "--tracking", "jsonl", "--epochs", "2",
                     "--scan-steps", "4", *CNN]) == 0
    j_losses = take_losses(tmp_path / "j")
    assert len(losses) == len(j_losses) == 8
    np.testing.assert_allclose(losses, j_losses, atol=2e-3)


def _saved_steps(monkeypatch, cls, method):
    seen = []
    real = getattr(cls, method)

    def record(self, step, *a, **kw):
        if step not in seen:
            seen.append(step)
        return real(self, step, *a, **kw)
    monkeypatch.setattr(cls, method, record)
    return seen


def test_scan_steps_capped_to_checkpoint_every_as_jax(tmp_path, capsys,
                                                      monkeypatch):
    argv = [*CNN, "--epochs", "3", "--steps", "10", "--scan-steps", "8",
            "--checkpoint-every", "3"]
    port_saves = _saved_steps(monkeypatch, ckpt_mod.Checkpointer, "save")
    _port(tmp_path / "p", argv, "--checkpoint-dir", str(tmp_path / "pc"))
    port_err = capsys.readouterr().err
    jax_saves = _saved_steps(monkeypatch, jax_ckpt.Checkpointer, "save_once")
    assert jax_main(["train", "--data-dir", small_data(tmp_path / "j"),
                     "--tracking", "jsonl", *argv, "--checkpoint-dir",
                     str(tmp_path / "jc")]) == 0
    jax_err = capsys.readouterr().err
    warning = ("[warn] --scan-steps 8 capped to --checkpoint-every 3 so "
               "checkpoint cadence is preserved")
    assert warning in port_err and warning in jax_err
    assert port_saves == jax_saves and port_saves
    assert 3 in port_saves and 10 in port_saves


def test_scan_capped_to_one_is_the_stepwise_loop(tmp_path, monkeypatch):
    calls = []
    real = FusedSplitTrainer.train_epoch
    monkeypatch.setattr(FusedSplitTrainer, "train_epoch",
                        lambda self, *a: calls.append(1) or real(self, *a))
    stepwise = _port(tmp_path / "a", CNN, "--steps", "3")
    capped = _port(tmp_path / "b", CNN, "--steps", "3", "--scan-steps", "4",
                   "--checkpoint-every", "1", "--checkpoint-dir",
                   str(tmp_path / "ck"))
    assert capped == stepwise and calls == []
    _port(tmp_path / "c", CNN, "--steps", "4", "--scan-steps", "2")
    assert len(calls) == 2


def test_scan_steps_ignored_off_the_fused_transport(tmp_path, capsys):
    _port(tmp_path, ["--transport", "local", "--dataset", "synthetic",
                     "--batch-size", "128"], "--steps", "2", "--scan-steps",
          "4")
    assert ("[warn] --scan-steps ignored on transport='local' (only the "
            "fused transport scans steps)") in capsys.readouterr().err


# --------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------- #

def _batches(kind, n=4, seed=4):
    rs = np.random.RandomState(seed)
    if kind == "cnn":
        return [(rs.randn(16, 28, 28, 1).astype(np.float32),
                 rs.randint(0, 10, (16,)).astype(np.int64))
                for _ in range(n)]
    return [(rs.randint(0, 64, (4, 16)).astype(np.int32),
             rs.randint(0, 64, (4, 16)).astype(np.int64)) for _ in range(n)]


def _port_trainer(kind, remat, init=None):
    if kind == "cnn":
        plan, cfg = get_plan(), Config(transport="fused", batch_size=16,
                                       remat=remat)
    else:
        plan = get_plan(model="transformer_lm", **LM_SIZE)
        cfg = Config(transport="fused", model="transformer_lm",
                     attn="flash", batch_size=4, optimizer="adamw",
                     lr=3e-3, remat=remat)
    return FusedSplitTrainer(plan, cfg, init if init is not None
                             else torch.Generator().manual_seed(0), None,
                             device="cpu")


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_remat_bit_equal_to_plain(kind):
    data = _batches(kind)
    plain, remat = _port_trainer(kind, False), _port_trainer(kind, True)
    assert all(s.remat for s in remat.plan.stages)
    assert not any(s.remat for s in plain.plan.stages)
    assert [plain.train_step(x, y) for x, y in data] == [
        remat.train_step(x, y) for x, y in data]
    for a, b in zip(plain.params, remat.params):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_remat_tracks_jaxs_remat_plan():
    data = _batches("cnn", n=6)
    j = JaxFused(jax_get_plan(mode="split"),
                 JaxConfig(mode="split", batch_size=16, remat=True),
                 jax.random.PRNGKey(11), jnp.asarray(data[0][0]))
    port = _port_trainer("cnn", True, init=params_from_jax(j.params))
    j_losses = [j.train_step(x, y) for x, y in data]
    losses = [port.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-4)


def test_remat_runs_the_flash_forward_twice_a_block(monkeypatch):
    counts = {"fwd": 0, "bwd": 0, "ce": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fa_mod, "flash_attention_with_lse_plain", counting(
        "fwd", fa_mod.flash_attention_with_lse_plain))
    monkeypatch.setattr(fa_mod, "flash_attention_bwd_plain", counting(
        "bwd", fa_mod.flash_attention_bwd_plain))
    # the loss's CPU path (K1's forward on the card)
    monkeypatch.setattr(ce_mod, "cross_entropy", counting(
        "ce", ce_mod.cross_entropy))
    blocks = LM_SIZE["client_depth"] + LM_SIZE["server_depth"]
    (x, y), = _batches("lm", n=1)
    for remat, fwd in ((False, blocks), (True, 2 * blocks)):
        for k in counts:
            counts[k] = 0
        _port_trainer("lm", remat).train_step(x, y)
        assert counts == {"fwd": fwd, "bwd": blocks, "ce": 1}, remat


@pytest.mark.parametrize("kind", ["cnn", "lm"])
def test_step_flops_does_not_count_the_recompute(kind):
    (x, y), = _batches(kind, n=1)
    assert _port_trainer(kind, True).step_flops(x, y) == \
        _port_trainer(kind, False).step_flops(x, y)


def test_serve_remat_trains(tmp_path, monkeypatch, capsys):
    got = {}
    real = run.serve_party

    def serve_party(args):
        out = real(args)
        got["runtime"], got["url"] = out[0], out[1].url
        return out

    class Clock:
        def sleep(self, _):
            with urllib.request.urlopen(got["url"] + "/health",
                                        timeout=10) as r:
                got["health"] = r.status
            got["rc"] = main(["train", "--device", "cpu", "--transport",
                              "http", "--server-url", got["url"],
                              "--steps", "3", "--dataset", "synthetic",
                              "--data-dir", str(tmp_path), "--tracking",
                              "noop", "--remat"])
            raise KeyboardInterrupt

        def __getattr__(self, name):
            return getattr(time, name)
    monkeypatch.setattr(run, "serve_party", serve_party)
    monkeypatch.setattr(run, "time", Clock())
    assert main(["serve", "--device", "cpu", "--port", "0", "--remat"]) == 0
    assert got["rc"] == 0 and got["health"] == 200
    assert got["runtime"]._stage.remat and got["runtime"].cfg.remat
    out = capsys.readouterr().out
    assert "[transport] http compress=none round_trips=3" in out
    assert "final_loss=" in out and "nan" not in out.split("final_loss=")[1]
