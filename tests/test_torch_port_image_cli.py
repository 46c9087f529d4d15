"""The image families on the port's CLI, on the CPU: ``train --model
resnet18|vit --dataset cifar10`` in every layout, over HTTP against
``serve``, the JAX command's refusals, and ``eval`` of ResNet-18 and ViT
checkpoints against JAX's.

The data directories hold a small synthetic CIFAR-10 (64 train and 16
test images) under the cache key both CLIs read. ``eval``'s records are
held as tests/test_torch_port_eval_generate_cli.py holds the CNN's: the
same keys, the accuracy and loss within 1e-4 (both round to 4 places).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest

from split_learning_tpu.launch.run import main as jax_main
from split_learning_tpu.runtime.checkpoint import Checkpointer as JaxCkpt
from split_learning_tpu_torch.data.datasets import (
    LocalStore, _to_blob, synthetic)
from split_learning_tpu_torch.interop import train_state_from_jax
from split_learning_tpu_torch.launch.run import _write_ckpt_meta, main
from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_resume_http import _Serve

FAMILIES = {"resnet18": [], "vit": ["--attn", "flash"]}
LAYOUTS = {"fused": [], "local": ["--transport", "local"],
           "local_int8": ["--transport", "local", "--compress", "int8"],
           "u_split": ["--mode", "u_split", "--transport", "local"],
           "federated": ["--mode", "federated", "--transport", "local"]}


def small_cifar(data_dir):
    """Seed ``data_dir``'s cache with a small synthetic CIFAR-10."""
    store = LocalStore(os.path.join(str(data_dir), "cache"))
    if not store.exists("datasets/cifar10-synthetic.npz"):
        store.put("datasets/cifar10-synthetic.npz", _to_blob(
            synthetic("cifar10", n_train=64, n_test=16)))
    return str(data_dir)


def _train(data_dir, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["train", "--device", "cpu", "--dataset", "cifar10",
                   "--data-dir", small_cifar(data_dir), "--batch-size", "4",
                   "--steps", "2", "--tracking", "noop", *flags])
    return rc, out.getvalue()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("model", list(FAMILIES))
def test_train_runs_every_layout(model, layout, tmp_path):
    rc, out = _train(tmp_path, "--model", model, *FAMILIES[model],
                     *LAYOUTS[layout])
    assert rc == 0
    done = [ln for ln in out.splitlines() if ln.startswith("[done]")]
    assert len(done) == 1
    mode = "u_split" if layout == "u_split" else (
        "federated" if layout == "federated" else "split")
    transport = "fused" if layout == "fused" else "local"
    assert f"mode={mode} transport={transport} steps=2" in done[0]
    loss = float(done[0].split("final_loss=")[1].split()[0])
    assert np.isfinite(loss)


@pytest.mark.parametrize("model", list(FAMILIES))
def test_train_over_http_against_serve(model, tmp_path):
    flags = ["--model", model, "--dataset", "cifar10", *FAMILIES[model]]
    srv = _Serve(tmp_path, *flags, "--data-dir", small_cifar(tmp_path))
    try:
        rc, out = _train(tmp_path, *flags[:2], *FAMILIES[model],
                         "--transport", "http", "--server-url", srv.url,
                         "--compress", "int8", "--wait-server", "30")
    finally:
        assert srv.stop() == 0
    assert rc == 0
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[transport]"))
    assert line.startswith("[transport] http compress=int8 round_trips=2 ")
    assert "transport=http steps=2" in out


@pytest.mark.parametrize("flags", [
    ["--model", "vit", "--dataset", "tokens"],
    ["--model", "resnet18", "--dataset", "cifar10", "--d-model", "64"],
    ["--model", "resnet18_4stage", "--dataset", "cifar10", "--mode",
     "u_split"]])
def test_refusals_match_jax(flags, tmp_path, capsys):
    argv = ["train", "--steps", "1", "--data-dir", str(tmp_path), *flags]
    assert jax_main(argv) == 2
    j_err = capsys.readouterr().err.splitlines()[-1]
    assert main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err.splitlines()[-1]
    assert err.startswith("[error] ") and err == j_err


def _record(runner, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("model", list(FAMILIES))
def test_eval_of_a_checkpoint_matches_jax(model, tmp_path):
    """JAX's CLI trains 2 fused steps into an Orbax checkpoint; its state
    crosses into a port checkpoint (``interop.train_state_from_jax``)
    with the port's meta; ``eval`` answers JAX's accuracy and loss."""
    data = small_cifar(tmp_path / "data")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = ["--model", model, "--dataset", "cifar10", "--batch-size", "4"]
    assert jax_main(["train", "--transport", "fused", "--steps", "2",
                     "--tracking", "noop", "--data-dir", data,
                     "--checkpoint-dir", jdir, *flags]) == 0
    ck = JaxCkpt(jdir)
    step = ck.latest_step()
    raw = jax.tree_util.tree_map(np.asarray, ck.restore_raw(step))
    ck.close()
    meta = json.load(open(os.path.join(jdir, "meta.json")))
    port = Checkpointer(pdir)
    port.save(step, {"trainer": train_state_from_jax(raw["trainer"])})
    port.close()
    _write_ckpt_meta(pdir, meta["layout"], Config(
        mode=meta["mode"], model=meta["model"], dataset=meta["dataset"]),
        meta.get("size_kw"))
    j = _record(jax_main, ["eval", "--checkpoint-dir", jdir, "--data-dir",
                           data, "--batch-size", "8"])
    p = _record(main, ["eval", "--device", "cpu", "--checkpoint-dir", pdir,
                       "--data-dir", data, "--batch-size", "8"])
    assert set(p) == set(j)
    for key in ("checkpoint_step", "dataset", "examples", "predictions"):
        assert p[key] == j[key], key
    assert p["examples"] == 16 and p["dataset"] == "cifar10"
    for key in ("accuracy", "loss"):
        assert abs(p[key] - j[key]) <= 1e-4 + 1e-9, (key, p[key], j[key])
