"""``train --checkpoint-dir ... --resume`` on the CPU, layout by layout,
against the uninterrupted run and against JAX's CLI.

Layouts (``meta.json``'s): ``fused`` (the CNN, and the small causal LM,
d_model 32, 2 heads, 1 + 1 blocks, T 16, under AdamW with warmup,
cosine decay and clipping), ``u_split_local`` (the U-shaped CNN on the
local wire) and ``federated`` (one client and the in-process server);
``split_local`` on ``none``/``int8``/``topk8`` is in
tests/test_torch_port_resume_split.py and the HTTP resume in
tests/test_torch_port_resume_http.py; both share these helpers.
Each data directory's cache is seeded with smaller synthetic sets under
the keys both CLIs read (512 CNN and 512 LM training examples, 64 test
ones), so an epoch is 4 CNN steps at batch 128 or 8 LM steps at batch
64.

- **The uninterrupted run.** One epoch, then ``--resume`` for one more,
  gives the loss series of two epochs in one run, bit for bit: the
  state, the optimizer and the schedule's count come back, the
  in-process server's handshake is re-armed, and the data stream
  resumes at the second epoch's shuffle.
- **JAX's run.** The port's checkpoint is seeded with JAX's init (the
  states JAX's CLI builds from ``--seed``, carried by
  ``interop.train_state_from_jax``) at step 0; two resumed epochs of the
  port then track JAX's CLI training two epochs from that init within
  1e-4 (1e-3 on the int8 and topk8 wires). JAX's own ``--resume`` is
  not the comparison: it restarts the data stream at the first epoch's
  shuffle, and its client drops the up-direction topk8 ledger.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.launch.run import main as jax_main
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import FederatedClientTrainer as JaxFedClient
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.runtime import USplitClientTrainer as JaxUClient
from split_learning_tpu.runtime.fused import FusedSplitTrainer as JaxFused
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.data.datasets import (
    LocalStore, _to_blob, synthetic, synthetic_lm)
from split_learning_tpu_torch.interop import train_state_from_jax
from split_learning_tpu_torch.launch.run import _write_ckpt_meta, main
from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
from split_learning_tpu_torch.utils.config import Config

LM_FLAGS = ["--model", "transformer_lm", "--dataset", "lm", "--seq-len",
            "16", "--d-model", "32", "--num-heads", "2", "--client-depth",
            "1", "--server-depth", "1", "--batch-size", "64",
            "--optimizer", "adamw", "--lr", "3e-3", "--weight-decay", "0.1",
            "--warmup-steps", "4", "--decay-steps", "16",
            "--grad-clip-norm", "1.0"]
CNN_FLAGS = ["--dataset", "synthetic", "--batch-size", "128", "--lr", "0.02"]
# layout -> (flags of both CLIs, the JAX parties whose init seeds the port)
LAYOUTS = {
    "fused_cnn": (["--transport", "fused", *CNN_FLAGS], "fused"),
    "fused_lm": (["--transport", "fused", *LM_FLAGS], "fused"),
    "u_split_local": (["--mode", "u_split", "--transport", "local",
                       "--dataset", "synthetic", "--batch-size", "128",
                       "--lr", "0.002"], "u_split_local"),
    "federated": (["--mode", "federated", "--transport", "local",
                   *CNN_FLAGS], "federated"),
    "split_none": (["--transport", "local", "--compress", "none",
                    *CNN_FLAGS], "split_local"),
    "split_int8": (["--transport", "local", "--compress", "int8",
                    *CNN_FLAGS], "split_local"),
    "split_topk8": (["--transport", "local", "--compress", "topk8",
                     *CNN_FLAGS], "split_local"),
}
TOL = {"split_int8": 1e-3, "split_topk8": 1e-3}


def small_data(data_dir):
    """Seed ``data_dir``'s cache with the small sets (both CLIs read the
    same keys and blobs)."""
    store = LocalStore(os.path.join(str(data_dir), "cache"))
    if not store.exists("datasets/synthetic-synthetic.npz"):
        store.put("datasets/synthetic-synthetic.npz", _to_blob(
            synthetic("mnist", n_train=512, n_test=64)))
        store.put("datasets/lm-synthetic-t16.npz", _to_blob(
            synthetic_lm(n_train=512, n_test=64, seq_len=16)))
    return str(data_dir)


def take_losses(data_dir, key="loss"):
    """The run's logged losses (by step), and the log cleared."""
    folder = os.path.join(str(data_dir), "metrics")
    (name,) = os.listdir(folder)
    path = os.path.join(folder, name)
    recs = [json.loads(line) for line in open(path)]
    os.remove(path)
    return [r["value"] for r in recs if r.get("key") == key]


def port(data_dir, flags, *extra):
    rc = main(["train", "--device", "cpu", "--data-dir",
               small_data(data_dir), "--tracking", "jsonl", *flags, *extra])
    assert rc == 0
    return take_losses(data_dir)


def epoch_means(losses, per_epoch):
    return [float(np.mean(losses[i:i + per_epoch]))
            for i in range(0, len(losses), per_epoch)]


def _flag(flags, name, default=None):
    return flags[flags.index(name) + 1] if name in flags else default


def _jax_cfg(flags):
    """The Config JAX's CLI builds from ``flags`` (its defaults)."""
    kw = dict(mode=_flag(flags, "--mode", "split"),
              model=_flag(flags, "--model", "split_cnn"),
              dataset=_flag(flags, "--dataset"),
              batch_size=int(_flag(flags, "--batch-size")),
              lr=float(_flag(flags, "--lr")),
              transport=_flag(flags, "--transport"))
    for name, key, cast in (("--optimizer", "optimizer", str),
                            ("--weight-decay", "weight_decay", float),
                            ("--warmup-steps", "warmup_steps", int),
                            ("--decay-steps", "decay_steps", int),
                            ("--grad-clip-norm", "grad_clip_norm", float)):
        if name in flags:
            kw[key] = cast(_flag(flags, name))
    return JaxConfig(**kw)


def _jax_sizes(flags):
    if "--d-model" not in flags:
        return {}
    return {k: int(_flag(flags, f"--{k.replace('_', '-')}"))
            for k in ("d_model", "num_heads", "client_depth",
                      "server_depth")}


def _as_port(state):
    return train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       state._asdict()))


def seed_from_jax(ckdir, flags, parties):
    """A port checkpoint at step 0 holding the states JAX's CLI starts
    from (``--seed`` 0), with the port's meta of that layout."""
    jcfg = _jax_cfg(flags)
    size = _jax_sizes(flags)
    plan = jax_get_plan(model=jcfg.model, mode=jcfg.mode, **size)
    rng = jax.random.PRNGKey(jcfg.seed)
    seq = 16 if jcfg.dataset == "lm" else None
    sample = (np.zeros((jcfg.batch_size, seq), np.int32) if seq
              else np.zeros((jcfg.batch_size, 28, 28, 1), np.float32))
    if parties == "fused":
        tree = {"trainer": _as_port(JaxFused(plan, jcfg, rng,
                                             jnp.asarray(sample)).state)}
    else:
        server = JaxServer(plan, jcfg, rng, sample)
        tree = {"server": _as_port(server.state)}
        cls = {"split_local": JaxClient, "u_split_local": JaxUClient,
               "federated": JaxFedClient}[parties]
        client = cls(plan, jcfg, rng, JaxLocal(server))
        client.ensure_init(sample)
        if parties == "u_split_local":
            tree.update(client_a=_as_port(client.state_a),
                        client_c=_as_port(client.state_c))
        else:
            tree["client"] = _as_port(client.state)
    ck = Checkpointer(str(ckdir))
    ck.save(0, tree)
    ck.close()
    cfg = Config(mode=jcfg.mode, model=jcfg.model, dataset=jcfg.dataset)
    _write_ckpt_meta(str(ckdir), parties, cfg, size or None,
                     seq)


def assert_resume_is_uninterrupted(tmp_path, layout):
    flags = LAYOUTS[layout][0]
    whole = port(tmp_path / "a", flags, "--epochs", "2")
    ck = str(tmp_path / "ck")
    first = port(tmp_path / "b", flags, "--epochs", "1",
                 "--checkpoint-dir", ck)
    second = port(tmp_path / "b", flags, "--epochs", "1",
                  "--checkpoint-dir", ck, "--resume")
    assert len(first) == len(second) > 0
    assert first + second == whole     # bit for bit
    meta = json.load(open(os.path.join(ck, "meta.json")))
    assert meta["framework"] == "torch"
    assert meta["layout"] == LAYOUTS[layout][1]
    return whole


def assert_resume_tracks_jax(tmp_path, layout):
    flags, parties = LAYOUTS[layout]
    ck = tmp_path / "ck"
    seed_from_jax(ck, flags, parties)
    losses = []
    for _ in range(2):
        losses += port(tmp_path / "p", flags, "--epochs", "1",
                       "--checkpoint-dir", str(ck), "--resume")
    assert jax_main(["train", "--data-dir", small_data(tmp_path / "j"),
                     "--tracking", "jsonl", "--epochs", "2", *flags]) == 0
    j_losses = take_losses(tmp_path / "j")
    if parties == "federated":
        # JAX's federated client logs one mean loss an epoch
        losses = epoch_means(losses, len(losses) // 2)
    assert len(losses) == len(j_losses) > 0
    np.testing.assert_allclose(losses, j_losses, atol=TOL.get(layout, 1e-4))
    return losses


LOCAL = ("fused_cnn", "fused_lm", "u_split_local", "federated")


@pytest.mark.parametrize("layout", LOCAL)
def test_resume_is_the_uninterrupted_run(layout, tmp_path):
    assert_resume_is_uninterrupted(tmp_path, layout)


@pytest.mark.parametrize("layout", LOCAL)
def test_resume_tracks_jax(layout, tmp_path):
    assert_resume_tracks_jax(tmp_path, layout)


def test_checkpoint_every_on_the_fused_transport(tmp_path, capsys):
    """``--checkpoint-every`` saves on the fused path, retention keeps
    the newest three, and a resume from a mid-epoch step continues the
    same batches."""
    flags = LAYOUTS["fused_cnn"][0]
    whole = port(tmp_path / "a", flags, "--steps", "7", "--epochs", "2")
    ck = tmp_path / "ck"
    first = port(tmp_path / "b", flags, "--steps", "3", "--epochs", "2",
                 "--checkpoint-every", "1", "--checkpoint-dir", str(ck))
    assert sorted(int(n) for n in os.listdir(ck) if n.isdigit()) == [1, 2, 3]
    second = port(tmp_path / "b", flags, "--steps", "4", "--epochs", "2",
                  "--checkpoint-dir", str(ck), "--resume")
    assert "[ckpt] resumed at step 3" in capsys.readouterr().err
    assert first + second == whole


def test_resume_with_other_sizes_is_refused(tmp_path, capsys):
    flags = LAYOUTS["fused_lm"][0]
    ck = str(tmp_path / "ck")
    port(tmp_path / "a", flags, "--steps", "1", "--checkpoint-dir", ck)
    other = [f if f != "32" else "64" for f in flags]
    assert main(["train", "--device", "cpu", "--data-dir",
                 small_data(tmp_path / "a"), *other, "--steps", "1",
                 "--checkpoint-dir", ck, "--resume"]) == 2
    err = capsys.readouterr().err
    assert "[error] checkpoint was written with sizes" in err
    assert "d_model: saved 32 != requested 64" in err
    # a resume into another layout's trainer is refused, not half-read,
    # and the directory's meta stays the one it was written with
    meta = open(os.path.join(ck, "meta.json")).read()
    assert main(["train", "--device", "cpu", "--data-dir",
                 str(tmp_path / "a"), *flags, "--transport", "local",
                 "--steps", "1", "--checkpoint-dir", ck, "--resume"]) == 2
    assert "[error] cannot resume from" in capsys.readouterr().err
    assert open(os.path.join(ck, "meta.json")).read() == meta
