"""The ``eval`` and ``generate`` commands on the CPU, against JAX's.

JAX's CLI trains a small causal LM (d_model 32, 2 heads, T 16) and the
CNN for 4 steps into an Orbax checkpoint; the state is carried into a
port checkpoint (``restore_raw`` -> ``interop.train_state_from_jax``,
with the port's meta of the same layout). Then:

- ``eval``'s JSON record has JAX's keys, and its values are within 1e-4
  of JAX's (both round to 4 places; the perplexity, ``exp(loss)``,
  within a relative 1e-4); ``--step`` picks a step;
- ``generate``'s record has JAX's keys; greedy tokens equal JAX's, with
  the KV cache and with ``--no-kv-cache``; a sampled decode is the same
  under one ``--seed`` (JAX's PRNG is not matched, so its tokens are
  not compared);
- ``generate --server-url`` against ``serve --resume`` of the same
  checkpoint (the fused layout's server share) decodes the local tokens;
- every refusal of tests/test_cli_generate.py and
  tests/test_cli_checkpoint.py has its counterpart: rc 2 with the same
  ``[error]`` text (a non-LM checkpoint, a bad prompt, each bad sampling
  flag, a negative id, ids outside the vocabulary, sizes that rebuild
  another plan), plus the port's own: the single-program pipeline's
  layout (item 16). A JAX K-stage chain checkpoint (the ``chain``
  layout) carried across evaluates within 1e-4 of JAX's ``eval``.
  ``eval`` of ResNet-18 and ViT checkpoints is held to JAX's in
  tests/test_torch_port_image_cli.py. The stale server (rc 3) and the
  serverless ``serve --resume`` (rc 2) are in
  tests/test_torch_port_resume_http.py.
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
from split_learning_tpu_torch.interop import train_state_from_jax
from split_learning_tpu_torch.launch.run import (
    _reconcile_ckpt_sizes, _write_ckpt_meta, main)
from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
from split_learning_tpu_torch.utils.config import Config

from test_torch_port_resume import small_data
from test_torch_port_resume_http import _Serve

LM = ["--model", "transformer_lm", "--dataset", "lm", "--seq-len", "16",
      "--d-model", "32", "--num-heads", "2", "--batch-size", "8"]
CNN = ["--dataset", "synthetic", "--batch-size", "16"]
EVAL_KEYS = {"checkpoint_step", "dataset", "accuracy", "loss",
             "perplexity", "examples", "predictions"}
GEN_KEYS = {"checkpoint_step", "prompt_len", "n_new", "decode", "prompt",
            "tokens"}


def _record(runner, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX checkpoints of the LM and the CNN (fused, 4 steps) and their
    port twins: ``{name: (jax_dir, port_dir, data_dir)}``."""
    root = tmp_path_factory.mktemp("ckpts")
    data = small_data(root / "data")
    out = {}
    for name, flags in (("lm", LM), ("cnn", CNN)):
        jdir, pdir = str(root / f"jax_{name}"), str(root / f"port_{name}")
        assert jax_main(["train", "--transport", "fused", "--steps", "4",
                         "--tracking", "noop", "--data-dir", data,
                         "--checkpoint-dir", jdir, *flags]) == 0
        ck = JaxCkpt(jdir)
        steps = sorted(ck.all_steps())
        raws = {s: jax.tree_util.tree_map(np.asarray, ck.restore_raw(s))
                for s in steps}
        ck.close()
        meta = json.load(open(os.path.join(jdir, "meta.json")))
        port = Checkpointer(pdir)
        for step, raw in raws.items():
            port.save(step, {"trainer": train_state_from_jax(
                raw["trainer"])})
        port.close()
        _write_ckpt_meta(pdir, meta["layout"], Config(
            mode=meta["mode"], model=meta["model"],
            dataset=meta["dataset"]), meta.get("size_kw"),
            meta.get("seq_len"))
        out[name] = (jdir, pdir, data)
    return out


def _both(checkpoints, name, cmd, *extra):
    jdir, pdir, data = checkpoints[name]
    j = _record(jax_main, [cmd, "--checkpoint-dir", jdir, "--data-dir", data,
                           *extra])
    p = _record(main, [cmd, "--device", "cpu", "--checkpoint-dir", pdir,
                       "--data-dir", data, *extra])
    return p, j


@pytest.mark.parametrize("name", ["lm", "cnn"])
def test_eval_record_matches_jax(checkpoints, name):
    p, j = _both(checkpoints, name, "eval", "--batch-size", "64")
    assert set(p) == set(j) == EVAL_KEYS
    for key in ("checkpoint_step", "dataset", "examples", "predictions"):
        assert p[key] == j[key], key
    for key in ("accuracy", "loss"):
        assert abs(p[key] - j[key]) <= 1e-4 + 1e-9, (key, p[key], j[key])
    # exp(loss): the loss's 1e-4 is a relative 1e-4 of the perplexity
    assert abs(p["perplexity"] - j["perplexity"]) <= \
        1e-4 * j["perplexity"] + 1e-4
    assert p["checkpoint_step"] == 4
    # an earlier step through --step
    jdir, pdir, data = checkpoints[name]
    steps = sorted(Checkpointer(pdir).all_steps())
    if len(steps) > 1:
        p1, j1 = _both(checkpoints, name, "eval", "--step", str(steps[0]))
        assert p1["checkpoint_step"] == j1["checkpoint_step"] == steps[0]
        assert abs(p1["loss"] - j1["loss"]) <= 1e-4 + 1e-9


@pytest.mark.parametrize("extra", [[], ["--no-kv-cache"],
                                   ["--prompt", "3,1,4,1,5"]])
def test_greedy_generate_matches_jax(checkpoints, extra):
    p, j = _both(checkpoints, "lm", "generate", "--n-new", "6", *extra)
    assert set(p) == set(j) == GEN_KEYS
    assert p["decode"] == j["decode"] == "greedy"
    assert p["prompt"] == j["prompt"]
    assert p["tokens"] == j["tokens"]
    assert len(p["tokens"][0]) == 6


def test_sampled_generate_is_reproducible(checkpoints):
    jdir, pdir, data = checkpoints["lm"]
    base = ["generate", "--device", "cpu", "--checkpoint-dir", pdir,
            "--data-dir", data, "--n-new", "8", "--prompt", "3,1,4",
            "--temperature", "0.9", "--top-k", "12", "--top-p", "0.95"]
    a = _record(main, base + ["--seed", "3"])
    b = _record(main, base + ["--seed", "3"])
    assert a["decode"] == "sampled" and a["tokens"] == b["tokens"]
    assert a["prompt"] == [[3, 1, 4]] and len(a["tokens"][0]) == 8
    others = [_record(main, base + ["--seed", str(s)])["tokens"]
              for s in (4, 5)]
    assert any(t != a["tokens"] for t in others)


def test_generate_over_http_matches_local(checkpoints, tmp_path):
    jdir, pdir, data = checkpoints["lm"]
    srv = _Serve(tmp_path, "--checkpoint-dir", pdir, "--resume",
                 "--data-dir", data, *LM[:4])
    try:
        args = ["generate", "--device", "cpu", "--checkpoint-dir", pdir,
                "--data-dir", data, "--prompt", "1,2,3", "--n-new", "4"]
        local = _record(main, args)
        remote = _record(main, args + ["--server-url", srv.url])
        remote8 = _record(main, args + ["--server-url", srv.url,
                                        "--compress", "int8"])
    finally:
        assert srv.stop() == 0
    assert remote["remote_server"] == srv.url
    assert remote["tokens"] == local["tokens"]
    assert len(remote8["tokens"][0]) == 4


def _meta_dir(tmp_path, **meta):
    d = tmp_path / "ck"
    os.makedirs(d, exist_ok=True)
    with open(d / "meta.json", "w") as f:
        json.dump({"layout": "fused", "mode": "split", "dataset": "lm",
                   "framework": "torch", **meta}, f)
    return str(d)


@pytest.mark.parametrize("flags,msg", [
    (["--temperature", "0"], "greedy"),
    (["--top-p", "0"], "top-p"),
    (["--top-k", "-1"], "top-k"),
    (["--prompt=-3,5"], ">= 0"),
    (["--prompt", "1,two,3"], "token ids"),
])
def test_generate_refuses_bad_flags(flags, msg, tmp_path, capsys):
    ck = _meta_dir(tmp_path, model="transformer_lm")
    argv = ["generate", "--checkpoint-dir", ck, "--data-dir", str(tmp_path)]
    assert jax_main(argv + flags) == 2
    j_err = capsys.readouterr().err
    assert main(argv + ["--device", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert msg in err and err.startswith("[error] ")
    assert err.splitlines()[-1] == j_err.splitlines()[-1]


def test_generate_refuses_a_non_lm_checkpoint(tmp_path, capsys):
    ck = _meta_dir(tmp_path, model="split_cnn", dataset="synthetic")
    assert main(["generate", "--device", "cpu", "--checkpoint-dir", ck,
                 "--data-dir", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert err == ("[error] generate needs a 'transformer_lm' checkpoint "
                   "(got 'split_cnn')\n")


def test_generate_refuses_ids_outside_the_vocabulary(checkpoints, capsys):
    jdir, pdir, data = checkpoints["lm"]
    for runner, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        d = jdir if runner is jax_main else pdir
        assert runner(["generate", "--checkpoint-dir", d, "--data-dir",
                       data, "--prompt", "1,300,999", *extra]) == 2
        assert capsys.readouterr().err.splitlines()[-1] == (
            "[error] --prompt ids [300, 999] are outside the checkpoint's "
            "vocabulary (256)")


def test_eval_refuses_what_it_cannot_read(checkpoints, tmp_path, capsys):
    jdir, pdir, data = checkpoints["lm"]
    # sizes that would rebuild another plan
    assert main(["eval", "--device", "cpu", "--checkpoint-dir", pdir,
                 "--data-dir", data, "--d-model", "64"]) == 2
    assert "d_model: saved 32 != requested 64" in capsys.readouterr().err
    assert main(["eval", "--device", "cpu", "--data-dir", data]) == 2
    assert "eval requires --checkpoint-dir" in capsys.readouterr().err
    # a K-stage chain checkpoint evaluates (the test below); the
    # single-program pipeline's is not ported yet
    for meta, item in (({"layout": "pipeline", "model": "resnet18_4stage",
                         "dataset": "cifar10"}, "ROADMAP item 16"),):
        ck = _meta_dir(tmp_path / meta["model"], **meta)
        saver = Checkpointer(ck)
        saver.save(1, {"trainer": {"params": []}})
        saver.close()
        assert main(["eval", "--device", "cpu", "--checkpoint-dir", ck,
                     "--data-dir", data]) == 2
        err = capsys.readouterr().err
        assert err.startswith("[error] ") and "not ported" in err
        assert item in err


def test_eval_of_a_jax_chain_checkpoint_matches_jax(tmp_path):
    """JAX's K-stage chain (``split_cnn_chain3``, M 2, 4 steps) saves the
    ``chain`` layout (``client``, ``stage1``, ``stage2``); each party's
    state carried through ``interop.train_state_from_jax`` into a port
    checkpoint evaluates within 1e-4 of JAX's ``eval``."""
    data = small_data(tmp_path / "data")
    jdir, pdir = str(tmp_path / "jax_chain"), str(tmp_path / "port_chain")
    assert jax_main(["train", "--transport", "local", "--stages", "3",
                     "--model", "split_cnn_chain3", "--microbatches", "2",
                     "--steps", "4", "--tracking", "noop", "--data-dir",
                     data, "--checkpoint-dir", jdir, *CNN]) == 0
    ck = JaxCkpt(jdir)
    step = ck.latest_step()
    raw = jax.tree_util.tree_map(np.asarray, ck.restore_raw(step))
    ck.close()
    assert sorted(raw) == ["client", "stage1", "stage2"]
    port = Checkpointer(pdir)
    port.save(step, {k: train_state_from_jax(v) for k, v in raw.items()})
    port.close()
    _write_ckpt_meta(pdir, "chain", Config(model="split_cnn_chain3",
                                           dataset="synthetic"))
    p = _record(main, ["eval", "--device", "cpu", "--checkpoint-dir", pdir,
                       "--data-dir", data, "--batch-size", "64"])
    j = _record(jax_main, ["eval", "--checkpoint-dir", jdir, "--data-dir",
                           data, "--batch-size", "64"])
    assert set(p) == set(j) == EVAL_KEYS
    assert p["checkpoint_step"] == j["checkpoint_step"] == step
    assert p["examples"] == j["examples"]
    for key in ("accuracy", "loss"):
        assert abs(p[key] - j[key]) <= 1e-4 + 1e-9, (key, p[key], j[key])


def test_reconcile_sizes_accepts_explicit_defaults():
    """JAX's ``_reconcile_ckpt_sizes`` cases: flags restating the
    builder's defaults are accepted, a different plan is refused."""
    kw, seq, err = _reconcile_ckpt_sizes(
        {}, {"d_model": 64, "num_heads": 4}, None, "eval",
        model="transformer")
    assert err is None and kw == {}
    meta = {"size_kw": {"d_model": 256, "num_heads": 2}}
    kw, seq, err = _reconcile_ckpt_sizes(
        meta, {"d_model": 256, "num_heads": 2}, None, "eval",
        model="transformer")
    assert err is None and kw == {"d_model": 256, "num_heads": 2}
    kw, seq, err = _reconcile_ckpt_sizes(
        meta, {"d_model": 256}, None, "eval", model="transformer")
    assert err is None and kw == {"d_model": 256, "num_heads": 2}
    kw, seq, err = _reconcile_ckpt_sizes(
        meta, {"d_model": 128}, None, "eval", model="transformer")
    assert err is not None and "d_model" in err
    kw, seq, err = _reconcile_ckpt_sizes(
        {}, {"d_model": 128}, None, "eval", model="transformer")
    assert err is not None and "d_model" in err
    kw, seq, err = _reconcile_ckpt_sizes(
        {"seq_len": 16}, {}, 32, "eval", model="transformer_lm")
    assert err == ("checkpoint was trained at --seq-len 16 but eval "
                   "requested 32")
