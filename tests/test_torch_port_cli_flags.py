"""The port's command-line surface against JAX's, flag by flag.

- Every flag of JAX's ``train``, ``serve``, ``eval`` and ``generate``
  parsers exists in the port's (the two argparse trees diffed), so no
  JAX command line meets argparse's bare rc 2. ``--kernels`` (no kernel
  fallback knob) and ``--download`` (no network) stay out by design.
- Each ``train`` flag the port does not run yet
  (:data:`TRAIN_NOT_PORTED`) exits 2 with ``[error] not ported yet:``
  and its ROADMAP item, before touching data; the observability flags
  (``--flight``, ``--telemetry-port``, ``--profile-dir``,
  ``--tracking-uri``) run and do what JAX's do, and so do the mesh
  flags (``--transport pipeline``, ``--num-clients``,
  ``--seq-parallel``, the multi-host flags).
- ``--require-real`` runs: with no real files it refuses the synthetic
  fallback (rc 2), with the real cache present it trains.
"""

import argparse
import json
import os

import numpy as np
import pytest

from split_learning_tpu.launch import run as jax_run
from split_learning_tpu_torch.data.datasets import (
    Dataset, LocalStore, Split, _to_blob)
from split_learning_tpu_torch.launch import run
from split_learning_tpu_torch.launch.run import TRAIN_NOT_PORTED, main

BY_DESIGN = {"--kernels", "--download"}


def _flags(module, cmd):
    """The option strings of ``module``'s ``cmd`` parser."""
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            module.main([cmd])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in captured["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {o for a in sub.choices[cmd]._actions for o in a.option_strings
            if o.startswith("--")}


@pytest.mark.parametrize("cmd", ["train", "serve", "eval", "generate"])
def test_every_jax_flag_has_a_port_flag(cmd):
    missing = _flags(jax_run, cmd) - _flags(run, cmd) - BY_DESIGN
    assert not missing, f"JAX {cmd} flags the port lacks: {sorted(missing)}"
    assert "--device" in _flags(run, cmd)


_VALUES = {
    "model_parallel": ["--model-parallel", "2"],
    "mesh_data": ["--mesh-data", "2"], "mesh_model": ["--mesh-model", "2"],
}


@pytest.mark.parametrize("attr,item", [(a, i) for a, _, _, i in
                                       TRAIN_NOT_PORTED],
                         ids=[a for a, *_ in TRAIN_NOT_PORTED])
def test_unported_train_flags_exit_2(attr, item, tmp_path, capsys):
    rc = main(["train", "--device", "cpu", "--steps", "1", "--dataset",
               "synthetic", "--data-dir", str(tmp_path), *_VALUES[attr]])
    err = capsys.readouterr().err
    assert rc == 2
    assert err.startswith("[error] not ported yet: ")
    assert f"(ROADMAP {item})" in err
    assert not any(tmp_path.iterdir())   # refused before touching data


@pytest.mark.parametrize("attr", ["flight", "telemetry_port", "profile_dir",
                                  "tracking_uri"])
def test_ported_train_flags_run(attr, tmp_path, capsys):
    """The observability flags that exited 2 before they were ported:
    each trains, with JAX's effect (the fused transport: ``--flight``
    dumps the journal at exit, ``--profile-dir`` writes the device
    trace, ``--telemetry-port`` warns that it serves the chain's hub,
    an unreachable ``--tracking-uri`` degrades to stdout)."""
    from split_learning_tpu_torch.obs import flight
    path = str(tmp_path / "out")
    flags = {"flight": ["--flight", path],
             "telemetry_port": ["--telemetry-port", "0"],
             "profile_dir": ["--profile-dir", path],
             "tracking_uri": ["--tracking", "mlflow", "--tracking-uri",
                              "http://127.0.0.1:9"]}[attr]
    rc = main(["train", "--device", "cpu", "--steps", "2", "--dataset",
               "synthetic", "--data-dir", str(tmp_path / "d"), *flags])
    err = capsys.readouterr().err
    assert rc == 0 and "not ported yet" not in err
    if attr == "flight":
        dump = json.load(open(path))
        assert dump["kind"] == "slt-flight-dump" and dump["reason"] == "exit"
        assert not flight.enabled()
    elif attr == "profile_dir":
        assert os.path.isfile(os.path.join(path, "device_trace.json"))
        assert "[profile] device trace written to" in err
    elif attr == "telemetry_port":
        assert "--telemetry-port applies to the K-stage chain" in err
    else:
        assert "unusable" in err and "falling back to stdout" in err


_PORTED_TRAIN_FLAGS = {
    "remat": ["--remat"],
    "replica_sync_every": ["--transport", "local", "--replicas", "2",
                           "--replica-sync-every", "1"],
    "handoff": ["--transport", "local", "--replicas", "2", "--handoff",
                "checkpoint"],
    "autoscale": ["--transport", "local", "--autoscale"],
    "autoscale_min": ["--transport", "local", "--autoscale",
                      "--autoscale-min", "2"],
    "autoscale_max": ["--transport", "local", "--autoscale",
                      "--autoscale-max", "2"],
    "autoscale_cooldown_s": ["--transport", "local", "--autoscale",
                             "--autoscale-cooldown-s", "0.5"],
    "scan_steps": ["--scan-steps", "2"],
}


@pytest.mark.parametrize("attr", sorted(_PORTED_TRAIN_FLAGS))
def test_replica_scan_remat_train_flags_run(attr, tmp_path, capsys):
    """The train flags that exited 2 before they were ported train: the
    in-process server replicated (``--replicas``, the sync and the
    handoff), elastic (``--autoscale``, its banner), ``--scan-steps`` on
    the fused transport, ``--remat``."""
    rc = main(["train", "--device", "cpu", "--steps", "2", "--dataset",
               "synthetic", "--data-dir", str(tmp_path),
               *_PORTED_TRAIN_FLAGS[attr]])
    err = capsys.readouterr().err
    assert rc == 0 and "not ported yet" not in err and "[warn]" not in err
    assert ("[autoscale] policy on:" in err) == attr.startswith("autoscale")


_MESH_TRAIN_FLAGS = {
    "transport": ["--transport", "pipeline", "--microbatches", "2"],
    "num_clients": ["--num-clients", "2"],
    "coordinator": ["--coordinator", "127.0.0.1:1"],
    "num_processes": ["--num-processes", "1"],
    "process_id": ["--process-id", "0"],
    "seq_parallel": ["--model", "transformer_lm", "--dataset", "lm",
                     "--seq-len", "16", "--d-model", "16", "--num-heads",
                     "2", "--attn", "ring", "--seq-parallel", "2"],
}


@pytest.mark.parametrize("attr", sorted(_MESH_TRAIN_FLAGS))
def test_mesh_train_flags_run(attr, tmp_path, capsys):
    """The mesh flags that exited 2 before the mesh slice train:
    ``--transport pipeline`` (GPipe over a pipe mesh), ``--num-clients``
    (the fused trainer's data axis), ``--seq-parallel`` (ring attention
    over a seq axis), and the multi-host flags, which alone (no second
    process) leave the run single-process, as JAX's do."""
    argv = ["train", "--device", "cpu", "--steps", "2", "--data-dir",
            str(tmp_path), "--batch-size", "8",
            *_MESH_TRAIN_FLAGS[attr]]
    if "--dataset" not in argv:
        argv += ["--dataset", "synthetic"]
    rc = main(argv)
    out, err = capsys.readouterr()
    assert rc == 0 and "not ported yet" not in err and "[warn]" not in err
    assert "steps=2 final_loss=" in out


def test_defaults_of_the_refused_flags_train(tmp_path, capsys):
    """The values that ask for nothing unported (``--stages 2``,
    ``--num-clients 1``, ``--scan-steps 1``, ``--handoff live``) train."""
    assert main(["train", "--device", "cpu", "--steps", "1", "--dataset",
                 "synthetic", "--data-dir", str(tmp_path), "--stages", "2",
                 "--num-clients", "1", "--scan-steps", "1", "--handoff",
                 "live", "--mesh-data", "1"]) == 0


def test_require_real(tmp_path, capsys):
    argv = ["train", "--device", "cpu", "--steps", "2", "--dataset",
            "mnist", "--data-dir", str(tmp_path), "--require-real",
            "--batch-size", "4"]
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("[error] no raw mnist files under ")
    assert "--require-real" in err
    rs = np.random.RandomState(0)
    split = Split(rs.rand(16, 28, 28, 1).astype(np.float32),
                  rs.randint(0, 10, 16).astype(np.int64))
    LocalStore(str(tmp_path / "cache")).put(
        "datasets/mnist.npz", _to_blob(Dataset(split, split, "mnist", 10)))
    assert main(argv) == 0
    assert "[data] using synthetic" not in capsys.readouterr().err
