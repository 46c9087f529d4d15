"""The K-stage chain through the port's command line, on the CPU.

- ``train --stages 3 --model split_cnn_chain3`` on ``--transport
  local`` and ``device`` (GPipe and 1F1B, M 4, lag 1): rc 0, the
  ``[pipeline] stage i: bubble=...`` and ``[transport] hop i`` lines, a
  falling loss; the device wire's hops copy nothing to the host;
- over HTTP against two ``serve --role stage`` processes on port 0: the
  chain trains and its loss falls; the wrong stage order (``--stage-urls``
  reversed) or another ``--microbatches`` exits 4 before any step;
- ``--gate-dropped-steps`` under ``--chaos`` on every hop wire passes,
  and the refusals: a plan of another depth, ``--transport device``
  without the chain, a bad ``--stage-index``;
- checkpoints, the ``chain`` layout: a mid-run save resumed into a fresh
  chain continues bit-equal (the port of
  ``tests/test_mpmd_pipeline.py::test_mid_pipeline_checkpoint_roundtrips``),
  ``train --resume`` continues the losses of a run that saved at the
  same steps, bit for bit, and
  ``eval`` scores a ``chain`` checkpoint as ``evaluate()`` scores the
  run's parties.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.runtime.checkpoint import (
    Checkpointer, extras_valid, read_latest_extras, write_extras)
from split_learning_tpu_torch.runtime.state import restore_state
from test_torch_port_chain import _batch, drive, port_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = ["--device", "cpu", "--model", "split_cnn_chain3", "--stages", "3",
         "--dataset", "synthetic", "--batch-size", "16", "--microbatches",
         "4", "--apply-lag", "1"]


def _losses(data_dir):
    """The run's jsonl losses, and the log cleared for the next run."""
    folder = os.path.join(data_dir, "metrics")
    losses = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            losses += [r["value"] for r in map(json.loads, f)
                       if r.get("key") == "loss"]
        os.remove(os.path.join(folder, name))
    return losses


def _train(tmp_path, *extra, steps=12):
    return main(["train", *CHAIN, "--data-dir", str(tmp_path), "--tracking",
                 "jsonl", "--steps", str(steps), *extra])


@pytest.mark.parametrize("transport,schedule", [
    ("local", "gpipe"), ("device", "1f1b")])
def test_train_chain_in_process(transport, schedule, tmp_path, capsys):
    assert _train(tmp_path, "--transport", transport, "--schedule",
                  schedule) == 0
    cap = capsys.readouterr()
    losses = _losses(tmp_path)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    pipe = [ln for ln in cap.err.splitlines() if ln.startswith("[pipeline]")]
    assert len(pipe) == 2
    assert pipe[0].startswith(f"[pipeline] stage 1 [{schedule}]: bubble=")
    assert "(ideal 0.333)" in pipe[0]
    hops = [ln for ln in cap.err.splitlines()
            if ln.startswith("[transport] hop")]
    assert len(hops) == 2 and "'round_trips': 96" in hops[0]
    assert "'hop_host_copies'" not in hops[0]   # 0: never counted
    assert f"transport={transport} steps=12" in cap.out


def _serve_stage(index, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
         "serve", "--role", "stage", "--stage-index", str(index),
         "--device", "cpu", "--model", "split_cnn_chain3",
         "--microbatches", "2", "--port", "0", "--host", "127.0.0.1",
         *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    return proc, lines


def test_train_chain_over_http_against_two_stage_processes(tmp_path,
                                                           capsys):
    procs = [_serve_stage(i) for i in (1, 2)]
    try:
        urls = []
        for i, (proc, lines) in enumerate(procs):
            first = lines.get(timeout=120)
            assert first.startswith(
                "[serve] mode=split role=stage listening on "
                "http://127.0.0.1:"), first
            urls.append(first.split("listening on ")[1].strip())
        http = ["--transport", "http", "--wait-server", "30"]
        # refusals first: they reach the parties' /health only
        argv = ["train", *CHAIN, "--data-dir", str(tmp_path), *http,
                "--steps", "2"]
        argv[argv.index("--microbatches") + 1] = "2"
        assert main([*argv, "--stage-urls", ",".join(urls[::-1])]) == 4
        assert "reports stage_index=2, expected 1" in (
            capsys.readouterr().err)
        bad = list(argv)
        bad[bad.index("--microbatches") + 1] = "4"
        assert main([*bad, "--stage-urls", ",".join(urls)]) == 4
        assert "microbatches=2" in capsys.readouterr().err
        assert main([*argv, "--stage-urls", urls[0]]) == 2
        assert "needs --stage-urls with 2 URLs" in capsys.readouterr().err
        argv[argv.index("--steps") + 1] = "12"
        assert main([*argv, "--stage-urls", ",".join(urls), "--compress",
                     "int8", "--tracking", "jsonl"]) == 0
        losses = _losses(tmp_path)
        assert len(losses) == 12
        assert np.mean(losses[-4:]) < np.mean(losses[:4])
        err = capsys.readouterr().err
        # 2 host copies a hop: 48 hops on wire 1, 24 on the loss wire
        assert "'hop_host_copies': 96" in err
        assert "'hop_host_copies': 48" in err
        assert "[pipeline] stage 2 [gpipe]" in err
        for proc, _ in procs:
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_gate_and_chaos_on_every_hop_wire(tmp_path, capsys):
    assert _train(tmp_path, "--transport", "local", "--compress", "topk8",
                  "--compress-density", "auto", "--chaos",
                  "drop_resp=0.2,dup=0.2", "--chaos-seed", "3",
                  "--gate-dropped-steps", steps=8) == 0
    err = capsys.readouterr().err
    assert "[gate] ok: 8 steps completed, 0 dropped" in err
    assert "on every hop wire" in err
    assert "[density] adaptive controller: windows=1" in err
    assert "'chaos_dup'" in err


@pytest.mark.parametrize("argv,msg", [
    (["--stages", "3", "--model", "split_cnn", "--transport", "local"],
     "--stages 3 does not match model 'split_cnn' (2 stages)"),
    (["--transport", "device"],
     "--transport device is the co-located K-stage chain"),
])
def test_chain_refusals(argv, msg, tmp_path, capsys):
    assert main(["train", "--device", "cpu", "--dataset", "synthetic",
                 "--data-dir", str(tmp_path), "--steps", "1", *argv]) == 2
    assert msg in capsys.readouterr().err


def test_serve_refuses_a_stage_index_outside_the_plan(capsys):
    assert main(["serve", "--device", "cpu", "--role", "stage",
                 "--stage-index", "3", "--model", "split_cnn_chain3",
                 "--port", "0"]) == 2
    assert "stage_index must be in [1, 2]" in capsys.readouterr().err


def test_mid_chain_checkpoint_continues_bit_equal(tmp_path):
    m, lag, at = 2, 1, 4
    runner, stages, _ = port_chain(m, lag)
    ckptr = Checkpointer(str(tmp_path))
    try:
        for i in range(at):
            runner.step(*_batch(i), i)
        ckptr.save(at, {"client": runner.state,
                        **{s.party: s.export_state() for s in stages}})
        for s in stages:
            assert s.counters()["deferred_apply_depth"] == 0   # flushed
            d = tmp_path / s.party
            d.mkdir()
            write_extras(str(d), s.export_runtime_extras(at))
        cont_a = [runner.step(*_batch(i), i) for i in range(at, at + 3)]
    finally:
        runner.close()
        for s in stages:
            s.close()
    ckptr.wait_until_finished()
    raw = ckptr.restore_raw(at)
    chain_b = runner, stages, _ = port_chain(m, lag)
    restore_state(runner.state, raw["client"])
    runner.steps_done = at
    for s in stages:
        extras = read_latest_extras(str(tmp_path / s.party), step=at)
        assert extras is not None and extras_valid(extras)
        s.resume_from(raw[s.party], at, extras=extras)
        assert s.health()["step"] == at - 1
    cont_b = drive(chain_b, 3, start=at)
    assert cont_a == cont_b


def test_resume_and_eval_of_a_chain_checkpoint(tmp_path, capsys):
    """A save flushes each stage's deferred queue (lag 1 here), so the
    run to continue is one that saved at the same steps."""
    ck, whole, part = (str(tmp_path / n) for n in ("ck", "whole", "part"))
    flags = ["--transport", "local", "--tracking", "jsonl"]
    assert main(["train", *CHAIN, *flags, "--data-dir", whole,
                 "--steps", "6", "--checkpoint-every", "2",
                 "--checkpoint-dir", str(tmp_path / "ck_whole")]) == 0
    want = _losses(whole)
    assert main(["train", *CHAIN, *flags, "--data-dir", part, "--steps",
                 "4", "--checkpoint-dir", ck, "--checkpoint-every", "2"]) == 0
    assert Checkpointer(ck).all_steps() == [2, 4]
    for party in ("stage1", "stage2"):
        assert read_latest_extras(os.path.join(ck, party), step=4)
    assert main(["train", *CHAIN, *flags, "--data-dir", part, "--steps",
                 "2", "--checkpoint-dir", ck, "--resume"]) == 0
    assert "[ckpt] chain resumed at step 4" in capsys.readouterr().err
    assert _losses(part) == want
    assert main(["eval", "--device", "cpu", "--checkpoint-dir", ck,
                 "--data-dir", part, "--batch-size", "16"]) == 0
    record = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert record["checkpoint_step"] == 6 and record["examples"] > 0
    assert 0.0 <= record["accuracy"] <= 1.0
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["layout"] == "chain"
