"""The server under many clients through the port's commands, on the CPU.

- ``serve --coalesce-max 4 --batching continuous --tenants 2 --quota
  --slo-ms --allow-out-of-order`` runs (in process: the serve loop's
  sleep is where the client runs, then it stops as on SIGINT), /health
  reports the coalescing and admission blocks, and ``train --transport
  http --pipeline-depth 2`` trains against it;
- ``serve --decouple-bwd --apply-lag 1 --no-overlap`` runs and trains a
  client, and a clean stop drains the queue;
- a depth-2 client against a strict server exits 5 before any data;
- ``train --transport local`` with ``--decouple-bwd --apply-lag 1``, with
  ``--no-overlap`` and with ``--pipeline-depth 2`` trains;
- the refusals: an LM with ``--coalesce-max > 1`` (rc 2, the reason
  named), ``--pipeline-depth 0``; the fused transport warns for
  ``--pipeline-depth`` and ``--decouple-bwd``, as JAX's does.
"""

import time

import pytest
import torch

from split_learning_tpu_torch import transport as tp
from split_learning_tpu_torch.launch import run
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import ServerRuntime
from split_learning_tpu_torch.transport import HttpTransport, SplitHTTPServer
from split_learning_tpu_torch.utils.config import Config


class _Clock:
    """``time`` for the serve loop: its sleep runs ``body`` instead and
    then stops the server as SIGINT would."""

    def __init__(self, body):
        self.body = body
        self.result = None

    def __getattr__(self, name):
        return getattr(time, name)

    def sleep(self, secs):
        self.result = self.body()
        raise KeyboardInterrupt


def _serve(monkeypatch, flags, body):
    started = []

    class Recording(SplitHTTPServer):
        def start(self):
            started.append(self)
            return super().start()
    monkeypatch.setattr(tp, "SplitHTTPServer", Recording)
    clock = _Clock(lambda: body(started[0]))
    monkeypatch.setattr(run, "time", clock)
    rc = main(["serve", "--device", "cpu", "--port", "0", "--host",
               "127.0.0.1", "--batch-size", "16", *flags])
    return rc, clock.result, started[0]


def _train(url, tmp_path, *extra):
    return main(["train", "--device", "cpu", "--transport", "http",
                 "--server-url", url, "--dataset", "synthetic",
                 "--data-dir", str(tmp_path), "--batch-size", "16",
                 "--tracking", "stdout", "--wait-server", "30", *extra])


def _final(out):
    done = next(ln for ln in out.splitlines() if ln.startswith("[done]"))
    return done, float(done.split("final_loss=")[1].split()[0])


def test_serve_coalescing_admission_and_a_pipelined_client(
        monkeypatch, tmp_path, capsys):
    def body(server):
        health = HttpTransport(server.url).health()
        rc = _train(server.url, tmp_path, "--steps", "6",
                    "--pipeline-depth", "2", "--compress", "int8")
        return health, rc

    rc, (health, train_rc), server = _serve(
        monkeypatch, ["--coalesce-max", "4", "--batching", "continuous",
                      "--tenants", "2", "--quota", "1000", "--slo-ms",
                      "250", "--allow-out-of-order"], body)
    out = capsys.readouterr().out
    assert rc == 0 and train_rc == 0
    assert health["strict_steps"] is False
    assert health["coalescing"]["batching"] == "continuous"
    assert health["coalescing"]["coalesce_max"] == 4
    assert health["admission"]["tenants"] == 2
    assert health["admission"]["slo_ms"] == [250.0, 250.0]
    after = server.runtime.health()  # stopped: the flusher joined
    assert after["coalescing"]["requests_coalesced"] == 6
    assert after["admission"]["admission_admitted"] == 6
    assert after["step"] == 5
    done, loss = _final(out)
    assert "transport=http steps=6" in done and loss == loss
    assert "round_trips=6" in next(ln for ln in out.splitlines()
                                   if ln.startswith("[transport]"))


def test_serve_decoupled_backward_drains_on_stop(monkeypatch, tmp_path,
                                                 capsys):
    def body(server):
        rc = _train(server.url, tmp_path, "--steps", "4")
        return rc, server.runtime.health()["decoupled_bwd"]

    rc, (train_rc, dec), server = _serve(
        monkeypatch, ["--decouple-bwd", "--apply-lag", "1", "--no-overlap"],
        body)
    assert rc == 0 and train_rc == 0
    assert dec["apply_lag"] == 1 and dec["deferred_apply_depth"] == 1
    assert server.runtime.overlap is False
    final = server.runtime.health()["decoupled_bwd"]
    assert final["deferred_apply_depth"] == 0
    assert final["deferred_applied"] == 4


def test_pipelined_client_refuses_a_strict_server(tmp_path, capsys):
    runtime = ServerRuntime(get_plan(), Config(batch_size=16),
                            torch.Generator().manual_seed(0), device="cpu")
    srv = SplitHTTPServer(runtime).start()
    try:
        rc = _train(srv.url, tmp_path, "--steps", "2", "--pipeline-depth",
                    "2")
    finally:
        srv.stop()
    assert rc == 5
    assert "--allow-out-of-order" in capsys.readouterr().err
    assert runtime.health()["step"] == -1


@pytest.mark.parametrize("flags", [
    ["--decouple-bwd", "--apply-lag", "1"],
    ["--no-overlap", "--compress", "int8"],
    ["--pipeline-depth", "2"],
], ids=["2bp", "no_overlap", "depth2"])
def test_train_local_runs_the_server_knobs(flags, tmp_path, capsys):
    rc = main(["train", "--device", "cpu", "--transport", "local",
               "--dataset", "synthetic", "--data-dir", str(tmp_path),
               "--batch-size", "16", "--steps", "12", "--tracking",
               "stdout", *flags])
    out = capsys.readouterr().out
    assert rc == 0
    first = float(next(ln for ln in out.splitlines()
                       if ln.startswith("[step 0] loss:")).split(":")[1])
    done, final = _final(out)
    assert "transport=local steps=12" in done
    assert final < first


def test_serve_refuses_lm_coalescing(capsys):
    assert main(["serve", "--device", "cpu", "--port", "0", "--model",
                 "transformer_lm", "--d-model", "16", "--coalesce-max",
                 "2"]) == 2
    err = capsys.readouterr().err
    assert "classifier plans only" in err


def test_pipeline_depth_refusal_and_fused_warnings(tmp_path, capsys):
    assert main(["train", "--device", "cpu", "--transport", "local",
                 "--steps", "1", "--pipeline-depth", "0", "--dataset",
                 "synthetic", "--data-dir", str(tmp_path)]) == 2
    assert "--pipeline-depth must be >= 1" in capsys.readouterr().err
    assert main(["train", "--device", "cpu", "--steps", "1",
                 "--pipeline-depth", "2", "--decouple-bwd", "--dataset",
                 "synthetic", "--data-dir", str(tmp_path)]) == 0
    err = capsys.readouterr().err
    assert "[warn] --pipeline-depth ignored on transport='fused'" in err
    assert "[warn] --decouple-bwd ignored on transport='fused'" in err


def test_pipeline_depth_checkpoints_and_resumes(tmp_path, capsys):
    """``--pipeline-depth`` with ``--checkpoint-dir``: the window drains
    at each epoch's end, so the saved joint state is quiesced, and
    ``--resume`` continues from it (JAX's
    tests/test_pipelined_client.py::test_checkpoint_cli_resume_with_depth)."""
    args = ["train", "--device", "cpu", "--mode", "split", "--transport",
            "local", "--dataset", "synthetic", "--batch-size", "16",
            "--epochs", "1", "--steps", "8", "--pipeline-depth", "3",
            "--data-dir", str(tmp_path / "data"), "--tracking", "noop",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert main(args) == 0
    assert main(args + ["--resume"]) == 0
    err = capsys.readouterr().err
    assert "[ckpt] resumed at step" in err, err[-800:]
