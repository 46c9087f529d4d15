"""``train`` and ``serve`` in the U-shaped and federated modes, on the CPU.

- ``train --mode u_split|federated --transport local|http`` returns 0
  with a falling loss and the ``[transport]`` line; over HTTP against a
  ``serve --mode ...`` subprocess, whose ``[serve]`` line and ``/health``
  carry its mode (``model_type`` ``trunk_b`` or ``FullModel``); SIGINT
  stops it with rc 0;
- ``--eval`` scores the composition each mode trains: [A, trunk, C] in
  process, A and C around the remote trunk over HTTP
  (``evaluate_remote``), the federated client's whole model;
- as in JAX, ``--failure-policy`` other than ``raise`` and ``--prefetch``
  warn outside split mode and the run falls back; ``--prefetch`` in
  split mode runs (``DevicePrefetch``);
- ``num_clients > 1`` is refused by the fused trainer only.

Every wait has a timeout; the subprocess is killed in ``finally``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading

import pytest

from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.transport import HttpTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TYPE = {"u_split": "trunk_b", "federated": "FullModel"}


def _args(tmp_path, mode, *extra):
    return ["train", "--mode", mode, "--device", "cpu", "--dataset",
            "synthetic", "--data-dir", str(tmp_path), "--tracking", "stdout",
            "--lr", "0.02", "--steps", "8", *extra]


def _losses(stdout):
    lines = stdout.splitlines()
    first = float(next(ln for ln in lines if ln.startswith("[step 0] loss:"))
                  .split(":")[1])
    done = next(ln for ln in lines if ln.startswith("[done]"))
    return first, float(done.split("final_loss=")[1].split()[0]), done


def _line(stdout, prefix):
    return next(ln for ln in stdout.splitlines() if ln.startswith(prefix))


@pytest.mark.parametrize("mode", ["u_split", "federated"])
def test_train_in_process_loss_falls(mode, tmp_path, capsys):
    rc = main(_args(tmp_path, mode, "--transport", "local", "--compress",
                    "int8", "--eval"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    first, final, done = _losses(out)
    assert f"mode={mode} transport=local steps=8" in done
    assert final < first
    # u_split: two hops a step; federated: one FedAvg round (one epoch)
    trips = {"u_split": 16, "federated": 1}[mode]
    assert _line(out, "[transport]").startswith(
        f"[transport] local compress=int8 round_trips={trips} ")
    assert "[eval] accuracy=" in out


@pytest.mark.parametrize("mode", ["u_split", "federated"])
def test_serve_mode_and_train_over_http(mode, tmp_path, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
         "serve", "--mode", mode, "--device", "cpu", "--port", "0",
         "--host", "127.0.0.1", "--lr", "0.02"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        first_line = lines.get(timeout=120)
        assert first_line.startswith(
            f"[serve] mode={mode} role=server listening on "
            "http://127.0.0.1:"), first_line
        url = first_line.split("listening on ")[1].strip()
        t = HttpTransport(url, timeout=30)
        h = t.wait_ready(timeout=30)
        t.close()
        assert (h["mode"], h["model_type"], h["step"]) == (
            mode, MODEL_TYPE[mode], -1)
        rc = main(_args(tmp_path, mode, "--transport", "http",
                        "--server-url", url, "--wait-server", "30",
                        "--compress", "topk8", "--eval"))
        out, err = capsys.readouterr()
        assert rc == 0, err
        first, final, done = _losses(out)
        assert f"mode={mode} transport=http steps=8" in done
        assert final < first
        assert "dropped_batches=0" in _line(out, "[transport] http")
        assert "[eval] accuracy=" in out
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_split_only_flags_warn_outside_split_mode(tmp_path, capsys):
    rc = main(_args(tmp_path, "u_split", "--transport", "local",
                    "--failure-policy", "retry", "--prefetch", "2",
                    "--steps", "2"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "[warn] --failure-policy retry applies to the serialized split " \
           "client only; ignored here" in err
    assert "[warn] --prefetch ignored in mode 'u_split' (split only)" in err
    # in split mode the prefetch runs (DevicePrefetch)
    rc = main(_args(tmp_path, "split", "--transport", "local",
                    "--prefetch", "2", "--steps", "1"))
    assert rc == 0
    assert "--prefetch" not in capsys.readouterr().err


def test_num_clients_refused_by_the_fused_trainer_only(tmp_path, capsys,
                                                       monkeypatch):
    """``SLT_NUM_CLIENTS`` 2 (refused by the fused trainer before the mesh
    slice) is the fused trainer's ``data`` axis now, as in JAX: a data-2
    mesh of CPU ranks trains; every other trainer runs as before."""
    monkeypatch.setenv("SLT_NUM_CLIENTS", "2")
    rc = main(_args(tmp_path, "split", "--steps", "1"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "steps=1 final_loss=" in out and "[error]" not in err
    rc = main(_args(tmp_path, "u_split", "--transport", "local",
                    "--steps", "2"))
    assert rc == 0, capsys.readouterr().err
