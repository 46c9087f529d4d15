"""The port's ``serve`` command and ``train --transport http`` on the CPU.

- ``serve --device cpu --port 0`` in a subprocess prints JAX's ``[serve]
  ... listening on <url>`` line; ``train --transport http`` against it
  returns 0 with a falling loss and the ``[transport] http`` line; SIGINT
  stops the server with rc 0;
- ``train --transport http`` with ``--chaos`` and ``--failure-policy
  retry`` (the breaker) completes every step;
- ``train`` and ``serve`` without ``--device cpu`` raise before touching
  data (no GPU here, no fallback);
- each JAX ``serve`` flag the port does not run exits 2 naming its
  ROADMAP item; a server in another mode makes the client exit 4;
- ``--compress-density auto`` on a two-party wire warns and trains at
  density 0.1, as JAX's ``_density_or_default`` does (fault 7).

Every wait has a timeout; the subprocess is killed in ``finally``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading

import pytest
import torch

from split_learning_tpu_torch.launch.run import SERVE_NOT_PORTED, main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import ServerRuntime
from split_learning_tpu_torch.transport import SplitHTTPServer
from split_learning_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_args(url, tmp_path, *extra):
    return ["train", "--transport", "http", "--server-url", url,
            "--device", "cpu", "--dataset", "synthetic", "--data-dir",
            str(tmp_path), "--tracking", "stdout", "--wait-server", "30",
            *extra]


def _losses(stdout):
    lines = stdout.splitlines()
    first = float(next(ln for ln in lines if ln.startswith("[step 0] loss:"))
                  .split(":")[1])
    done = next(ln for ln in lines if ln.startswith("[done]"))
    return first, float(done.split("final_loss=")[1].split()[0]), done


def _transport_line(stdout):
    return next(ln for ln in stdout.splitlines()
                if ln.startswith("[transport]"))


def test_serve_subprocess_and_train_over_http(tmp_path, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
         "serve", "--device", "cpu", "--port", "0", "--host", "127.0.0.1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        first = lines.get(timeout=120)
        assert first.startswith("[serve] mode=split role=server listening on "
                                "http://127.0.0.1:"), first
        url = first.split("listening on ")[1].strip()
        rc = main(_train_args(url, tmp_path, "--compress", "int8",
                              "--steps", "8"))
        out = capsys.readouterr().out
        assert rc == 0
        assert _transport_line(out).startswith(
            "[transport] http compress=int8 round_trips=8 ")
        assert "dropped_batches=0" in _transport_line(out)
        loss0, final, done = _losses(out)
        assert "transport=http steps=8" in done and final < loss0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
        assert lines.get(timeout=10).startswith("[serve] shutting down")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _in_process_server(mode="split"):
    cfg = Config(batch_size=64)
    runtime = ServerRuntime(get_plan(), cfg,
                            torch.Generator().manual_seed(cfg.seed),
                            device="cpu")
    if mode != "split":
        runtime.health = lambda: {"status": "healthy", "mode": mode}
    return SplitHTTPServer(runtime).start()


def test_train_over_http_with_chaos_and_retry(tmp_path, capsys):
    srv = _in_process_server()
    try:
        rc = main(_train_args(srv.url, tmp_path, "--compress", "topk8",
                              "--steps", "4", "--chaos",
                              "drop_resp=0.3,drop_req=0.2",
                              "--chaos-seed", "2",
                              "--failure-policy", "retry", "--eval"))
    finally:
        srv.stop()
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "[chaos] injecting 'drop_resp=0.3,drop_req=0.2' (seed 2) on " \
           "the client wire" in err
    line = _transport_line(out)
    assert "round_trips=" in line and "dropped_batches=0" in line
    assert "chaos_" not in line
    assert "[eval] accuracy=" in out
    assert srv.runtime.health()["step"] == 3


def test_health_mode_mismatch_exits_4(tmp_path, capsys):
    srv = _in_process_server(mode="u_split")
    try:
        rc = main(_train_args(srv.url, tmp_path, "--steps", "1"))
    finally:
        srv.stop()
    assert rc == 4
    assert "server is in mode 'u_split' but this client wants 'split'" in \
        capsys.readouterr().err
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("transport", ["local", "http"])
def test_compress_density_auto_warns_and_trains(transport, tmp_path,
                                                capsys):
    """Fault 7: JAX warns and runs the two-party wire at 0.1."""
    out = {}
    for density in ("auto", "0.1"):
        srv = _in_process_server() if transport == "http" else None
        args = (_train_args(srv.url, tmp_path) if srv is not None else
                ["train", "--transport", "local", "--device", "cpu",
                 "--dataset", "synthetic", "--data-dir", str(tmp_path)])
        try:
            rc = main(args + ["--compress", "topk8", "--steps", "2",
                              "--compress-density", density])
        finally:
            if srv is not None:
                srv.stop()
        captured = capsys.readouterr()
        assert rc == 0, captured.err
        out[density] = (captured.err, _transport_line(captured.out))
    assert "[warn] --compress-density auto drives the chain hop wires " \
           "only" in out["auto"][0]
    assert "[warn]" not in out["0.1"][0]
    assert out["auto"][1] == out["0.1"][1]    # the same bytes: density 0.1


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this machine has a GPU")


def test_train_and_serve_without_device_cpu_raise(tmp_path):
    _no_gpu()
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--transport", "http", "--server-url",
              "http://127.0.0.1:9", "--steps", "1", "--dataset",
              "synthetic", "--data-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["serve", "--port", "0", "--data-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


_FLAG_VALUES = {
    "role": ["--role", "stage"], "resume": ["--resume"],
    "checkpoint_dir": ["--checkpoint-dir", "ckpt"],
    "remat": ["--remat"],
    "coalesce_max": ["--coalesce-max", "4"],
    "batching": ["--batching", "continuous"],
    "tenants": ["--tenants", "2"], "quota": ["--quota", "5"],
    "slo_ms": ["--slo-ms", "250"], "no_overlap": ["--no-overlap"],
    "decouple_bwd": ["--decouple-bwd"], "apply_lag": ["--apply-lag", "2"],
    "mesh_data": ["--mesh-data", "2"], "mesh_model": ["--mesh-model", "2"],
    "replicas": ["--replicas", "2"],
    "replica_sync_every": ["--replica-sync-every", "4"],
    "handoff": ["--handoff", "checkpoint"], "autoscale": ["--autoscale"],
    "autoscale_min": ["--autoscale-min", "1"],
    "autoscale_max": ["--autoscale-max", "3"],
    "autoscale_cooldown_s": ["--autoscale-cooldown-s", "1"],
    "trace": ["--trace", "t.json"], "flight": ["--flight", "f.json"],
    "telemetry": ["--telemetry"],
    "telemetry_interval_s": ["--telemetry-interval-s", "0.5"],
    "telemetry_slo_ms": ["--telemetry-slo-ms", "100"],
    "tracking_uri": ["--tracking-uri", "http://mlflow:5000"],
}


@pytest.mark.parametrize("attr,item", [(a, i) for a, _, _, i in
                                       SERVE_NOT_PORTED],
                         ids=[a for a, *_ in SERVE_NOT_PORTED])
def test_unported_serve_flags_exit_2(attr, item, capsys):
    rc = main(["serve", "--device", "cpu", "--port", "0",
               *_FLAG_VALUES[attr]])
    err = capsys.readouterr().err
    assert rc == 2
    assert err.startswith("[error] not ported yet: ")
    assert f"(ROADMAP {item})" in err


@pytest.mark.parametrize("flags,msg", [
    (["--compress-density", "1.5"], "--compress-density must be in"),
    (["--chaos", "drop_response=0.1"], "unknown chaos kind"),
    (["--mode", "federated"], "items 11 and 15"),
])
def test_serve_refuses_bad_arguments(flags, msg, capsys):
    assert main(["serve", "--device", "cpu", "--port", "0", *flags]) == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("flags,msg", [
    (["--mode", "u_split"], "ROADMAP item 11"),
    (["--chaos", "dup=2"], "in [0, 1]"),
    (["--pipeline-depth", "2"], "ROADMAP item 15"),
])
def test_train_over_http_refuses_bad_arguments(flags, msg, tmp_path,
                                               capsys):
    rc = main(_train_args("http://127.0.0.1:9", tmp_path, "--steps", "1",
                          *flags))
    assert rc == 2
    assert msg in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
