"""The port's ``serve`` command and ``train --transport http`` on the CPU.

- ``serve --device cpu --port 0`` in a subprocess prints JAX's ``[serve]
  ... listening on <url>`` line; ``train --transport http`` against it
  returns 0 with a falling loss and the ``[transport] http`` line; SIGINT
  stops the server with rc 0;
- ``train --transport http`` with ``--chaos`` and ``--failure-policy
  retry`` (the breaker) completes every step;
- ``train`` and ``serve`` without ``--device cpu`` raise before touching
  data (no GPU here, no fallback);
- the mesh flags (``--mesh-data``, ``--mesh-model``), which exited 2
  until the sharded server was ported, serve on their mesh, and the
  observability flags (``--trace``, ``--flight``, ``--telemetry`` and
  its interval and SLO, ``--tracking-uri``) serve;
  a server in another mode makes the client exit 4;
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

from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import ServerRuntime
from split_learning_tpu_torch.transport import SplitHTTPServer, codec
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
    "remat": ["--remat"],
    "mesh_data": ["--mesh-data", "2"], "mesh_model": ["--mesh-model", "2"],
    "replicas": ["--replicas", "2"],
    "replica_sync_every": ["--replica-sync-every", "4"],
    "handoff": ["--handoff", "checkpoint"], "autoscale": ["--autoscale"],
    "autoscale_min": ["--autoscale-min", "1"],
    "autoscale_max": ["--autoscale-max", "3"],
    "autoscale_cooldown_s": ["--autoscale-cooldown-s", "1"],
}


@pytest.mark.parametrize("attr,item", [("mesh_data", "item 18"),
                                       ("mesh_model", "item 18")],
                         ids=["mesh_data", "mesh_model"])
def test_unported_serve_flags_exit_2(attr, item, monkeypatch, capsys):
    """``--mesh-data`` and ``--mesh-model`` exited 2 naming ROADMAP item
    18 until the sharded server was ported: ``serve`` now comes up on
    the mesh, its /health carries it, and it stops on the interrupt with
    rc 0."""
    import time
    import urllib.request
    from split_learning_tpu_torch.launch import run
    got = {}
    real = run.serve_party

    def serve_party(args):
        out = real(args)
        got["url"] = out[1].url
        return out

    class Clock:
        def sleep(self, _):
            with urllib.request.urlopen(got["url"] + "/health",
                                        timeout=10) as r:
                got["health"] = codec.decode(r.read())
            raise KeyboardInterrupt

        def __getattr__(self, name):
            return getattr(time, name)
    monkeypatch.setattr(run, "serve_party", serve_party)
    monkeypatch.setattr(run, "time", Clock())
    rc = main(["serve", "--device", "cpu", "--port", "0", "--host",
               "127.0.0.1", *_FLAG_VALUES[attr]])
    err = capsys.readouterr().err
    assert rc == 0 and "not ported yet" not in err
    assert f"ROADMAP {item}" not in err
    axis = {"mesh_data": "data", "mesh_model": "model"}[attr]
    assert got["health"]["mesh"]["devices"] == 2
    assert got["health"]["mesh"][axis] == 2


@pytest.mark.parametrize("attr", ["trace", "flight", "telemetry",
                                  "telemetry_interval_s",
                                  "telemetry_slo_ms", "tracking_uri"])
def test_ported_serve_flags_run(attr, tmp_path, monkeypatch, capsys):
    """The observability flags that exited 2 before they were ported:
    ``serve`` comes up and answers with JAX's effect (the interval and
    the SLO ride with ``--telemetry``, as in JAX, where they refine the
    ring it turns on), then stops on the interrupt with rc 0."""
    import json
    import time
    import urllib.request
    from split_learning_tpu_torch.launch import run
    path = str(tmp_path / "out.json")
    flags = {"trace": ["--trace", path], "flight": ["--flight", path],
             "telemetry": ["--telemetry"],
             "telemetry_interval_s": ["--telemetry",
                                      "--telemetry-interval-s", "0.5"],
             "telemetry_slo_ms": ["--telemetry", "--telemetry-slo-ms",
                                  "100"],
             "tracking_uri": ["--tracking-uri", "http://mlflow:5000"]}[attr]
    got = {}
    real = run.serve_party

    def serve_party(args):
        out = real(args)
        got["url"] = out[1].url
        return out

    class Clock:
        def sleep(self, _):
            for route in ("/telemetry", "/debug/flight", "/health"):
                try:
                    with urllib.request.urlopen(got["url"] + route,
                                                timeout=10) as r:
                        got[route] = r.read()
                except urllib.error.HTTPError as e:
                    got[route] = e.code
            raise KeyboardInterrupt

        def __getattr__(self, name):
            return getattr(time, name)
    monkeypatch.setattr(run, "serve_party", serve_party)
    monkeypatch.setattr(run, "time", Clock())
    rc = main(["serve", "--device", "cpu", "--port", "0", "--host",
               "127.0.0.1", *flags])
    assert rc == 0 and "not ported yet" not in capsys.readouterr().err
    on = {"flight": "/debug/flight"}.get(attr, "/telemetry"
                                         if "telemetry" in attr else None)
    for route in ("/telemetry", "/debug/flight"):
        assert (got[route] != 404) == (route == on), (route, got[route])
    if attr == "trace":
        events = json.load(open(path))
        assert any(e["name"] == "mesh_meta" for e in events)
    elif attr == "flight":
        assert json.load(open(path))["reason"] == "exit"
    elif on == "/telemetry":
        dump = json.loads(got["/telemetry"])
        assert dump["interval_s"] == (0.5 if attr == "telemetry_interval_s"
                                      else 1.0)
        slo = dump["slo"]
        assert (slo is not None) == (attr == "telemetry_slo_ms")


_PORTED_SERVE_FLAGS = {
    "remat": ["--remat"], "replicas": ["--replicas", "2"],
    "replica_sync_every": ["--replicas", "2", "--replica-sync-every", "4"],
    "handoff": ["--replicas", "2", "--handoff", "checkpoint"],
    "autoscale": ["--autoscale"],
    "autoscale_min": ["--autoscale", "--autoscale-min", "2"],
    "autoscale_max": ["--autoscale", "--autoscale-max", "3"],
    "autoscale_cooldown_s": ["--autoscale", "--autoscale-cooldown-s", "1"],
}


@pytest.mark.parametrize("attr", sorted(_PORTED_SERVE_FLAGS))
def test_replica_and_remat_serve_flags_run(attr, monkeypatch, capsys):
    """The serve flags that exited 2 before they were ported: ``serve``
    comes up; ``/health`` carries the group's ``replicas`` block (JAX's
    keys) for a replicated or elastic server, and ``--autoscale`` turns
    the telemetry ring on and prints the policy banner."""
    import time
    import urllib.error
    import urllib.request
    from split_learning_tpu_torch.launch import run
    got = {}
    real = run.serve_party

    def serve_party(args):
        out = real(args)
        got["url"], got["runtime"] = out[1].url, out[0]
        return out

    class Clock:
        def sleep(self, _):
            for route in ("/health", "/telemetry"):
                try:
                    with urllib.request.urlopen(got["url"] + route,
                                                timeout=10) as r:
                        got[route] = r.read()
                except urllib.error.HTTPError as e:
                    got[route] = e.code
            raise KeyboardInterrupt

        def __getattr__(self, name):
            return getattr(time, name)
    monkeypatch.setattr(run, "serve_party", serve_party)
    monkeypatch.setattr(run, "time", Clock())
    flags = _PORTED_SERVE_FLAGS[attr]
    rc = main(["serve", "--device", "cpu", "--port", "0", "--host",
               "127.0.0.1", *flags])
    err = capsys.readouterr().err
    assert rc == 0 and "not ported yet" not in err
    health = codec.decode(got["/health"])
    grouped = attr != "remat"
    assert ("replicas" in health) == grouped
    if grouped:
        block = health["replicas"]
        want_n = {"autoscale_min": 2}.get(
            attr, 2 if "--replicas" in flags else 1)
        assert block["n"] == want_n and block["live"] == list(range(want_n))
        assert block["handoff"] == ("checkpoint" if attr == "handoff"
                                    else "live")
        assert block["sync_every"] == (4 if attr == "replica_sync_every"
                                       else 0)
    elastic = "--autoscale" in flags
    assert ("[autoscale] policy on:" in err) == elastic
    assert (got["/telemetry"] != 404) == elastic
    if attr == "remat":
        assert got["runtime"]._stage.remat


@pytest.mark.parametrize("flags,msg", [
    (["--compress-density", "1.5"], "--compress-density must be in"),
    (["--chaos", "drop_response=0.1"], "unknown chaos kind"),
])
def test_serve_refuses_bad_arguments(flags, msg, capsys):
    assert main(["serve", "--device", "cpu", "--port", "0", *flags]) == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("flags,msg", [
    (["--chaos", "dup=2"], "in [0, 1]"),
    (["--pipeline-depth", "0"], "--pipeline-depth must be >= 1"),
])
def test_train_over_http_refuses_bad_arguments(flags, msg, tmp_path,
                                               capsys):
    rc = main(_train_args("http://127.0.0.1:9", tmp_path, "--steps", "1",
                          *flags))
    assert rc == 2
    assert msg in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
