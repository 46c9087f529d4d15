"""The observability flags of the port's command line, and MLflow over
REST, against the JAX package's, on the CPU:

- ``MlflowRestLogger`` sends JAX's request sequence (endpoints and
  bodies, timestamps aside) to the stub tracking server of
  ``tests/test_mlflow_rest.py``; ``make_logger`` degrades as JAX's does
  (REST for an http(s) URI without the package, else stdout, with JAX's
  stderr lines);
- ``train --flight --profile-dir --trace --tracking mlflow`` on the
  two-party path: one ``loss`` a step and a finished run land in the
  stub, the flight dump renders through ``scripts/postmortem.py``, the
  trace carries the server's MFU sidecar, the profile directory a
  device trace; with every flag off the losses, the wire bytes and the
  kernel launch counts are bit-identical (the CPU launches none);
- ``serve --trace --telemetry --flight`` answers ``GET /telemetry`` and
  ``GET /debug/flight`` while a client trains, and writes its trace at
  shutdown;
- the chain's ``--telemetry-port 0`` serves the hub's ring and prints
  the fleet view, which names a bottleneck party.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from split_learning_tpu.tracking import mlflow_rest as jax_mlflow_rest
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.launch import run
from split_learning_tpu_torch.obs import flight, spans, telemetry
from split_learning_tpu_torch.ops.common import LAUNCHES
from split_learning_tpu_torch.tracking import (
    MlflowLogger, StdoutLogger, make_logger)
from split_learning_tpu_torch.tracking.mlflow_rest import MlflowRestLogger
from split_learning_tpu_torch.utils.config import Config
from test_mlflow_rest import _StubMlflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _planes_off():
    flight.disable()
    telemetry.disable()
    obs.disable()
    yield
    flight.disable()
    telemetry.disable()
    obs.disable()


@pytest.fixture()
def stub():
    """The JAX test's stub MLflow server, recording each request as
    (endpoint, body without its timestamps)."""
    log = []

    class Recording(_StubMlflow):
        store = {"experiments": {}, "runs": {}}

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.loads(raw or b"{}")
            log.append((self.path.split("/api/2.0/mlflow/", 1)[-1],
                        {k: v for k, v in body.items()
                         if k not in ("timestamp", "start_time",
                                      "end_time")}))
            import io
            self.rfile = io.BytesIO(raw)
            super().do_POST()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Recording)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}", Recording.store, log
    finally:
        srv.shutdown()
        srv.server_close()


def _session(cls, uri):
    with cls("split", tracking_uri=uri) as lg:
        lg.log_params({"lr": 0.01, "batch_size": 64})
        for step, loss in enumerate([2.3, 1.9, 1.4]):
            lg.log_metric("loss", loss, step=step)
    cls("split", tracking_uri=uri, run_name="second").close()


def test_mlflow_rest_requests_equal_jaxs(stub):
    uri, store, log = stub
    _session(jax_mlflow_rest.MlflowRestLogger, uri)
    jax_log = list(log)
    store["experiments"].clear()
    store["runs"].clear()
    log.clear()
    _session(MlflowRestLogger, uri)
    assert log == jax_log
    assert [p for p, _ in log][:3] == ["experiments/get-by-name",
                                       "experiments/create", "runs/create"]
    (run1, r1), (run2, r2) = sorted(store["runs"].items())
    assert r1["run_name"] == "Split_Training" and r2["run_name"] == "second"
    assert r1["metrics"] == [("loss", 2.3, 0), ("loss", 1.9, 1),
                             ("loss", 1.4, 2)]
    assert r1["status"] == r2["status"] == "FINISHED"


def test_make_logger_degrades_as_jaxs(stub, monkeypatch, capsys):
    uri, store, _ = stub
    monkeypatch.setitem(sys.modules, "mlflow", None)   # no package
    with pytest.raises(ImportError):
        MlflowLogger("split")
    lg = make_logger(Config(tracking="mlflow", tracking_uri=uri))
    assert isinstance(lg, MlflowRestLogger)
    assert capsys.readouterr().err == (
        "[tracking] mlflow package unavailable; using the REST protocol "
        "directly\n")
    lg.log_metric("loss", 0.5, step=7)
    lg.close()
    (_, r), = store["runs"].items()
    assert r["metrics"] == [("loss", 0.5, 7)]
    lg = make_logger(Config(tracking="mlflow",
                            tracking_uri="http://127.0.0.1:9"))
    assert isinstance(lg, StdoutLogger)
    assert "unusable" in capsys.readouterr().err
    lg = make_logger(Config(tracking="mlflow", tracking_uri="file:/x"))
    assert isinstance(lg, StdoutLogger)
    assert capsys.readouterr().err == (
        "[tracking] mlflow unavailable; falling back to stdout\n")


def _train(tmp_path, *flags):
    return ["train", "--device", "cpu", "--transport", "local",
            "--compress", "int8", "--steps", "4", "--batch-size", "16",
            "--dataset", "synthetic", "--data-dir", str(tmp_path / "d"),
            *flags]


def _wire(err):
    return re.search(r"bytes_sent=(\d+) bytes_received=(\d+)", err).groups()


def test_train_flags_on_and_off(tmp_path, stub, capsys, monkeypatch):
    uri, store, _ = stub
    monkeypatch.setitem(sys.modules, "mlflow", None)
    LAUNCHES.reset()
    assert run.main(_train(tmp_path, "--tracking", "jsonl")) == 0
    off_launches = LAUNCHES.snapshot()
    off = capsys.readouterr()
    jsonl = tmp_path / "d" / "metrics" / "Split_Learning_Sim.jsonl"
    off_losses = [json.loads(line)["value"] for line in open(jsonl)
                  if '"loss"' in line]
    LAUNCHES.reset()
    fl, tr, prof = (str(tmp_path / "f.json"), str(tmp_path / "t.json"),
                    str(tmp_path / "prof"))
    assert run.main(_train(tmp_path, "--tracking", "mlflow",
                           "--tracking-uri", uri, "--flight", fl,
                           "--trace", tr, "--profile-dir", prof)) == 0
    on = capsys.readouterr()
    assert LAUNCHES.snapshot() == off_launches
    (_, r), = store["runs"].items()
    losses = [v for k, v, _ in r["metrics"] if k == "loss"]
    assert [s for k, _, s in r["metrics"] if k == "loss"] == [0, 1, 2, 3]
    assert losses == off_losses and r["status"] == "FINISHED"
    assert _wire(on.out) == _wire(off.out)
    assert "[profile] transport fraction:" in on.err
    assert os.path.isfile(os.path.join(prof, "device_trace.json"))
    meta = [e for e in json.load(open(tr)) if e["name"] == spans.MESH_META]
    assert meta[0]["args"]["programs"]["split_step"]["calls"] == 4
    dump = json.load(open(fl))
    assert dump["reason"] == "exit" and dump["party"] == "client"
    out = subprocess.run([sys.executable,
                          os.path.join(ROOT, "scripts", "postmortem.py"),
                          fl], capture_output=True, text=True, timeout=120)
    assert out.stdout.rstrip().splitlines()[-1].startswith(
        "anomalies: none")
    assert not flight.enabled() and obs.get_tracer() is None


def _serve_once(monkeypatch, argv, during):
    """``serve`` in this process: ``during(url)`` runs where ``cmd_serve``
    waits for SIGINT, then the wait is interrupted."""
    got = {}
    real = run.serve_party

    def serve_party(args):
        out = real(args)
        got["url"] = out[1].url
        return out

    class Clock:
        def sleep(self, _):
            during(got["url"])
            raise KeyboardInterrupt

        def __getattr__(self, name):
            return getattr(time, name)
    monkeypatch.setattr(run, "serve_party", serve_party)
    monkeypatch.setattr(run, "time", Clock())
    return run.main(argv)


def test_serve_trace_telemetry_and_flight(tmp_path, monkeypatch, capsys):
    seen = {}

    def during(url):
        client = ["train", "--device", "cpu", "--transport", "http",
                  "--server-url", url, "--steps", "5", "--batch-size", "8",
                  "--dataset", "synthetic", "--data-dir",
                  str(tmp_path / "d"), "--tracking", "noop"]
        rc = subprocess.run([sys.executable, "-m",
                             "split_learning_tpu_torch.launch.run",
                             *client], capture_output=True, text=True,
                            timeout=300, cwd=ROOT).returncode
        seen["rc"] = rc
        time.sleep(0.6)   # one more telemetry window closes
        with urllib.request.urlopen(url + "/telemetry", timeout=10) as r:
            seen["tel"] = json.loads(r.read())
        with urllib.request.urlopen(url + "/debug/flight", timeout=10) as r:
            seen["fl"] = json.loads(r.read())
    tr = str(tmp_path / "st.json")
    rc = _serve_once(monkeypatch, [
        "serve", "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
        "--trace", tr, "--flight", str(tmp_path / "sf.json"),
        "--telemetry", "--telemetry-interval-s", "0.25",
        "--telemetry-slo-ms", "5000", "--tracking-uri",
        "http://127.0.0.1:9"], during)
    assert rc == 0 and seen["rc"] == 0
    windows = seen["tel"]["windows"]
    assert sum(w["counters"].get("split_steps_total", 0)
               for w in windows) == 5
    assert any(spans.DISPATCH in w["percentiles"] for w in windows)
    assert seen["tel"]["slo"]["objectives"][0]["slo_ms"] == 5000.0
    recv = [e for e in seen["fl"]["events"] if e["name"] == spans.FL_RECV]
    assert sorted(e["step"] for e in recv) == list(range(5))
    meta = [e for e in json.load(open(tr)) if e["name"] == spans.MESH_META]
    assert meta[0]["args"]["programs"]["split_step"]["calls"] == 5
    assert json.load(open(tmp_path / "sf.json"))["reason"] == "exit"
    assert not telemetry.enabled() and obs.get_tracer() is None


def test_chain_telemetry_port_names_a_bottleneck(tmp_path, capsys):
    tr = str(tmp_path / "ch.json")
    assert run.main(["train", "--device", "cpu", "--model",
                     "split_cnn_chain3", "--stages", "3", "--transport",
                     "device", "--microbatches", "2", "--dataset",
                     "synthetic", "--data-dir", str(tmp_path / "d"),
                     "--steps", "3", "--batch-size", "8",
                     "--telemetry-port", "0", "--trace", tr]) == 0
    err = capsys.readouterr().err
    assert re.search(r"\[telemetry\] hub /telemetry on port \d+", err)
    fleet = json.loads(err.split("[telemetry] fleet ", 1)[1].splitlines()[0])
    assert fleet["critical_path"] and fleet["bottlenecks"]
    assert set(fleet["bottlenecks"]) <= {"hub", "stage1", "stage2"}
    meta = [e for e in json.load(open(tr)) if e["name"] == spans.STAGE_META]
    stages = meta[0]["args"]["stages"]
    assert [s["stage"] for s in stages] == [1, 2]
    assert all("mfu" in s and s["mfu"] is None for s in stages)  # the CPU
    assert not telemetry.enabled() and obs.get_tracer() is None
