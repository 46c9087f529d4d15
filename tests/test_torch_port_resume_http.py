"""``serve --checkpoint-dir --resume`` with ``train --transport http
--resume`` on the CPU, and the refusals around them.

- Per wire mode (``none``, ``int8``, ``topk8``): ``serve
  --checkpoint-every 1`` in a subprocess and an in-process client train
  3 steps with checkpoints; the server stops (SIGINT) and restarts with
  ``--resume``; the last step's request, sent again, is answered with
  the original frame byte for byte (the sidecar's replay cache); the
  client resumes for 3 more steps, and the 6 losses are the
  uninterrupted run's, bit for bit.
- A resumed client against a fresh server exits 3; ``serve --resume``
  on a joint directory restores its server subtree (remote eval equals
  local eval; the joint meta stays), on a client-only one exits 2 (``no
  server subtree``).

Every wait has a timeout; a server that does not stop is killed.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.parse

import pytest

from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.runtime import checkpoint as ckpt
from split_learning_tpu_torch.transport import http as http_mod

from test_torch_port_resume import CNN_FLAGS, port, small_data, take_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_FLAGS = ["--dataset", "synthetic", "--batch-size", "16", "--lr",
              "0.02"]
TIMEOUT = 60


class _Serve:
    """``serve --device cpu`` in a subprocess: its URL, SIGINT, rc."""

    def __init__(self, tmp_path, *flags):
        self.err = open(tmp_path / "serve.err", "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
             "serve", "--device", "cpu", "--host", "127.0.0.1", "--port",
             "0", *flags], cwd=REPO, stdout=subprocess.PIPE,
            stderr=self.err, text=True)
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln)
                                         for ln in self.proc.stdout],
                         daemon=True).start()
        try:
            first = lines.get(timeout=TIMEOUT)
        except queue.Empty:
            first = ""
        if "listening on " not in first:
            self.stop()
            raise AssertionError(f"serve printed {first!r}: "
                                 f"{open(tmp_path / 'serve.err').read()}")
        self.url = first.split("listening on ")[1].strip()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                return self.proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=TIMEOUT)
                raise
        self.err.close()
        return self.proc.returncode


def _client(url, data_dir, *extra):
    return main(["train", "--device", "cpu", "--transport", "http",
                 "--server-url", url, "--data-dir", small_data(data_dir),
                 "--tracking", "jsonl", "--wait-server", "30", *HTTP_FLAGS,
                 *extra])


def _capture_replies(monkeypatch):
    """Every POST the port's HttpTransport makes: (path, request body,
    reply body)."""
    seen = []
    orig = http_mod.HttpTransport._request

    def request(self, method, path, body=None):
        resp, content = orig(self, method, path, body)
        if method == "POST":
            seen.append((path, body, content))
        return resp, content
    monkeypatch.setattr(http_mod.HttpTransport, "_request", request)
    return seen


def _post(url, path, body):
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=TIMEOUT)
    try:
        crc = str(http_mod.codec.checksum(body))
        conn.request("POST", path, body=body, headers={
            "Content-Type": "application/msgpack",
            http_mod.CRC_HEADER: crc})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
def test_http_resume_of_both_halves(compress, tmp_path, monkeypatch):
    wire = ["--compress", compress]
    srv = _Serve(tmp_path, *wire)
    try:
        assert _client(srv.url, tmp_path / "a", *wire, "--steps", "6") == 0
    finally:
        assert srv.stop() == 0
    whole = take_losses(tmp_path / "a")

    sdir, cdir = str(tmp_path / "s"), str(tmp_path / "c")
    srv = _Serve(tmp_path, *wire, "--checkpoint-dir", sdir,
                 "--checkpoint-every", "1")
    seen = _capture_replies(monkeypatch)
    try:
        assert _client(srv.url, tmp_path / "b", *wire, "--steps", "3",
                       "--checkpoint-dir", cdir) == 0
    finally:
        assert srv.stop() == 0
    first = take_losses(tmp_path / "b")
    assert sorted(n for n in os.listdir(sdir) if n.isdigit()) == [
        "1", "2", "3"]
    extras = ckpt.read_latest_extras(sdir, step=3)
    assert extras is not None and ckpt.extras_valid(extras)
    path, request, reply = seen[-1]

    srv = _Serve(tmp_path, *wire, "--checkpoint-dir", sdir, "--resume")
    try:
        # the in-flight step again: the pre-restart frame, byte for byte
        status, again = _post(srv.url, path, request)
        assert status == 200 and again == reply
        assert _client(srv.url, tmp_path / "b", *wire, "--steps", "3",
                       "--checkpoint-dir", cdir, "--resume") == 0
    finally:
        assert srv.stop() == 0
    second = take_losses(tmp_path / "b")
    assert first + second == whole


def test_resumed_client_refuses_a_fresh_server(tmp_path, capsys):
    cdir = str(tmp_path / "c")
    srv = _Serve(tmp_path)
    try:
        assert _client(srv.url, tmp_path / "a", "--steps", "2",
                       "--checkpoint-dir", cdir) == 0
    finally:
        srv.stop()
    srv = _Serve(tmp_path)   # fresh: its acknowledged step is -1
    try:
        assert _client(srv.url, tmp_path / "a", "--steps", "2",
                       "--checkpoint-dir", cdir, "--resume") == 3
        assert "the server half was not resumed" in capsys.readouterr().err
    finally:
        srv.stop()


def test_serve_resumes_the_server_half_of_a_joint_checkpoint(tmp_path):
    """``serve --resume`` on a directory ``train --transport local``
    wrote: the server subtree comes back (remote eval equals local
    eval), its own saves go to ``server_party/``, the joint meta stays."""
    jdir = str(tmp_path / "joint")
    port(tmp_path / "a", CNN_FLAGS + ["--transport", "local"], "--steps",
         "3", "--checkpoint-dir", jdir)
    local = _eval(tmp_path / "a", jdir)
    srv = _Serve(tmp_path, "--checkpoint-dir", jdir, "--resume",
                 "--data-dir", small_data(tmp_path / "a"))
    try:
        remote = _eval(tmp_path / "a", jdir, "--server-url", srv.url)
    finally:
        assert srv.stop() == 0
    assert remote["accuracy"] == local["accuracy"]
    assert abs(remote["loss"] - local["loss"]) <= 1e-4 + 1e-9
    assert json.load(open(os.path.join(jdir, "meta.json")))["layout"] == \
        "split_local"
    assert json.load(open(os.path.join(jdir, "server_party",
                                       "meta.json")))["layout"] == \
        "server_only"


def _eval(data_dir, ckdir, *extra):
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["eval", "--device", "cpu", "--checkpoint-dir", ckdir,
                     "--data-dir", str(data_dir), *extra]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_serve_resume_rejects_a_serverless_layout(tmp_path, capsys):
    cdir = str(tmp_path / "c")
    srv = _Serve(tmp_path)
    try:
        assert _client(srv.url, tmp_path / "a", "--steps", "1",
                       "--checkpoint-dir", cdir) == 0
    finally:
        srv.stop()
    assert json.load(open(os.path.join(cdir, "meta.json")))["layout"] == \
        "client_only"
    rc = main(["serve", "--device", "cpu", "--port", "0",
               "--checkpoint-dir", cdir, "--resume"])
    assert rc == 2
    assert "no server subtree" in capsys.readouterr().err
