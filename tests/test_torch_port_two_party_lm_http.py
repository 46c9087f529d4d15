"""The two-party transformer over HTTP against the JAX pair, on the CPU.

The port's ``SplitClientTrainer`` over ``HttpTransport`` to a port
``SplitHTTPServer`` tracks the JAX client over JAX's ``HttpTransport``
to JAX's server (the causal LM, AdamW with warmup, cosine decay and
clipping, float32 on the dense wire and bfloat16 on int8 and topk8,
within the bounds of tests/test_torch_port_two_party_lm.py); the port's
request frames are byte-equal to the JAX client's for the same float32
LM cut tensors; and ``serve`` and ``train --transport http`` take the
optimizer and dtype flags. Every server binds port 0 and stops in
``finally``; every transport and wait has a timeout.
"""

import io
import os
import queue
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.transport import HttpTransport, SplitHTTPServer

from test_torch_port_two_party_lm import (
    B, T, V, _assert_tracks, _data, _jax_client, _jax_server, _port_client,
    _port_server, _train)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0


def _run_http(server_rt, server_cls, transport_cls, client_fn, data,
              compress):
    srv = server_cls(server_rt).start()
    t = transport_cls(srv.url, timeout=TIMEOUT, compress=compress)
    try:
        return _train(client_fn(t), data)
    finally:
        t.close()
        srv.stop()


@pytest.mark.parametrize("dtype,compress", [("float32", "none"),
                                            ("bfloat16", "int8"),
                                            ("bfloat16", "topk8")])
def test_lm_pair_over_http_tracks_jax_pair(dtype, compress):
    model = "transformer_lm"
    data = _data(model)
    j_losses = _run_http(_jax_server(model, dtype, data), JaxHTTPServer,
                         JaxHttp, lambda t: _jax_client(model, dtype, t),
                         data, compress)
    losses = _run_http(_port_server(model, dtype, data), SplitHTTPServer,
                       HttpTransport,
                       lambda t: _port_client(model, dtype, data, t), data,
                       compress)
    _assert_tracks(losses, j_losses, dtype, compress)


def _capture(server):
    bodies = []
    handler = server._httpd.RequestHandlerClass
    do_post = handler.do_POST

    def capturing(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        bodies.append((self.path, raw))
        self.rfile = io.BytesIO(raw)
        do_post(self)

    handler.do_POST = capturing
    return bodies


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
def test_lm_request_frames_byte_equal_to_jax(compress):
    """The same float32 LM cut tensors ``[B, T, E]`` and labels ``[B, T]``
    through the port's client transport (tensors) and JAX's (numpy):
    every request frame byte-equal, over three steps."""
    data = _data("transformer_lm")
    rs = np.random.RandomState(7)
    sends = [(rs.randn(B, T, 32).astype(np.float32),
              rs.randint(0, V, (B, T)).astype(np.int32)) for _ in range(3)]
    frames = {}
    for side in ("jax", "port"):
        srv = SplitHTTPServer(_port_server("transformer_lm", "float32",
                                           data)).start()
        bodies = _capture(srv)
        cls = JaxHttp if side == "jax" else HttpTransport
        t = cls(srv.url, timeout=TIMEOUT, compress=compress)
        try:
            for i, (acts, labels) in enumerate(sends):
                if side == "port":
                    acts, labels = (torch.from_numpy(acts),
                                    torch.from_numpy(labels))
                t.split_step(acts, labels, i)
        finally:
            t.close()
            srv.stop()
        frames[side] = bodies
    assert len(frames["port"]) == 3
    assert frames["port"] == frames["jax"]


def _cli(tmp_path, *extra):
    return ["--device", "cpu", "--model", "transformer_lm", "--dataset",
            "lm", "--seq-len", "16", "--d-model", "32", "--num-heads", "2",
            "--client-depth", "1", "--server-depth", "1", "--attn",
            "flash", "--batch-size", "4", "--data-dir", str(tmp_path),
            "--dtype", "bfloat16", "--optimizer", "adamw", "--lr", "3e-3",
            "--weight-decay", "0.1", "--warmup-steps", "2",
            "--decay-steps", "10", "--grad-clip-norm", "1.0", *extra]


def test_cli_serve_and_train_over_http_with_the_new_flags(tmp_path, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
         "serve", "--port", "0", "--host", "127.0.0.1", *_cli(tmp_path)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        first = lines.get(timeout=120)
        assert "listening on http://127.0.0.1:" in first, first
        url = first.split("listening on ")[1].strip()
        rc = main(["train", "--transport", "http", "--server-url", url,
                   "--compress", "int8", "--steps", "6", "--tracking",
                   "stdout", "--wait-server", "30", *_cli(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 0
        assert "[transport] http compress=int8 round_trips=6 " in out
        done = next(ln for ln in out.splitlines() if ln.startswith("[done]"))
        assert "transport=http steps=6" in done
        assert np.isfinite(float(done.split("final_loss=")[1].split()[0]))
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
