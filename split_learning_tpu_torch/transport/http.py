"""HTTP transport: the reference's routes over a real socket
(counterpart of ``split_learning_tpu/transport/http.py``).

The route layout is the reference server's: ``POST /forward_pass``
(``src/server_part.py:25``), ``POST /aggregate_weights``
(``src/server_part.py:60``), ``GET /health`` (``src/server_part.py:95``),
plus ``POST /predict``, ``POST /u_forward``, ``POST /u_backward`` and
``GET /metrics``, and the K-stage chain's ``POST /hop_forward``,
``/hop_backward`` and ``/hop_loss`` (served by a ``StageRuntime``,
``runtime/stage.py``; each keyed by ``hop_seq(step, mb)`` in the replay
cache and the chaos schedule, each reply echoing its ``step`` and
``mb``). Bodies are the msgpack frames of ``transport/codec.py``
(never pickle), each with a CRC-32 in the ``X-SLT-CRC32`` header, both
ways; the frames are JAX's byte for byte, so a JAX client talks to this
server and this client to a JAX server. A hop's payload compresses as
the two-party cut does: the client transport is bound to one stage and
the stage's reply ledger keys ``(client, path)``, so each hop wire is
its own error-feedback endpoint; labels travel dense. The client counts
2 host copies a hop (``spans.HOP_HOST_COPIES``: the request's encode
and the reply's decode), the contrast of ``DeviceTransport``'s 0.

Status mapping, as in JAX: 400 = a request the server cannot take or a
bad frame, 409 = a step-handshake violation (both permanent: the client
raises ``ProtocolError``), 429 = admission refused (``Backpressure``,
with ``Retry-After``), 500 = a server fault (transient:
``TransportError``). An op of another mode is the runtime's 400; an op
the port does not run yet reaches the runtime, whose error (naming its
ROADMAP item) comes back as a 500. The FedAvg route carries JAX's
parameter tree, dense both ways (weights are never compressed).

Both sides are the standard library: :class:`SplitHTTPServer` on
``http.server.ThreadingHTTPServer`` (HTTP/1.0: one connection a
request), :class:`HttpTransport` on ``http.client``, one connection per
calling thread, reopened after each of the server's closes; a handshake
that stalls is retried on a fresh socket within the request's timeout.

Where the arithmetic runs follows the tensors, as on the in-process
wire: the server decodes a request on its runtime's device (a compressed
cut is expanded by the dequantize kernel or the topk8 scatter on the
card) and packs its reply there (K3, or the five topk8 select launches);
the client packs a CUDA tensor on the card with one host copy a frame
and decodes the reply on the request tensor's device (numpy for a numpy
caller). A runtime without ``device`` (JAX's) gets numpy.

Server requests run on the handler threads of ``ThreadingHTTPServer``,
all on the default CUDA stream: the kernels' per-stream scratch buffers
(K1, K4) rely on that. ``GET /debug/flight`` serves the flight
recorder's ring as JSON and ``GET /telemetry`` the telemetry ring's
windows (JAX's schemas); each answers 404 with JAX's off-path body while
its recorder is off. With the recorder on, the server journals each
request (``FL_RECV``, with the client's trace ID) and each injected
fault (``FL_CHAOS``), the client each post and reply (``FL_SEND``,
``FL_RECV``) and each hop (``FL_HOP_SEND``, ``FL_HOP_RECV``).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from split_learning_tpu_torch import __version__
from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.obs.metrics import render_prometheus
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError, backoff_delays, device_of,
    timed)
from split_learning_tpu_torch.transport.chaos import CHAOS_OPS, _AttemptCounter

CRC_HEADER = "X-SLT-CRC32"
COMPRESS_MODES = ("none", "int8", "topk8", "clapping")
# ops that carry a per-step trace id when tracing is on
_TRACED_PATHS = ("/forward_pass", "/u_forward", "/u_backward")
# wire path -> the runtime's replay-cache op (runtime/replay.py)
_OP_BY_PATH = {"/forward_pass": "split_step", "/u_forward": "u_forward",
               "/u_backward": "u_backward", "/hop_forward": "hop_fwd",
               "/hop_backward": "hop_bwd", "/hop_loss": "hop_loss"}
# the K-stage chain's hop ops, served by a stage runtime and keyed by the
# composite hop_seq(step, mb) ordinal
_HOP_PATHS = ("/hop_forward", "/hop_backward", "/hop_loss")
_OCTETS = "application/octet-stream"
# the most one TCP handshake may take before the client gives it up and
# opens a fresh socket (a loopback handshake takes microseconds; one that
# stalls has lost its SYN and would wait out the kernel's retransmits)
CONNECT_ATTEMPT_S = 5.0


def _as_leaf(x: Any) -> Any:
    """A tensor as it is (the codec encodes it where it lives), anything
    else as numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


class SplitHTTPServer:
    """Serves a server runtime over HTTP (the port's ``ServerRuntime``,
    or any object with its ops, JAX's included).

    ``compress``/``density`` are the defaults for reply packing; a
    request's own ``compress``/``density`` keys win. ``chaos`` is an
    optional :class:`~.chaos.ChaosPolicy` injecting server-side faults on
    the seeded schedule: http500 and drop_req before the runtime applies
    anything, drop_resp (reply discarded after apply) and corrupt (bad
    reply CRC) after, delay before; dup passes (a client act).
    ``telemetry`` is the ``obs/telemetry.py`` ring behind this server's
    ``GET /telemetry`` (default: the process's global ring)."""

    def __init__(self, runtime: Any, host: str = "127.0.0.1",
                 port: int = 0, compress: str = "none",
                 density: float = 0.1, chaos: Optional[Any] = None,
                 telemetry: Optional[Any] = None) -> None:
        if compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compression {compress!r}")
        self.runtime = runtime
        self.telemetry = telemetry
        self.chaos = chaos
        self._chaos_attempts = _AttemptCounter()
        self.default_compress = compress
        self.default_density = float(density)
        # where requests are decoded: the runtime's device, or numpy. A
        # party on a mesh takes host arrays, as JAX's does: its _to_dev
        # places them on the mesh and its replies leave through its
        # sanctioned gather (runtime/party.py)
        self.device: Optional[torch.device] = (
            None if getattr(runtime, "_mesh", None) is not None
            else getattr(runtime, "device", None))
        # reply-direction error feedback: the runtime's ledger when it
        # has one; this one serves bare runtimes
        self._wire_ef = codec.make_wire_ef(
            "clapping" if compress == "clapping" else "topk8")
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- reply packing (one place, so a harness can wrap it) ------------ #
    def _pack_reply(self, arr: Any, key: Tuple[int, str], mode: str,
                    density: float) -> Any:
        """A step reply in ``mode``; topk8 through the error-feedback
        ledger keyed ``(client_id, path)``."""
        if mode in ("topk8", "clapping"):
            ef = getattr(self.runtime, "wire_ef", None) or self._wire_ef
            return ef.compress(key, _as_leaf(arr), density,
                               decay=codec.ef_decay_for(key[1]))
        return self._pack_stateless(arr, mode, density)

    def _pack_stateless(self, arr: Any, mode: str, density: float) -> Any:
        """A reply with no error feedback: inference, and a step result
        rebuilt for a replay (its residual was already folded once)."""
        if mode in ("topk8", "clapping"):
            return codec.topk8_pack(_as_leaf(arr), density)
        if mode == "int8":
            return codec.q8_compress(_as_leaf(arr))
        return arr

    def _draw_fault(self, path: str, cid: int,
                    key_seq: Optional[int]) -> Optional[Tuple[str, float]]:
        """One seeded draw per delivery attempt of a step op."""
        if self.chaos is None or path not in CHAOS_OPS or key_seq is None:
            return None
        attempt = self._chaos_attempts.next((cid, path, key_seq))
        fault = self.chaos.draw(path, key_seq, attempt)
        if fault is not None:
            self.chaos.count(fault[0])
        return fault

    def _dispatch(self, path: str, req: Dict[str, Any], cid: int,
                  pack) -> Optional[Dict[str, Any]]:
        """Run ``path``'s op on the runtime; the reply dict, or None for
        an unknown path."""
        rt = self.runtime
        if path == "/forward_pass":
            grads, loss = rt.split_step(req["activations"], req["labels"],
                                        int(req["step"]), cid)
            return {"grads": pack(grads), "loss": loss,
                    "step": req["step"]}
        if path == "/u_forward":
            return {"features": pack(rt.u_forward(
                req["activations"], int(req["step"]), cid))}
        if path == "/u_backward":
            return {"grads": pack(rt.u_backward(
                req["feat_grads"], int(req["step"]), cid))}
        if path in _HOP_PATHS:
            step, mb = int(req["step"]), int(req.get("mb", 0))
            echo = {"step": req["step"], "mb": req.get("mb", 0)}
            if path == "/hop_forward":
                return {"y": pack(rt.hop_forward(req["x"], step, mb, cid)),
                        **echo}
            if path == "/hop_backward":
                return {"grads": pack(rt.hop_backward(req["g"], step, mb,
                                                      cid)), **echo}
            g, loss = rt.hop_loss(req["x"], req["labels"], step, mb, cid)
            return {"grads": pack(g), "loss": loss, **echo}
        if path == "/predict":
            return {"outputs": pack(rt.predict(req["activations"], cid))}
        if path == "/aggregate_weights":
            n_ex = req.get("num_examples")
            return {"model_state": rt.aggregate(
                req["model_state"], int(req["epoch"]), float(req["loss"]),
                int(req["step"]), int(n_ex) if n_ex is not None else None)}
        return None

    def _replayed(self, op: str, req: Dict[str, Any], cached: Any,
                  mode: str, density: float) -> Dict[str, Any]:
        """The reply to a duplicate whose first delivery left a result
        but no wire bytes, packed statelessly: running the error feedback
        again for a step it already packed would corrupt its ledger."""
        def pack(a):
            return self._pack_stateless(a, mode, density)
        if op == "split_step":
            return {"grads": pack(cached[0]), "loss": cached[1],
                    "step": req["step"]}
        if op == "u_forward":
            return {"features": pack(cached)}
        echo = {"step": req.get("step"), "mb": req.get("mb", 0)}
        if op == "hop_fwd":
            return {"y": pack(cached), **echo}
        if op == "hop_loss":
            return {"grads": pack(cached[0]), "loss": cached[1], **echo}
        if op == "hop_bwd":
            return {"grads": pack(cached), **echo}
        return {"grads": pack(cached)}

    def _handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # the headers and the body go out as two writes; without
            # TCP_NODELAY the second waits on the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass  # stats live in TransportStats and /metrics

            def _reply(self, status: int, body: bytes, ctype: str = _OCTETS,
                       crc: Optional[int] = None,
                       headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                # crc override: the chaos 'corrupt' fault ships a frame
                # the client's checksum gate must refuse
                self.send_header(CRC_HEADER, str(
                    crc if crc is not None else codec.checksum(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_200(self, body: bytes, fault) -> None:
                """The final send, honouring a post-apply chaos fault:
                the runtime already applied the update; only the reply
                is dropped (no status line at all: the client sees the
                connection close) or ships with a wrong CRC."""
                if fault is not None and fault[0] == "drop_resp":
                    self.close_connection = True
                    return
                if fault is not None and fault[0] == "corrupt":
                    self._reply(200, body,
                                crc=codec.checksum(body) ^ 0x5A5A5A5A)
                    return
                self._reply(200, body)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, codec.encode(outer.runtime.health()))
                elif self.path == "/metrics":
                    snap = (outer.runtime.metrics()
                            if hasattr(outer.runtime, "metrics") else {})
                    text = render_prometheus(snap)
                    text += f'slt_build_info{{version="{__version__}"}} 1\n'
                    self._reply(
                        200, text.encode("utf-8"),
                        ctype="text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/debug/flight":
                    # the live ring as JSON: event metadata (steps, ids,
                    # names), never tensors
                    fl = obs_flight.get_recorder()
                    if fl is None:
                        self._reply(404, codec.encode(
                            {"error": "flight recorder off "
                                      "(SLT_FLIGHT/--flight)"}))
                    else:
                        self._reply(200, json.dumps(
                            fl.dump(reason="http")).encode("utf-8"),
                            ctype="application/json")
                elif self.path == "/telemetry":
                    # advance the ring (one snapshot per elapsed window,
                    # through the runtime's own metrics()) and serialise
                    # here, outside any runtime lock
                    from split_learning_tpu_torch.obs import (
                        telemetry as obs_telemetry)
                    ring = outer.telemetry or obs_telemetry.get_ring()
                    if ring is None:
                        self._reply(404, codec.encode(
                            {"error": "telemetry off "
                                      "(SLT_TELEMETRY/--telemetry)"}))
                    else:
                        ring.advance()
                        self._reply(200, json.dumps(
                            ring.dump()).encode("utf-8"),
                            ctype="application/json")
                else:
                    self._reply(404, codec.encode({"error": "not found"}))

            def do_POST(self):
                from split_learning_tpu_torch.runtime.party import (
                    ProtocolError)
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                sent_crc = self.headers.get(CRC_HEADER)
                if sent_crc is not None:
                    try:
                        crc_ok = int(sent_crc) == codec.checksum(raw)
                    except ValueError:  # a malformed header is a bad frame
                        crc_ok = False
                    if not crc_ok:
                        self._reply(400, codec.encode(
                            {"error": "frame checksum mismatch"}))
                        return
                tid = None
                try:
                    tree = codec.decode(raw)
                    req = codec.decompress_tree(tree, outer.device)
                    cid = int(req.get("client_id", 0))
                    # the key of every per-(client, step) mechanism: the
                    # step, or a hop's composite (step, mb) ordinal
                    key_seq = int(req["step"]) if "step" in req else None
                    if key_seq is not None and self.path in _HOP_PATHS:
                        from split_learning_tpu_torch.runtime.stage import (
                            hop_seq)
                        key_seq = hop_seq(key_seq, int(req.get("mb", 0)))
                    # pre-apply faults act here; drop_resp and corrupt
                    # ride to _send_200, after the runtime applied
                    fault = outer._draw_fault(self.path, cid, key_seq)
                    fl = obs_flight.get_recorder()
                    if fl is not None:
                        # the client's trace id, explicitly: CTX adopts
                        # it only below
                        _tid = req.get("trace_id")
                        fl.record(spans.FL_RECV,
                                  step=int(req.get("step", -1)),
                                  client_id=cid, party="server",
                                  trace_id=(str(_tid) if _tid is not None
                                            else None),
                                  path=self.path)
                    if fault is not None:
                        kind, arg = fault
                        if fl is not None:
                            fl.record(spans.FL_CHAOS,
                                      step=int(req.get("step", -1)),
                                      client_id=cid, party="server",
                                      kind=kind, path=self.path)
                        if kind == "delay":
                            time.sleep(arg / 1e3)
                            fault = None
                        elif kind == "http500":
                            self._reply(500, codec.encode(
                                {"error": "chaos: injected http500"}))
                            return
                        elif kind == "drop_req":
                            self.close_connection = True
                            return
                        elif kind == "dup":
                            fault = None  # a client/network act
                    tid = req.get("trace_id")
                    if tid is not None:
                        # the runtime's server spans join the client's
                        # trace on this handler thread; echoed back below
                        obs_trace.CTX.trace_id = str(tid)
                        obs_trace.CTX.server_spans = None
                    in_raw, in_wire = codec.compressed_leaf_bytes(tree)
                    mode = req.get("compress") or outer.default_compress
                    density = float(req.get("density",
                                            outer.default_density))
                    if self.path == "/predict":
                        # inference is stateless: no later step repays a
                        # residual
                        def pack(a):
                            return outer._pack_stateless(a, mode, density)
                    else:
                        def pack(a):
                            return outer._pack_reply(
                                a, (cid, self.path), mode, density)
                    # exactly-once: a redelivered step is served the
                    # reply its first apply produced
                    op = _OP_BY_PATH.get(self.path)
                    if (op is not None and key_seq is not None
                            and hasattr(outer.runtime, "replay_lookup")):
                        cached_body, cached = outer.runtime.replay_lookup(
                            cid, op, key_seq)
                        if cached_body is not None:
                            # the original frame, byte for byte
                            self._send_200(cached_body, fault)
                            return
                        if cached is not None:
                            body = codec.encode(outer._replayed(
                                op, req, cached, mode, density))
                            outer.runtime.attach_reply_body(
                                cid, op, key_seq, body)
                            self._send_200(body, fault)
                            return
                    resp = outer._dispatch(self.path, req, cid, pack)
                    if resp is None:
                        self._reply(404, codec.encode({"error": "not found"}))
                        return
                    if tid is not None and obs_trace.CTX.server_spans:
                        # the client splits wire time out of its round
                        # trip with these
                        resp["server_spans"] = obs_trace.CTX.server_spans
                    out_raw, out_wire = codec.compressed_leaf_bytes(resp)
                    if (in_wire or out_wire) and hasattr(
                            outer.runtime, "note_wire_compression"):
                        outer.runtime.note_wire_compression(
                            in_raw + out_raw, in_wire + out_wire)
                    body = codec.encode(resp)
                    if (op is not None and key_seq is not None and hasattr(
                            outer.runtime, "attach_reply_body")):
                        # pin the exact frame to the replay entry before
                        # sending: a reply lost in flight leaves the
                        # retry a bit-identical copy
                        outer.runtime.attach_reply_body(
                            cid, op, key_seq, body)
                    self._send_200(body, fault)
                except Backpressure as exc:
                    self._reply(
                        429, codec.encode({"error": str(exc)}),
                        headers={"Retry-After": f"{exc.retry_after_s:.3f}"})
                except ProtocolError as exc:
                    self._reply(exc.status, codec.encode({"error": str(exc)}))
                except Exception as exc:  # noqa: BLE001 (server must not die)
                    self._reply(500, codec.encode({"error": str(exc)}))
                finally:
                    if tid is not None:
                        obs_trace.CTX.trace_id = None
                        obs_trace.CTX.server_spans = None

        return Handler

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "SplitHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class HttpTransport(Transport):
    """Client side: blocking POSTs like the reference client
    (``src/client_part.py:125,186``), with the permanent/transient error
    split instead of silent batch drops.

    ``compress="int8"`` quantizes the cut tensor (4x fewer bytes);
    ``"topk8"`` ships the top ``density`` fraction of magnitudes as int8
    with sender-side error feedback; ``"clapping"`` is topk8 with the
    storage-free ledger. ``pool_maxsize`` is validated and kept for
    JAX's signature: this client holds one connection per calling
    thread. A ``density_controller`` (``transport/density.py``) sets the
    topk8 density per wire (``wire_id``, by default the URL) and is fed
    each frame's byte ratio."""

    def __init__(self, base_url: str, timeout: float = 60.0,
                 compress: str = "none", density: float = 0.1,
                 pool_maxsize: int = 32,
                 density_controller: Optional[Any] = None,
                 wire_id: Optional[str] = None) -> None:
        super().__init__()
        if compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compression {compress!r}")
        if pool_maxsize < 1:
            raise ValueError(f"pool_maxsize must be >= 1 (got {pool_maxsize})")
        url = urllib.parse.urlsplit(base_url.rstrip("/"))
        if url.scheme != "http" or not url.hostname:
            raise ValueError(f"not an http URL: {base_url!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.compress = compress
        self.density = float(density)
        self.pool_maxsize = int(pool_maxsize)
        self._dc = density_controller
        self.wire_id = wire_id if wire_id is not None else base_url
        self._host, self._port, self._prefix = url.hostname, url.port, url.path
        # up-direction error feedback, keyed per op (one transport = one
        # client, so the op name is the whole key)
        self._ef = codec.make_wire_ef(
            "clapping" if compress == "clapping" else "topk8")
        self._local = threading.local()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # handshakes given up and retried on a fresh socket (_connect)
        self.connect_retries = 0

    # -- connections ------------------------------------------------------ #
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self.timeout)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.add(conn)
        return conn

    def _drop_conn(self, conn: http.client.HTTPConnection) -> None:
        conn.close()
        self._local.conn = None
        with self._conns_lock:
            self._conns.discard(conn)

    def _connect(self, conn: http.client.HTTPConnection) -> None:
        """Open ``conn``'s socket. A handshake that stalls past
        ``CONNECT_ATTEMPT_S`` is given up and tried again on a fresh
        socket until ``timeout`` has passed: nothing was sent, so a retry
        cannot apply a request twice. A refused connection raises at
        once."""
        deadline = time.monotonic() + self.timeout
        while True:
            left = deadline - time.monotonic()
            conn.timeout = max(min(CONNECT_ATTEMPT_S, left), 1e-3)
            try:
                conn.connect()
                break
            except TimeoutError:
                conn.close()
                if left <= CONNECT_ATTEMPT_S:
                    raise
                with self._conns_lock:
                    self.connect_retries += 1
            finally:
                conn.timeout = self.timeout
        conn.sock.settimeout(self.timeout)

    def _request(self, method: str, path: str, body: Optional[bytes] = None
                 ) -> Tuple[http.client.HTTPResponse, bytes]:
        """One request on this thread's connection; a socket error or a
        connection the server closed without a reply (a lost response)
        is a ``TransportError``, and the next request opens a fresh
        connection."""
        conn = self._conn()
        headers = {}
        if body is not None:
            headers = {"Content-Type": _OCTETS,
                       CRC_HEADER: str(codec.checksum(body))}
        try:
            if conn.sock is None:
                self._connect(conn)
            conn.request(method, self._prefix + path, body=body,
                         headers=headers)
            resp = conn.getresponse()
            content = resp.read()
        except (OSError, http.client.HTTPException) as exc:
            self._drop_conn(conn)
            raise TransportError(f"{method} {path} failed: {exc!r}") from exc
        return resp, content

    # -- packing ------------------------------------------------------------ #
    def _topk8(self) -> bool:
        return self.compress in ("topk8", "clapping")

    def _density_now(self) -> float:
        if self._dc is not None:
            return self._dc.density(self.wire_id)
        return self.density

    def _note_ratio(self, tree: Dict[str, Any]) -> None:
        """Count one frame's compressed leaves (logical against wire
        bytes) in the stats and the density controller."""
        raw_b, wire_b = codec.compressed_leaf_bytes(tree)
        if wire_b:
            self.stats.record_compression(raw_b, wire_b)
            if self._dc is not None:
                self._dc.note_ratio(self.wire_id, raw_b, wire_b)

    def _pack(self, arr: Any, key: str) -> Any:
        """The wire form of one cut tensor: a CUDA tensor is encoded on
        the card (K3, or the five topk8 select launches) with one host
        copy; ``"predict"`` packs statelessly."""
        arr = _as_leaf(arr)
        if self.compress == "int8":
            return codec.q8_compress(arr)
        if self._topk8():
            if key == "predict":
                # no later step repays an inference residual
                return codec.topk8_pack(arr, self._density_now())
            return self._ef.compress(key, arr, self._density_now(),
                                     decay=codec.ef_decay_for(key))
        return arr

    def _rollback(self, key: str) -> None:
        """A failed POST never delivered its reply: undo the error
        feedback update, so re-packing the same tensor reproduces the
        same frame and the same residual (whether the server applied the
        first delivery or never saw it)."""
        if self._topk8():
            self._ef.rollback(key)

    def _post(self, path: str, payload: Dict[str, Any],
              device: Optional[torch.device] = None) -> Dict[str, Any]:
        from split_learning_tpu_torch.runtime.party import ProtocolError
        # tracing: with the tracer off this is the untraced wire, no
        # trace_id key and no extra timing calls
        tr = obs_trace.get_tracer()
        tid = None
        if tr is not None and path in _TRACED_PATHS:
            tid = obs_trace.CTX.trace_id or tr.new_trace_id(
                int(payload.get("client_id", 0)),
                int(payload.get("step", -1)))
            payload = dict(payload, trace_id=tid)
        if self.compress != "none":
            payload = dict(payload, compress=self.compress)
            if self._topk8():
                payload["density"] = self._density_now()
            self._note_ratio(payload)
        fl = obs_flight.get_recorder()
        if fl is not None and path in _TRACED_PATHS:
            fl.record(spans.FL_SEND, step=int(payload.get("step", -1)),
                      client_id=int(payload.get("client_id", 0)),
                      party="client", trace_id=tid, path=path)
        t_enc0 = time.perf_counter() if tid is not None else 0.0
        body = codec.encode(payload)
        enc_s = time.perf_counter() - t_enc0 if tid is not None else 0.0
        t_wire0 = time.perf_counter() if tid is not None else 0.0
        resp, content = self._request("POST", path, body)
        t_wire1 = time.perf_counter() if tid is not None else 0.0
        self.stats.add_bytes(sent=len(body), received=len(content))
        resp_crc = resp.getheader(CRC_HEADER)
        if resp_crc is not None:
            try:
                crc_ok = int(resp_crc) == codec.checksum(content)
            except ValueError:
                crc_ok = False
            if not crc_ok:
                raise TransportError(
                    f"POST {path}: response checksum mismatch")
        if resp.status == 429:
            try:
                ra = float(resp.getheader("Retry-After", "0") or 0)
            except ValueError:
                ra = 0.0
            raise Backpressure(
                f"POST {path} -> 429: "
                f"{codec.decode(content).get('error', '')}",
                retry_after_s=ra)
        if resp.status in (400, 409):
            raise ProtocolError(codec.decode(content).get("error", ""),
                                status=resp.status)
        if resp.status != 200:
            raise TransportError(
                f"POST {path} -> {resp.status}: {content[:200]!r}")
        if fl is not None and path in _TRACED_PATHS:
            fl.record(spans.FL_RECV, step=int(payload.get("step", -1)),
                      client_id=int(payload.get("client_id", 0)),
                      party="client", trace_id=tid, path=path)
        t_dec0 = time.perf_counter() if tid is not None else 0.0
        try:
            tree = codec.decode(content)
            if self.compress != "none":
                self._note_ratio(tree)
            out = codec.decompress_tree(tree, device)
        except codec.CodecError as exc:
            # a frame that passed the CRC but fails the codec's checks is
            # a bad delivery: transient, so the retry collects the
            # original frame
            raise TransportError(
                f"POST {path}: reply failed codec validation: "
                f"{exc}") from exc
        if tid is not None:
            enc_s += time.perf_counter() - t_dec0  # client codec, both ways
            srv = out.pop("server_spans", None) or {}
            step = int(payload.get("step", -1))
            cid = int(payload.get("client_id", 0))
            wire = max((t_wire1 - t_wire0) - sum(srv.values()), 0.0)
            tr.record(spans.ENCODE, t_enc0, enc_s,
                      trace_id=tid, party="client", tid=cid, step=step)
            tr.record(spans.WIRE, t_wire0, wire,
                      trace_id=tid, party="client", tid=cid, step=step)
            self.stats.record_span(spans.ENCODE, enc_s)
            self.stats.record_span(spans.WIRE, wire)
            # the server's spans fold into this transport's stats
            for name, secs in srv.items():
                self.stats.record_span(str(name), float(secs))
        return out

    # -- ops -------------------------------------------------------------- #
    def split_step(self, activations: Any, labels: Any, step: int,
                   client_id: int = 0) -> Tuple[Any, float]:
        with timed(self.stats):
            try:
                out = self._post("/forward_pass", {
                    "activations": self._pack(activations, "acts"),
                    "labels": _as_leaf(labels),
                    "step": step, "client_id": client_id,
                }, device_of(activations))
            except Exception:
                self._rollback("acts")
                raise
            # the reply echoes the request step (a replayed frame carries
            # the original, matching step)
            if int(out["step"]) != step:
                raise TransportError(
                    f"/forward_pass reply step {out['step']} does not "
                    f"echo request step {step}")
            return out["grads"], float(out["loss"])

    def predict(self, activations: Any, client_id: int = 0) -> Any:
        with timed(self.stats):
            return self._post("/predict", {
                "activations": self._pack(activations, "predict"),
                "client_id": client_id,
            }, device_of(activations))["outputs"]

    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        with timed(self.stats):
            try:
                return self._post("/u_forward", {
                    "activations": self._pack(activations, "u_acts"),
                    "step": step, "client_id": client_id,
                }, device_of(activations))["features"]
            except Exception:
                self._rollback("u_acts")
                raise

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        with timed(self.stats):
            try:
                return self._post("/u_backward", {
                    "feat_grads": self._pack(feat_grads, "u_grads"),
                    "step": step, "client_id": client_id,
                }, device_of(feat_grads))["grads"]
            except Exception:
                self._rollback("u_grads")
                raise

    # -- the K-stage chain's hops (the peer serves a StageRuntime) ------ #
    def _hop_post(self, path: str, key: str, up: str, payload: Any,
                  step: int, mb: int, client_id: int,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One hop: ``payload`` packed under ``key`` as field ``up``, the
        EF rollback on a failed POST (the shipped mass was not
        delivered), and the reply's ``(step, mb)`` echo checked: a wire
        multiplexes M exchanges a step. With the flight recorder on, the
        hop journals ``FL_HOP_SEND`` and, on its reply, ``FL_HOP_RECV``."""
        op = _OP_BY_PATH[path]
        self._hop_flight(spans.FL_HOP_SEND, op, step, mb, client_id)
        with timed(self.stats):
            self.stats.incr(spans.HOP_HOST_COPIES, 2)
            try:
                out = self._post(path, {
                    up: self._pack(payload, key), **(extra or {}),
                    "step": step, "mb": int(mb), "client_id": client_id,
                }, device_of(payload))
            except Exception:
                self._rollback(key)
                raise
        if int(out.get("step", step)) != int(step) or int(
                out.get("mb", mb)) != int(mb):
            raise TransportError(
                f"{path} reply (step={out.get('step')}, mb={out.get('mb')}) "
                f"does not echo request (step={step}, mb={mb})")
        self._hop_flight(spans.FL_HOP_RECV, op, step, mb, client_id)
        return out

    @staticmethod
    def _hop_flight(name: str, op: str, step: int, mb: int,
                    client_id: int) -> None:
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(name, step=int(step), client_id=int(client_id),
                      party="client", op=op, mb=int(mb), stage=-1)

    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0) -> Any:
        return self._hop_post("/hop_forward", "hop_x", "x", x, step, mb,
                              client_id)["y"]

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0) -> Any:
        return self._hop_post("/hop_backward", "hop_g", "g", g_out, step,
                              mb, client_id)["grads"]

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0) -> Tuple[Any, float]:
        # labels travel dense: integer classes quantize to garbage
        out = self._hop_post("/hop_loss", "hop_loss_x", "x", x, step, mb,
                             client_id, {"labels": _as_leaf(labels)})
        return out["grads"], float(out["loss"])

    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        """``POST /aggregate_weights``: ``params`` (JAX's tree) dense, the
        round's mean back as host numpy."""
        with timed(self.stats):
            payload = {"model_state": params, "epoch": epoch,
                       "loss": loss, "step": step}
            if num_examples is not None:
                payload["num_examples"] = int(num_examples)
            return self._post("/aggregate_weights", payload)["model_state"]

    def health(self) -> Dict[str, Any]:
        resp, content = self._request("GET", "/health")
        if resp.status != 200:
            raise TransportError(
                f"GET /health -> {resp.status}: {content[:200]!r}")
        return codec.decode(content)

    def wait_ready(self, timeout: float = 60.0, interval: float = 0.5,
                   max_interval: float = 5.0, jitter: float = 0.5,
                   seed: Optional[int] = None) -> Dict[str, Any]:
        """Block until the server answers /health: the readiness barrier
        the reference lacks (its client drops every batch sent before
        the server is up, ``src/client_part.py:127-129``). Polls on
        exponential backoff (``interval``, doubling, capped at
        ``max_interval``) with up to ``jitter`` of multiplicative jitter;
        ``seed`` pins the jitter stream."""
        deadline = time.monotonic() + timeout
        rng = np.random.RandomState(seed) if seed is not None else None
        for delay in backoff_delays(interval, cap=max_interval,
                                    jitter=jitter, rng=rng):
            try:
                return self.health()
            except TransportError:
                now = time.monotonic()
                if now >= deadline:
                    raise
                time.sleep(min(delay, deadline - now))

    def close(self) -> None:
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for conn in conns:
            conn.close()
        self._local = threading.local()
