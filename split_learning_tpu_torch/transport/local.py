"""In-process transport (counterpart of
``split_learning_tpu/transport/local.py``), the protocol-level fake of
the reference's ``/forward_pass`` route with no network.

With ``compress=None`` the transport hands the server what it was given
and returns its reply as is: a CUDA tensor stays on the card, a numpy
array stays numpy. ``through_codec=True`` (JAX's flag) instead encodes
and decodes each payload of ``split_step`` and ``predict`` with the
real codec, uncompressed and uncounted. Any of ``"none"``, ``"int8"``,
``"topk8"`` or ``"clapping"`` switches ``split_step``, ``predict`` and
the U-shaped hops ``u_forward``/``u_backward`` to full wire emulation,
exactly one HTTP hop minus the socket: each
direction's payload is packed with that compression, encoded to the
real msgpack frame, counted, decoded and expanded. ``"none"`` is the
dense float32 wire; ``"clapping"`` is topk8 selection with the
storage-free error-feedback ledger (``codec.ClappingEF``).

Where the arithmetic runs follows the tensor (``transport/codec.py``): a
CUDA tensor is quantized or sparsified on the card (K3, K4) and its
header and payload cross to the host in one copy. The request (with or
without compression) is decoded on the
server's device (``server.device``; numpy for a peer without one, such
as the JAX ``ServerRuntime``), and the reply in the kind the caller sent:
a tensor on the caller's device, or numpy for a numpy caller (a JAX
client). A numpy peer or caller gets numpy arrays only, a bfloat16 one
as numpy's ``ml_dtypes`` bfloat16 (:func:`utils.arrays.host_tree`).

Exception contract (uniform across ops): a ``ProtocolError`` of the
server propagates as is (permanent, never masked by retry or skip), a
``Backpressure`` too; anything else becomes ``TransportError``
(transient).

The U-shaped hops key their error feedback as JAX's do: ``("u_acts",
cid)`` and ``("u_grads", cid)`` up, ``(cid, "/u_forward")`` and ``(cid,
"/u_backward")`` down (the gradient roles decay at 1.0,
``codec.ef_decay_for``).

The K-stage chain's hop ops (the peer is a ``StageRuntime``,
``runtime/stage.py``): with ``compress=None`` the payload and the reply
pass untouched (``through_codec`` round-trips them); otherwise each hop
is the emulated wire, keyed ``("hop_x", cid)``, ``("hop_g", cid)`` and
``("hop_loss_x", cid)`` up and ``(cid, "/hop_forward")``, ``(cid,
"/hop_backward")`` and ``(cid, "/hop_loss")`` down; labels travel dense.
A ``density_controller`` (``transport/density.py``) gives every topk8
pack its density under this wire's ``wire_id`` and is fed each frame's
byte ratio. ``aggregate`` (FedAvg) carries weights, which
always travel dense: with wire emulation on, its payload goes through
the real frame, uncompressed, and, as in JAX, its bytes are not counted
in the stats. With the flight recorder on, ``split_step`` journals
``FL_SEND``/``FL_RECV`` and each hop ``FL_HOP_SEND``/``FL_HOP_RECV``
(party ``client``; the server's own events tag themselves).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError, device_of, timed)
from split_learning_tpu_torch.utils.arrays import host_tree

COMPRESS_MODES = (None, "none", "int8", "topk8", "clapping")


class LocalTransport(Transport):
    """JAX's signature: ``server`` is a ``ServerRuntime`` of the port, or
    any object with its ``split_step``/``predict``/``health``
    (duck-typed), the JAX ``ServerRuntime`` included.

    ``density`` is topk8's kept fraction, unless a
    ``density_controller`` sets it per wire (``wire_id``, by default
    ``hop<i>`` for a stage peer). ``ef_mode`` is stored as JAX stores it
    (the ledgers follow ``compress``, as in JAX)."""

    def __init__(self, server: Any, through_codec: bool = False,
                 compress: Optional[str] = None,
                 density: float = 0.1,
                 ef_mode: str = "topk8",
                 density_controller: Optional[Any] = None,
                 wire_id: Optional[str] = None) -> None:
        super().__init__()
        if compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compression {compress!r}")
        self.server = server
        self.through_codec = bool(through_codec)
        self.compress = compress
        self.density = float(density)
        self.ef_mode = ef_mode
        mode = "clapping" if compress == "clapping" else "topk8"
        self._ef = codec.make_wire_ef(mode)       # up (client-owned)
        self._down_ef = codec.make_wire_ef(mode)  # down, servers without one
        self._dc = density_controller
        stage = getattr(server, "stage_index", None)
        self.wire_id = wire_id if wire_id is not None else (
            f"hop{stage}" if stage is not None else "cut")

    def _topk8(self) -> bool:
        return self.compress in ("topk8", "clapping")

    def _density_now(self) -> float:
        if self._dc is not None:
            return self._dc.density(self.wire_id)
        return self.density

    # -- wire emulation (compress != None) ------------------------------
    def _pack_up(self, arr: Any, key: Any) -> Any:
        if self.compress == "int8":
            return codec.q8_compress(arr)
        if self._topk8():
            return self._ef.compress(key, arr, self._density_now(),
                                     decay=codec.ef_decay_for(key[0]))
        return arr

    def _pack_down(self, arr: Any, key: Any) -> Any:
        if self.compress == "int8":
            return codec.q8_compress(arr)
        if self._topk8():
            # the server's own ledger, keyed (client, op) as over HTTP
            ef = getattr(self.server, "wire_ef", None) or self._down_ef
            return ef.compress(key, arr, self._density_now(),
                               decay=codec.ef_decay_for(key[1]))
        return arr

    def _pack_stateless(self, arr: Any) -> Any:
        """Inference packing: no error feedback on either end."""
        if self._topk8():
            return codec.topk8_pack(arr, self._density_now())
        if self.compress == "int8":
            return codec.q8_compress(arr)
        return arr

    def _wire(self, payload: dict, device: Optional[torch.device]
              ) -> Tuple[dict, int]:
        """One direction of the emulated wire: real encode, real byte
        count, real decode and expansion on ``device`` (numpy for None)."""
        body = codec.encode(payload)
        raw_b, wire_b = codec.compressed_leaf_bytes(payload)
        if wire_b:
            self.stats.record_compression(raw_b, wire_b)
            if self._dc is not None:
                self._dc.note_ratio(self.wire_id, raw_b, wire_b)
            # the peer runtime folds the same bytes into its own metrics
            nwc = getattr(self.server, "note_wire_compression", None)
            if nwc is not None:
                nwc(raw_b, wire_b)
        tree = codec.decompress_tree(codec.decode(body), device)
        return (tree if device is not None else host_tree(tree)), len(body)

    def _server_device(self) -> Optional[torch.device]:
        return getattr(self.server, "device", None)

    def _roundtrip(self, obj: Any, device: Optional[torch.device]) -> Any:
        """``through_codec``: the real encode and decode, expanded on
        ``device`` (numpy for None); else ``obj`` untouched, but as host
        numpy for a numpy peer (``device`` None)."""
        if self.through_codec:
            obj = codec.decompress_tree(codec.decode(codec.encode(obj)),
                                        device)
        return obj if device is not None else host_tree(obj)

    def _call(self, fn, *args):
        from split_learning_tpu_torch.runtime.party import ProtocolError
        try:
            return fn(*args)
        except (ProtocolError, Backpressure):
            raise
        except Exception as exc:
            raise TransportError(str(exc)) from exc

    # -- ops -------------------------------------------------------------
    def split_step(self, activations: Any, labels: Any, step: int,
                   client_id: int = 0) -> Tuple[Any, float]:
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_SEND, step=int(step),
                      client_id=int(client_id), party="client",
                      op="split_step")
        tr = obs_trace.get_tracer()
        if tr is not None:
            obs_trace.CTX.server_spans = None
        with timed(self.stats):
            if self.compress is None:
                dev = self._server_device()
                grads, loss = self._call(
                    self.server.split_step,
                    self._roundtrip(activations, dev),
                    self._roundtrip(labels, dev), step, client_id)
                res = (self._roundtrip(grads, device_of(activations)),
                       float(loss))
            else:
                res = self._split_step_wire(activations, labels, step,
                                            client_id)
        if tr is not None:
            # the server's span times, handed back through CTX
            for name, secs in (obs_trace.CTX.server_spans or {}).items():
                self.stats.record_span(str(name), float(secs))
        if fl is not None:
            fl.record(spans.FL_RECV, step=int(step),
                      client_id=int(client_id), party="client",
                      op="split_step")
        return res

    def _split_step_wire(self, activations, labels, step, client_id):
        """Both directions through the real codec. No rollback on
        failure: an in-process call that raised still delivered the
        payload (the server decoded it before failing)."""
        req, up = self._wire({
            "activations": self._pack_up(activations, ("acts", client_id)),
            "labels": labels}, self._server_device())
        grads, loss = self._call(self.server.split_step,
                                 req["activations"], req["labels"], step,
                                 client_id)
        resp, down = self._wire({
            "grads": self._pack_down(grads, (client_id, "/forward_pass")),
            "loss": float(loss)}, device_of(activations))
        self.stats.add_bytes(sent=up, received=down)
        return resp["grads"], float(resp["loss"])

    def predict(self, activations: Any, client_id: int = 0) -> Any:
        with timed(self.stats):
            if self.compress is None:
                out = self._call(
                    self.server.predict,
                    self._roundtrip(activations, self._server_device()),
                    client_id)
                return self._roundtrip(out, device_of(activations))
            req, up = self._wire(
                {"activations": self._pack_stateless(activations)},
                self._server_device())
            out = self._call(self.server.predict, req["activations"],
                             client_id)
            resp, down = self._wire({"outputs": self._pack_stateless(out)},
                                    device_of(activations))
            self.stats.add_bytes(sent=up, received=down)
            return resp["outputs"]

    def _hop_wire(self, up_key: str, role_key: Tuple[Any, Any], path: str,
                  down_key: str, fn, payload: Any, step: int,
                  client_id: int) -> Any:
        """One U-shaped hop: ``payload`` packed up under ``role_key``,
        ``fn`` on the server, the reply packed down under ``(client_id,
        path)``, both frames counted."""
        req, up = self._wire({up_key: self._pack_up(payload, role_key)},
                             self._server_device())
        out = self._call(fn, req[up_key], step, client_id)
        resp, down = self._wire(
            {down_key: self._pack_down(out, (client_id, path))},
            device_of(payload))
        self.stats.add_bytes(sent=up, received=down)
        return resp[down_key]

    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        with timed(self.stats):
            if self.compress is not None:
                return self._hop_wire(
                    "activations", ("u_acts", client_id), "/u_forward",
                    "features", self.server.u_forward, activations, step,
                    client_id)
            feats = self._call(
                self.server.u_forward,
                self._roundtrip(activations, self._server_device()), step,
                client_id)
            return self._roundtrip(feats, device_of(activations))

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        with timed(self.stats):
            if self.compress is not None:
                return self._hop_wire(
                    "feat_grads", ("u_grads", client_id), "/u_backward",
                    "grads", self.server.u_backward, feat_grads, step,
                    client_id)
            g = self._call(
                self.server.u_backward,
                self._roundtrip(feat_grads, self._server_device()), step,
                client_id)
            return self._roundtrip(g, device_of(feat_grads))

    # -- the K-stage chain's hops (the peer is a StageRuntime) ----------
    def _hop(self, fn, x: Any, step: int, mb: int, client_id: int) -> Any:
        """A hop with no wire emulation: the payload as it is (or through
        the codec with ``through_codec``), the reply in the caller's
        kind."""
        out = self._call(fn, self._roundtrip(x, self._server_device()),
                         step, mb, client_id)
        return self._roundtrip(out, device_of(x))

    def _hop_flight(self, name: str, op: str, step: int, mb: int,
                    client_id: int) -> None:
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(name, step=int(step), client_id=int(client_id),
                      party="client", op=op, mb=int(mb),
                      stage=getattr(self.server, "stage_index", -1))

    def _journaled(self, op: str, fn, step: int, mb: int, client_id: int,
                   *args: Any) -> Any:
        """``fn(*args, step, mb, client_id)`` between the hop's send and
        receive events."""
        self._hop_flight(spans.FL_HOP_SEND, op, step, mb, client_id)
        out = fn(*args, step, mb, client_id)
        self._hop_flight(spans.FL_HOP_RECV, op, step, mb, client_id)
        return out

    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0) -> Any:
        return self._journaled("hop_fwd", self._hop_forward, step, mb,
                               client_id, x)

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0) -> Any:
        return self._journaled("hop_bwd", self._hop_backward, step, mb,
                               client_id, g_out)

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0) -> Tuple[Any, float]:
        return self._journaled("hop_loss", self._hop_loss, step, mb,
                               client_id, x, labels)

    def _hop_forward(self, x: Any, step: int, mb: int,
                     client_id: int) -> Any:
        with timed(self.stats):
            if self.compress is None:
                return self._hop(self.server.hop_forward, x, step, mb,
                                 client_id)
            # the transport is bound to one stage, so the ledger keys are
            # effectively (client, stage, op), as on the HTTP chain
            req, up = self._wire(
                {"x": self._pack_up(x, ("hop_x", client_id))},
                self._server_device())
            y = self._call(self.server.hop_forward, req["x"], step, mb,
                           client_id)
            resp, down = self._wire(
                {"y": self._pack_down(y, (client_id, "/hop_forward"))},
                device_of(x))
            self.stats.add_bytes(sent=up, received=down)
            return resp["y"]

    def _hop_backward(self, g_out: Any, step: int, mb: int,
                      client_id: int) -> Any:
        with timed(self.stats):
            if self.compress is None:
                return self._hop(self.server.hop_backward, g_out, step, mb,
                                 client_id)
            req, up = self._wire(
                {"g": self._pack_up(g_out, ("hop_g", client_id))},
                self._server_device())
            g = self._call(self.server.hop_backward, req["g"], step, mb,
                           client_id)
            resp, down = self._wire(
                {"g": self._pack_down(g, (client_id, "/hop_backward"))},
                device_of(g_out))
            self.stats.add_bytes(sent=up, received=down)
            return resp["g"]

    def _hop_loss(self, x: Any, labels: Any, step: int, mb: int,
                  client_id: int) -> Tuple[Any, float]:
        with timed(self.stats):
            dev = self._server_device()
            if self.compress is None:
                g, loss = self._call(
                    self.server.hop_loss, self._roundtrip(x, dev),
                    self._roundtrip(labels, dev), step, mb, client_id)
                return self._roundtrip(g, device_of(x)), float(loss)
            # labels travel dense (integer classes quantize to garbage);
            # the loss scalar is dense by construction
            req, up = self._wire(
                {"x": self._pack_up(x, ("hop_loss_x", client_id)),
                 "labels": labels}, dev)
            g, loss = self._call(self.server.hop_loss, req["x"],
                                 req["labels"], step, mb, client_id)
            resp, down = self._wire(
                {"g": self._pack_down(g, (client_id, "/hop_loss")),
                 "loss": float(loss)}, device_of(x))
            self.stats.add_bytes(sent=up, received=down)
            return resp["g"], float(resp["loss"])

    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        """FedAvg: ``params`` in JAX's layout, dense both ways; the mean
        comes back as host numpy."""
        dev = self._server_device()
        with timed(self.stats):
            if self.compress is not None or self.through_codec:
                sent = codec.decompress_tree(
                    codec.decode(codec.encode(params)), dev)
            else:
                sent = params if dev is not None else host_tree(params)
            out = self._call(self.server.aggregate, sent, epoch, loss, step,
                             num_examples)
            if self.compress is not None or self.through_codec:
                out = codec.decode(codec.encode(out))
            return host_tree(out)

    def health(self) -> Dict[str, Any]:
        return self.server.health()

