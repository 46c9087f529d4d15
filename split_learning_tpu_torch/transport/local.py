"""In-process transport (counterpart of
``split_learning_tpu/transport/local.py``), the protocol-level fake of
the reference's ``/forward_pass`` route with no network.

With ``compress=None`` the transport hands the server what it was given
and returns its reply as is: a CUDA tensor stays on the card, a numpy
array stays numpy. ``through_codec=True`` (JAX's flag) instead encodes
and decodes each payload of ``split_step`` and ``predict`` with the
real codec, uncompressed and uncounted. Any of ``"none"``, ``"int8"``,
``"topk8"`` or ``"clapping"`` switches ``split_step`` and ``predict``
to full wire emulation, exactly one HTTP hop minus the socket: each
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

Not ported yet: the U-shaped ops (``u_forward``/``u_backward``, ROADMAP
item 11), ``aggregate`` (items 11 and 15), the pipeline hop ops
(item 16), the adaptive density controller (item 13).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from split_learning_tpu_torch.obs import trace as obs_trace
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.transport.base import (
    Backpressure, Transport, TransportError, device_of, not_ported, timed)
from split_learning_tpu_torch.utils.arrays import host_tree

COMPRESS_MODES = (None, "none", "int8", "topk8", "clapping")


class LocalTransport(Transport):
    """JAX's signature: ``server`` is a ``ServerRuntime`` of the port, or
    any object with its ``split_step``/``predict``/``health``
    (duck-typed), the JAX ``ServerRuntime`` included.

    ``density`` is topk8's kept fraction. ``ef_mode`` and ``wire_id`` are
    stored as JAX stores them (the ledgers follow ``compress``, as in
    JAX); a ``density_controller`` (the adaptive controller) is not
    ported yet."""

    def __init__(self, server: Any, through_codec: bool = False,
                 compress: Optional[str] = None,
                 density: float = 0.1,
                 ef_mode: str = "topk8",
                 density_controller: Optional[Any] = None,
                 wire_id: Optional[str] = None) -> None:
        super().__init__()
        if compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compression {compress!r}")
        if density_controller is not None:
            raise not_ported("the adaptive density controller", "item 13")
        self.server = server
        self.through_codec = bool(through_codec)
        self.compress = compress
        self.density = float(density)
        self.ef_mode = ef_mode
        mode = "clapping" if compress == "clapping" else "topk8"
        self._ef = codec.make_wire_ef(mode)       # up (client-owned)
        self._down_ef = codec.make_wire_ef(mode)  # down, servers without one
        stage = getattr(server, "stage_index", None)
        self.wire_id = wire_id if wire_id is not None else (
            f"hop{stage}" if stage is not None else "cut")

    def _topk8(self) -> bool:
        return self.compress in ("topk8", "clapping")

    # -- wire emulation (compress != None) ------------------------------
    def _pack_up(self, arr: Any, key: Any) -> Any:
        if self.compress == "int8":
            return codec.q8_compress(arr)
        if self._topk8():
            return self._ef.compress(key, arr, self.density,
                                     decay=codec.ef_decay_for(key[0]))
        return arr

    def _pack_down(self, arr: Any, key: Any) -> Any:
        if self.compress == "int8":
            return codec.q8_compress(arr)
        if self._topk8():
            # the server's own ledger, keyed (client, op) as over HTTP
            ef = getattr(self.server, "wire_ef", None) or self._down_ef
            return ef.compress(key, arr, self.density,
                               decay=codec.ef_decay_for(key[1]))
        return arr

    def _pack_stateless(self, arr: Any) -> Any:
        """Inference packing: no error feedback on either end."""
        if self._topk8():
            return codec.topk8_pack(arr, self.density)
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

    def u_forward(self, activations: Any, step: int,
                  client_id: int = 0) -> Any:
        raise not_ported("u_forward (the U-shaped split)", "item 11")

    def u_backward(self, feat_grads: Any, step: int,
                   client_id: int = 0) -> Any:
        raise not_ported("u_backward (the U-shaped split)", "item 11")

    def aggregate(self, params: Any, epoch: int, loss: float, step: int,
                  num_examples: Optional[int] = None) -> Any:
        raise not_ported("aggregate (FedAvg)", "items 11 and 15")

    def health(self) -> Dict[str, Any]:
        return self.server.health()

