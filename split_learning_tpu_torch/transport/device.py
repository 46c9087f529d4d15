"""The device-native hop wire between co-located stages (counterpart of
``split_learning_tpu/transport/device.py``).

When the hub and its ``StageRuntime`` peers share one process, the
classic hop contract (host numpy in, host numpy out) copies every cut
tensor through the host twice a microbatch for nothing. In the port
``LocalTransport(compress=None)`` already hands the peer stage the
device tensor as it is and relays its reply in the request's kind, so
this transport is that wire under JAX's name: no host copy, no codec. On
one card the same CUDA tensors flow through the whole chain. The one
host read a microbatch is the loss scalar of the last stage's hop.

What it adds: ``device_native`` (the runner keeps a stage-0 payload on
the card when every wire has it), and the accounting
``stats.counters["hop_host_copies"]``
(:data:`~split_learning_tpu_torch.obs.spans.HOP_HOST_COPIES`), which
counts every hop payload or reply that is a numpy array; on the intended
path it stays 0. Each hop journals ``FL_HOP_SEND``/``FL_HOP_RECV``
(with the stage's index) through ``LocalTransport`` when the flight
recorder is on.

Scope: the hop ops, ``predict`` and ``health``. The two-party ops
(``split_step``, ``u_forward``, ``u_backward``, ``aggregate``) raise
``NotImplementedError`` as JAX's do: ``LocalTransport`` serves them.
JAX's ``mesh=`` (a ``pipe`` mesh whose ``ppermute`` moves each payload
between ranks) is ROADMAP item 18 and raises.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.base import not_ported
from split_learning_tpu_torch.transport.local import LocalTransport


class DeviceTransport(LocalTransport):
    """In-process wire to one ``StageRuntime``, device tensors end to
    end: ``LocalTransport`` with no compression, counting host copies."""

    device_native = True

    def __init__(self, server: Any, mesh: Optional[Any] = None) -> None:
        if mesh is not None:
            raise not_ported("a pipe mesh on the device wire (mesh)",
                             "item 18")
        super().__init__(server)
        self.stage_index = int(getattr(server, "stage_index", -1))

    def _note_host(self, *arrays: Any) -> None:
        """The zero-copy pin: a numpy array on the hop path means some
        layer copied to the host where none should."""
        for a in arrays:
            if isinstance(a, np.ndarray):
                self.stats.incr(spans.HOP_HOST_COPIES)

    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0) -> Any:
        y = super().hop_forward(x, step, mb, client_id)
        self._note_host(x, y)
        return y

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0) -> Any:
        g = super().hop_backward(g_out, step, mb, client_id)
        self._note_host(g_out, g)
        return g

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0) -> Tuple[Any, float]:
        """The runner's reply contract: (the cut gradient, here a device
        tensor, and the loss as a host float). Labels ride in as the
        runner sliced them."""
        g, loss = super().hop_loss(x, labels, step, mb, client_id)
        self._note_host(x, g)
        return g, loss

    def split_step(self, activations, labels, step, client_id=0):
        raise NotImplementedError(
            "DeviceTransport serves pipeline hops only; the 2-party "
            "split path has no co-located fast path: use LocalTransport")

    def u_forward(self, activations, step, client_id=0):
        raise NotImplementedError(
            "DeviceTransport serves pipeline hops only")

    def u_backward(self, feat_grads, step, client_id=0):
        raise NotImplementedError(
            "DeviceTransport serves pipeline hops only")

    def aggregate(self, params, epoch, loss, step, num_examples=None):
        raise NotImplementedError(
            "DeviceTransport serves pipeline hops only")
