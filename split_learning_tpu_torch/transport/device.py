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

With ``mesh=`` (a mesh with a ``pipe`` axis covering the chain's
stages, :mod:`split_learning_tpu_torch.parallel.mesh`), each hop payload
moves to its receiving stage's pipe rank device first (forward: stage-1
to stage; backward: stage+1 to stage), through
:func:`~split_learning_tpu_torch.parallel.pipeline.make_hop_shift`, a
device-to-device copy where JAX runs a ``ppermute``; stage 1's replies
move on to the hub's rank-0 device. Each stage's runtime is built on
its pipe rank's device.

Scope: the hop ops, ``predict`` and ``health``. The two-party ops
(``split_step``, ``u_forward``, ``u_backward``, ``aggregate``) raise
``NotImplementedError`` as JAX's do: ``LocalTransport`` serves them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.transport.local import LocalTransport


class DeviceTransport(LocalTransport):
    """In-process wire to one ``StageRuntime``, device tensors end to
    end: ``LocalTransport`` with no compression, counting host copies."""

    device_native = True

    def __init__(self, server: Any, mesh: Optional[Any] = None) -> None:
        super().__init__(server)
        self.stage_index = int(getattr(server, "stage_index", -1))
        self._mesh = mesh
        self._shifts: Dict[Tuple[int, int], Callable] = {}
        if mesh is not None:
            from split_learning_tpu_torch.parallel.mesh import PIPE_AXIS
            if PIPE_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"DeviceTransport mesh needs a {PIPE_AXIS!r} axis")
            n_stages = int(server.plan.num_stages) \
                if hasattr(server, "plan") else 0
            if mesh.shape[PIPE_AXIS] < n_stages:
                raise ValueError(
                    f"pipe axis size {mesh.shape[PIPE_AXIS]} < "
                    f"{n_stages} stages")

    def _shuttle(self, x: Any, src: int, dst: int) -> Any:
        """Move a hop payload from pipe rank ``src`` to ``dst``; as it is
        without a mesh or for a host array."""
        if self._mesh is None or not isinstance(x, torch.Tensor):
            return x
        fn = self._shifts.get((src, dst))
        if fn is None:
            from split_learning_tpu_torch.parallel.pipeline import (
                make_hop_shift)
            fn = self._shifts[(src, dst)] = make_hop_shift(self._mesh, src,
                                                           dst)
        return fn(x)

    def _to_hub(self, g: Any) -> Any:
        """Stage 1's replies feed the hub's own stage: to pipe rank 0."""
        if self.stage_index == 1:
            return self._shuttle(g, 1, 0)
        return g

    def _note_host(self, *arrays: Any) -> None:
        """The zero-copy pin: a numpy array on the hop path means some
        layer copied to the host where none should."""
        for a in arrays:
            if isinstance(a, np.ndarray):
                self.stats.incr(spans.HOP_HOST_COPIES)

    def hop_forward(self, x: Any, step: int, mb: int = 0,
                    client_id: int = 0) -> Any:
        x = self._shuttle(x, self.stage_index - 1, self.stage_index)
        y = super().hop_forward(x, step, mb, client_id)
        self._note_host(x, y)
        return y

    def hop_backward(self, g_out: Any, step: int, mb: int = 0,
                     client_id: int = 0) -> Any:
        g_out = self._shuttle(g_out, self.stage_index + 1, self.stage_index)
        g = super().hop_backward(g_out, step, mb, client_id)
        self._note_host(g_out, g)
        return self._to_hub(g)

    def hop_loss(self, x: Any, labels: Any, step: int, mb: int = 0,
                 client_id: int = 0) -> Tuple[Any, float]:
        """The runner's reply contract: (the cut gradient, here a device
        tensor, and the loss as a host float). Labels ride in as the
        runner sliced them."""
        x = self._shuttle(x, self.stage_index - 1, self.stage_index)
        g, loss = super().hop_loss(x, labels, step, mb, client_id)
        self._note_host(x, g)
        return self._to_hub(g), loss

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
