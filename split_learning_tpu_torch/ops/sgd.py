"""Fused SGD(+momentum) update: the multi-tensor CUDA kernel and its wrapper.

Counterpart of ``split_learning_tpu/ops/sgd.py`` (``fused_sgd_step``,
whose Pallas kernels are ``_sgd_kernel`` and ``_sgd_mom_kernel``). The
kernel lives in ``csrc/sgd.cu``, whose header gives the design.

Unlike the JAX version, which returns new arrays, :func:`fused_sgd_step`
updates ``params`` and ``trace`` **in place**, with optax.sgd semantics
and a zero-initialised trace (:func:`init_trace`):

    m <- mu * m + g;  p <- p - lr * m      (mu > 0)
    p <- p - lr * g                        (mu == 0)

On CUDA tensors it launches one kernel over every leaf (up to the
kernel's table of ``slt_sgd_max_leaves()`` leaves a launch, 896); on CPU
tensors it runs :func:`sgd_step_plain`. The two round identically: the
kernel is built without FMA contraction.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence

import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)

NAME = "sgd"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernels()["sgd"]
    lib.slt_sgd_max_leaves.argtypes = []
    lib.slt_sgd_max_leaves.restype = ctypes.c_int
    lib.slt_sgd_step.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.slt_sgd_step.restype = ctypes.c_int
    return lib


class _Table:
    """The host arrays one launch reads (pointers and sizes of its leaves),
    allocated once a thread at the kernel's capacity and refilled for each
    step: ``slt_sgd_step`` copies them into the launch before it returns."""

    _local = threading.local()

    def __init__(self, cap: int) -> None:
        self.cap = cap
        self.p = (ctypes.c_void_p * cap)()
        self.g = (ctypes.c_void_p * cap)()
        self.m = (ctypes.c_void_p * cap)()
        self.numel = (ctypes.c_int64 * cap)()

    @classmethod
    def mine(cls) -> "_Table":
        table = getattr(cls._local, "table", None)
        if table is None:
            table = cls._local.table = cls(_lib().slt_sgd_max_leaves())
        return table


def init_trace(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero momentum trace, matching optax.trace initialisation."""
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


@torch.no_grad()
def sgd_step_plain(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   trace: Optional[Sequence[torch.Tensor]], lr: float,
                   momentum: float = 0.0) -> None:
    """The kernel's update in plain PyTorch, in place."""
    if momentum:
        for p, g, m in zip(params, grads, trace):
            m.mul_(momentum).add_(g)
            p.sub_(lr * m)
    else:
        for p, g in zip(params, grads):
            p.sub_(lr * g)


@torch.no_grad()
def sgd_step_cuda(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor],
                  trace: Optional[Sequence[torch.Tensor]], lr: float,
                  momentum: float = 0.0) -> None:
    """Launch the multi-tensor kernel: one launch for up to 896 leaves."""
    leaves = list(zip(params, grads,
                      trace if momentum else [None] * len(params)))
    for p, g, m in leaves:
        check_cuda_tensor(p, "param", (torch.float32,))
        check_cuda_tensor(g, "grad", (torch.float32,))
        if g.shape != p.shape or g.device != p.device:
            raise ValueError("grad must match its param in shape and device")
        if m is not None:
            check_cuda_tensor(m, "trace", (torch.float32,))
            if m.shape != p.shape or m.device != p.device:
                raise ValueError("trace must match its param")
    table = _Table.mine()
    for lo in range(0, len(leaves), table.cap):
        part = leaves[lo:lo + table.cap]
        k = len(part)
        table.p[:k] = [p.data_ptr() for p, _, _ in part]
        table.g[:k] = [g.data_ptr() for _, g, _ in part]
        table.m[:k] = [m.data_ptr() if m is not None else None
                       for _, _, m in part]
        table.numel[:k] = [p.numel() for p, _, _ in part]
        rc = _lib().slt_sgd_step(k, table.p, table.g, table.m, table.numel,
                                 lr, momentum,
                                 current_stream_handle(part[0][0].device))
        check_launch(rc, NAME)
        LAUNCHES.add(NAME)


def fused_sgd_step(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   trace: Optional[Sequence[torch.Tensor]], lr: float,
                   momentum: float = 0.0) -> None:
    """In-place (momentum-)SGD over a list of leaves.

    ``trace`` is the momentum list (zeros-initialised) or None when
    ``momentum == 0``. CUDA leaves launch the kernel; CPU leaves run
    :func:`sgd_step_plain`."""
    if len(grads) != len(params) or (momentum and trace is None) or (
            momentum and len(trace) != len(params)):
        raise ValueError("params, grads and trace must align leaf for leaf")
    if not params:
        return
    devices = {p.device.type for p in params}
    if devices == {"cuda"}:
        sgd_step_cuda(params, grads, trace, lr, momentum)
    elif devices == {"cpu"}:
        sgd_step_plain(params, grads, trace, lr, momentum)
    else:
        raise ValueError(f"leaves on unsupported or mixed devices {devices}")
