"""Fused softmax cross-entropy: the CUDA kernel pair and its wrapper.

Counterpart of ``split_learning_tpu/ops/cross_entropy.py``
(``fused_cross_entropy``, whose Pallas kernels are ``_fwd_kernel`` /
``_fwd_grid_kernel`` and ``_bwd_kernel`` / ``_bwd_grid_kernel``). The
kernels live in ``csrc/cross_entropy.cu``, whose header gives the design.

:func:`fused_cross_entropy` is a drop-in for
:func:`split_learning_tpu_torch.core.losses.cross_entropy` (mean over
rows, integer labels). On a CUDA tensor it runs
:class:`CrossEntropyFunction`, whose forward and backward each launch
the kernels; on a CPU tensor it returns the plain ``cross_entropy``.
The function's own forward and backward also accept CPU tensors, where
they run :func:`ce_forward_plain` and :func:`ce_backward_plain`, the
plain PyTorch versions of the kernels' math.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from split_learning_tpu_torch.core.losses import cross_entropy
from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)

FWD = "cross_entropy_fwd"
BWD = "cross_entropy_bwd"
_LOGIT_DTYPES = (torch.float32, torch.bfloat16)
_p = ctypes.c_void_p
_i = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernels()["cross_entropy"]
    lib.slt_ce_fwd_blocks.argtypes = [_i]
    lib.slt_ce_fwd_blocks.restype = _i
    lib.slt_ce_fwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _p]
    lib.slt_ce_fwd.restype = _i
    lib.slt_ce_bwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _p]
    lib.slt_ce_bwd.restype = _i
    return lib


def _check_inputs(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"expected logits [N, C] and labels [N]; got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.shape[0] == 0 or logits.shape[1] == 0:
        raise ValueError("cross-entropy needs N >= 1 rows and C >= 1 classes")


# --------------------------------------------------------------------- #
# plain versions (the kernels' math in PyTorch; CPU path and yardstick)

def ce_forward_plain(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, row log-sum-exp [N]), float32, as the forward kernel."""
    x = logits.float()
    m = x.max(dim=1, keepdim=True).values
    log_s = torch.log(torch.exp(x - m).sum(dim=1))
    x_y = x.gather(1, labels.long().unsqueeze(1)).squeeze(1)
    row_loss = log_s - (x_y - m.squeeze(1))
    return row_loss.sum() / x.shape[0], m.squeeze(1) + log_s


def ce_backward_plain(logits: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(exp(x - lse) - onehot) * g / N, in the logits dtype."""
    x = logits.float()
    p = torch.exp(x - lse.unsqueeze(1))
    onehot = torch.nn.functional.one_hot(labels.long(), x.shape[1]).float()
    return ((p - onehot) * (g.float() / x.shape[0])).to(logits.dtype)


# --------------------------------------------------------------------- #
# kernel launches

def ce_forward_cuda(logits: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernels: (mean loss, row log-sum-exp [N])."""
    check_cuda_tensor(logits, "logits", _LOGIT_DTYPES)
    check_cuda_tensor(labels, "labels", (torch.int64,))
    _check_inputs(logits, labels)
    n, c = logits.shape
    lib = _lib()
    lse = torch.empty(n, device=logits.device, dtype=torch.float32)
    partials = torch.empty(lib.slt_ce_fwd_blocks(n), device=logits.device,
                           dtype=torch.float32)
    loss = torch.empty((), device=logits.device, dtype=torch.float32)
    rc = lib.slt_ce_fwd(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                        partials.data_ptr(), loss.data_ptr(), n, c,
                        int(logits.dtype == torch.bfloat16),
                        current_stream_handle(logits.device))
    check_launch(rc, FWD)
    LAUNCHES.add(FWD)
    return loss, lse


def ce_backward_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel; ``g`` is read on the device."""
    check_cuda_tensor(logits, "logits", _LOGIT_DTYPES)
    check_cuda_tensor(labels, "labels", (torch.int64,))
    check_cuda_tensor(lse, "lse", (torch.float32,))
    g = g.to(device=logits.device, dtype=torch.float32).contiguous()
    if g.numel() != 1:
        raise ValueError("the loss cotangent must be a scalar")
    n, c = logits.shape
    grad = torch.empty_like(logits)
    rc = _lib().slt_ce_bwd(logits.data_ptr(), labels.data_ptr(),
                           lse.data_ptr(), g.data_ptr(), grad.data_ptr(), n,
                           c, int(logits.dtype == torch.bfloat16),
                           current_stream_handle(logits.device))
    check_launch(rc, BWD)
    LAUNCHES.add(BWD)
    return grad


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


class CrossEntropyFunction(torch.autograd.Function):
    """Mean softmax CE with a hand-written forward and backward.

    Saves the logits, the labels and the row log-sum-exp; the backward
    recomputes the softmax from them."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
        _check_inputs(logits, labels)
        if _on_cuda(logits):
            loss, lse = ce_forward_cuda(logits, labels)
        else:
            loss, lse = ce_forward_plain(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, labels, lse = ctx.saved_tensors
        if _on_cuda(logits):
            grad = ce_backward_cuda(logits, labels, lse, g)
        else:
            grad = ce_backward_plain(logits, labels, lse, g)
        return grad, None


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Mean softmax CE with integer labels.

    CUDA tensors go through the kernels (:class:`CrossEntropyFunction`);
    CPU tensors through the plain :func:`core.losses.cross_entropy`."""
    if _on_cuda(logits):
        return CrossEntropyFunction.apply(logits, labels)
    return cross_entropy(logits, labels)
