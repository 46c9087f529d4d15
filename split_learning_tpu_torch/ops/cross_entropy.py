"""Fused softmax cross-entropy: the CUDA kernel pair and its wrapper.

Counterpart of ``split_learning_tpu/ops/cross_entropy.py``
(``fused_cross_entropy``, whose Pallas kernels are ``_fwd_kernel`` /
``_fwd_grid_kernel`` and ``_bwd_kernel`` / ``_bwd_grid_kernel``). The
kernels live in ``csrc/cross_entropy.cu``, whose header gives the design.

:func:`fused_cross_entropy` is a drop-in for
:func:`split_learning_tpu_torch.core.losses.cross_entropy` (the class
axis last, the mean over every label element, integer labels). On a
CUDA tensor it runs :class:`CrossEntropyFunction` over the logits
flattened to ``[N, C]`` rows, whose forward and backward each launch the
kernels; on a CPU tensor it returns the plain ``cross_entropy``.
The function's own forward and backward also accept CPU tensors, where
they run :func:`ce_forward_plain` and :func:`ce_backward_plain`, the
plain PyTorch versions of the kernels' math.

:func:`cross_entropy_rows` is the same pair of kernels for a caller that
also needs each row's loss (the coalescing server, which hands every
client the mean of its own rows): the forward's row log-sum-exp comes
out of the function, and a row's loss is ``lse - logits[row, label]``.
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
    lib.slt_ce_scratch_words.argtypes = []
    lib.slt_ce_scratch_words.restype = _i
    lib.slt_ce_fwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _p]
    lib.slt_ce_fwd.restype = _i
    lib.slt_ce_bwd.argtypes = [_p, _p, _p, _p, _p, _i, _i, _i, _p]
    lib.slt_ce_bwd.restype = _i
    return lib


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The forward's scratch for one stream, zeroed once: every launch
    leaves its arrival counter at zero (csrc/cross_entropy.cu)."""
    del stream  # part of the key: concurrent streams must not share it
    return torch.zeros(_lib().slt_ce_scratch_words(), dtype=torch.int32,
                       device=device)


def _check_inputs(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"expected logits [N, C] and labels [N]; got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    n, c = logits.shape
    if not (1 <= n < 2 ** 31 and 1 <= c < 2 ** 31):
        raise ValueError(f"cross-entropy needs 1 <= N, C < 2**31 rows and "
                         f"classes; got {n} x {c}")


# --------------------------------------------------------------------- #
# plain versions (the kernels' math in PyTorch; CPU path and yardstick)

def ce_forward_plain(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, row log-sum-exp [N]), float32, as the forward kernel:
    a label outside [0, C) makes its row loss NaN."""
    x = logits.float()
    m = x.max(dim=1, keepdim=True).values
    log_s = torch.log(torch.exp(x - m).sum(dim=1))
    y = labels.long()
    ok = (y >= 0) & (y < x.shape[1])
    x_y = x.gather(1, torch.where(ok, y, 0).unsqueeze(1)).squeeze(1)
    row_loss = torch.where(ok, log_s - (x_y - m.squeeze(1)), torch.nan)
    return row_loss.sum() / x.shape[0], m.squeeze(1) + log_s


def ce_backward_plain(logits: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(exp(x - lse) - onehot) * (g / N), in the logits dtype."""
    x = logits.float()
    p = torch.exp(x - lse.unsqueeze(1))
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols == labels.long().unsqueeze(1)).float()
    return ((p - onehot) * (g.float() / x.shape[0])).to(logits.dtype)


# --------------------------------------------------------------------- #
# kernel launches

def ce_forward_cuda(logits: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (mean loss, row log-sum-exp [N])."""
    check_cuda_tensor(logits, "logits", _LOGIT_DTYPES)
    check_cuda_tensor(labels, "labels", (torch.int64,))
    _check_inputs(logits, labels)
    n, c = logits.shape
    lse = torch.empty(n, device=logits.device, dtype=torch.float32)
    loss = torch.empty((), device=logits.device, dtype=torch.float32)
    stream = current_stream_handle(logits.device)
    with torch.cuda.device(logits.device):
        rc = _lib().slt_ce_fwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            _scratch(logits.device, stream.value).data_ptr(),
            loss.data_ptr(), n, c, int(logits.dtype == torch.bfloat16),
            stream)
    check_launch(rc, FWD)
    LAUNCHES.add(FWD)
    return loss, lse


def ce_backward_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel; ``g`` is read on the device."""
    check_cuda_tensor(logits, "logits", _LOGIT_DTYPES)
    check_cuda_tensor(labels, "labels", (torch.int64,))
    check_cuda_tensor(lse, "lse", (torch.float32,))
    _check_inputs(logits, labels)
    n, c = logits.shape
    if lse.shape != (n,):
        raise ValueError(f"lse must be [{n}]; got {tuple(lse.shape)}")
    g = g.to(device=logits.device, dtype=torch.float32).contiguous()
    if g.numel() != 1:
        raise ValueError("the loss cotangent must be a scalar")
    grad = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        rc = _lib().slt_ce_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), grad.data_ptr(), n, c,
            int(logits.dtype == torch.bfloat16),
            current_stream_handle(logits.device))
    check_launch(rc, BWD)
    LAUNCHES.add(BWD)
    return grad


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    # a meta tensor (a FLOP count's shape pass, utils/flops.step_flops)
    # takes the plain path, which computes nothing there
    if t.device.type not in ("cpu", "meta"):
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


class CrossEntropyRowsFunction(torch.autograd.Function):
    """:class:`CrossEntropyFunction` that also returns the forward's row
    log-sum-exp ``[N]`` (float32, no gradient). The same launches: one
    forward, and one backward when the mean is differentiated."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_inputs(logits, labels)
        if _on_cuda(logits):
            loss, lse = ce_forward_cuda(logits, labels)
        else:
            loss, lse = ce_forward_plain(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g: torch.Tensor, g_lse: torch.Tensor):
        del g_lse  # the row LSE carries no gradient
        return CrossEntropyFunction.backward(ctx, g)


def cross_entropy_rows(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean softmax CE of logits ``[N, C]`` and labels ``[N]``
    (differentiable; K1's forward and backward on a CUDA tensor, their
    plain versions on a CPU one) and each row's loss ``[N]`` (float32,
    detached): ``lse - logits[row, label]``, NaN for a label outside
    ``[0, C)`` as in the forward kernel. The mean over any set of rows'
    losses is that set's own mean loss."""
    loss, lse = CrossEntropyRowsFunction.apply(logits, labels)
    x = logits.detach().float()
    y = labels.long()
    ok = (y >= 0) & (y < x.shape[1])
    x_y = x.gather(1, torch.where(ok, y, 0).unsqueeze(1)).squeeze(1)
    return loss, torch.where(ok, lse - x_y, torch.nan)


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """Mean softmax CE with integer labels: logits ``[..., C]``, labels
    ``[...]``, the mean over every label element, as optax's (the causal
    LM's ``[B, T, V]`` logits average over all B*T tokens).

    CUDA tensors go through the kernels (:class:`CrossEntropyFunction`)
    with the leading axes flattened to rows; CPU tensors through the
    plain :func:`core.losses.cross_entropy`."""
    if logits.dim() < 1 or labels.shape != logits.shape[:-1]:
        raise ValueError(f"expected logits [..., C] and labels [...]; got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if _on_cuda(logits):
        return CrossEntropyFunction.apply(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return cross_entropy(logits, labels)
