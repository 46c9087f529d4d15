"""Model FLOPs and MFU accounting (counterpart of
``split_learning_tpu/utils/flops.py``).

- :func:`step_flops` counts the matmul and convolution FLOPs of one call
  of a step function (pass the differentiated step, forward and
  backward, for training FLOPs) with ``torch.utils.flop_counter``'s
  per-op formulas (``FlopCounterMode``'s), on ``meta`` copies of the
  arguments: the count reads shapes only, runs no kernel and moves no
  state. JAX's ``jaxpr_matmul_flops`` walks the step's jaxpr for the
  same sum; where the two counters differ the port follows JAX (a
  convolution's input gradient, :func:`_conv_backward_flops`).
- The hand-written kernels launch through ``ctypes``, where the counter
  cannot see them; on meta tensors their wrappers take their plain
  versions, whose products the counter does see. For the flash kernels
  (K5, K6) that is 4·B·H·T²·D forward (QKᵀ and PV) and 10·B·H·T²·D
  backward (S recomputed once, dP, dQ, dK, dV), JAX's count, causal or
  not; not the recomputes of the three launches the card runs.
- :func:`device_peak_flops` is the card's dense bfloat16 peak, keyed on
  ``torch.cuda.get_device_name`` (one peak per device, JAX's
  definition); ``None`` for an unknown card or the CPU, and :func:`mfu`
  is then ``None`` rather than a guess.

Elementwise work (activations, norms, the loss, the optimizer) is not
counted, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, shape_wrapper
from torch.utils.weak import WeakIdKeyDictionary

# dense bfloat16 tensor-core peaks, FLOP/s, by exact device name (the
# vendor's data sheets)
_PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM
}

# meta tensors padded by conv_pad: the unpadded shape of each
_PADDED_BY_HAND = WeakIdKeyDictionary()


def device_peak_flops(device: Any = None) -> Optional[float]:
    """The card's dense bfloat16 peak in FLOP/s, or None (the CPU, an
    unknown card). ``device`` defaults to the current CUDA device."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in _PEAK_BF16_FLOPS.items():
        if name == key or name == key.replace("NVIDIA ", ""):
            return peak
    return None


def conv_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, pads)`` declared as the padding of the convolution it
    feeds, one that JAX pads inside (a model's SAME padding that
    PyTorch's convolution cannot take, ``models/resnet.py``): JAX forms
    the gradient of the unpadded input, so :func:`step_flops` counts
    that convolution's input gradient over ``x``'s extent. Marks meta
    tensors only; elsewhere it is ``F.pad``."""
    out = F.pad(x, pads)
    if out.is_meta:
        _PADDED_BY_HAND[out] = tuple(x.shape)
    return out


def _to_meta(x: Any) -> Any:
    if hasattr(x, "whole_meta"):
        # a leaf on a mesh (parallel/tensor.py) counts as the whole leaf:
        # the model's FLOPs, however the ranks split them
        return x.whole_meta().requires_grad_(True)
    if isinstance(x, torch.Tensor):
        m = x.detach().to("meta")
        return m.requires_grad_(True) if x.requires_grad else m
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias,
                         _stride, _padding, _dilation, transposed,
                         _output_padding, groups, output_mask, out_shape,
                         dx_shape=None, **kwargs) -> int:
    """A convolution's backward as JAX's jaxpr counts it: the input's
    gradient is a transposed convolution counted over the input's
    extent, 2 · |dx| · C_out/groups · kernel taps, and the weight's
    gradient the forward's count. ``dx_shape`` is the unpadded input's
    shape where the model padded by hand (:func:`conv_pad`), else the
    input's.

    JAX's count is not the work done. Its input gradient at stride s is
    an lhs-dilated convolution, and the count includes the multiplies by
    the dilation's zeros: s² times the products actually needed (4x at
    stride 2), where ``FlopCounterMode`` counts over the output's extent,
    the forward's work. The port keeps JAX's count; ResNet-18's strided
    convolutions make its step count, and so its MFU, higher than the
    work done (PERF.md gives by how much)."""
    taps = math.prod(w_shape[2:])
    flops = 0
    if output_mask[0]:
        c_out = w_shape[1] if transposed else w_shape[0]
        dx = x_shape if dx_shape is None else dx_shape
        flops += 2 * math.prod(dx) * (c_out // (
            1 if transposed else groups)) * taps
    if output_mask[1]:
        # the forward: 2 · |out| · C_in/groups · taps
        out = x_shape if transposed else grad_out_shape
        flops += 2 * math.prod(out) * w_shape[1] * taps
    return flops


class _Counter(TorchDispatchMode):
    """``FlopCounterMode``'s per-op formulas (``flop_registry``), with
    :func:`_conv_backward_flops` for the convolution's backward, summed
    over every op dispatched. Unlike ``FlopCounterMode`` it tracks no
    modules: its per-module backward hooks refuse a leaf input under
    ``torch.autograd.grad`` (a cut layer's activations)."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0
        self._formulas = {**flop_registry,
                          torch.ops.aten.convolution_backward:
                          shape_wrapper(_conv_backward_flops)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            if func._overloadpacket == torch.ops.aten.convolution_backward:
                kwargs = dict(kwargs,
                              dx_shape=_PADDED_BY_HAND.get(args[1]))
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def step_flops(fn: Callable[..., Any], *args: Any) -> float:
    """Matmul and convolution FLOPs of one call ``fn(*args)``, counted on
    meta copies of ``args`` (tensors, and dicts, lists and tuples of
    them; a tensor that requires grad keeps requiring it). ``fn`` must
    take its state from its arguments: it runs on the copies, never on
    the live tensors."""
    meta = _to_meta(args)
    with _Counter() as counter, torch.enable_grad():
        fn(*meta)
    return float(counter.total)


def mfu(achieved_flops_per_sec: Optional[float],
        peak_flops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1], or None when the peak is
    unknown."""
    if not peak_flops or achieved_flops_per_sec is None:
        return None
    return achieved_flops_per_sec / peak_flops
