"""Int8 symmetric quantization of the cut-layer payload: the CUDA kernels
and their wrappers.

Counterpart of ``split_learning_tpu/ops/quantize.py`` (``quantize_int8``,
``dequantize_int8``, ``quantize_dequantize``; its Pallas kernels are
``_quant_fused_kernel``, ``_amax_kernel`` + ``_quant_scaled_kernel`` and
``_dequant_kernel``). The kernels live in ``csrc/quantize.cu``, whose
header gives the design::

    scale = max(max|x| / 127, 1e-12)     float32
    q     = clip(rint(x / scale), -127, 127)  int8 (half to even)
    x'    = q * scale

Three launches, each with its :data:`LAUNCHES` name:

- :func:`q8_amax` (``AMAX``): ``{amax, scale}`` of a flat tensor, as a
  float32 ``[2]`` tensor on its device (two kernels: per-block
  partials, then a one-block reduce);
- :func:`q8_quantize` (``QUANT``): int8 ``[n_out]`` from a flat tensor
  and those stats, zeros past the input;
- :func:`q8_dequantize` (``DEQUANT``): float32 from int8 and a scale.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version (``*_plain``), which the tests hold to
the JAX kernels and ``chip_smoke.py`` holds the kernels to. The JAX
functions keep their shapes: ``quantize_int8`` returns ``q`` as the
zero-padded ``[rows, 128]`` tile array (``rows`` a multiple of 32), so
tests compare whole arrays; the wire codec asks for the unpadded
length instead. The TPU's one-block / 512-row-grid choice is VMEM
layout and has no counterpart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)

AMAX = "q8_amax"
QUANT = "q8_quantize"
DEQUANT = "q8_dequantize"
EPS = 1e-12
LANE, INT8_SUBLANE = 128, 32
_IN_DTYPES = (torch.float32, torch.bfloat16)
_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(load_kernels()["quantize"])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/quantize.cu`` on a loaded
    library (any build of that source) and return it."""
    lib.slt_q8_amax_blocks.argtypes = [_i64]
    lib.slt_q8_amax_blocks.restype = _i
    lib.slt_q8_amax.argtypes = [_p, _i64, _i, _p, _p, _p]
    lib.slt_q8_amax.restype = _i
    lib.slt_q8_quantize.argtypes = [_p, _i64, _i64, _i, _p, _p, _p]
    lib.slt_q8_quantize.restype = _i
    lib.slt_q8_dequantize.argtypes = [_p, _i64, ctypes.c_float, _p, _p]
    lib.slt_q8_dequantize.restype = _i
    return lib


def tile_rows(n: int) -> int:
    """Rows of JAX's ``_to_tiles`` layout for ``n`` values: ceil(n / 128)
    rounded up to a multiple of 32 (at least 32)."""
    rows = max(-(-n // LANE), 1)
    return -(-rows // INT8_SUBLANE) * INT8_SUBLANE


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """float32 ``max(amax / 127, 1e-12)``, divided in double then narrowed
    (equal to the float32 quotient; the wire ships the double)."""
    return (amax.double() / 127.0).clamp_min(EPS).float()


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1) if x.is_contiguous() else x.contiguous().reshape(-1)


# --------------------------------------------------------------------- #
# plain versions (the kernels' math in PyTorch; CPU path and yardstick)

def amax_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[2]``: ``max|x|`` (NaN if any NaN; 0 when empty) and the
    scale."""
    flat = x.reshape(-1).float()
    amax = flat.abs().max() if flat.numel() else flat.new_zeros(())
    return torch.stack([amax, scale_of(amax)])


def quantize_plain(x: torch.Tensor, stats: torch.Tensor,
                   n_out: int) -> torch.Tensor:
    """int8 ``[n_out]``: the quantized flat ``x``, then zeros."""
    flat = x.reshape(-1).float()
    q = torch.zeros(n_out, dtype=torch.int8, device=x.device)
    q[:flat.numel()] = torch.clamp(torch.round(flat / stats[1]),
                                   -127, 127).to(torch.int8)
    return q


def dequantize_plain(q: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 ``q * float32(scale)``, elementwise."""
    return q.float() * torch.tensor(scale, dtype=torch.float32)


# --------------------------------------------------------------------- #
# kernel launches

def amax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the two amax kernels over the contiguous ``x``."""
    check_cuda_tensor(x, "x", _IN_DTYPES)
    n = x.numel()
    lib = _lib()
    partials = torch.empty(lib.slt_q8_amax_blocks(n), device=x.device,
                           dtype=torch.float32)
    stats = torch.empty(2, device=x.device, dtype=torch.float32)
    rc = lib.slt_q8_amax(x.data_ptr(), n, int(x.dtype == torch.bfloat16),
                         partials.data_ptr(), stats.data_ptr(),
                         current_stream_handle(x.device))
    check_launch(rc, AMAX)
    LAUNCHES.add(AMAX)
    return stats


def quantize_cuda(x: torch.Tensor, stats: torch.Tensor,
                  n_out: int) -> torch.Tensor:
    """Launch the quantize kernel: int8 ``[n_out]``, zeros past ``x``."""
    check_cuda_tensor(x, "x", _IN_DTYPES)
    check_cuda_tensor(stats, "stats", (torch.float32,))
    if stats.numel() != 2 or stats.device != x.device:
        raise ValueError("stats must be q8_amax's [2] on x's device")
    n = x.numel()
    if n_out < n:
        raise ValueError(f"n_out {n_out} < {n} input values")
    q = torch.empty(n_out, device=x.device, dtype=torch.int8)
    if n_out == 0:
        return q
    rc = _lib().slt_q8_quantize(x.data_ptr(), n, n_out,
                                int(x.dtype == torch.bfloat16),
                                stats.data_ptr(), q.data_ptr(),
                                current_stream_handle(x.device))
    check_launch(rc, QUANT)
    LAUNCHES.add(QUANT)
    return q


def dequantize_cuda(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the dequantize kernel: float32 ``q * scale``, ``q``'s shape."""
    check_cuda_tensor(q, "q", (torch.int8,))
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    if q.numel() == 0:
        return out
    rc = _lib().slt_q8_dequantize(q.data_ptr(), q.numel(), float(scale),
                                  out.data_ptr(),
                                  current_stream_handle(q.device))
    check_launch(rc, DEQUANT)
    LAUNCHES.add(DEQUANT)
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device} (cuda or cpu)")
    return False


# --------------------------------------------------------------------- #
# dispatch by device

def q8_amax(x: torch.Tensor) -> torch.Tensor:
    """``{amax, scale}`` of ``x`` (any shape) as float32 ``[2]``."""
    return amax_cuda(_flat(x)) if _on_cuda(x) else amax_plain(x)


def q8_quantize(x: torch.Tensor, stats: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """int8 ``[n_out]`` of ``x`` (any shape) at ``stats``' scale."""
    if _on_cuda(x):
        return quantize_cuda(_flat(x), stats, n_out)
    return quantize_plain(x, stats, n_out)


def q8_dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 ``q * float32(scale)`` in ``q``'s shape."""
    if _on_cuda(q):
        return dequantize_cuda(q.contiguous(), scale)
    return dequantize_plain(q, scale)


# --------------------------------------------------------------------- #
# the JAX package's functions

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, float) -> (q int8 ``[rows, 128]``, scale float32
    scalar), ``rows`` as :func:`tile_rows`; padding quantizes to 0."""
    stats = q8_amax(x)
    n_out = tile_rows(x.numel()) * LANE
    return q8_quantize(x, stats, n_out).reshape(-1, LANE), stats[1]


def dequantize_int8(q: torch.Tensor, scale, shape: Tuple[int, ...],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q ``[rows, 128]``, scale) -> the original-shape tensor."""
    n = 1
    for s in shape:
        n *= int(s)
    x = q8_dequantize(q, float(scale))
    return x.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    """Round trip (the transport-visible distortion)."""
    q, scale = quantize_int8(x)
    return dequantize_int8(q, scale, tuple(x.shape), x.dtype)
