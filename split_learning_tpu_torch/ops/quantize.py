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

Two launches, each with its :data:`LAUNCHES` name:

- :func:`q8_encode` (``QUANT``): one cooperative launch that takes the
  amax and quantizes, returning one uint8 buffer on the input's device:
  a 16-byte header (float32 ``amax``, ``scale``, then zeros) and ``q``
  ``[n_out]``, zeros past the input. The wire codec copies it to the
  host in one piece (:func:`split_q8`);
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

import numpy as np
import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)

QUANT = "q8_amax_quantize"
DEQUANT = "q8_dequantize"
EPS = 1e-12
LANE, INT8_SUBLANE = 128, 32
HEADER = 16   # bytes ahead of q in q8_encode's buffer
_IN_DTYPES = (torch.float32, torch.bfloat16)
_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(load_kernels()["quantize"])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/quantize.cu`` on a loaded
    library (any build of that source) and return it."""
    lib.slt_q8_coresident_blocks.argtypes = [_i]
    lib.slt_q8_coresident_blocks.restype = _i
    lib.slt_q8_amax_quantize_grid.argtypes = [_i64, _i64, _i]
    lib.slt_q8_amax_quantize_grid.restype = _i
    lib.slt_q8_amax_quantize.argtypes = [_p, _i64, _i64, _i, _p, _i, _p, _p]
    lib.slt_q8_amax_quantize.restype = _i
    lib.slt_q8_dequantize.argtypes = [_p, _i64, ctypes.c_float, _p, _p]
    lib.slt_q8_dequantize.restype = _i
    return lib


@functools.lru_cache(maxsize=None)
def _coresident(lib: ctypes.CDLL, device: int, is_bf16: int) -> int:
    with torch.cuda.device(device):
        blocks = lib.slt_q8_coresident_blocks(is_bf16)
    if blocks < 1:
        raise RuntimeError(f"{QUANT}: no co-resident grid on cuda:{device} "
                           f"(cudaError {-blocks})")
    return blocks


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


def split_q8(buf, n_out: int) -> Tuple[float, float, np.ndarray]:
    """``(amax, float32 scale, q int8 [n_out])`` of a host copy of
    :func:`q8_encode`'s buffer (a uint8 array or CPU tensor)."""
    raw = np.asarray(buf, dtype=np.uint8).reshape(-1)
    head = raw[:8].view(np.float32)
    return float(head[0]), float(head[1]), raw[HEADER:HEADER + n_out].view(
        np.int8)


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


def q8_encode_plain(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """What the amax/quantize launch writes, in PyTorch on ``x``'s
    device: uint8 ``[16 + n_out]``."""
    stats = amax_plain(x)
    buf = torch.zeros(HEADER + n_out, dtype=torch.uint8, device=x.device)
    buf[:8] = stats.view(torch.uint8)
    buf[HEADER:] = quantize_plain(x, stats, n_out).view(torch.uint8)
    return buf


def dequantize_plain(q: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 ``q * float32(scale)``, elementwise."""
    return q.float() * torch.tensor(scale, dtype=torch.float32)


# --------------------------------------------------------------------- #
# kernel launches

def q8_encode_cuda(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the amax/quantize kernel over the contiguous ``x``: uint8
    ``[16 + n_out]`` on its device."""
    check_cuda_tensor(x, "x", _IN_DTYPES)
    n = x.numel()
    if n_out < n:
        raise ValueError(f"n_out {n_out} < {n} input values")
    lib = _lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    cap = _coresident(lib, x.device.index if x.device.index is not None
                      else torch.cuda.current_device(), is_bf16)
    grid = lib.slt_q8_amax_quantize_grid(n, n_out, cap)
    partials = torch.empty(grid, device=x.device, dtype=torch.float32)
    buf = torch.empty(HEADER + n_out, device=x.device, dtype=torch.uint8)
    with torch.cuda.device(x.device):
        rc = lib.slt_q8_amax_quantize(
            x.data_ptr(), n, n_out, is_bf16, partials.data_ptr(), grid,
            buf.data_ptr(), current_stream_handle(x.device))
    check_launch(rc, QUANT)
    LAUNCHES.add(QUANT)
    return buf


def dequantize_cuda(q: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the dequantize kernel: float32 ``q * scale``, ``q``'s shape."""
    check_cuda_tensor(q, "q", (torch.int8,))
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
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

def q8_encode(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """uint8 ``[16 + n_out]`` on ``x``'s device: float32 ``{amax,
    scale}``, 8 zero bytes, then ``q`` of ``x`` (any shape), zeros past
    it."""
    if _on_cuda(x):
        return q8_encode_cuda(_flat(x), n_out)
    return q8_encode_plain(x, n_out)


def q8_dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 ``q * float32(scale)`` in ``q``'s shape."""
    if _on_cuda(q):
        return dequantize_cuda(q.contiguous(), scale)
    return dequantize_plain(q, scale)


def q8_views(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``{amax, scale}`` float32 ``[2]``, ``q`` int8) views of a
    :func:`q8_encode` buffer, on its device."""
    return buf[:8].view(torch.float32), buf[HEADER:].view(torch.int8)


# --------------------------------------------------------------------- #
# the JAX package's functions

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, float) -> (q int8 ``[rows, 128]``, scale float32
    scalar), ``rows`` as :func:`tile_rows`; padding quantizes to 0."""
    stats, q = q8_views(q8_encode(x, tile_rows(x.numel()) * LANE))
    return q.reshape(-1, LANE), stats[1]


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
