"""Top-k magnitude sparsification of the cut-layer payload: the CUDA
kernels, their wrappers and their plain versions.

Counterpart of ``split_learning_tpu/ops/topk.py`` (``magnitudes``,
``topk8_encode``, ``topk8_decode``, ``topk8_residual``,
``topk8_roundtrip``; its Pallas kernel is ``_mag_kernel``). Two CUDA
sources, each with its :data:`LAUNCHES` names:

- ``csrc/topk.cu``, the magnitude kernel (``NAME``): ``m = |x_eff|``
  with ``x_eff = x + float32(decay) * res`` when an error-feedback
  residual is given, and a flag when ``x`` holds a NaN or an infinity.
  :func:`magnitudes` runs it; :func:`fold_magnitudes_plain` is also the
  first step of the encode's plain version.
- ``csrc/topk_select.cu``, the wire codec's whole topk8 encode in five
  launches (:data:`SELECT_LAUNCHES`): the fold, a radix select of the
  k-th largest magnitude, the int8 survivors in ascending index order,
  the new residual and the position map. :func:`topk8_select` runs it;
  its source's header gives the design.

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it runs the plain version (``*_plain``). The plain versions
select with PyTorch ops, as JAX leaves the selection to ``lax.top_k``
outside Pallas. Two orders are in use, and both break ties toward the
lower index:

- :func:`topk8_encode` returns ``idx`` in ``lax.top_k``'s order
  (descending magnitude), from a stable descending sort;
- the wire codec's set (:func:`select_topk`, :func:`topk8_select`) is in
  ascending index order: everything above the k-th largest magnitude,
  then the first ties (``split_learning_tpu/transport/codec.py:193-211``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)
from split_learning_tpu_torch.ops.quantize import (
    HEADER, _flat, _on_cuda, q8_encode, q8_views, scale_of)

NAME = "topk_magnitudes"
# the five launches of csrc/topk_select.cu, in order
SELECT_LAUNCHES = ("topk8_fold_hist", "topk8_hist_mid", "topk8_hist_low",
                   "topk8_count", "topk8_write")
BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)   # np.packbits: MSB first
_IN_DTYPES = (torch.float32, torch.bfloat16)
_p = ctypes.c_void_p
Fold = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_kernels()["topk"]
    lib.slt_topk_magnitudes.argtypes = [_p, _p, ctypes.c_float,
                                        ctypes.c_int64, ctypes.c_int, _p, _p,
                                        _p, _p]
    lib.slt_topk_magnitudes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _select_lib() -> ctypes.CDLL:
    return bind_select(load_kernels()["topk_select"])


def bind_select(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/topk_select.cu`` on a loaded
    library (any build of that source) and return it."""
    lib.slt_topk8_scratch_words.argtypes = []
    lib.slt_topk8_scratch_words.restype = ctypes.c_int
    lib.slt_topk8_encode.argtypes = [_p, ctypes.c_int, _p, ctypes.c_float,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, _p, _p, _p, _p]
    lib.slt_topk8_encode.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------- #
# the magnitude kernel and its plain version

def fold_magnitudes_plain(x: torch.Tensor, res: Optional[torch.Tensor] = None,
                          decay: float = 1.0) -> Fold:
    """(x_eff, m, bad), flat float32: ``x_eff = x + float32(decay) * res``
    (or ``x``), ``m = |x_eff|``; ``bad`` int32 ``[1]``, 1 when ``x`` has a
    non-finite element."""
    x_eff = x.reshape(-1).float()
    bad = (~torch.isfinite(x_eff)).any().to(torch.int32).reshape(1)
    if res is not None:
        d = torch.tensor(decay, dtype=torch.float32)
        x_eff = x_eff + d * res.reshape(-1)
    else:
        x_eff = x_eff.clone()
    return x_eff, x_eff.abs(), bad


def fold_magnitudes_cuda(x: torch.Tensor, res: Optional[torch.Tensor] = None,
                         decay: float = 1.0, want_x_eff: bool = True) -> Fold:
    """Launch the magnitude kernel over the contiguous ``x``; ``x_eff`` is
    None when not wanted (then it is not written)."""
    check_cuda_tensor(x, "x", _IN_DTYPES)
    n = x.numel()
    if res is not None:
        check_cuda_tensor(res, "res", (torch.float32,))
        if res.numel() != n or res.device != x.device:
            raise ValueError("res must match x in size and device")
    m = torch.empty(n, device=x.device, dtype=torch.float32)
    x_eff = torch.empty_like(m) if want_x_eff else None
    bad = torch.zeros(1, device=x.device, dtype=torch.int32)
    if n:
        rc = _lib().slt_topk_magnitudes(
            x.data_ptr(), res.data_ptr() if res is not None else None,
            float(decay), n, int(x.dtype == torch.bfloat16),
            x_eff.data_ptr() if x_eff is not None else None, m.data_ptr(),
            bad.data_ptr(), current_stream_handle(x.device))
        check_launch(rc, NAME)
        LAUNCHES.add(NAME)
    return x_eff, m, bad


# --------------------------------------------------------------------- #
# the topk8 encode: its layout, plain version, kernels and dispatch

def select_layout(n: int, k: int) -> Tuple[bool, int, int]:
    """(bitmap form?, byte offset of the positions, buffer bytes) of the
    encode of ``n`` values keeping ``k``: the header, q ``[k]`` padded to
    a multiple of 4, then the bitmap or the int32 indices."""
    bitmap = n < 32 * k   # bitmap (n/8 B) beats int32 indices (4k B)
    pos = HEADER + -(-k // 4) * 4
    return bitmap, pos, pos + (-(-n // 8) if bitmap else 4 * k)


def split_select(buf, n: int, k: int
                 ) -> Tuple[bool, float, np.ndarray, str, np.ndarray]:
    """``(flag, amax, q int8 [k], "m" or "idx", positions)`` of a host
    copy of :func:`topk8_select`'s buffer (a uint8 array or CPU tensor):
    the bitmap as uint8, or the indices as int32."""
    raw = np.asarray(buf, dtype=np.uint8).reshape(-1)
    bitmap, pos, end = select_layout(n, k)
    flag = bool(raw[:4].view(np.int32)[0])
    amax = float(raw[4:8].view(np.float32)[0])
    q = raw[HEADER:HEADER + k].view(np.int8)
    if bitmap:
        return flag, amax, q, "m", raw[pos:end]
    return flag, amax, q, "idx", raw[pos:end].view(np.int32)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` of a boolean vector, on its device."""
    pad = (-mask.numel()) % 8
    bits = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    w = torch.tensor(BIT_WEIGHTS, dtype=torch.uint8, device=mask.device)
    return (bits.view(-1, 8) * w).sum(dim=1).to(torch.uint8)


def select_topk(m: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codec's set: every ``m`` above the k-th largest, then the
    first ties by index, until k. Returns (ascending int64 indices, the
    boolean mask of the set)."""
    n = m.numel()
    if k >= n:
        return (torch.arange(n, device=m.device),
                torch.ones(n, dtype=torch.bool, device=m.device))
    thr = torch.topk(m, k, sorted=False).values.min()
    gt = m > thr
    eq = m == thr
    need = k - gt.sum()
    sel = gt | (eq & (torch.cumsum(eq, 0) <= need))
    return torch.nonzero(sel).reshape(-1), sel


def topk8_select_plain(x: torch.Tensor, res: Optional[torch.Tensor],
                       decay: float, k: int, keep_residual: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """What the five launches write, in PyTorch on ``x``'s device: the
    uint8 buffer of :func:`select_layout` and the new residual (flat
    float32, or None when not kept). A flagged input (a non-finite
    ``x``) gets the header alone: the codec refuses it."""
    x_eff, m, bad = fold_magnitudes_plain(x, res, decay)
    n = x_eff.numel()
    amax = m.max()
    bitmap, pos, end = select_layout(n, k)
    buf = torch.zeros(end, dtype=torch.uint8, device=x.device)
    buf[:4] = bad.view(torch.uint8)
    buf[4:8] = amax.reshape(1).view(torch.uint8)
    if bad.item():
        return buf, (x_eff if keep_residual else None)
    idx, sel = select_topk(m, k)
    scale = scale_of(amax)
    vals = x_eff[idx]
    q = torch.clamp(torch.round(vals / scale), -127, 127).to(torch.int8)
    x_eff[idx] = vals - q.float() * scale
    buf[HEADER:HEADER + k] = q.view(torch.uint8)
    buf[pos:] = (packbits(sel) if bitmap
                 else idx.to(torch.int32).view(torch.uint8))
    return buf, (x_eff if keep_residual else None)


# one encode's five launches are enqueued together: threads that encode
# on one stream (concurrent clients, HTTP handlers) must not interleave
# their launches, or one encode's histogram passes read another's scratch
_ENCODE_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The select launches' scratch for one stream, zeroed once: every
    call leaves it zeroed for the next (csrc/topk_select.cu)."""
    del stream  # part of the key: concurrent streams must not share it
    return torch.zeros(_select_lib().slt_topk8_scratch_words(),
                       dtype=torch.int32, device=device)


def topk8_select_cuda(x: torch.Tensor, res: Optional[torch.Tensor],
                      decay: float, k: int, keep_residual: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the five select kernels over the contiguous ``x``."""
    check_cuda_tensor(x, "x", _IN_DTYPES)
    n = x.numel()
    if res is not None:
        check_cuda_tensor(res, "res", (torch.float32,))
        if res.numel() != n or res.device != x.device:
            raise ValueError("res must match x in size and device")
    if not 1 <= k <= n < 2 ** 31:
        raise ValueError(f"need 1 <= k <= n < 2**31 (k {k}, n {n})")
    bitmap, _, end = select_layout(n, k)
    buf = torch.empty(end, device=x.device, dtype=torch.uint8)
    x_eff = (torch.empty(n, device=x.device, dtype=torch.float32)
             if keep_residual else None)
    stream = current_stream_handle(x.device)
    scratch = _scratch(x.device, stream.value)
    with _ENCODE_LOCK:
        rc = _select_lib().slt_topk8_encode(
            x.data_ptr(), int(x.dtype == torch.bfloat16),
            res.data_ptr() if res is not None else None, float(decay), n,
            k, int(bitmap), x_eff.data_ptr() if x_eff is not None else None,
            scratch.data_ptr(), buf.data_ptr(), stream)
    check_launch(rc, SELECT_LAUNCHES[0])
    for name in SELECT_LAUNCHES:
        LAUNCHES.add(name)
    return buf, x_eff


def topk8_select(x: torch.Tensor, res: Optional[torch.Tensor], decay: float,
                 k: int, keep_residual: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The wire codec's topk8 encode of ``x`` (any shape, float32 or
    bfloat16, ``n`` values) with an optional float32 residual folded in
    at ``decay``: (the uint8 buffer of :func:`select_layout` on ``x``'s
    device, the new flat float32 residual or None)."""
    if _on_cuda(x):
        return topk8_select_cuda(_flat(x), None if res is None else _flat(res),
                                 decay, k, keep_residual)
    return topk8_select_plain(x, res, decay, k, keep_residual)


# --------------------------------------------------------------------- #
# the JAX package's functions

def magnitudes(x: torch.Tensor) -> torch.Tensor:
    """x (any shape, float) -> flat float32 ``|x|`` of length ``x.numel()``."""
    if _on_cuda(x):
        return fold_magnitudes_cuda(_flat(x), want_x_eff=False)[1]
    return fold_magnitudes_plain(x)[1]


def topk8_encode(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x -> (idx int32 ``[k]``, q int8 ``[k]``, scale float32 scalar).

    ``idx`` in ``lax.top_k``'s order: descending magnitude, ties toward
    the lower index (a stable sort; ``torch.topk`` does not promise the
    tie order). The survivors are quantized with the q8 scale math."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}] (got {k})")
    order = torch.sort(magnitudes(x), descending=True, stable=True).indices
    idx = order[:k]
    stats, q = q8_views(q8_encode(flat[idx], k))
    return idx.to(torch.int32), q, stats[1]


def topk8_decode(idx: torch.Tensor, q: torch.Tensor, scale,
                 shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(idx, q, scale) -> dense tensor: ``q * scale`` at ``idx``, zeros
    elsewhere."""
    n = 1
    for s in shape:
        n *= int(s)
    vals = q.float() * torch.as_tensor(scale, dtype=torch.float32,
                                       device=q.device)
    flat = torch.zeros(n, dtype=torch.float32, device=q.device)
    flat[idx.long()] = vals
    return flat.reshape(tuple(shape)).to(dtype)


def topk8_residual(x: torch.Tensor, idx: torch.Tensor, q: torch.Tensor,
                   scale) -> torch.Tensor:
    """Error-feedback residual: ``x`` minus what the receiver rebuilds."""
    vals = q.float() * torch.as_tensor(scale, dtype=torch.float32,
                                       device=q.device)
    flat = x.reshape(-1).float().clone()
    i = idx.long()
    flat[i] = flat[i] - vals
    return flat.reshape(x.shape)


def topk8_roundtrip(x: torch.Tensor, k: int) -> torch.Tensor:
    """Encode then decode: one step's distortion before error feedback."""
    idx, q, scale = topk8_encode(x, k)
    return topk8_decode(idx, q, scale, tuple(x.shape), x.dtype)
