"""Top-k magnitude sparsification of the cut-layer payload: the CUDA
magnitude kernel, its wrapper and the selection around it.

Counterpart of ``split_learning_tpu/ops/topk.py`` (``magnitudes``,
``topk8_encode``, ``topk8_decode``, ``topk8_residual``,
``topk8_roundtrip``; its Pallas kernel is ``_mag_kernel``). The kernel
lives in ``csrc/topk.cu``, whose header gives the design. It computes
``m = |x_eff|`` with ``x_eff = x + float32(decay) * res`` when an
error-feedback residual is given (the wire codec's fold), raises a flag
when ``x`` holds a NaN or an infinity, and counts one launch under
:data:`NAME`. On a CUDA tensor :func:`fold_magnitudes` launches it or
raises; on a CPU tensor it runs :func:`fold_magnitudes_plain`.

The selection, gather and scatter are PyTorch ops on both devices, as
JAX leaves them to ``lax.top_k``, ``jnp.take`` and ``.at[].set`` outside
Pallas. Two orders are in use, and both break ties toward the lower
index:

- :func:`topk8_encode` returns ``idx`` in ``lax.top_k``'s order
  (descending magnitude), from a stable descending sort;
- :func:`select_topk` returns the wire codec's set in ascending index
  order: everything above the k-th largest magnitude, then the first
  ties (``split_learning_tpu/transport/codec.py:193-211``), and the
  boolean mask of that set, from which the codec packs its bitmap. The
  threshold is the smallest of ``torch.topk``'s k values: a value, so
  the order ``torch.topk`` gives ties does not matter. (``kthvalue``
  gives the same value but runs one block per slice on the card: 6.6 ms
  at the CNN cut against 0.22 ms, PERF.md.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from split_learning_tpu_torch.ops.common import (
    LAUNCHES, check_cuda_tensor, check_launch, current_stream_handle,
    load_kernels)
from split_learning_tpu_torch.ops.quantize import (
    _flat, _on_cuda, q8_amax, q8_quantize)

NAME = "topk_magnitudes"
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


# --------------------------------------------------------------------- #
# the kernel, its plain version and the dispatch

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


def fold_magnitudes(x: torch.Tensor, res: Optional[torch.Tensor] = None,
                    decay: float = 1.0) -> Fold:
    """(x_eff, m, bad) of ``x`` (any shape, float32 or bfloat16) and an
    optional float32 residual of the same size."""
    if _on_cuda(x):
        return fold_magnitudes_cuda(
            _flat(x), None if res is None else _flat(res), decay)
    return fold_magnitudes_plain(x, res, decay)


# --------------------------------------------------------------------- #
# the JAX package's functions

def magnitudes(x: torch.Tensor) -> torch.Tensor:
    """x (any shape, float) -> flat float32 ``|x|`` of length ``x.numel()``."""
    if _on_cuda(x):
        return fold_magnitudes_cuda(_flat(x), want_x_eff=False)[1]
    return fold_magnitudes_plain(x)[1]


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
    vals = flat[idx]
    stats = q8_amax(vals)
    return idx.to(torch.int32), q8_quantize(vals, stats, k), stats[1]


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
