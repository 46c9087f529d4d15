"""Wire codec: msgpack frames of array trees, with int8 and top-k int8
compression of the cut-layer tensors.

Counterpart of ``split_learning_tpu/transport/codec.py``, byte for byte:
the same msgpack ext type for arrays (dtype, shape, raw buffer; no
pickle, no code run on decode), the same q8 and topk8 dicts in the same
key order, the same CRC-32, the same error-feedback ledgers. Frames of
either package decode in the other.

What the port adds is where the arithmetic runs. ``q8_compress``,
``topk8_compress`` and ``TopK8EF.compress`` take either

- a numpy array: the host path, JAX's numpy codec line for line (the
  bit-identical twin of its ``native/slt_codec.cc``, which is not
  ported); or
- a tensor: the device path. On a CUDA tensor the whole encode runs on
  the card through the hand-written kernels (``ops/quantize.py`` K3, one
  launch; ``ops/topk.py`` K4, five launches), which leave a header (the
  non-finite flag or the amax) and the payload (q, then the bitmap or
  the indices) in one device buffer: the frame costs one copy to the
  host, and the host waits for the card once. On a CPU tensor the
  kernels' plain versions build the same buffer. Both give the numpy
  path's dict, and the new residual stays a tensor on the input's
  device. A refused tensor changes no ledger.

``decompress_tree(obj, device=None)`` rebuilds dense leaves on the host
as numpy (JAX's behaviour) or, given a device, as tensors there: a copy
of the int8 payload to the device, then the dequantize kernel (q8) or a
scatter (topk8). numpy has no bfloat16; a bfloat16 leaf decoded on the
host is a CPU ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import math
import threading
import zlib
from typing import Any, Optional, Tuple

import msgpack
import numpy as np
import torch

from split_learning_tpu_torch.ops.quantize import (
    EPS as _Q8_EPS, q8_dequantize, q8_encode, split_q8)
from split_learning_tpu_torch.ops.topk import (
    BIT_WEIGHTS as _BIT_WEIGHTS, split_select, topk8_select)

_NDARRAY_EXT = 42

# allow-list of dtypes permitted on the wire (no object arrays)
_SAFE_DTYPES = frozenset(
    ["float32", "float64", "float16", "bfloat16",
     "int8", "int16", "int32", "int64",
     "uint8", "uint16", "uint32", "uint64", "bool"]
)


class CodecError(ValueError):
    pass


def _dtype_name(x: Any) -> str:
    """The wire's dtype name of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CodecError(f"no torch dtype for {name!r}")
    return dt


def _pack_array(arr: np.ndarray) -> bytes:
    name = arr.dtype.name
    if name not in _SAFE_DTYPES:
        raise CodecError(f"refusing to serialize dtype {name!r}")
    header = msgpack.packb((name, list(arr.shape)))
    return header + np.ascontiguousarray(arr).tobytes()


def _pack_tensor(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return _pack_array(t.numpy())
    header = msgpack.packb(("bfloat16", list(t.shape)))
    return header + t.view(torch.int16).numpy().tobytes()


def _unpack_array(data: bytes) -> Any:
    unpacker = msgpack.Unpacker(max_buffer_size=len(data))
    unpacker.feed(data)
    name, shape = unpacker.unpack()
    if name not in _SAFE_DTYPES:
        raise CodecError(f"refusing to deserialize dtype {name!r}")
    offset = unpacker.tell()
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16, offset=offset).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(data, dtype=np.dtype(name), offset=offset)
    return arr.reshape(shape)


def _default(obj: Any) -> Any:
    # numpy scalars also expose __array__ — check them first so they
    # round-trip as native ints/floats, not 0-d arrays
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, (np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return msgpack.ExtType(_NDARRAY_EXT, _pack_tensor(obj))
    if hasattr(obj, "__array__") or isinstance(obj, np.ndarray):
        return msgpack.ExtType(_NDARRAY_EXT, _pack_array(np.asarray(obj)))
    raise CodecError(f"cannot serialize {type(obj)!r}")


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _NDARRAY_EXT:
        return _unpack_array(data)
    raise CodecError(f"unknown ext type {code}")


def encode(obj: Any) -> bytes:
    """Tree of dict/list/scalars/arrays/tensors -> bytes (tensors are
    copied to the host)."""
    return msgpack.packb(obj, default=_default, use_bin_type=True)


def decode(data: bytes) -> Any:
    """bytes -> tree with numpy arrays at the leaves."""
    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False,
                           strict_map_key=False)


def checksum(data: bytes) -> int:
    """Frame checksum: IEEE CRC-32 (zlib), copy-free and GIL-releasing."""
    return zlib.crc32(data) & 0xFFFFFFFF


# --------------------------------------------------------------------- #
# q8: symmetric int8 with one per-tensor scale (4x fewer bytes)
# --------------------------------------------------------------------- #
_Q8_KEY = "__q8__"


def _ensure_finite(a: np.ndarray, orig_dtype: Any) -> None:
    """A NaN/Inf element poisons the scale and the whole tensor would
    decode as NaN silently: refuse it."""
    if a.size and not np.isfinite(a).all():
        raise CodecError(
            f"refusing to quantize non-finite tensor "
            f"(shape={list(a.shape)}, dtype={orig_dtype})")


def _wire_scale(amax: float, n: int) -> float:
    """The wire's double scale from the float32 amax."""
    return max(amax / 127.0, _Q8_EPS) if n else _Q8_EPS


def _device_input(t: torch.Tensor) -> torch.Tensor:
    x = t.detach()
    return x if x.dtype in (torch.float32, torch.bfloat16) else x.float()


def _refuse_non_finite(amax: float, t: torch.Tensor) -> None:
    if not math.isfinite(amax):
        raise CodecError(
            f"refusing to quantize non-finite tensor "
            f"(shape={list(t.shape)}, dtype={_dtype_name(t)})")


def q8_compress(arr: Any) -> dict:
    """float array or tensor -> {__q8__, q(int8), scale, shape, dtype}."""
    if isinstance(arr, torch.Tensor):
        x = _device_input(arr)
        n = x.numel()
        # the header and the payload in one copy to the host
        amax, _, q = split_q8(q8_encode(x, n).cpu(), n)
        _refuse_non_finite(amax, arr)
        return {_Q8_KEY: True, "q": q.reshape(tuple(x.shape)),
                "scale": _wire_scale(amax, n),
                "shape": list(x.shape), "dtype": _dtype_name(arr)}
    a = np.ascontiguousarray(arr, dtype=np.float32)
    _ensure_finite(a, np.asarray(arr).dtype)
    scale = max(float(np.max(np.abs(a))) / 127.0, _Q8_EPS) if a.size \
        else _Q8_EPS
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return {_Q8_KEY: True, "q": q, "scale": scale,
            "shape": list(a.shape), "dtype": str(np.asarray(arr).dtype)}


def is_q8(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get(_Q8_KEY) is True


def _host_result(x: np.ndarray, name: str) -> Any:
    if name == "bfloat16":  # numpy has no bfloat16: a CPU tensor
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return x.astype(np.dtype(name))


def q8_decompress(d: dict, device: Optional[torch.device] = None) -> Any:
    """The dense tensor of a q8 dict: numpy on the host (``device``
    None), else a tensor on ``device`` (the dequantize kernel on CUDA)."""
    q8 = np.asarray(d["q"], np.int8)
    if device is not None:
        q = torch.tensor(q8, device=device)
        x = q8_dequantize(q, float(d["scale"])).reshape(d["shape"])
        return x.to(_torch_dtype(d["dtype"]))
    x = (q8.astype(np.float32) * d["scale"]).reshape(d["shape"])
    return _host_result(x, d["dtype"])


# --------------------------------------------------------------------- #
# topk8: top-k magnitude sparsification + int8 quantization of the
# survivors (the q8 scale math; the global |max| always survives, so the
# scale equals dense q8's). The sender keeps the compression error in a
# per-tensor error-feedback residual (TopK8EF), added back before the
# next step's selection. Positions travel as int32 indices ("idx") or a
# packed bitmap ("m", n/8 bytes), whichever is smaller.
# --------------------------------------------------------------------- #
_TOPK8_KEY = "__topk8__"


def _topk8_select_numpy(flat: np.ndarray, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Every element strictly above the k-th-largest magnitude, then
    threshold ties in ascending index order until k. Returns (ascending
    int32 indices, gathered values)."""
    n = flat.size
    if k >= n:
        idx = np.arange(n, dtype=np.int32)
        return idx, flat.copy()
    absv = np.abs(flat)
    thr = np.partition(absv, n - k)[n - k]
    gt = absv > thr
    need = k - int(np.count_nonzero(gt))
    ties = np.flatnonzero(absv == thr)[:need]
    idx = np.sort(np.concatenate([np.flatnonzero(gt), ties]))
    idx = idx.astype(np.int32)
    return idx, flat[idx]


def _unpackbits(m: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``np.packbits``: the first ``n`` bits as booleans."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=m.device)
    return ((m.view(-1, 1) & w) != 0).reshape(-1)[:n]


def _k_of(density: float, n: int) -> int:
    return max(1, min(n, int(math.ceil(density * n))))


def _topk8_compress_tensor(arr: torch.Tensor, density: float,
                           residual: Any, decay: float,
                           keep_residual: bool = True
                           ) -> Tuple[dict, Optional[torch.Tensor]]:
    x = _device_input(arr)
    shape, n = tuple(x.shape), x.numel()
    d: dict = {_TOPK8_KEY: True, "n": n, "shape": list(shape),
               "dtype": _dtype_name(arr)}
    if n >= 2 ** 31:
        raise CodecError(
            f"topk8 indices are int32; tensor of {n} elements exceeds the "
            "addressable range")
    if n == 0:
        d.update(idx=np.zeros(0, np.int32), q=np.zeros(0, np.int8),
                 scale=_Q8_EPS)
        return d, torch.zeros(shape, dtype=torch.float32, device=x.device)
    res = None
    if residual is not None and tuple(residual.shape) == shape:
        res = torch.as_tensor(residual, dtype=torch.float32,
                              device=x.device)
    k = _k_of(density, n)
    # error feedback: the new residual is x_eff less what the receiver
    # rebuilds (q * scale at the survivors); the dropped mass and the
    # quantization error ride into the next step
    buf, x_eff = topk8_select(x, res, decay, k, keep_residual)
    # the header and the payload in one copy to the host
    bad, amax, q, form, pos = split_select(buf.cpu(), n, k)
    if bad:
        _refuse_non_finite(math.nan, arr)
    d[form] = pos
    d.update(q=q, scale=_wire_scale(amax, n))
    return d, None if x_eff is None else x_eff.reshape(shape)


def topk8_compress(arr: Any, density: float, residual: Any = None,
                   decay: float = 1.0) -> Tuple[dict, Any]:
    """float array or tensor -> ({__topk8__, idx|m, q, scale, ...},
    new_residual).

    Adds ``float32(decay) * residual`` (the error fed back from the
    previous step; None or another shape = zeros) to the input, selects
    the top ``ceil(density * n)`` magnitudes, int8-quantizes them with
    the q8 scale math, and returns the new residual: the whole
    compression error, in the input's kind (numpy, or a float32 tensor
    on the input's device)."""
    if not 0.0 < density <= 1.0:
        raise CodecError(f"topk8 density must be in (0, 1] (got {density})")
    if isinstance(arr, torch.Tensor):
        return _topk8_compress_tensor(arr, density, residual, decay)
    if isinstance(residual, torch.Tensor):
        residual = residual.detach().cpu().numpy()
    if residual is not None and decay != 1.0:
        residual = np.float32(decay) * residual
    a = np.ascontiguousarray(arr, dtype=np.float32)
    _ensure_finite(a, np.asarray(arr).dtype)
    if a.size >= 2 ** 31:
        raise CodecError(
            f"topk8 indices are int32; tensor of {a.size} elements "
            "exceeds the addressable range")
    if residual is not None and residual.shape == a.shape:
        flat = (a + residual).reshape(-1)
    else:
        flat = a.copy().reshape(-1)
    n = flat.size
    d: dict = {_TOPK8_KEY: True, "n": n, "shape": list(a.shape),
               "dtype": str(np.asarray(arr).dtype)}
    if n == 0:
        d.update(idx=np.zeros(0, np.int32), q=np.zeros(0, np.int8),
                 scale=_Q8_EPS)
        return d, flat.reshape(a.shape)
    k = _k_of(density, n)
    idx, vals = _topk8_select_numpy(flat, k)
    scale = max(float(np.max(np.abs(vals))) / 127.0, _Q8_EPS)
    q = np.clip(np.round(vals / scale), -127, 127).astype(np.int8)
    flat[idx] -= q.astype(np.float32) * np.float32(scale)
    if n < 32 * k:  # bitmap (n/8 B) beats int32 indices (4k B)
        mask = np.zeros(n, np.bool_)
        mask[idx] = True
        d["m"] = np.packbits(mask)
    else:
        d["idx"] = idx
    d.update(q=q, scale=float(scale))
    return d, flat.reshape(a.shape)


def topk8_pack(arr: Any, density: float) -> dict:
    """Stateless :func:`topk8_compress` (inference: no error feedback on
    either end): the dict alone. A tensor's encode writes no residual."""
    if not isinstance(arr, torch.Tensor):
        return topk8_compress(arr, density)[0]
    if not 0.0 < density <= 1.0:
        raise CodecError(f"topk8 density must be in (0, 1] (got {density})")
    return _topk8_compress_tensor(arr, density, None, 1.0,
                                  keep_residual=False)[0]


def is_topk8(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get(_TOPK8_KEY) is True


def topk8_decompress(d: dict, device: Optional[torch.device] = None) -> Any:
    """{__topk8__, ...} -> dense tensor, numpy on the host or a tensor on
    ``device``. Indices and bitmap are checked against the declared size
    before anything is written: these are wire bytes."""
    n = int(d["n"])
    if n < 0:
        raise CodecError(f"topk8: negative element count {n}")
    q = np.asarray(d["q"], np.int8).reshape(-1)
    scale = float(d["scale"])
    if "m" in d:
        m = np.asarray(d["m"], np.uint8).reshape(-1)
        if m.size * 8 < n:
            raise CodecError(
                f"topk8: bitmap of {m.size} bytes cannot cover {n} elements")
        if device is not None:
            idx_t = torch.nonzero(
                _unpackbits(torch.tensor(m, device=device), n)).reshape(-1)
            count = idx_t.numel()
        else:
            idx = np.flatnonzero(np.unpackbits(m, count=n))
            count = idx.size
    else:
        idx = np.asarray(d["idx"], np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise CodecError("topk8: index out of range")
        count = idx.size
        if device is not None:
            idx_t = torch.tensor(idx, device=device)
    if count != q.size:
        raise CodecError(f"topk8: {count} positions but {q.size} values")
    if device is not None:
        vals = torch.tensor(q, device=device).float() * torch.tensor(
            scale, dtype=torch.float32, device=device)
        flat_t = torch.zeros(n, dtype=torch.float32, device=device)
        flat_t[idx_t] = vals
        return flat_t.reshape(d["shape"]).to(_torch_dtype(d["dtype"]))
    flat = np.zeros(n, np.float32)
    flat[idx] = q.astype(np.float32) * np.float32(scale)
    return _host_result(flat.reshape(d["shape"]), d["dtype"])


def decompress_tree(obj: Any, device: Optional[torch.device] = None) -> Any:
    """Expand every q8/topk8 dict of a decoded tree. ``device`` None keeps
    the leaves on the host as numpy (JAX's behaviour); a device turns
    every array leaf into a tensor there."""
    if is_q8(obj):
        return q8_decompress(obj, device)
    if is_topk8(obj):
        return topk8_decompress(obj, device)
    if isinstance(obj, dict):
        return {k: decompress_tree(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decompress_tree(v, device) for v in obj]
    if device is not None and isinstance(obj, np.ndarray):
        return torch.tensor(obj, device=device)
    if device is not None and isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj


# Residual decay per tensor role. Gradients are an additive signal: full
# error feedback (decay 1) preserves the sum of updates. Activations are
# not: a residual added to the next step injects features of other
# samples, so it is halved each step (JAX's measured choice, codec.py
# EF_DECAY_* comment).
EF_DECAY_GRADS = 1.0
EF_DECAY_ACTS = 0.5

# tensor roles whose wire payload is a gradient; everything else on the
# step path is a forward activation
_GRAD_ROLES = frozenset({"u_grads", "/forward_pass", "/u_backward",
                         "hop_g", "/hop_backward", "/hop_loss"})


def ef_decay_for(role: str) -> float:
    """Residual decay for a wire tensor role."""
    return EF_DECAY_GRADS if role in _GRAD_ROLES else EF_DECAY_ACTS


class TopK8EF:
    """Per-tensor sender-side error-feedback residuals for topk8.

    One instance per wire endpoint: the client transport keys by
    (role, client_id), ``ServerRuntime.wire_ef`` by (client_id, op). All
    state transitions happen under one lock. ``decay`` scales the stored
    residual before it is added back. A residual lives in the kind of
    the tensor it came from: a tensor on the card for a CUDA input.
    ``rollback(key)`` undoes the latest ``compress`` (a send that failed
    after packing must not mark the shipped mass as delivered)."""

    def __init__(self) -> None:
        self._res: dict = {}
        self._prev: dict = {}
        self._lock = threading.Lock()

    def compress(self, key: Any, arr: Any, density: float,
                 decay: float = EF_DECAY_GRADS) -> dict:
        with self._lock:
            prev = self._res.get(key)
            packed, new_res = topk8_compress(arr, density, residual=prev,
                                             decay=decay)
            self._prev[key] = prev
            self._res[key] = new_res
            return packed

    def residual(self, key: Any) -> Any:
        """The residual stored under ``key`` (None before any compress)."""
        with self._lock:
            return self._res.get(key)

    def rollback(self, key: Any) -> None:
        with self._lock:
            if key in self._prev:
                self._res[key] = self._prev.pop(key)

    def reset(self) -> None:
        with self._lock:
            self._res.clear()
            self._prev.clear()

    # -- persistence ----------------------------------------------------- #
    def export_state(self) -> list:
        """Residual ledger as ``[{key, res}]`` records with numpy arrays;
        the one-deep rollback buffer is not exported."""
        with self._lock:
            items = list(self._res.items())
        return [{"key": list(k) if isinstance(k, tuple) else k,
                 "res": (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else v)}
                for k, v in items]

    def restore_state(self, entries: list) -> None:
        """Rebuild the ledger from :meth:`export_state` output; keys that
        exported as lists come back as tuples."""
        restored = self._restore_entries(entries)
        with self._lock:
            self._res.clear()
            self._prev.clear()
            self._res.update(restored)

    def merge_state(self, entries: list) -> int:
        """Adopt exported residuals for keys not held here; returns how
        many were adopted."""
        restored = self._restore_entries(entries)
        with self._lock:
            adopted = 0
            for key, res in restored.items():
                if key not in self._res:
                    self._res[key] = res
                    adopted += 1
            return adopted

    @staticmethod
    def _restore_entries(entries: list) -> dict:
        out = {}
        for rec in entries:
            key = rec["key"]
            if isinstance(key, list):
                key = tuple(key)
            out[key] = np.asarray(rec["res"], dtype=np.float32)
        return out


class ClappingEF(TopK8EF):
    """Storage-free error feedback (Clapping, arXiv:2509.19029 §3): the
    same in-memory fold as :class:`TopK8EF`, but the ledger is ephemeral:
    nothing is exported, restored or merged."""

    def export_state(self) -> list:
        return []

    def restore_state(self, entries: list) -> None:
        del entries  # storage-free: nothing persists, nothing restores

    def merge_state(self, entries: list) -> int:
        del entries  # no ledger migrates in clapping mode
        return 0


EF_MODES = ("topk8", "clapping")


def make_wire_ef(mode: str) -> TopK8EF:
    """EF ledger for ``mode``; an unknown mode fails here."""
    if mode not in EF_MODES:
        raise CodecError(
            f"unknown EF mode {mode!r} (expected one of {EF_MODES})")
    return ClappingEF() if mode == "clapping" else TopK8EF()


def compressed_leaf_bytes(obj: Any) -> Tuple[int, int]:
    """(logical_bytes, wire_bytes) summed over every q8/topk8 leaf of a
    packed tree; dense leaves count nothing."""
    if is_q8(obj) or is_topk8(obj):
        n = 1
        for s in obj["shape"]:
            n *= int(s)
        name = obj.get("dtype", "float32")
        itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
        wire = sum(np.asarray(obj[f]).nbytes
                   for f in ("q", "idx", "m") if f in obj)
        return n * itemsize, wire
    if isinstance(obj, dict):
        vals = obj.values()
    elif isinstance(obj, list):
        vals = obj
    else:
        return 0, 0
    raw = wire = 0
    for v in vals:
        r, w = compressed_leaf_bytes(v)
        raw += r
        wire += w
    return raw, wire
