"""ctypes bindings for the native host codec (``slt_codec.cc``), the
port's counterpart of ``split_learning_tpu/native/codec.py``.

Build: the single translation unit is compiled with ``g++ -O3
-std=c++17 -shared -fPIC -pthread`` at first use into ``build/native/``
beside the package (``SLT_NATIVE_CACHE`` names another directory), under
a file name keyed by the source's hash, so an edit rebuilds and an
unchanged source is reused; concurrent builders write a temporary file
and rename it into place. The library is loaded with ``ctypes``.

There is no quiet fallback: a failed build (no ``g++``, a compile error,
a failed ``dlopen``) raises :class:`NativeBuildError` with the
compiler's message, from the first codec call that needs the library.
``SLT_NO_NATIVE=1`` is the one way onto the numpy line of
``transport/codec.py``: every function below then returns None and the
codec computes the same frames in numpy, byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "slt_codec.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The native codec did not build or load."""


def disabled() -> bool:
    """Whether ``SLT_NO_NATIVE`` sends the codec down its numpy line
    (read per call, as JAX's switch: any non-empty value)."""
    return bool(os.environ.get("SLT_NO_NATIVE"))


def cache_dir() -> Path:
    root = os.environ.get("SLT_NATIVE_CACHE")
    return Path(root) if root else BUILD_DIR


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return cache_dir() / f"slt_codec-{tag}.so"


def _build() -> Path:
    """Compile (or reuse) the shared library; its path. Raises
    :class:`NativeBuildError` with g++'s message on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeBuildError(
            f"native codec: g++ could not run ({exc}); install a C++17 "
            "compiler or set SLT_NO_NATIVE=1 for the numpy codec") from exc
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native codec: g++ failed (rc {proc.returncode}): "
            f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, out)  # atomic: concurrent builders converge
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.slt_absmax_f32.restype = ctypes.c_float
    lib.slt_absmax_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.slt_q8_quantize_f32.restype = ctypes.c_double
    lib.slt_q8_quantize_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int]
    lib.slt_q8_dequantize_f32.restype = None
    lib.slt_q8_dequantize_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.slt_topk8_select_f32.restype = None
    lib.slt_topk8_select_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.slt_topk8_scatter_f32.restype = None
    lib.slt_topk8_scatter_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.slt_crc32.restype = ctypes.c_uint32
    lib.slt_crc32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_uint32]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process.
    Raises :class:`NativeBuildError` (the same one on every later call)
    when the build or the load failed."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeBuildError(_error)
        try:
            path = _build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise NativeBuildError(
                    f"native codec: dlopen of {path} failed: {exc}") from exc
            _lib = _bind(lib)
        except NativeBuildError as exc:
            _error = str(exc)
            raise
        return _lib


def _active() -> Optional[ctypes.CDLL]:
    return None if disabled() else load()


def available() -> bool:
    """True when the library is in use: built and loaded, and not
    switched off by ``SLT_NO_NATIVE``. A failed build raises."""
    return _active() is not None


def build_error() -> Optional[str]:
    """Why the codec does not use the library (the build's error, or
    the switch), else None. Never raises."""
    if disabled():
        return "disabled via SLT_NO_NATIVE"
    try:
        load()
    except NativeBuildError as exc:
        return str(exc)
    return None


def q8_quantize(arr: np.ndarray, n_threads: int = 0
                ) -> Optional[Tuple[np.ndarray, float]]:
    """float32 array -> (int8 array of the same shape, scale); None on
    the numpy line or for another dtype."""
    lib = _active()
    if lib is None or arr.dtype != np.float32:
        return None
    a = np.ascontiguousarray(arr)
    q = np.empty(a.shape, np.int8)
    scale = lib.slt_q8_quantize_f32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(a.size),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int(n_threads))
    return q, float(scale)


def q8_dequantize(q: np.ndarray, scale: float, n_threads: int = 0
                  ) -> Optional[np.ndarray]:
    """int8 array and scale -> float32 array of the same shape."""
    lib = _active()
    if lib is None:
        return None
    qc = np.ascontiguousarray(q, np.int8)
    out = np.empty(qc.shape, np.float32)
    lib.slt_q8_dequantize_f32(
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(qc.size), ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads))
    return out


def topk8_select(arr: np.ndarray, k: int, n_threads: int = 0
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Flat float32 array -> (ascending int32 indices of the top-k
    magnitudes, gathered values): every element above the k-th largest
    magnitude, then threshold ties lowest index first, as
    ``codec._topk8_select_numpy``. None on the numpy line or for
    another dtype."""
    lib = _active()
    if lib is None or arr.dtype != np.float32:
        return None
    a = np.ascontiguousarray(arr).reshape(-1)
    k = int(k)
    idx = np.empty(k if k < a.size else a.size, np.int32)
    vals = np.empty(idx.size, np.float32)
    lib.slt_topk8_select_f32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(a.size), ctypes.c_int64(k),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads))
    return idx, vals


def topk8_scatter(idx: np.ndarray, q: np.ndarray, scale: float, n: int,
                  n_threads: int = 0) -> Optional[np.ndarray]:
    """(indices, int8 values, scale) -> dense float32 vector of length
    ``n`` with ``q * scale`` at ``idx``, zeros elsewhere."""
    lib = _active()
    if lib is None:
        return None
    ic = np.ascontiguousarray(idx, np.int64).reshape(-1)
    qc = np.ascontiguousarray(q, np.int8).reshape(-1)
    out = np.zeros(int(n), np.float32)
    lib.slt_topk8_scatter_f32(
        ic.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int64(qc.size), ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads))
    return out


def crc32(data: bytes, seed: int = 0) -> Optional[int]:
    """zlib-compatible CRC-32; None on the numpy line."""
    lib = _active()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(lib.slt_crc32(buf, ctypes.c_int64(len(data)),
                             ctypes.c_uint32(seed)))
