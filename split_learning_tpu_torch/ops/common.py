"""Shared helpers for the hand-written Hopper kernels.

Counterpart of ``split_learning_tpu/ops/common.py``. The TPU tile
constants and the interpret-mode switch have no use here; in their
place:

- :data:`NEG_BIG`, the additive-mask value of the softmax-family
  kernels, copied from the JAX package.
- :data:`LAUNCHES`, the launch-count registry. Each kernel wrapper adds
  one to its name where it launches its kernel, and nowhere else, so a
  run can show that its main path went through the kernels. Its
  ``hook`` (None unless the dispatch watchdog, ``obs/dispatch_debug.py``,
  is installed) sees each launch on the launching thread.
- :func:`load_kernels`, which compiles ``csrc/*.cu`` with ``nvcc`` into
  shared libraries with a plain C interface and loads them with
  ``ctypes``. The build runs at first use, one ``nvcc`` per source, all
  started together, into ``build/torch_kernels/`` beside the package;
  each file name carries a hash of the sources and flags, so a changed
  source is rebuilt and an unchanged one is reused. A missing ``nvcc``
  or a failed build raises. :data:`BUILD_HOOK` (None unless the
  dispatch watchdog is installed) is told how many ``nvcc`` runs a build
  made, on the building thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# additive-mask value for softmax-family kernels: large enough to zero out
# after exp, small enough that (x - NEG_BIG) never overflows; masked entries
# must still be re-zeroed after any exp rebase
NEG_BIG = -1e30

# sm_90a: Hopper with its architecture-specific instructions. --fmad=false
# keeps a*b+c as two roundings, so the SGD kernel is bit-identical to its
# plain PyTorch version (which rounds lr*g before the subtraction); the
# flash-attention kernels' products are tensor-core instructions, which the
# flag does not touch.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


class LaunchCounts:
    """Per-kernel launch counters (plain integers keyed by kernel name),
    exact under concurrent launching threads (the multi-client runner's
    clients, the HTTP server's handlers)."""

    def __init__(self) -> None:
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.hook: Optional[Callable[[str], None]] = None

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
        if self.hook is not None:
            self.hook(name)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


LAUNCHES = LaunchCounts()

# the dispatch watchdog's build hook: called with the number of nvcc runs
BUILD_HOOK: Optional[Callable[[int], None]] = None

_LOADED: Dict[str, Dict[str, ctypes.CDLL]] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every ``csrc/*.cu``; ``{stem: CDLL}``.

    Raises ``RuntimeError`` when there is no ``nvcc`` or a build fails.
    Threads of one process build once: the first call may come from any
    of them (a coalescing server's flusher, HTTP handlers, client lanes),
    and builds write their objects under the process's id."""
    with _LOAD_LOCK:
        return _load_kernels()


def _load_kernels() -> Dict[str, ctypes.CDLL]:
    digest = _sources_digest()
    if digest in _LOADED:
        return _LOADED[digest]
    sources = sorted(CSRC_DIR.glob("*.cu"))
    targets = {src.stem: BUILD_DIR / f"{src.stem}-{digest}.so"
               for src in sources}
    pending = [(src, targets[src.stem]) for src in sources
               if not targets[src.stem].exists()]
    if pending:
        if BUILD_HOOK is not None:
            BUILD_HOOK(len(pending))
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in pending:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for src, out, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name} (rc {proc.returncode}):\n{err}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    libs = {stem: ctypes.CDLL(str(path)) for stem, path in targets.items()}
    _LOADED[digest] = libs
    return libs


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned after a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {rc})")


def current_stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
