"""Phase accounting and the device trace (counterpart of
``split_learning_tpu/utils/profiling.py``).

- :class:`PhaseProfiler`: wall-clock accounting of named step phases
  (compute against transport, the split that decides the north-star
  metric), with percentile summaries; JAX's, line for line.
- :func:`device_trace`: a context manager around ``torch.profiler`` with
  the CPU and CUDA activities, which writes a Chrome trace into
  ``log_dir`` (Perfetto-loadable). CUPTI sees every kernel on the card,
  the ``ctypes``-launched K1-K6 among them, by their CUDA names.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np

TRACE_FILE = "device_trace.json"


class PhaseProfiler:
    """Accumulates wall-clock per named phase across steps.

    Thread-safe: one profiler may be shared by the workers of
    ``MultiClientSplitRunner(concurrent=True)``."""

    def __init__(self) -> None:
        self._samples: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._samples[name].append(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = [(name, list(xs)) for name, xs in self._samples.items()]
        out = {}
        for name, xs in items:
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            }
        return out

    def fraction(self, name: str) -> float:
        """Share of the total accounted time spent in ``name`` (0.0 when
        nothing was recorded)."""
        with self._lock:
            totals = {k: sum(v) for k, v in self._samples.items()}
        denom = sum(totals.values())
        return totals.get(name, 0.0) / denom if denom else 0.0

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` over the body, its Chrome trace written to
    ``log_dir/device_trace.json`` (a no-op when ``log_dir`` is None). The
    CUDA activity is recorded only where a card is present."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
