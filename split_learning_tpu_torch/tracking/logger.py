"""Experiment tracking (counterpart of ``split_learning_tpu/tracking/logger.py``).

The same MetricLogger protocol, experiment naming and records as the JAX
package, for the stdout, jsonl and noop backends. MLflow is not ported
yet (ROADMAP item 22): ``tracking="mlflow"`` raises.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

from split_learning_tpu_torch.utils.config import Config


def experiment_name(mode: str) -> str:
    """f"{mode.capitalize()}_Learning_Sim"; u_split logs as split."""
    base = "split" if mode == "u_split" else mode
    return f"{base.capitalize()}_Learning_Sim"


class MetricLogger:
    def log_metric(self, key: str, value: float, step: int) -> None:
        raise NotImplementedError

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NoopLogger(MetricLogger):
    def log_metric(self, key: str, value: float, step: int) -> None:
        pass


class StdoutLogger(MetricLogger):
    """Progress prints every Nth step, as the reference client's."""

    def __init__(self, every: int = 10, stream=None) -> None:
        self.every = every
        self.stream = stream or sys.stdout

    def log_metric(self, key: str, value: float, step: int) -> None:
        if step % self.every == 0:
            print(f"[step {step}] {key}: {value:.4f}", file=self.stream,
                  flush=True)

    def log_params(self, params: Dict[str, Any]) -> None:
        print(f"[params] {params}", file=self.stream, flush=True)


class JsonlLogger(MetricLogger):
    """One JSON record per line, flushed per record."""

    def __init__(self, path: str, experiment: str = "",
                 run_name: str = "") -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self.experiment = experiment
        self.run_name = run_name

    def log_metric(self, key: str, value: float, step: int) -> None:
        self._f.write(json.dumps({
            "ts": time.time(), "experiment": self.experiment,
            "run": self.run_name, "key": key,
            "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def log_params(self, params: Dict[str, Any]) -> None:
        self._f.write(json.dumps({
            "ts": time.time(), "experiment": self.experiment,
            "run": self.run_name, "params": params}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def make_logger(cfg: Config, run_name: Optional[str] = None) -> MetricLogger:
    kind = cfg.tracking
    if kind == "noop":
        return NoopLogger()
    if kind == "stdout":
        return StdoutLogger()
    if kind == "jsonl":
        path = os.path.join(cfg.data_dir, "metrics",
                            f"{experiment_name(cfg.mode)}.jsonl")
        return JsonlLogger(path, experiment=experiment_name(cfg.mode),
                           run_name=run_name or "run")
    if kind == "mlflow":
        raise NotImplementedError(
            "MLflow tracking is not ported yet (ROADMAP item 22); use "
            "stdout, jsonl or noop")
    raise ValueError(f"Unknown tracking backend: {kind!r}")
