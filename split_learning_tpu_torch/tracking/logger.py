"""Experiment tracking (counterpart of ``split_learning_tpu/tracking/logger.py``).

The same MetricLogger protocol, experiment naming and records as the JAX
package: stdout, jsonl, noop and mlflow. ``tracking="mlflow"`` degrades
as JAX's does: the ``mlflow`` package if it imports, otherwise the REST
protocol (``tracking/mlflow_rest.py``) for an ``http(s)`` tracking URI,
otherwise stdout, each fallback announced on stderr in JAX's words.
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


def default_run_name(mode: str) -> str:
    """f"{mode.capitalize()}_Training", with :func:`experiment_name`'s
    u_split aliasing."""
    base = "split" if mode == "u_split" else mode
    return f"{base.capitalize()}_Training"


class MetricLogger:
    def log_metric(self, key: str, value: float, step: int) -> None:
        raise NotImplementedError

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def log_artifact(self, path: str) -> None:
        """Persist a file or directory with the run (a no-op on backends
        without an artifact store)."""

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


class MlflowLogger(MetricLogger):
    """The ``mlflow`` package's client, with the reference server's
    experiment and run names; the tracking URI comes from the config.
    Raises ``ImportError`` where the package is absent."""

    def __init__(self, mode: str, tracking_uri: Optional[str] = None,
                 run_name: Optional[str] = None) -> None:
        try:
            import mlflow  # noqa: PLC0415
        except ImportError as exc:
            raise ImportError(
                "MlflowLogger requires mlflow; use tracking='jsonl' or "
                "'stdout' off-cluster") from exc
        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name(mode))
        self._run = mlflow.start_run(
            run_name=run_name or default_run_name(mode))

    def log_metric(self, key: str, value: float, step: int) -> None:
        self._mlflow.log_metric(key, value, step=step)

    def log_params(self, params: Dict[str, Any]) -> None:
        self._mlflow.log_params(params)

    def log_artifact(self, path: str) -> None:
        if os.path.isdir(path):
            self._mlflow.log_artifacts(path,
                                       artifact_path=os.path.basename(path))
        else:
            self._mlflow.log_artifact(path)

    def close(self) -> None:
        self._mlflow.end_run()


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
        try:
            return MlflowLogger(cfg.mode, tracking_uri=cfg.tracking_uri,
                                run_name=run_name)
        except ImportError:
            if cfg.tracking_uri and cfg.tracking_uri.startswith(
                    ("http://", "https://")):
                # no package, but a server URI: the REST protocol
                from split_learning_tpu_torch.tracking.mlflow_rest import (
                    MlflowRestLogger)
                try:
                    logger = MlflowRestLogger(
                        cfg.mode, tracking_uri=cfg.tracking_uri,
                        run_name=run_name)
                    print("[tracking] mlflow package unavailable; using "
                          "the REST protocol directly", file=sys.stderr)
                    return logger
                except (OSError, ValueError, KeyError) as e:
                    # an unreachable or misbehaving server must not stop
                    # training
                    print(f"[tracking] MLflow server {cfg.tracking_uri} "
                          f"unusable ({type(e).__name__}: {e}); falling "
                          f"back to stdout", file=sys.stderr)
                    return StdoutLogger()
            print("[tracking] mlflow unavailable; falling back to stdout",
                  file=sys.stderr)
            return StdoutLogger()
    raise ValueError(f"Unknown tracking backend: {kind!r}")
