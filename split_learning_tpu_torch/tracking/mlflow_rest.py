"""MLflow tracking over its REST wire protocol, with no client package
(counterpart of ``split_learning_tpu/tracking/mlflow_rest.py``).

Speaks the MLflow REST API 2.0 (``/api/2.0/mlflow/...``, the endpoints
the official client calls) with stdlib ``urllib``: the same requests
and bodies as the JAX package's logger, so one tracking server takes
either. Endpoints: ``experiments/get-by-name`` | ``experiments/create``,
``runs/create`` | ``runs/update``, ``runs/log-metric`` |
``runs/log-batch``.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from split_learning_tpu_torch.tracking.logger import (
    MetricLogger, default_run_name, experiment_name)


class MlflowRestLogger(MetricLogger):
    """Log to an MLflow tracking server through its REST API, with the
    reference server's experiment and run names (``{Mode}_Learning_Sim``
    / ``{Mode}_Training``); the tracking URI comes from the config."""

    # after this many consecutive send failures, stop warning (the run
    # keeps training; metrics drop with one line per failure up to here)
    _WARN_LIMIT = 3

    def __init__(self, mode: str, tracking_uri: str,
                 run_name: Optional[str] = None,
                 timeout: float = 5.0) -> None:
        self._base = tracking_uri.rstrip("/") + "/api/2.0/mlflow"
        self._timeout = timeout
        self._send_failures = 0
        exp_name = experiment_name(mode)
        exp_id = self._experiment_id(exp_name)
        run = self._post("runs/create", {
            "experiment_id": exp_id,
            "run_name": run_name or default_run_name(mode),
            "start_time": int(time.time() * 1000),
        })
        self._run_id = run["run"]["info"]["run_id"]

    # -- wire ---------------------------------------------------------- #
    def _post(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(
            f"{self._base}/{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def _experiment_id(self, name: str) -> str:
        try:
            got = self._post("experiments/get-by-name",
                             {"experiment_name": name})
            return got["experiment"]["experiment_id"]
        except urllib.error.HTTPError as e:
            if e.code not in (400, 404):  # 404: not found; 400: older servers
                raise
        try:
            return self._post("experiments/create", {"name": name})[
                "experiment_id"]
        except urllib.error.HTTPError:
            # get-or-create race: another client created it between our
            # two calls (RESOURCE_ALREADY_EXISTS) — re-read, it must
            # exist now
            got = self._post("experiments/get-by-name",
                             {"experiment_name": name})
            return got["experiment"]["experiment_id"]

    def _post_safe(self, path: str, body: Dict[str, Any]) -> None:
        """Per-step sends must not kill a training run on a transient
        server hiccup (the package client retries; here: warn and drop,
        capped so a dead server doesn't flood stderr)."""
        import sys
        try:
            self._post(path, body)
            self._send_failures = 0
        except (OSError, ValueError, KeyError) as e:
            # OSError: network/HTTP; ValueError: non-JSON body from a
            # misbehaving endpoint; KeyError: unexpected response shape
            self._send_failures += 1
            if self._send_failures <= self._WARN_LIMIT:
                more = (" (suppressing further warnings)"
                        if self._send_failures == self._WARN_LIMIT else "")
                print(f"[tracking] mlflow {path} failed ({e}); metric "
                      f"dropped{more}", file=sys.stderr)

    # -- MetricLogger -------------------------------------------------- #
    def log_metric(self, key: str, value: float, step: int) -> None:
        self._post_safe("runs/log-metric", {
            "run_id": self._run_id, "key": key, "value": float(value),
            "timestamp": int(time.time() * 1000), "step": int(step),
        })

    def log_params(self, params: Dict[str, Any]) -> None:
        self._post_safe("runs/log-batch", {
            "run_id": self._run_id,
            "params": [{"key": k, "value": str(v)[:500]}
                       for k, v in params.items()],
        })

    def close(self) -> None:
        self._post_safe("runs/update", {
            "run_id": self._run_id, "status": "FINISHED",
            "end_time": int(time.time() * 1000),
        })
