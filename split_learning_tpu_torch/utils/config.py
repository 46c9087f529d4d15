"""Single-source configuration (counterpart of ``split_learning_tpu/utils/config.py``).

One frozen dataclass built from defaults < environment < explicit
kwargs, with the same fields, environment names and validation as the
JAX ``Config``, less ``kernels``: in the port the tensor's device picks
the kernel or its plain version, so there is no backend knob.

Some values validate here but no trainer of the port runs them yet;
:func:`split_learning_tpu_torch.runtime.fused.check_supported` rejects
those with the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

_ENV_MAP = {
    # reference-compatible env names
    "mode": "LEARNING_MODE",
    "s3_endpoint": "S3_ENDPOINT_URL",
    "s3_access_key": "AWS_ACCESS_KEY_ID",
    "s3_secret_key": "AWS_SECRET_ACCESS_KEY",
    "tracking_uri": "MLFLOW_TRACKING_URI",
    # the JAX package's surface (the same names; the port adds none)
    "server_url": "SLT_SERVER_URL",
    "transport": "SLT_TRANSPORT",
    "model": "SLT_MODEL",
    "dataset": "SLT_DATASET",
    "batch_size": "SLT_BATCH_SIZE",
    "epochs": "SLT_EPOCHS",
    "lr": "SLT_LR",
    "momentum": "SLT_MOMENTUM",
    "optimizer": "SLT_OPTIMIZER",
    "weight_decay": "SLT_WEIGHT_DECAY",
    "warmup_steps": "SLT_WARMUP_STEPS",
    "decay_steps": "SLT_DECAY_STEPS",
    "grad_clip_norm": "SLT_GRAD_CLIP_NORM",
    "seed": "SLT_SEED",
    "dtype": "SLT_DTYPE",
    "num_clients": "SLT_NUM_CLIENTS",
    "num_stages": "SLT_NUM_STAGES",
    "microbatches": "SLT_MICROBATCHES",
    "schedule": "SLT_SCHEDULE",
    "remat": "SLT_REMAT",
    "model_parallel": "SLT_MODEL_PARALLEL",
    "seq_parallel": "SLT_SEQ_PARALLEL",
    "attn": "SLT_ATTN",
    "data_dir": "SLT_DATA_DIR",
    "checkpoint_dir": "SLT_CHECKPOINT_DIR",
    "tracking": "SLT_TRACKING",
}


@dataclasses.dataclass(frozen=True)
class Config:
    """Full configuration surface (the JAX ``Config`` without ``kernels``)."""

    # learning mode: "split" | "federated" | "u_split"
    mode: str = "split"
    model: str = "split_cnn"
    dataset: str = "mnist"
    # transport: the port runs "fused" only so far
    transport: str = "local"
    server_url: str = "http://127.0.0.1:8000"

    # hyperparameters (reference defaults: lr 0.01, batch 64, 3 epochs)
    batch_size: int = 64
    epochs: int = 3
    lr: float = 0.01
    momentum: float = 0.0
    optimizer: str = "sgd"
    weight_decay: float = 0.0
    warmup_steps: int = 0
    decay_steps: int = 0
    grad_clip_norm: float = 0.0
    seed: int = 0
    dtype: str = "float32"

    # parallelism
    num_clients: int = 1
    num_stages: int = 2
    model_parallel: int = 1
    seq_parallel: int = 1
    attn: str = "full"
    microbatches: int = 1
    schedule: str = "gpipe"
    remat: bool = False

    # storage / tracking
    data_dir: str = os.path.expanduser("~/.cache/split_learning_tpu")
    checkpoint_dir: Optional[str] = None
    tracking: str = "stdout"  # "stdout" | "jsonl" | "noop"
    tracking_uri: Optional[str] = None
    s3_endpoint: Optional[str] = None
    s3_access_key: Optional[str] = None
    s3_secret_key: Optional[str] = None
    s3_bucket: str = "mlops-bucket"

    def __post_init__(self) -> None:
        self.validate()

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **overrides: Any) -> "Config":
        """defaults < environment < explicit overrides."""
        env = dict(os.environ if env is None else env)
        kw: dict[str, Any] = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for field_name, env_name in _ENV_MAP.items():
            if env_name in env and env[env_name] != "":
                raw = env[env_name]
                ftype = fields[field_name].type
                if ftype in ("int", int):
                    kw[field_name] = int(raw)
                elif ftype in ("float", float):
                    kw[field_name] = float(raw)
                elif ftype in ("bool", bool):
                    kw[field_name] = raw.strip().lower() in ("1", "true", "yes")
                else:
                    kw[field_name] = raw
        kw.update(overrides)
        return cls(**kw)

    def validate(self) -> None:
        if self.mode not in ("split", "federated", "u_split"):
            raise ValueError(
                f"Unknown learning mode: {self.mode!r} "
                "(expected 'split', 'federated' or 'u_split')"
            )
        if self.batch_size <= 0 or self.epochs <= 0:
            raise ValueError("batch_size and epochs must be positive")
        if self.microbatches <= 0:
            raise ValueError("microbatches must be positive")
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"Unknown pipeline schedule: {self.schedule!r} "
                "(expected 'gpipe' or '1f1b')")
        if self.batch_size % self.microbatches != 0:
            raise ValueError("batch_size must be divisible by microbatches")
        if self.seq_parallel <= 0:
            raise ValueError("seq_parallel must be positive")
        if self.optimizer not in ("sgd", "adam", "adamw"):
            raise ValueError(
                f"Unknown optimizer: {self.optimizer!r} "
                "(expected 'sgd', 'adam' or 'adamw')")
        if self.weight_decay < 0 or self.warmup_steps < 0 \
                or self.decay_steps < 0 or self.grad_clip_norm < 0:
            raise ValueError("weight_decay / warmup_steps / decay_steps / "
                             "grad_clip_norm must be non-negative")
        if self.weight_decay and self.optimizer == "adam":
            raise ValueError(
                "weight_decay with adam silently L2-couples into the "
                "moments; use optimizer='adamw' (decoupled) instead")
        if self.momentum and self.optimizer != "sgd":
            raise ValueError(
                f"momentum is an SGD hyperparameter; {self.optimizer!r} "
                "has its own moment estimates and would silently ignore "
                "it")
        if self.decay_steps and self.decay_steps <= self.warmup_steps:
            raise ValueError("decay_steps counts total steps incl. "
                             "warmup and must exceed warmup_steps")
        if self.attn not in ("full", "flash", "auto", "ring",
                             "ring_flash", "ulysses"):
            raise ValueError(
                f"Unknown attn impl: {self.attn!r} "
                "(expected 'full', 'flash', 'auto', 'ring', "
                "'ring_flash' or 'ulysses')")
