"""Device resolution and the port's numerics policy.

Counterpart of ``split_learning_tpu/utils/backend.py``; that module's
JAX plugin hygiene has no PyTorch analog. What is here:

- :func:`resolve_device`: the one place an entry point turns its
  ``device`` argument into a ``torch.device``. ``"cuda"`` without a GPU
  raises; nothing falls back to the CPU.
- :func:`set_numerics_policy`: float32 everywhere, in full precision.
  cuDNN convolutions default to TF32 on the card (about three decimal
  digits), so ``cudnn.allow_tf32`` is turned off, and matmuls run at
  ``"highest"`` precision. That is what the JAX CPU reference computes,
  so the tests compare like with like; relaxing it is a performance
  decision for later.
- :func:`gpu_name_and_power_limit`: the ``nvidia-smi`` line that every
  reported time stands beside.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def set_numerics_policy() -> None:
    """Full-f32 convolutions and matmuls (process-wide torch flags)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``, after checking it exists.

    Only ``cuda`` and ``cpu`` are accepted. Asking for CUDA on a machine
    without a GPU raises ``RuntimeError``: the CPU is reached only by
    asking for it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    set_numerics_policy()
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip()
