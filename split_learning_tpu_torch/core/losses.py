"""Loss functions (counterpart of ``split_learning_tpu/core/losses.py``).

Mean softmax cross-entropy over integer labels, as the reference's
``nn.CrossEntropyLoss``. These are plain PyTorch; they are also the
versions that :func:`split_learning_tpu_torch.ops.fused_cross_entropy`
runs for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_example_cross_entropy(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Unreduced ``[batch]`` CE, computed in float32."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32."""
    return per_example_cross_entropy(logits, labels).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
