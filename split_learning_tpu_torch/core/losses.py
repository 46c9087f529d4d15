"""Loss functions (counterpart of ``split_learning_tpu/core/losses.py``).

Mean softmax cross-entropy over integer labels, as the reference's
``nn.CrossEntropyLoss``. As optax does, the class axis is the last one
and every leading axis is a batch axis: the causal LM's ``[B, T, V]``
logits take ``[B, T]`` labels. These are plain PyTorch; they are also the
versions that :func:`split_learning_tpu_torch.ops.fused_cross_entropy`
runs for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_example_cross_entropy(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Unreduced CE over the last axis (shape of ``labels``), in float32."""
    flat = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1), reduction="none")
    return flat.reshape(labels.shape)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32."""
    return per_example_cross_entropy(logits, labels).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
