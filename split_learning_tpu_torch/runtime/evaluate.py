"""Test-split evaluation (counterpart of ``split_learning_tpu/runtime/evaluate.py``).

Accuracy and mean CE of a plan's full composition, with the JAX
package's accounting: fixed order, the partial tail batch kept, every
label element counted once, perplexity exp(mean CE) nulled on overflow.
Runs on the device the parameters lie on, with plain PyTorch ops.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.core.losses import cross_entropy
from split_learning_tpu_torch.core.stage import Params, SplitPlan
from split_learning_tpu_torch.data.datasets import Split, batches


def _accumulate_metrics(split: Split, batch_size: int,
                        score_batch: Callable[[Any, Any], Tuple[Any, Any]]
                        ) -> Dict[str, float]:
    """``score_batch(x, y) -> (loss, correct)`` per batch, reduced."""
    total = rows = correct_sum = 0
    loss_sum = 0.0
    for x, y in batches(split, batch_size, shuffle=False):
        loss, correct = score_batch(x, y)
        n = int(np.prod(np.shape(y)))
        total += n
        rows += len(y)
        correct_sum += int(correct)
        loss_sum += float(loss) * n
    if total == 0:
        return {"accuracy": float("nan"), "loss": float("nan"),
                "perplexity": float("nan"), "examples": 0, "predictions": 0}
    mean_loss = loss_sum / total
    with np.errstate(over="ignore"):
        ppl = float(np.exp(mean_loss))
    return {"accuracy": correct_sum / total, "loss": mean_loss,
            "perplexity": ppl if np.isfinite(ppl) else None,
            "examples": rows, "predictions": total}


def evaluate(plan: SplitPlan, params: Sequence[Params], split: Split,
             batch_size: int = 512) -> Dict[str, float]:
    """Accuracy and mean CE loss of ``plan.apply(params, .)`` on a split."""
    params = list(params)
    device = next(iter(params[0].values())).device

    @torch.no_grad()
    def score(x, y):
        x = torch.as_tensor(x).to(device, torch.float32)
        y = torch.as_tensor(y).to(device, torch.int64)
        logits = plan.apply(params, x)
        return (cross_entropy(logits, y).item(),
                (logits.argmax(dim=-1) == y).sum().item())

    return _accumulate_metrics(split, batch_size, score)
