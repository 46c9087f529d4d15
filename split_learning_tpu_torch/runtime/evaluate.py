"""Test-split evaluation (counterpart of ``split_learning_tpu/runtime/evaluate.py``).

Accuracy and mean CE of a plan's full composition (:func:`evaluate`) or
of the split-party composition, the server's stages behind
``transport.predict`` (:func:`evaluate_remote`), with the JAX package's
accounting: fixed order, the partial tail batch kept, every
label element counted once (B for classifiers, B*T for the causal LM),
perplexity exp(mean CE) nulled on overflow. Runs on the device the
parameters lie on; the plan's own kernels (flash attention) run there
too. Floating inputs are cast to float32; integer token ids pass as
they are, as JAX's ``evaluate`` passes ``x``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.core.losses import cross_entropy
from split_learning_tpu_torch.core.stage import Params, SplitPlan, Stage
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
        x = torch.as_tensor(x).to(device)
        if x.is_floating_point():
            x = x.float()
        y = torch.as_tensor(y).to(device, torch.int64)
        logits = plan.apply(params, x)
        return (cross_entropy(logits, y).item(),
                (logits.argmax(dim=-1) == y).sum().item())

    return _accumulate_metrics(split, batch_size, score)


def split_client_stages(plan: SplitPlan, client_params: Sequence[Params]
                        ) -> Tuple[List[Stage], List[Params], List[Stage],
                                   List[Params]]:
    """Partition the client-owned stages (and their params) around the
    server stage: ``(pre_stages, pre_params, post_stages, post_params)``,
    the ownership rule that split-party evaluation and decoding share.
    Raises ``ValueError`` on a params/ownership mismatch or a plan with
    no server stage."""
    client_idx = plan.stages_of("client")
    if len(client_params) != len(client_idx):
        raise ValueError(
            f"expected params for {len(client_idx)} client-owned stages, "
            f"got {len(client_params)}")
    server_idx = plan.stages_of("server")
    if not server_idx:
        raise ValueError("plan has no server-owned stage to call remotely")
    first_server = min(server_idx)
    client_params = list(client_params)
    pre_stages = [plan.stages[i] for i in client_idx if i < first_server]
    post_stages = [plan.stages[i] for i in client_idx if i > first_server]
    return (pre_stages, client_params[:len(pre_stages)],
            post_stages, client_params[len(pre_stages):])


def evaluate_remote(plan: SplitPlan, client_params: Sequence[Params],
                    transport: Any, split: Split,
                    batch_size: int = 512) -> Dict[str, float]:
    """Split-party inference: the client holds only its own stages, and
    the server-owned compute runs behind ``transport.predict``.

    ``client_params`` are the client-owned stages' parameters in plan
    order. The client stages run on their parameters' device, without
    autograd; ``transport.predict`` receives the cut tensor itself, so a
    compressed wire encodes it where it lives (on the card, K3 or the
    topk8 select launches), and the post-stages and the score run on
    the reply. Labels never leave the client. The metrics equal
    :func:`evaluate` of the full composition to float tolerance."""
    pre_stages, pre_params, post_stages, post_params = \
        split_client_stages(plan, client_params)
    leaves = [t for p in client_params for t in p.values()]
    device = leaves[0].device if leaves else torch.device("cpu")

    @torch.no_grad()
    def score(x, y):
        x = torch.as_tensor(x).to(device)
        if x.is_floating_point():
            x = x.float()
        for st, p in zip(pre_stages, pre_params):
            x = st.apply(p, x)
        out = transport.predict(x)
        logits = torch.as_tensor(out).to(device)
        for st, p in zip(post_stages, post_params):
            logits = st.apply(p, logits)
        y = torch.as_tensor(y).to(device, torch.int64)
        return (cross_entropy(logits, y).item(),
                (logits.argmax(dim=-1) == y).sum().item())

    return _accumulate_metrics(split, batch_size, score)
