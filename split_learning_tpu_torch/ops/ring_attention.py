"""Dense attention and the sequence-parallel forms
(counterpart of ``split_learning_tpu/ops/ring_attention.py``).

:func:`full_attention` is the JAX package's single-device reference
semantics in plain PyTorch, computed in the input dtype as there. The
ring and Ulysses forms shard the sequence over devices; they come with
context parallelism (ROADMAP item 21) and raise until then.
"""

from __future__ import annotations

import torch

from split_learning_tpu_torch.ops.common import NEG_BIG


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Plain dense softmax attention, ``[B, T, H, D] -> [B, T, H, D]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _not_ported(name: str):
    def attention(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (context parallelism over a device mesh) is not ported "
            "yet (ROADMAP item 21)")
    attention.__name__ = name
    return attention


ring_attention = _not_ported("ring_attention")
ulysses_attention = _not_ported("ulysses_attention")
