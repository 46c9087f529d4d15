"""Model factory (counterpart of ``split_learning_tpu/models/factory.py``).

Same role+mode dispatch and the same ``ValueError`` contract: an unknown
mode, model family or role, size overrides on the fixed reference CNN,
and a chain plan outside split mode all raise ``ValueError``. The
families the port has not reached yet are registered by name and raise
``NotImplementedError``.

Dtypes: every family takes float32 and bfloat16, flax's mixed precision
(float32 parameters, bfloat16 compute: :mod:`models.transformer`,
:mod:`models.cnn`); another dtype raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from split_learning_tpu_torch.core.stage import SplitPlan
from split_learning_tpu_torch.models.cnn import (
    chain3_cnn_plan, split_cnn_plan, u_split_cnn_plan)
from split_learning_tpu_torch.models.transformer import transformer_plan

_FAMILIES: Dict[str, Callable[..., SplitPlan]] = {}


def register_model(name: str):
    def deco(fn):
        _FAMILIES[name] = fn
        return fn
    return deco


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@register_model("split_cnn")
def _split_cnn(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
    if kw:
        raise ValueError(f"split_cnn is the fixed reference architecture; "
                         f"it takes no size overrides (got {sorted(kw)})")
    if mode == "u_split":
        return u_split_cnn_plan(dtype)
    # split and federated share the 2-stage plan (federated trains the
    # composition)
    return split_cnn_plan(dtype)


@register_model("split_cnn_chain3")
def _split_cnn_chain3(mode: str, dtype: torch.dtype, **kw: Any
                      ) -> SplitPlan:
    if kw:
        raise ValueError(f"split_cnn_chain3 is the fixed reference "
                         f"architecture re-cut; it takes no size "
                         f"overrides (got {sorted(kw)})")
    if mode != "split":
        raise ValueError("split_cnn_chain3 is a pipeline chain plan; "
                         "use mode='split'")
    return chain3_cnn_plan(dtype)


@register_model("transformer")
def _transformer(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
    """Classifier over token sequences (dense attention by default)."""
    return transformer_plan(mode=mode, dtype=dtype, **kw)


@register_model("transformer_lm")
def _transformer_lm(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
    """Causal language model: causal attention + per-token head."""
    return transformer_plan(mode=mode, dtype=dtype, lm=True, **kw)


def _not_ported(name: str) -> Callable[..., SplitPlan]:
    def build(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
        raise NotImplementedError(
            f"model family {name!r} is not ported to PyTorch yet "
            "(ROADMAP item 20)")
    return build


for _name in ("resnet18", "resnet18_4stage", "vit"):
    register_model(_name)(_not_ported(_name))


def _dtype_of(dtype: Any) -> torch.dtype:
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {dtype!r}: the port runs float32 and bfloat16 only "
            "(ROADMAP item 14)")
    return _DTYPES[name]


def get_plan(model: str = "split_cnn", mode: str = "split",
             dtype: Any = "float32", **size_kw: Any) -> SplitPlan:
    """Build the SplitPlan for a model family under a learning mode.

    ``size_kw`` (d_model, num_heads, client_depth, server_depth, vocab,
    max_len, attn, ...) forwards to the transformer plan builder; the
    fixed reference CNN rejects it with a ``ValueError``."""
    if mode not in ("split", "federated", "u_split"):
        raise ValueError(f"Unknown learning mode: {mode!r}")
    if model not in _FAMILIES:
        raise ValueError(
            f"Unknown model family: {model!r} (have {sorted(_FAMILIES)})")
    return _FAMILIES[model](mode, _dtype_of(dtype), **size_kw)


def get_model(role: str, mode: str = "split", model: str = "split_cnn",
              dtype: Any = "float32") -> Tuple[SplitPlan, Tuple[int, ...]]:
    """(plan, indices of the stages ``role`` owns); federated owns all."""
    if role not in ("client", "server"):
        raise ValueError(f"Unknown role: {role!r}")
    plan = get_plan(model=model, mode=mode, dtype=dtype)
    if mode == "federated":
        return plan, tuple(range(plan.num_stages))
    return plan, plan.stages_of(role)
