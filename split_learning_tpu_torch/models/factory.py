"""Model factory (counterpart of ``split_learning_tpu/models/factory.py``).

Same role+mode dispatch and the same ``ValueError`` contract: an unknown
mode, model family or role, size overrides on the fixed reference CNN
or ResNet-18, and a chain or pipeline plan (``split_cnn_chain3``,
``resnet18_4stage``) outside split mode all raise ``ValueError``.

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
from split_learning_tpu_torch.models.resnet import resnet18_plan
from split_learning_tpu_torch.models.transformer import transformer_plan
from split_learning_tpu_torch.models.vit import vit_plan

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


@register_model("resnet18")
def _resnet18(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
    if kw:
        raise ValueError(f"resnet18 takes no size overrides "
                         f"(got {sorted(kw)})")
    return resnet18_plan(mode=mode, dtype=dtype)


@register_model("resnet18_4stage")
def _resnet18_4stage(mode: str, dtype: torch.dtype, **kw: Any
                     ) -> SplitPlan:
    """The 4-stage pipeline cut (BASELINE config 4)."""
    if kw:
        raise ValueError(f"resnet18_4stage takes no size overrides "
                         f"(got {sorted(kw)})")
    if mode != "split":
        raise ValueError("resnet18_4stage is a pipeline plan; use "
                         "mode='split'")
    return resnet18_plan(mode=mode, dtype=dtype, stages=4)


@register_model("vit")
def _vit(mode: str, dtype: torch.dtype, **kw: Any) -> SplitPlan:
    """Vision transformer on the image datasets: a patchify stem and the
    transformer classifier's trunk and head."""
    return vit_plan(mode=mode, dtype=dtype, **kw)


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
    max_len, attn, ...) forwards to the transformer and ViT plan
    builders; the fixed reference CNN and ResNet-18 reject it with a
    ``ValueError``."""
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
