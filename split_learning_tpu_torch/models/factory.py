"""Model factory (counterpart of ``split_learning_tpu/models/factory.py``).

Same role+mode dispatch and the same ``ValueError`` contract: an unknown
mode, model family or role, size overrides on the fixed reference CNN,
and a chain plan outside split mode all raise ``ValueError``. The
families the port has not reached yet are registered by name and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from split_learning_tpu_torch.core.stage import SplitPlan
from split_learning_tpu_torch.models.cnn import (
    chain3_cnn_plan, split_cnn_plan, u_split_cnn_plan)

_FAMILIES: Dict[str, Callable[..., SplitPlan]] = {}


def register_model(name: str):
    def deco(fn):
        _FAMILIES[name] = fn
        return fn
    return deco


@register_model("split_cnn")
def _split_cnn(mode: str, **kw: Any) -> SplitPlan:
    if kw:
        raise ValueError(f"split_cnn is the fixed reference architecture; "
                         f"it takes no size overrides (got {sorted(kw)})")
    if mode == "u_split":
        return u_split_cnn_plan()
    # split and federated share the 2-stage plan (federated trains the
    # composition)
    return split_cnn_plan()


@register_model("split_cnn_chain3")
def _split_cnn_chain3(mode: str, **kw: Any) -> SplitPlan:
    if kw:
        raise ValueError(f"split_cnn_chain3 is the fixed reference "
                         f"architecture re-cut; it takes no size "
                         f"overrides (got {sorted(kw)})")
    if mode != "split":
        raise ValueError("split_cnn_chain3 is a pipeline chain plan; "
                         "use mode='split'")
    return chain3_cnn_plan()


def _not_ported(name: str) -> Callable[..., SplitPlan]:
    def build(mode: str, **kw: Any) -> SplitPlan:
        raise NotImplementedError(
            f"model family {name!r} is not ported to PyTorch yet "
            "(ROADMAP item 20)")
    return build


for _name in ("resnet18", "resnet18_4stage", "vit", "transformer",
              "transformer_lm"):
    register_model(_name)(_not_ported(_name))


def get_plan(model: str = "split_cnn", mode: str = "split",
             dtype: str = "float32", **size_kw: Any) -> SplitPlan:
    """Build the SplitPlan for a model family under a learning mode.

    Only float32 is ported; other dtypes raise ``NotImplementedError``."""
    if mode not in ("split", "federated", "u_split"):
        raise ValueError(f"Unknown learning mode: {mode!r}")
    if model not in _FAMILIES:
        raise ValueError(
            f"Unknown model family: {model!r} (have {sorted(_FAMILIES)})")
    if str(dtype).replace("torch.", "") != "float32":
        raise NotImplementedError(
            f"dtype {dtype!r}: the port runs float32 only so far "
            "(ROADMAP item 14)")
    return _FAMILIES[model](mode, **size_kw)


def get_model(role: str, mode: str = "split", model: str = "split_cnn",
              dtype: str = "float32") -> Tuple[SplitPlan, Tuple[int, ...]]:
    """(plan, indices of the stages ``role`` owns); federated owns all."""
    if role not in ("client", "server"):
        raise ValueError(f"Unknown role: {role!r}")
    plan = get_plan(model=model, mode=mode, dtype=dtype)
    if mode == "federated":
        return plan, tuple(range(plan.num_stages))
    return plan, plan.stages_of(role)
