"""Parameter interop between the JAX package's flax trees and the port.

A JAX plan's parameters are one flax tree per stage,
``{"params": {layer: {"kernel": ..., "bias": ...}}}``, NHWC-minded: conv
kernels HWIO, dense kernels ``[in, out]``. The port keeps one
``{name: tensor}`` dict per stage with PyTorch's layouts: conv weights
OIHW, linear weights ``[out, in]``. The mapping:

- conv kernel HWIO -> ``<layer>.weight`` OIHW (``transpose(3, 2, 0, 1)``);
- dense kernel -> ``<layer>.weight``, transposed;
- bias -> ``<layer>.bias`` as is.

The CNN's stage B flattens in NHWC order in both packages, so the dense
kernel needs no row remap. Both directions only transpose, so a round
trip is bit-exact. This covers every CNN plan (split, u_split, chain3).
Arrays cross as numpy, so neither side imports the other framework.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params


def _kernel_to_weight(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:   # HWIO -> OIHW
        return k.transpose(3, 2, 0, 1)
    if k.ndim == 2:   # [in, out] -> [out, in]
        return k.T
    raise ValueError(f"unsupported kernel rank {k.ndim}")


def _weight_to_kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:   # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0)
    if w.ndim == 2:
        return w.T
    raise ValueError(f"unsupported weight rank {w.ndim}")


def stage_from_jax(tree: Mapping[str, Any]) -> Params:
    """One stage's flax tree -> the port's ``{name: tensor}`` dict."""
    out: Params = {}
    for layer, leaves in tree["params"].items():
        for leaf, value in leaves.items():
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                out[f"{layer}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(_kernel_to_weight(arr)))
            elif leaf == "bias":
                out[f"{layer}.bias"] = torch.from_numpy(arr.copy())
            else:
                raise ValueError(f"unexpected flax leaf {layer}/{leaf}")
    return out


def stage_to_jax(params: Params) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """One stage's ``{name: tensor}`` dict -> a flax tree of numpy arrays."""
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        layer, _, kind = name.rpartition(".")
        arr = t.detach().cpu().numpy()
        if kind == "weight":
            layers.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                _weight_to_kernel(arr))
        elif kind == "bias":
            layers.setdefault(layer, {})["bias"] = arr.copy()
        else:
            raise ValueError(f"unexpected parameter name {name!r}")
    return {"params": layers}


def params_from_jax(flax_params: Sequence[Mapping[str, Any]]
                    ) -> Tuple[Params, ...]:
    """Per-stage flax trees (numpy or array-likes) -> per-stage dicts."""
    return tuple(stage_from_jax(t) for t in flax_params)


def params_to_jax(params: Sequence[Params]) -> Tuple[Dict[str, Any], ...]:
    """Per-stage dicts -> per-stage flax trees of numpy arrays."""
    return tuple(stage_to_jax(p) for p in params)
