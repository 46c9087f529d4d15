"""Parameter interop between the JAX package's flax trees and the port.

A JAX plan's parameters are one flax tree per stage,
``{"params": {...}}``, nested by module path (``block0/mha/q/kernel``,
``trunk/block1/ln2/scale``, ``head/lm_head/kernel``; the CNN's
``conv1/kernel``), NHWC-minded: conv kernels HWIO, dense kernels
``[in, out]``. The port keeps one ``{name: tensor}`` dict per stage
whose names are the same paths joined by dots, with PyTorch's layouts.
The mapping of the leaf:

- conv ``kernel`` HWIO -> ``weight`` OIHW (``transpose(3, 2, 0, 1)``);
- dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]``;
- ``bias`` -> ``bias`` as is;
- LayerNorm ``scale`` -> ``weight`` as is;
- ``embedding`` ``[vocab, dim]`` -> ``weight`` as is, not transposed (the
  layers named in :data:`models.transformer.EMBED_LAYERS`);
- the transformer's raw ``pos`` table stays ``pos``.

The parties of the two-party path (``runtime/server.py``,
``runtime/client.py``) take :func:`params_from_jax` of the whole plan's
JAX init and each keep their own stage, as the JAX parties keep theirs
from one PRNG key, so a mixed pair starts from identical parameters.

Both directions only transpose, so a round trip is bit-exact. Arrays
cross as numpy, so neither side imports the other framework. Each leaf
keeps its dtype in both directions: a bfloat16 leaf (``pos`` in a bf16
tree) reaches numpy as an ``ml_dtypes`` array, which the port does not
import; it is read as float32 (exact) and cast back to
``torch.bfloat16``, and it goes back to JAX as numpy's ``bfloat16``
with the same bits (:func:`split_learning_tpu_torch.utils.arrays.to_host`;
as float32 in a process that has no ``ml_dtypes`` loaded).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params
from split_learning_tpu_torch.models.transformer import EMBED_LAYERS
from split_learning_tpu_torch.utils.arrays import to_host

_RAW_LEAVES = ("pos",)


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


def _leaf_to_torch(value: Any, transform=None) -> torch.Tensor:
    arr = np.asarray(value)
    bf16 = arr.dtype.name == "bfloat16"
    arr = arr.astype(np.float32)   # a copy: the tensor owns its memory
    if transform is not None:
        arr = transform(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(torch.bfloat16) if bf16 else t


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...], out: Params
          ) -> None:
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            _walk(value, path, out)
            continue
        name = ".".join(prefix)
        if key == "kernel":
            out[f"{name}.weight"] = _leaf_to_torch(value, _kernel_to_weight)
        elif key in ("bias", "scale", "embedding"):
            kind = "bias" if key == "bias" else "weight"
            out[f"{name}.{kind}"] = _leaf_to_torch(value)
        elif key in _RAW_LEAVES:
            out[".".join(path)] = _leaf_to_torch(value)
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")


def stage_from_jax(tree: Mapping[str, Any]) -> Params:
    """One stage's flax tree -> the port's ``{name: tensor}`` dict."""
    out: Params = {}
    _walk(tree["params"], (), out)
    return out


def stage_to_jax(params: Params) -> Dict[str, Dict[str, Any]]:
    """One stage's ``{name: tensor}`` dict -> a flax tree of numpy arrays
    of the leaves' dtypes."""
    root: Dict[str, Any] = {}
    for name, t in params.items():
        *path, kind = name.split(".")
        arr = to_host(t).copy()
        if kind in ("bias",) + _RAW_LEAVES:
            leaf = kind
        elif kind != "weight":
            raise ValueError(f"unexpected parameter name {name!r}")
        elif arr.ndim == 1:
            leaf = "scale"
        elif arr.ndim == 2 and path and path[-1] in EMBED_LAYERS:
            leaf = "embedding"
        else:
            leaf, arr = "kernel", np.ascontiguousarray(_weight_to_kernel(arr))
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return {"params": root}


def params_from_jax(flax_params: Sequence[Mapping[str, Any]]
                    ) -> Tuple[Params, ...]:
    """Per-stage flax trees (numpy or array-likes) -> per-stage dicts."""
    return tuple(stage_from_jax(t) for t in flax_params)


def params_to_jax(params: Sequence[Params]) -> Tuple[Dict[str, Any], ...]:
    """Per-stage dicts -> per-stage flax trees of numpy arrays."""
    return tuple(stage_to_jax(p) for p in params)
