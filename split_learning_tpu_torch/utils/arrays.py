"""Host arrays across the framework boundary, bfloat16 included.

numpy has no bfloat16 of its own. JAX hands one out as an ``ml_dtypes``
array, and ``ml_dtypes`` registers the type with numpy when it is
imported, which every process that runs JAX has done. The port imports
neither; it looks the type up by name:

- :func:`to_host` turns a tensor into a numpy array, a bfloat16 one into
  numpy's ``bfloat16`` where that type is registered (bit for bit), and
  into float32 (exact) where it is not;
- :func:`from_host` turns a numpy array, an ``ml_dtypes`` bfloat16 one
  included, into a CPU tensor of the same dtype, bit for bit;
- :func:`host_tree` applies :func:`to_host` to every tensor of a tree
  of dicts and lists.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def numpy_bfloat16() -> Optional[np.dtype]:
    """numpy's ``bfloat16`` dtype where ``ml_dtypes`` has registered it,
    else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of its dtype (see the module)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bf16 = numpy_bfloat16()
    if bf16 is None:
        return t.float().numpy()
    return t.contiguous().view(torch.int16).numpy().view(bf16)


def from_host(a: Any) -> torch.Tensor:
    """A numpy array (or array-like, or tensor) as a CPU tensor that owns
    its memory; a bfloat16 array keeps its bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.tensor(arr)


def host_tree(obj: Any) -> Any:
    """Every tensor of a tree of dicts and lists as a host numpy array."""
    if isinstance(obj, torch.Tensor):
        return to_host(obj)
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [host_tree(v) for v in obj]
    return obj
