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
  of dicts, lists and tuples, in one copy per device and dtype;
- :func:`tree_map` and :func:`tree_leaves` walk such trees, as
  ``jax.tree_util`` walks JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

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


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``: dicts matched by key (in ``tree``'s key order), lists and
    tuples by position; anything else is a leaf."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("parameter trees differ in their keys")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError("parameter trees differ in their length")
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def host_tree(obj: Any) -> Any:
    """Every tensor of a tree of dicts, lists and tuples as a host numpy
    array. The tensors on a card go to the host in one copy per device
    and dtype: flattened into one buffer there, copied once and split
    into views of it (a FedAvg reply is tens of leaves)."""
    leaves = tree_leaves(obj)
    out = list(leaves)
    groups: Dict[Tuple[torch.device, torch.dtype], List[int]] = {}
    for i, t in enumerate(leaves):
        if isinstance(t, torch.Tensor):
            if t.device.type == "cpu":
                out[i] = to_host(t)
            else:
                groups.setdefault((t.device, t.dtype), []).append(i)
    for idx in groups.values():
        if len(idx) == 1:
            out[idx[0]] = to_host(leaves[idx[0]])
            continue
        flat = to_host(torch.cat([leaves[i].detach().reshape(-1)
                                  for i in idx]))
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(tuple(leaves[i].shape))
            off += n
    it = iter(out)
    return tree_map(lambda _: next(it), obj)
