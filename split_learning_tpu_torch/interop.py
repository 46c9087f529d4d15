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
cross as numpy, so neither side imports the other framework; a flax
tree whose leaves are tensors (a federated server's average on the
card) converts on their device. :func:`stage_to_jax` orders every dict's
keys as ``jax.tree_util`` does, so the FedAvg frame of a port client is
byte-equal to a JAX client's. Each leaf
keeps its dtype in both directions: a bfloat16 leaf (``pos`` in a bf16
tree) reaches numpy as an ``ml_dtypes`` array, which the port does not
import; it is read as float32 (exact) and cast back to
``torch.bfloat16``, and it goes back to JAX as numpy's ``bfloat16``
with the same bits (:func:`split_learning_tpu_torch.utils.arrays.to_host`;
as float32 in a process that has no ``ml_dtypes`` loaded).

A training state crosses too, optimizer and schedule included:
:func:`train_state_from_jax` takes the numpy tree JAX's
``Checkpointer.restore_raw`` gives for a ``TrainState`` (``{'params',
'opt_state', 'step'}``, optax's chain as nested lists with ``None`` for
its empty states) and returns the port's checkpoint form of a state
(``runtime/state.py`` ``state_tree``, which ``restore_state`` loads);
optax's ``TraceState`` becomes the momentum trace (float32, the SGD
kernel's), ``ScaleByAdamState`` the moments, and each count must equal
the step. :func:`train_state_to_jax` goes back, building the chain
JAX's ``make_tx`` builds for the Config. Moments take the parameters'
transposes. This is how a run trained on a TPU continues on the card,
and the reverse.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from split_learning_tpu_torch.core.stage import Params
from split_learning_tpu_torch.models.transformer import EMBED_LAYERS
from split_learning_tpu_torch.utils.arrays import to_host

_RAW_LEAVES = ("pos",)


# a kernel's transposes, by rank: torch dim i of a weight is dim
# _KERNEL_TO_WEIGHT[ndim][i] of the flax kernel, and flax dim j of a
# kernel is dim _WEIGHT_TO_KERNEL[ndim][j] of the weight
_KERNEL_TO_WEIGHT = {4: (3, 2, 0, 1),   # HWIO -> OIHW
                     2: (1, 0)}         # [in, out] -> [out, in]
_WEIGHT_TO_KERNEL = {4: (2, 3, 1, 0),   # OIHW -> HWIO
                     2: (1, 0)}


def _kernel_to_weight(k: Any) -> Any:
    if k.ndim not in _KERNEL_TO_WEIGHT:
        raise ValueError(f"unsupported kernel rank {k.ndim}")
    perm = _KERNEL_TO_WEIGHT[k.ndim]
    return (k.permute(*perm) if isinstance(k, torch.Tensor)
            else k.transpose(*perm))


def _weight_to_kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim not in _WEIGHT_TO_KERNEL:
        raise ValueError(f"unsupported weight rank {w.ndim}")
    return w.transpose(*_WEIGHT_TO_KERNEL[w.ndim])


def is_kernel(name: str, ndim: int) -> bool:
    """Whether the port's leaf ``name`` of rank ``ndim`` is a flax
    ``kernel`` (transposed on the way across): a conv or dense
    ``weight``, not a LayerNorm scale, an embedding table or ``pos``."""
    *path, kind = name.split(".")
    return (kind == "weight" and ndim in _WEIGHT_TO_KERNEL
            and not (ndim == 2 and path and path[-1] in EMBED_LAYERS))


def torch_dim(name: str, ndim: int, jax_dim: int) -> int:
    """The torch dim of the port's leaf ``name`` that holds dim
    ``jax_dim`` (negative counts from the end) of the same leaf in the
    JAX tree: the transposes above for a kernel, the identity for every
    other leaf."""
    j = jax_dim % ndim
    return _WEIGHT_TO_KERNEL[ndim][j] if is_kernel(name, ndim) else j


def _leaf_to_torch(value: Any, transform=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        # a tensor stays on its device and keeps its dtype
        t = value.detach()
        return (transform(t) if transform is not None else t).contiguous()
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
    return {"params": _sorted(root)}


def _sorted(node: Any) -> Any:
    """Keys in sorted order at every level: the order ``jax.tree_util``
    rebuilds a dict in, so a frame of this tree is byte-equal to JAX's
    ``tree_map(np.asarray, params)``."""
    if not isinstance(node, dict):
        return node
    return {k: _sorted(node[k]) for k in sorted(node)}


def params_from_jax(flax_params: Sequence[Mapping[str, Any]]
                    ) -> Tuple[Params, ...]:
    """Per-stage flax trees (numpy or array-likes) -> per-stage dicts."""
    return tuple(stage_from_jax(t) for t in flax_params)


def params_to_jax(params: Sequence[Params]) -> Tuple[Dict[str, Any], ...]:
    """Per-stage dicts -> per-stage flax trees of numpy arrays."""
    return tuple(stage_to_jax(p) for p in params)


# --------------------------------------------------------------------- #
# training state: params, optimizer state and step count
# --------------------------------------------------------------------- #
def _opt_pieces(node: Any, out: Dict[str, List[Any]]) -> None:
    """Collect optax's states from a raw chain: the momentum trace, the
    Adam moments and every count."""
    if node is None:
        return
    if hasattr(node, "_asdict"):  # a live optax NamedTuple
        node = node._asdict()
    if isinstance(node, Mapping):
        if not node:  # an optax EmptyState
            return
        if "trace" in node:
            out["trace"].append(node["trace"])
        elif "mu" in node and "nu" in node:
            out["adam"].append((node["mu"], node["nu"]))
            out["count"].append(node["count"])
        elif set(node) == {"count"}:
            out["count"].append(node["count"])
        else:
            raise ValueError(f"unexpected optimizer state keys {sorted(node)}")
        return
    if isinstance(node, (list, tuple)):
        for item in node:
            _opt_pieces(item, out)
        return
    raise ValueError(f"unexpected optimizer state leaf {type(node).__name__}")


def _stage_trees(node: Any) -> List[Any]:
    """A party's stages: JAX keeps a one-stage party's tree bare, a
    whole plan's as a sequence of trees."""
    return [node] if isinstance(node, Mapping) else list(node)


def train_state_from_jax(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX's raw ``TrainState`` tree (a whole plan's, or one party's
    single stage) -> the port's ``state_tree``."""
    params = [stage_from_jax(t) for t in _stage_trees(raw["params"])]
    step = int(np.asarray(raw["step"]))
    pieces: Dict[str, List[Any]] = {"trace": [], "adam": [], "count": []}
    _opt_pieces(raw["opt_state"], pieces)
    if len(pieces["trace"]) + len(pieces["adam"]) > 1:
        raise ValueError("more than one optimizer state in the chain")
    bad = [int(np.asarray(c)) for c in pieces["count"]
           if int(np.asarray(c)) != step]
    if bad:
        raise ValueError(f"optimizer counts {bad} differ from step {step}")

    def stages(trees: Any) -> List[Dict[str, torch.Tensor]]:
        return [stage_from_jax(t) for t in _stage_trees(trees)]

    if pieces["adam"]:
        mu, nu = pieces["adam"][0]
        opt: Any = {"mu": stages(mu), "nu": stages(nu)}
    elif pieces["trace"]:
        # the SGD kernel's trace is float32 for every leaf
        opt = {"trace": [{k: v.float() for k, v in st.items()}
                         for st in stages(pieces["trace"][0])]}
    else:
        opt = None
    return {"params": params, "opt_state": opt, "step": step}


def train_state_to_jax(tree: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """The port's ``state_tree`` -> JAX's raw ``TrainState`` tree for
    the optimizer ``cfg`` configures (``make_tx``'s chain: clipping and
    coupled L2 as empty states, the schedule's count). A momentum trace
    goes back in each parameter's dtype, as optax keeps it. A one-stage
    state (a party's) comes back as JAX's party keeps it: the bare tree,
    not a sequence."""
    step = np.asarray(int(tree["step"]), np.int32)

    def jax_stages(trees: List[Any]) -> Any:
        return trees[0] if len(trees) == 1 else trees

    params = jax_stages([stage_to_jax(p) for p in tree["params"]])
    opt = tree["opt_state"]
    sched = ({"count": step.copy()} if (cfg.warmup_steps or cfg.decay_steps)
             else None)

    def moments(stages: Sequence[Params]) -> Any:
        return jax_stages([
            stage_to_jax({k: v.to(p[k].dtype) for k, v in st.items()})
            for st, p in zip(stages, tree["params"])])

    if cfg.optimizer == "sgd":
        trace = ({"trace": moments(opt["trace"])} if cfg.momentum
                 else None)
        chain: Any = [trace, sched]
        if cfg.weight_decay:
            chain = [None, chain]
    else:
        adam = {"count": step.copy(), "mu": moments(opt["mu"]),
                "nu": moments(opt["nu"])}
        chain = ([adam, sched] if cfg.optimizer == "adam"
                 else [adam, None, sched])
    if cfg.grad_clip_norm:
        chain = [None, chain]
    return {"params": params, "opt_state": chain, "step": step}
