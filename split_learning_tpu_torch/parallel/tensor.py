"""Tensor parallelism over the ``model`` mesh axis: the port's own module.

JAX has no counterpart: its whole feature is the placement rule
(``parallel/mesh.py`` :func:`~.mesh.tp_leaf_sharding`) and GSPMD
partitions the programs from it. The port partitions the compute
itself, one op at a time, keeping PR 17's one-controller design: a
rank's tensors live on its device and every cross-rank move is an
autograd ``Function`` whose backward is the move's transpose
(:func:`gather` / :func:`scatter`, :func:`broadcast` / :func:`reduce_sum`).

A parameter leaf laid out on a mesh is a :class:`ShardedParam`: a
``grid[row][rank]`` of tensors, one per ``data`` row and ``model``
rank, each on its rank's device. A leaf the rule splits holds its
``shard_dim`` slice there; a replicated leaf a whole copy. The wrapper is
a tensor of the whole leaf's shape on the ``meta`` device, so the
models' modules take it through ``torch.func.functional_call`` like any
parameter, and ``__torch_function__`` routes what they do with it:

- a cast, ``detach``, ``clone``, ``requires_grad_`` or an index that
  leaves the split dim whole maps over the grid;
- ``F.linear`` and ``F.conv2d``, the embedding gather, ``F.layer_norm``
  and ``F.group_norm`` (on replicated scales), and the positional add
  run per rank on its shard:

  - column parallel (the weight's output dim split): each rank computes
    its output slice from the whole input, and the slices are gathered;
  - row parallel (the contraction dim split): each rank computes a
    partial product from its slice of the input, and the partials are
    summed on the row's first rank (JAX's psum);
  - a replicated leaf is used from the row's first rank's copy.

Every op's result is whole, on the row's first rank. With more than one
``data`` row, an op first scatters its input's batch over the rows and
gathers the rows' results back, so each row computes on its shard with
its own copies. :func:`head_parallel_attention` keeps q, k and v split
through the attention: each rank runs the attention on its own
``H / model`` heads (K5 and K6 launch once a rank and block); when the
heads do not divide, the projections are gathered and the attention
runs whole on the row's first rank.

No rank holds a whole split weight or its gradient: autograd takes the
gradient of each shard on its rank (:meth:`ShardedParam.leaves`), and
the state keeps and updates the shards in place
(``runtime/state.py`` :class:`~split_learning_tpu_torch.runtime.state.
ShardedState`).

The ``seq`` axis, as JAX lays it out (``P(data, seq)``): a step's
activations are :class:`SeqBlocks`, one block of T/n tokens a seq rank,
each on its rank's device, from the first stage (which takes a
:class:`SeqInput` and each rank its slice of the input) to the loss.
The models run every per-token op (Dense, LayerNorm, GELU, the residual
adds, the embedding lookup) on each block where it lies, as that rank
(:func:`on_block`), and only the attention exchanges blocks
(``ops/ring_attention.py``; the striped ring through :func:`restripe`,
a cross-rank permutation whose backward is its inverse). Each seq rank
reads its own copy of the parameters: :func:`seq_view` broadcasts every
leaf (or every model rank's shard) from seq rank 0 to the same model
rank of the other seq ranks, and the broadcast's backward sums the seq
ranks' gradients, JAX's psum over ``seq``. A column- or row-parallel op
on a block runs on that seq rank's model ranks.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import (
    Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence,
    Tuple)

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# cross-rank moves, each with its transpose as the backward
# --------------------------------------------------------------------- #
def _moved(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    # a Function may not return the same tensor twice: on one device the
    # move is an alias
    return x.to(dev) if x.device != dev else x.view_as(x)


class _Gather(torch.autograd.Function):
    """Parts on their ranks -> their concatenation on ``dst``; the
    backward slices the gradient back to each rank."""

    @staticmethod
    def forward(ctx, dim, dst, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devs = [p.device for p in parts]
        return torch.cat([p.to(dst) for p in parts], dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(
            _moved(c, d) for c, d in zip(g.split(ctx.sizes, ctx.dim),
                                         ctx.devs))


class _Scatter(torch.autograd.Function):
    """A tensor -> its equal slices along ``dim``, one on each rank; the
    backward gathers the slices' gradients back."""

    @staticmethod
    def forward(ctx, dim, devs, x):
        ctx.dim, ctx.src = dim, x.device
        return tuple(_moved(c, d)
                     for c, d in zip(x.chunk(len(devs), dim), devs))

    @staticmethod
    def backward(ctx, *gs):
        return None, None, torch.cat([g.to(ctx.src) for g in gs], ctx.dim)


class _Broadcast(torch.autograd.Function):
    """A tensor -> a copy on each rank; the backward sums the copies'
    gradients back."""

    @staticmethod
    def forward(ctx, devs, x):
        ctx.src = x.device
        return tuple(_moved(x, d) for d in devs)

    @staticmethod
    def backward(ctx, *gs):
        acc = gs[0].to(ctx.src)
        for g in gs[1:]:
            acc = acc + g.to(ctx.src)
        return None, acc


class _Sum(torch.autograd.Function):
    """Partials on their ranks -> their sum on ``dst`` (JAX's psum, in
    rank order); the backward hands the gradient to every rank."""

    @staticmethod
    def forward(ctx, dst, *parts):
        ctx.devs = [p.device for p in parts]
        acc = parts[0].to(dst)
        for p in parts[1:]:
            acc = acc + p.to(dst)
        return acc

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.devs)


def gather(parts: Sequence[torch.Tensor], dim: int,
           dst: torch.device) -> torch.Tensor:
    return _Gather.apply(dim, torch.device(dst), *parts)


def scatter(x: torch.Tensor, dim: int,
            devs: Sequence[torch.device]) -> List[torch.Tensor]:
    if x.shape[dim] % len(devs):
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                         f"divide over {len(devs)} ranks")
    return list(_Scatter.apply(dim, tuple(devs), x))


def broadcast(x: torch.Tensor,
              devs: Sequence[torch.device]) -> List[torch.Tensor]:
    return list(_Broadcast.apply(tuple(devs), x))


def reduce_sum(parts: Sequence[torch.Tensor],
               dst: torch.device) -> torch.Tensor:
    return _Sum.apply(torch.device(dst), *parts)


# --------------------------------------------------------------------- #
# a parameter leaf on the mesh
# --------------------------------------------------------------------- #
# methods that act on each shard alone and keep the split where it is
_PER_SHARD = frozenset({"to", "float", "bfloat16", "detach", "clone",
                        "contiguous", "requires_grad_"})
# reads of the whole leaf's metadata, answered by the meta tensor
_META_READS = frozenset({"__get__", "size", "dim", "numel", "__len__",
                         "element_size", "is_floating_point",
                         "__repr__", "__format__", "is_complex"})
# attributes that compute from the data: refused, never answered on meta
_COMPUTED = frozenset({"T", "mT", "H", "mH", "real", "imag", "data"})


class ShardedParam(torch.Tensor):
    """A parameter leaf on a mesh: ``grid[row][rank]``, one tensor per
    ``data`` row and ``model`` rank on its rank's device. ``shard_dim``
    is the torch dim split over the ranks (a slice each, in rank order),
    or None for a whole copy on each. The tensor itself is the whole
    leaf's shape on ``meta``: it has no data."""

    @staticmethod
    def __new__(cls, grid: Sequence[Sequence[torch.Tensor]],
                shard_dim: Optional[int], over_seq: bool = False):
        first = grid[0][0]
        shape = list(first.shape)
        if shard_dim is not None:
            shape[shard_dim] = sum(int(s.shape[shard_dim])
                                   for s in grid[0])
        base = torch.empty(shape, dtype=first.dtype, device="meta")
        return torch.Tensor._make_subclass(cls, base, False)

    def __init__(self, grid: Sequence[Sequence[torch.Tensor]],
                 shard_dim: Optional[int], over_seq: bool = False) -> None:
        self.grid = [list(row) for row in grid]
        self.shard_dim = shard_dim
        # rows are seq ranks (:func:`seq_view`), read one a block
        self.over_seq = over_seq

    def leaves(self) -> List[torch.Tensor]:
        """The tensors autograd differentiates: every shard of a split
        leaf (row-major), each row's first copy of a replicated one (the
        copy its ops read)."""
        if self.shard_dim is None:
            return [row[0] for row in self.grid]
        return [t for row in self.grid for t in row]

    def whole_meta(self) -> torch.Tensor:
        """The whole leaf's shape and dtype on ``meta`` (a FLOP count's
        stand-in)."""
        return torch.empty(tuple(self.shape), dtype=self.dtype,
                           device="meta")

    def _map(self, fn: Callable[[torch.Tensor], torch.Tensor]
             ) -> "ShardedParam":
        return ShardedParam([[fn(t) for t in row] for row in self.grid],
                            self.shard_dim, self.over_seq)

    def _index(self, idx: Any) -> "ShardedParam":
        """``self[idx]`` for an index that leaves the split dim whole."""
        grid = [[t[idx] for t in row] for row in self.grid]
        if self.shard_dim is None:
            return ShardedParam(grid, None, self.over_seq)
        with torch._C.DisableTorchFunctionSubclass():
            whole = torch.empty(tuple(self.shape), device="meta")[idx]
        first = grid[0][0]
        diff = [d for d in range(first.dim())
                if first.shape[d] != whole.shape[d]]
        if len(diff) != 1 or sum(t.shape[diff[0]] for t in grid[0]) \
                != whole.shape[diff[0]]:
            raise NotImplementedError(
                "an index across the split dim of a sharded parameter")
        return ShardedParam(grid, diff[0], self.over_seq)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _OPS.get(func)
        if op is not None:
            return op(*args, **kwargs)
        name = getattr(func, "__name__", "")
        self = args[0] if args else None
        if isinstance(self, ShardedParam):
            if name in _PER_SHARD:
                return self._map(lambda t: getattr(t, name)(*args[1:],
                                                            **kwargs))
            if name == "__getitem__":
                return self._index(args[1])
        attr = getattr(getattr(func, "__self__", None), "__name__", "")
        if name in _META_READS and attr not in _COMPUTED:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        raise NotImplementedError(
            f"{name or func} on a sharded parameter: not a tensor-parallel "
            "op (parallel/tensor.py)")


def is_sharded(t: Any) -> bool:
    return isinstance(t, ShardedParam)


class _Leaf(NamedTuple):
    """One data row's part of a leaf: a tensor per model rank."""
    shards: List[torch.Tensor]
    dim: Optional[int]

    @property
    def devs(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    def copy(self) -> torch.Tensor:
        if self.dim is not None:
            raise NotImplementedError(
                "a split leaf where a replicated one is read (a bias or a "
                "norm scale of rank >= 2)")
        return self.shards[0]


def _row_view(p: Any, r: int) -> Any:
    if isinstance(p, ShardedParam):
        return _Leaf(p.grid[r], p.shard_dim)
    if isinstance(p, torch.Tensor):
        return _Leaf([p], None)
    return p


def _copy(b: Any) -> Optional[torch.Tensor]:
    return None if b is None else b.copy()


def _data_parallel(fn: Callable[..., torch.Tensor], x: torch.Tensor,
                   params: Sequence[Any], *rest: Any) -> torch.Tensor:
    """``fn(x_row, *param_rows, *rest)`` on each data row: the batch of
    ``x`` scattered over the rows' first ranks, the rows' results
    gathered back onto ``x``'s device. Parameters whose rows are seq
    ranks (:func:`seq_view`) run the row of the block being computed
    (:func:`on_block`) on ``x`` as it is."""
    grid_of = next(p for p in params if isinstance(p, ShardedParam))
    if grid_of.over_seq:
        s = _BLOCK.get()
        if s is None:
            raise RuntimeError("a seq-replicated parameter read outside a "
                               "seq block (parallel/tensor.py on_block)")
        return fn(x, *[_row_view(p, s) for p in params], *rest)
    rows = len(grid_of.grid)
    if rows == 1:
        return fn(x, *[_row_view(p, 0) for p in params], *rest)
    devs = [row[0].device for row in grid_of.grid]
    xs = scatter(x, 0, devs)
    outs = [fn(xs[r], *[_row_view(p, r) for p in params], *rest)
            for r in range(rows)]
    return gather(outs, 0, x.device)


# --------------------------------------------------------------------- #
# the ops, on one data row
# --------------------------------------------------------------------- #
def _linear_row(x: torch.Tensor, w: _Leaf, b: Any) -> torch.Tensor:
    if w.dim is None:
        return F.linear(x, w.copy(), _copy(b))
    devs = w.devs
    if w.dim == 0:    # column parallel: the output features split
        bs = (scatter(b.copy(), 0, devs) if b is not None
              else [None] * len(devs))
        outs = [F.linear(xi, wi, bi)
                for xi, wi, bi in zip(broadcast(x, devs), w.shards, bs)]
        return gather(outs, -1, x.device)
    # row parallel: the contraction split, the partials summed
    parts = [F.linear(xi, wi)
             for xi, wi in zip(scatter(x, -1, devs), w.shards)]
    y = reduce_sum(parts, x.device)
    return y if b is None else y + b.copy()


def _conv2d_row(x: torch.Tensor, w: _Leaf, b: Any, stride, padding,
                dilation, groups) -> torch.Tensor:
    conv = lambda xi, wi, bi: F.conv2d(  # noqa: E731
        xi, wi, bi, stride, padding, dilation, groups)
    if w.dim is None:
        return conv(x, w.copy(), _copy(b))
    if groups != 1:
        raise NotImplementedError("a grouped conv with a sharded kernel")
    devs = w.devs
    if w.dim == 0:    # column parallel: the output channels split
        bs = (scatter(b.copy(), 0, devs) if b is not None
              else [None] * len(devs))
        outs = [conv(xi, wi, bi)
                for xi, wi, bi in zip(broadcast(x, devs), w.shards, bs)]
        return gather(outs, 1, x.device)
    parts = [conv(xi, wi, None)
             for xi, wi in zip(scatter(x, 1, devs), w.shards)]
    y = reduce_sum(parts, x.device)
    return y if b is None else y + b.copy().reshape(1, -1, 1, 1)


def _embedding_row(ids: torch.Tensor, w: _Leaf) -> torch.Tensor:
    if w.dim is None:
        return F.embedding(ids, w.copy())
    devs = w.devs
    if w.dim == 1:    # the feature dim split: each rank its columns
        outs = [F.embedding(ids.to(d), wi)
                for d, wi in zip(devs, w.shards)]
        return gather(outs, -1, ids.device)
    # the vocabulary split: each rank gathers the ids it holds, zeros
    # elsewhere, and the rows are summed
    parts, off = [], 0
    for d, wi in zip(devs, w.shards):
        local = ids.to(d) - off
        held = (local >= 0) & (local < wi.shape[0])
        rows = F.embedding(local.clamp(0, wi.shape[0] - 1), wi)
        parts.append(rows * held.unsqueeze(-1).to(rows.dtype))
        off += wi.shape[0]
    return reduce_sum(parts, ids.device)


def _add_row(x: torch.Tensor, p: _Leaf, ndim: int) -> torch.Tensor:
    """``x + p`` where ``p`` (of rank ``ndim``) broadcasts against ``x``:
    each rank adds its slice to the matching slice of ``x``."""
    if p.dim is None:
        return x + p.copy()
    k = x.dim() - (ndim - p.dim)
    outs = [xi + pi for xi, pi in zip(scatter(x, k, p.devs), p.shards)]
    return gather(outs, k, x.device)


# --------------------------------------------------------------------- #
# the handlers __torch_function__ routes to
# --------------------------------------------------------------------- #
def _linear(input, weight, bias=None):
    return _data_parallel(_linear_row, input, (weight, bias))


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    return _data_parallel(_conv2d_row, input, (weight, bias), stride,
                          padding, dilation, groups)


def _embedding(input, weight, padding_idx=None, max_norm=None,
               norm_type=2.0, scale_grad_by_freq=False, sparse=False):
    if padding_idx is not None or max_norm is not None or sparse \
            or scale_grad_by_freq:
        raise NotImplementedError("embedding options on a sharded table")
    return _data_parallel(_embedding_row, input, (weight,))


def _layer_norm(input, normalized_shape, weight=None, bias=None, eps=1e-5):
    return _data_parallel(
        lambda x, w, b: F.layer_norm(x, normalized_shape, _copy(w),
                                     _copy(b), eps),
        input, (weight, bias))


def _group_norm(input, num_groups, weight=None, bias=None, eps=1e-5):
    return _data_parallel(
        lambda x, w, b: F.group_norm(x, num_groups, _copy(w), _copy(b),
                                     eps),
        input, (weight, bias))


def _add(a, b, *, alpha=1):
    if alpha != 1:
        raise NotImplementedError("add with alpha on a sharded parameter")
    p, x = (b, a) if isinstance(b, ShardedParam) else (a, b)
    if isinstance(x, ShardedParam) or not isinstance(x, torch.Tensor):
        raise NotImplementedError("the sum of two sharded parameters")
    return _data_parallel(lambda xr, pr: _add_row(xr, pr, p.dim()),
                          x, (p,))


_OPS = {
    F.linear: _linear,
    F.conv2d: _conv2d,
    F.embedding: _embedding,
    F.layer_norm: _layer_norm,
    F.group_norm: _group_norm,
    torch.add: _add,
    torch.Tensor.add: _add,
    torch.Tensor.__add__: _add,
    torch.Tensor.__radd__: lambda a, b: _add(b, a),
}


# --------------------------------------------------------------------- #
# activations partitioned along T over the seq ranks
# --------------------------------------------------------------------- #
_BLOCK: contextvars.ContextVar = contextvars.ContextVar("slt_seq_block",
                                                        default=None)


@contextlib.contextmanager
def on_block(s: int) -> Iterator[None]:
    """Compute as seq rank ``s``: a parameter of :func:`seq_view` reads
    its row ``s``, that rank's copies on its devices."""
    token = _BLOCK.set(int(s))
    try:
        yield
    finally:
        _BLOCK.reset(token)


class SeqInput:
    """One data row's input ``[B, T, ...]`` (on the host) and its seq
    ranks' devices (model rank 0 of each), before the first stage
    partitions it along T: the token embedding takes rank s's slice of
    the ids on rank s, the patch stem the image rows that hold rank s's
    patch tokens. No rank holds the whole input."""

    def __init__(self, x: torch.Tensor, devs: Sequence[torch.device]) -> None:
        self.x, self.devs = x, [torch.device(d) for d in devs]

    @property
    def n(self) -> int:
        return len(self.devs)


class SeqBlocks:
    """One data row's activations ``[B, T, ...]`` partitioned along T
    (dim 1) over its seq ranks, JAX's ``P(data, seq)`` placement:
    ``blocks[s]`` holds tokens ``[s T/n, (s+1) T/n)`` on ``devs[s]``.
    Per-token ops run on each block where it lies (:meth:`map`); only
    the attention exchanges blocks between ranks."""

    def __init__(self, blocks: Sequence[torch.Tensor],
                 devs: Optional[Sequence[torch.device]] = None) -> None:
        self.blocks = list(blocks)
        self.devs = ([torch.device(d) for d in devs] if devs is not None
                     else [b.device for b in self.blocks])

    @classmethod
    def split(cls, x: torch.Tensor,
              devs: Sequence[torch.device]) -> "SeqBlocks":
        """``x``'s equal slices along dim 1, slice s on ``devs[s]``; a
        length that does not divide raises ``ValueError``."""
        n = len(devs)
        if x.shape[1] % n:
            raise ValueError(f"sequence length {x.shape[1]} does not divide "
                             f"over the 'seq' axis ({n})")
        return cls([c.to(d) for c, d in zip(x.chunk(n, 1), devs)], devs)

    @property
    def n(self) -> int:
        return len(self.blocks)

    @property
    def t_local(self) -> int:
        return int(self.blocks[0].shape[1])

    @property
    def t(self) -> int:
        """The global sequence length."""
        return self.n * self.t_local

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "SeqBlocks":
        """``fn`` on every block, as its seq rank (:func:`on_block`)."""
        out = []
        for s, b in enumerate(self.blocks):
            with on_block(s):
                out.append(fn(b))
        return SeqBlocks(out, self.devs)

    def __add__(self, other: "SeqBlocks") -> "SeqBlocks":
        return SeqBlocks([a + b for a, b in zip(self.blocks, other.blocks)],
                         self.devs)

    def __repr__(self) -> str:
        return (f"SeqBlocks({[tuple(b.shape) for b in self.blocks]}, "
                f"devs={[str(d) for d in self.devs]})")


def seq_view(params: Sequence[Dict[str, Any]],
             devices: Sequence[Sequence[torch.device]]
             ) -> Tuple[Dict[str, ShardedParam], ...]:
    """The parameters as the seq ranks of one data row read them, JAX's
    replication over ``seq``: ``devices[s][m]`` is the device of seq rank
    s and model rank m. Each leaf (a tensor on seq rank 0, or a
    :class:`ShardedParam` of one data row over the model ranks there) is
    broadcast to the same model rank of every seq rank; the broadcast's
    backward sums the seq ranks' gradients (JAX's psum over ``seq``), so
    the leaves the state holds take the whole step's gradient and the
    optimizer runs once on them. Rank s reads its row under
    :func:`on_block`. With virtual ranks on one card the copies are
    aliases."""
    n = len(devices)
    out = []
    for stage in params:
        view = {}
        for k, p in stage.items():
            if isinstance(p, ShardedParam):
                dim = p.shard_dim
                home = p.grid[0] if dim is not None else p.grid[0][:1]
            else:
                dim, home = None, [p]
            cols = [broadcast(t, [devices[s][m] for s in range(n)])
                    for m, t in enumerate(home)]
            view[k] = ShardedParam([[c[s] for c in cols] for s in range(n)],
                                   dim, over_seq=True)
        out.append(view)
    return tuple(out)


def _stripe_moves(n: int, t_local: int, to_striped: bool
                  ) -> List[Tuple[List[np.ndarray], np.ndarray]]:
    """Per destination rank: the source slots taken from each source rank
    (in source order), and the order that puts their concatenation in
    the destination's token order. Contiguous: token g on rank g // t_l
    at slot g % t_l; striped: on rank g % n at slot g // n."""
    moves = []
    for dst in range(n):
        slots = np.arange(t_local)
        g = slots * n + dst if to_striped else dst * t_local + slots
        src = g // t_local if to_striped else g % n
        src_slot = g % t_local if to_striped else g // n
        picks = [np.nonzero(src == r)[0] for r in range(n)]
        order = np.argsort(np.concatenate(picks), kind="stable")
        moves.append(([src_slot[p] for p in picks], order))
    return moves


def _restripe(blocks: Sequence[torch.Tensor], devs: Sequence[torch.device],
              to_striped: bool) -> List[torch.Tensor]:
    n, t_local = len(blocks), int(blocks[0].shape[1])
    out = []
    for dst, (slots, order) in enumerate(_stripe_moves(n, t_local,
                                                       to_striped)):
        dev = devs[dst]
        parts = [b.index_select(1, torch.as_tensor(sl, device=b.device))
                 .to(dev) for b, sl in zip(blocks, slots) if len(sl)]
        out.append(torch.cat(parts, 1).index_select(
            1, torch.as_tensor(order, device=dev)))
    return out


class _Restripe(torch.autograd.Function):
    """T-partitioned blocks from the contiguous layout to the striped one
    (token g on rank g % n, JAX's ``stripe_permutation``) or back, a
    cross-rank exchange; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, to_striped, devs, *blocks):
        ctx.to_striped, ctx.devs = to_striped, devs
        return tuple(_restripe(blocks, devs, to_striped))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(_restripe(gs, ctx.devs,
                                              not ctx.to_striped))


def restripe(x: SeqBlocks, to_striped: bool) -> SeqBlocks:
    """:class:`SeqBlocks` in the striped layout (``to_striped``) or back
    in the contiguous one; differentiable."""
    return SeqBlocks(_Restripe.apply(to_striped, tuple(x.devs), *x.blocks),
                     x.devs)


# --------------------------------------------------------------------- #
# attention on its heads
# --------------------------------------------------------------------- #
def head_parallel_attention(x: Any, projections: Sequence[Any],
                            num_heads: int, attend: Callable[..., Any],
                            head_multiple: int = 1) -> Any:
    """Multi-head attention's core on a mesh: ``projections`` are the q,
    k and v dense modules (flax ``nn.Dense``: ``weight``, ``bias`` and
    ``compute_dtype``) whose leaves are :class:`ShardedParam`; ``attend``
    takes ``[B, T, h, d]`` q, k and v and returns the ``[B, T, h, d]``
    output. Per data row: when the three weights are split on their
    output dim and each rank's share of ``num_heads`` is a multiple of
    ``head_multiple`` (Ulysses over a ``seq`` axis splits a rank's heads
    over it), each rank projects and attends its own
    ``num_heads / model`` heads and the heads are gathered; else the
    projections are gathered (column or row parallel) and the attention
    runs whole on the row's first rank. Returns ``[B, T, num_heads, d]``
    on ``x``'s device.

    ``x`` may be :class:`SeqBlocks` (parameters of :func:`seq_view`):
    then each seq rank projects its block on its own model ranks (each
    projection the module itself, called on the rank's shard, so its
    hooks see the block), ``attend`` takes and returns the
    :class:`SeqBlocks` of one model rank's heads on that rank's devices
    over the seq ranks, and the result is the blocks' heads gathered on
    each seq rank's first model rank."""
    if isinstance(x, SeqBlocks):
        return _head_parallel_blocks(x, projections, num_heads, attend,
                                     head_multiple)
    qw = projections[0].weight

    def row(xr: torch.Tensor, *leaves: _Leaf) -> torch.Tensor:
        b, t, e = xr.shape
        d = e // num_heads
        ws, bs = leaves[0::2], leaves[1::2]
        dts = [m.compute_dtype for m in projections]
        n = len(ws[0].shards)
        if all(w.dim == 0 for w in ws) \
                and num_heads % (n * head_multiple) == 0:
            devs = ws[0].devs
            xs = broadcast(xr, devs)
            per_rank = []
            for w, bias, dt in zip(ws, bs, dts):
                b_parts = scatter(bias.copy().to(dt), 0, devs)
                per_rank.append([
                    F.linear(xi.to(dt), wi.to(dt), bi).reshape(
                        b, t, num_heads // n, d)
                    for xi, wi, bi in zip(xs, w.shards, b_parts)])
            outs = [attend(q, k, v) for q, k, v in zip(*per_rank)]
            return gather(outs, 2, xr.device)
        qkv = [_linear_row(xr.to(dt),
                           _Leaf([s.to(dt) for s in w.shards], w.dim),
                           _Leaf([s.to(dt) for s in bias.shards],
                                 bias.dim)).reshape(b, t, num_heads, d)
               for w, bias, dt in zip(ws, bs, dts)]
        return attend(*qkv)

    params = [p for m in projections for p in (m.weight, m.bias)]
    if not isinstance(qw, ShardedParam):
        raise ValueError("head_parallel_attention needs sharded weights")
    return _data_parallel(row, x, params)


def _head_parallel_blocks(x: SeqBlocks, projections: Sequence[Any],
                          num_heads: int, attend: Callable[..., SeqBlocks],
                          head_multiple: int) -> SeqBlocks:
    b, t_local, e = x.blocks[0].shape
    d = e // num_heads
    params = [p for m in projections for p in (m.weight, m.bias)]
    views = [[_row_view(p, s if isinstance(p, ShardedParam) and p.over_seq
                        else 0) for p in params] for s in range(x.n)]
    ws = views[0][0::2]
    n_model = len(ws[0].shards)
    if not (n_model > 1 and all(w.dim == 0 for w in ws)
            and num_heads % (n_model * head_multiple) == 0):
        # each seq rank's projections whole on its first model rank
        qkv = [x.map(lambda xs, m=m: m(xs).reshape(b, t_local, num_heads, d))
               for m in projections]
        return attend(*qkv)
    h_rank = num_heads // n_model
    # per[j][m][s]: projection j of model rank m's heads on seq rank s
    per = [[[None] * x.n for _ in range(n_model)] for _ in projections]
    for s, xs in enumerate(x.blocks):
        with on_block(s):
            leaves = views[s]
            devs = leaves[0].devs
            xb = broadcast(xs, devs)
            for j, mod in enumerate(projections):
                w, bias = leaves[2 * j], leaves[2 * j + 1]
                b_parts = scatter(bias.copy(), 0, devs)
                for m in range(n_model):
                    y = torch.func.functional_call(
                        mod, {"weight": w.shards[m], "bias": b_parts[m]},
                        (xb[m],))
                    per[j][m][s] = y.reshape(b, t_local, h_rank, d)
    outs = []
    for m in range(n_model):
        devs_m = [views[s][0].devs[m] for s in range(x.n)]
        outs.append(attend(*(SeqBlocks(per[j][m], devs_m)
                             for j in range(len(projections)))))
    return SeqBlocks([gather([o.blocks[s] for o in outs], 2, x.devs[s])
                      for s in range(x.n)], x.devs)
