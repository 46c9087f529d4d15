"""The device mesh (counterpart of ``split_learning_tpu/parallel/mesh.py``).

JAX runs the mesh forms as one SPMD program over a ``jax.sharding.Mesh``.
The port keeps one controller per process and makes the mesh a grid of
``torch.device`` with JAX's axis names and order: ``data``, ``pipe``,
then ``model`` and ``seq`` only when their size is above 1. A rank's
tensors live on its device; where JAX exchanges data with a collective
inside ``shard_map``, the port moves tensors between the ranks' devices
(a ``ppermute`` is a ``.to(next_rank_device)``, an ``all_to_all`` a
split and a ``torch.cat`` across ranks), and autograd carries the
reverse hops as JAX's transpose does.

Axes:

- ``data``: data-parallel replicas (the fused trainer's
  ``num_clients``), each with its batch shard; gradients are averaged
  over them;
- ``pipe``: pipeline stages (:mod:`.pipeline`);
- ``model``: tensor parallelism. JAX's whole feature is one placement
  rule, :func:`tp_leaf_sharding` (column, then row, then replicated),
  from which GSPMD partitions the programs. The port keeps the rule on
  JAX's axes and partitions the compute itself: a parameter leaf laid
  out on the ranks is a :class:`~split_learning_tpu_torch.parallel.
  tensor.ShardedParam`, whose ``F.linear``, ``F.conv2d``, embedding
  gather and positional add run per rank on its shard
  (:mod:`.tensor`);
- ``seq``: context parallelism, JAX's activation placement ``P(data,
  seq)``: a step's activations ``[B, T, ...]`` split their T over the
  seq ranks (:func:`seq_devices`; ``parallel/tensor.py`` ``SeqBlocks``),
  so every op but the attention runs on a rank's T/n tokens, and the
  attention forms (``ops/ring_attention.py``) exchange blocks. The
  parameters are replicated over ``seq``: each seq coordinate's model
  ranks hold their :func:`tp_leaf_sharding` shards, and with no
  ``model`` axis each seq rank a whole copy. It composes with
  ``model``.

Devices. :func:`make_mesh` takes distinct CUDA cards by default and
raises JAX's ``ValueError`` when too few are visible; it never shrinks
the mesh. On the CPU every rank is ``cpu``: the counterpart of JAX's
forced host devices, whose count :func:`host_device_count` reads from
``SLT_HOST_DEVICES`` (default 8). On the card a process offers one rank a
visible card, or, when ``SLT_CUDA_RANKS`` asks for n, n ranks laid over
the cards in turn: virtual ranks where n exceeds the cards (the way a
command-line run meshes on one card). A caller may also ask for virtual
ranks with ``devices=[torch.device("cuda:0")] * n``. Neither is ever a
fallback: without the ask, a mesh larger than the devices raises.

Across processes (``parallel/distributed.py``) each mesh entry also
carries the process that owns it; a process runs the ranks it owns and
``torch.distributed`` joins them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from split_learning_tpu_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

# how many CPU ranks a process offers (JAX: the forced host device count)
HOST_DEVICES_ENV = "SLT_HOST_DEVICES"
# how many ranks a process offers over its cards (unset: one a card)
CUDA_RANKS_ENV = "SLT_CUDA_RANKS"
_DEFAULT_HOST_DEVICES = 8


class Mesh:
    """A named grid of ``torch.device`` (JAX's ``Mesh``).

    ``devices`` is an object array of the grid's shape; ``processes``
    (same shape) names the process that owns each entry, all 0 in one
    process."""

    def __init__(self, devices: Any, axis_names: Sequence[str],
                 processes: Any = None) -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.axis_names = tuple(axis_names)
        self.processes = (np.zeros(grid.shape, dtype=np.int64)
                          if processes is None
                          else np.asarray(processes, dtype=np.int64))
        if self.processes.shape != grid.shape:
            raise ValueError("processes must have the device grid's shape")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """The number of ranks (JAX's ``Mesh.size``)."""
        return int(self.devices.size)

    def _index(self, coords: Dict[str, int]) -> tuple:
        bad = set(coords) - set(self.axis_names)
        if bad:
            raise ValueError(f"no axis {sorted(bad)} in {self.axis_names}")
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def device(self, **coords: int) -> torch.device:
        """The device at ``coords`` (an axis left out is 0)."""
        return self.devices[self._index(coords)]

    def process(self, **coords: int) -> int:
        return int(self.processes[self._index(coords)])

    def axis_devices(self, axis: str, **coords: int) -> List[torch.device]:
        """The devices along ``axis`` at ``coords`` on the other axes (a
        missing axis is ``axis`` of size 1: its one device)."""
        if axis not in self.axis_names:
            return [self.device(**coords)]
        return [self.device(**{**coords, axis: i})
                for i in range(self.shape[axis])]

    def local_rows(self, process: int) -> List[int]:
        """The ``data`` rows whose devices ``process`` owns."""
        n = self.shape.get(DATA_AXIS, 1)
        return [d for d in range(n) if self.process(**(
            {DATA_AXIS: d} if DATA_AXIS in self.axis_names else {}))
            == process]

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat))
                and (self.processes == other.processes).all())

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.devices.shape),
                     tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{sorted({str(d) for d in self.devices.flat})})")


def host_device_count() -> int:
    """How many CPU ranks a process offers: ``SLT_HOST_DEVICES``, else 8."""
    return int(os.environ.get(HOST_DEVICES_ENV) or _DEFAULT_HOST_DEVICES)


def ensure_host_device_count(n: Optional[int] = None) -> int:
    """Set ``SLT_HOST_DEVICES`` to ``n`` (default: the variable's value,
    else 8) unless it is already set; return the count. JAX's function
    forces the XLA host device count; here the variable is the count."""
    if n is None:
        n = host_device_count()
    os.environ.setdefault(HOST_DEVICES_ENV, str(n))
    return host_device_count()


def local_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices this process offers a mesh: every visible card for
    ``cuda`` (raising without one), or ``SLT_CUDA_RANKS`` ranks laid over
    the cards in turn; :func:`host_device_count` CPU ranks for
    ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        ranks = int(os.environ.get(CUDA_RANKS_ENV) or cards)
        return [torch.device("cuda", i % cards) for i in range(ranks)]
    return [torch.device("cpu")] * host_device_count()


def make_mesh(num_clients: int = 1, num_stages: int = 1,
              model_parallel: int = 1, seq_parallel: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None,
              device: DeviceLike = "cuda") -> Mesh:
    """A (data x pipe[, model][, seq]) mesh over the first
    ``num_clients*num_stages*model_parallel*seq_parallel`` of
    ``devices`` (default: :func:`local_devices` of ``device``). The
    ``model`` and ``seq`` axes exist only when their sizes exceed 1."""
    if devices is None:
        devices = local_devices(device)
    need = num_clients * num_stages * model_parallel * seq_parallel
    if len(devices) < need:
        raise ValueError(
            f"mesh needs {need} devices ({num_clients} clients x "
            f"{num_stages} stages x {model_parallel} model shards x "
            f"{seq_parallel} seq shards), only {len(devices)} available")
    shape = [num_clients, num_stages]
    names = [DATA_AXIS, PIPE_AXIS]
    if model_parallel > 1:
        shape.append(model_parallel)
        names.append(MODEL_AXIS)
    if seq_parallel > 1:
        shape.append(seq_parallel)
        names.append(SEQ_AXIS)
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(shape), names)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data x 1[, model]) mesh of CPU ranks, for tests and local runs.

    Too few ranks raises with the remedy, as JAX's does."""
    n = host_device_count()
    if n < data * model:
        raise RuntimeError(
            f"host mesh needs {data * model} devices but the process "
            f"offers {n}. Set {HOST_DEVICES_ENV}={max(data * model, 8)} "
            "(or call parallel.mesh.ensure_host_device_count())")
    return make_mesh(num_clients=data, model_parallel=model, device="cpu")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh (JAX's ``NamedSharding``, reduced
    to the placements the port uses): split along dim 0 over the
    ``data`` rows (``axis`` ``"data"``), or a copy on every row (``axis``
    None). A row's tensor lives on the row's first device. ``dim`` is a
    parameter's placement on the ``model`` axis: the torch dim split
    over the row's model ranks, or None for a copy on each."""

    mesh: Mesh
    axis: Optional[str] = None
    dim: Optional[int] = None

    @property
    def spec(self) -> tuple:
        """The partition spec over the torch dims, as JAX writes one:
        ``()`` replicated, else one entry a dim up to the sharded one."""
        if self.dim is not None:
            return (None,) * self.dim + (MODEL_AXIS,)
        return (DATA_AXIS,) if self.axis == DATA_AXIS else ()

    def _rows(self) -> List[torch.device]:
        return self.mesh.axis_devices(DATA_AXIS)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One tensor a data row, on the row's device."""
        devs = self._rows()
        if self.axis is None:
            return [x.to(d) for d in devs]
        if x.shape[0] % len(devs):
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{len(devs)} data rows")
        return [c.to(d) for c, d in zip(x.chunk(len(devs), 0), devs)]

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor on the first row's device."""
        first = self._rows()[0]
        if self.axis is None:
            return parts[0].to(first)
        return torch.cat([p.to(first) for p in parts], 0)


def seq_devices(mesh: Mesh, row: int = 0) -> List[List[torch.device]]:
    """JAX's activation placement ``P(data, seq)`` for data row ``row``:
    ``[s][m]``, the device of seq rank s and model rank m (one model rank
    where the mesh has no ``model`` axis). Block s of the row's
    activations lives on ``[s][0]``; seq rank s's copy of each parameter
    on ``[s][m]``, as :func:`tp_leaf_sharding` places it there."""
    if SEQ_AXIS not in mesh.axis_names:
        return [mesh.axis_devices(MODEL_AXIS, **{DATA_AXIS: row})]
    return [mesh.axis_devices(MODEL_AXIS, **{DATA_AXIS: row, SEQ_AXIS: s})
            for s in range(mesh.shape[SEQ_AXIS])]


def tp_leaf_sharding(mesh: Mesh, leaf: Any, name: str = "weight"
                     ) -> Sharding:
    """JAX's placement rule for one parameter leaf (``tp_leaf_sharding``,
    ``split_learning_tpu/parallel/mesh.py``), on the port's leaf ``name``
    of ``leaf``'s shape. On the JAX leaf, a leaf of rank >= 2 splits its
    last dim over ``model`` when the axis size divides it (column
    parallel), else its second-to-last (row parallel), else replicates;
    biases, norm scales and scalars replicate. The rule reads the JAX
    leaf's axes: a flax dense kernel is ``[in, out]`` and a conv kernel
    HWIO where torch keeps ``[out, in]`` and OIHW, so JAX's last dim is
    torch dim 0 there (:func:`~split_learning_tpu_torch.interop.
    torch_dim`); an embedding table and ``pos`` are not transposed.
    ``name`` defaults to a kernel's. Optimizer mirrors share their
    weights' shapes and names, so they shard with them."""
    if MODEL_AXIS not in mesh.axis_names:
        return replicated(mesh)
    from split_learning_tpu_torch.interop import torch_dim
    n_model = mesh.shape[MODEL_AXIS]
    shape = tuple(getattr(leaf, "shape", ()))
    nd = len(shape)
    if nd >= 2:
        for jax_dim in (-1, -2):
            dim = torch_dim(name, nd, jax_dim)
            if shape[dim] % n_model == 0:
                return Sharding(mesh, None, dim)
    return replicated(mesh)


def tp_param_sharding(mesh: Mesh, params: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Sharding]]:
    """:func:`tp_leaf_sharding` of every leaf of per-stage ``{name:
    tensor}`` dicts, keyed as they are (JAX's ``tp_param_sharding``)."""
    return [{k: tp_leaf_sharding(mesh, v, k) for k, v in stage.items()}
            for stage in params]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batch dim split over the data rows."""
    return Sharding(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def host_gather(x: Any, rows: Optional[int] = None) -> np.ndarray:
    """A host array of ``x`` (a tensor, an array, or the per-row shards
    of a batch-split tensor, gathered in row order), trimmed to its
    first ``rows`` rows. The one sanctioned device-to-host read of a
    meshed output, as JAX's is."""
    if isinstance(x, (list, tuple)):
        x = np.concatenate([host_gather(p) for p in x], 0)
    elif isinstance(x, torch.Tensor):
        x = x.detach()
        x = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    else:
        x = np.asarray(x)
    if rows is not None and x.ndim >= 1 and int(rows) < x.shape[0]:
        x = x[:int(rows)]
    return x


# --------------------------------------------------------------------- #
# the data row a caller runs (JAX: ``lax.axis_index`` inside shard_map)

_ROW: contextvars.ContextVar = contextvars.ContextVar("slt_mesh_row",
                                                      default=None)


@contextlib.contextmanager
def data_row(mesh: Mesh, row: int) -> Iterator[None]:
    """Run the block as data row ``row`` of ``mesh``: the mesh forms
    called inside (``ops/ring_attention.py``) take the tensors they are
    given as that row's and use that row's devices only."""
    token = _ROW.set((mesh, int(row)))
    try:
        yield
    finally:
        _ROW.reset(token)


def active_row(mesh: Mesh) -> Optional[int]:
    """The data row set by :func:`data_row` for ``mesh``, else None."""
    cur = _ROW.get()
    if cur is None or not (cur[0] is mesh or cur[0] == mesh):
        return None
    return cur[1]
