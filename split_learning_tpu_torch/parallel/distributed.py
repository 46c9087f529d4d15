"""Runs over several processes (counterpart of
``split_learning_tpu/parallel/distributed.py``).

JAX makes a multi-host job one SPMD program over a global mesh. The port
keeps one controller per process: :func:`init_multi_host` starts
``torch.distributed`` (gloo on the CPU, NCCL between hosts with cards),
:func:`global_mesh` lays the mesh over every process's devices, and each
process runs the ``data`` rows it owns; the gradient mean over the rows
(:func:`sum_over_rows`) is the one collective that crosses processes.

Layout policy, as in JAX: the ``pipe`` axis is packed within one
process's devices, processes stack along ``data``; ``model`` and ``seq``
axes across processes are refused with JAX's messages, as is a
``num_clients`` other than the number of data rows the hardware gives.

Coordinator discovery: ``SLT_COORDINATOR`` (``host:port`` of process 0),
``SLT_NUM_PROCESSES`` and ``SLT_PROCESS_ID``, or the arguments. Every
process builds the identical global batch (same data, same seed) and
takes its rows of it.

NCCL refuses two ranks on one card, so a multi-process run on one
machine with one card runs on the CPU (gloo).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from split_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, Sharding, batch_sharding,
    local_devices, make_mesh, replicated)
from split_learning_tpu_torch.utils.device import DeviceLike

_ENV_COORDINATOR = "SLT_COORDINATOR"      # host:port of process 0
_ENV_NUM_PROCESSES = "SLT_NUM_PROCESSES"
_ENV_PROCESS_ID = "SLT_PROCESS_ID"


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_multi_host(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    device: DeviceLike = "cuda") -> bool:
    """Join the job's process group; True when it spans processes.

    The arguments default from ``SLT_COORDINATOR``,
    ``SLT_NUM_PROCESSES`` and ``SLT_PROCESS_ID``. No coordinator, or one
    process, is a no-op returning False. The backend is NCCL for
    ``device`` ``cuda`` and gloo for ``cpu``. Idempotent."""
    if _initialized():
        return _dist().get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        _ENV_COORDINATOR) or None
    if num_processes is None:
        raw = os.environ.get(_ENV_NUM_PROCESSES)
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = os.environ.get(_ENV_PROCESS_ID)
        process_id = int(raw) if raw else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError(
            f"multi-host init needs a process id ({_ENV_PROCESS_ID}; on k8s "
            "use the StatefulSet pod ordinal)")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    _dist().init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if _initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def _grid_rows(devices: Sequence, num_stages: int,
               process_of: Callable = lambda d: d.process_index
               ) -> List[List]:
    """Rows of a (data x pipe) grid in which every row's ``num_stages``
    devices belong to one process: pipe hops never cross hosts."""
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(process_of(d), []).append(d)
    rows: List[List] = []
    for proc in sorted(by_proc):
        local = by_proc[proc]
        if len(local) % num_stages != 0:
            raise ValueError(
                f"process {proc} has {len(local)} devices, not divisible by "
                f"num_stages={num_stages}: a pipeline stage chain would have "
                "to cross DCN")
        for i in range(0, len(local), num_stages):
            rows.append(local[i:i + num_stages])
    return rows


def global_mesh(num_clients: int = 1, num_stages: int = 1,
                model_parallel: int = 1, seq_parallel: int = 1,
                devices: Optional[Sequence[DeviceLike]] = None,
                device: DeviceLike = "cuda") -> Mesh:
    """A (data x pipe[, model][, seq]) mesh over every process's devices.

    One process: :func:`~.mesh.make_mesh`. Several: each process offers
    ``devices`` (default :func:`~.mesh.local_devices` of ``device``),
    ``pipe`` is packed within a process and processes stack on ``data``;
    ``num_clients`` must equal the data rows that gives."""
    if process_count() <= 1:
        return make_mesh(num_clients=num_clients, num_stages=num_stages,
                         model_parallel=model_parallel,
                         seq_parallel=seq_parallel, devices=devices,
                         device=device)
    if model_parallel > 1:
        raise ValueError(
            "tensor parallelism (model axis) shards per-layer activation "
            "collectives and must stay on ICI; it is not supported across "
            "hosts — use data/pipe axes over DCN instead")
    if seq_parallel > 1:
        raise ValueError(
            "context parallelism (seq axis) is wired for single-host ICI "
            "meshes; cross-host ring attention over DCN is not laid out "
            "by this policy — use the data axis across hosts and the seq "
            "axis within one")
    local = [str(torch.device(d)) for d in
             (devices if devices is not None else local_devices(device))]
    every: List[Any] = [None] * process_count()
    _dist().all_gather_object(every, local)
    entries = [(proc, dev) for proc, devs in enumerate(every)
               for dev in devs]
    rows = _grid_rows(entries, num_stages, process_of=lambda e: e[0])
    if num_clients != len(rows):
        raise ValueError(
            f"{len(entries)} devices across {process_count()} hosts at "
            f"{num_stages} stages form {len(rows)} data rows; "
            f"--num-clients must be {len(rows)} (got {num_clients})")
    grid = np.empty((len(rows), num_stages), dtype=object)
    procs = np.empty((len(rows), num_stages), dtype=np.int64)
    for i, row in enumerate(rows):
        for j, (proc, dev) in enumerate(row):
            grid[i, j], procs[i, j] = dev, proc
    return Mesh(grid, (DATA_AXIS, PIPE_AXIS), procs)


@torch.no_grad()
def sum_over_rows(per_row: Sequence[Sequence[torch.Tensor]]
                  ) -> List[torch.Tensor]:
    """The element-wise sum over every data row of the job: ``per_row``
    holds this process's rows in row order, each a list of tensors; the
    rows add in that order on the first row's devices, then across
    processes (``all_reduce``). Every process gets the same sum."""
    acc = [t.detach().clone() for t in per_row[0]]
    for row in per_row[1:]:
        for a, t in zip(acc, row):
            a.add_(t.to(a.device))
    if process_count() > 1:
        for a in acc:
            _dist().all_reduce(a)
    return acc


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Placement table of one party on a mesh: batches split over
    ``data``, state replicated. The ``model`` part (tensor parallelism)
    raises until its slice."""

    mesh: Mesh

    @property
    def data(self) -> int:
        return int(self.mesh.shape.get(DATA_AXIS, 1))

    def _no_model(self) -> None:
        if MODEL_AXIS in self.mesh.axis_names:
            raise NotImplementedError(
                "not ported yet: a model axis (tensor parallelism, ROADMAP "
                "item 18)")

    @property
    def model(self) -> int:
        self._no_model()
        return 1

    def batch(self) -> Sharding:
        return batch_sharding(self.mesh)

    def replicated(self) -> Sharding:
        return replicated(self.mesh)

    def param(self, leaf: Any) -> Sharding:
        self._no_model()
        return replicated(self.mesh)

    def state(self, state: Any) -> Dict[str, Sharding]:
        """One placement per parameter leaf, ``"stage/key"``: replicated."""
        self._no_model()
        return {f"{i}/{k}": replicated(self.mesh)
                for i, stage in enumerate(state.params) for k in stage}
