"""Checkpoint and resume (counterpart of
``split_learning_tpu/runtime/checkpoint.py``).

:class:`Checkpointer` keeps step-indexed saves of a tree of tensors,
lists, tuples, dicts, ints and strings: the whole cross-party state of a
run (every stage's ``TrainState`` as :func:`~split_learning_tpu_torch.
runtime.state.state_tree` gives it), in one atomic save per step, so
the halves of a split pair never desync across a restore. A step lives
in ``<directory>/<step>/state.pt``, written with ``torch.save`` and read
with ``torch.load(weights_only=True)``; the step directory is committed
the way the sidecar below is: written under a temporary name, fsynced,
then renamed.

Saves are asynchronous, as JAX's Orbax saves are, but the port's
parameters and optimizer moments are updated **in place** (the SGD
kernel, Adam's ``_foreach`` ops): a save that kept references would
write a later step's values. So :meth:`Checkpointer.save` snapshots:
it clones every tensor on the caller's stream and, on the card, records
an event behind the clones. That clone is all the caller pays (on a
server, under its lock). A writer thread waits on the event, copies the
snapshot to pinned host memory on a side stream, then writes, fsyncs
and renames. Every read (:meth:`~Checkpointer.latest_step`,
:meth:`~Checkpointer.restore` ...) barriers on the outstanding writes
first, and :meth:`~Checkpointer.close` drains them; the launcher's
``_ckpt_drain`` drains on every exit path.

A state laid out on a mesh (``runtime/state.py`` ``ShardedState``)
saves as whole leaves, its shards concatenated as the unsharded state
holds them, and restores onto any mesh or none: the restore cuts each
leaf to the slices of the template's ranks.

A JAX checkpoint directory (Orbax step directories) cannot be read
without Orbax: the checkpointer refuses it with
:class:`ForeignCheckpointError`, before reading any of it.
``interop.train_state_from_jax`` carries a JAX run's state across in a
process that has JAX.

From :data:`EXTRAS_VERSION` on, the module is JAX's own, copied: the
runtime-extras sidecar, one checksummed JSON file per save with the
server state the step tree does not carry (the replay cache with its
wire bodies, and the topk8 error-feedback ledger), written tmp + fsync
+ rename through an injectable filesystem. The sidecar is
framework-neutral: a port-written one passes JAX's
``extras_valid``/``read_latest_extras``, and the reverse.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import queue
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from split_learning_tpu_torch.obs import flight as obs_flight
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.utils.arrays import to_host

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"
# what an Orbax step directory holds that a port step never does
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default", "_METADATA")

Extras = Union[Dict[str, Any], Callable[[], Dict[str, Any]], None]


class ForeignCheckpointError(ValueError):
    """The directory holds a checkpoint the port cannot read (JAX's
    Orbax step directories)."""


def foreign_checkpoint(directory: str) -> Optional[str]:
    """Why ``directory`` is not a port checkpoint directory (it holds
    Orbax step directories, or a ``meta.json`` without the port's
    ``framework`` key), or None when it is one or is empty."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in names:
        path = os.path.join(directory, name)
        if name.isdigit() and os.path.isdir(path):
            inside = set(os.listdir(path))
            if STATE_FILE not in inside or inside & set(_ORBAX_MARKERS):
                return (f"{directory} is a JAX checkpoint directory (Orbax "
                        f"step {name}); the PyTorch port cannot read it: "
                        "carry its state across with interop."
                        "train_state_from_jax in a process that has JAX")
    meta = os.path.join(directory, "meta.json")
    if os.path.isfile(meta):
        try:
            with open(meta) as f:
                framework = json.load(f).get("framework")
        except (OSError, ValueError, AttributeError):
            framework = None
        if framework != "torch":
            return (f"{directory} is a JAX checkpoint directory (its "
                    "meta.json was not written by the PyTorch port); the "
                    "port cannot read it")
    return None


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a tree of dicts, lists and tuples;
    other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _tensors(tree: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    _map(out.append, tree)
    return out


class _Job:
    __slots__ = ("step", "tree", "event", "extras")

    def __init__(self, step: int, tree: Any, event: Any,
                 extras: Extras) -> None:
        self.step, self.tree, self.event = step, tree, event
        self.extras = extras


class Checkpointer:
    """Step-indexed asynchronous saves with ``max_to_keep`` retention
    (the JAX class's surface). ``stats`` holds the last save's costs:
    ``snapshot_ms`` (what :meth:`save` blocked its caller), ``write_ms``
    (the writer thread's time for the step, the host copy included),
    ``bytes`` (the step file) and ``restore_ms`` (the last restore)."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(os.path.expanduser(directory))
        foreign = foreign_checkpoint(self.directory)
        if foreign is not None:
            raise ForeignCheckpointError(foreign)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self._jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._cond = threading.Condition()
        self._pending = 0
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[torch.device, Any] = {}
        self.stats: Dict[str, float] = {}
        # nothing is in flight yet: a plain disk read. Afterwards save()
        # keeps it, so save_once() never needs the barriering read
        self._last_enqueued = self._latest_on_disk()

    @property
    def last_enqueued(self) -> Optional[int]:
        """The step of the newest save enqueued (or found on disk)."""
        return self._last_enqueued

    # -- saves ------------------------------------------------------------ #
    def save(self, step: int, tree: Any, extras: Extras = None) -> None:
        """Snapshot ``tree`` (a ``TrainState``, or a dict holding them
        and other values) and enqueue its write; returns without waiting
        for the disk. ``extras`` (a sidecar payload, or a callable that
        builds one on the writer thread) is written beside the step once
        the step is committed."""
        from split_learning_tpu_torch.runtime.state import (
            ShardedState, TrainState, state_tree)
        t0 = time.perf_counter()
        states = (TrainState, ShardedState)
        if isinstance(tree, states):
            tree = state_tree(tree)
        elif isinstance(tree, dict):
            tree = {k: state_tree(v) if isinstance(v, states) else v
                    for k, v in tree.items()}
        snap = _map(lambda t: t.detach().clone(), tree)
        event = None
        cuda = [t for t in _tensors(snap, []) if t.is_cuda]
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        self.stats["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
        with self._cond:
            self._pending += 1
            self._start_writer()
        self._jobs.put(_Job(int(step), snap, event, extras))
        self._last_enqueued = int(step)

    def save_once(self, step: int, tree: Any, extras: Extras = None) -> bool:
        """:meth:`save`, skipped when ``step`` is the last one enqueued,
        without the barriering :meth:`latest_step`: the form a step hook
        uses (a barrier there would stall it, and on a server every
        client, on the previous write)."""
        if self._last_enqueued == int(step):
            return False
        self.save(step, tree, extras)
        return True

    def _start_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, name="slt-ckpt-writer", daemon=True)
            self._thread.start()

    def _writer(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                self._write(job)
            except Exception as exc:  # re-raised at the next barrier
                with self._cond:
                    self._error = exc
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _host_copy(self, job: _Job) -> Any:
        """The snapshot on the host: on the card, after the clones'
        event, through pinned memory on a side stream."""
        if job.event is None:
            return job.tree
        job.event.synchronize()
        dev = next(t.device for t in _tensors(job.tree, []) if t.is_cuda)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)

        def host(t: torch.Tensor) -> torch.Tensor:
            if not t.is_cuda:
                return t
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            return out

        with torch.cuda.stream(stream):
            tree = _map(host, job.tree)
        stream.synchronize()
        return tree

    def _write(self, job: _Job) -> None:
        t0 = time.perf_counter()
        tree = self._host_copy(job)
        job.tree = None  # the card's snapshot is free from here
        final = os.path.join(self.directory, str(job.step))
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{job.step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILE)
        torch.save(tree, path)
        _fsync_path(path)
        _fsync_path(tmp)
        if os.path.isdir(final):  # a re-save of a step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_path(self.directory)
        self.stats["bytes"] = float(os.path.getsize(
            os.path.join(final, STATE_FILE)))
        if job.extras is not None:
            payload = job.extras() if callable(job.extras) else job.extras
            if payload is not None:
                write_extras(self.directory, payload)
        self._retain()
        self.stats["write_ms"] = (time.perf_counter() - t0) * 1e3

    def _retain(self) -> None:
        """Keep the newest ``max_to_keep`` steps, and the sidecars of
        those steps (a sidecar of a dropped step can never be paired)."""
        steps = self._steps_on_disk()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, str(step)),
                          ignore_errors=True)
        kept = steps[-self.max_to_keep:]
        for name in os.listdir(self.directory):
            if name.startswith(_EXTRAS_PREFIX) and kept:
                stem = name[len(_EXTRAS_PREFIX):].split("-")[0]
                if stem.isdigit() and int(stem) < kept[0]:
                    os.remove(os.path.join(self.directory, name))

    # -- barriers and reads ---------------------------------------------- #
    def wait_until_finished(self) -> None:
        """Barrier on every enqueued save; re-raises a failed write."""
        with self._cond:
            while self._pending:
                self._cond.wait()
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _steps_on_disk(self) -> List[int]:
        """Committed steps, ascending. A temporary directory (a write
        that never reached its rename) is never one of them."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(self.directory, n, STATE_FILE)))

    def _latest_on_disk(self) -> Optional[int]:
        steps = self._steps_on_disk()
        return steps[-1] if steps else None

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        return self._latest_on_disk()

    def all_steps(self) -> List[int]:
        self.wait_until_finished()
        return self._steps_on_disk()

    def restore_raw(self, step: Optional[int] = None) -> Any:
        """The saved tree of ``step`` (default: the latest), its tensors
        on the CPU. Raises ``FileNotFoundError`` when there is none."""
        self.wait_until_finished()
        if step is None:
            step = self._latest_on_disk()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(int(step)), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.directory}")
        t0 = time.perf_counter()
        tree = torch.load(path, map_location="cpu", weights_only=True)
        self.stats["restore_ms"] = (time.perf_counter() - t0) * 1e3
        return tree

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore ``step`` (default: the latest) into ``template``: a
        ``TrainState`` or a dict of them (and of other values). Each
        ``TrainState`` is restored in place
        (:func:`~split_learning_tpu_torch.runtime.state.restore_state`)
        and returned; other keys come back as saved."""
        from split_learning_tpu_torch.runtime.state import (
            ShardedState, TrainState, restore_state)
        states = (TrainState, ShardedState)
        raw = self.restore_raw(step)
        t0 = time.perf_counter()
        if isinstance(template, states):
            restore_state(template, raw)
            out: Any = template
        else:
            out = {}
            for key, value in raw.items():
                live = template.get(key) if isinstance(template, dict) \
                    else None
                if isinstance(live, states):
                    restore_state(live, value)
                    out[key] = live
                else:
                    out[key] = value
        self.stats["restore_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def restore_partial(self, template: Dict[str, Any],
                        step: Optional[int] = None) -> Dict[str, Any]:
        """:meth:`restore` of the top-level keys of ``template`` (e.g.
        the ``server`` half of a joint checkpoint); a key the checkpoint
        does not hold raises ``KeyError``."""
        raw_keys = self.restore_raw(step)
        if not isinstance(raw_keys, dict):
            raise ValueError(
                f"restore_partial expects a dict-shaped checkpoint, got "
                f"{type(raw_keys).__name__}")
        missing = set(template) - set(raw_keys)
        if missing:
            raise KeyError(
                f"checkpoint under {self.directory} has no {sorted(missing)}"
                f" subtree(s); present: {sorted(raw_keys)}")
        return self.restore(template, step)

    def close(self) -> None:
        """Drain the outstanding writes and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._thread is not None and self._thread.is_alive():
                self._jobs.put(None)
                self._thread.join(timeout=30.0)
            self._thread = None


# --------------------------------------------------------------------- #
# Runtime-extras sidecar (JAX's, copied): the server state the step tree
# does not carry: the replay cache (exactly-once across a restart) and
# the topk8 EF residual ledger. One JSON file per save, lineage-stamped
# and checksummed, written tmp + fsync + rename, so a crash at any point
# leaves the previous extras or the new one, never a readable half-file.
# The filesystem is injectable (``fs=``).
# --------------------------------------------------------------------- #

EXTRAS_VERSION = 1
_EXTRAS_PREFIX = "extras-"
_EXTRAS_SUFFIX = ".json"


def encode_obj(obj: Any) -> Any:
    """Tagged JSON-able encoding: ndarrays and tensors (b64, bit-exact),
    bytes, tuples, and non-str-keyed dicts all round-trip through
    :func:`decode_obj` (a tensor comes back as an ndarray). Raises
    TypeError on anything else."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, tuple):
        return {"__tup__": [encode_obj(v) for v in obj]}
    if isinstance(obj, list):
        return [encode_obj(v) for v in obj]
    if isinstance(obj, dict):
        if all(isinstance(k, str) and not k.startswith("__") for k in obj):
            return {k: encode_obj(v) for k, v in obj.items()}
        return {"__kvs__": [[encode_obj(k), encode_obj(v)]
                            for k, v in obj.items()]}
    if isinstance(obj, np.generic):
        return encode_obj(obj.item())
    if isinstance(obj, torch.Tensor):
        obj = to_host(obj)
    arr = np.asarray(obj)
    if arr.dtype == object:
        raise TypeError(f"cannot encode {type(obj).__name__} into extras")
    arr = np.ascontiguousarray(arr)
    return {"__nd__": {"dtype": str(arr.dtype), "shape": list(arr.shape),
                       "b64": base64.b64encode(arr.tobytes())
                                    .decode("ascii")}}


def decode_obj(obj: Any) -> Any:
    """Inverse of :func:`encode_obj`."""
    if isinstance(obj, list):
        return [decode_obj(v) for v in obj]
    if isinstance(obj, dict):
        if "__b64__" in obj:
            return base64.b64decode(obj["__b64__"])
        if "__tup__" in obj:
            return tuple(decode_obj(v) for v in obj["__tup__"])
        if "__kvs__" in obj:
            return {decode_obj(k): decode_obj(v) for k, v in obj["__kvs__"]}
        if "__nd__" in obj:
            nd = obj["__nd__"]
            raw = base64.b64decode(nd["b64"])
            return np.frombuffer(raw, dtype=np.dtype(nd["dtype"])) \
                     .reshape(nd["shape"]).copy()
        return {k: decode_obj(v) for k, v in obj.items()}
    return obj


def _canonical(payload: Any) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def build_extras(step: int, lineage: int, *, replay: Any = None,
                 wire_ef: Any = None) -> Dict[str, Any]:
    """Assemble and checksum one extras payload. ``replay`` / ``wire_ef``
    are the raw ``export_state()`` outputs (encoded here); ``lineage``
    is the writer's monotonic commit counter. A restore whose sidecar
    step does not match the restored step is stale and rejected
    (``read_latest_extras(step=...)``)."""
    payload: Dict[str, Any] = {"version": EXTRAS_VERSION,
                               "step": int(step), "lineage": int(lineage)}
    if replay is not None:
        payload["replay"] = encode_obj(replay)
    if wire_ef is not None:
        payload["wire_ef"] = encode_obj(wire_ef)
    return finalize_extras(payload)


def finalize_extras(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp the sha256 checksum over the canonical body."""
    body = {k: v for k, v in payload.items() if k != "checksum"}
    out = dict(body)
    out["checksum"] = hashlib.sha256(
        _canonical(body).encode("utf-8")).hexdigest()
    return out


def extras_valid(payload: Any) -> bool:
    """True iff the payload is a well-formed, checksum-intact extras
    dict of the current version. A torn or bit-rotted file fails here
    and the reader falls back to the previous sidecar."""
    if not isinstance(payload, dict):
        return False
    if payload.get("version") != EXTRAS_VERSION:
        return False
    if not isinstance(payload.get("step"), int) or \
            not isinstance(payload.get("lineage"), int):
        return False
    body = {k: v for k, v in payload.items() if k != "checksum"}
    want = hashlib.sha256(_canonical(body).encode("utf-8")).hexdigest()
    return payload.get("checksum") == want


class _OsFS:
    """The real-filesystem leg of the injectable fs seam. rename is
    os.replace: atomic within a filesystem, the commit point of the
    tmp-write idiom."""

    def put(self, path: str, text: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)

    def fsync(self, path: str) -> None:
        _fsync_path(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def listdir(self, directory: str) -> list:
        try:
            return os.listdir(directory)
        except OSError:
            return []

    def read(self, path: str) -> str:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()


def extras_name(step: int, lineage: int) -> str:
    # zero-padded so lexicographic filename order == (step, lineage)
    return f"{_EXTRAS_PREFIX}{int(step):08d}-{int(lineage):08d}" \
           f"{_EXTRAS_SUFFIX}"


def write_extras(directory: str, payload: Dict[str, Any],
                 fs: Any = None) -> str:
    """Durably publish one extras payload: write the canonical JSON to a
    ``.tmp`` sibling, fsync it, then rename onto the final name. A crash
    before the rename leaves only the tmp (ignored by readers); after,
    the full file. Returns the final path."""
    fs = fs or _OsFS()
    final = f"{directory}/{extras_name(payload['step'], payload['lineage'])}"
    tmp = final + ".tmp"
    blob = _canonical(payload)
    fs.put(tmp, blob)
    fs.fsync(tmp)
    fs.rename(tmp, final)
    fl = obs_flight.get_recorder()
    if fl is not None:
        fl.record(spans.FL_CKPT_COMMIT, step=int(payload["step"]),
                  party="server", lineage=int(payload["lineage"]))
    return final


def read_latest_extras(directory: str, fs: Any = None,
                       step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Newest-valid-wins scan of the extras sidecars. Unparseable or
    checksum-failing files (torn writes) are skipped; with ``step=``,
    sidecars for any other step are skipped too (stale-lineage
    rejection: the caller pairs this with the step it restored).
    Returns the payload dict or None."""
    fs = fs or _OsFS()
    names = sorted(
        (n for n in fs.listdir(directory)
         if n.startswith(_EXTRAS_PREFIX) and n.endswith(_EXTRAS_SUFFIX)),
        reverse=True)
    for name in names:
        try:
            text = fs.read(f"{directory}/{name}")
            payload = json.loads(text)
        except (OSError, KeyError, ValueError):
            continue
        if not extras_valid(payload):
            continue
        if step is not None and payload["step"] != int(step):
            continue
        fl = obs_flight.get_recorder()
        if fl is not None:
            fl.record(spans.FL_CKPT_LINEAGE, step=int(payload["step"]),
                      party="server", lineage=int(payload["lineage"]),
                      source=name)
        return payload
    return None


def joint_state(**named_states: Any) -> Dict[str, Any]:
    """Bundle per-party states into the single atomic checkpoint tree,
    e.g. ``joint_state(client=state_tree(client.state),
    server=state_tree(server.state), step=n)``: one save covers both
    halves."""
    return dict(named_states)
