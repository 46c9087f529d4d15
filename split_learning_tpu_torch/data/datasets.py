"""Datasets (counterpart of ``split_learning_tpu/data/datasets.py``).

A numpy copy of the parts the fused trainer uses, so that the port never
imports the JAX package: the :class:`Split`/:class:`Dataset` records,
the cache store protocol with its local backend, the MNIST IDX readers,
the seeded synthetic generators (images, class-conditional tokens and
the causal-LM Markov chains), the cache-first :func:`load_dataset`, and
the seeded batcher, and :class:`DevicePrefetch`, which stages the next
batches on the device while a step is in flight. The same seeds give
the same bytes as the JAX package, and the cache keys are the same, so
both packages share a cache directory. Images are NHWC float32,
normalised like the reference (MNIST) or by the CIFAR-10 channel means
and deviations (the binary distribution, read with numpy, no pickle);
token inputs are ``[N, T] int32``. Without raw files, ``cifar10``
synthesises 32x32x3 images as JAX does.

Not ported: the S3 store and the downloader (network).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import queue
import re
import struct
import tarfile
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


@dataclasses.dataclass
class Split:
    x: np.ndarray  # [N, H, W, C] float32, normalized; or [N, T] int32 ids
    y: np.ndarray  # [N] int64; [N, T] for the causal LM

    def __len__(self) -> int:
        return len(self.y)


@dataclasses.dataclass
class Dataset:
    train: Split
    test: Split
    name: str
    num_classes: int
    synthetic: bool = False


# --------------------------------------------------------------------- #
# stores

class DatasetStore:
    """Cache backend: probe / fetch / put of opaque blobs."""

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def fetch(self, key: str) -> bytes:
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError


class LocalStore(DatasetStore):
    """Filesystem cache (the off-cluster default)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.expanduser(root)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def fetch(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)


# --------------------------------------------------------------------- #
# npz blob codec for the cache (no pickle)

def _to_blob(ds: Dataset) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(
        buf, train_x=ds.train.x, train_y=ds.train.y,
        test_x=ds.test.x, test_y=ds.test.y,
        meta=np.array([ds.num_classes, int(ds.synthetic)], np.int64))
    return buf.getvalue()


def _from_blob(name: str, data: bytes) -> Dataset:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = z["meta"]
        return Dataset(
            train=Split(z["train_x"], z["train_y"]),
            test=Split(z["test_x"], z["test_y"]),
            name=name, num_classes=int(meta[0]), synthetic=bool(meta[1]))


# --------------------------------------------------------------------- #
# MNIST IDX readers

def _read_idx_images(raw: bytes) -> np.ndarray:
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    if magic != 0x803:
        raise ValueError(f"bad IDX image magic {magic:#x}")
    return np.frombuffer(raw, np.uint8, offset=16).reshape(n, rows, cols, 1)


def _read_idx_labels(raw: bytes) -> np.ndarray:
    magic, n = struct.unpack(">II", raw[:8])
    if magic != 0x801:
        raise ValueError(f"bad IDX label magic {magic:#x}")
    return np.frombuffer(raw, np.uint8, offset=8).astype(np.int64)


def _maybe_gunzip(raw: bytes) -> bytes:
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def load_mnist_idx(data_dir: str) -> Optional[Dataset]:
    """MNIST from IDX files under data_dir (optionally gzipped); None if
    any of the four is absent."""
    names = {
        "train_x": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "train_y": ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
        "test_x": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
        "test_y": ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
    }
    found: Dict[str, bytes] = {}
    for part, cands in names.items():
        for cand in cands:
            for suffix in ("", ".gz"):
                p = os.path.join(os.path.expanduser(data_dir), cand + suffix)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        found[part] = _maybe_gunzip(f.read())
                    break
            if part in found:
                break
        if part not in found:
            return None

    def norm(img: np.ndarray) -> np.ndarray:
        x = img.astype(np.float32) / 255.0
        return (x - MNIST_MEAN) / MNIST_STD

    return Dataset(
        train=Split(norm(_read_idx_images(found["train_x"])),
                    _read_idx_labels(found["train_y"])),
        test=Split(norm(_read_idx_images(found["test_x"])),
                   _read_idx_labels(found["test_y"])),
        name="mnist", num_classes=10)


def load_cifar10_binary(data_dir: str) -> Optional[Dataset]:
    """CIFAR-10 from the binary distribution under ``data_dir``:
    ``data_batch_1..5.bin`` and ``test_batch.bin`` (in ``data_dir`` or
    its ``cifar-10-batches-bin/``), or ``cifar-10-binary.tar.gz``; None
    if absent. Records are 1 label byte and 3072 CHW pixel bytes."""
    root = os.path.expanduser(data_dir)
    bin_dir = None
    for cand in (root, os.path.join(root, "cifar-10-batches-bin")):
        if os.path.exists(os.path.join(cand, "data_batch_1.bin")):
            bin_dir = cand
            break
    raws: Dict[str, bytes] = {}
    if bin_dir is not None:
        for i in range(1, 6):
            with open(os.path.join(bin_dir, f"data_batch_{i}.bin"), "rb") as f:
                raws[f"b{i}"] = f.read()
        with open(os.path.join(bin_dir, "test_batch.bin"), "rb") as f:
            raws["test"] = f.read()
    else:
        tar_path = os.path.join(root, "cifar-10-binary.tar.gz")
        if not os.path.exists(tar_path):
            return None
        with tarfile.open(tar_path, "r:gz") as tar:
            for m in tar.getmembers():
                base = os.path.basename(m.name)
                match = re.fullmatch(r"data_batch_(\d)\.bin", base)
                if match:
                    raws[f"b{match.group(1)}"] = tar.extractfile(m).read()
                elif base == "test_batch.bin":
                    raws["test"] = tar.extractfile(m).read()
        if len(raws) != 6:
            return None

    def parse(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
        rec = np.frombuffer(raw, np.uint8).reshape(-1, 3073)
        y = rec[:, 0].astype(np.int64)
        x = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x = x.astype(np.float32) / 255.0
        return (x - CIFAR_MEAN) / CIFAR_STD, y

    xs, ys = zip(*(parse(raws[f"b{i}"]) for i in range(1, 6)))
    tx, ty = parse(raws["test"])
    return Dataset(
        train=Split(np.concatenate(xs), np.concatenate(ys)),
        test=Split(tx, ty), name="cifar10", num_classes=10)


# --------------------------------------------------------------------- #
# synthetic fallback (zero-egress environments)

_SHAPES = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}


def image_shape(name: str) -> Tuple[int, int, int]:
    """``(H, W, C)`` of an image dataset's examples (``synthetic`` is
    MNIST-shaped)."""
    return _SHAPES.get(name, _SHAPES["mnist"])


def synthetic(name: str, n_train: int = 4096, n_test: int = 512,
              num_classes: int = 10, seed: int = 0) -> Dataset:
    """Class-conditional Gaussian images, deterministic, learnable."""
    h, w, c = image_shape(name)
    rs = np.random.RandomState(seed)
    centers = rs.randn(num_classes, h * w * c).astype(np.float32)

    def make(n: int, rs: np.random.RandomState) -> Split:
        y = rs.randint(0, num_classes, (n,)).astype(np.int64)
        x = centers[y] + 0.5 * rs.randn(n, h * w * c).astype(np.float32)
        return Split(x.reshape(n, h, w, c), y)

    return Dataset(train=make(n_train, rs), test=make(n_test, rs),
                   name=name, num_classes=num_classes, synthetic=True)


def _categorical_rows(rs: np.random.RandomState, rows: int, cols: int,
                      sharpness: float) -> np.ndarray:
    """[rows, cols] row-stochastic matrix from sharpened random logits."""
    logits = sharpness * rs.randn(rows, cols)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    return probs / probs.sum(axis=1, keepdims=True)


_TOKEN_SEQ_LEN = 64   # the token generators' default sequence length


def synthetic_tokens(name: str = "tokens", n_train: int = 4096,
                     n_test: int = 512, num_classes: int = 10,
                     vocab: int = 256, seq_len: int = _TOKEN_SEQ_LEN,
                     seed: int = 0) -> Dataset:
    """Class-conditional token sequences for the transformer classifier:
    class k draws its tokens from a k-specific categorical distribution.
    ``x`` is ``[N, T] int32``, ``y`` ``[N] int64``."""
    rs = np.random.RandomState(seed)
    probs = _categorical_rows(rs, num_classes, vocab, sharpness=2.0)

    def make(n: int, rs: np.random.RandomState) -> Split:
        y = rs.randint(0, num_classes, (n,)).astype(np.int64)
        x = np.stack([rs.choice(vocab, size=seq_len, p=probs[k])
                      for k in y]).astype(np.int32)
        return Split(x, y)

    return Dataset(train=make(n_train, rs), test=make(n_test, rs),
                   name=name, num_classes=num_classes, synthetic=True)


def synthetic_lm(name: str = "lm", n_train: int = 4096, n_test: int = 512,
                 vocab: int = 256, seq_len: int = _TOKEN_SEQ_LEN,
                 seed: int = 0) -> Dataset:
    """First-order Markov chains for the causal LM: a fixed random
    transition matrix generates sequences and ``y`` is ``x`` shifted by
    one. ``x`` is ``[N, T] int32``, ``y`` ``[N, T] int64``."""
    rs = np.random.RandomState(seed)
    cdf = np.cumsum(_categorical_rows(rs, vocab, vocab, sharpness=4.0),
                    axis=1)

    def make(n: int, rs: np.random.RandomState) -> Split:
        chain = np.zeros((n, seq_len + 1), np.int64)
        chain[:, 0] = rs.randint(0, vocab, n)
        for t in range(1, seq_len + 1):
            u = rs.rand(n, 1)
            chain[:, t] = np.argmax(cdf[chain[:, t - 1]] > u, axis=1)
        return Split(chain[:, :seq_len].astype(np.int32), chain[:, 1:])

    return Dataset(train=make(n_train, rs), test=make(n_test, rs),
                   name=name, num_classes=vocab, synthetic=True)


# --------------------------------------------------------------------- #
# the cache-first load path

def load_dataset(name: str, data_dir: str,
                 store: Optional[DatasetStore] = None,
                 allow_synthetic: bool = True,
                 seq_len: Optional[int] = None) -> Dataset:
    """Probe the store; on a hit fetch the prepared blob; on a miss build
    from raw files (or synthesize) and put the blob for next time.
    Real and synthetic data use distinct cache keys, and so does a token
    dataset at a ``seq_len`` other than the default 64."""
    if seq_len is not None and name not in ("tokens", "lm"):
        raise ValueError(
            f"seq_len applies to the token datasets only (got {name!r})")
    if seq_len is not None and seq_len <= 0:
        raise ValueError(f"seq_len must be positive (got {seq_len})")
    if name not in ("mnist", "cifar10", "synthetic", "tokens", "lm"):
        raise ValueError(f"Unknown dataset: {name!r}")
    if seq_len == _TOKEN_SEQ_LEN:
        seq_len = None   # the default length is the bare dataset
    if store is None:
        store = LocalStore(os.path.join(data_dir, "cache"))
    tkey = "" if seq_len is None else f"-t{seq_len}"
    real_key = f"datasets/{name}{tkey}.npz"
    synth_key = f"datasets/{name}-synthetic{tkey}.npz"

    if store.exists(real_key):
        return _from_blob(name, store.fetch(real_key))
    raw = {"mnist": load_mnist_idx, "cifar10": load_cifar10_binary}.get(name)
    ds = raw(data_dir) if raw is not None else None
    if ds is not None:
        store.put(real_key, _to_blob(ds))
        return ds
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no raw {name} files under {data_dir} and synthetic "
            "fallback disabled")
    if store.exists(synth_key):
        return _from_blob(name, store.fetch(synth_key))
    tkw = {} if seq_len is None else {"seq_len": seq_len}
    if name == "tokens":
        ds = synthetic_tokens(**tkw)
    elif name == "lm":
        ds = synthetic_lm(**tkw)
    else:
        ds = synthetic("mnist" if name == "synthetic" else name)
    store.put(synth_key, _to_blob(ds))
    return ds


# --------------------------------------------------------------------- #
# batcher = DataLoader(batch_size, shuffle=True)

def batches(split: Split, batch_size: int, seed: int = 0, *,
            shuffle: bool = True,
            drop_remainder: bool = False
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Seeded shuffling batcher. With drop_remainder=False the final
    partial batch is emitted."""
    n = len(split)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    stop = n - (n % batch_size) if drop_remainder else n
    for lo in range(0, stop, batch_size):
        sel = idx[lo:lo + batch_size]
        yield split.x[sel], split.y[sel]


def epoch_steps(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)


# --------------------------------------------------------------------- #
# device prefetch: batch k+1's host-to-device copy under step k

_DONE = object()  # end-of-stream marker on the prefetch queue


class DevicePrefetch:
    """Stage batch k+1 on the device while step k is in flight (JAX's
    ``DevicePrefetch``).

    Wraps any ``(x, y)`` batch iterator: a background thread pulls up to
    ``depth`` batches ahead and stages ``x`` on ``device``. On the card
    that is a pinned host copy, then ``.to(device, non_blocking=True)``
    on a side ``torch.cuda.Stream`` with an event recorded behind it;
    the consumer's stream waits on the event before it touches ``x``,
    and ``x`` is recorded on that stream (``record_stream``), so the
    caching allocator never hands its memory to the side stream early.
    On the CPU it is a plain copy, which is how the tests run it. Labels
    pass through untouched: they travel host-side over the wire.

    It yields exactly the plain iterator's sequence (the copy keeps the
    values; the queue is FIFO), and :meth:`close` (also the context
    exit) stops the thread and joins it, mid-epoch too; an exception of
    the source is raised on the consumer's thread. ``device`` defaults
    to ``"cuda"`` and raises without a GPU; ``depth < 1`` raises
    ``ValueError``."""

    def __init__(self, source: Iterable[Tuple[Any, Any]], depth: int = 2,
                 device: Any = "cuda") -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1 (got {depth})")
        from split_learning_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._stream = None
        if self.device.type == "cuda":
            import torch
            self._stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),),
            name="slt-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        # bounded waits only: a consumer that left early sets _stop and
        # drains, and this producer must notice instead of parking
        # forever on a full queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, x: Any) -> Tuple[Any, Any]:
        import torch
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        if self._stream is None:
            return t.clone(), None
        with torch.cuda.stream(self._stream):
            out = t.pin_memory().to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _run(self, it: Iterator[Tuple[Any, Any]]) -> None:
        try:
            for x, y in it:
                if self._stop.is_set():
                    return
                if not self._put((*self._stage(x), y)):
                    return
        except BaseException as exc:  # re-raised on the consumer thread
            self._exc = exc
        finally:
            self._put(_DONE)

    # -- iterator protocol --------------------------------------------- #
    def __iter__(self) -> "DevicePrefetch":
        return self

    def __next__(self) -> Tuple[Any, Any]:
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._finished = True
            self._thread.join(timeout=5.0)
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        x, ready, y = item
        if ready is not None:
            import torch
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            x.record_stream(stream)
        return x, y

    # -- lifecycle ----------------------------------------------------- #
    def close(self, timeout: float = 5.0) -> None:
        """Stop staging and join the thread. Safe at any point (a
        mid-epoch break included) and idempotent."""
        self._stop.set()
        self._finished = True
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                # drain: unblocks a producer parked on a full queue
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.02)

    def __enter__(self) -> "DevicePrefetch":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()
