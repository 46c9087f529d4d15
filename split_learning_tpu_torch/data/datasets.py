"""Datasets (counterpart of ``split_learning_tpu/data/datasets.py``).

A numpy copy of the parts the fused trainer uses, so that the port never
imports the JAX package: the :class:`Split`/:class:`Dataset` records,
the cache store protocol with its local backend, the MNIST IDX readers,
the seeded synthetic generator, the cache-first :func:`load_dataset`,
and the seeded batcher. The same seeds give the same bytes as the JAX
package, and the cache keys are the same, so both packages share a
cache directory. Arrays are NHWC float32, normalised like the reference.

Not ported yet: the S3 store, the downloader and device prefetch
(ROADMAP item 13), and the CIFAR-10 and token datasets, which serve the
other model families (ROADMAP item 20).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


@dataclasses.dataclass
class Split:
    x: np.ndarray  # [N, H, W, C] float32, normalized
    y: np.ndarray  # [N] int64

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


# --------------------------------------------------------------------- #
# synthetic fallback (zero-egress environments)

_SHAPES = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}


def synthetic(name: str, n_train: int = 4096, n_test: int = 512,
              num_classes: int = 10, seed: int = 0) -> Dataset:
    """Class-conditional Gaussian images, deterministic, learnable."""
    h, w, c = _SHAPES.get(name, (28, 28, 1))
    rs = np.random.RandomState(seed)
    centers = rs.randn(num_classes, h * w * c).astype(np.float32)

    def make(n: int, rs: np.random.RandomState) -> Split:
        y = rs.randint(0, num_classes, (n,)).astype(np.int64)
        x = centers[y] + 0.5 * rs.randn(n, h * w * c).astype(np.float32)
        return Split(x.reshape(n, h, w, c), y)

    return Dataset(train=make(n_train, rs), test=make(n_test, rs),
                   name=name, num_classes=num_classes, synthetic=True)


# --------------------------------------------------------------------- #
# the cache-first load path

def load_dataset(name: str, data_dir: str,
                 store: Optional[DatasetStore] = None,
                 allow_synthetic: bool = True) -> Dataset:
    """Probe the store; on a hit fetch the prepared blob; on a miss build
    from raw files (or synthesize) and put the blob for next time.
    Real and synthetic data use distinct cache keys."""
    if name in ("cifar10", "tokens", "lm"):
        raise NotImplementedError(
            f"dataset {name!r} serves model families the port has not "
            "reached yet (ROADMAP item 20)")
    if name not in ("mnist", "synthetic"):
        raise ValueError(f"Unknown dataset: {name!r}")
    if store is None:
        store = LocalStore(os.path.join(data_dir, "cache"))
    real_key = f"datasets/{name}.npz"
    synth_key = f"datasets/{name}-synthetic.npz"

    if store.exists(real_key):
        return _from_blob(name, store.fetch(real_key))
    ds = load_mnist_idx(data_dir) if name == "mnist" else None
    if ds is not None:
        store.put(real_key, _to_blob(ds))
        return ds
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no raw {name} files under {data_dir} and synthetic "
            "fallback disabled")
    if store.exists(synth_key):
        return _from_blob(name, store.fetch(synth_key))
    ds = synthetic("mnist")
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
