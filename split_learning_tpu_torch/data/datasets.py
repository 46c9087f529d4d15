"""Datasets (counterpart of ``split_learning_tpu/data/datasets.py``).

A numpy copy of the parts the fused trainer uses, so that the port never
imports the JAX package: the :class:`Split`/:class:`Dataset` records,
the cache store protocol with its local backend, the MNIST IDX readers,
the seeded synthetic generators (images, class-conditional tokens and
the causal-LM Markov chains), the cache-first :func:`load_dataset`, and
the seeded batcher. The same seeds give the same bytes as the JAX
package, and the cache keys are the same, so both packages share a
cache directory. Images are NHWC float32, normalised like the reference;
token inputs are ``[N, T] int32``.

Not ported yet: the S3 store, the downloader and device prefetch
(ROADMAP item 13), and CIFAR-10, which serves the ResNet and ViT
families (ROADMAP item 20).
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
    if name == "cifar10":
        raise NotImplementedError(
            "dataset 'cifar10' serves model families the port has not "
            "reached yet (ROADMAP item 20)")
    if name not in ("mnist", "synthetic", "tokens", "lm"):
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
    tkw = {} if seq_len is None else {"seq_len": seq_len}
    if name == "tokens":
        ds = synthetic_tokens(**tkw)
    elif name == "lm":
        ds = synthetic_lm(**tkw)
    else:
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
