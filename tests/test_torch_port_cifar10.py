"""The port's CIFAR-10 reader and the ``cifar10`` entry of
``load_dataset`` against the JAX package's, on the CPU.

No CIFAR-10 files are in the repository and nothing is downloaded: the
tests write the binary distribution's files themselves (a few records a
batch: 1 label byte and 3072 CHW pixel bytes each, from a seed) in the
three forms the readers take (the files in the data directory, under
``cifar-10-batches-bin/``, and ``cifar-10-binary.tar.gz``). The port's
arrays must be JAX's bit for bit; a cache blob written by either package
loads in the other under the same keys; without raw files both
synthesise the same 32x32x3 bytes.
"""

import io
import tarfile

import numpy as np
import pytest

from split_learning_tpu.data import datasets as jds
from split_learning_tpu_torch.data import datasets as tds

BATCHES = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]


def _records(rs, n):
    labels = rs.randint(0, 10, (n, 1), dtype=np.uint8)
    pixels = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
    return np.concatenate([labels, pixels], axis=1).tobytes()


def _files(seed=0):
    rs = np.random.RandomState(seed)
    return {name: _records(rs, 3 + i) for i, name in enumerate(BATCHES)}


def _write(root, form, files):
    if form == "dir":
        for name, raw in files.items():
            (root / name).write_bytes(raw)
    elif form == "subdir":
        (root / "cifar-10-batches-bin").mkdir()
        for name, raw in files.items():
            (root / "cifar-10-batches-bin" / name).write_bytes(raw)
    else:
        with tarfile.open(root / "cifar-10-binary.tar.gz", "w:gz") as tar:
            for name, raw in files.items():
                info = tarfile.TarInfo(f"cifar-10-batches-bin/{name}")
                info.size = len(raw)
                tar.addfile(info, io.BytesIO(raw))


def _assert_split_equal(a, b):
    assert a.x.dtype == b.x.dtype == np.float32
    assert a.y.dtype == b.y.dtype == np.int64
    assert a.x.shape == b.x.shape and a.x.tobytes() == b.x.tobytes()
    assert a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("form", ["dir", "subdir", "tar.gz"])
def test_binary_reader_bit_equal_to_jax(form, tmp_path):
    files = _files()
    _write(tmp_path, form, files)
    j = jds.load_cifar10_binary(str(tmp_path))
    t = tds.load_cifar10_binary(str(tmp_path))
    assert t.name == "cifar10" and t.num_classes == 10 and not t.synthetic
    assert t.train.x.shape == (3 + 4 + 5 + 6 + 7, 32, 32, 3)
    assert t.test.x.shape == (8, 32, 32, 3)
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    # NHWC from CHW records, normalised by the CIFAR-10 channel stats
    rec = np.frombuffer(files["test_batch.bin"], np.uint8).reshape(-1, 3073)
    pix = rec[0, 1:].reshape(3, 32, 32)
    want = (pix[:, 5, 7] / np.float32(255.0) - tds.CIFAR_MEAN) / tds.CIFAR_STD
    np.testing.assert_array_equal(t.test.x[0, 5, 7], want.astype(np.float32))
    assert t.test.y[0] == rec[0, 0]


def test_reader_gives_none_without_every_file(tmp_path):
    assert tds.load_cifar10_binary(str(tmp_path)) is None
    files = _files()
    del files["data_batch_3.bin"]
    _write(tmp_path, "tar.gz", files)
    assert tds.load_cifar10_binary(str(tmp_path)) is None
    assert jds.load_cifar10_binary(str(tmp_path)) is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_real_cache_blob_crosses_packages(writer, tmp_path):
    """``load_dataset`` reads the raw files once and caches them under
    ``datasets/cifar10.npz``; the other package loads that blob."""
    _write(tmp_path, "dir", _files(seed=1))
    first, second = (jds, tds) if writer == "jax" else (tds, jds)
    a = first.load_dataset("cifar10", str(tmp_path))
    assert (tmp_path / "cache" / "datasets" / "cifar10.npz").exists()
    for name in BATCHES:   # the blob, not the files, answers now
        (tmp_path / name).unlink()
    b = second.load_dataset("cifar10", str(tmp_path),
                            allow_synthetic=False)
    assert not a.synthetic and not b.synthetic
    _assert_split_equal(a.train, b.train)
    _assert_split_equal(a.test, b.test)


def test_synthetic_fallback_is_jax_bytes(tmp_path):
    """No raw files: both synthesise the same 32x32x3 images under
    ``datasets/cifar10-synthetic.npz``, and ``--require-real`` refuses."""
    t = tds.load_dataset("cifar10", str(tmp_path / "t"))
    j = jds.load_dataset("cifar10", str(tmp_path / "j"))
    assert t.synthetic and t.train.x.shape == (4096, 32, 32, 3)
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    assert (tmp_path / "t" / "cache" / "datasets" /
            "cifar10-synthetic.npz").exists()
    _assert_split_equal(jds.load_dataset("cifar10", str(tmp_path / "t"))
                        .train, t.train)
    with pytest.raises(FileNotFoundError):
        tds.load_dataset("cifar10", str(tmp_path / "empty"),
                         allow_synthetic=False)
