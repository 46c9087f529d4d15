"""The port's data path and CLI.

The dataset module is a numpy copy of the JAX package's, so the same
seeds must give the same bytes; the CLI's ``train`` runs end to end on
``--device cpu``.
"""

import gzip
import struct

import numpy as np
import pytest

from split_learning_tpu.data import datasets as jds
from split_learning_tpu_torch.data import datasets as tds


def _assert_split_equal(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.x.tobytes() == b.x.tobytes()
    assert a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_and_batches_byte_equal_to_jax(seed):
    j = jds.synthetic("mnist", n_train=300, n_test=40, seed=seed)
    t = tds.synthetic("mnist", n_train=300, n_test=40, seed=seed)
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    for kw in (dict(seed=seed), dict(seed=seed, drop_remainder=True),
               dict(shuffle=False)):
        jb = list(jds.batches(j.train, 64, **kw))
        tb = list(tds.batches(t.train, 64, **kw))
        assert len(tb) == len(jb)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            assert tx.tobytes() == jx.tobytes()
            assert ty.tobytes() == jy.tobytes()
    for drop in (False, True):
        assert tds.epoch_steps(300, 64, drop) == jds.epoch_steps(300, 64, drop)


def test_load_dataset_shares_the_jax_cache(tmp_path):
    """Same cache keys and blob format: the port reads what JAX wrote."""
    j = jds.load_dataset("synthetic", str(tmp_path))
    t = tds.load_dataset("synthetic", str(tmp_path))
    assert t.synthetic and t.num_classes == j.num_classes == 10
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    with pytest.raises(ValueError):
        tds.load_dataset("nope", str(tmp_path))
    # cifar10 (once refused, ROADMAP item 20): JAX's synthetic bytes under
    # JAX's key, which JAX's loader reads back
    t = tds.load_dataset("cifar10", str(tmp_path))
    assert t.synthetic and t.train.x.shape[1:] == (32, 32, 3)
    assert (tmp_path / "cache" / "datasets" / "cifar10-synthetic.npz"
            ).exists()
    j = jds.load_dataset("cifar10", str(tmp_path))
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)


def _write_idx(root, rs):
    def images(n):
        raw = rs.randint(0, 256, (n, 28, 28), dtype=np.uint8)
        return struct.pack(">IIII", 0x803, n, 28, 28) + raw.tobytes()

    def labels(n):
        raw = rs.randint(0, 10, (n,), dtype=np.uint8)
        return struct.pack(">II", 0x801, n) + raw.tobytes()

    (root / "train-images-idx3-ubyte.gz").write_bytes(
        gzip.compress(images(20)))
    (root / "train-labels-idx1-ubyte").write_bytes(labels(20))
    (root / "t10k-images-idx3-ubyte").write_bytes(images(6))
    (root / "t10k-labels-idx1-ubyte.gz").write_bytes(
        gzip.compress(labels(6)))


def test_mnist_idx_readers_match_jax(tmp_path):
    _write_idx(tmp_path, np.random.RandomState(0))
    j = jds.load_mnist_idx(str(tmp_path))
    t = tds.load_mnist_idx(str(tmp_path))
    assert t.train.x.shape == (20, 28, 28, 1) and not t.synthetic
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    assert tds.load_mnist_idx(str(tmp_path / "missing")) is None


def test_cli_train_on_cpu_prints_done_and_eval(tmp_path, capsys):
    from split_learning_tpu_torch.launch.run import main
    rc = main(["train", "--device", "cpu", "--steps", "3", "--dataset",
               "synthetic", "--batch-size", "16", "--eval",
               "--data-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[eval] accuracy=" in out and "n=512" in out
    done = [line for line in out.splitlines() if line.startswith("[done]")]
    assert len(done) == 1
    assert "mode=split transport=fused steps=3 final_loss=" in done[0]
    assert "steps/s)" in done[0]


def test_cli_rejects_unported_model(tmp_path, capsys):
    """ResNet-18's 4-stage plan builds, but its K-stage chain (``--stages
    4``) waits for ROADMAP item 16."""
    from split_learning_tpu_torch.launch.run import main
    rc = main(["train", "--device", "cpu", "--model", "resnet18_4stage",
               "--stages", "4", "--dataset", "cifar10", "--data-dir",
               str(tmp_path)])
    assert rc == 2
    assert "ROADMAP item 16" in capsys.readouterr().err


def test_cli_trains_resnet18_on_cpu(tmp_path, capsys):
    """``train --model resnet18 --dataset cifar10`` (once refused, ROADMAP
    item 20) runs on the CPU."""
    from split_learning_tpu_torch.launch.run import main
    rc = main(["train", "--device", "cpu", "--model", "resnet18",
               "--dataset", "cifar10", "--batch-size", "4", "--steps", "2",
               "--data-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mode=split transport=fused steps=2 final_loss=" in out
