"""``DevicePrefetch`` (``data/datasets.py``) and ``--prefetch`` on the CPU.

- the wrapper yields the plain iterator's sequence, as JAX's
  ``DevicePrefetch`` does over the same batches: ``x`` a copy staged on
  the device (a CPU tensor here), ``y`` passed through untouched;
- ``close()`` mid-epoch (and the context exit) stops the staging
  thread and joins it; a source exception reaches the consumer;
  ``depth`` 0 raises ``ValueError``; ``device="cuda"`` without a GPU
  raises, as every entry point does;
- ``SplitClientTrainer.train(prefetch=2)``, ``MultiClientSplitRunner.
  train_rounds(prefetch=2)`` and ``train --prefetch 2`` give the loss
  series of ``prefetch`` 0, bit for bit.
"""

import itertools
import json
import threading

import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import DevicePrefetch as JaxPrefetch
from split_learning_tpu_torch.data import DevicePrefetch, batches, synthetic
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    MultiClientSplitRunner, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

BATCH = 16


def _batches(n=6, seed=0):
    ds = synthetic("mnist", n_train=BATCH * n, n_test=8, seed=seed)
    return list(batches(ds.train, BATCH, seed=seed, drop_remainder=True))


def _threads():
    return {t for t in threading.enumerate() if t.name == "slt-prefetch"}


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_same_sequence_as_the_plain_iterator(depth):
    data = _batches()
    before = _threads()
    with DevicePrefetch(iter(data), depth=depth, device="cpu") as it:
        got = list(it)
    jax_got = list(JaxPrefetch(iter(data), depth=depth))
    assert len(got) == len(data) == len(jax_got)
    for (x, y), (x0, y0), (xj, yj) in zip(got, data, jax_got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert np.array_equal(x.numpy(), x0)
        assert np.array_equal(np.asarray(xj), x.numpy())
        assert y is y0            # labels are not staged
        assert not np.shares_memory(x.numpy(), x0)   # a staged copy
    assert _threads() == before


def test_close_mid_epoch_joins_the_thread():
    before = _threads()
    source = ((np.full((2, 3), i, np.float32), i) for i in itertools.count())
    pf = DevicePrefetch(source, depth=2, device="cpu")
    assert next(pf)[1] == 0 and next(pf)[1] == 1
    assert pf._thread.is_alive()     # parked on a full queue
    pf.close()
    assert not pf._thread.is_alive()
    assert _threads() == before
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()   # idempotent
    # a consumer that breaks out of a with-block joins it too
    with DevicePrefetch(iter(_batches()), depth=1, device="cpu") as it:
        for _ in it:
            break
    assert not it._thread.is_alive()


def test_source_exception_reaches_the_consumer():
    def source():
        yield np.zeros((1, 2), np.float32), 0
        raise KeyError("bad shard")
    pf = DevicePrefetch(source(), depth=2, device="cpu")
    assert next(pf)[1] == 0
    with pytest.raises(KeyError, match="bad shard"):
        next(pf)
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("depth", [0, -1])
def test_depth_below_one_raises(depth):
    with pytest.raises(ValueError, match="depth must be >= 1"):
        DevicePrefetch(iter([]), depth=depth, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this machine has a GPU")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DevicePrefetch(iter([]), depth=2)


def _client(compress="int8"):
    plan = get_plan(mode="split")
    cfg = Config(mode="split", batch_size=BATCH, lr=0.02)
    server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return SplitClientTrainer(plan, cfg, torch.Generator().manual_seed(0),
                              LocalTransport(server, compress=compress),
                              device="cpu")


def test_split_client_train_with_prefetch_is_bit_equal():
    data = _batches()
    runs = {}
    for prefetch in (0, 2):
        client = _client()
        recs = client.train(lambda: iter(data), epochs=2, prefetch=prefetch)
        runs[prefetch] = [(r.step, r.epoch, r.loss) for r in recs]
    assert runs[2] == runs[0]
    assert len(runs[0]) == 2 * len(data)


def test_runner_train_rounds_with_prefetch_is_bit_equal():
    plan = get_plan(mode="split")
    cfg = Config(mode="split", batch_size=BATCH, lr=0.02)
    before = _threads()
    runs = {}
    for prefetch in (0, 2):
        server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        runner = MultiClientSplitRunner(
            plan, cfg, torch.Generator().manual_seed(0),
            lambda i: LocalTransport(server), num_clients=2,
            sync_bottoms_every=2, device="cpu")
        shards = [_batches(4, seed=i) for i in range(2)]
        runs[prefetch] = runner.train_rounds(shards, rounds=3,
                                             prefetch=prefetch)
        runner.close()
    assert runs[2] == runs[0] and len(runs[0]) == 3
    assert _threads() == before   # the wrappers were joined


def test_cli_prefetch_gives_the_same_loss_series(tmp_path, capsys):
    series = {}
    for prefetch in ("0", "2"):
        data_dir = tmp_path / f"d{prefetch}"
        rc = main(["train", "--device", "cpu", "--transport", "local",
                   "--compress", "int8", "--dataset", "synthetic",
                   "--batch-size", str(BATCH), "--steps", "6",
                   "--data-dir", str(data_dir), "--tracking", "jsonl",
                   "--prefetch", prefetch])
        assert rc == 0, capsys.readouterr().err
        recs = [json.loads(line) for line in
                (data_dir / "metrics" / "Split_Learning_Sim.jsonl")
                .read_text().splitlines()]
        series[prefetch] = [r["value"] for r in recs if r.get("key") == "loss"]
    assert len(series["0"]) == 6 and series["2"] == series["0"]
    assert "--prefetch" not in capsys.readouterr().err
