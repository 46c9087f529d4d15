"""The port's ``runtime/checkpoint.py`` on the CPU, beside JAX's.

- ``Checkpointer``: a save returns before its write (a slowed writer
  stub), every read barriers on it, ``close`` drains, ``max_to_keep``
  retention, ``restore_raw`` of an empty directory raises
  ``FileNotFoundError``;
- the snapshot: parameters and moments updated in place right after
  ``save()`` (as the SGD kernel and Adam's ``_foreach`` ops update them)
  do not reach the checkpoint;
- a write torn before its rename is never read, and its error reaches
  the next barrier;
- the launcher's ``_ckpt_drain`` barriers on the error path and the
  clean path;
- the runtime-extras sidecar across frameworks: one the port writes
  passes JAX's ``extras_valid``/``read_latest_extras`` and decodes to the
  same replay entries and residuals, and the reverse;
- the replay cache's export/restore round trip, and
  ``ServerRuntime.resume_from`` with a matching, stale or missing
  sidecar (JAX's ``test_resume_restores_replay_cache_from_extras``), the
  wire's EF ledger with it;
- a JAX (Orbax) checkpoint directory refused with rc 2 by ``train
  --resume``, ``serve``, ``eval`` and ``generate``, and by the
  ``Checkpointer`` itself;
- ``resume_from`` on the U server (its residuals dropped, the handshake
  re-armed) and the federated server (its partial round dropped); a
  bf16 LM's ``pos`` table that a weighted FedAvg round made float32
  restores float32, its moments with it.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from split_learning_tpu.runtime import checkpoint as jax_ckpt
from split_learning_tpu_torch.launch.run import _ckpt_drain, main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    FusedSplitTrainer, ServerRuntime, state_tree)
from split_learning_tpu_torch.runtime import checkpoint as ckpt
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.transport import codec
from split_learning_tpu_torch.utils.config import Config

BATCH = 8


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(BATCH, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, (BATCH,)).astype(np.int64))


def _trainer(**cfg):
    plan = get_plan(mode="split")
    return FusedSplitTrainer(plan, Config(batch_size=BATCH, transport="fused",
                                          **cfg),
                             torch.Generator().manual_seed(0),
                             np.zeros((1, 28, 28, 1), np.float32),
                             device="cpu")


def _slow_writes(monkeypatch, seconds, calls=None):
    orig = ckpt.Checkpointer._write

    def slow(self, job):
        time.sleep(seconds)
        orig(self, job)
        if calls is not None:
            calls.append(("written", job.step))
    monkeypatch.setattr(ckpt.Checkpointer, "_write", slow)


def _count_waits(monkeypatch, ck, calls):
    orig = ck.wait_until_finished

    def wait():
        calls.append("wait")
        orig()
    monkeypatch.setattr(ck, "wait_until_finished", wait)


def test_save_is_async_and_reads_barrier(tmp_path, monkeypatch):
    calls = []
    _slow_writes(monkeypatch, 0.3, calls)
    ck = ckpt.Checkpointer(str(tmp_path / "async"))
    _count_waits(monkeypatch, ck, calls)
    t0 = time.perf_counter()
    ck.save(1, {"w": torch.ones(8)})
    assert time.perf_counter() - t0 < 0.2, "save() waited for its write"
    assert calls == []
    assert ck.latest_step() == 1
    assert calls == [("written", 1), "wait"] or calls[:2] == [
        "wait", ("written", 1)]
    calls.clear()
    assert torch.equal(ck.restore_raw(step=1)["w"], torch.ones(8))
    assert "wait" in calls
    calls.clear()
    ck.save(2, {"w": torch.zeros(8)})
    ck.close()
    assert "wait" in calls and ("written", 2) in calls
    assert ck.all_steps() == [1, 2]


def test_retention_keeps_the_newest_three(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path / "keep"))
    for step in range(1, 6):
        ck.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert ck.all_steps() == [3, 4, 5]
    assert ck.restore_raw()["step"] == 5
    assert not ck.save_once(5, {"step": 0})  # the last enqueued step
    ck.close()


def test_empty_directory_has_no_step(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path / "empty"))
    assert ck.latest_step() is None and ck.all_steps() == []
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore_raw()
    with pytest.raises(FileNotFoundError):
        ck.restore_raw(step=3)
    ck.close()


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_snapshot_is_isolated_from_in_place_updates(tmp_path, monkeypatch,
                                                    optimizer):
    """The save's values are the ones at save(): an in-place update
    right after it, and optimizer steps while the write is still queued
    behind a slow writer, never reach the disk."""
    _slow_writes(monkeypatch, 0.2)
    cfg = (dict(momentum=0.9) if optimizer == "sgd"
           else dict(optimizer="adamw", lr=1e-3, weight_decay=0.1))
    tr = _trainer(**cfg)
    x, y = _batch()
    tr.train_step(x, y)
    want = [t.clone() for t in ckpt._tensors(state_tree(tr.state), [])]
    ck = ckpt.Checkpointer(str(tmp_path / "snap"))
    ck.save(1, {"trainer": tr.state})
    with torch.no_grad():
        for p in tr.state.params[0].values():
            p.add_(1.0)
    for _ in range(2):
        tr.train_step(x, y)
    raw = ck.restore_raw(1)["trainer"]
    got = ckpt._tensors(raw, [])
    assert len(got) == len(want) > 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"leaf {i} moved after save()"
    assert raw["step"] == 1
    # and it restores into a live trainer, in place
    tr2 = _trainer(**cfg)
    ck.restore({"trainer": tr2.state}, 1)
    for a, b in zip(ckpt._tensors(state_tree(tr2.state), []), want):
        assert torch.equal(a, b)
    assert tr2.state.step == 1
    ck.close()


def test_torn_write_is_never_read(tmp_path, monkeypatch):
    ck = ckpt.Checkpointer(str(tmp_path / "torn"))
    ck.save(1, {"w": torch.ones(3)})
    assert ck.latest_step() == 1
    real = os.replace

    def crash(src, dst):
        if os.path.basename(dst) == "2":
            raise OSError("crash before the rename")
        real(src, dst)
    monkeypatch.setattr(ckpt.os, "replace", crash)
    ck.save(2, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="before the rename"):
        ck.wait_until_finished()
    monkeypatch.setattr(ckpt.os, "replace", real)
    # the half-written step stays a temporary directory nobody reads
    leftovers = [n for n in os.listdir(ck.directory)
                 if n.startswith(ckpt._TMP_PREFIX)]
    assert leftovers
    with open(os.path.join(ck.directory, leftovers[0], ckpt.STATE_FILE),
              "wb") as f:
        f.write(b"torn")
    assert ck.latest_step() == 1
    assert torch.equal(ck.restore_raw()["w"], torch.ones(3))
    ck2 = ckpt.Checkpointer(ck.directory)  # a restart sees the same
    assert ck2.all_steps() == [1]
    ck.close()
    ck2.close()


def test_ckpt_drain_barriers_on_every_exit_path(tmp_path, monkeypatch):
    calls = []
    _slow_writes(monkeypatch, 0.05)
    ck = ckpt.Checkpointer(str(tmp_path / "slow"))
    _count_waits(monkeypatch, ck, calls)
    with pytest.raises(RuntimeError, match="mid-epoch"):
        with _ckpt_drain(ck):
            ck.save(1, {"w": torch.ones(4)})
            raise RuntimeError("mid-epoch failure")
    assert "wait" in calls, "error exit must drain in-flight saves"
    assert ck.all_steps() == [1]
    calls.clear()
    with _ckpt_drain(ck):
        ck.save(2, {"w": torch.zeros(4)})
    assert "wait" in calls, "clean exit must drain in-flight saves"
    assert ck.latest_step() == 2
    ck.close()
    with _ckpt_drain(None):  # no --checkpoint-dir: a no-op
        pass


def _replay_and_ledger():
    """A replay cache with a body-carrying entry and a ledger with a
    residual, both of the port, and what they export."""
    cache = ReplayCache()
    grads = np.arange(6, dtype=np.float32).reshape(2, 3)
    cache.put(0, "split_step", 4, (grads, 1.25))
    cache.attach_body(0, "split_step", 4, b"\x01wire-reply")
    ef = codec.make_wire_ef("topk8")
    ef.compress((0, "/forward_pass"), np.linspace(-1, 1, 40,
                                                  dtype=np.float32), 0.1)
    return cache.export_state(), ef.export_state()


def test_sidecar_written_by_the_port_is_read_by_jax(tmp_path):
    replay, wire_ef = _replay_and_ledger()
    payload = ckpt.build_extras(5, 3, replay=replay, wire_ef=wire_ef)
    ckpt.write_extras(str(tmp_path), payload)
    got = jax_ckpt.read_latest_extras(str(tmp_path), step=5)
    assert got is not None and jax_ckpt.extras_valid(got)
    assert got == payload
    rep = jax_ckpt.decode_obj(got["replay"])
    assert rep[0]["key"] == [0, "split_step", 4]
    assert rep[0]["body"] == b"\x01wire-reply"
    np.testing.assert_array_equal(rep[0]["result"][0],
                                  replay[0]["result"][0])
    ledger = jax_ckpt.decode_obj(got["wire_ef"])
    np.testing.assert_array_equal(ledger[0]["res"], wire_ef[0]["res"])
    assert jax_ckpt.read_latest_extras(str(tmp_path), step=4) is None


def test_sidecar_written_by_jax_is_read_by_the_port(tmp_path):
    replay, wire_ef = _replay_and_ledger()
    payload = jax_ckpt.build_extras(7, 2, replay=replay, wire_ef=wire_ef)
    jax_ckpt.write_extras(str(tmp_path), payload)
    # a newer torn sidecar and a stale one are skipped
    (tmp_path / ckpt.extras_name(9, 1)).write_text('{"version": 1, "st')
    ckpt.write_extras(str(tmp_path), ckpt.build_extras(6, 1))
    got = ckpt.read_latest_extras(str(tmp_path), step=7)
    assert got == payload and ckpt.extras_valid(got)
    assert ckpt.read_latest_extras(str(tmp_path))["step"] == 7
    cache = ReplayCache()
    cache.restore_state(ckpt.decode_obj(got["replay"]))
    assert cache.get_body(0, "split_step", 4) == b"\x01wire-reply"
    res, loss = cache.get(0, "split_step", 4)
    assert loss == 1.25
    np.testing.assert_array_equal(res, replay[0]["result"][0])
    tampered = dict(got, lineage=3)
    assert not ckpt.extras_valid(tampered)
    assert not jax_ckpt.extras_valid(tampered)


def test_replay_cache_export_restore_round_trip():
    cache = ReplayCache(window=2)
    for step in range(3):
        cache.put(1, "u_forward", step, np.full(2, step, np.float32))
        cache.attach_body(1, "u_forward", step, bytes([step]))
    entry, owner = cache.begin(1, "u_backward", 2)  # pending: not exported
    assert owner
    exported = cache.export_state()
    assert [e["key"] for e in exported] == [[1, "u_forward", 1],
                                            [1, "u_forward", 2]]
    blob = ckpt.decode_obj(ckpt.encode_obj(exported))
    again = ReplayCache(window=2)
    again.put(9, "split_step", 0, "stale")
    again.restore_state(blob)
    assert not again.contains(9, "split_step", 0)
    assert again.lookup(1, "u_forward", 2) == (b"\x02", None)
    assert again.get_body(1, "u_forward", 1) == b"\x01"
    assert not again.contains(1, "u_forward", 0)   # aged out before export
    np.testing.assert_array_equal(again.get(1, "u_forward", 2),
                                  np.full(2, 2, np.float32))
    again.clear()
    assert again.counters()["replay_cache_size"] == 0


def _server(seed=0, **cfg):
    return ServerRuntime(get_plan(mode="split"),
                         Config(mode="split", batch_size=BATCH, **cfg),
                         torch.Generator().manual_seed(seed), device="cpu")


def test_resume_restores_replay_cache_and_ledger_from_extras(tmp_path):
    x, y = _batch()
    rt = _server()
    acts = torch.randn(BATCH, 26, 26, 32,
                       generator=torch.Generator().manual_seed(1)).numpy()
    grads, loss = rt.split_step(acts, y, 0)
    rt.attach_reply_body(0, "split_step", 0, b"\x01wire-reply")
    rt.wire_ef.compress((0, "/forward_pass"), grads, 0.1)
    residual = np.asarray(rt.wire_ef.residual((0, "/forward_pass")))
    state = state_tree(rt.export_state())
    payload = rt.export_runtime_extras(1)
    assert payload["lineage"] == 1
    ckpt.write_extras(str(tmp_path), payload)

    rt2 = _server(seed=1)
    rt2.resume_from(state, 1,
                    extras=ckpt.read_latest_extras(str(tmp_path), step=1))
    assert rt2.replay_lookup(0, "split_step", 0)[0] == b"\x01wire-reply"
    np.testing.assert_array_equal(
        rt2.wire_ef.residual((0, "/forward_pass")), residual)
    for a, b in zip(rt.params.values(), rt2.params.values()):
        assert torch.equal(a, b)
    assert rt2.health()["step"] == 0
    assert rt2.export_runtime_extras(2)["lineage"] == 2  # monotonic
    # a new step below the floor is refused; the next one is accepted
    with pytest.raises(Exception, match="non-monotonic"):
        rt2.split_step(acts, y, 0, client_id=3)
    rt2.split_step(acts, y, 1)

    rt3 = _server(seed=2)   # a stale sidecar: cleared
    rt3.resume_from(state, 5, extras=ckpt.read_latest_extras(str(tmp_path)))
    assert rt3.replay_lookup(0, "split_step", 0) == (None, None)
    assert rt3.wire_ef.residual((0, "/forward_pass")) is None
    rt4 = _server(seed=3)   # no sidecar: cleared
    rt4.resume_from(state, 1)
    assert rt4.replay_lookup(0, "split_step", 0) == (None, None)


def _jax_checkpoint_dir(path):
    """An Orbax step directory and JAX's meta.json, as JAX's CLI leaves
    them."""
    import json
    c = jax_ckpt.Checkpointer(str(path))
    c.save(3, {"client": {"params": {"w": np.zeros(2)}}})
    c.close()
    with open(path / "meta.json", "w") as f:
        json.dump({"layout": "fused", "mode": "split",
                   "model": "transformer_lm", "dataset": "lm"}, f)
    return str(path)


def test_jax_checkpoint_directory_refused(tmp_path, capsys):
    jdir = _jax_checkpoint_dir(tmp_path / "jax")
    before = sorted(os.listdir(jdir))
    with pytest.raises(ckpt.ForeignCheckpointError, match="JAX checkpoint"):
        ckpt.Checkpointer(jdir)
    data = ["--device", "cpu", "--data-dir", str(tmp_path / "d")]
    runs = (["train", "--checkpoint-dir", jdir, "--resume", "--steps", "1",
             "--dataset", "synthetic", *data],
            ["serve", "--checkpoint-dir", jdir, "--resume", "--port", "0",
             "--model", "transformer_lm", "--dataset", "lm", *data],
            ["eval", "--checkpoint-dir", jdir, *data],
            ["generate", "--checkpoint-dir", jdir, "--prompt", "1,2", *data])
    for argv in runs:
        assert main(argv) == 2, argv[0]
        err = capsys.readouterr().err
        assert err.startswith("[error] ") and "JAX checkpoint" in err, err
    assert sorted(os.listdir(jdir)) == before  # nothing written into it
    # an Orbax step directory alone (no meta.json) is refused too
    os.remove(os.path.join(jdir, "meta.json"))
    assert "Orbax step 3" in ckpt.foreign_checkpoint(jdir)


def test_checkpointer_saves_from_threads(tmp_path):
    """Saves enqueued from several threads all land (the server saves
    from its HTTP handler threads)."""
    ck = ckpt.Checkpointer(str(tmp_path / "threads"), max_to_keep=10)
    threads = [threading.Thread(target=ck.save,
                                args=(i, {"w": torch.full((3,), i)}))
               for i in range(1, 7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ck.all_steps() == list(range(1, 7))
    for i in range(1, 7):
        assert torch.equal(ck.restore_raw(i)["w"],
                           torch.full((3,), i, dtype=torch.int64))
    ck.close()


def test_resume_rearms_the_u_and_federated_servers():
    """``resume_from`` on the U server drops its pending residuals and
    re-arms the handshake (the next accepted hop is at the restored step
    or later; ``/health`` reports the step before it); on the federated
    server it drops the partial FedAvg round."""
    from split_learning_tpu_torch.runtime.party import ProtocolError
    u = ServerRuntime(get_plan(mode="u_split"),
                      Config(mode="u_split", batch_size=2),
                      torch.Generator().manual_seed(0), device="cpu")
    acts = np.zeros((2, 26, 26, 32), np.float32)
    u.u_forward(acts, 0)
    assert u._u_residual
    u.resume_from(state_tree(u.export_state()), 3)
    assert not u._u_residual and u.health()["step"] == 2
    with pytest.raises(ProtocolError, match="non-monotonic"):
        u.u_forward(acts, 2, client_id=1)
    u.u_forward(acts, 3)
    fed = ServerRuntime(get_plan(mode="federated"),
                        Config(mode="federated", num_clients=2),
                        torch.Generator().manual_seed(0), device="cpu")
    fed._agg._pending.append((object(), {}, None))   # half a round
    fed.resume_from(state_tree(fed.export_state()), 5)
    assert fed._agg._pending == [] and fed._agg.num_clients == 2
    assert fed.health()["step"] == 4


def test_restore_keeps_a_promoted_leaf_float32(tmp_path):
    """A bf16 LM whose ``pos`` table a weighted FedAvg round made float32
    (and whose Adam moments followed it) restores into a fresh bf16
    trainer with ``pos`` and its moments float32, and both trainers
    then take the same step."""
    from split_learning_tpu_torch.data import synthetic_lm
    from split_learning_tpu_torch.runtime.state import adopt_params
    plan = get_plan(model="transformer_lm", vocab=32, d_model=16,
                    num_heads=2, client_depth=1, server_depth=1,
                    max_len=16, dtype="bfloat16")
    cfg = Config(transport="fused", model="transformer_lm", batch_size=2,
                 dtype="bfloat16", optimizer="adamw", lr=1e-3,
                 weight_decay=0.1, warmup_steps=1, decay_steps=4)
    ds = synthetic_lm(n_train=6, n_test=2, vocab=32, seq_len=8)
    data = [(ds.train.x[i:i + 2], ds.train.y[i:i + 2]) for i in (0, 2, 4)]

    def trainer(seed):
        return FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(
            seed), data[0][0], device="cpu")

    a = trainer(0)
    a.train_step(*data[0])
    mean = [{k: v.detach().float() if k == "pos" else v.detach()
             for k, v in stage.items()} for stage in a.state.params]
    adopt_params(a.state, mean, torch.device("cpu"))
    a.train_step(*data[1])
    ck = ckpt.Checkpointer(str(tmp_path / "promoted"))
    ck.save(2, a.export_states())
    b = trainer(1)
    assert b.state.params[0]["pos"].dtype == torch.bfloat16
    b.restore_states(ck.restore_raw(2))
    ck.close()
    idx = list(b.state.params[0]).index("pos")
    for st in (a.state, b.state):
        assert st.params[0]["pos"].dtype == torch.float32
        assert st.opt_state[0][idx].dtype == torch.float32
    assert a.train_step(*data[2]) == b.train_step(*data[2])
