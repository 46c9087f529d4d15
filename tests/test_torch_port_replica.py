"""The port's server replicas (``runtime/replica.py``) against JAX's,
case by case of tests/test_replica.py, on the CPU.

- ``rendezvous_pick`` picks JAX's replica for 1,000 client ids over
  several replica sets.
- The protocol legs drive a stub replica around a real ``ReplayCache``
  (JAX's stub, here over the port's cache and sidecar), the same
  scenario through JAX's group and the port's: a garbage duplicate after
  a kill is served the original reply and applied nowhere, a duplicate
  racing the kill blocks on the fence and is then served, the
  checkpoint handoff goes through the durable sidecar on disk (under
  ``SLT_LOCK_DEBUG=1``); the router counters equal JAX's.
- Real ``ServerRuntime`` replicas: ``maybe_replicate(..., 1)`` is the
  bare runtime, bit for bit; the FedAvg sync installs the mean of the
  replicas' parameters, within 1e-6 of JAX's ``fedavg_mean`` of the same
  trees (carried by ``interop``), and training goes on; the topk8 EF
  ledger moves on handoff (a clapping group moves none) while the
  duplicate is served bit for bit; a scale-up adopts a donor's
  parameters.
- The chain's replicated stages on ``--transport local`` train the bare
  chain's losses bit for bit (one hub client, one replica a stage takes
  its traffic), and JAX's refusals exit 2.
- Mixed pairs through the numpy ``Transport`` interface: a port client
  against a JAX ``ReplicaGroup`` and a JAX client against the port's,
  both killing a replica mid-run, track the bare JAX pair.
"""

import glob
import os
import threading

import jax
import numpy as np
import pytest
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ReplicaGroup as JaxGroup
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.runtime import rendezvous_pick as jax_pick
from split_learning_tpu.runtime.checkpoint import (
    build_extras as jax_build_extras)
from split_learning_tpu.runtime.replay import ReplayCache as JaxReplayCache
from split_learning_tpu.runtime.state import fedavg_mean as jax_fedavg_mean
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.launch.run import main
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    ReplicaGroup, ServerRuntime, SplitClientTrainer, maybe_replicate,
    rendezvous_pick)
from split_learning_tpu_torch.runtime.checkpoint import build_extras
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.runtime.state import adopt_params
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.transport import codec as wire_codec
from split_learning_tpu_torch.utils.config import Config

BATCH = 8


def _stub_class(cache_cls, extras):
    class Stub:
        """JAX's stub: a real replay cache decides ownership, only the
        owner applies, and the reply names the payload it applied."""

        def __init__(self, idx):
            self.idx = idx
            self.replay = cache_cls(window=16)
            self.applies = []

        def health(self):
            return {"step": len(self.applies), "status": "serving"}

        def split_step(self, payload, labels, step, client_id=0):
            entry, owner = self.replay.begin(client_id, "split_step", step)
            if not owner:
                return self.replay.wait(entry, timeout=30.0)
            self.applies.append((client_id, step, payload))
            value = ("reply", client_id, step, self.idx, payload)
            self.replay.resolve(entry, value)
            return value

        def flush_deferred(self):
            return 0

        def export_runtime_extras(self, step):
            return extras(step, 1, replay=self.replay.export_state(),
                          wire_ef=[])

        def close(self):
            pass
    return Stub


STUBS = {"port": (ReplicaGroup, _stub_class(ReplayCache, build_extras)),
         "jax": (JaxGroup, _stub_class(JaxReplayCache, jax_build_extras))}


def _reply(v):
    # the decoded sidecar turns the stub's tuple reply into a list
    return tuple(v)


@pytest.mark.parametrize("ids", [[0, 1, 2], [0, 2], [1, 3, 4, 7],
                                 list(range(8)), [5]])
def test_rendezvous_pick_is_jaxs(ids):
    assert [rendezvous_pick(c, ids) for c in range(1000)] == [
        jax_pick(c, ids) for c in range(1000)]
    with pytest.raises(ValueError):
        rendezvous_pick(0, [])


def test_assignment_sticky_and_minimal_churn():
    first = {c: rendezvous_pick(c, [0, 1, 2]) for c in range(256)}
    assert set(first.values()) == {0, 1, 2}
    for c in range(256):
        after = rendezvous_pick(c, [0, 2])
        assert after == first[c] if first[c] != 1 else after in (0, 2)
    cls, stub = STUBS["port"]
    group = cls([stub(i) for i in range(3)])
    assert [group.assignment(c) for c in range(64)] == [
        first[c] for c in range(64)]


def _garbage_dup(side):
    cls, stub = STUBS[side]
    group = cls([stub(i) for i in range(2)])
    victim = group.assignment(0)
    orig = group.split_step("orig-payload", None, 1, 0)
    group.kill(victim)
    dup = group.split_step("garbage-payload", None, 1, 0)
    applies = [a for r in group.replicas for a in r.applies
               if a[0] == 0 and a[1] == 1]
    other = next(c for c in range(1, 32)
                 if rendezvous_pick(c, [0, 1]) != victim)
    group.split_step("fresh", None, 1, other)
    return group, victim, orig, dup, applies


def test_handoff_never_double_applies_garbage_dup():
    group, victim, orig, dup, applies = _garbage_dup("port")
    assert _reply(dup) == _reply(orig)
    assert dup[-1] == "orig-payload"
    assert len(applies) == 1
    assert group.live_replicas() == [1 - victim]
    assert len(group.replicas[1 - victim].applies) >= 1
    jgroup, *_ = _garbage_dup("jax")
    assert group.counters() == jgroup.counters()
    assert group.counters()["replica_handoffs"] == 1
    assert group.counters()["handoff_replay_entries"] >= 1


def test_kill_mid_flight_duplicate_blocks_then_serves():
    cls, stub = STUBS["port"]
    group = cls([stub(i) for i in range(2)])
    victim = group.assignment(0)
    orig = group.split_step("orig", None, 3, 0)
    results = {}
    killer = threading.Thread(target=group.kill, args=(victim,))
    killer.start()
    t = threading.Thread(target=lambda: results.setdefault(
        "dup", group.split_step("retransmit", None, 3, 0)))
    t.start()
    killer.join(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive() and not killer.is_alive()
    assert _reply(results["dup"]) == _reply(orig)
    assert group.counters()["replica_handoffs"] == 1
    assert sum(len(r.applies) for r in group.replicas) == 1


def test_fenced_client_waits_for_the_commit():
    """A client of the dying replica that arrives while the handoff is
    fenced blocks until the commit, and lands on the successor after."""
    cls, stub = STUBS["port"]
    group = cls([stub(i) for i in range(2)])
    victim = group.assignment(0)
    group.split_step("orig", None, 1, 0)
    slot = group._slots[victim]
    gate = threading.Event()
    real = slot.runtime.export_runtime_extras

    def slow_capture(step):
        gate.wait(timeout=30)
        return real(step)
    slot.runtime.export_runtime_extras = slow_capture
    killer = threading.Thread(target=group.kill, args=(victim,))
    killer.start()
    while slot.alive:
        pass
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "r", group.split_step("next", None, 2, 0)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive(), "a fenced client landed before the commit"
    gate.set()
    killer.join(timeout=30)
    t.join(timeout=30)
    assert got["r"][3] == 1 - victim
    assert group.counters()["replica_fenced_waits"] >= 1


def test_checkpoint_handoff_roundtrip_lock_debug(tmp_path, monkeypatch):
    monkeypatch.setenv("SLT_LOCK_DEBUG", "1")
    cls, stub = STUBS["port"]
    group = cls([stub(i) for i in range(2)], handoff="checkpoint",
                ckpt_dir=str(tmp_path))
    victim = group.assignment(0)
    orig = group.split_step("orig", None, 1, 0)
    group.kill(victim)
    assert glob.glob(os.path.join(str(tmp_path), "**", "*"), recursive=True)
    assert _reply(group.split_step("garbage", None, 1, 0)) == _reply(orig)
    assert group.counters()["handoff_replay_entries"] >= 1


def test_maybe_replicate_one_is_the_bare_runtime():
    sentinel, calls = object(), []
    out = maybe_replicate(lambda i: calls.append(i) or sentinel, 1)
    assert out is sentinel and calls == [0]
    assert isinstance(maybe_replicate(STUBS["port"][1], 2), ReplicaGroup)


@pytest.mark.parametrize("n,floor,size", [(1, 1, 1), (1, 2, 2), (3, 1, 3)])
def test_maybe_replicate_under_a_floor_is_always_a_group(n, floor, size):
    # an elastic run: the autoscaler adds and removes through the router,
    # so even one replica is fronted by a group
    group = maybe_replicate(STUBS["port"][1], n, min_replicas=floor)
    assert isinstance(group, ReplicaGroup)
    assert len(group.replicas) == size


# --------------------------------------------------------------------- #
# real replicas
# --------------------------------------------------------------------- #

def _factory(ef_mode="topk8", init=None):
    plan, cfg = get_plan(), Config(batch_size=BATCH)

    def factory(_idx):
        return ServerRuntime(plan, cfg, init if init is not None
                             else torch.Generator().manual_seed(0),
                             ef_mode=ef_mode, device="cpu")
    return factory


def _batch(seed, n=BATCH):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, (n,)).astype(np.int64)
    return rs.randn(n, 26, 26, 32).astype(np.float32), y


def test_replicas_one_bit_identical_to_plain_server():
    factory = _factory()
    plain = factory(0)
    solo = maybe_replicate(factory, 1, sync_every=1)
    for step in range(1, 4):
        x, y = _batch(step)
        g_p, loss_p = plain.split_step(x, y, step, 0)
        g_s, loss_s = solo.split_step(x, y, step, 0)
        assert loss_p == loss_s
        np.testing.assert_array_equal(g_p, g_s)
    for a, b in zip(plain.params.values(), solo.params.values()):
        assert torch.equal(a, b)


def _diverge(group, steps=2):
    a = next(c for c in range(1000, 1032) if group.assignment(c) == 0)
    b = next(c for c in range(1000, 1032) if group.assignment(c) == 1)
    for step in range(1, steps + 1):
        group.split_step(*_batch(step), step, a)
        group.split_step(*_batch(100 + step), step, b)
    return a, b


def test_fedavg_sync_is_jaxs_mean_and_training_continues():
    group = maybe_replicate(_factory(), 2)
    a, b = _diverge(group)
    before = [params_to_jax([r.params]) for r in group.replicas]
    l0 = jax.tree_util.tree_leaves(before[0])
    l1 = jax.tree_util.tree_leaves(before[1])
    assert any(not np.array_equal(x, y) for x, y in zip(l0, l1))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jax_fedavg_mean([jax.tree_util.tree_map(
            jax.numpy.asarray, p) for p in before])))
    assert group.sync_now() == 2
    after = [jax.tree_util.tree_leaves(params_to_jax([r.params]))
             for r in group.replicas]
    for x, y, w in zip(after[0], after[1], want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(x, w, rtol=0, atol=1e-6)
    assert group.counters()["replica_syncs"] == 1
    # per-replica buffers: one replica's step leaves the other's alone
    group.split_step(*_batch(9), 3, a)
    moved = jax.tree_util.tree_leaves(params_to_jax(
        [group.replicas[0].params]))
    kept = jax.tree_util.tree_leaves(params_to_jax(
        [group.replicas[1].params]))
    assert any(not np.array_equal(x, y) for x, y in zip(moved, after[0]))
    for x, y in zip(kept, after[1]):
        np.testing.assert_array_equal(x, y)
    group.split_step(*_batch(9), 3, b)
    group.close()


def test_sync_every_and_compressed_sync():
    """``sync_every`` K syncs every K group steps; a topk8 sync sends
    fewer bytes than it reconstructs and the replicas still end equal."""
    group = maybe_replicate(_factory(), 2, sync_every=2,
                            sync_compress="topk8", sync_density=0.5)
    _diverge(group, steps=3)
    c = group.counters()
    assert c["replica_syncs"] == 3
    assert 0 < c["sync_wire_bytes"] < c["sync_raw_bytes"]
    for x, y in zip(group.replicas[0].params.values(),
                    group.replicas[1].params.values()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["topk8", "clapping"])
def test_handoff_moves_the_ef_ledger(mode):
    group = ReplicaGroup([_factory(ef_mode=mode)(i) for i in range(2)])
    victim = group.assignment(0)
    g = np.random.RandomState(1).randn(4096).astype(np.float32)
    group.replicas[victim].wire_ef.compress((0, "/forward_pass"), g, 0.1)
    x, y = _batch(7)
    orig_g, orig_loss = group.split_step(x, y, 0, 0)
    cap = group.replicas[victim].export_runtime_extras(0)
    assert ("wire_ef" in cap) == (mode == "topk8")
    assert len(wire_codec.encode(cap)) > 0
    group.kill(victim)
    ctr = group.counters()
    succ = group.replicas[1 - victim]
    if mode == "topk8":
        assert ctr["handoff_ef_entries"] >= 1
        np.testing.assert_array_equal(
            np.asarray(succ.wire_ef.residual((0, "/forward_pass"))),
            np.asarray(group.replicas[victim].wire_ef.residual(
                (0, "/forward_pass"))))
    else:
        assert ctr["handoff_ef_entries"] == 0
    dup_g, dup_loss = group.split_step(x, y, 0, 0)
    np.testing.assert_array_equal(np.asarray(dup_g), np.asarray(orig_g))
    assert dup_loss == orig_loss
    assert succ.health()["step"] == -1   # served, never applied
    group.close()


def test_scale_up_adopts_a_donors_params_and_replays():
    group = ReplicaGroup([_factory()(i) for i in range(2)])
    _diverge(group)
    donor = group.replicas[0].params
    clients = list(range(64))
    for c in clients:
        group.split_step(*_batch(c), 0, c)
    idx = group.add_replica(_factory())
    new = group.replicas[idx]
    for k in donor:
        assert torch.equal(new.params[k], group.replicas[0].params[k])
    moved = [c for c in clients if group.assignment(c) == idx]
    assert moved, "HRW moved no client to the newcomer"
    c = moved[0]
    g0, l0 = group.replicas[rendezvous_pick(c, [0, 1])].replay.get(
        c, "split_step", 0)
    g, loss = group.split_step(*_batch(999), 0, c)   # a garbage duplicate
    assert loss == l0
    np.testing.assert_array_equal(np.asarray(g), np.asarray(g0))
    assert new.health()["step"] == -1
    h = group.health()["replicas"]
    assert h["n"] == 3 and h["live"] == [0, 1, 2]
    group.remove_replica(idx)
    assert group.live_replicas() == [0, 1]
    assert group.counters()["replica_scale_downs"] == 1


def test_group_metrics_health_and_hooks():
    group = ReplicaGroup([_factory()(i) for i in range(2)], sync_every=5)
    seen = []
    group.on_step = seen.append
    _diverge(group, steps=1)
    m = group.metrics()
    assert m["gauges"]["replicas_live"] == 2.0
    assert m["counters"]["replica_routes_total"] >= 2
    assert {s["labels"]["replica"] for s in m["labeled"]} == {"0", "1"}
    h = group.health()
    assert h["replicas"]["step_max"] == 1 and h["replicas"]["sync_every"] == 5
    assert sorted(seen) == [1, 1]
    assert group.device == torch.device("cpu")
    assert group.trace_metadata()["replicas"] == 2
    group.close()


def test_adopt_params_copies():
    """The adopted parameters are the server's own copies."""
    a, b = _factory()(0), _factory()(1)
    a.split_step(*_batch(1), 1, 0)
    adopt_params(b.state, a.state.params, b.device)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k])
        assert v.data_ptr() != b.params[k].data_ptr()


# --------------------------------------------------------------------- #
# the chain's replicated stages, and the CLI's refusals
# --------------------------------------------------------------------- #

CHAIN = ["train", "--device", "cpu", "--model", "split_cnn_chain3",
         "--stages", "3", "--microbatches", "2", "--steps", "4",
         "--batch-size", "16", "--dataset", "synthetic", "--tracking",
         "jsonl"]


def _losses(data_dir):
    import json
    folder = os.path.join(str(data_dir), "metrics")
    out = []
    for name in sorted(os.listdir(folder)):
        out += [json.loads(line)["value"]
                for line in open(os.path.join(folder, name))
                if json.loads(line)["key"] == "loss"]
        os.remove(os.path.join(folder, name))
    return out


def test_chain_replicas_on_local(tmp_path, capsys):
    d = str(tmp_path / "d")
    assert main(CHAIN + ["--transport", "local", "--data-dir", d]) == 0
    bare = _losses(d)
    assert main(CHAIN + ["--transport", "local", "--data-dir", d,
                         "--replicas", "2", "--replica-sync-every", "0",
                         "--gate-dropped-steps"]) == 0
    assert "[gate] ok: 4 steps completed, 0 dropped" in \
        capsys.readouterr().err
    assert _losses(d) == bare


@pytest.mark.parametrize("flags,text", [
    (["--transport", "device", "--replicas", "2"], "needs --transport local"),
    (["--transport", "local", "--replicas", "2", "--checkpoint-dir", "CK"],
     "does not compose with --checkpoint-dir"),
])
def test_chain_replica_refusals(flags, text, tmp_path, capsys):
    flags = [str(tmp_path / "ck") if f == "CK" else f for f in flags]
    assert main(CHAIN + ["--data-dir", str(tmp_path / "d"), *flags]) == 2
    assert text in capsys.readouterr().err


def test_serve_replicas_refuse_checkpoint_dir(tmp_path, capsys):
    assert main(["serve", "--device", "cpu", "--port", "0", "--replicas",
                 "2", "--checkpoint-dir", str(tmp_path)]) == 2
    assert "does not compose with --checkpoint-dir" in \
        capsys.readouterr().err


# --------------------------------------------------------------------- #
# mixed pairs through the numpy Transport interface
# --------------------------------------------------------------------- #

def _data(steps=6):
    ds = jax_synthetic("mnist", n_train=64 * steps, n_test=8, seed=0)
    return list(jax_batches(ds.train, 64, seed=0))


def _jax_replica(data):
    return JaxServer(jax_get_plan(mode="split"), JaxConfig(batch_size=64),
                     jax.random.PRNGKey(0), data[0][0])


def _jax_init(data):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(0), jax.numpy.asarray(data[0][0])))


def _train_with_kill(client, group, data):
    losses = []
    for i, (x, y) in enumerate(data):
        if i == len(data) // 2:
            group.kill(group.assignment(0))
        losses.append(client.train_step(x, y, i))
    return losses


@pytest.mark.parametrize("pair", ["port_client_jax_group",
                                  "jax_client_port_group"])
def test_mixed_pairs_across_a_failover(pair):
    """Each mixed pair against the JAX pair (a JAX client and a JAX
    group), a replica killed mid-run in all three: the same losses
    within 1e-4 before and after the failover (the successor starts
    from the shared init, in every group)."""
    data = _data()
    jgroup = JaxGroup([_jax_replica(data) for _ in range(2)])
    want = _train_with_kill(
        JaxClient(jax_get_plan(mode="split"), JaxConfig(batch_size=64),
                  jax.random.PRNGKey(0), JaxLocal(jgroup)), jgroup, data)
    if pair == "port_client_jax_group":
        group = JaxGroup([_jax_replica(data) for _ in range(2)])
        client = SplitClientTrainer(get_plan(), Config(batch_size=64),
                                    _jax_init(data), JaxLocal(group),
                                    device="cpu")
    else:
        init = _jax_init(data)
        group = ReplicaGroup([ServerRuntime(get_plan(),
                                            Config(batch_size=64), init,
                                            device="cpu")
                              for _ in range(2)])
        client = JaxClient(jax_get_plan(mode="split"),
                           JaxConfig(batch_size=64), jax.random.PRNGKey(0),
                           LocalTransport(group))
    losses = _train_with_kill(client, group, data)
    assert group.counters()["replica_handoffs"] == 1
    assert group.counters() == jgroup.counters()
    np.testing.assert_allclose(losses, want, atol=1e-4)
