"""slt-check and slt-crash of the port (``analysis/sched.py``,
``invariants.py``, ``scenarios.py``) against the JAX package's
(counterpart of tests/test_sched.py and tests/test_crash_check.py), on
the CPU.

- Stdlib-only toys (tests/test_sched.py's and tests/test_crash_check.py's,
  imported from those modules) explored by both packages' schedulers
  give the same schedule count, the same ids and the same fingerprints.
- Each invariant fires on its planted toy (check-then-act claims, the
  if-guarded wait's lost wakeup, AB/BA deadlock, EDF inversion, a
  forgotten 429 release, a leaked admission slot, a dropped waiter, the
  four durability invariants), with a replayable id; replay is
  bit-identical, from the API and from ``--schedule``.
- The adversarial disk (``DurableStore``) and the port's real
  ``write_extras`` surviving every crash point; extras round trips.
- The port's lighter scenarios, every crash scenario and the CLI gate
  at their own budgets (the heavy scenarios are in
  tests/test_torch_port_scenarios.py).
"""

import json
import os

import numpy as np
import pytest

import test_crash_check as jax_crash
import test_sched as jax_sched
from split_learning_tpu.analysis import sched as jsched
from split_learning_tpu_torch.analysis import engine
from split_learning_tpu_torch.analysis.invariants import (
    GENERIC, INVARIANTS, check_run)
from split_learning_tpu_torch.analysis.scenarios import (
    CRASH_SCENARIOS, SCENARIOS)
from split_learning_tpu_torch.analysis.sched import (
    DurableStore, decode_choices, encode_choices, explore, explore_crashes,
    run_crash_schedule, run_schedule)
from split_learning_tpu_torch.runtime.checkpoint import (
    build_extras, decode_obj, extras_valid, read_latest_extras,
    write_extras)
from split_learning_tpu_torch.runtime.replay import ReplayCache
from split_learning_tpu_torch.transport.codec import TopK8EF

TOYS = {"counter": jax_sched._counter_race,
        "double_claim": jax_sched._double_claim,
        "lost_wakeup": jax_sched._lost_wakeup,
        "ab_ba": jax_sched._ab_ba}


def _violations(name, fn, named=(), *, budget=200, bound=3):
    out = []
    explore(name, fn, budget=budget, bound=bound,
            on_run=lambda run: out.extend(check_run(run, named)))
    return out


# ---------------------------------------------------------------------- #
# the two schedulers agree
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["dfs", "random"])
@pytest.mark.parametrize("toy", sorted(TOYS))
def test_toy_explored_alike_by_both_packages(toy, mode):
    fn = TOYS[toy]
    ours = explore(toy, fn, budget=60, bound=3, mode=mode, seed=5)
    theirs = jsched.explore(toy, fn, budget=60, bound=3, mode=mode, seed=5)
    assert ours.schedules == theirs.schedules > 0
    assert ours.schedule_ids == theirs.schedule_ids
    assert ours.sample == theirs.sample
    assert ours.summary() == theirs.summary()


def test_crash_toy_explored_alike_by_both_packages():
    args = ("two_writer", jax_crash._two_writer_workload,
            jax_crash._two_writer_recover)
    kw = dict(budget=6, bound=2, crash_budget=24)
    ours = explore_crashes(*args, **kw)
    theirs = jsched.explore_crashes(*args, **kw)
    assert ours.schedule_ids == theirs.schedule_ids
    assert ours.summary() == theirs.summary()


def test_schedule_id_roundtrip():
    for choices in ((), (0,), (1, 0, 2), tuple(range(7))):
        assert decode_choices(encode_choices(choices)) == choices


def test_same_forced_schedule_is_bit_identical():
    res = explore("counter", TOYS["counter"], budget=50)
    assert res.schedules >= 2
    for sid in res.schedule_ids[:5]:
        forced = decode_choices(sid.split(":", 1)[1])
        a = run_schedule("counter", TOYS["counter"], forced=forced)
        b = run_schedule("counter", TOYS["counter"], forced=forced)
        assert a.trace_fingerprint() == b.trace_fingerprint()
        assert a.trace == b.trace and a.notes == b.notes
        assert a.state == b.state == {"n": 4}


def test_counterexample_replays_bit_for_bit():
    dead = [v for v in _violations("abba", TOYS["ab_ba"])
            if v.invariant == "deadlock_free"]
    assert dead
    forced = decode_choices(dead[0].schedule_id.split(":", 1)[1])
    replay = run_schedule("abba", TOYS["ab_ba"], forced=forced)
    assert replay.deadlock is not None
    assert replay.schedule_id == dead[0].schedule_id
    again = run_schedule("abba", TOYS["ab_ba"], forced=forced)
    assert again.trace_fingerprint() == replay.trace_fingerprint()


# ---------------------------------------------------------------------- #
# each invariant fires on its planted toy
# ---------------------------------------------------------------------- #
PLANTED = {
    "exactly_once_claims": jax_sched._double_claim,
    "no_lost_wakeup": jax_sched._lost_wakeup,
    "deadlock_free": jax_sched._ab_ba,
    "edf_pickup_order": jax_sched._edf_inversion,
    "reclaimable_429": jax_sched._forgotten_release,
    "admission_conservation": jax_sched._leaked_admit,
    "all_resolved": jax_sched._dropped_waiter,
}


@pytest.mark.parametrize("invariant", sorted(PLANTED))
def test_invariant_fires_on_its_planted_toy(invariant):
    found = [v for v in _violations(invariant, PLANTED[invariant],
                                    (invariant,))
             if v.invariant == invariant]
    assert found, f"{invariant} missed its planted fault"
    assert found[0].schedule_id.startswith(f"{invariant}:")
    assert "--schedule" in str(found[0])


def test_lost_wakeup_replays_to_the_same_stall():
    stuck = [v for v in _violations("lw", TOYS["lost_wakeup"])
             if v.invariant == "no_lost_wakeup"]
    forced = decode_choices(stuck[0].schedule_id.split(":", 1)[1])
    replay = run_schedule("lw", TOYS["lost_wakeup"], forced=forced)
    assert replay.stalled and not replay.deadlock


def test_edf_overtaking_and_deadlock_cycle():
    assert any(v.invariant == "edf_pickup_order" for v in _violations(
        "edf2", jax_sched._edf_overtaken, ("edf_pickup_order",)))
    dead = [v for v in _violations("abba", TOYS["ab_ba"])
            if v.invariant == "deadlock_free"]
    assert "cycle" in str(dead[0])


def test_correct_toy_is_clean_and_generics_registered():
    assert _violations("counter", TOYS["counter"], tuple(INVARIANTS)) == []
    for fn in GENERIC:
        assert INVARIANTS[fn.__name__] is fn


# ---------------------------------------------------------------------- #
# slt-crash: the adversarial disk and the durability invariants
# ---------------------------------------------------------------------- #
def test_durable_store_worst_case_semantics():
    st = DurableStore()
    st.put("d/a.txt", "payload-AAAA")
    st.crash()
    assert st.read("d/a.txt") == "payload-AAAA"[:6]   # torn, un-fsynced
    st = DurableStore()
    st.put("d/x.json.tmp", "hello!")
    st.fsync("d/x.json.tmp")
    st.rename("d/x.json.tmp", "d/x.json")
    st.crash()
    assert st.listdir("d") == ["x.json"] and st.read("d/x.json") == "hello!"
    st.put("d/x.json", "new-new-new!")   # dirties past the fsync
    st.crash()
    assert st.read("d/x.json") == "new-new-new!"[:6]


def test_torn_checkpoint_toy_caught():
    torn = []
    for k in range(1, 6):
        run = run_crash_schedule("torn_ckpt", jax_crash._torn_ckpt_workload,
                                 jax_crash._torn_ckpt_recover, crash_at=k)
        if run.crashed:
            torn.extend(v for v in check_run(run, ("checkpoint_atomicity",))
                        if v.invariant == "checkpoint_atomicity")
    assert torn and all("@crash:" in v.schedule_id for v in torn)


def _real_extras_workload(ctx, store):
    write_extras("ckpt", build_extras(1, 1, replay=[]), fs=store)
    ctx.note("c_commit", step=1, lineage=1, captured=[])


def _real_extras_recover(ctx, store, pre):
    payload = read_latest_extras("ckpt", fs=store)
    ctx.note("c_restore", step=None if payload is None else payload["step"],
             lineage=None if payload is None else payload["lineage"],
             torn=False)


def test_ports_write_extras_survives_every_crash_point():
    for k in range(1, 10):
        run = run_crash_schedule("atomic_ckpt", _real_extras_workload,
                                 _real_extras_recover, crash_at=k)
        assert check_run(run, ("checkpoint_atomicity",)) == [], k


@pytest.mark.parametrize("toy", [
    "test_slt109_lost_deferred_apply_toy_caught",
    "test_slt109_double_apply_toy_caught",
    "test_slt111_mutated_replay_toy_caught",
    "test_slt111_replay_of_never_replied_step_caught",
    "test_slt112_unflushed_save_toy_caught"])
def test_durability_toys_caught_by_the_ports_checker(monkeypatch, toy):
    """JAX's toy cases, their run_crash_schedule and check_run rebound to
    the port's."""
    monkeypatch.setattr(jax_crash, "run_crash_schedule", run_crash_schedule)
    monkeypatch.setattr(jax_crash, "check_run", check_run)
    getattr(jax_crash, toy)()


def test_forced_crash_replay_is_bit_identical():
    runs = [run_crash_schedule("two_writer", jax_crash._two_writer_workload,
                               jax_crash._two_writer_recover, crash_at=3)
            for _ in range(2)]
    assert runs[0].schedule_id == runs[1].schedule_id
    assert "@crash:3" in runs[0].schedule_id
    assert runs[0].trace_fingerprint() == runs[1].trace_fingerprint()
    assert runs[0].state == runs[1].state


def _populated_cache():
    cache = ReplayCache(window=8, max_total=64)
    entry, owner = cache.begin(0, "split_step", 1)
    assert owner
    cache.resolve(entry, {"loss": 1.5})
    cache.attach_body(0, "split_step", 1, b"\x00\x01wire-bytes")
    return cache


def test_extras_roundtrip_replay_and_ef(tmp_path):
    cache = _populated_cache()
    ef = TopK8EF()
    ef.compress(("c0", "grads"), np.linspace(-1, 1, 64, dtype=np.float32),
                0.125)
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    write_extras(str(ckdir), build_extras(3, 2, replay=cache.export_state(),
                                          wire_ef=ef.export_state()))
    assert all(not n.endswith(".tmp") for n in os.listdir(ckdir))
    got = read_latest_extras(str(ckdir), step=3)
    assert got is not None and extras_valid(got)
    cache2 = ReplayCache(window=8, max_total=64)
    cache2.restore_state(decode_obj(got["replay"]))
    assert cache2.lookup(0, "split_step", 1)[0] == b"\x00\x01wire-bytes"
    ef2 = TopK8EF()
    ef2.restore_state(decode_obj(got["wire_ef"]))
    np.testing.assert_array_equal(ef2.export_state()[0]["res"],
                                  ef.export_state()[0]["res"])
    store = DurableStore()
    write_extras("ckpt", build_extras(5, 1, replay=cache.export_state()),
                 fs=store)
    store.crash()
    assert read_latest_extras("ckpt", fs=store, step=5) is not None


# ---------------------------------------------------------------------- #
# the port's scenarios (the lighter half) and the CLI
# ---------------------------------------------------------------------- #
HEAVY = ("onefb_hop_order", "scale_down_inflight_race",
         "pipeline_hop_chain", "sharded_stage_handoff")
LIGHT = sorted(n for n in SCENARIOS if n not in HEAVY)
# the port's own scenarios, which drive runtime code that JAX's
# scenarios reach only through stubs
PORT_ONLY = ("stage_hop_claims",)


def test_every_jax_scenario_has_a_port_counterpart():
    from split_learning_tpu.analysis import scenarios as jscen
    assert set(SCENARIOS) == set(jscen.SCENARIOS) | set(PORT_ONLY)
    assert not set(PORT_ONLY) & set(jscen.SCENARIOS)
    assert set(CRASH_SCENARIOS) == set(jscen.CRASH_SCENARIOS)
    for name, sc in SCENARIOS.items():
        if name in PORT_ONLY:
            continue
        js = jscen.SCENARIOS[name]
        assert (sc.invariants, sc.budget, sc.bound, sc.mode, sc.seed) == (
            js.invariants, js.budget, js.bound, js.mode, js.seed), name
    for name, sc in CRASH_SCENARIOS.items():
        js = jscen.CRASH_SCENARIOS[name]
        assert (sc.invariants, sc.budget, sc.crash_budget, sc.bound) == (
            js.invariants, js.budget, js.crash_budget, js.bound), name


def clean_under_budget(name):
    sc = SCENARIOS[name]
    assert sc.available()
    bad = []
    res = explore(name, sc.fn, budget=sc.budget, bound=sc.bound,
                  mode=sc.mode, seed=sc.seed,
                  on_run=lambda r: bad.extend(check_run(r, sc.invariants)))
    assert bad == [], [str(v) for v in bad[:3]]
    assert res.schedules > 0 and res.runs_with_errors == 0
    assert res.schedules <= sc.budget
    return res


@pytest.mark.parametrize("name", LIGHT)
def test_scenario_clean_under_its_budget(name):
    clean_under_budget(name)


@pytest.mark.parametrize("name", sorted(CRASH_SCENARIOS))
def test_crash_scenario_clean_under_its_budget(name):
    sc = CRASH_SCENARIOS[name]
    bad = []
    res = explore_crashes(
        name, sc.workload, sc.recover, budget=sc.budget, bound=sc.bound,
        crash_budget=sc.crash_budget,
        on_run=lambda r: bad.extend(check_run(r, sc.invariants)))
    assert res.crash_schedules > 0 and res.bases > 0
    assert bad == [], [str(v) for v in bad[:3]]


def test_check_cli_gate_report_and_replay(tmp_path, capsys):
    rpt = tmp_path / "report.json"
    assert engine.main(["--check", "--scenario", "replay_dup_storm",
                        "--budget", "60", "--report", str(rpt)]) == 0
    out = capsys.readouterr().out
    assert "slt-check: replay_dup_storm: 60 schedules" in out
    entry = json.loads(rpt.read_text())["scenarios"]["replay_dup_storm"]
    assert entry["violations"] == [] and entry["schedules"] == 60
    sid = next(iter(entry["sample_fingerprints"]))
    assert sid.startswith("replay_dup_storm:")
    outs = []
    for _ in range(2):
        assert engine.main(["--schedule", sid]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "no invariant violated" in outs[0]


def test_crash_cli_gate_and_replay(tmp_path, capsys):
    name = "crash_replay_dup_storm"
    rpt = tmp_path / "report.json"
    assert engine.main(["--check", "--crash", "--scenario", name,
                        "--budget", "24", "--report", str(rpt)]) == 0
    data = json.loads(rpt.read_text())
    assert data["crash"] is True
    assert data["scenarios"][name]["crash_schedules"] > 0
    capsys.readouterr()
    sc = CRASH_SCENARIOS[name]
    res = explore_crashes(name, sc.workload, sc.recover, budget=2,
                          bound=sc.bound, crash_budget=4)
    sid = next(s for s in res.schedule_ids if "@crash:" in s)
    outs = []
    for _ in range(2):
        assert engine.main(["--schedule", sid]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "crashed at transition" in outs[0]


def test_check_rejects_unknown_scenario():
    with pytest.raises(SystemExit):
        engine.main(["--check", "--scenario", "no_such_scenario"])
