"""The port's heavier slt-check scenarios (the pipeline hop chain, 1F1B
order, the replica scale-down race and the sharded stage handoff) at
their own budgets, on the port's real runtime objects on the CPU; the
lighter ones are in tests/test_torch_port_sched.py. Also: a scenario's
sweep over the port explores as many schedules as JAX's sweep of its
own scenario where both drive pure host code (the replay cache, the
breaker), and the cooperative world never leaks out of a schedule.
"""

import threading

import pytest

from split_learning_tpu.analysis import scenarios as jscen
from split_learning_tpu.analysis import sched as jsched
from split_learning_tpu_torch.analysis.scenarios import SCENARIOS
from split_learning_tpu_torch.analysis.sched import explore
from split_learning_tpu_torch.obs import locks

import test_torch_port_sched as light


@pytest.mark.parametrize("name", light.HEAVY)
def test_scenario_clean_under_its_budget(name):
    light.clean_under_budget(name)


@pytest.mark.parametrize("name", ["replay_dup_storm", "replay_fail_retry",
                                  "breaker_probe_race",
                                  "admission_bucket_race"])
def test_sweep_matches_jax_schedule_count(name):
    sc, js = SCENARIOS[name], jscen.SCENARIOS[name]
    ours = explore(name, sc.fn, budget=sc.budget, bound=sc.bound,
                   mode=sc.mode, seed=sc.seed)
    theirs = jsched.explore(name, js.fn, budget=js.budget, bound=js.bound,
                            mode=js.mode, seed=js.seed)
    assert ours.schedules == theirs.schedules
    assert ours.pruned == theirs.pruned


def test_seam_is_restored_after_a_sweep():
    explore("replay_dup_storm", SCENARIOS["replay_dup_storm"].fn, budget=5)
    assert not locks.checker_installed()
    from split_learning_tpu_torch.runtime import coalesce
    assert coalesce.time.monotonic.__module__ == "time"
    assert isinstance(locks.make_lock("x"), type(threading.RLock()))
