"""The port's K-stage chain against the JAX package's, on the CPU.

``PipelineRunner`` + two ``StageRuntime`` parties of
``split_cnn_chain3`` behind ``LocalTransport`` (or ``DeviceTransport``),
from JAX's init (carried across with ``interop.params_from_jax``) on the
same batches as JAX's chain:

- the schedule math (``pipeline_ticks``, ``bubble_fraction``,
  ``onefb_warmup``, ``SCHEDULES``) equals JAX's over a grid, exactly;
- ``DensityController`` fed one ``note_ratio``/``note_loss`` sequence
  gives JAX's densities and trajectory bit for bit;
- M 1, lag 0, 12 steps: losses within 1e-4 of JAX's chain (the
  cross-framework float32 bar of ``tests/test_torch_parity.py``), and
  bit-equal to driving the port's stages one hop after another;
- M 4, lag 1, 6 steps: within 1e-4 of JAX's chain;
- 1F1B bit-equal to GPipe; ``DeviceTransport`` bit-equal to
  ``LocalTransport(compress=None)``, with no host copy on its hops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import pipeline_runner as jax_runner_mod
from split_learning_tpu.runtime.pipeline_runner import (
    PipelineRunner as JaxRunner)
from split_learning_tpu.runtime.stage import StageRuntime as JaxStage
from split_learning_tpu.transport import density as jax_density_mod
from split_learning_tpu.transport.density import (
    DensityController as JaxDensity)
from split_learning_tpu.transport.local import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import spans
from split_learning_tpu_torch.runtime import pipeline_runner as runner_mod
from split_learning_tpu_torch.runtime.pipeline_runner import PipelineRunner
from split_learning_tpu_torch.runtime.stage import StageRuntime
from split_learning_tpu_torch.runtime.state import (
    init_params, make_state, make_tx)
from split_learning_tpu_torch.transport import (
    DensityController, DeviceTransport, LocalTransport)
from split_learning_tpu_torch.transport import density as density_mod
from split_learning_tpu_torch.utils.config import Config

BATCH, SEED = 8, 2
JAX_TOL = 1e-4   # cross-framework float32 drift (test_torch_parity.py:96)
SHAPE = (28, 28, 1)


def _batch(seed, batch=BATCH):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, *SHAPE).astype(np.float32),
            rs.randint(0, 10, batch).astype(np.int64))


def _kw(m, schedule, batch):
    return dict(mode="split", model="split_cnn_chain3", batch_size=batch,
                num_stages=3, microbatches=m, schedule=schedule, seed=SEED)


def _jax_init(batch=BATCH):
    return jax_get_plan(model="split_cnn_chain3", mode="split").init(
        jax.random.PRNGKey(SEED), jnp.zeros((batch,) + SHAPE))


def jax_chain(m, lag, schedule="gpipe", batch=BATCH, compress=None,
              dc=None, wrap=None):
    """JAX's 3-stage chain: the runner and two in-process stages, each
    from the plan-level seed."""
    cfg = JaxConfig(**_kw(m, schedule, batch))
    plan = jax_get_plan(model="split_cnn_chain3", mode="split")
    sample = np.zeros((batch,) + SHAPE, np.float32)
    stages = [JaxStage(plan, i, cfg, jax.random.PRNGKey(SEED), sample,
                       microbatches=m, apply_lag=lag) for i in (1, 2)]
    wires = [JaxLocal(s, compress=compress, density_controller=dc)
             for s in stages]
    if wrap is not None:
        wires = [wrap(t) for t in wires]
    runner = JaxRunner(plan, cfg, jax.random.PRNGKey(SEED), sample, wires,
                       microbatches=m, schedule=schedule)
    runner.density_controller = dc
    return runner, stages, wires


def port_chain(m, lag, schedule="gpipe", batch=BATCH, transport="local",
               compress=None, dc=None, wrap=None):
    """The port's chain from JAX's init, on the CPU."""
    cfg = Config(**_kw(m, schedule, batch))
    plan = get_plan(model="split_cnn_chain3")
    init = params_from_jax(_jax_init(batch))
    stages = [StageRuntime(plan, i, cfg, init, microbatches=m,
                           apply_lag=lag, device="cpu") for i in (1, 2)]
    if transport == "device":
        wires = [DeviceTransport(s) for s in stages]
    else:
        wires = [LocalTransport(s, compress=compress, density_controller=dc)
                 for s in stages]
    if wrap is not None:
        wires = [wrap(t) for t in wires]
    runner = PipelineRunner(plan, cfg, init, None, wires, microbatches=m,
                            schedule=schedule, device="cpu")
    runner.density_controller = dc
    return runner, stages, wires


def drive(chain, steps, batch=BATCH, data=None, start=0):
    """Steps ``start``.. ``start + steps - 1`` of ``chain`` on ``data``
    (default: ``_batch(step)``), then every party closed."""
    runner, stages, _ = chain
    try:
        return [runner.step(*(data[i] if data is not None
                              else _batch(start + i, batch)), start + i)
                for i in range(steps)]
    finally:
        runner.close()
        for s in stages:
            s.close()


@pytest.mark.parametrize("m", range(1, 9))
def test_schedule_math_equals_jax(m):
    for s in range(2, 7):
        for fn in ("pipeline_ticks", "bubble_fraction", "onefb_warmup"):
            assert getattr(runner_mod, fn)(m, s) == getattr(
                jax_runner_mod, fn)(m, s), (fn, m, s)
    assert runner_mod.SCHEDULES == jax_runner_mod.SCHEDULES


def test_density_controller_equals_jax():
    """One feed to both controllers, compared after every loss: the
    densities, the snapshot and the decision trajectory bit for bit."""
    for name in ("DENSITY_LADDER", "AUTO_START_RUNG", "DEFAULT_WINDOW",
                 "DEFAULT_BUDGET_NATS"):
        assert getattr(density_mod, name) == getattr(jax_density_mod, name)
    rs = np.random.RandomState(0)
    for window, budget in ((1, 0.05), (2, 0.05), (4, 0.01), (8, 0.2)):
        ours = DensityController(window=window, budget_nats=budget)
        ref = JaxDensity(window=window, budget_nats=budget)
        for i in range(60):
            for wire in ("hop1", "hop2", "hop3"):
                raw = int(rs.randint(1000, 100000))
                wire_b = int(rs.randint(50, raw))
                if rs.rand() < 0.8:
                    ours.note_ratio(wire, raw, wire_b)
                    ref.note_ratio(wire, raw, wire_b)
                assert ours.density(wire) == ref.density(wire)
            loss = float(2.0 - 0.02 * i + rs.randn() * 0.1)
            ours.note_loss(loss)
            ref.note_loss(loss)
            assert ours.snapshot() == ref.snapshot()
        assert ours.densities() == ref.densities()
    for kw in (dict(window=0), dict(ladder=(0.1, 0.2)),
               dict(start_rung=99)):
        with pytest.raises(ValueError):
            DensityController(**kw)


def test_m1_lag0_matches_jax_and_the_sequential_drive():
    steps = 12
    ref = drive(jax_chain(1, 0), steps)
    piped = drive(port_chain(1, 0), steps)
    np.testing.assert_allclose(piped, ref, atol=JAX_TOL, rtol=0)

    # the same hops by hand, on the runner's own stage-0 arithmetic
    cfg = Config(**_kw(1, "gpipe", BATCH))
    plan = get_plan(model="split_cnn_chain3")
    init = params_from_jax(_jax_init())
    s1, s2 = (StageRuntime(plan, i, cfg, init, microbatches=1,
                           apply_lag=0, device="cpu") for i in (1, 2))
    tx = make_tx(cfg)
    state = make_state(init_params(plan, init, torch.device("cpu"), (0,)),
                       tx)
    manual = []
    for step in range(steps):
        x, y = _batch(step)
        params = state.params[0]
        with torch.enable_grad():
            a = plan.stages[0].apply(params, torch.as_tensor(x))
        y1 = s1.hop_forward(a.detach(), step, 0, 0)
        g1, loss = s2.hop_loss(y1, y, step, 0, 0)
        g0 = s1.hop_backward(g1, step, 0, 0)
        grads = torch.autograd.grad(a, list(params.values()), g0)
        tx.update(state, [g.contiguous() for g in grads])
        manual.append(float(np.mean([loss])))
    for s in (s1, s2):
        ctr = s.counters()
        assert ctr["deferred_enqueued"] == ctr["deferred_applied"] == steps
        assert ctr["deferred_apply_depth"] == 0
    assert piped == manual


def test_m4_lag1_matches_jax():
    steps = 6
    ref = drive(jax_chain(4, 1), steps)
    chain = port_chain(4, 1)
    runner, stages, _ = chain
    got = drive(chain, steps)
    np.testing.assert_allclose(got, ref, atol=JAX_TOL, rtol=0)
    for s in stages:
        ctr = s.counters()
        assert ctr["deferred_enqueued"] == steps
        # closing flushes the lag's last entry
        assert ctr["deferred_applied"] == steps
        op = "hop_loss" if s.is_last else "hop_fwd"
        assert ctr[op] == 4 * steps


def test_1f1b_is_bit_equal_to_gpipe_and_reports_its_schedule():
    gpipe = drive(port_chain(4, 1), 4)
    chain = port_chain(4, 1, schedule="1f1b")
    runner = chain[0]
    onefb = drive(chain, 4)
    assert onefb == gpipe
    meta = runner.trace_metadata()
    assert meta["schedule"] == "1f1b" and meta["warmup_depth"] == 3
    assert meta["ticks_per_step"] == 6 and meta["steps"] == 4
    for row in meta["stages"]:
        assert row["bubble_theoretical"] == pytest.approx(2 / 6)
        assert row["schedule"] == "1f1b"
        # each hop worker's host busy time over the wall, unclipped: one
        # thread's share; the loss wire has no backward worker
        assert 0.0 < row["busy_share_forward"] <= 1.0
        last = row["stage"] == len(meta["stages"])
        assert (row["busy_share_backward"] is None) == last
        if not last:
            assert 0.0 < row["busy_share_backward"] <= 1.0
    plan = get_plan(model="split_cnn_chain3")
    with pytest.raises(ValueError, match="unknown schedule"):
        PipelineRunner(plan, Config(**_kw(2, "gpipe", BATCH)),
                       torch.Generator().manual_seed(0), None,
                       chain[2], microbatches=2, schedule="zigzag",
                       device="cpu")


def test_device_transport_is_bit_equal_to_local_with_no_host_copy():
    local = drive(port_chain(4, 1), 4)
    chain = port_chain(4, 1, transport="device")
    runner, _, wires = chain
    device = drive(chain, 4)
    assert device == local
    assert runner.trace_metadata()["device_native"] is True
    for t in wires:
        assert t.stats.counters.get(spans.HOP_HOST_COPIES, 0) == 0
        assert t.stats.round_trips == (4 * 4 if t.stage_index == 2
                                       else 2 * 4 * 4)
    # a numpy payload on the device wire is counted, not hidden: it and
    # its reply (which follows the request's kind) are two host copies
    plan = get_plan(model="split_cnn_chain3")
    cfg = Config(**_kw(1, "gpipe", BATCH))
    stage = StageRuntime(plan, 1, cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    wire = DeviceTransport(stage)
    y = wire.hop_forward(np.zeros((2, 26, 26, 32), np.float32), 0)
    assert isinstance(y, np.ndarray)
    assert wire.stats.counters[spans.HOP_HOST_COPIES] == 2
    for call in (lambda: wire.split_step(None, None, 0),
                 lambda: wire.u_forward(None, 0),
                 lambda: wire.u_backward(None, 0),
                 lambda: wire.aggregate(None, 0, 0.0, 0)):
        with pytest.raises(NotImplementedError, match="pipeline hops"):
            call()
    with pytest.raises(NotImplementedError, match="item 18"):
        DeviceTransport(stage, mesh=object())
    stage.close()
