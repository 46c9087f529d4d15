"""The port's ``PipelinedSplitClientTrainer`` against JAX's, on the CPU
(the cases of tests/test_pipelined_client.py, on the port).

- depth 1 is ``SplitClientTrainer`` bit for bit (losses and the client's
  parameters): the recomputed backward runs the same operations as the
  kept graph's;
- depth 2 against JAX's pipelined client, one flax init carried across,
  through a transport that answers the lanes in step order (so the
  server sees the same sequence in both): losses within 1e-4, the
  client's parameters within 1e-5 (the two-party float32 bar,
  ``PERF.md`` §2);
- the window keeps each in-flight step's parameters although the
  updates are in place (copy-on-write);
- a fault in the middle of the window raises and the lanes quiesce;
  depth is validated.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import (
    PipelinedSplitClientTrainer as JaxPipelined)
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    PipelinedSplitClientTrainer, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import (
    FaultInjector, FaultyTransport, LocalTransport, TransportError)
from split_learning_tpu_torch.utils.config import Config

SEED = 42
BATCH = 16
SAMPLE = np.zeros((BATCH, 28, 28, 1), np.float32)
LOSS_TOL, PARAM_TOL = 1e-4, 1e-5


def _batches(n_steps, seed=123):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BATCH, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, (BATCH,)).astype(np.int64))
            for _ in range(n_steps)]


def _init(seed=SEED):
    return params_from_jax(jax_get_plan(mode="split").init(
        jax.random.PRNGKey(seed), jnp.asarray(SAMPLE)))


CFG = Config(mode="split", batch_size=BATCH, lr=0.01)


def _server(strict=True):
    return ServerRuntime(get_plan(), CFG, _init(), strict_steps=strict,
                         device="cpu")


class InOrder:
    """A transport wrapper that lets each lane's call through only when
    its step is the next one, so the server sees the steps in order
    whatever the lanes' timing."""

    def __init__(self, inner, first=0):
        self.inner = inner
        self.stats = inner.stats
        self._next = first
        self._cond = threading.Condition()

    def split_step(self, acts, labels, step, client_id=0):
        with self._cond:
            assert self._cond.wait_for(lambda: self._next == step,
                                       timeout=60)
            try:
                return self.inner.split_step(acts, labels, step, client_id)
            finally:
                self._next += 1
                self._cond.notify_all()

    def close(self):
        pass


def test_depth1_equals_the_synchronous_client():
    batches = _batches(8)
    sync = SplitClientTrainer(get_plan(), CFG, _init(),
                              LocalTransport(_server()), device="cpu")
    sync_losses = [sync.train_step(x, y, i)
                   for i, (x, y) in enumerate(batches)]
    piped = PipelinedSplitClientTrainer(get_plan(), CFG, _init(),
                                        LocalTransport(_server()), depth=1,
                                        device="cpu")
    records = piped.train(lambda: iter(batches), epochs=1)
    piped.close()
    assert [r.loss for r in records] == sync_losses
    for k, v in piped.params.items():
        assert torch.equal(v, sync.params[k]), k


@pytest.fixture(scope="module")
def jax_depth2():
    batches = _batches(8)
    jcfg = JaxConfig(mode="split", batch_size=BATCH, lr=0.01)
    plan = jax_get_plan(mode="split")
    server = JaxServer(plan, jcfg, jax.random.PRNGKey(SEED), SAMPLE,
                       strict_steps=False)
    piped = JaxPipelined(plan, jcfg, jax.random.PRNGKey(SEED),
                         InOrder(JaxLocal(server)), depth=2)
    records = piped.train(lambda: iter(batches), epochs=1)
    piped.close()
    params = params_from_jax([piped.state.params, server.state.params])[0]
    return batches, records, {k: np.asarray(v) for k, v in params.items()}


def test_depth2_matches_jax(jax_depth2):
    batches, want, want_params = jax_depth2
    piped = PipelinedSplitClientTrainer(
        get_plan(), CFG, _init(), InOrder(LocalTransport(_server(False))),
        depth=2, device="cpu")
    got = piped.train(lambda: iter(batches), epochs=1)
    piped.close()
    assert [r.step for r in got] == [r.step for r in want] == list(range(8))
    np.testing.assert_allclose([r.loss for r in got],
                               [r.loss for r in want], rtol=0,
                               atol=LOSS_TOL)
    for k, v in piped.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want_params[k],
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_in_flight_steps_keep_their_parameters():
    """Each step's backward runs at the parameters its forward used: the
    window's entries are recorded at submit time and compared, bit for
    bit, when applied, after the in-place updates of earlier steps."""
    batches = _batches(6)
    piped = PipelinedSplitClientTrainer(
        get_plan(), CFG, _init(), LocalTransport(_server(False)), depth=3,
        device="cpu")
    at_submit, checked = {}, []
    submit, apply = piped._submit, piped._apply

    def recording_submit(lane, acts, y, step):
        at_submit[step] = {k: v.detach().clone()
                           for k, v in piped.state.params[0].items()}
        return submit(lane, acts, y, step)

    def checking_apply(entry):
        for k, v in entry[0].items():
            assert torch.equal(v, at_submit[entry[3]][k]), (entry[3], k)
        checked.append(entry[3])
        return apply(entry)
    piped._submit, piped._apply = recording_submit, checking_apply
    piped.train(lambda: iter(batches), epochs=1)
    piped.close()
    assert checked == list(range(6))
    assert not all(torch.equal(at_submit[0][k], at_submit[5][k])
                   for k in at_submit[0])


def test_fault_mid_window_raises_and_quiesces():
    batches = _batches(12)
    faulty = FaultyTransport(LocalTransport(_server(False)),
                             FaultInjector(fail_steps={5}))
    piped = PipelinedSplitClientTrainer(get_plan(), CFG, _init(), faulty,
                                        depth=3, device="cpu")
    with pytest.raises(TransportError, match="injected fault"):
        piped.train(lambda: iter(batches), epochs=1)
    piped.close()  # joins the lanes without hanging
    assert piped._pool._shutdown


def test_depth_validation_and_merged_stats():
    with pytest.raises(ValueError, match="depth"):
        PipelinedSplitClientTrainer(get_plan(), CFG, _init(),
                                    LocalTransport(None), depth=0,
                                    device="cpu")
    with pytest.raises(ValueError, match="stage 0"):
        PipelinedSplitClientTrainer(get_plan(mode="u_split"),
                                    Config(mode="u_split"), _init(),
                                    LocalTransport(None), device="cpu")
    lanes = [LocalTransport(_server(False)) for _ in range(2)]
    it = iter(lanes[1:])
    piped = PipelinedSplitClientTrainer(get_plan(), CFG, _init(), lanes[0],
                                        depth=2, device="cpu",
                                        transport_factory=lambda: next(it))
    piped.train(lambda: iter(_batches(4)), epochs=1)
    piped.close()
    assert piped.stats.round_trips == 4
    assert [t.stats.round_trips for t in lanes] == [2, 2]
    tree = piped.export_states()
    assert set(tree) == {"client"}  # lanes keep a ledger each


def test_entry_points_default_to_the_card_and_raise_without_one():
    """No fallback: without ``device`` the pipelined client and a
    coalescing or decoupled server ask for CUDA and raise here."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; this machine has a GPU")
    for kw in (dict(coalesce_max=4), dict(decouple_bwd=True, apply_lag=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            ServerRuntime(get_plan(), CFG, _init(), **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        PipelinedSplitClientTrainer(get_plan(), CFG, _init(),
                                    LocalTransport(_server()), depth=2)
