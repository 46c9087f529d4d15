"""The port's FLOP and MFU accounting and its profiler against the JAX
package's (``utils/flops.py``, ``utils/profiling.py``,
``ServerRuntime.trace_metadata``), on the CPU:

- ``FusedSplitTrainer.step_flops`` equals JAX's (``jaxpr_matmul_flops``
  of the jitted step) exactly for the fused split CNN, a small ResNet-18
  step and a small ``transformer_lm`` step with ``attn="flash"`` and
  with dense attention (``attn="full"``);
- a strided convolution's input gradient counts as JAX's does, over
  the input's extent, which for ResNet-18 is more than the work done;
- the flash kernels (K5, K6), which ``FlopCounterMode`` cannot see, count
  4·B·H·T²·D forward and 3.5 times that forward and backward, causal or
  not. JAX's walker counts one kernel body: at B 1, H 2, D 64 and T a
  multiple of the 128-row block, where that body is the whole problem,
  the two counts are equal; elsewhere JAX's ignores B·H (its walker
  does not multiply by the grid) and the port keeps the model's count;
- ``device_peak_flops`` and ``mfu`` are None on the CPU;
- a traced server's ``trace_metadata`` has JAX's keys and JAX's model
  FLOPs for the split step; untraced it accounts nothing; the card's
  event windows are read off the step path (stand-in events);
- ``PhaseProfiler.summary()`` and ``fraction`` equal JAX's on the same
  samples; ``device_trace`` writes a Chrome trace.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu import obs as jax_obs
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime.fused import FusedSplitTrainer as JaxFused
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu.utils import flops as jax_flops
from split_learning_tpu.utils import profiling as jax_profiling
from split_learning_tpu_torch import obs
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.ops.flash_attention import flash_attention
from split_learning_tpu_torch.runtime import (
    FusedSplitTrainer, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils import flops, profiling
from split_learning_tpu_torch.utils.config import Config

LM = dict(d_model=128, num_heads=2, vocab=64, client_depth=1,
          server_depth=1)


@pytest.fixture(autouse=True)
def _tracers_off():
    obs.disable()
    jax_obs.disable()
    yield
    obs.disable()
    jax_obs.disable()


def _step_flops(model, x, y, **size):
    attn = size.pop("attn", "full")
    kw = dict(size, attn=attn) if size else {}
    jcfg = JaxConfig(model=model, attn=attn, transport="fused")
    tcfg = Config(model=model, attn=attn, transport="fused")
    jt = JaxFused(jax_get_plan(model=model, mode="split", **kw), jcfg,
                  jax.random.PRNGKey(0), x)
    tt = FusedSplitTrainer(get_plan(model=model, mode="split", **kw), tcfg,
                           torch.Generator().manual_seed(0), x, device="cpu")
    return tt.step_flops(x, y), jt.step_flops(x, y), tt


RS = np.random.RandomState(0)


@pytest.mark.parametrize("case", ["split_cnn", "resnet18", "lm_flash",
                                  "lm_dense"])
def test_step_flops_equal_jaxs(case):
    if case == "split_cnn":
        got, want, tt = _step_flops(
            "split_cnn", RS.rand(4, 28, 28, 1).astype(np.float32),
            RS.randint(0, 10, 4))
    elif case == "resnet18":
        got, want, tt = _step_flops(
            "resnet18", RS.rand(2, 32, 32, 3).astype(np.float32),
            RS.randint(0, 10, 2))
    else:
        x = RS.randint(0, 64, (1, 128)).astype(np.int32)
        got, want, tt = _step_flops(
            "transformer_lm", x, RS.randint(0, 64, (1, 128)),
            attn="flash" if case == "lm_flash" else "full", **LM)
    assert got == want
    # counted once a shape, on meta copies: the live state is untouched
    before = [t.clone() for st in tt.state.params for t in st.values()]
    assert tt.step_flops(_same_batch(case), _same_labels(case)) == got
    after = [t for st in tt.state.params for t in st.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def _same_batch(case):
    return {"split_cnn": np.zeros((4, 28, 28, 1), np.float32),
            "resnet18": np.zeros((2, 32, 32, 3), np.float32)}.get(
                case, np.zeros((1, 128), np.int32))


def _same_labels(case):
    return {"split_cnn": np.zeros(4, np.int64),
            "resnet18": np.zeros(2, np.int64)}.get(
                case, np.zeros((1, 128), np.int64))


@pytest.mark.parametrize("b,t,h,d", [(1, 256, 2, 64), (2, 256, 2, 64),
                                     (1, 128, 4, 32), (3, 100, 2, 24)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_counts_the_models_flops(b, t, h, d, causal):
    q = torch.zeros((b, t, h, d), requires_grad=True)
    fwd = flops.step_flops(lambda q, k, v: flash_attention(q, k, v, causal),
                           q, q, q)
    both = flops.step_flops(
        lambda q, k, v: torch.autograd.grad(
            flash_attention(q, k, v, causal).sum(), [q, k, v]), q, q, q)
    assert fwd == 4.0 * b * h * t * t * d
    assert both == 3.5 * fwd
    if (b, h, d) == (1, 2, 64) and t % 128 == 0:
        # JAX's walker sees the whole problem in one kernel body here
        qj = jnp.zeros((b, t, h, d))
        assert fwd == jax_flops.jaxpr_matmul_flops(
            lambda q, k, v: jax_flash(q, k, v, causal=causal), qj, qj, qj)
        assert both == jax_flops.jaxpr_matmul_flops(
            jax.grad(lambda q, k, v: jax_flash(q, k, v,
                                               causal=causal).sum(),
                     argnums=(0, 1, 2)), qj, qj, qj)


def test_strided_input_gradients_count_as_jaxs(monkeypatch):
    """JAX counts a strided convolution's input gradient over the input's
    extent, dilation zeros included: s² times the work done. For
    ResNet-18 on 32 x 32 images, whose three layers each open with a
    3x3 (padded by hand, ``conv_pad``) and a 1x1 convolution at stride
    2, each 2 · 2,097,152 · taps FLOPs a row forward, the count exceeds
    the work done by 3 times those forwards; the ratio is the factor by
    which the count raises ResNet-18's MFU."""
    n = 2
    x = RS.rand(n, 32, 32, 3).astype(np.float32)
    y = RS.randint(0, 10, n)

    def count():
        return FusedSplitTrainer(
            get_plan(model="resnet18", mode="split"),
            Config(model="resnet18", transport="fused"),
            torch.Generator().manual_seed(0), x,
            device="cpu").step_flops(x, y)
    jax_count = count()
    jaxs = flops._conv_backward_flops
    # the work done: the input gradient over the output's extent
    monkeypatch.setattr(
        flops, "_conv_backward_flops",
        lambda g, xs, w, *a, dx_shape=None, **k: jaxs(
            g, xs, w, *a, dx_shape=(xs[0], xs[1], *g[2:]), **k))
    done = count()
    strided_fwd = 3 * 2 * 2_097_152 * (9 + 1)
    assert jax_count - done == n * 3 * strided_fwd
    assert jax_count == 7_412_969_472 and done == 6_657_994_752
    assert jax_count / done == pytest.approx(1.1133937, rel=1e-7)


def test_peak_and_mfu_on_the_cpu():
    assert flops.device_peak_flops("cpu") is None
    assert flops.device_peak_flops(torch.device("cpu")) is None
    assert flops.mfu(1e12, None) is None
    assert flops.mfu(None, 989e12) is None
    assert flops.mfu(494.5e12, 989e12) == pytest.approx(0.5)
    assert flops.mfu(98.5e12, 197e12) == jax_flops.mfu(98.5e12, 197e12)
    assert jax_flops.device_peak_flops(jax.devices("cpu")[0]) is None


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_trace_metadata_has_jaxs_keys_and_flops():
    rs = np.random.RandomState(1)
    x = rs.rand(8, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.int32)
    jplan = jax_get_plan(mode="split")
    jserver = JaxServer(jplan, JaxConfig(batch_size=8),
                        jax.random.PRNGKey(0), x)
    init = params_from_jax(jplan.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    server = ServerRuntime(get_plan(), Config(batch_size=8), init,
                           device="cpu")
    client = SplitClientTrainer(get_plan(), Config(batch_size=8), init,
                                LocalTransport(server), device="cpu")
    # untraced: nothing accounted
    client.train_step(x, y, 0)
    assert server.trace_metadata()["programs"] == {}
    jax_obs.enable()
    acts = np.asarray(jplan.stages[0].apply(
        jplan.init(jax.random.PRNGKey(0), jnp.asarray(x))[0],
        jnp.asarray(x)))
    jserver.split_step(acts, y, 0)
    jax_obs.disable()
    obs.enable()
    for step in (1, 2):
        client.train_step(x, y, step)
    obs.disable()
    got, want = server.trace_metadata(), jserver.trace_metadata()
    assert _keys(got) == _keys(want)
    assert got["mesh"] == want["mesh"] and got["gather_bytes"] == 0
    prog, ref = got["programs"]["split_step"], want["programs"]["split_step"]
    assert prog["calls"] == 2 and ref["calls"] == 1
    assert prog["model_flops"] == 2 * ref["model_flops"] > 0
    assert prog["dispatch_s"] > 0 and prog["mfu"] is None
    assert got["peak_flops_per_device"] is None


class _Event:
    """A stand-in for a CUDA timing event: ``query``, ``synchronize`` and
    ``elapsed_time`` (ms) as the card's."""

    def __init__(self, at_ms, done=True):
        self.at_ms, self.done, self.waited = at_ms, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.at_ms - self.at_ms


def test_device_windows_are_read_off_the_step_path():
    """On the card a traced program's window is a pair of events recorded
    under the lock; ``_note_flops`` folds only the windows whose end has
    passed (no wait on the step path) and ``trace_metadata`` waits for
    the rest."""
    server = ServerRuntime(get_plan(), Config(batch_size=8),
                           params_from_jax(jax_get_plan(mode="split").init(
                               jax.random.PRNGKey(0),
                               jnp.zeros((8, 28, 28, 1)))),
                           device="cpu")
    a = torch.zeros(4, 4)
    pending = (_Event(10.0), _Event(13.0, done=False))
    server._note_flops("p", lambda x: x @ x, (a,), pending)
    server._note_flops("p", lambda x: x @ x, (a,), (_Event(20.0),
                                                     _Event(22.0)))
    assert server._prog_stats["p"] == [256.0, pytest.approx(2e-3), 2]
    assert not pending[1].waited and len(server._windows) == 1
    prog = server.trace_metadata()["programs"]["p"]
    assert pending[1].waited and server._windows == []
    assert prog["calls"] == 2 and prog["model_flops"] == 256.0
    assert prog["dispatch_s"] == pytest.approx(5e-3)


def test_phase_profiler_summary_equals_jaxs():
    rs = np.random.RandomState(5)
    samples = {"compute_fwd": list(rs.rand(17) * 0.01),
               "transport": list(rs.rand(17) * 0.05),
               "compute_bwd": list(rs.rand(3) * 0.02)}
    mine, ref = profiling.PhaseProfiler(), jax_profiling.PhaseProfiler()
    for prof in (mine, ref):
        for name, xs in samples.items():
            prof._samples[name].extend(xs)
    assert mine.summary() == ref.summary()
    assert mine.fraction("transport") == ref.fraction("transport")
    assert profiling.PhaseProfiler().fraction("transport") == 0.0
    with mine.phase("extra"):
        pass
    assert mine.summary()["extra"]["count"] == 1
    mine.reset()
    assert mine.summary() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(None):
        pass   # off: a no-op
    with profiling.device_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / "prof" / profiling.TRACE_FILE))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
