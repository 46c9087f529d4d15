"""Mixed chains across the frameworks, and ResNet-18 in four stages.

- A port ``PipelineRunner`` driving JAX ``StageRuntime`` parties through
  JAX ``LocalTransport``s, and a JAX runner driving port stages through
  JAX's transport: ``split_cnn_chain3``, M 2, lag 1, 4 steps, each
  within 1e-4 of the all-JAX chain (cross-framework float32 drift, the
  bar of ``tests/test_torch_parity.py``). A foreign wire gets host
  numpy, as JAX's runner sends; the port's stage replies numpy to numpy.
- ``resnet18_4stage`` (the hub's stem and layer1, layer2, layer3, the
  head) at batch 8, M 2, 2 steps: within 1e-4 of JAX's chain, as
  ``tests/test_torch_port_resnet_train.py`` holds the fused ResNet-18.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.pipeline_runner import (
    PipelineRunner as JaxRunner)
from split_learning_tpu.runtime.stage import StageRuntime as JaxStage
from split_learning_tpu.transport.local import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.pipeline_runner import PipelineRunner
from split_learning_tpu_torch.runtime.stage import StageRuntime
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config
from test_torch_port_chain import (
    BATCH, JAX_TOL, SEED, SHAPE, _jax_init, _kw, drive, jax_chain)

M, LAG, STEPS = 2, 1, 4


def _port_stages(init, cfg):
    plan = get_plan(model="split_cnn_chain3")
    return [StageRuntime(plan, i, cfg, init, microbatches=M, apply_lag=LAG,
                         device="cpu") for i in (1, 2)]


def test_port_runner_drives_jax_stages():
    want = drive(jax_chain(M, LAG), STEPS)
    cfg = JaxConfig(**_kw(M, "gpipe", BATCH))
    jplan = jax_get_plan(model="split_cnn_chain3", mode="split")
    sample = np.zeros((BATCH,) + SHAPE, np.float32)
    stages = [JaxStage(jplan, i, cfg, jax.random.PRNGKey(SEED), sample,
                       microbatches=M, apply_lag=LAG) for i in (1, 2)]
    runner = PipelineRunner(get_plan(model="split_cnn_chain3"),
                            Config(**_kw(M, "gpipe", BATCH)),
                            params_from_jax(_jax_init()), None,
                            [JaxLocal(s) for s in stages], microbatches=M,
                            device="cpu")
    got = drive((runner, stages, None), STEPS)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
    assert runner.trace_metadata()["device_native"] is False
    for s in stages:
        assert s.counters()["deferred_enqueued"] == STEPS


def test_jax_runner_drives_port_stages():
    want = drive(jax_chain(M, LAG), STEPS)
    stages = _port_stages(params_from_jax(_jax_init()),
                          Config(**_kw(M, "gpipe", BATCH)))
    cfg = JaxConfig(**_kw(M, "gpipe", BATCH))
    runner = JaxRunner(jax_get_plan(model="split_cnn_chain3", mode="split"),
                       cfg, jax.random.PRNGKey(SEED),
                       np.zeros((BATCH,) + SHAPE, np.float32),
                       [JaxLocal(s) for s in stages], microbatches=M)
    got = drive((runner, stages, None), STEPS)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
    for s in stages:
        ctr = s.counters()
        assert ctr["deferred_enqueued"] == ctr["deferred_applied"] == STEPS
    # numpy in, numpy out: the JAX runner's contract
    out = stages[0].hop_forward(np.zeros((2, 26, 26, 32), np.float32),
                                STEPS, 0)
    assert isinstance(out, np.ndarray) and out.shape == (2, 9216)
    assert isinstance(stages[0].hop_forward(torch.zeros(2, 26, 26, 32),
                                            STEPS, 1), torch.Tensor)


def test_resnet18_4stage_chain_matches_jax():
    b = 8
    ds = jax_synthetic("cifar10", n_train=b * 2, n_test=4, seed=3)
    data = list(jax_batches(ds.train, b, seed=3))
    kw = dict(mode="split", model="resnet18_4stage", batch_size=b,
              num_stages=4, microbatches=M, seed=SEED)
    jplan = jax_get_plan(model="resnet18_4stage", mode="split")
    sample = np.zeros((b, 32, 32, 3), np.float32)
    key = jax.random.PRNGKey(SEED)
    jcfg = JaxConfig(**kw)
    jstages = [JaxStage(jplan, i, jcfg, key, sample, microbatches=M)
               for i in (1, 2, 3)]
    jrunner = JaxRunner(jplan, jcfg, key, sample,
                        [JaxLocal(s) for s in jstages], microbatches=M)
    want = drive((jrunner, jstages, None), 2, data=data)

    plan = get_plan(model="resnet18_4stage")
    init = params_from_jax(jplan.init(key, jnp.asarray(sample)))
    cfg = Config(**kw)
    stages = [StageRuntime(plan, i, cfg, init, microbatches=M,
                           device="cpu") for i in (1, 2, 3)]
    runner = PipelineRunner(plan, cfg, init, None,
                            [LocalTransport(s) for s in stages],
                            microbatches=M, device="cpu")
    got = drive((runner, stages, None), 2, data=data)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
    for s in stages:
        assert s.counters()["deferred_applied"] == 2   # one a step
