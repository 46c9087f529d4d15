"""``evaluate_remote`` of the port (JAX's ``tests/test_split_inference.py``
on the port, and against JAX's):

- over ``LocalTransport(through_codec=True)`` and over HTTP it equals
  ``evaluate`` of the composed parameters (accuracy equal, loss within
  1e-5);
- ``predict`` moves neither the step handshake nor the server's weights;
- the port's ``evaluate_remote`` is within 1e-5 of JAX's on the same
  weights, dense and over ``int8`` (both sides quantize the same cut);
- the client stages see the cut tensor itself: ``transport.predict``
  receives a tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime.evaluate import (
    evaluate_remote as jax_evaluate_remote)
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.data.datasets import Split
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    ServerRuntime, evaluate, evaluate_remote)
from split_learning_tpu_torch.transport import (
    HttpTransport, LocalTransport, SplitHTTPServer)
from split_learning_tpu_torch.utils.config import Config


def _setup():
    rs = np.random.RandomState(0)
    x = rs.randn(48, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, (48,)).astype(np.int64)
    jax_params = jax_get_plan(mode="split").init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x[:16]))
    params = params_from_jax(jax_params)
    plan = get_plan()
    runtime = ServerRuntime(plan, Config(batch_size=16), params,
                            device="cpu")
    full = [{k: torch.as_tensor(v) for k, v in p.items()} for p in params]
    client = [full[i] for i in plan.stages_of("client")]
    return plan, runtime, full, client, Split(x=x, y=y), jax_params


@pytest.mark.parametrize("wire", ["local", "http"])
def test_remote_matches_full_composition(wire):
    plan, runtime, full, client, split, _ = _setup()
    srv = None
    if wire == "local":
        transport = LocalTransport(runtime, through_codec=True)
    else:
        srv = SplitHTTPServer(runtime).start()
        transport = HttpTransport(srv.url, timeout=30)
    try:
        want = evaluate(plan, full, split, batch_size=24)
        got = evaluate_remote(plan, client, transport, split, batch_size=24)
    finally:
        if srv is not None:
            transport.close()
            srv.stop()
    assert got["examples"] == want["examples"] == 48
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == want["accuracy"]


def test_predict_does_not_advance_the_handshake():
    plan, runtime, full, client, split, _ = _setup()
    transport = LocalTransport(runtime)
    acts = plan.stages[0].apply(client[0], torch.from_numpy(split.x[:4]))
    before = next(iter(runtime.params.values())).detach().clone()
    out = transport.predict(acts.detach())
    assert out.shape == (4, 10)
    transport.predict(acts.detach().numpy())
    assert runtime.health()["step"] == -1
    assert torch.equal(before, next(iter(runtime.params.values())))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_remote_matches_jax_evaluate_remote(compress):
    """The same weights on both stacks, the same wire mode: the port's
    split-party metrics within 1e-5 of JAX's."""
    plan, runtime, full, client, split, jax_params = _setup()
    jrt = JaxServer(jax_get_plan(mode="split"), JaxConfig(batch_size=16),
                    jax.random.PRNGKey(0), split.x[:16])
    jax_client = [jax_params[i] for i in plan.stages_of("client")]
    from split_learning_tpu.data.datasets import Split as JaxSplit
    want = jax_evaluate_remote(
        jax_get_plan(mode="split"), jax_client,
        JaxLocal(jrt, through_codec=compress is None, compress=compress),
        JaxSplit(x=split.x, y=split.y), batch_size=16)
    got = evaluate_remote(plan, client,
                          LocalTransport(runtime, through_codec=compress
                                         is None, compress=compress),
                          split, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == want["accuracy"]
    assert got["predictions"] == want["predictions"]


def test_predict_receives_the_cut_tensor():
    plan, runtime, full, client, split, _ = _setup()
    seen = []

    class _Spy(LocalTransport):
        def predict(self, activations, client_id=0):
            seen.append(activations)
            return super().predict(activations, client_id)

    evaluate_remote(plan, client, _Spy(runtime, compress="int8"), split,
                    batch_size=16)
    assert len(seen) == 3
    assert all(isinstance(a, torch.Tensor) and a.shape == (16, 26, 26, 32)
               and not a.requires_grad for a in seen)
