"""Mixed pairs of the image families through the numpy ``Transport``, on
the CPU: a port client against a JAX server and the reverse, over the
JAX ``LocalTransport`` (a port client) or the port's (a JAX client),
each starting from one flax init of the whole plan (carried across with
``interop``). Two split steps on synthetic CIFAR-10 at batch 4 give the
JAX pair's losses within 1e-4, the parity bar of
tests/test_torch_parity.py. The ViT pairs run ``attn="full"`` on both
sides (JAX's Pallas flash in interpret mode makes each party's step
compile for tens of seconds; the flash path's parity is in
tests/test_torch_port_vit.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime import SplitClientTrainer as JaxClient
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import ServerRuntime, SplitClientTrainer
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

BATCH, STEPS = 4, 2
PORT_KW = {"resnet18": {}, "vit": {"channels": 3}}


def _train(client, data):
    return [client.train_step(x, y, i) for i, (x, y) in enumerate(data)]


@pytest.mark.parametrize("model,pair", [
    ("resnet18", "port_client_jax_server"),
    ("vit", "port_client_jax_server"),
    ("vit", "jax_client_port_server")])
def test_mixed_pairs_match_the_jax_pair(model, pair):
    ds = jax_synthetic("cifar10", n_train=BATCH * STEPS, n_test=4, seed=4)
    data = list(jax_batches(ds.train, BATCH, seed=4))
    jplan = jax_get_plan(model=model)
    jcfg = JaxConfig(model=model, batch_size=BATCH)

    def jax_server():
        return JaxServer(jplan, jcfg, jax.random.PRNGKey(0), data[0][0])

    j_losses = _train(JaxClient(jplan, jcfg, jax.random.PRNGKey(0),
                                JaxLocal(jax_server())), data)
    init = params_from_jax(jplan.init(jax.random.PRNGKey(0),
                                      jnp.asarray(data[0][0])))
    plan = get_plan(model=model, **PORT_KW[model])
    cfg = Config(model=model, batch_size=BATCH)
    if pair == "port_client_jax_server":
        client = SplitClientTrainer(plan, cfg, init, JaxLocal(jax_server()),
                                    device="cpu")
    else:
        server = ServerRuntime(plan, cfg, init, device="cpu")
        client = JaxClient(jplan, jcfg, jax.random.PRNGKey(0),
                           LocalTransport(server))
    np.testing.assert_allclose(_train(client, data), j_losses, atol=1e-4)
