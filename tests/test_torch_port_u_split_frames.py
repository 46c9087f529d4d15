"""The U hops' frames on the local wire, and the mixed U pairs, on the
CPU.

Part of tests/test_torch_port_u_split.py (its docstring gives the
setup and the tolerances), split off so that no file's serial time sets
the run's critical path: every frame of both hops, each way, byte-equal
to JAX's ``LocalTransport``'s in float32 and bfloat16 on each
compressed wire; a port client against a JAX server and the reverse,
on the local wire and over HTTP, tracking the JAX pair.
"""

import numpy as np
import pytest

from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu.transport.http import SplitHTTPServer as JaxHTTPServer
from split_learning_tpu_torch.transport import (
    HttpTransport, LocalTransport, SplitHTTPServer)

from test_torch_port_u_split import (
    F32_TOL, MODELS, _data, _http_pair, _jax_client, _jax_pair, _jax_server,
    _port_client, _port_server, _train, assert_u_hop_frames_local)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", ["none", "int8", "topk8", "clapping"])
def test_u_hop_frames_byte_equal_to_jax_local(compress, dtype):
    assert_u_hop_frames_local(compress, dtype)


@pytest.mark.parametrize("wire", ["local", "http"])
@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
@pytest.mark.parametrize("model", MODELS)
def test_u_mixed_pairs(model, pair, wire):
    compress = "int8"
    j_losses, _ = _jax_pair(model, "float32", compress)
    if pair == "port_client_jax_server":
        server, client_fn = _jax_server(model, "float32"), (
            lambda t: _port_client(model, "float32", t))
        server_cls, transport_cls = JaxHTTPServer, HttpTransport
    else:
        server, client_fn = _port_server(model, "float32"), (
            lambda t: _jax_client(model, "float32", t))
        server_cls, transport_cls = SplitHTTPServer, JaxHttp
    if wire == "local":
        local = JaxLocal if pair == "port_client_jax_server" \
            else LocalTransport
        losses = _train(client_fn(local(server, compress=compress)),
                        _data(model))
    else:
        losses = _http_pair(server, server_cls, transport_cls, client_fn,
                            model, compress)
    np.testing.assert_allclose(losses, j_losses, atol=F32_TOL[compress])
