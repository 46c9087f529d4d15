"""The U-shaped CNN in bfloat16 against JAX's, on the CPU, and the U
hops' request frames over HTTP against JAX's.

Part of tests/test_torch_port_u_split.py (its docstring gives the
setup and the tolerances), split off by family, dtype and wire so that
no file's serial time sets the run's critical path: the loss series of
the bf16 CNN over every wire mode, and the HTTP request frames of both
hops byte-equal to JAX's client's.
"""

import numpy as np
import pytest

from split_learning_tpu.transport.http import HttpTransport as JaxHttp
from split_learning_tpu_torch.transport import HttpTransport, SplitHTTPServer

from test_torch_port_u_split import (
    TIMEOUT, WIRES, _capture_http, _hop_tensors, _hops, _port_server,
    assert_u_pair_tracks_jax_pair)


@pytest.mark.parametrize("compress", WIRES)
@pytest.mark.parametrize("dtype", ["bfloat16"])
@pytest.mark.parametrize("model", ["split_cnn"])
def test_u_pair_tracks_jax_pair(model, dtype, compress):
    assert_u_pair_tracks_jax_pair(model, dtype, compress)


@pytest.mark.parametrize("compress", ["none", "int8", "topk8", "clapping"])
def test_u_hop_frames_byte_equal_to_jax_http(compress):
    acts = _hop_tensors("float32")
    frames = {}
    for side in ("jax", "port"):
        srv = SplitHTTPServer(_port_server()).start()
        bodies = _capture_http(srv)
        cls = JaxHttp if side == "jax" else HttpTransport
        t = cls(srv.url, timeout=TIMEOUT, compress=compress)
        try:
            _hops(t, acts, as_tensor=side == "port")
        finally:
            t.close()
            srv.stop()
        frames[side] = bodies
    assert [p for p, _ in frames["port"]] == ["/u_forward",
                                              "/u_backward"] * 3
    assert frames["port"] == frames["jax"]
