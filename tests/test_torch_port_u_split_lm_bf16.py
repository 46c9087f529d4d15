"""The U-shaped causal LM in bfloat16 against JAX's, on the CPU.

Part of tests/test_torch_port_u_split.py (its docstring gives the
setup and the tolerances), split off by family and dtype so that no
file's serial time sets the run's critical path: the loss series of the
bf16 LM over every wire mode.
"""

import pytest

from test_torch_port_u_split import WIRES, assert_u_pair_tracks_jax_pair


@pytest.mark.parametrize("compress", WIRES)
@pytest.mark.parametrize("dtype", ["bfloat16"])
@pytest.mark.parametrize("model", ["transformer_lm"])
def test_u_pair_tracks_jax_pair(model, dtype, compress):
    assert_u_pair_tracks_jax_pair(model, dtype, compress)
