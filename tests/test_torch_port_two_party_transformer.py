"""The two-party sequence classifier (``transformer``) against the JAX
pair, on the CPU: tests/test_torch_port_two_party_lm.py's check (loss
series, wire totals, dtypes) on the other transformer family, in
float32 and bfloat16 over ``none``, ``int8`` and ``topk8``, with that
file's tolerances (its docstring derives them).
"""

import pytest

from test_torch_port_two_party_lm import assert_pair_tracks_jax


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_party_classifier_tracks_jax_pair(dtype, compress):
    assert_pair_tracks_jax("transformer", dtype, compress)
