"""K3 (int8 quantize/dequantize), K4 (top-k magnitudes) and the wire codec
of the port against the JAX package.

- The plain versions of K3 and K4 (what a CPU tensor runs) against the
  JAX Pallas kernels in interpret mode: ``q``, ``idx``, magnitudes,
  decode and residual equal, the scale equal in float32. The full cut
  tensor ``[64, 26, 26, 32]`` takes JAX's gridded path.
- Wire frames: for the same input, ``codec.encode`` of the port's q8 and
  topk8 dicts is byte-equal to JAX's (index and bitmap forms, three EF
  steps with decay 1 and 0.5), and each side decodes the other's frames
  to equal arrays. The port's codec on a CPU tensor (the device path with
  the plain versions) gives the numpy path's frames.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.ops import quantize as jq
from split_learning_tpu.ops import topk as jk
from split_learning_tpu.transport import codec as jc
from split_learning_tpu_torch.ops import quantize as pq
from split_learning_tpu_torch.ops import topk as pk
from split_learning_tpu_torch.transport import codec as pc

CUT = (64, 26, 26, 32)


def _rand(shape, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


QUANT_CASES = {
    "cut8": _rand((8, 26, 26, 32)),
    "cut64": _rand(CUT, 1),
    "zeros": np.zeros((8, 26, 26, 32), np.float32),
    "odd": _rand((1001,), 2),
    "halves": (np.arange(-127, 128, dtype=np.float32) + 0.5).clip(-127, 127),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_matches_jax(case):
    x = QUANT_CASES[case]
    qj, sj = jq.quantize_int8(jnp.asarray(x))
    qp, sp = pq.quantize_int8(torch.from_numpy(x))
    assert tuple(qp.shape) == np.asarray(qj).shape
    assert qp.shape[0] % 32 == 0 and qp.shape[1] == 128
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    assert np.float32(sp.item()) == np.float32(sj)
    dj = jq.dequantize_int8(qj, sj, x.shape)
    dp = pq.dequantize_int8(qp, sp, x.shape)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(
        pq.quantize_dequantize(torch.from_numpy(x)).numpy(),
        np.asarray(jq.quantize_dequantize(jnp.asarray(x))))


def test_quantize_rounds_half_to_even():
    """x / scale exactly k + 0.5 rounds to the even neighbour (rint), as
    jnp.round and np.round do; roundf would round away from zero."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, scale = pq.quantize_int8(x)
    assert scale.item() == 1.0
    assert q.reshape(-1)[:6].tolist() == [127, 0, 2, 2, 0, -2]


def test_quantize_empty_tensor():
    q, scale = pq.quantize_int8(torch.zeros(0))
    assert tuple(q.shape) == (32, 128) and not q.any()
    assert scale.item() == np.float32(1e-12)


@pytest.mark.parametrize("shape", [(8, 26, 26, 32), CUT])
def test_magnitudes_match_jax(shape):
    x = _rand(shape, 3)
    np.testing.assert_array_equal(pk.magnitudes(torch.from_numpy(x)).numpy(),
                                  np.asarray(jk.magnitudes(jnp.asarray(x))))


@pytest.mark.parametrize("case", ["cut8", "cut64", "ties"])
def test_topk8_encode_decode_residual_match_jax(case):
    """Same idx in lax.top_k's order (descending magnitude, ties toward
    the lower index), same q and scale; then decode and residual."""
    x = {"cut8": _rand((8, 26, 26, 32), 4), "cut64": _rand(CUT, 5),
         "ties": np.ones((4, 64), np.float32)}[case]
    k = 10 if case == "ties" else int(math.ceil(0.1 * x.size))
    ij, qj, sj = jk.topk8_encode(jnp.asarray(x), k)
    ip, qp, sp = pk.topk8_encode(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    assert np.float32(sp.item()) == np.float32(sj)
    if case == "ties":
        np.testing.assert_array_equal(ip.numpy(), np.arange(10))
    np.testing.assert_array_equal(
        pk.topk8_decode(ip, qp, sp, x.shape).numpy(),
        np.asarray(jk.topk8_decode(ij, qj, sj, x.shape)))
    np.testing.assert_array_equal(
        pk.topk8_residual(torch.from_numpy(x), ip, qp, sp).numpy(),
        np.asarray(jk.topk8_residual(jnp.asarray(x), ij, qj, sj)))
    np.testing.assert_array_equal(
        pk.topk8_roundtrip(torch.from_numpy(x), k).numpy(),
        np.asarray(jk.topk8_roundtrip(jnp.asarray(x), k)))


def test_select_topk_is_the_codec_rule():
    """Ascending indices: everything above the k-th largest magnitude,
    then the first ties by index (codec._topk8_select_numpy)."""
    m = torch.tensor([1.0, 3.0, 2.0, 2.0, 0.5, 2.0, 3.0])
    idx, sel = pk.select_topk(m, 4)
    assert idx.tolist() == [1, 2, 3, 6]
    assert sel.tolist() == [False, True, True, True, False, False, True]
    want, _ = jc._topk8_select_numpy(m.numpy(), 4)
    assert idx.tolist() == want.tolist()


# --------------------------------------------------------------------- #
# wire frames

def test_q8_frames_byte_equal_jax_and_cross_decode():
    x = np.maximum(_rand((8, 26, 26, 32), 6), 0)
    body_j = jc.encode({"activations": jc.q8_compress(x)})
    body_p = pc.encode({"activations": pc.q8_compress(x)})
    body_t = pc.encode({"activations": pc.q8_compress(torch.from_numpy(x))})
    assert body_p == body_j
    assert body_t == body_j
    want = jc.decompress_tree(jc.decode(body_p))["activations"]
    np.testing.assert_array_equal(
        pc.decompress_tree(pc.decode(body_j))["activations"], want)
    got = pc.decompress_tree(pc.decode(body_j), torch.device("cpu"))
    np.testing.assert_array_equal(got["activations"].numpy(), want)


@pytest.mark.parametrize("density,form", [(0.1, "m"), (0.01, "idx")])
@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_topk8_ef_frames_byte_equal_jax(density, form, decay):
    """Three error-feedback steps through each side's TopK8EF: the same
    frames (bitmap form at density 0.1, index form at 0.01), the same
    residuals, and each side decodes the other's frames."""
    ef_j, ef_p, ef_t = jc.TopK8EF(), pc.TopK8EF(), pc.TopK8EF()
    for step in range(3):
        x = _rand((8, 26, 26, 32), 10 + step)
        d_j = ef_j.compress("k", x, density, decay=decay)
        d_p = ef_p.compress("k", x, density, decay=decay)
        d_t = ef_t.compress("k", torch.from_numpy(x), density, decay=decay)
        assert form in d_j
        body_j = jc.encode(d_j)
        assert pc.encode(d_p) == body_j
        assert pc.encode(d_t) == body_j
        np.testing.assert_array_equal(ef_p.residual("k"), ef_j._res["k"])
        np.testing.assert_array_equal(ef_t.residual("k").numpy(),
                                      ef_j._res["k"])
        want = jc.decompress_tree(jc.decode(body_j))
        np.testing.assert_array_equal(
            jc.decompress_tree(jc.decode(pc.encode(d_t))), want)
        np.testing.assert_array_equal(
            pc.decompress_tree(pc.decode(body_j)), want)
        np.testing.assert_array_equal(
            pc.decompress_tree(pc.decode(body_j),
                               torch.device("cpu")).numpy(), want)


def test_bfloat16_tensor_frames_equal_jax():
    """A bfloat16 tensor is encoded from its float32 values and keeps its
    dtype name, as JAX's codec does with an ml_dtypes array."""
    x32 = _rand((4, 26, 26, 32), 7)
    x_j = np.asarray(jnp.asarray(x32, jnp.bfloat16))
    x_t = torch.from_numpy(x32).to(torch.bfloat16)
    assert pc.encode(pc.q8_compress(x_t)) == jc.encode(jc.q8_compress(x_j))
    d_j, _ = jc.topk8_compress(x_j, 0.1)
    d_t, _ = pc.topk8_compress(x_t, 0.1)
    assert pc.encode(d_t) == jc.encode(d_j)
    out = pc.decompress_tree(pc.decode(jc.encode(d_j)), torch.device("cpu"))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.float().numpy(),
        np.asarray(jc.topk8_decompress(d_j)).astype(np.float32))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_non_finite_refused(bad, kind):
    x = _rand((4, 10), 8)
    x[1, 3] = bad
    arr = torch.from_numpy(x) if kind == "tensor" else x
    with pytest.raises(pc.CodecError, match="non-finite"):
        pc.q8_compress(arr)
    with pytest.raises(pc.CodecError, match="non-finite"):
        pc.topk8_compress(arr, 0.5)
    with pytest.raises(jc.CodecError, match="non-finite"):
        jc.q8_compress(x)


def test_empty_and_full_density():
    for arr in (np.zeros((0, 3), np.float32), torch.zeros(0, 3)):
        d = pc.q8_compress(arr)
        assert d["scale"] == 1e-12
        dt, res = pc.topk8_compress(arr, 0.1)
        assert dt["n"] == 0 and dt["scale"] == 1e-12 and res.shape == (0, 3)
    x = _rand((3, 5), 9)
    d_j, _ = jc.topk8_compress(x, 1.0)
    d_t, _ = pc.topk8_compress(torch.from_numpy(x), 1.0)
    assert pc.encode(d_t) == jc.encode(d_j)


def test_ef_ledgers_and_leaf_bytes():
    clap = pc.make_wire_ef("clapping")
    assert isinstance(clap, pc.ClappingEF)
    clap.compress(("acts", 0), torch.ones(4, 8), 0.25)
    assert clap.export_state() == []
    clap.restore_state([{"key": ["acts", 0], "res": np.zeros(4)}])
    assert clap.merge_state([{"key": "x", "res": np.zeros(4)}]) == 0
    with pytest.raises(pc.CodecError):
        pc.make_wire_ef("bogus")
    ef = pc.make_wire_ef("topk8")
    ef.compress(("acts", 0), torch.ones(4, 8), 0.25)
    (rec,) = ef.export_state()
    assert rec["key"] == ["acts", 0] and isinstance(rec["res"], np.ndarray)
    back = pc.TopK8EF()
    back.restore_state([rec])
    np.testing.assert_array_equal(back.residual(("acts", 0)), rec["res"])
    ef.rollback(("acts", 0))
    assert ef.residual(("acts", 0)) is None
    assert pc.ef_decay_for("acts") == jc.ef_decay_for("acts") == 0.5
    assert pc.ef_decay_for("/forward_pass") == 1.0
    x = _rand((8, 26, 26, 32), 11)
    tree_p = {"a": pc.q8_compress(x), "g": pc.topk8_compress(x, 0.1)[0],
              "labels": np.arange(8)}
    tree_j = {"a": jc.q8_compress(x), "g": jc.topk8_compress(x, 0.1)[0],
              "labels": np.arange(8)}
    assert pc.compressed_leaf_bytes(tree_p) == jc.compressed_leaf_bytes(
        tree_j)
    assert pc.checksum(pc.encode(tree_p)) == jc.checksum(jc.encode(tree_j))
