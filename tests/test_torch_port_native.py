"""The port's native host codec (``split_learning_tpu_torch/native``)
against the JAX package's numpy codec.

- The C++ library builds with g++ into its cache directory and its ops
  match the numpy formulas bit for bit (the absmax scale, round-half-even
  quantization on exact halves, the topk8 selection rule with its
  lowest-index ties, the scatter, zlib's CRC-32), at every thread count
  above the library's per-thread floor.
- The port's host codec line (numpy inputs) now runs on it: its q8 and
  topk8 frames, with and without error feedback, are byte-equal to
  ``split_learning_tpu/transport/codec.py``'s on seeded inputs, and to
  the port's own ``SLT_NO_NATIVE=1`` numpy line.
- No quiet fallback: a failed build raises with g++'s message, from the
  codec call too; ``SLT_NO_NATIVE`` is the one way onto the numpy line.
"""

import zlib

import numpy as np
import pytest

from split_learning_tpu.transport import codec as jc
from split_learning_tpu_torch import native
from split_learning_tpu_torch.native import codec as ncodec
from split_learning_tpu_torch.transport import codec as pc


def _rand(shape, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _numpy_q8(a):
    scale = max(float(np.max(np.abs(a))) / 127.0, 1e-12) if a.size else 1e-12
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("SLT_NO_NATIVE", raising=False)


def test_builds_into_the_cache_directory():
    assert native.available()
    assert native.build_error() is None
    path = ncodec.library_path()
    assert path.exists() and path.parent == ncodec.cache_dir()
    assert path.name.startswith("slt_codec-") and path.suffix == ".so"


@pytest.mark.parametrize("shape", [(64, 26, 26, 32), (1,), (17, 3), (0,),
                                   (8, 1024, 16)])
def test_quantize_matches_numpy(shape):
    a = _rand(shape, 1, 5.0)
    q_nat, s_nat = native.q8_quantize(a)
    q_np, s_np = _numpy_q8(a)
    assert s_nat == s_np
    np.testing.assert_array_equal(q_nat, q_np)


def test_quantize_declines_other_dtypes():
    assert native.q8_quantize(np.ones(4, np.float64)) is None
    assert native.topk8_select(np.ones(4, np.float64), 2) is None


def test_dequantize_matches_numpy():
    q = np.random.RandomState(2).randint(-127, 128, (1000,)).astype(np.int8)
    out = native.q8_dequantize(q, 0.037)
    np.testing.assert_array_equal(out, q.astype(np.float32)
                                  * np.float32(0.037))


@pytest.mark.parametrize("data", [b"", b"hello", bytes(range(256)) * 100])
def test_crc32_matches_zlib(data):
    assert native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF
    assert native.crc32(data) == pc.checksum(data)


@pytest.mark.parametrize("n,k", [(100, 10), (2_163_200, 216_320),
                                 (513 * 128 + 7, 1000), (50, 50), (17, 1)])
def test_topk8_select_matches_numpy(n, k):
    a = _rand((n,), 4)
    idx_n, vals_n = native.topk8_select(a, k)
    idx_p, vals_p = pc._topk8_select_numpy(a, k)
    np.testing.assert_array_equal(idx_n, idx_p)
    np.testing.assert_array_equal(vals_n, vals_p)


@pytest.mark.parametrize("k", [1, 7, 500, 9_999])
def test_topk8_select_tie_rule(k):
    """Heavy ties at the threshold: both keep the lowest indices."""
    a = np.random.RandomState(5).choice(
        [-2.0, -1.0, 1.0, 2.0], size=10_000).astype(np.float32)
    idx_n, vals_n = native.topk8_select(a, k)
    idx_p, vals_p = pc._topk8_select_numpy(a, k)
    np.testing.assert_array_equal(idx_n, idx_p)
    np.testing.assert_array_equal(vals_n, vals_p)


def test_topk8_scatter_matches_numpy():
    rs = np.random.RandomState(7)
    n, k = 500_000, 50_000
    idx = np.sort(rs.choice(n, size=k, replace=False)).astype(np.int64)
    q = rs.randint(-127, 128, k).astype(np.int8)
    ref = np.zeros(n, np.float32)
    ref[idx] = q.astype(np.float32) * np.float32(0.0123)
    np.testing.assert_array_equal(native.topk8_scatter(idx, q, 0.0123, n),
                                  ref)


def test_quantize_rounds_halves_to_even():
    """x / scale on exact halves (scale 1.0): np.round's half-to-even,
    and the clip of both signs."""
    a = np.concatenate([[127.0], np.arange(-126.5, 127.0, 1.0),
                        [-0.0, 0.5, -0.5]]).astype(np.float32)
    q_nat, s_nat = native.q8_quantize(a)
    q_np, s_np = _numpy_q8(a)
    assert s_nat == s_np == 1.0
    np.testing.assert_array_equal(q_nat, q_np)


# above the library's per-thread floor (2^20 elements), so 3 and 8
# threads split the work
THREADED_N = (3 << 20) + 5


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 100_000, THREADED_N - 1])
def test_threaded_select_keeps_the_tie_rule(threads, k):
    """Heavy ties (signed zeros too) over several chunks: the write
    windows of the chunks keep the lowest-index ties, as numpy does."""
    a = np.random.RandomState(6).choice(
        [-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], size=THREADED_N).astype(
        np.float32)
    idx_n, vals_n = native.topk8_select(a, k, n_threads=threads)
    idx_p, vals_p = pc._topk8_select_numpy(a, k)
    np.testing.assert_array_equal(idx_n, idx_p)
    np.testing.assert_array_equal(vals_n.view(np.uint32),
                                  vals_p.view(np.uint32))


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_thread_counts_agree(threads):
    a = _rand((THREADED_N,), 3)
    q1, s1 = native.q8_quantize(a, n_threads=1)
    qt, st = native.q8_quantize(a, n_threads=threads)
    assert s1 == st
    np.testing.assert_array_equal(q1, qt)
    i1, v1 = native.topk8_select(a, 100_000, n_threads=1)
    it, vt = native.topk8_select(a, 100_000, n_threads=threads)
    np.testing.assert_array_equal(i1, it)
    np.testing.assert_array_equal(v1, vt)
    d1 = native.topk8_scatter(i1, q1[i1], s1, a.size, n_threads=1)
    dt = native.topk8_scatter(i1, q1[i1], s1, a.size, n_threads=threads)
    np.testing.assert_array_equal(d1, dt)


# --------------------------------------------------------------------- #
# the host codec line: frames byte-equal to JAX's numpy codec
# --------------------------------------------------------------------- #
FRAME_SHAPES = {"cnn_cut": (8, 26, 26, 32), "lm_cut": (4, 128, 256),
                "odd": (3, 7, 11)}


@pytest.mark.parametrize("name", sorted(FRAME_SHAPES))
def test_q8_frames_byte_equal_to_jax(name):
    a = _rand(FRAME_SHAPES[name], 11)
    port = pc.encode(pc.q8_compress(a))
    ref = jc.encode(jc.q8_compress(a))
    assert port == ref
    dec = pc.decompress_tree(pc.decode(port))
    np.testing.assert_array_equal(dec, jc.decompress_tree(jc.decode(ref)))


@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("name", sorted(FRAME_SHAPES))
def test_topk8_frames_byte_equal_to_jax(name, density):
    a = _rand(FRAME_SHAPES[name], 12)
    d_p, r_p = pc.topk8_compress(a, density)
    d_j, r_j = jc.topk8_compress(a, density)
    assert pc.encode(d_p) == jc.encode(d_j)
    np.testing.assert_array_equal(r_p, r_j)
    np.testing.assert_array_equal(pc.topk8_decompress(d_p),
                                  jc.topk8_decompress(d_j))


@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_topk8_ef_frames_byte_equal_to_jax(decay):
    """Three error-feedback steps of one key: every frame and residual
    equals JAX's ledger's."""
    port, ref = pc.TopK8EF(), jc.TopK8EF()
    for step in range(3):
        a = _rand(FRAME_SHAPES["cnn_cut"], 20 + step)
        fp = pc.encode(port.compress("acts", a, 0.1, decay=decay))
        fj = jc.encode(ref.compress("acts", a, 0.1, decay=decay))
        assert fp == fj, step
        np.testing.assert_array_equal(port.residual("acts"),
                                      ref._res["acts"])


@pytest.mark.parametrize("mode", ["int8", "topk8", "topk8_ef"])
def test_native_frames_equal_the_numpy_line(monkeypatch, mode):
    a = _rand(FRAME_SHAPES["lm_cut"], 13)

    def frames():
        if mode == "int8":
            return [pc.encode(pc.q8_compress(a))]
        ef = pc.TopK8EF()
        out = []
        for step in range(2 if mode == "topk8_ef" else 1):
            out.append(pc.encode(ef.compress("g", a * (step + 1), 0.1)))
        return out

    nat = frames()
    monkeypatch.setenv("SLT_NO_NATIVE", "1")
    assert not native.available()
    assert nat == frames()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_q8_refuses_non_finite(bad):
    a = np.ones((4, 7), np.float32)
    a[2, 3] = bad
    with pytest.raises(pc.CodecError) as ei:
        pc.q8_compress(a)
    assert "[4, 7]" in str(ei.value) and "float32" in str(ei.value)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_topk8_refuses_non_finite(bad):
    a = np.ones((3, 5), np.float32)
    a[0, 0] = bad
    with pytest.raises(pc.CodecError):
        pc.topk8_compress(a, 0.5)


# --------------------------------------------------------------------- #
# no quiet fallback
# --------------------------------------------------------------------- #
@pytest.fixture()
def fresh_native(monkeypatch, tmp_path):
    """The module's build state emptied (restored after the test), the
    cache pointed at ``tmp_path``."""
    monkeypatch.setattr(ncodec, "_lib", None)
    monkeypatch.setattr(ncodec, "_error", None)
    monkeypatch.setenv("SLT_NATIVE_CACHE", str(tmp_path / "cache"))
    return tmp_path


def test_failed_build_raises_with_the_compiler_message(fresh_native,
                                                       monkeypatch):
    broken = fresh_native / "slt_codec.cc"
    broken.write_text('extern "C" { int slt_crc32( }\n')
    monkeypatch.setattr(ncodec, "_SRC", broken)
    with pytest.raises(ncodec.NativeBuildError) as ei:
        native.available()
    assert "g++ failed" in str(ei.value) and "error" in str(ei.value)
    # the codec raises too: no silent numpy fallback
    with pytest.raises(ncodec.NativeBuildError):
        pc.q8_compress(np.ones((2, 2), np.float32))
    # and the same error on every later call, without a rebuild
    assert "g++ failed" in native.build_error()
    with pytest.raises(ncodec.NativeBuildError):
        pc.topk8_decompress(jc.topk8_compress(np.ones(8, np.float32),
                                              0.5)[0])


def test_missing_compiler_raises(fresh_native, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_native))  # no g++ here
    with pytest.raises(ncodec.NativeBuildError) as ei:
        native.q8_quantize(np.ones(4, np.float32))
    assert "g++" in str(ei.value)


def test_native_cache_env_names_the_build_directory(fresh_native):
    assert native.available()
    built = list((fresh_native / "cache").glob("slt_codec-*.so"))
    assert built == [ncodec.library_path()]
    assert not list((fresh_native / "cache").glob("*.tmp*"))


def test_slt_no_native_is_the_numpy_line(fresh_native, monkeypatch):
    """With the switch set nothing builds or loads, and the codec still
    gives JAX's frames."""
    monkeypatch.setenv("SLT_NO_NATIVE", "1")

    def boom():
        raise AssertionError("the numpy line must not load the library")

    monkeypatch.setattr(ncodec, "load", boom)
    assert not native.available()
    assert native.build_error() == "disabled via SLT_NO_NATIVE"
    assert native.crc32(b"x") is None
    a = _rand((4, 26, 26, 32), 14)
    assert pc.encode(pc.q8_compress(a)) == jc.encode(jc.q8_compress(a))
    d_p, _ = pc.topk8_compress(a, 0.1)
    assert pc.encode(d_p) == jc.encode(jc.topk8_compress(a, 0.1)[0])
    np.testing.assert_array_equal(pc.decompress_tree(d_p),
                                  jc.decompress_tree(jc.topk8_compress(
                                      a, 0.1)[0]))
    assert not list((fresh_native / "cache").glob("*.so"))
