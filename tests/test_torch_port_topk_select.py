"""A numpy model of the five launches of ``csrc/topk_select.cu`` (the
wire codec's topk8 encode on the card), held to JAX's codec on the CPU.

The CUDA kernels cannot run here, so this file follows their structure
step by step in numpy, with the kernel's constants: keys (the float bits
of |x_eff| with the sign cleared), histograms of the 11/11/10-bit digits
over the keys that match the prefix so far, the bucket picked by a
suffix count of the bins, then the compaction over the kernel's grid
(each block a contiguous chunk of 2048-element tiles, 256 threads of 8
consecutive elements): per-block counts and their exclusive scan, then
per tile and per thread the prefix of (key > thr, key == thr) and the
slot ``gt_before + min(ties_before, need)``, and one bitmap byte per
thread, MSB first. The model's buffer (the kernel's byte layout) must
give JAX's frame (``_topk8_select_numpy``, ``np.packbits``); a wrong tie
rule or bitmap shows here before the card.

The plain PyTorch version of the whole encode (what a CPU tensor runs,
and what ``chip_smoke.py`` holds the kernels to) is held to JAX's
``topk8_compress`` frames and residuals, with and without decay.
"""

import math

import numpy as np
import pytest
import torch

from split_learning_tpu.transport import codec as jc
from split_learning_tpu_torch.ops import topk as pk
from split_learning_tpu_torch.transport import codec as pc

THREADS, ITEMS, BINS, MAX_BLOCKS = 256, 8, 2048, 528
TILE = THREADS * ITEMS
DIGITS = ((21, 11, None), (10, 11, 21), (0, 10, 10))  # shift, bits, match
SIZES = (1, 7, 8, 9, 4099, 64 * 26 * 26 * 32)
DENSITIES = (0.01, 0.1, 1.0)


def grid_of(n):
    """(blocks, chunk) as the kernel's ``grid_of``."""
    tiles = -(-n // TILE)
    per = -(-tiles // min(tiles, MAX_BLOCKS))
    return -(-tiles // per), per * TILE


def keys_of(v):
    return v.astype(np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)


def radix_select(keys, k):
    """Passes 1-3: (thr, count_gt, need) from the three digit histograms."""
    prefix, remain, count_gt = 0, k, 0
    for shift, bits, match in DIGITS:
        live = keys if match is None else keys[(keys >> match) == prefix]
        hist = np.bincount((live >> shift) & ((1 << bits) - 1),
                           minlength=BINS).astype(np.int64)
        above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])
        (digit,) = np.flatnonzero((above < remain) & (remain <= above + hist))
        prefix = (prefix << bits) | int(digit)
        count_gt += int(above[digit])
        remain -= int(above[digit])
    return prefix, count_gt, remain


def _excl(a, axis):
    return np.cumsum(a, axis=axis) - a


def compact(keys, thr, need, n):
    """Passes 4-5: (survivor mask, slot of each element) over the grid."""
    blocks, chunk = grid_of(n)
    valid = np.arange(blocks * chunk) < n
    kp = np.zeros(blocks * chunk, np.uint32)
    kp[:n] = keys
    gt = (valid & (kp > thr)).astype(np.int64)
    eq = (valid & (kp == thr)).astype(np.int64)
    shape = (blocks, chunk // TILE, THREADS, ITEMS)
    before = {}
    for name, flags in (("gt", gt), ("eq", eq)):
        f = flags.reshape(shape)
        block_base = _excl(f.sum(axis=(1, 2, 3)), 0)     # pass 4's scan
        thread = f.sum(axis=3)
        tile_base = _excl(thread.sum(axis=2), 1)          # carried per tile
        thread_base = _excl(thread, 2)                    # the block scan
        before[name] = (block_base[:, None, None, None]
                        + tile_base[:, :, None, None]
                        + thread_base[..., None] + _excl(f, 3)).reshape(-1)
    taken = np.minimum(before["eq"], need)
    keep = (gt == 1) | ((eq == 1) & (np.minimum(before["eq"] + 1, need)
                                     > taken))
    return keep[:n], (before["gt"] + taken)[:n]


def model_encode(x, k, res=None, decay=1.0):
    """The kernel's buffer and new residual, built the kernel's way."""
    x = np.asarray(x, np.float32).reshape(-1)
    n = x.size
    v = x + np.float32(decay) * res if res is not None else x.copy()
    keys = keys_of(v)
    thr, count_gt, need = radix_select(keys, k)
    keep, slot = compact(keys, thr, need, n)
    assert count_gt + need == k and keep.sum() == k
    amax = np.uint32(keys.max()).view(np.float32)
    scale = np.float32(max(float(amax) / 127.0, 1e-12))
    bitmap, pos, end = pk.select_layout(n, k)
    buf = np.zeros(end, np.uint8)
    buf[:4] = np.array([0 if np.isfinite(x).all() else 1],
                       np.int32).view(np.uint8)
    buf[4:8] = np.array([amax], np.float32).view(np.uint8)
    q = np.zeros(k, np.int8)
    sv = v[keep]
    q[slot[keep]] = np.clip(np.rint(sv / scale), -127, 127).astype(np.int8)
    buf[16:16 + k] = q.view(np.uint8)
    if bitmap:
        blocks, chunk = grid_of(n)
        bits = np.zeros(blocks * chunk, np.uint8)
        bits[:n] = keep
        weights = np.array(pk.BIT_WEIGHTS, np.uint32)
        byte = (bits.reshape(-1, ITEMS) * weights).sum(axis=1)
        buf[pos:] = byte[:-(-n // ITEMS)].astype(np.uint8)
    else:
        idx = np.zeros(k, np.int32)
        idx[slot[keep]] = np.flatnonzero(keep)
        buf[pos:] = idx.view(np.uint8)
    v[keep] = sv - q[slot[keep]].astype(np.float32) * scale
    return buf, v


def _input(n, kind, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "random":
        return (3.0 * rs.randn(n)).astype(np.float32)
    if kind == "ties":
        return np.full(n, 0.7, np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    # exact halves at scale 1, and ties of every magnitude across tiles
    x = (np.arange(n) % 254).astype(np.float32) - 126.5
    x[n // 2] = 127.0
    return x


def _jax_frame(x, density, res=None, decay=1.0):
    if res is not None and decay != 1.0:
        res = np.float32(decay) * res
    return jc.topk8_compress(x, density, residual=res)


def _frame_of(buf, x, k):
    """The codec's dict from a buffer (what the card's codec sends)."""
    n = x.size
    bad, amax, q, form, pos = pk.split_select(buf, n, k)
    assert not bad
    d = {"__topk8__": True, "n": n, "shape": list(x.shape),
         "dtype": "float32", form: pos}
    d.update(q=q, scale=max(amax / 127.0, 1e-12))
    return d


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "halves"])
@pytest.mark.parametrize("n", SIZES)
def test_model_frames_equal_jax(n, kind, density):
    x = _input(n, kind)
    k = max(1, min(n, math.ceil(density * n)))
    res = (0.5 * np.random.RandomState(1).randn(n)).astype(np.float32)
    buf, new_res = model_encode(x, k, res, 0.5)
    d_j, r_j = _jax_frame(x, density, res, 0.5)
    assert jc.encode(_frame_of(buf, x, k)) == jc.encode(d_j)
    np.testing.assert_array_equal(new_res, r_j)


def test_model_ties_straddle_blocks_and_tiles():
    """Ties at the threshold spread over every block and tile edge of a
    multi-block grid: the first ``need`` by index survive, in order."""
    n = 40 * TILE + 3
    x = np.where(np.arange(n) % 3 == 0, 2.0, 1.0).astype(np.float32)
    x[::1000] = 5.0
    for k in (n // 3 + 7, n // 2, 4 * TILE):
        keys = keys_of(x)
        thr, count_gt, need = radix_select(keys, k)
        keep, slot = compact(keys, thr, need, n)
        want, _ = jc._topk8_select_numpy(x, k)
        np.testing.assert_array_equal(np.flatnonzero(keep), want)
        np.testing.assert_array_equal(slot[keep], np.arange(k))
        assert grid_of(n)[0] > 1 and need > 0


def test_model_radix_select_is_the_kth_largest():
    rs = np.random.RandomState(4)
    for n, k in ((1, 1), (9, 3), (5000, 1), (5000, 5000), (70000, 777)):
        keys = keys_of(rs.randn(n).astype(np.float32) * 10 ** rs.randint(
            -30, 30, n).astype(np.float32))
        thr, count_gt, need = radix_select(keys, k)
        assert thr == np.sort(keys)[::-1][k - 1]
        assert count_gt == (keys > thr).sum() and 1 <= need <= (
            keys == thr).sum()


def test_model_bitmap_bytes_are_packbits_msb_first():
    for n in (1, 7, 8, 9, 17, 4099):
        x = _input(n, "random", n)
        k = max(1, math.ceil(0.3 * n))
        buf, _ = model_encode(x, k)
        bitmap, pos, end = pk.select_layout(n, k)
        assert bitmap
        mask = np.zeros(n, bool)
        mask[jc._topk8_select_numpy(x, k)[0]] = True
        np.testing.assert_array_equal(buf[pos:end], np.packbits(mask))


def test_plain_buffer_is_the_models():
    """The plain version writes the model's bytes and residual."""
    for n, density in ((9, 1.0), (4099, 0.1), (4099, 0.01)):
        x = _input(n, "random", 2)
        res = np.random.RandomState(3).randn(n).astype(np.float32)
        k = max(1, min(n, math.ceil(density * n)))
        buf, r = pk.topk8_select_plain(torch.from_numpy(x),
                                       torch.from_numpy(res), 0.5, k)
        want_buf, want_r = model_encode(x, k, res, 0.5)
        np.testing.assert_array_equal(buf.numpy(), want_buf)
        np.testing.assert_array_equal(r.numpy(), want_r)
        buf_nr, none = pk.topk8_select_plain(torch.from_numpy(x), None, 1.0,
                                             k, keep_residual=False)
        assert none is None
        np.testing.assert_array_equal(buf_nr.numpy(), model_encode(x, k)[0])


@pytest.mark.parametrize("decay", [1.0, 0.5])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_encode_frames_equal_jax(density, decay, dtype):
    """The codec on a CPU tensor (the plain version) over three EF steps:
    frames and residuals equal JAX's; a bf16 tensor equals JAX on its
    float32 values; the stateless pack equals a residual-free frame."""
    ef = pc.TopK8EF()
    res_j = None
    for step in range(3):
        x = torch.from_numpy(_input(4099, "random", step)).to(dtype)
        xf = x.float().numpy()
        d = ef.compress("k", x, density, decay)
        d_j, res_j = _jax_frame(xf, density, res_j, decay)
        d_j["dtype"] = str(dtype).replace("torch.", "")
        assert pc.encode(d) == jc.encode(d_j)
        np.testing.assert_array_equal(ef.residual("k").numpy(), res_j)
        d_s = pc.topk8_pack(x, density)
        d_sj = dict(_jax_frame(xf, density)[0], dtype=d_j["dtype"])
        assert pc.encode(d_s) == jc.encode(d_sj)


def test_plain_encode_flags_non_finite_and_keeps_the_ledger():
    ef = pc.TopK8EF()
    ef.compress("k", torch.ones(64), 0.1)
    before = ef.residual("k").clone()
    for bad in (float("nan"), float("inf")):
        x = torch.ones(64)
        x[5] = bad
        buf, _ = pk.topk8_select_plain(x, None, 1.0, 7)
        assert pk.split_select(buf, 64, 7)[0]
        with pytest.raises(pc.CodecError, match="non-finite"):
            ef.compress("k", x, 0.1)
        assert torch.equal(ef.residual("k"), before)
