"""A numpy model of the launches of ``csrc/cross_entropy.cu`` (K1) and
``csrc/sgd.cu`` (K2), held to JAX on the CPU.

The CUDA kernels cannot run here, so this file follows their structure in
numpy, with the kernels' constants:

- K1's forward: a row belongs to a group of ``lanes_for(C / W, B)``
  lanes (W = 4 float32 or 8 bf16 a 16-byte load, or 1; B the loads a
  lane batches, 16 / W or 4); each lane keeps a
  running (m, s) over batches of B loads, its exponents shifted by m or,
  while m = -inf, by 0 (never exp(-inf - -inf)); the group takes the row
  max by a butterfly, rescales each lane's s to it once and sums them by
  a second butterfly; each thread sums its rows' losses, each block its
  threads' (warp butterflies, then the warps in order), and the last
  block the per-block partials in the same fixed tree, divided by N (a
  grid of one block divides its own sum).
- K1's backward: the same groups walk the rows; each element is written
  once, at ``row * C + col`` in 64-bit, with no division.
- K2: the prefix of 512-element blocks per leaf, the binary search from a
  block to its leaf, and each thread's float4 (or, for leaves that are not
  16-byte aligned, four scattered elements); tables of at most 896
  leaves, each at the smallest capacity (8, 64, 896) that holds it.

The models' losses and gradients are held to JAX's ``fused_cross_entropy``
(Pallas in interpret mode) within ``CE_TOL``, and their index maps must
cover every element exactly once. The plain SGD update (what a CPU tensor
runs, and what the card's kernel must equal bit for bit) is held to JAX's
``fused_sgd_step`` over the small LM's 54 leaves.

Tolerances: ``CE_TOL`` as tests/test_torch_port_ops.py (float32 exp/log
and another summation order); SGD rtol 1e-6 / atol 1e-6 (one rounding
per operation here, and possibly an FMA in XLA's CPU code: an ulp of
operands up to 4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.ops.cross_entropy import (
    fused_cross_entropy as jax_fused_ce)
from split_learning_tpu.ops.sgd import (
    fused_sgd_step as jax_fused_sgd, init_trace as jax_init_trace)
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.ops.sgd import init_trace, sgd_step_plain

CE_TOL = dict(rtol=1e-5, atol=1e-6)
# csrc/cross_entropy.cu
THREADS, FWD_MAX_BLOCKS = 256, 4096
# csrc/sgd.cu
SGD_THREADS, SGD_CHUNK, SGD_CAPS = 128, 512, (8, 64, 896)
F32 = np.float32
NEG_INF = F32(-np.inf)


def batch_of(w):
    """Loads a lane issues before it computes: 16 elements, or 4."""
    return 16 // w if w > 1 else 4


def lanes_for(units, batch):
    want, lanes = -(-units // batch), 1
    while lanes < want and lanes < 32:
        lanes *= 2
    return lanes


def blocks_for(rows, per_block, cap):
    return max(1, min(cap, -(-rows // per_block)))


def width(c, itemsize, aligned=True):
    """Elements a load: 16 bytes where every row starts 16-byte aligned."""
    w = 16 // itemsize
    return w if aligned and (c * itemsize) % 16 == 0 else 1


LOG2E = F32(1.4426950408889634)


def exp_(d):
    """The kernels' exp(d): exp2f(d * log2 e), in float32."""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.exp2((np.asarray(d, F32) * LOG2E).astype(F32)).astype(F32)


def safe(m):
    """The exponents' shift: m, or 0 where m = -inf."""
    return np.where(m == NEG_INF, F32(0), m).astype(F32)


def lane_pairs(x, lanes, w):
    """Each lane's (m, s) over its loads, for every row of ``x`` [N, C]:
    arrays [lanes, N], as the forward's loop (batches of loads)."""
    n, c = x.shape
    units, bt = c // w, batch_of(w)
    ms, ss = [], []
    for lane in range(lanes):
        m = np.full(n, NEG_INF)
        s = np.zeros(n, F32)
        for u0 in range(lane, units, lanes * bt):
            cols = [u * w + k for b in range(bt)
                    for u in [u0 + b * lanes] if u < units for k in range(w)]
            v = x[:, cols]
            mn = m
            for j in range(v.shape[1]):
                mn = np.fmax(mn, v[:, j])
            shift = safe(mn)
            sb = np.zeros(n, F32)
            with np.errstate(invalid="ignore"):
                for j in range(v.shape[1]):
                    sb = (sb + exp_(v[:, j] - shift)).astype(F32)
                s = ((s * exp_(m - shift)).astype(F32) + sb).astype(F32)
            m = mn
        ms.append(m)
        ss.append(s)
    return np.array(ms), np.array(ss)


def xor_sum(v):
    """A butterfly sum over the first axis (lane l adds lane l ^ o, o =
    lanes/2 .. 1), lane 0's result; every lane ends with the same."""
    lanes = len(v)
    o = lanes // 2
    while o:
        v = (v + v[np.arange(lanes) ^ o]).astype(F32)
        o //= 2
    return v[0]


def group_merge(ms, ss):
    """The row from its lanes' pairs: the max by a butterfly (fmaxf), each
    lane's s rescaled to it once, then the butterfly sum."""
    mr = np.fmax.reduce(ms, axis=0)
    with np.errstate(invalid="ignore"):
        sr = (ss * exp_(ms - safe(mr)[None, :])).astype(F32)
    return mr, xor_sum(sr)


def butterfly_sum(v):
    """A warp's xor butterfly sum (32 lanes), lane 0's result."""
    return xor_sum(np.asarray(v, F32))


def block_sum(v):
    """csrc/cross_entropy.cu block_sum: warps' butterflies, then the warps
    in index order."""
    t = F32(0)
    for w in range(THREADS // 32):
        t = F32(t + butterfly_sum(v[32 * w:32 * w + 32]))
    return t


def fwd_model(x, y, itemsize=4):
    """(loss, lse) as the forward launch computes them."""
    n, c = x.shape
    w = width(c, itemsize)
    lanes = lanes_for(c // w, batch_of(w))
    m, s = group_merge(*lane_pairs(x, lanes, w))
    with np.errstate(divide="ignore", invalid="ignore"):
        log_s = np.log(s).astype(F32)
        lse = (m + log_s).astype(F32)
        ok = (y >= 0) & (y < c)
        x_y = x[np.arange(n), np.where(ok, y, 0)]
        row_loss = np.where(ok, log_s - (x_y - m), np.nan).astype(F32)
    rows = THREADS // lanes
    grid = blocks_for(n, rows, FWD_MAX_BLOCKS)
    partials = np.zeros(grid, F32)
    for b in range(grid):
        acc = np.zeros(THREADS, F32)       # each thread's sum of row losses
        for base in range(b * rows, n, grid * rows):
            for group in range(rows):
                if base + group < n:       # the group's lane 0 adds it
                    t = group * lanes
                    acc[t] = F32(acc[t] + row_loss[base + group])
        partials[b] = block_sum(acc)
    if grid == 1:                          # the block writes the loss
        return F32(partials[0] / F32(n)), lse
    acc = np.zeros(THREADS, F32)           # the last block
    for i in range(grid):
        acc[i % THREADS] = F32(acc[i % THREADS] + partials[i])
    return F32(block_sum(acc) / F32(n)), lse


def bwd_indices(n, c, w, lanes):
    """Flat indices the backward writes, in 64-bit, from its loops: block
    (one a row group), row, lane, batch iteration, load, element."""
    rows = THREADS // lanes
    units, bt = c // w, batch_of(w)
    grid = -(-n // rows)
    row = (np.arange(grid)[:, None] * rows
           + np.arange(rows)[None, :]).reshape(-1)
    row = row[row < n].astype(np.int64)
    its = -(-units // (lanes * bt))
    u = (np.arange(lanes)[:, None, None]
         + np.arange(its)[None, :, None] * lanes * bt
         + np.arange(bt)[None, None, :] * lanes).reshape(-1)
    u = u[u < units]
    col = (u[:, None] * w + np.arange(w)[None, :]).reshape(-1)
    return (row[:, None] * c + col[None, :]).reshape(-1)


def bwd_model(x, y, lse, g, itemsize=4):
    """The backward's gradient, written through its index map."""
    n, c = x.shape
    w = width(c, itemsize)
    lanes = lanes_for(c // w, batch_of(w))
    idx = bwd_indices(n, c, w, lanes)
    row, col = idx // c, idx % c
    scale = F32(F32(g) / F32(n))
    grad = np.full(n * c, np.nan, F32)
    with np.errstate(invalid="ignore", over="ignore"):
        p = exp_(x.reshape(-1)[idx] - lse[row])
    grad[idx] = ((p - (col == y[row]).astype(F32)) * scale).astype(F32)
    return grad.reshape(n, c)


def _ce_inputs(n, c, seed):
    rs = np.random.RandomState(seed)
    x = (3.0 * rs.randn(n, c)).astype(F32)
    return x, rs.randint(0, c, n).astype(np.int64)


@pytest.mark.parametrize("c", [1, 10, 130, 256])
@pytest.mark.parametrize("n", [1, 7, 64, 1025])
def test_ce_model_matches_jax(n, c):
    """The forward's lane pairs, group merge and last-block mean, and the
    backward's row walk, against JAX's kernel (1025 rows: its gridded
    path), loss and gradient within CE_TOL."""
    x, y = _ce_inputs(n, c, seed=n * 7 + c)
    loss, lse = fwd_model(x, y)
    grad = bwd_model(x, y, lse, 1.0)
    j_loss, j_grad = jax.value_and_grad(jax_fused_ce)(jnp.asarray(x),
                                                       jnp.asarray(y))
    np.testing.assert_allclose(loss, np.asarray(j_loss), **CE_TOL)
    np.testing.assert_allclose(grad, np.asarray(j_grad), **CE_TOL)
    m = x.max(axis=1)
    want_lse = m + np.log(np.exp(x - m[:, None]).sum(axis=1))
    np.testing.assert_allclose(lse, want_lse, **CE_TOL)


@pytest.mark.parametrize("c, lanes, w", [(10, 4, 1), (7, 2, 1),
                                         (256, 16, 4), (256, 16, 8),
                                         (1000, 32, 4)])
def test_ce_lane_pairs_with_empty_lanes_and_infinities(c, lanes, w):
    """Rows with -inf logits (lanes whose every element is -inf stay
    empty), a row of all -inf, a +inf and a NaN logit: the merged (m, s)
    gives the two-pass lse where the row is finite, and NaN where it
    holds +inf or NaN."""
    rs = np.random.RandomState(c)
    x = (3.0 * rs.randn(6, c)).astype(F32)
    x[1, : c - 1] = -np.inf          # one finite logit, at the end
    x[2, ::2] = -np.inf
    x[3] = -np.inf
    x[4, c // 2] = np.inf
    x[5, c - 1] = np.nan
    assert lanes_for(c // w, batch_of(w)) == lanes
    m, s = group_merge(*lane_pairs(x, lanes, w))
    with np.errstate(divide="ignore", invalid="ignore"):
        lse = m + np.log(s)
    for r in (0, 1, 2):
        row = x[r][np.isfinite(x[r])]
        want = row.max() + np.log(np.exp(row - row.max()).sum())
        np.testing.assert_allclose(lse[r], want, **CE_TOL)
    assert m[3] == -np.inf and s[3] == 0 and lse[3] == -np.inf
    assert np.isnan(lse[4]) and np.isnan(lse[5])
    # every finite row's loss agrees with JAX's; the non-finite ones are
    # NaN, as JAX's kernel gives for +inf and NaN
    y = np.array([c - 1, c - 1, 1, 0, 0, 0], np.int64)
    loss, _ = fwd_model(x[:3], y[:3])
    j_loss = jax_fused_ce(jnp.asarray(x[:3]), jnp.asarray(y[:3]))
    np.testing.assert_allclose(loss, np.asarray(j_loss), **CE_TOL)
    for r in (3, 4, 5):
        assert np.isnan(fwd_model(x[r:r + 1], y[r:r + 1])[0])
    assert np.isnan(np.asarray(jax_fused_ce(jnp.asarray(x[4:6]),
                                            jnp.asarray(y[4:6]))))


@pytest.mark.parametrize("label", [-1, 10, 2 ** 40])
def test_ce_label_outside_the_row_gives_nan(label):
    """A label outside [0, C) makes the loss NaN and reads nothing of
    the row; the backward's one-hot never matches it."""
    x, y = _ce_inputs(5, 10, seed=3)
    y[2] = label
    loss, lse = fwd_model(x, y)
    assert np.isnan(loss) and np.isfinite(lse).all()
    grad = bwd_model(x, y, lse, 1.0)
    np.testing.assert_allclose(
        grad[2], np.exp(x[2] - lse[2]) / 5, **CE_TOL)
    assert (grad[2] > 0).all()


@pytest.mark.parametrize("n, c, itemsize", [(1, 1, 4), (7, 10, 4),
                                            (1025, 256, 4), (64, 256, 2),
                                            (33, 130, 4), (33, 13, 2),
                                            (300, 1000, 4)])
def test_ce_backward_writes_each_element_once(n, c, itemsize):
    w = width(c, itemsize)
    lanes = lanes_for(c // w, batch_of(w))
    idx = bwd_indices(n, c, w, lanes)
    assert (np.bincount(idx, minlength=n * c) == 1).all()


def test_ce_backward_offsets_past_2_31():
    """At vocab 50,257 and 65,536 rows the last element is past 2^31:
    the kernel's row * C + col in 64-bit reaches it, where 32-bit
    arithmetic wraps. Computed from the kernel's loop variables, without
    allocating the logits."""
    n, c = 65536, 50257
    w = width(c, 4)
    lanes = lanes_for(c // w, batch_of(w))
    rows = THREADS // lanes
    assert (w, lanes, rows) == (1, 32, 8)
    row = n - 1
    block, group = row // rows, row % rows     # grid: n / 8 = 8192 blocks
    assert block * rows + group == row and block < 2 ** 31 - 1
    units = c // w
    u = units - 1                          # the row's last load
    lane, rest = u % lanes, u // lanes
    its, b = rest // batch_of(w), rest % batch_of(w)
    assert lane + its * lanes * batch_of(w) + b * lanes == u
    off = np.int64(row) * np.int64(c) + np.int64(u * w)
    assert off == n * c - 1 > 2 ** 31
    with np.errstate(over="ignore"):
        assert np.int32(row) * np.int32(c) + np.int32(u) != off


# --------------------------------------------------------------------- #
# K2

def sgd_tables(numels):
    """The wrapper's split into tables of at most 896 leaves, each with
    its kernel capacity and block prefix."""
    out = []
    for lo in range(0, len(numels), SGD_CAPS[-1]):
        part = numels[lo:lo + SGD_CAPS[-1]]
        cap = next(c for c in SGD_CAPS if len(part) <= c)
        start = np.concatenate([[0], np.cumsum(
            [-(-n // SGD_CHUNK) for n in part])]).astype(np.int64)
        out.append((lo, cap, part, start))
    return out


def leaf_of(start, n_leaves, b):
    """The kernel's binary search: the last leaf whose first block is at
    or before block b."""
    lo, hi = 0, n_leaves - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if start[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def sgd_touches(numels, aligned):
    """(leaf, element) of every access the launches make."""
    leaves, elems = [], []
    for lo, cap, part, start in sgd_tables(numels):
        assert len(part) <= cap
        for b in range(int(start[-1])):
            leaf = leaf_of(start, len(part), b)
            begin = (b - int(start[leaf])) * SGD_CHUNK
            end = min(begin + SGD_CHUNK, part[leaf])
            t = np.arange(SGD_THREADS)
            if aligned[lo + leaf]:   # a float4 a thread, or the ragged end
                j = (begin + 4 * t[:, None] + np.arange(4)[None, :]).reshape(-1)
            else:
                j = (begin + t[None, :] + SGD_THREADS
                     * np.arange(4)[:, None]).reshape(-1)
            j = j[j < end]
            leaves.append(np.full(len(j), lo + leaf))
            elems.append(j)
    return np.concatenate(leaves), np.concatenate(elems)


@pytest.mark.parametrize("n_leaves", [1, 6, 24, 25, 54, 300, 1000])
def test_sgd_blocks_cover_every_element_once(n_leaves):
    """Odd and zero sizes, 16-byte aligned leaves and not: every element
    of every leaf is updated exactly once, one launch per table."""
    rs = np.random.RandomState(n_leaves)
    numels = [int(v) for v in rs.randint(0, 5000, n_leaves)]
    numels[0] = 1
    if n_leaves > 3:
        numels[1], numels[2] = 0, SGD_CHUNK * 3 + 1
    aligned = rs.rand(n_leaves) < 0.7
    leaf, elem = sgd_touches(numels, aligned)
    flat = np.concatenate([[0], np.cumsum(numels)])[leaf] + elem
    assert (np.bincount(flat, minlength=sum(numels)) == 1).all()
    assert len(sgd_tables(numels)) == math.ceil(n_leaves / SGD_CAPS[-1])


def test_sgd_block_counts_spread_the_cnn_over_the_sms():
    """The CNN's six leaves take 220 blocks of 512 elements (132 SMs);
    the LM's 54 leaves fit one table of capacity 64."""
    cnn = [288, 32, 18432, 64, 92160, 10]
    (_, cap, _, start), = sgd_tables(cnn)
    assert (cap, int(start[-1])) == (8, 220)
    (_, cap, _, _), = sgd_tables([1] * 54)
    assert cap == 64


def test_sgd_plain_matches_jax_on_54_leaves():
    """sgd_step_plain against JAX's fused_sgd_step (Pallas in interpret
    mode) on the small LM's 54 leaves, momentum 0.9, five steps. XLA's
    CPU code may contract p - lr * m into one FMA, so where the update
    cancels most of p the two differ by an ulp of the operands (|p| and
    |lr * m| reach 4 here: 4.8e-7), hence atol 1e-6."""
    plan = get_plan(model="transformer_lm", vocab=61, d_model=16,
                    num_heads=2, client_depth=1, server_depth=2, max_len=32,
                    attn="flash")
    shapes = [tuple(t.shape) for st in plan.init(
        torch.Generator().manual_seed(0), torch.zeros(1))
        for t in st.values()]
    assert len(shapes) == 54
    rs = np.random.RandomState(54)
    p0 = [rs.randn(*s).astype(F32) for s in shapes]
    j_params = [jnp.asarray(a) for a in p0]
    j_trace = jax_init_trace(j_params)
    j_step = jax.jit(lambda p, g, m: jax_fused_sgd(p, g, m, 0.1, 0.9))
    params = [torch.from_numpy(a.copy()) for a in p0]
    trace = init_trace(params)
    for _ in range(5):
        grads = [rs.randn(*s).astype(F32) for s in shapes]
        j_params, j_trace = j_step(j_params, [jnp.asarray(g) for g in grads],
                                   j_trace)
        sgd_step_plain(params, [torch.from_numpy(g) for g in grads], trace,
                       0.1, 0.9)
    for got, want in zip(params + trace, list(j_params) + list(j_trace)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
