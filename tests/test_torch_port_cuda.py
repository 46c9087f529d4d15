"""The port on the card: kernels against their plain versions and the
serving path on CUDA tensors. Every test is marked ``cuda`` and skips
without a card. This file imports no JAX, so it runs where JAX is not
installed; tests/conftest.py imports JAX, hence on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances are chip_smoke.py's. Forward: float32 2e-5 on O and LSE
(the 3xTF32 products, summation order and online rescaling against one
dense float32 softmax); bf16 1.6e-2 on O (the plain version rounds P to
bf16 where the kernel does, which leaves two bf16 ulps of an |o| below
2) and 1e-3 on LSE. Backward: ``BWD_TOL`` times the largest gradient
entry of the plain version (float32: the 3xTF32 products and the tile
loop's summation order against one dense sum per product; bf16: two bf16
ulps of the largest entry, both sides rounding P and dS to bf16).
"""

import numpy as np
import pytest
import torch

from split_learning_tpu_torch.ops.common import LAUNCHES, NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    BWD_NAMES, NAME as FA, flash_attention, flash_attention_bwd_plain,
    flash_attention_with_lse, flash_attention_with_lse_plain,
    flash_bwd_cuda)

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1.6e-2, 1e-3)}
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,strict", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("b,t,h,d", [(1, 1, 1, 16), (2, 65, 3, 64),
                                     (1, 200, 2, 128), (1, 70, 1, 256)])
def test_flash_kernel_matches_plain(dev, b, t, h, d, causal, strict, dtype):
    g = torch.Generator(device=dev).manual_seed(t * d)
    q, k, v = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    LAUNCHES.reset()
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal, strict)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {FA: 1}
    o_p, lse_p = flash_attention_with_lse_plain(q, k, v, causal, strict)
    tol_o, tol_l = TOL[dtype]
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_p.float()).abs().max().item() <= tol_o
    assert (lse - lse_p).abs().max().item() <= tol_l
    if strict:
        assert (o[:, 0] == 0).all() and (lse[:, 0] == NEG_BIG).all()


def test_flash_kernel_reads_strided_views(dev):
    packed = torch.randn(2, 50, 3, 2, 32, device=dev)
    q, k, v = packed.unbind(2)
    assert not q.is_contiguous()
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=True)
    want = flash_attention_with_lse_plain(q, k, v, True)[0]
    assert (o - want).abs().max().item() <= 2e-5


def test_flash_kernel_refuses_what_it_cannot_run(dev):
    x = torch.randn(1, 8, 2, 16, device=dev)
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        flash_attention(x, x.cpu(), x)
    with pytest.raises(ValueError):
        flash_bwd_cuda(x, x, x, x, x[..., 0], x.cpu())


def _assert_grads_close(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() \
            <= BWD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("causal,strict", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("b,t,h,d", [(1, 1, 1, 16), (2, 65, 3, 64),
                                     (1, 200, 2, 128), (1, 70, 1, 256)])
def test_flash_backward_kernel_matches_plain(dev, b, t, h, d, causal, strict,
                                             with_g_lse, dtype):
    g = torch.Generator(device=dev).manual_seed(t * d + 1)
    q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    g_lse = (torch.randn(b, t, h, device=dev, generator=g) if with_g_lse
             else None)
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal, strict)
    LAUNCHES.reset()
    got = flash_bwd_cuda(q, k, v, o, lse, do, g_lse, causal, strict)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {n: 1 for n in BWD_NAMES}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, g_lse, causal,
                                     strict)
    _assert_grads_close(got, want, dtype)
    if strict:   # row 0 has no key: no gradient reaches its query
        assert (got[0][:, 0] == 0).all()


def test_flash_backward_reads_strided_views(dev):
    packed = torch.randn(2, 90, 4, 2, 48, device=dev)
    q, k, v, do = packed.unbind(2)
    assert not do.is_contiguous()
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, True)
    got = flash_bwd_cuda(q, k, v, o, lse, do, None, True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, None, True)
    _assert_grads_close(got, want, torch.float32)


def _dense(q, k, v):
    """Causal softmax attention in plain differentiable ops: (o, lse)."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, NEG_BIG)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o, torch.logsumexp(s, dim=-1).permute(0, 2, 1)


def test_autograd_through_flash_launches_k6(dev):
    """Gradients through flash_attention_with_lse (K5 forward, K6
    backward) against autograd of dense attention on the card, and two
    runs give bit-identical gradients (no atomics)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, w = (torch.randn(2, 150, 2, 64, device=dev, generator=g)
                  for _ in range(4))
    w_lse = torch.randn(2, 150, 2, device=dev, generator=g)

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = fn(*leaves)
        return torch.autograd.grad((o * w).sum() + (lse * w_lse).sum(),
                                   leaves)

    LAUNCHES.reset()
    got = grads(lambda *a: flash_attention_with_lse(*a, causal=True))
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {FA: 1, **{n: 1 for n in BWD_NAMES}}
    _assert_grads_close(got, grads(_dense), torch.float32)
    again = grads(lambda *a: flash_attention_with_lse(*a, causal=True))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_serving_path_on_the_card(dev):
    from split_learning_tpu_torch.data import synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        evaluate, greedy_generate, sample_generate)
    size = dict(vocab=61, d_model=64, num_heads=2, client_depth=1,
                server_depth=2, max_len=128, attn="flash")
    plan = get_plan(model="transformer_lm", **size)
    cpu_params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    params = tuple({k: v.to(dev) for k, v in st.items()}
                   for st in cpu_params)
    prompt = np.random.RandomState(0).randint(0, 61, (2, 40)).astype(
        np.int32)
    LAUNCHES.reset()
    toks = greedy_generate(plan, params, prompt, 12, device="cuda")
    assert LAUNCHES.snapshot() == {FA: 3}
    LAUNCHES.reset()
    again = greedy_generate(plan, params, prompt, 12, kv_cache=False,
                            device="cuda")
    assert LAUNCHES.snapshot() == {FA: 3 * 12}
    assert torch.equal(toks, again)
    # the card's tokens are the CPU twin's argmax, within 1e-4
    with torch.no_grad():
        logits = plan.apply(cpu_params, toks[:, :-1].cpu())
    rows = logits[:, 39:]
    chosen = rows.gather(-1, toks[:, 40:, None].cpu().long())[..., 0]
    assert (rows.max(-1).values - chosen).max().item() <= 1e-4
    s = [sample_generate(plan, params, prompt, 6,
                         torch.Generator(device=dev).manual_seed(3), 0.8,
                         top_k=10, top_p=0.9, device="cuda")
         for _ in range(2)]
    assert torch.equal(s[0], s[1]) and s[0].max().item() < 61
    with pytest.raises(ValueError, match="requested device"):
        greedy_generate(plan, cpu_params, prompt, 2, device="cuda")
    ds = synthetic_lm(n_train=4, n_test=6, vocab=61, seq_len=32)
    LAUNCHES.reset()
    res = evaluate(plan, params, ds.test, batch_size=4)
    assert LAUNCHES.snapshot() == {FA: 3 * 2}
    want = evaluate(plan, cpu_params, ds.test, batch_size=4)
    assert abs(res["loss"] - want["loss"]) <= 1e-4


def test_lm_training_on_the_card(dev):
    """Two steps of the split causal LM (three blocks, attn="flash") on
    the card: per step 3 K5 and 3 of each K6 launch, one K1 pair, and
    one K2 launch over all 54 leaves; losses within 1e-4 of a CPU twin
    from the same parameters."""
    from split_learning_tpu_torch.data import synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils.config import Config
    plan = get_plan(model="transformer_lm", vocab=61, d_model=64,
                    num_heads=2, client_depth=1, server_depth=2,
                    max_len=128, attn="flash")
    ds = synthetic_lm(n_train=8, n_test=4, vocab=61, seq_len=96)
    cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                 batch_size=4, lr=0.1, momentum=0.9)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    assert sum(len(st) for st in init) == 54
    card, cpu = (FusedSplitTrainer(plan, cfg, init, ds.train.x[:4],
                                   device=where) for where in ("cuda", "cpu"))
    batches = [(ds.train.x[i:i + 4], ds.train.y[i:i + 4]) for i in (0, 4)]
    LAUNCHES.reset()
    losses = [card.train_step(x, y) for x, y in batches]
    assert LAUNCHES.snapshot() == {FA: 6, **{n: 6 for n in BWD_NAMES},
                                   FWD: 2, BWD: 2, SGD: 2}
    want = [cpu.train_step(x, y) for x, y in batches]
    assert max(abs(a - b) for a, b in zip(losses, want)) <= 1e-4


# --------------------------------------------------------------------- #
# K1 (cross-entropy) and K2 (SGD): chip_smoke.py's tolerances. The loss
# within 1e-6 + 1e-5 of it (float32 exp/log and another summation order);
# the float32 gradient within 1e-5 of its largest entry; the bf16 gradient
# within one bf16 ulp (both round the same float32 value to bf16, which
# differs only in its last float32 bits). K2 is bit-identical.

CE_SHAPES = ((1, 1), (7, 10), (64, 10), (33, 130), (1025, 256), (64, 1000),
             (65536, 256))


def bf16_ulps(a, b):
    """Largest distance of two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs().max().item()


def _ce_check(x, y, g_scale=1.0):
    from split_learning_tpu_torch.ops.cross_entropy import (
        BWD, FWD, ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    g = torch.full((), g_scale, device=x.device)
    LAUNCHES.reset()
    runs = []
    for _ in range(2):
        loss, lse = ce_forward_cuda(x, y)
        runs.append((loss, lse, ce_backward_cuda(x, y, lse, g)))
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {FWD: 2, BWD: 2}
    loss, lse, grad = runs[0]
    for a, b in zip(runs[0], runs[1]):  # bit-reproducible
        assert torch.equal(a, b)
    want_loss, want_lse = ce_forward_plain(x, y)
    want_grad = ce_backward_plain(x, y, want_lse, g)
    assert abs(loss.item() - want_loss.item()) <= (
        1e-6 + 1e-5 * abs(want_loss.item()))
    assert (lse - want_lse).abs().max().item() <= 1e-5 * max(
        1.0, want_lse.abs().max().item())
    if x.dtype == torch.float32:
        err = (grad - want_grad).abs().max().item()
        assert err <= 1e-5 * want_grad.abs().max().item()
    else:
        assert bf16_ulps(grad, want_grad) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, c", CE_SHAPES)
def test_ce_kernels_match_plain(dev, n, c, dtype):
    """One forward and one backward launch, against the plain version;
    two runs give the same bits."""
    g = torch.Generator(device=dev).manual_seed(n * 1000 + c)
    x = (3.0 * torch.randn(n, c, device=dev, generator=g)).to(dtype)
    y = torch.randint(0, c, (n,), device=dev, generator=g)
    _ce_check(x, y, g_scale=0.5)


def test_kernels_launch_on_a_card_that_is_not_current():
    """A mesh rank's tensors may lie on a card other than the calling
    thread's current one: K5 and K1 on cuda:1 with cuda:0 current, each
    against its plain version (a launch into another card's stream from
    the wrong device gave wrong values, then NaN, on a four-card mesh)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.cuda.device(0):
        q, k, v = (torch.randn(2, 65, 3, 64, device=dev, generator=g)
                   for _ in range(3))
        with torch.no_grad():
            o, lse = flash_attention_with_lse(q, k, v, True, False)
        o_p, lse_p = flash_attention_with_lse_plain(q, k, v, True, False)
        assert (o - o_p).abs().max().item() <= TOL[torch.float32][0]
        assert (lse - lse_p).abs().max().item() <= TOL[torch.float32][1]
        x = 3.0 * torch.randn(64, 256, device=dev, generator=g)
        _ce_check(x, torch.randint(0, 256, (64,), device=dev, generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 10, 7])
def test_ce_kernels_read_unaligned_rows(dev, c, dtype):
    """Logits that start off a 16-byte boundary (and odd C, whose rows
    cannot all be aligned) take the kernels' one-element loads."""
    g = torch.Generator(device=dev).manual_seed(c)
    n = 257
    flat = (3.0 * torch.randn(n * c + 1, device=dev, generator=g)).to(dtype)
    x = flat[1:].view(n, c)
    y = torch.randint(0, c, (n,), device=dev, generator=g)
    _ce_check(x, y)


def test_ce_kernel_nan_rows(dev):
    """A +inf or NaN logit, an all -inf row, and a label outside [0, C)
    each make the loss NaN; the other rows' LSE and gradient stay those
    of the plain version."""
    from split_learning_tpu_torch.ops.cross_entropy import (
        ce_backward_cuda, ce_backward_plain, ce_forward_cuda,
        ce_forward_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    for c in (10, 256):
        base = 3.0 * torch.randn(8, c, device=dev, generator=g)
        labels = torch.randint(0, c, (8,), device=dev, generator=g)
        for fault in ("inf", "nan", "all_neg_inf", "label_neg", "label_c"):
            x, y = base.clone(), labels.clone()
            if fault == "inf":
                x[3, c // 2] = float("inf")
            elif fault == "nan":
                x[3, c - 1] = float("nan")
            elif fault == "all_neg_inf":
                x[3] = float("-inf")
            else:
                y[3] = -1 if fault == "label_neg" else c
            loss, lse = ce_forward_cuda(x, y)
            grad = ce_backward_cuda(x, y, lse, torch.ones((), device=dev))
            want_loss, want_lse = ce_forward_plain(x, y)
            want = ce_backward_plain(x, y, want_lse, torch.ones((), device=dev))
            assert loss.isnan().item() and want_loss.isnan().item(), fault
            rows = torch.arange(8, device=dev) != 3
            assert torch.isfinite(lse[rows]).all()
            assert (lse[rows] - want_lse[rows]).abs().max().item() <= 1e-5
            assert (grad[rows] - want[rows]).abs().max().item() <= 1e-6
            if fault.startswith("label"):
                assert torch.isfinite(grad[3]).all()
                assert (grad[3] - want[3]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_kernel_bit_identical_on_300_leaves(dev, momentum):
    """300 leaves of mixed, odd sizes (some 16-byte aligned, some views
    that are not) in one launch a step, bit-identical to the plain
    version over five steps."""
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    rs = np.random.RandomState(300)
    sizes = [int(v) for v in rs.randint(1, 3000, 300)]
    g = torch.Generator(device=dev).manual_seed(1)

    def leaves(misalign):
        out = []
        for i, n in enumerate(sizes):
            if misalign and i % 3 == 0:
                out.append(torch.randn(n + 1, device=dev, generator=g)[1:])
            else:
                out.append(torch.randn(n, device=dev, generator=g))
        return out

    p_k = leaves(True)
    p_p = [t.clone() for t in p_k]
    m_k = [torch.zeros_like(t) for t in p_k] if momentum else None
    m_p = [torch.zeros_like(t) for t in p_k] if momentum else None
    for _ in range(5):
        grads = leaves(True)
        LAUNCHES.reset()
        sgd_step_cuda(p_k, grads, m_k, 0.01, momentum)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {SGD: 1}
        sgd_step_plain(p_p, grads, m_p, 0.01, momentum)
    for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_kernel_bit_identical_on_mixed_bf16_leaves(dev, momentum):
    """float32 and bfloat16 leaves in one launch a step: a bfloat16 leaf
    updated in float32 against a float32 trace and rounded to nearest
    even, bit-identical to the plain version over five steps, aligned
    leaves and views one element off their vector alignment alike."""
    from split_learning_tpu_torch.ops.sgd import (
        NAME as SGD, sgd_step_cuda, sgd_step_plain)
    rs = np.random.RandomState(54)
    spec = [(int(n), torch.bfloat16 if i % 2 else torch.float32)
            for i, n in enumerate(rs.randint(1, 5000, 54))]
    g = torch.Generator(device=dev).manual_seed(2)

    def leaves():
        out = []
        for i, (n, dt) in enumerate(spec):
            t = torch.randn(n + 1, device=dev, generator=g).to(dt)
            out.append(t[1:] if i % 3 == 0 else t[:n])
        return out

    p_k = leaves()
    p_p = [t.clone() for t in p_k]
    m_k = ([torch.zeros(t.shape, device=dev) for t in p_k] if momentum
           else None)
    m_p = [t.clone() for t in m_k] if momentum else None
    for _ in range(5):
        grads = leaves()
        LAUNCHES.reset()
        sgd_step_cuda(p_k, grads, m_k, 0.1, momentum)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {SGD: 1}
        sgd_step_plain(p_p, grads, m_p, 0.1, momentum)
    for a, b in zip(p_k + (m_k or []), p_p + (m_p or [])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_party_lm_step_on_the_card(dev, dtype):
    """One two-party LM step (AdamW, warmup, cosine decay, clipping) over
    LocalTransport(ServerRuntime) with an int8 wire on the card: exact
    launch counts (client 1 K5 and 1 of each K6 launch; server 2 K5, 2 of
    each K6 launch and the K1 pair; 2 K3 quantize and 2 dequantize; no
    K2 under AdamW), the cut in the plan's dtype, and the loss within a
    CPU twin's bound (float32 1e-3 on int8; bf16 two bf16 ulps at the
    loss's magnitude, times 4 on int8)."""
    import math

    from split_learning_tpu_torch.data import batches, synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    size = dict(model="transformer_lm", vocab=256, d_model=64, num_heads=2,
                client_depth=1, server_depth=2, max_len=256, attn="flash")
    cfg = Config(transport="local", model="transformer_lm", attn="flash",
                 batch_size=4, dtype=dtype, optimizer="adamw", lr=3e-3,
                 weight_decay=0.1, warmup_steps=1, decay_steps=4,
                 grad_clip_norm=1.0)
    data = list(batches(synthetic_lm(n_train=8, n_test=4, seq_len=128).train,
                        4, seed=0))
    plan = get_plan(dtype=dtype, **size)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    losses, sent = {}, []
    for where in ("cuda", "cpu"):
        server = ServerRuntime(plan, cfg, init, device=where)
        transport = LocalTransport(server, compress="int8")
        pack = transport._pack_up

        def spy(arr, key, _pack=pack):
            sent.append(arr.dtype)
            return _pack(arr, key)

        transport._pack_up = spy
        client = SplitClientTrainer(plan, cfg, init, transport, device=where)
        LAUNCHES.reset()
        losses[where] = [client.train_step(x, y, i)
                         for i, (x, y) in enumerate(data)]
        if where == "cuda":
            torch.cuda.synchronize()
            per_step = {FA: 3, **{n: 3 for n in BWD_NAMES}, FWD: 1, BWD: 1,
                        qmod.QUANT: 2, qmod.DEQUANT: 2}
            assert LAUNCHES.snapshot() == {k: 2 * v
                                           for k, v in per_step.items()}
    assert set(sent) == {getattr(torch, dtype)}
    for a, b in zip(losses["cuda"], losses["cpu"]):
        tol = (1e-3 if dtype == "float32" else
               4 * 2 * 2.0 ** (math.floor(math.log2(b)) - 7))
        assert abs(a - b) <= tol, losses


# --------------------------------------------------------------------- #
# the wire: K3, K4, the wire codec, the two-party trainer and split-party
# decode on the card

WIRE_SIZES = (1, 127, 129, 4099, 64 * 26 * 26 * 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", WIRE_SIZES)
def test_wire_kernels_match_plain(dev, n, dtype):
    """K3's amax/quantize launch and its dequantize and K4's magnitude
    fold: bit-equal to their plain versions, one launch each."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    g = torch.Generator(device=dev).manual_seed(n)
    x = (3.0 * torch.randn(n, device=dev, generator=g)).to(dtype)
    res = torch.randn(n, device=dev, generator=g)
    n_out = qmod.tile_rows(n) * qmod.LANE
    LAUNCHES.reset()
    buf = qmod.q8_encode_cuda(x, n_out)
    stats, q = qmod.q8_views(buf)
    deq = qmod.dequantize_cuda(q, stats[1].item())
    fold = kmod.fold_magnitudes_cuda(x, res, 0.5)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {qmod.QUANT: 1, qmod.DEQUANT: 1,
                                   kmod.NAME: 1}
    assert torch.equal(buf, qmod.q8_encode_plain(x, n_out))
    assert torch.equal(deq, qmod.dequantize_plain(q, stats[1].item()))
    for a, b in zip(fold, kmod.fold_magnitudes_plain(x, res, 0.5)):
        assert torch.equal(a, b)


def _select_input(dev, n, kind, dtype):
    if kind == "random":
        x = 3.0 * torch.randn(n, device=dev,
                              generator=torch.Generator(dev).manual_seed(n))
    elif kind == "ties":
        x = torch.full((n,), 0.7, device=dev)
    else:
        x = torch.zeros(n, device=dev)
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "ties", "zeros"])
@pytest.mark.parametrize("density", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("n", WIRE_SIZES)
def test_topk8_select_kernels_match_plain(dev, n, density, kind, dtype):
    """K4's five launches: the buffer and the new residual bit-equal to
    the plain version, with a residual at decay 0.5 and without."""
    import math
    from split_learning_tpu_torch.ops import topk as kmod
    x = _select_input(dev, n, kind, dtype)
    res = 0.5 * torch.randn(n, device=dev,
                            generator=torch.Generator(dev).manual_seed(7))
    k = max(1, min(n, math.ceil(density * n)))
    for r, keep in ((res, True), (None, False)):
        buf, new_res = kmod.topk8_select_cuda(x, r, 0.5, k, keep)
        want_buf, want_res = kmod.topk8_select_plain(x, r, 0.5, k, keep)
        torch.cuda.synchronize()
        assert torch.equal(buf, want_buf)
        if keep:
            assert torch.equal(new_res, want_res)
        else:
            assert new_res is None


def test_topk8_select_launch_count_and_reset(dev):
    """One encode is exactly the five select launches; two encodes in a
    row on one stream give the same bytes (the scratch resets itself),
    and a NaN is flagged without a fault."""
    from split_learning_tpu_torch.ops import topk as kmod
    n = 64 * 26 * 26 * 32
    x = _select_input(dev, n, "random", torch.float32)
    LAUNCHES.reset()
    first = kmod.topk8_select_cuda(x, None, 1.0, n // 10)[0]
    second = kmod.topk8_select_cuda(x, None, 1.0, n // 10)[0]
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {name: 2
                                   for name in kmod.SELECT_LAUNCHES}
    assert torch.equal(first, second)
    y = x.clone()
    y[1234] = float("nan")
    buf = kmod.topk8_select_cuda(y, None, 1.0, n // 10)[0]
    assert kmod.split_select(buf.cpu(), n, n // 10)[0]
    assert torch.equal(kmod.topk8_select_cuda(x, None, 1.0, n // 10)[0],
                       first)


def test_wire_kernels_round_half_to_even_and_flag_non_finite(dev):
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.transport import codec
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], device=dev)
    q, scale = qmod.quantize_int8(x)
    assert scale.item() == 1.0
    assert q.reshape(-1)[:6].tolist() == [127, 0, 2, 2, 0, -2]
    y = torch.randn(1000, device=dev)
    y[17] = float("nan")
    assert kmod.fold_magnitudes_cuda(y)[2].item() == 1
    assert kmod.split_select(kmod.topk8_select_cuda(y, None, 1.0, 100)[0].cpu(),
                             1000, 100)[0]
    with pytest.raises(codec.CodecError):
        codec.q8_compress(y)
    with pytest.raises(codec.CodecError):
        codec.topk8_compress(y, 0.1)


@pytest.mark.parametrize("density", [0.1, 0.01])
def test_card_frames_equal_host_frames(dev, density):
    """The codec on a CUDA tensor gives the numpy path's frames (q8, and
    three topk8 EF steps at decay 0.5), and the same residuals."""
    from split_learning_tpu_torch.transport import codec
    ef_card, ef_host = codec.TopK8EF(), codec.TopK8EF()
    for step in range(3):
        x = np.random.RandomState(step).randn(64, 26, 26, 32).astype(
            np.float32)
        xd = torch.from_numpy(x).to(dev)
        assert codec.encode(codec.q8_compress(xd)) == codec.encode(
            codec.q8_compress(x))
        assert codec.encode(ef_card.compress("k", xd, density, 0.5)) == \
            codec.encode(ef_host.compress("k", x, density, 0.5))
        np.testing.assert_array_equal(ef_card.residual("k").cpu().numpy(),
                                      ef_host.residual("k"))
        out = codec.decompress_tree(codec.decode(codec.encode(
            codec.q8_compress(x))), dev)
        assert out.is_cuda
        np.testing.assert_array_equal(
            out.cpu().numpy(), codec.q8_decompress(codec.q8_compress(x)))


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
def test_two_party_training_on_the_card(dev, compress):
    """Two steps of the split CNN through LocalTransport(ServerRuntime) on
    the card: exact launch counts, the gradient back on the card, losses
    within 1e-4 of a CPU twin (1e-3 with int8 and topk8)."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    data = list(batches(synthetic("mnist", n_train=64, n_test=8).train, 32,
                        seed=0))
    losses = {}
    for where in ("cuda", "cpu"):
        server = ServerRuntime(get_plan(), Config(batch_size=32),
                               torch.Generator().manual_seed(0),
                               device=where)
        client = SplitClientTrainer(
            get_plan(), Config(batch_size=32),
            torch.Generator().manual_seed(0),
            LocalTransport(server, compress=compress), device=where)
        LAUNCHES.reset()
        losses[where] = [client.train_step(x, y, i)
                         for i, (x, y) in enumerate(data)]
        torch.cuda.synchronize()
        if where == "cuda":
            per_step = {FWD: 1, BWD: 1, SGD: 2}
            if compress == "int8":
                per_step.update({qmod.QUANT: 2, qmod.DEQUANT: 2})
            if compress == "topk8":
                per_step.update({name: 2 for name in kmod.SELECT_LAUNCHES})
            assert LAUNCHES.snapshot() == {k: 2 * v
                                           for k, v in per_step.items()}
    tol = 1e-4 if compress == "none" else 1e-3
    assert max(abs(a - b) for a, b in zip(*losses.values())) <= tol


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
def test_two_party_over_http_on_the_card(dev, compress):
    """The same two steps over a real socket: a SplitHTTPServer on
    127.0.0.1:0 in a thread in front of the ServerRuntime on the card,
    the client over HttpTransport. The local wire's exact launch counts
    (the server decodes and packs on the card) and its losses within
    1e-5 (cuDNN's default backward sums in a varying order)."""
    from split_learning_tpu_torch.data import batches, synthetic
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, SplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils.config import Config
    data = list(batches(synthetic("mnist", n_train=64, n_test=8).train, 32,
                        seed=0))
    losses = {}
    for wire in ("local", "http"):
        server = ServerRuntime(get_plan(), Config(batch_size=32),
                               torch.Generator().manual_seed(0),
                               device="cuda")
        srv = None
        if wire == "http":
            srv = SplitHTTPServer(server).start()
            transport = HttpTransport(srv.url, timeout=60,
                                      compress=compress)
        else:
            transport = LocalTransport(server, compress=compress)
        client = SplitClientTrainer(get_plan(), Config(batch_size=32),
                                    torch.Generator().manual_seed(0),
                                    transport, device="cuda")
        LAUNCHES.reset()
        try:
            losses[wire] = [client.train_step(x, y, i)
                            for i, (x, y) in enumerate(data)]
            torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
        finally:
            if srv is not None:
                transport.close()
                srv.stop()
        per_step = {FWD: 1, BWD: 1, SGD: 2}
        if compress == "int8":
            per_step.update({qmod.QUANT: 2, qmod.DEQUANT: 2})
        if compress == "topk8":
            per_step.update({name: 2 for name in kmod.SELECT_LAUNCHES})
        assert counts == {k: 2 * v for k, v in per_step.items()}
    assert max(abs(a - b) for a, b in zip(*losses.values())) <= 1e-5


@pytest.mark.parametrize("compress", [None, "none", "int8", "topk8"])
def test_generate_remote_on_the_card(dev, compress):
    """Split-party decode of a small flash LM on the card: exactly 3 K5
    launches per token plus the wire launches of two frames per token;
    on the uncompressed wires the local re-forward decode's tokens."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, generate_remote, greedy_generate)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    size = dict(model="transformer_lm", vocab=64, d_model=32, num_heads=2,
                max_len=128, attn="flash")
    plan = get_plan(**size)
    params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    on_card = [{k: v.to(dev) for k, v in st.items()} for st in params]
    prompt = np.random.RandomState(0).randint(0, 64, (4, 40)).astype(
        np.int32)
    server = ServerRuntime(get_plan(**size), Config(batch_size=4), params,
                           device="cuda")
    n_new = 6
    LAUNCHES.reset()
    toks = generate_remote(plan, on_card[:1],
                           LocalTransport(server, compress=compress),
                           prompt, n_new, device="cuda")
    torch.cuda.synchronize()
    per_token = {FA: 3}
    if compress == "int8":
        per_token.update({qmod.QUANT: 2, qmod.DEQUANT: 2})
    if compress == "topk8":
        per_token.update({name: 2 for name in kmod.SELECT_LAUNCHES})
    assert LAUNCHES.snapshot() == {k: v * n_new for k, v in per_token.items()}
    assert toks.shape == (4, 40 + n_new) and toks.min() >= 0 \
        and toks.max() < 64
    if compress in (None, "none"):
        want = greedy_generate(plan, on_card, prompt, n_new, kv_cache=False,
                               device="cuda")
        np.testing.assert_array_equal(toks, want.cpu().numpy())


def _cnn_data(n=64, batch=32):
    from split_learning_tpu_torch.data import batches, synthetic
    return list(batches(synthetic("mnist", n_train=n, n_test=8).train, batch,
                        seed=0))


def _wire_per_step(compress, frames):
    """Launches of ``frames`` card encodes and decodes a step."""
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops import topk as kmod
    if compress == "int8":
        return {qmod.QUANT: frames, qmod.DEQUANT: frames}
    if compress == "topk8":
        return {name: frames for name in kmod.SELECT_LAUNCHES}
    return {}


@pytest.mark.parametrize("compress", ["none", "int8", "topk8"])
@pytest.mark.parametrize("wire", ["local", "http"])
def test_u_split_cnn_on_the_card(dev, wire, compress):
    """Two U-shaped CNN steps on the card: per step the client's K1 pair
    and 2 K2 (A and C), the server's 1 K2 (the trunk), and four frames'
    wire launches (two hops, each way); losses within 1e-4 of a CPU twin
    (1e-3 on int8 and topk8)."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, USplitClientTrainer)
    from split_learning_tpu_torch.transport import (
        HttpTransport, LocalTransport, SplitHTTPServer)
    from split_learning_tpu_torch.utils.config import Config
    data = _cnn_data()
    cfg = Config(mode="u_split", batch_size=32, lr=0.002)
    plan = get_plan(mode="u_split")
    losses = {}
    for where in ("cuda", "cpu"):
        server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                               device=where)
        srv = None
        if wire == "http" and where == "cuda":
            srv = SplitHTTPServer(server).start()
            transport = HttpTransport(srv.url, timeout=60,
                                      compress=compress)
        else:
            transport = LocalTransport(server, compress=compress)
        client = USplitClientTrainer(plan, cfg,
                                     torch.Generator().manual_seed(0),
                                     transport, device=where)
        LAUNCHES.reset()
        try:
            losses[where] = [client.train_step(x, y, i)
                             for i, (x, y) in enumerate(data)]
            torch.cuda.synchronize()
            counts = LAUNCHES.snapshot()
        finally:
            if srv is not None:
                transport.close()
                srv.stop()
        if where == "cuda":
            per_step = {FWD: 1, BWD: 1, SGD: 3,
                        **_wire_per_step(compress, 4)}
            assert counts == {k: 2 * v for k, v in per_step.items()}
            assert not server._u_residual
    tol = 1e-4 if compress == "none" else 1e-3
    assert max(abs(a - b) for a, b in zip(*losses.values())) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_u_split_lm_on_the_card(dev, dtype):
    """One U-shaped LM step (flash, AdamW) on the card over int8: the
    client's block 1 K5 and 1 of each K6 launch and the K1 pair (head C);
    the server's 2 blocks twice forward (hop 1, and the recompute of hop
    2: 4 K5) and 2 of each K6 launch; 4 K3 quantize and 4 dequantize; no
    K2 under AdamW. The hops carry the plan's dtype."""
    from split_learning_tpu_torch.data import batches, synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.runtime import (
        ServerRuntime, USplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    size = dict(model="transformer_lm", vocab=256, d_model=64, num_heads=2,
                client_depth=1, server_depth=2, max_len=256, attn="flash")
    cfg = Config(mode="u_split", model="transformer_lm", attn="flash",
                 batch_size=4, dtype=dtype, optimizer="adamw", lr=3e-3,
                 weight_decay=0.1, warmup_steps=1, decay_steps=4,
                 grad_clip_norm=1.0)
    (x, y), = list(batches(synthetic_lm(n_train=4, n_test=4,
                                        seq_len=128).train, 4, seed=0))
    plan = get_plan(mode="u_split", dtype=dtype, **size)
    server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    transport = LocalTransport(server, compress="int8")
    sent = []
    pack = transport._pack_up
    transport._pack_up = lambda arr, key: sent.append(arr.dtype) or pack(
        arr, key)
    client = USplitClientTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                 transport, device="cuda")
    LAUNCHES.reset()
    loss = client.train_step(x, y, 0)
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    want = {FA: 1 + 4, **{n: 1 + 2 for n in BWD_NAMES}, FWD: 1, BWD: 1,
            **_wire_per_step("int8", 4)}
    assert LAUNCHES.snapshot() == want
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert sent == [dt, dt]


def test_federated_two_clients_on_the_card(dev):
    """Two federated clients in threads against a server on the card
    (``num_clients=2``): per client and step the K1 pair and one K2
    launch; after the epoch both hold the same parameters, the mean of
    their pre-sync ones within 1e-6."""
    import threading

    from split_learning_tpu_torch.interop import params_to_jax
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import (
        FederatedClientTrainer, ServerRuntime, leaves_of)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    data = _cnn_data(n=128)
    shards = [data[:2], data[2:]]
    cfg = Config(mode="federated", batch_size=32, lr=0.002, num_clients=2)
    plan = get_plan(mode="federated")
    server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    clients = [FederatedClientTrainer(plan, cfg,
                                      torch.Generator().manual_seed(0),
                                      LocalTransport(server), device="cuda")
               for _ in range(2)]
    pre = {}
    for i, c in enumerate(clients):
        sync = c.sync

        def spy(*a, _i=i, _c=c, _sync=sync, **kw):
            pre[_i] = [t.detach().clone() for t in leaves_of(_c.params)]
            _sync(*a, **kw)

        c.sync = spy
    LAUNCHES.reset()
    threads = [threading.Thread(target=lambda i=i: clients[i].train(
        lambda: iter(shards[i]), epochs=1)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {FWD: 4, BWD: 4, SGD: 4}
    for a, b, p0, p1 in zip(leaves_of(clients[0].params),
                            leaves_of(clients[1].params), pre[0], pre[1]):
        assert torch.equal(a, b)
        assert (a - (p0 + p1) / 2).abs().max().item() <= 1e-6
    assert len(params_to_jax(server.params)) == 2


def test_multi_client_compressed_sync_on_the_card(dev):
    """Two split clients, a topk8 bottom sync every round: the first sync
    dense (no select launch), the second 5 select launches per leaf and
    ready client (the CNN's stage A has 2 leaves: 20); the bottoms equal
    after each sync."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops import topk as kmod
    from split_learning_tpu_torch.runtime import (
        MultiClientSplitRunner, ServerRuntime, leaves_of)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    cfg = Config(batch_size=32, num_clients=2)
    server = ServerRuntime(get_plan(), cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    runner = MultiClientSplitRunner(
        get_plan(), cfg, torch.Generator().manual_seed(0),
        lambda i: LocalTransport(server), sync_bottoms_every=1,
        sync_compress="topk8", device="cuda")
    data = _cnn_data()
    counts = []
    for r in range(2):
        runner.train_round([data[0], data[1]])
        LAUNCHES.reset()
        runner.sync_bottoms()
        torch.cuda.synchronize()
        counts.append(sum(LAUNCHES.snapshot().get(n, 0)
                          for n in kmod.SELECT_LAUNCHES))
        for a, b in zip(*(leaves_of(c.state.params)
                          for c in runner.clients)):
            assert torch.equal(a, b)
    # the sync inside round 0's train_round was dense and set the
    # reference; every sync after it is compressed
    assert counts == [20, 20]
    assert runner.sync_raw_bytes > runner.sync_wire_bytes > 0


# --------------------------------------------------------------------- #
# checkpoints and DevicePrefetch on the card (chip_smoke.py phase 24)

def test_checkpoint_snapshot_survives_in_place_updates_on_the_card(
        dev, tmp_path):
    """``save()`` clones on the card and returns; the same stream then
    updates the parameters in place (as the SGD kernel and Adam's
    ``_foreach`` ops do), and the checkpoint holds the values at
    save(), in their dtypes."""
    from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(1 << 20, device=dev, generator=gen),
            "pos": torch.randn(64, 32, device=dev, generator=gen)
            .to(torch.bfloat16), "step": 7}
    want = {k: v.clone().cpu() for k, v in tree.items() if k != "step"}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    for _ in range(20):
        tree["w"].mul_(1.5).add_(1.0)
        tree["pos"].add_(1.0)
    raw = ck.restore_raw(1)
    ck.close()
    assert raw["step"] == 7 and raw["pos"].dtype == torch.bfloat16
    for k, v in want.items():
        assert torch.equal(raw[k], v), k
    assert ck.stats["bytes"] > 4 << 20 and ck.stats["write_ms"] > 0


def test_device_prefetch_stages_on_a_side_stream(dev):
    """``DevicePrefetch(device="cuda")`` yields CUDA tensors equal to the
    source's batches, labels untouched, and the staging thread joined."""
    from split_learning_tpu_torch.data import DevicePrefetch
    rs = np.random.RandomState(0)
    data = [(rs.randn(64, 28, 28, 1).astype(np.float32), np.arange(64) + i)
            for i in range(6)]
    with DevicePrefetch(iter(data), depth=2, device="cuda") as it:
        got = [(x.clone(), y) for x, y in it]
    assert not it._thread.is_alive()
    for (x, y), (x0, y0) in zip(got, data):
        assert x.is_cuda and torch.equal(x.cpu(), torch.from_numpy(x0))
        assert y is y0


def test_fused_lm_resume_on_the_card(dev, tmp_path):
    """The bf16 LM (attn="flash") under AdamW with a schedule: 3 steps,
    a save, a fresh trainer restored from it, 3 more steps on each: the
    same losses and the same launches per step (K5 3, each K6 3, one K1
    pair, no K2)."""
    from split_learning_tpu_torch.data import synthetic_lm
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.runtime.checkpoint import Checkpointer
    from split_learning_tpu_torch.utils.config import Config
    plan = get_plan(model="transformer_lm", vocab=61, d_model=64,
                    num_heads=2, client_depth=1, server_depth=2,
                    max_len=128, attn="flash", dtype="bfloat16")
    ds = synthetic_lm(n_train=24, n_test=4, vocab=61, seq_len=96)
    cfg = Config(transport="fused", model="transformer_lm", attn="flash",
                 batch_size=4, dtype="bfloat16", optimizer="adamw", lr=3e-3,
                 weight_decay=0.1, warmup_steps=2, decay_steps=6,
                 grad_clip_norm=1.0)
    batches = [(ds.train.x[i:i + 4], ds.train.y[i:i + 4])
               for i in range(0, 24, 4)]

    def trainer(seed):
        return FusedSplitTrainer(plan, cfg, torch.Generator().manual_seed(
            seed), ds.train.x[:4], device="cuda")

    a = trainer(0)
    head = [a.train_step(x, y) for x, y in batches[:3]]
    ck = Checkpointer(str(tmp_path))
    ck.save(3, a.export_states())
    LAUNCHES.reset()
    tail = [a.train_step(x, y) for x, y in batches[3:]]
    want = LAUNCHES.snapshot()
    b = trainer(1)
    b.restore_states(ck.restore_raw(3))
    ck.close()
    assert b.state.step == 3 and b.state.params[0]["pos"].dtype == \
        torch.bfloat16
    LAUNCHES.reset()
    resumed = [b.train_step(x, y) for x, y in batches[3:]]
    assert LAUNCHES.snapshot() == want == {
        FA: 9, **{n: 9 for n in BWD_NAMES}, FWD: 3, BWD: 3}
    assert resumed == tail and all(np.isfinite(head))


# --------------------------------------------------------------------- #
# the server under many clients on the card (chip_smoke.py phase 25)

def _many_clients_server(device, **kw):
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import ServerRuntime
    from split_learning_tpu_torch.utils.config import Config
    return ServerRuntime(get_plan(), Config(batch_size=32, num_clients=4),
                         torch.Generator().manual_seed(0), device=device,
                         **kw)


def test_many_clients_group_step_matches_the_cpu(dev):
    """One group of [8, 8, 4] cut rows through ``_dispatch_group`` on the
    card: exactly one K1 forward, one K1 backward and one K2 launch, each
    member's gradient and loss and the server's parameters after it
    within 1e-4 of the same group on the CPU."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime.coalesce import CoalesceRequest
    g = torch.Generator().manual_seed(3)
    members = [(torch.randn(b, 26, 26, 32, generator=g),
                torch.randint(0, 10, (b,), generator=g)) for b in (8, 8, 4)]
    out = {}
    for device in ("cuda", "cpu"):
        server = _many_clients_server(device, coalesce_max=4)
        reqs = [CoalesceRequest(x.to(device), y.to(device), 0, i)
                for i, (x, y) in enumerate(members)]
        LAUNCHES.reset()
        server._dispatch_group(reqs, "full")
        replies = [r.result() for r in reqs]
        if device == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES.snapshot() == {FWD: 1, BWD: 1, SGD: 1}
            assert all(gr.is_cuda for gr, _ in replies)
        out[device] = ([(gr.cpu(), loss) for gr, loss in replies],
                       {k: v.detach().cpu() for k, v in
                        server.params.items()})
        server.close()
    for (ga, la), (gb, lb) in zip(out["cuda"][0], out["cpu"][0]):
        assert (ga - gb).abs().max().item() <= 1e-4
        assert abs(la - lb) <= 1e-4
    for k, v in out["cpu"][1].items():
        assert (out["cuda"][1][k] - v).abs().max().item() <= 1e-4, k


def test_many_clients_decoupled_backward_matches_the_cpu(dev):
    """2BP at lag 2 on the card: 6 steps of one client within 1e-4 of the
    same pair on the CPU; per step the K1 pair twice and K2 twice (the
    server's deferred apply and the client's update)."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    from split_learning_tpu_torch.runtime import SplitClientTrainer
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    data = _cnn_data(n=192)
    losses = {}
    for device in ("cuda", "cpu"):
        server = _many_clients_server(device, decouple_bwd=True,
                                      apply_lag=2)
        client = SplitClientTrainer(get_plan(), Config(batch_size=32),
                                    torch.Generator().manual_seed(0),
                                    LocalTransport(server), device=device)
        LAUNCHES.reset()
        losses[device] = [client.train_step(x, y, i)
                          for i, (x, y) in enumerate(data)]
        assert server.health()["decoupled_bwd"]["deferred_apply_depth"] == 2
        server.close()
        if device == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES.snapshot() == {FWD: 12, BWD: 12, SGD: 12}
    assert max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])) \
        <= 1e-4


def test_many_clients_concurrent_coalescing_on_the_card(dev):
    """Four concurrent clients against a coalescing server on the card:
    every step lands, the flusher's launches run on the card (the K1
    pair once a group), and the groups hold more than one request."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.ops.cross_entropy import FWD
    from split_learning_tpu_torch.runtime import MultiClientSplitRunner
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    server = _many_clients_server("cuda", coalesce_max=4,
                                  coalesce_window_ms=50.0)
    runner = MultiClientSplitRunner(
        get_plan(), Config(batch_size=32, num_clients=4),
        torch.Generator().manual_seed(0), lambda i: LocalTransport(server),
        concurrent=True, device="cuda")
    data = _cnn_data(n=128)
    LAUNCHES.reset()
    try:
        for r in range(3):
            losses = runner.train_round([data[(r + i) % len(data)]
                                         for i in range(4)])
            assert all(np.isfinite(v) for v in losses)
    finally:
        runner.close()
    torch.cuda.synchronize()
    c = server.health()["coalescing"]
    server.close()
    assert c["requests_coalesced"] == 12
    assert LAUNCHES.snapshot()[FWD] == c["groups_flushed"]
    assert c["mean_occupancy"] > 1.0


def test_many_clients_pipelined_depth1_is_the_synchronous_client(dev):
    """The pipelined client at depth 1 on the card: the synchronous
    client's losses bit for bit under deterministic cuDNN."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import (
        PipelinedSplitClientTrainer, SplitClientTrainer)
    from split_learning_tpu_torch.transport import LocalTransport
    from split_learning_tpu_torch.utils.config import Config
    data = _cnn_data(n=192)
    cfg = Config(batch_size=32)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sync = SplitClientTrainer(get_plan(), cfg,
                                  torch.Generator().manual_seed(0),
                                  LocalTransport(_many_clients_server("cuda")),
                                  device="cuda")
        want = [sync.train_step(x, y, i) for i, (x, y) in enumerate(data)]
        piped = PipelinedSplitClientTrainer(
            get_plan(), cfg, torch.Generator().manual_seed(0),
            LocalTransport(_many_clients_server("cuda")), depth=1,
            device="cuda")
        got = [r.loss for r in piped.train(lambda: iter(data), epochs=1)]
        piped.close()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert got == want


# --------------------------------------------------------------------- #
# the image families: ResNet-18 and the ViT (K5/K6 non-causal at the
# ViT's head dimension and token counts)

VIT_SHAPES = ((8, 49, 4, 16), (16, 64, 4, 16), (16, 64, 6, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,d", VIT_SHAPES)
def test_image_flash_at_vit_shapes_matches_plain(dev, b, t, h, d, dtype):
    """K5 and K6 non-causal at the ViT's shapes: MNIST's T 49 (a ragged
    tail in a 64-row block), CIFAR-10's T 64, D 16 (the defaults, padded
    to the 32-wide tile) and 64 (ViT-S): O and LSE within ``TOL``, each
    gradient within ``BWD_TOL`` of the plain version's largest entry."""
    g = torch.Generator(device=dev).manual_seed(t * d + h)
    q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    LAUNCHES.reset()
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, False)
    got = flash_bwd_cuda(q, k, v, o, lse, do, None, False)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {FA: 1, **{n: 1 for n in BWD_NAMES}}
    o_p, lse_p = flash_attention_with_lse_plain(q, k, v, False)
    tol_o, tol_l = TOL[dtype]
    assert (o.float() - o_p.float()).abs().max().item() <= tol_o
    assert (lse - lse_p).abs().max().item() <= tol_l
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, None, False)
    _assert_grads_close(got, want, dtype)


def _image_data(n, hw, c, batch):
    from split_learning_tpu_torch.data import batches, synthetic
    name = "cifar10" if c == 3 else "mnist"
    ds = synthetic(name, n_train=n, n_test=8, seed=1)
    return list(batches(ds.train, batch, seed=1, drop_remainder=True))


def _bf16_loss_tol(loss):
    """Two bfloat16 ulps at the loss's magnitude (chip_smoke.py's)."""
    return 2 * 2.0 ** (np.floor(np.log2(abs(loss))) - 7)


def _fused_twins(model, kw, cfg_kw, data, launches):
    """The fused trainer on the card and on the CPU from one init: the
    card's launch counts over the run, and both loss series."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import FusedSplitTrainer
    from split_learning_tpu_torch.utils.config import Config
    plan = get_plan(model=model, **kw)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    cfg = Config(transport="fused", model=model, batch_size=len(data[0][1]),
                 **cfg_kw)
    losses = {}
    for where in ("cuda", "cpu"):
        trainer = FusedSplitTrainer(plan, cfg, init, data[0][0],
                                    device=where)
        LAUNCHES.reset()
        losses[where] = [trainer.train_step(x, y) for x, y in data]
        if where == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES.snapshot() == {
                name: n * len(data) for name, n in launches.items()}
    return losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_resnet18_fused_steps_on_the_card(dev, dtype):
    """Two fused SGD steps of ResNet-18 at batch 16 on the card against
    the CPU from one init: per step exactly one K1 pair and one K2 launch
    (62 leaves); losses within 1e-4 (float32, deterministic cuDNN) or two
    bf16 ulps at the loss's magnitude."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = _fused_twins(
            "resnet18", dict(dtype=dtype), dict(dtype=dtype),
            _image_data(32, 32, 3, 16), {FWD: 1, BWD: 1, SGD: 1})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for a, b in zip(losses["cuda"], losses["cpu"]):
        tol = 1e-4 if dtype == "float32" else _bf16_loss_tol(b)
        assert abs(a - b) <= tol, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["split", "u_split"])
def test_image_vit_flash_fused_steps_on_the_card(dev, mode, dtype):
    """Two fused SGD steps of the ViT (defaults: d_model 64, 4 heads,
    depths 1 + 2) with ``attn="flash"`` on CIFAR-10's T 64 at batch 16:
    per step exactly 3 K5 and 3 of each K6 launch (non-causal, one a
    block), one K1 pair and one K2; losses within 1e-4 of the CPU's
    (float32) or two bf16 ulps."""
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    losses = _fused_twins(
        "vit", dict(mode=mode, attn="flash", channels=3, dtype=dtype),
        dict(mode=mode, attn="flash", dtype=dtype),
        _image_data(32, 32, 3, 16),
        {FA: 3, **{n: 3 for n in BWD_NAMES}, FWD: 1, BWD: 1, SGD: 1})
    for a, b in zip(losses["cuda"], losses["cpu"]):
        tol = 1e-4 if dtype == "float32" else _bf16_loss_tol(b)
        assert abs(a - b) <= tol, losses


def _chain3(device, m, schedule="gpipe", compress=None):
    """``split_cnn_chain3`` at batch 16, ``m`` microbatches, lag 0, from
    one init: ``DeviceTransport`` wires, or ``LocalTransport`` with
    ``compress``."""
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime import PipelineRunner, StageRuntime
    from split_learning_tpu_torch.transport import (
        DeviceTransport, LocalTransport)
    from split_learning_tpu_torch.utils import Config
    plan = get_plan(model="split_cnn_chain3")
    cfg = Config(model="split_cnn_chain3", num_stages=3, microbatches=m,
                 batch_size=16, schedule=schedule)
    init = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    stages = [StageRuntime(plan, i, cfg, init, microbatches=m,
                           device=device) for i in (1, 2)]
    wires = [DeviceTransport(s) if compress is None
             else LocalTransport(s, compress=compress) for s in stages]
    return (PipelineRunner(plan, cfg, init, None, wires, microbatches=m,
                           schedule=schedule, device=device), stages, wires)


def _chain_losses(chain, data):
    runner, stages, _ = chain
    try:
        return [runner.step(x, y, i) for i, (x, y) in enumerate(data)]
    finally:
        runner.close()
        for s in stages:
            s.close()


@pytest.mark.parametrize("compress", [None, "int8"])
def test_chain_steps_on_the_card(dev, compress):
    """Three steps of the 3-stage chain at M 4 on the card against the
    CPU from one init (deterministic cuDNN): per step exactly 2M K1
    pairs (the loss hops and the last stage's recompute), 3 K2 (the hub
    and one deferred apply a stage) and, on ``int8``, (4S - 6) M packs
    and decodes; no host copy on the device wire; 1F1B bit-equal to
    GPipe; losses within 1e-4 (``None``) or 1e-3 (``int8``) of the
    CPU's."""
    from split_learning_tpu_torch.obs import spans
    from split_learning_tpu_torch.ops import quantize as qmod
    from split_learning_tpu_torch.ops.cross_entropy import BWD, FWD
    from split_learning_tpu_torch.ops.sgd import NAME as SGD
    rs = np.random.RandomState(0)
    data = [(rs.rand(16, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, 16).astype(np.int64)) for _ in range(3)]
    per_step = {FWD: 8, BWD: 8, SGD: 3}
    if compress == "int8":
        per_step.update({qmod.QUANT: 24, qmod.DEQUANT: 24})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        chain = _chain3("cuda", 4, compress=compress)
        LAUNCHES.reset()
        card = _chain_losses(chain, data)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {k: 3 * v for k, v in per_step.items()}
        for t in chain[2]:
            assert t.stats.counters.get(spans.HOP_HOST_COPIES, 0) == 0
        if compress is None:
            assert _chain_losses(_chain3("cuda", 4, "1f1b"), data) == card
        cpu = _chain_losses(_chain3("cpu", 4, compress=compress), data)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    tol = 1e-4 if compress is None else 1e-3
    assert max(abs(a - b) for a, b in zip(card, cpu)) <= tol, (card, cpu)
