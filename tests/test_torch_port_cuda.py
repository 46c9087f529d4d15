"""The port on the card: kernels against their plain versions and the
serving path on CUDA tensors. Every test is marked ``cuda`` and skips
without a card. This file imports no JAX, so it runs where JAX is not
installed; tests/conftest.py imports JAX, hence on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances are chip_smoke.py's. Forward: float32 2e-5 on O and LSE
(summation order and online rescaling against one dense softmax); bf16
3e-2 on O (two bf16 ulps at |o| near 2) and 1e-3 on LSE. Backward:
``BWD_TOL`` times the largest gradient entry of the plain version
(float32: the tile loop's summation order against one dense sum per
product; bf16: two bf16 ulps of the largest entry, since both round
float32 sums that differ only in that order).
"""

import numpy as np
import pytest
import torch

from split_learning_tpu_torch.ops.common import LAUNCHES, NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    BWD_NAMES, NAME as FA, flash_attention, flash_attention_bwd_plain,
    flash_attention_with_lse, flash_attention_with_lse_plain,
    flash_bwd_cuda)

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 1e-3)}
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
    ceil(54 leaves / 24) = 3 K2 launches; losses within 1e-4 of a CPU
    twin from the same parameters."""
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
                                   FWD: 2, BWD: 2, SGD: 6}
    want = [cpu.train_step(x, y) for x, y in batches]
    assert max(abs(a - b) for a, b in zip(losses, want)) <= 1e-4
