"""The port on the card: kernels against their plain versions and the
serving path on CUDA tensors. Every test is marked ``cuda`` and skips
without a card. This file imports no JAX, so it runs where JAX is not
installed; tests/conftest.py imports JAX, hence on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances are chip_smoke.py's: float32 2e-5 on O and LSE (summation
order and online rescaling against one dense softmax); bf16 3e-2 on O
(two bf16 ulps at |o| near 2) and 1e-3 on LSE.
"""

import numpy as np
import pytest
import torch

from split_learning_tpu_torch.ops.common import LAUNCHES, NEG_BIG
from split_learning_tpu_torch.ops.flash_attention import (
    NAME as FA, flash_attention, flash_attention_with_lse,
    flash_attention_with_lse_plain)

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 1e-3)}
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
    with pytest.raises(NotImplementedError, match="K6"):
        flash_attention(x.clone().requires_grad_(True), x, x)
    with pytest.raises(ValueError):
        flash_attention(x, x.cpu(), x)


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
