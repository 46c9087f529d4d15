"""The port's transformer plans against the JAX package's, on the CPU.

Parameters start in JAX (flax init) and cross to the port through
``split_learning_tpu_torch.interop``; token inputs are numpy arrays from
a seed. float32 logits are held to 2e-5 (two libraries sum in different
orders). bf16 logits are held to 1e-1: bf16 rounds at other places in
the two frameworks, and at this size JAX's own bf16 logits differ from
its f32 ones by about 4e-2 (|logit| up to 3.8), so the f32 test is the
one that holds the algorithm. With attn="flash" the port runs the
kernel's plain version and JAX its Pallas kernel in interpret mode.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu_torch.interop import params_from_jax, params_to_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.models import transformer as tmod

V, E, HEADS, B, T = 61, 32, 2, 2, 16
SIZE = dict(vocab=V, d_model=E, num_heads=HEADS, client_depth=1,
            server_depth=2, max_len=64)
PLANS = [(m, mode) for m in ("transformer", "transformer_lm")
         for mode in ("split", "u_split")]


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_trees():
    """One flax init per (model, mode, dtype); attn does not change the
    parameter tree."""
    trees = {}
    for model, mode in PLANS:
        for dtype in ("float32", "bfloat16"):
            plan = jax_get_plan(model=model, mode=mode, dtype=dtype, **SIZE)
            trees[model, mode, dtype] = plan.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(_tokens()))
    return trees


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model,mode", PLANS)
def test_interop_round_trip_bit_exact(jax_trees, model, mode, dtype):
    jparams = jax_trees[model, mode, dtype]
    port = params_from_jax(jparams)
    flat_a = jax.tree_util.tree_leaves_with_path(jparams)
    flat_b = jax.tree_util.tree_leaves_with_path(params_to_jax(port))
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        a = np.asarray(a)
        assert a.shape == b.shape, path
        # a bf16 leaf keeps bf16 (and its bits) in both directions
        assert b.dtype == a.dtype, path
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))
    pos = port[0]["pos"]
    assert pos.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert all(v.dtype == torch.float32 for st in port
               for k, v in st.items() if k != "pos")
    plan = get_plan(model=model, mode=mode, dtype=dtype, **SIZE)
    fresh = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    assert [sorted(p) for p in fresh] == [sorted(p) for p in port]
    assert all(fresh[i][k].shape == port[i][k].shape
               and fresh[i][k].dtype == port[i][k].dtype
               for i in range(len(port)) for k in port[i])


@pytest.mark.parametrize("attn", ["full", "flash"])
@pytest.mark.parametrize("model,mode", PLANS)
def test_f32_logits_match_jax(jax_trees, model, mode, attn):
    jparams = jax_trees[model, mode, "float32"]
    jplan = jax_get_plan(model=model, mode=mode, attn=attn, **SIZE)
    x = _tokens(1)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)))
    plan = get_plan(model=model, mode=mode, attn=attn, **SIZE)
    with torch.no_grad():
        got = plan.apply(params_from_jax(jparams), torch.from_numpy(x))
    assert got.shape == want.shape
    assert got.shape == ((B, T, V) if model == "transformer_lm" else (B, 10))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("model,mode", PLANS)
def test_bf16_logits_near_jax(jax_trees, model, mode):
    jparams = jax_trees[model, mode, "bfloat16"]
    jplan = jax_get_plan(model=model, mode=mode, dtype="bfloat16", **SIZE)
    x = _tokens(1)
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)).astype(
        jnp.float32))
    plan = get_plan(model=model, mode=mode, dtype="bfloat16", **SIZE)
    with torch.no_grad():
        got = plan.apply(params_from_jax(jparams), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 1e-1


def test_layernorm_epsilon_is_flax_not_torch():
    """At a variance near 1e-6 the epsilon decides the output."""
    x = (1e-3 * np.random.RandomState(3).randn(4, E)).astype(np.float32)
    ln = fnn.LayerNorm()
    want = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), x), x))
    port = tmod.LayerNorm(E, torch.float32)
    w, b = torch.ones(E), torch.zeros(E)
    got = torch.func.functional_call(port, {"weight": w, "bias": b},
                                     (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    torch_default = F.layer_norm(torch.from_numpy(x), (E,), w, b)
    assert np.abs(torch_default.numpy() - want).max() > 1e-2


def test_block_gelu_is_tanh_approximation(jax_trees, monkeypatch):
    """The transformer block matches flax; with torch's exact GELU it
    would not."""
    from split_learning_tpu.models.transformer import Block as JaxBlock
    x = 3.0 * np.random.RandomState(4).randn(2, 5, E).astype(np.float32)
    jblk = JaxBlock(HEADS)
    jp = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jblk.apply(jp, jnp.asarray(x)))
    port = tmod.Block(E, HEADS, "full", False, torch.float32)
    params = params_from_jax([jp])[0]

    def run():
        with torch.no_grad():
            return torch.func.functional_call(
                port, params, (torch.from_numpy(x),)).numpy()

    np.testing.assert_allclose(run(), want, atol=2e-5)
    exact = F.gelu
    monkeypatch.setattr(tmod.F, "gelu",
                        lambda y, approximate="none": exact(y))
    assert np.abs(run() - want).max() > 1e-4


def test_embedding_ids_outside_vocab_follow_jax():
    """jnp.take inside nn.Embed: negative ids count from the end, ids
    outside [-V, V) give NaN rows. F.embedding raises on them."""
    ids = np.array([[0, V - 1, V, V + 3, -1, -V, -V - 1]], np.int32)
    emb = fnn.Embed(V, E)
    jp = emb.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    want = np.asarray(emb.apply(jp, jnp.asarray(ids)))
    table = torch.tensor(np.asarray(jp["params"]["embedding"]))
    port = tmod.Embed(V, E, torch.float32)
    got = torch.func.functional_call(port, {"weight": table},
                                     (torch.from_numpy(ids),)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(want[0, 2]).all() and not np.isnan(want[0, 4]).any()
    with pytest.raises(IndexError):
        F.embedding(torch.from_numpy(ids).long(), table)
    with pytest.raises(ValueError, match="integer"):
        port(torch.zeros(1, 2))


def test_out_of_vocab_token_gives_nan_logits_like_jax(jax_trees):
    jparams = jax_trees["transformer_lm", "split", "float32"]
    jplan = jax_get_plan(model="transformer_lm", **SIZE)
    x = _tokens(2)
    x[0, 3] = V + 2
    want = np.asarray(jplan.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = get_plan(model="transformer_lm", **SIZE).apply(
            params_from_jax(jparams), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 3:]).all() and not np.isnan(got[1]).any()


def test_get_plan_dtypes():
    cnn = get_plan(model="split_cnn", dtype="bfloat16")
    params = cnn.init(torch.Generator().manual_seed(0), torch.zeros(1))
    assert all(v.dtype == torch.float32 for st in params for v in st.values())
    with torch.no_grad():
        y = cnn.apply(params, torch.zeros(2, 28, 28, 1))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 10)
    for model in ("transformer", "transformer_lm"):
        plan = get_plan(model=model, dtype="bfloat16", **SIZE)
        params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
        assert params[0]["pos"].dtype == torch.bfloat16
        with torch.no_grad():
            y = plan.apply(params, torch.from_numpy(_tokens()))
        assert y.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="item 14"):
        get_plan(model="transformer", dtype="float16")


@pytest.mark.parametrize("attn,exc,match", [
    ("auto", None, "full"),
    ("ring", None, "full"),
    ("ring_flash", None, "flash"),
    ("ulysses", None, "full"),
    ("bogus", ValueError, "Unknown attn"),
])
def test_attention_choices(jax_trees, attn, exc, match):
    """An unknown name raises; ``auto`` and the sequence-parallel forms
    build, and with no ``seq`` axis run the single-device math ``match``
    names, as JAX's do (their meshed numbers are
    tests/test_torch_port_ring_attention.py's). ``auto`` resolves per
    shape (dense at this one on the CPU) and gives JAX's logits."""
    if exc is None:
        ref = get_plan(model="transformer_lm", attn=match, **SIZE)
        params = ref.init(torch.Generator().manual_seed(0), torch.zeros(1))
        tokens = torch.from_numpy(_tokens())
        with torch.no_grad():
            got = get_plan(model="transformer_lm", attn=attn,
                           **SIZE).apply(params, tokens)
            assert torch.equal(got, ref.apply(params, tokens))
        if attn == "auto":
            jparams = jax_trees["transformer_lm", "split", "float32"]
            want = np.asarray(jax_get_plan(
                model="transformer_lm", attn="auto", **SIZE).apply(
                    jparams, jnp.asarray(_tokens())))
            with torch.no_grad():
                got = get_plan(model="transformer_lm", attn="auto",
                               **SIZE).apply(params_from_jax(jparams), tokens)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        return
    with pytest.raises(exc, match=match):
        get_plan(model="transformer_lm", attn=attn)
    if exc is ValueError:
        with pytest.raises(ValueError):
            jax_get_plan(model="transformer_lm", attn=attn)


@pytest.mark.parametrize("model,mode", PLANS)
def test_fresh_init_has_flax_statistics(jax_trees, model, mode):
    """Per-leaf std within 15% of flax's, on the leaves large enough to
    tell (LayerNorm scales 1 and biases 0 in both)."""
    want = params_from_jax(jax_trees[model, mode, "float32"])
    plan = get_plan(model=model, mode=mode, **SIZE)
    got = plan.init(torch.Generator().manual_seed(4), torch.zeros(1))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if g[k].numel() >= 512:
                ratio = g[k].std().item() / w[k].std().item()
                assert 0.85 < ratio < 1.15, (k, ratio)
            elif k.endswith("bias") or ".ln" in k:
                torch.testing.assert_close(g[k], w[k])


def test_stage_apply_passes_cache_keywords():
    plan = get_plan(model="transformer_lm", **SIZE)
    params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    x = torch.from_numpy(_tokens())
    with torch.no_grad():
        h, caches = plan.stages[0].apply(params[0], x, cache_len=20)
    assert h.shape == (B, T, E) and len(caches) == 1
    assert caches[0]["k"].shape == (B, 20, HEADS, E // HEADS)
    assert (caches[0]["k"][:, T:] == 0).all()
    classifier = get_plan(model="transformer", **SIZE)
    cparams = classifier.init(torch.Generator().manual_seed(0),
                              torch.zeros(1))
    with pytest.raises(ValueError, match="requires the causal-LM head"):
        classifier.stages[1].apply(cparams[1], h, cache_len=20)
