"""The port's serving path against the JAX package's, on the CPU:
generation (prefill, KV-cache decode, re-forward decode, greedy and
sampled), split-party decode (``generate_remote``) over the in-process
wire, forward-only evaluation on token data, and the token datasets.

Parameters start in JAX and cross through ``interop``; prompts come from
numpy with a seed. Greedy tokens must equal JAX's; prefill caches agree
within 2e-5 (float32, different summation orders). Sampling draws from a
``torch.Generator``, which cannot give JAX's bits, so it is held by its
properties. ``generate_remote`` runs at JAX's own test size
(tests/test_split_inference.py): token-exact against the local
re-forward decode and against JAX's ``generate_remote``, with either
package's transport and server on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.runtime.evaluate import evaluate as jax_evaluate
from split_learning_tpu.runtime.evaluate import (
    split_client_stages as jax_split_client_stages)
from split_learning_tpu.runtime import ServerRuntime as JaxServer
from split_learning_tpu.runtime.generate import (
    generate_remote as jax_generate_remote, greedy_generate as jax_greedy,
    sample_generate as jax_sample)
from split_learning_tpu.transport import LocalTransport as JaxLocal
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.data import datasets as tds
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime import (
    ServerRuntime, evaluate, generate_remote, greedy_generate,
    sample_generate, split_client_stages)
from split_learning_tpu_torch.runtime.fused import check_supported
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

V, B, P, N_NEW = 61, 2, 5, 8
SIZE = dict(vocab=V, d_model=32, num_heads=2, client_depth=1,
            server_depth=2, max_len=64)


def _prompt(seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, P)).astype(np.int32)


@pytest.fixture(scope="module")
def lm():
    """(JAX plan, JAX params, port params) for the split causal LM."""
    jplan = jax_get_plan(model="transformer_lm", **SIZE)
    jparams = jplan.init(jax.random.PRNGKey(0), jnp.asarray(_prompt()))
    return jplan, jparams, params_from_jax(jparams)


@pytest.fixture(scope="module")
def jax_greedy_tokens(lm):
    jplan, jparams, _ = lm
    return {kv: np.asarray(jax_greedy(jplan, jparams, _prompt(), N_NEW,
                                      kv_cache=kv))
            for kv in (True, False)}


@pytest.mark.parametrize("attn", ["full", "flash"])
@pytest.mark.parametrize("kv_cache", [True, False], ids=["kv", "reforward"])
def test_greedy_tokens_equal_jax(lm, jax_greedy_tokens, kv_cache, attn):
    _, _, params = lm
    plan = get_plan(model="transformer_lm", attn=attn, **SIZE)
    got = greedy_generate(plan, params, _prompt(), N_NEW, kv_cache=kv_cache,
                          device="cpu")
    assert got.dtype == torch.int32 and got.shape == (B, P + N_NEW)
    np.testing.assert_array_equal(got.numpy(), jax_greedy_tokens[kv_cache])
    np.testing.assert_array_equal(got.numpy(), jax_greedy_tokens[not kv_cache])


def test_u_split_kv_and_reforward_agree():
    plan = get_plan(model="transformer_lm", mode="u_split", attn="flash",
                    **SIZE)
    params = plan.init(torch.Generator().manual_seed(3), torch.zeros(1))
    a = greedy_generate(plan, params, _prompt(1), N_NEW, device="cpu")
    b = greedy_generate(plan, params, _prompt(1), N_NEW, kv_cache=False,
                        device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a[:, :P].numpy(), _prompt(1))


def test_prefill_caches_match_jax(lm):
    jplan, jparams, params = lm
    plan = get_plan(model="transformer_lm", attn="flash", **SIZE)
    total = P + N_NEW
    x_j, x = jnp.asarray(_prompt()), torch.from_numpy(_prompt())
    for jst, jp, st, p in zip(jplan.stages, jparams, plan.stages, params):
        x_j, c_j = jst.apply(jp, x_j, cache_len=total)
        with torch.no_grad():
            x, c = st.apply(p, x, cache_len=total)
        assert len(c) == len(c_j)
        for blk_j, blk in zip(c_j, c):
            for key in ("k", "v"):
                assert blk[key].shape == blk_j[key].shape
                np.testing.assert_allclose(blk[key].numpy(),
                                           np.asarray(blk_j[key]), atol=2e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=2e-5)


def test_sampling_properties(lm):
    _, _, params = lm
    plan = get_plan(model="transformer_lm", attn="flash", **SIZE)
    greedy = greedy_generate(plan, params, _prompt(), N_NEW, device="cpu")

    def sample(seed, **kw):
        return sample_generate(plan, params, _prompt(), N_NEW,
                               torch.Generator().manual_seed(seed),
                               device="cpu", **kw)

    np.testing.assert_array_equal(sample(0, top_k=1).numpy(), greedy.numpy())
    a = sample(7, temperature=0.8, top_k=40, top_p=0.9)
    np.testing.assert_array_equal(
        a.numpy(), sample(7, temperature=0.8, top_k=40, top_p=0.9).numpy())
    assert a.min() >= 0 and a.max() < V
    np.testing.assert_array_equal(
        sample(7, kv_cache=False, temperature=0.8, top_k=40,
               top_p=0.9).numpy(), a.numpy())
    # top-k keeps only the k best ids of each step's logits
    k = 3
    toks = sample(11, temperature=2.0, top_k=k)
    with torch.no_grad():
        logits = plan.apply(params, toks[:, :-1])
    for pos in range(P - 1, P + N_NEW - 1):
        best = torch.topk(logits[:, pos], k, dim=-1).indices
        assert (best == toks[:, pos + 1, None].long()).any(dim=-1).all()
    # a high temperature with no filter leaves the greedy path
    assert not torch.equal(sample(5, temperature=50.0), greedy)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.0), dict(temperature=-1.0),
    dict(temperature=float("nan")), dict(top_k=-1), dict(top_p=0.0),
    dict(top_p=1.5),
])
def test_sampling_value_errors_match_jax(lm, kw):
    jplan, jparams, params = lm
    with pytest.raises(ValueError):
        jax_sample(jplan, jparams, _prompt(), 2, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError):
        sample_generate(get_plan(model="transformer_lm", **SIZE), params,
                        _prompt(), 2, torch.Generator(), device="cpu", **kw)


def test_n_new_errors_and_zero_match_jax(lm):
    jplan, jparams, params = lm
    plan = get_plan(model="transformer_lm", **SIZE)
    with pytest.raises(ValueError, match="n_new"):
        jax_greedy(jplan, jparams, _prompt(), -1)
    with pytest.raises(ValueError, match="n_new"):
        greedy_generate(plan, params, _prompt(), -1, device="cpu")
    with pytest.raises(ValueError, match="n_new"):
        sample_generate(plan, params, _prompt(), -1, torch.Generator(),
                        device="cpu")
    same = greedy_generate(plan, params, _prompt(), 0, device="cpu")
    np.testing.assert_array_equal(same.numpy(), _prompt())
    with pytest.raises(ValueError, match="exceeds the vocabulary"):
        sample_generate(plan, params, _prompt(), 1, torch.Generator(),
                        top_k=V + 1, device="cpu")


def test_params_must_lie_on_the_device(lm):
    _, _, params = lm
    moved = tuple({k: v.to("meta") for k, v in st.items()} for st in params)
    with pytest.raises(ValueError, match="requested device"):
        greedy_generate(get_plan(model="transformer_lm", **SIZE), moved,
                        _prompt(), 2, device="cpu")


# --------------------------------------------------------------------- #
# split-party decode, at JAX's test size (tests/test_split_inference.py)

R_SIZE = dict(vocab=64, d_model=16, num_heads=1, max_len=64)
R_NEW = 5


@pytest.fixture(scope="module")
def remote():
    """(JAX plan, JAX params, port params, prompt) of the small LM."""
    prompt = np.random.RandomState(3).randint(0, 64, (2, 6)).astype(np.int32)
    jplan = jax_get_plan(model="transformer_lm", **R_SIZE)
    jparams = jplan.init(jax.random.PRNGKey(5), jnp.asarray(prompt))
    return jplan, jparams, params_from_jax(jparams), prompt


def _port_lm_server(params):
    return ServerRuntime(get_plan(model="transformer_lm", **R_SIZE),
                         Config(batch_size=2), params, device="cpu")


def _jax_lm_server(remote):
    jplan, _, _, prompt = remote
    return JaxServer(jplan, JaxConfig(mode="split", batch_size=2),
                     jax.random.PRNGKey(5), prompt)


def _jax_remote(remote, transport, **kw):
    jplan, jparams, _, prompt = remote
    client = [jparams[i] for i in jplan.stages_of("client")]
    return np.asarray(jax_generate_remote(jplan, client, transport, prompt,
                                          R_NEW, **kw))


def _port_remote(remote, transport, **kw):
    _, _, params, prompt = remote
    plan = get_plan(model="transformer_lm", **R_SIZE)
    client = [params[i] for i in plan.stages_of("client")]
    return generate_remote(plan, client, transport, prompt, R_NEW,
                           device="cpu", **kw)


@pytest.mark.parametrize("wire", [
    dict(), dict(through_codec=True), dict(compress="none")],
    ids=["direct", "through_codec", "dense_wire"])
def test_generate_remote_matches_local_decode_and_jax(remote, wire):
    _, _, params, prompt = remote
    got = _port_remote(remote, LocalTransport(_port_lm_server(params),
                                              **wire))
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    local = greedy_generate(get_plan(model="transformer_lm", **R_SIZE),
                            params, prompt, R_NEW, kv_cache=False,
                            device="cpu")
    np.testing.assert_array_equal(got, local.numpy())
    want = _jax_remote(remote, JaxLocal(_jax_lm_server(remote),
                                        through_codec=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :6], prompt)


@pytest.mark.parametrize("pair,wire", [
    ("jax_client_port_server", dict()),
    ("jax_client_port_server", dict(compress="none")),
    ("port_client_jax_server", dict(through_codec=True)),
    ("port_client_jax_server", dict(compress="none")),
])
def test_generate_remote_mixed_pairs(remote, pair, wire):
    """Greedy tokens of a mixed pair equal the pure-JAX pair's: the
    port's server answers numpy to a JAX client, and the port's client
    takes a JAX server's numpy reply."""
    _, _, params, _ = remote
    want = _jax_remote(remote, JaxLocal(_jax_lm_server(remote)))
    if pair == "jax_client_port_server":
        got = _jax_remote(remote, JaxLocal(_port_lm_server(params), **wire))
    else:
        got = _port_remote(remote, LocalTransport(_jax_lm_server(remote),
                                                  **wire))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compress", ["int8", "topk8"])
def test_generate_remote_compressed_matches_jax(remote, compress):
    """The compressed wires' tokens equal JAX's pair's at this seed, and
    both directions of each token's hop went through the codec."""
    _, _, params, _ = remote
    transport = LocalTransport(_port_lm_server(params), compress=compress)
    got = _port_remote(remote, transport)
    jtransport = JaxLocal(_jax_lm_server(remote), compress=compress)
    np.testing.assert_array_equal(got, _jax_remote(remote, jtransport))
    assert got.min() >= 0 and got.max() < R_SIZE["vocab"]
    for field in ("round_trips", "bytes_sent", "bytes_received"):
        assert getattr(transport.stats, field) == getattr(
            jtransport.stats, field), field
    assert transport.stats.round_trips == R_NEW


def test_generate_remote_sampling(remote):
    """The same generator seed gives the same tokens, the local
    re-forward sampler's, in the vocabulary; top_k=1 is greedy."""
    _, _, params, prompt = remote
    transport = LocalTransport(_port_lm_server(params))
    kw = dict(temperature=0.8, top_k=5, top_p=0.9)
    a = _port_remote(remote, transport, rng=torch.Generator().manual_seed(11),
                     **kw)
    b = _port_remote(remote, transport, rng=torch.Generator().manual_seed(11),
                     **kw)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < R_SIZE["vocab"]
    local = sample_generate(get_plan(model="transformer_lm", **R_SIZE),
                            params, prompt, R_NEW,
                            torch.Generator().manual_seed(11), kv_cache=False,
                            device="cpu", **kw)
    np.testing.assert_array_equal(a, local.numpy())
    np.testing.assert_array_equal(
        _port_remote(remote, transport, rng=torch.Generator().manual_seed(2),
                     top_k=1),
        _port_remote(remote, transport))


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8), dict(top_k=5), dict(top_p=0.9),
    dict(rng=True, temperature=0.0), dict(rng=True, top_k=-1),
    dict(rng=True, top_p=1.5), dict(n_new=-1),
])
def test_generate_remote_value_errors_match_jax(remote, kw):
    """JAX's refusals, including sampling knobs without an rng (never a
    silent greedy decode)."""
    jplan, jparams, params, prompt = remote
    kw = dict(kw)
    n_new = kw.pop("n_new", 2)
    use_rng = kw.pop("rng", False)
    plan = get_plan(model="transformer_lm", **R_SIZE)
    with pytest.raises(ValueError):
        jax_generate_remote(
            jplan, [jparams[0]], JaxLocal(_jax_lm_server(remote)), prompt,
            n_new, rng=jax.random.PRNGKey(0) if use_rng else None, **kw)
    with pytest.raises(ValueError):
        generate_remote(plan, [params[0]],
                        LocalTransport(_port_lm_server(params)), prompt,
                        n_new, rng=torch.Generator() if use_rng else None,
                        device="cpu", **kw)


def test_generate_remote_zero_tokens_and_ownership(remote):
    _, _, params, prompt = remote
    plan = get_plan(model="transformer_lm", **R_SIZE)
    transport = LocalTransport(_port_lm_server(params))
    same = generate_remote(plan, [params[0]], transport, prompt, 0,
                           device="cpu")
    np.testing.assert_array_equal(same, prompt)
    with pytest.raises(ValueError, match="client-owned"):
        generate_remote(plan, list(params), transport, prompt, 1,
                        device="cpu")


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_evaluate_lm_matches_jax(lm, attn):
    """Token ids reach the embedding as integers (the port once cast
    every input to float32, which the embedding refuses)."""
    _, jparams, params = lm
    ds = jds.synthetic_lm(n_train=8, n_test=20, vocab=V, seq_len=16, seed=1)
    want = jax_evaluate(jax_get_plan(model="transformer_lm", **SIZE),
                        jparams, ds.test, batch_size=8)
    got = evaluate(get_plan(model="transformer_lm", attn=attn, **SIZE),
                   params, ds.test, batch_size=8)
    assert got["predictions"] == want["predictions"] == 20 * 16
    assert got["examples"] == want["examples"] == 20
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-9


def test_evaluate_token_classifier_matches_jax():
    jplan = jax_get_plan(model="transformer", **SIZE)
    ds = jds.synthetic_tokens(n_train=8, n_test=12, vocab=V, seq_len=16)
    jparams = jplan.init(jax.random.PRNGKey(1), jnp.asarray(ds.test.x[:2]))
    want = jax_evaluate(jplan, jparams, ds.test, batch_size=5)
    got = evaluate(get_plan(model="transformer", **SIZE),
                   params_from_jax(jparams), ds.test, batch_size=5)
    assert got["predictions"] == want["predictions"] == 12
    assert abs(got["loss"] - want["loss"]) <= 1e-5


@pytest.mark.parametrize("mode,n_client", [("split", 1), ("u_split", 2)])
def test_split_client_stages_matches_jax(mode, n_client):
    jplan = jax_get_plan(model="transformer_lm", mode=mode, **SIZE)
    plan = get_plan(model="transformer_lm", mode=mode, **SIZE)
    fake = [{"w": torch.zeros(1)} for _ in range(n_client)]
    j = jax_split_client_stages(jplan, [{"w": np.zeros(1)}] * n_client)
    t = split_client_stages(plan, fake)
    assert [s.name for s in t[0]] == [s.name for s in j[0]]
    assert [s.name for s in t[2]] == [s.name for s in j[2]]
    assert len(t[1]) == len(j[1]) and len(t[3]) == len(j[3])
    with pytest.raises(ValueError):
        split_client_stages(plan, fake + fake)


def _assert_split_equal(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize("name", ["tokens", "lm"])
def test_token_datasets_byte_equal_to_jax(name, tmp_path):
    fn = {"tokens": "synthetic_tokens", "lm": "synthetic_lm"}[name]
    j = getattr(jds, fn)(n_train=16, n_test=8, seq_len=12, seed=3)
    t = getattr(tds, fn)(n_train=16, n_test=8, seq_len=12, seed=3)
    _assert_split_equal(t.train, j.train)
    _assert_split_equal(t.test, j.test)
    assert t.num_classes == j.num_classes and t.synthetic
    # load_dataset: same keys, same blobs, either package reads the other's
    jl = jds.load_dataset(name, str(tmp_path), seq_len=24)
    tl = tds.load_dataset(name, str(tmp_path), seq_len=24)
    _assert_split_equal(tl.test, jl.test)
    assert tl.test.x.shape[1] == 24
    assert sorted(p.name for p in (tmp_path / "cache" / "datasets")
                  .iterdir()) == [f"{name}-synthetic-t24.npz"]
    with pytest.raises(ValueError, match="seq_len"):
        tds.load_dataset("mnist", str(tmp_path), seq_len=8)


@pytest.mark.parametrize("model", ["transformer", "transformer_lm"])
def test_transformer_training_is_rejected(model, tmp_path, capsys):
    """The transformer families train now; without their token dataset
    the CLI refuses them as JAX's does (rc 2, before any data loads)."""
    check_supported(Config(transport="fused", model=model, attn="flash"))
    from split_learning_tpu_torch.launch.run import main
    rc = main(["train", "--device", "cpu", "--model", model, "--steps", "1",
               "--data-dir", str(tmp_path)])
    assert rc == 2
    want = {"transformer": "needs --dataset tokens (got 'mnist')",
            "transformer_lm": "needs per-token targets: --dataset lm "
                              "(got 'mnist')"}[model]
    assert want in capsys.readouterr().err
    assert not any(tmp_path.iterdir())  # refused before loading data
