"""The ``seq`` axis with the ``model`` axis, and ``attn="auto"``, on the
CPU: the ViT, the bf16 LM, hooks, checkpoints, FLOPs and the crossover
rule (the LM against JAX is tests/test_torch_port_seq_model.py, whose
helpers this file imports).

- the ViT with ``ring`` at ``model 2 x seq 2`` within 1e-4 of JAX's
  ``seq 2`` trainer (JAX's own ``model 2 x seq 2`` ViT forward is off
  its unsharded one, see the test), and patch rows shared by two ranks;
- the bf16 AdamW LM at ``model 2 x seq 2`` within two bf16 ulps of JAX's
  and, from one state, of the unsharded trainer's;
- forward hooks: every Dense and LayerNorm, and the cut tensor, see
  T/n tokens a rank, on ``seq``-only meshes too; no attention call
  scatters or gathers the whole T;
- a checkpoint restored onto a ``model x seq`` mesh continues as the
  uninterrupted run; ``step_flops`` equals the unsharded count;
- ``attn="auto"`` on a seq mesh and through the CLI; the striped
  exchange; ``select_attention`` picks as JAX's does on the CPU;
- the split CNN on a ``seq`` mesh: the axis unused, with a warning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.ops.flash_attention import (
    select_attention as jax_select_attention)
from split_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.models.transformer import Dense, LayerNorm
from split_learning_tpu_torch.ops import flash_attention as fa
from split_learning_tpu_torch.ops import ring_attention as ra
from split_learning_tpu_torch.parallel import tensor as tp
from split_learning_tpu_torch.parallel.mesh import make_mesh
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config
from test_torch_port_seq_model import (
    BATCH, LM, STEPS, T, VIT, _cfg_kw, _img_data, _lm_data, _pair)


def test_vit_ring_on_model_and_seq_matches_jax():
    """The ViT with ``ring`` at ``model 2 x seq 2`` against JAX's
    trainer with the image rows on ``seq`` (``seq 2``). JAX's own
    ``model 2 x seq 2`` trainer is not the reference: with the image's
    rows on ``seq`` and the patch kernel's features on ``model``, its
    GSPMD-partitioned forward is 0.71 off its unsharded logits at this
    init (dense attention too; the first loss 0.13 off), while its
    ``seq``-only and ``model``-only layouts agree with the unsharded
    trainer to 2e-7."""
    data = _img_data()
    jtr, _ = _pair("vit", dict(VIT, attn="ring"), data, (1, 1, 2))
    _, tr = _pair("vit", dict(VIT, attn="ring"), data[:1], (1, 2, 2))
    want = [jtr.train_step(x, y) for x, y in data]
    got = [tr.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_vit_patch_rows_shared_between_ranks():
    """12 patch tokens of a 3 x 4 patch grid over 2 seq ranks: rank 0
    takes patch rows 0-1 and keeps 6 tokens, rank 1 rows 1-2; the
    T-partitioned forward is the whole one."""
    plan = get_plan(model="vit", attn="ring", **VIT)
    params = plan.init(torch.Generator().manual_seed(0), torch.zeros(1))
    x = torch.from_numpy(np.random.RandomState(2).randn(
        4, 12, 16, 1).astype(np.float32))
    devs = [[torch.device("cpu")]] * 2
    with torch.no_grad():
        want = plan.apply(params, x)
        got = plan.apply(tp.seq_view(params, devs),
                         tp.SeqInput(x, [torch.device("cpu")] * 2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


_BF16 = dict(LM, server_depth=2, attn="ring_flash")
_BF16_CFG = dict(batch_size=BATCH, dtype="bfloat16", optimizer="adamw",
                 lr=1e-2, weight_decay=1e-4)


def _bf16_lm(init, mesh=None):
    plan = get_plan(model="transformer_lm", dtype="bfloat16", mesh=mesh,
                    **_BF16)
    cfg = Config(transport="fused", model_parallel=1 if mesh is None else 2,
                 seq_parallel=1 if mesh is None else 2, **_BF16_CFG)
    return FusedSplitTrainer(plan, cfg, init, None, device="cpu",
                             mesh=mesh)


def test_bf16_adamw_lm_within_two_bf16_ulps():
    """The chip's LM configuration (bf16, AdamW, 2 heads, 3 blocks,
    ring_flash) at ``model 2 x seq 2``, narrow: 12 steps within two bf16
    ulps of JAX's meshed trainer's (whose bf16 loss is itself rounded to
    bf16), and each step from the sharded trainer's state within two
    bf16 ulps of the unsharded trainer's."""
    data = _lm_data(STEPS, seed=3)
    jmesh = jax_make_mesh(num_clients=1, model_parallel=2, seq_parallel=2,
                          devices=jax.devices()[:4])
    jtr = JaxFusedSplitTrainer(
        jax_get_plan(model="transformer_lm", dtype="bfloat16", mesh=jmesh,
                     **_BF16),
        JaxConfig(model_parallel=2, seq_parallel=2, **_BF16_CFG),
        jax.random.PRNGKey(0), jnp.asarray(data[0][0]), mesh=jmesh)
    init = params_from_jax(jax.device_get(jtr.params))
    tr = _bf16_lm(init, make_mesh(model_parallel=2, seq_parallel=2,
                                  device="cpu"))
    ref = _bf16_lm(init)
    ulp = 2.0 ** -7
    for x, y in data:
        want = jtr.train_step(x, y)
        ref.restore_states(tr.export_states())
        a, b = tr.train_step(x, y), ref.train_step(x, y)
        assert abs(a - want) <= 2 * ulp * abs(want), (a, want)
        assert abs(a - b) <= 2 * ulp * abs(b), (a, b)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (2, 1, 2),
                                   (1, 1, 4)])
@pytest.mark.parametrize("attn", ["ring_flash", "ulysses"])
def test_every_dense_and_layernorm_sees_its_ranks_tokens(attn, shape,
                                                         monkeypatch):
    """One training step: each Dense and LayerNorm call, and the cut
    tensor's blocks, hold T/n tokens; every module runs once a seq rank
    (q, k and v once a model rank too, where the ranks split the heads);
    no attention call scatters or gathers the whole T (``_sharded``)."""
    d, m, s = shape
    if attn == "ulysses" and s == 4:
        attn = "ring"   # 2 heads do not divide over 4 ranks
    mesh = make_mesh(num_clients=d, model_parallel=m, seq_parallel=s,
                     device="cpu")
    plan = get_plan(model="transformer_lm", mesh=mesh, attn=attn, **LM)
    tr = FusedSplitTrainer(plan, Config(transport="fused", **_cfg_kw(
        shape)), torch.Generator().manual_seed(0), None, mesh=mesh)

    def whole_t(*args, **kw):
        raise AssertionError("an attention call scattered the whole T")

    monkeypatch.setattr(ra, "_sharded", whole_t)
    seen, cuts = {}, []
    handles = []
    for st in plan.stages:
        for name, mod in st.module.named_modules():
            if isinstance(mod, (Dense, LayerNorm)):
                handles.append(mod.register_forward_hook(
                    lambda mod, args, out, name=f"{st.name}.{name}":
                    seen.setdefault(name, []).append(tuple(
                        args[0].shape))))
    handles.append(plan.stages[0].module.register_forward_hook(
        lambda mod, args, out: cuts.append(out)))
    x, y = _lm_data(1, batch=BATCH * d)[0]
    tr.train_step(x, y)
    for h in handles:
        h.remove()
    n_dense = sum(isinstance(mod, (Dense, LayerNorm)) for st in plan.stages
                  for mod in st.module.modules())
    assert len(seen) == n_dense
    for name, shapes in seen.items():
        assert all(sh[:2] == (BATCH, T // s) for sh in shapes), (name,
                                                                 shapes)
        split_qkv = m > 1 and name.split(".")[-1] in ("q", "k", "v") \
            and not (attn == "ulysses" and (LM["num_heads"] // m) % s)
        assert len(shapes) == d * s * (m if split_qkv else 1), (name,
                                                                shapes)
    assert len(cuts) == d
    for cut in cuts:
        assert isinstance(cut, tp.SeqBlocks) and cut.n == s
        assert [tuple(b.shape) for b in cut.blocks] == \
            [(BATCH, T // s, LM["d_model"])] * s


def test_checkpoint_restores_onto_a_model_and_seq_mesh():
    """An unsharded AdamW trainer's checkpoint restored onto ``model 2 x
    seq 2`` continues as the sharded run that started there does, and
    a sharded run saved and restored is the uninterrupted one, bit for
    bit."""
    data = _lm_data(6, seed=4)
    size = dict(LM, attn="ring")
    kw = dict(optimizer="adamw", lr=1e-2, weight_decay=0.1)
    mesh = make_mesh(model_parallel=2, seq_parallel=2, device="cpu")
    init = get_plan(model="transformer_lm", **size).init(
        torch.Generator().manual_seed(3), torch.zeros(1))

    def fresh(on_mesh=True):
        return FusedSplitTrainer(
            get_plan(model="transformer_lm", mesh=mesh if on_mesh else None,
                     **size),
            Config(transport="fused", **_cfg_kw((1, 2, 2), **kw)), init,
            None, device="cpu", mesh=mesh if on_mesh else None)

    a = fresh()
    whole = [a.train_step(x, y) for x, y in data]
    b = fresh()
    half = [b.train_step(x, y) for x, y in data[:3]]
    c = fresh()
    c.restore_states(b.export_states())
    assert half + [c.train_step(x, y) for x, y in data[3:]] == whole
    plain = fresh(on_mesh=False)
    [plain.train_step(x, y) for x, y in data[:3]]
    e = fresh()
    e.restore_states(plain.export_states())
    np.testing.assert_allclose([e.train_step(x, y) for x, y in data[3:]],
                               whole[3:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_step_flops_equal_the_unsharded_count(attn):
    x, y = _lm_data(1)[0]
    counts = []
    for shape in [(1, 1, 1), (1, 2, 2), (1, 1, 2)]:
        mesh = (None if shape == (1, 1, 1) else
                make_mesh(model_parallel=shape[1], seq_parallel=shape[2],
                          device="cpu"))
        tr = FusedSplitTrainer(
            get_plan(model="transformer_lm", mesh=mesh, attn=attn, **LM),
            Config(transport="fused", **_cfg_kw(shape)),
            torch.Generator().manual_seed(0), None, device="cpu",
            mesh=mesh)
        counts.append(tr.step_flops(x, y))
    assert counts[0] > 0 and counts == [counts[0]] * 3


def test_auto_on_a_seq_mesh_is_dense_on_the_cpu():
    """``attn="auto"`` on ``model 2 x seq 2``: on CPU ranks the speed
    rule is off and the memory rule keeps dense, so the step is the
    ``full`` plan's step, whose blocks gather K and V and attend their
    own queries; the same with ``"flash"`` gathers q, k and v for one
    plain flash call and scatters the output back."""
    data = _lm_data(3)
    mesh = make_mesh(model_parallel=2, seq_parallel=2, device="cpu")
    init = get_plan(model="transformer_lm", **LM).init(
        torch.Generator().manual_seed(0), torch.zeros(1))
    losses = {}
    for attn in ("auto", "full", "flash"):
        tr = FusedSplitTrainer(
            get_plan(model="transformer_lm", mesh=mesh, attn=attn, **LM),
            Config(transport="fused", **_cfg_kw((1, 2, 2))), init, None,
            mesh=mesh)
        losses[attn] = [tr.train_step(x, y) for x, y in data]
    assert losses["auto"] == losses["full"]
    np.testing.assert_allclose(losses["flash"], losses["full"], rtol=0,
                               atol=1e-5)


def test_cli_auto_with_model_and_seq(tmp_path, capsys):
    """``train --attn auto --model-parallel 2 --seq-parallel 2`` trains
    (no refusal), to ``--attn full``'s losses on CPU ranks."""
    from split_learning_tpu_torch.launch.run import main
    argv = ["train", "--device", "cpu", "--model", "transformer_lm",
            "--dataset", "lm", "--seq-len", "16", "--d-model", "16",
            "--num-heads", "2", "--batch-size", "4", "--steps", "2",
            "--tracking", "stdout", "--model-parallel", "2",
            "--seq-parallel", "2", "--data-dir", str(tmp_path)]
    finals = []
    for attn in ("auto", "full"):
        assert main(argv + ["--attn", attn]) == 0
        out, err = capsys.readouterr()
        assert "[error]" not in err
        finals.append([ln.split("final_loss=")[1].split()[0]
                       for ln in out.splitlines() if "final_loss=" in ln])
    assert finals[0] and finals[0] == finals[1]


@pytest.mark.parametrize("mesh_flags", [
    ["--model-parallel", "2"], ["--seq-parallel", "2"],
    ["--model-parallel", "2", "--seq-parallel", "2"]])
def test_cli_eval_on_meshes_is_the_unsharded_eval(mesh_flags, tmp_path,
                                                  capsys):
    """``train --eval`` on a meshed fused trainer evaluates its trained
    parameters (a ``model`` axis's are ``ShardedParam``s, which once sent
    the inputs to ``meta``) to the unsharded run's line."""
    from split_learning_tpu_torch.launch.run import main
    argv = ["train", "--device", "cpu", "--model", "transformer_lm",
            "--dataset", "lm", "--seq-len", "16", "--d-model", "16",
            "--num-heads", "2", "--attn", "ring_flash", "--batch-size", "8",
            "--steps", "2", "--eval", "--tracking", "noop", "--data-dir",
            str(tmp_path)]
    lines = []
    for extra in ([], mesh_flags):
        assert main(argv + extra) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("[eval]")])
    assert len(lines[0]) == 1 and lines[1] == lines[0]


def test_restripe_round_trip_and_backward():
    """The striped exchange is JAX's ``stripe_permutation`` over the
    blocks; back again gives the blocks; its backward is the inverse
    exchange."""
    n, t = 4, 16
    x = torch.randn(2, t, 3, requires_grad=True)
    blocks = tp.SeqBlocks(list(x.chunk(n, 1)), [torch.device("cpu")] * n)
    striped = tp.restripe(blocks, True)
    perm = ra.stripe_permutation(t, n)
    torch.testing.assert_close(torch.cat(striped.blocks, 1), x[:, perm],
                               rtol=0, atol=0)
    back = tp.restripe(striped, False)
    torch.testing.assert_close(torch.cat(back.blocks, 1), x, rtol=0, atol=0)
    g = torch.randn(2, t, 3)
    (gx,) = torch.autograd.grad(striped.blocks, [x],
                                list(g[:, perm].chunk(n, 1)))
    torch.testing.assert_close(gx, g, rtol=0, atol=0)


_GRID = [(b, t, h) for b in (1, 16, 64) for t in (128, 1024, 4096, 16384)
         for h in (1, 2, 8)]


@pytest.mark.parametrize("env", [None, "256", "4096"])
@pytest.mark.parametrize("hbm", [None, 1 << 30, 80 << 30])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_select_attention_picks_as_jax(itemsize, hbm, env, monkeypatch):
    """The port's ``select_attention`` against JAX's over a grid of
    shapes (symmetric and a 4x longer key extent, a ring rank's), on the
    CPU: the memory rule, the 16 GiB default budget and the
    ``SLT_FLASH_AUTO_T`` override alike (JAX's speed rule is off in
    interpret mode, the port's on CPU tensors)."""
    if env is None:
        monkeypatch.delenv(fa.FLASH_AUTO_T_ENV, raising=False)
    else:
        monkeypatch.setenv(fa.FLASH_AUTO_T_ENV, env)
    for b, t, h in _GRID:
        for t_kv in (None, 4 * t):
            want = jax_select_attention(b, t, h, itemsize, hbm_bytes=hbm,
                                        t_kv=t_kv, interpret=True)
            got = fa.select_attention(b, t, h, itemsize, hbm_bytes=hbm,
                                      t_kv=t_kv,
                                      device=torch.device("cpu"))
            assert got == want, (b, t, h, t_kv)


def test_select_attention_speed_rule_on_the_card(monkeypatch):
    """On a card the measured crossover (``FLASH_SPEED_T``) picks flash
    at and past its T and leaves the rest to the memory rule; on the CPU
    the speed rule is off. ``hbm_bytes`` given, no device is queried."""
    monkeypatch.delenv(fa.FLASH_AUTO_T_ENV, raising=False)
    big = 1 << 50
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for itemsize, cross in fa.FLASH_SPEED_T.items():
        picks = {t: fa.select_attention(1, t, 2, itemsize, hbm_bytes=big,
                                        device=card)
                 for t in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)}
        assert picks == {t: "flash" if t >= cross else "full"
                         for t in picks}, (itemsize, picks)
        assert fa.select_attention(1, 4096, 2, itemsize, hbm_bytes=big,
                                   device=cpu) == "full"


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)])
def test_cnn_on_a_seq_mesh_trains_whole_rows(shape):
    """A plan with no sequence axis (the split CNN) on a mesh with a
    ``seq`` axis: the axis is left unused with a warning, each data row
    runs whole, and the 12-step losses are JAX's: on ``seq 2`` JAX's
    trainer on the same mesh (whose GSPMD partitions the image rows over
    ``seq``); on ``model 2 x seq 2`` JAX's ``model 2`` trainer, as JAX's
    own ``model x seq`` partition of a conv is off its unsharded step
    (the ViT test above)."""
    d, m, s = shape
    data = _img_data(side=28)
    js = s if m == 1 else 1
    jmesh = jax_make_mesh(num_clients=d, model_parallel=m, seq_parallel=js,
                          devices=jax.devices()[:d * m * js])
    jtr = JaxFusedSplitTrainer(
        jax_get_plan(model="split_cnn"), JaxConfig(**_cfg_kw((d, m, js))),
        jax.random.PRNGKey(0), jnp.asarray(data[0][0]), mesh=jmesh)
    mesh = make_mesh(num_clients=d, model_parallel=m, seq_parallel=s,
                     device="cpu")
    with pytest.warns(UserWarning, match="'seq' axis is not used"):
        tr = FusedSplitTrainer(get_plan(model="split_cnn"),
                               Config(transport="fused", **_cfg_kw(shape)),
                               params_from_jax(jax.device_get(jtr.params)),
                               data[0][0], mesh=mesh)
    want = [jtr.train_step(x, y) for x, y in data]
    got = [tr.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
