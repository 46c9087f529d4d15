"""The port's tensor parallelism (the ``model`` mesh axis) against JAX's,
on the CPU.

JAX's whole feature is the placement rule ``tp_leaf_sharding``, from
which GSPMD partitions the programs; the port keeps the rule on JAX's
axes (``parallel/mesh.py``) and partitions the compute itself
(``parallel/tensor.py``, ``runtime/state.py`` ``ShardedState``). The
cases follow ``tests/test_tensor_parallel.py`` on the same mesh shapes,
from JAX's init (``interop.params_from_jax``) on the same numpy-seeded
batches, at JAX's bar (rtol 1e-4, atol 1e-5):

- the mesh has a ``model`` axis; ``model 2`` and ``model 4`` (the 9216x10
  fc row parallel) and ``data 2 x model 2`` train as JAX's meshed
  trainer does;
- the placement of every leaf of the CNN, ResNet-18, the transformer
  and the ViT at ``model`` 2 and 4 is JAX's, through the axis map;
- per-rank parameter bytes at ``model 2``: <= 0.6 of the whole for the
  CNN and ResNet-18 (JAX's per-device count, to the byte), <= 0.75 for
  the transformer, which trains as JAX's single-device one does;
- ``model`` across hosts is refused with JAX's "ICI" message;
- the optimizer mirrors shard with their weights, clipping counts each
  leaf once, a checkpoint restores onto any mesh, the bf16 AdamW LM
  (the chip's configuration, narrow) trains within two bf16 ulps of the
  unsharded step, and the cross-rank moves' backwards are their
  transposes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from split_learning_tpu.models import get_plan as jax_get_plan
from split_learning_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh, tp_leaf_sharding as jax_tp_leaf_sharding)
from split_learning_tpu.runtime.fused import (
    FusedSplitTrainer as JaxFusedSplitTrainer)
from split_learning_tpu.utils import Config as JaxConfig
from split_learning_tpu_torch import interop
from split_learning_tpu_torch.interop import params_from_jax
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.models.transformer import TP_HEAVY_PARAMS
from split_learning_tpu_torch.parallel import tensor as tp
from split_learning_tpu_torch.parallel.mesh import (
    MODEL_AXIS, make_mesh, tp_leaf_sharding, tp_param_sharding)
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.runtime.state import (
    ShardedState, make_tx, state_tree)
from split_learning_tpu_torch.utils.config import Config

SEED, BATCH = 5, 32
TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_tensor_parallel.py's bar


def _batches(n):
    rs = np.random.RandomState(7)
    return [(rs.randn(BATCH, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, (BATCH,)).astype(np.int64))
            for _ in range(n)]


def _jax_run(data, num_clients=1, model_parallel=1, **plan_kw):
    """JAX's trainer on its mesh of that shape (none at 1 x 1): its
    losses and its init."""
    jplan = jax_get_plan(mode="split", **plan_kw)
    kw = dict(mode="split", batch_size=BATCH, num_clients=num_clients,
              model_parallel=model_parallel,
              **({"model": plan_kw["model"]} if plan_kw else {}))
    mesh = None
    if num_clients * model_parallel > 1:
        mesh = jax_make_mesh(num_clients=num_clients, num_stages=1,
                             model_parallel=model_parallel,
                             devices=jax.devices()[:num_clients
                                                   * model_parallel])
    tr = JaxFusedSplitTrainer(jplan, JaxConfig(**kw),
                              jax.random.PRNGKey(SEED), data[0][0],
                              mesh=mesh)
    init = params_from_jax(jax.device_get(tr.params))
    return [tr.train_step(x, y) for x, y in data], init


def _port(init, num_clients=1, model_parallel=1, plan=None, **cfg_kw):
    mesh = (make_mesh(num_clients=num_clients, model_parallel=model_parallel,
                      device="cpu")
            if num_clients * model_parallel > 1 else None)
    cfg = Config(mode="split", transport="fused", batch_size=BATCH,
                 num_clients=num_clients, model_parallel=model_parallel,
                 **cfg_kw)
    return FusedSplitTrainer(plan or get_plan(mode="split"), cfg, init,
                             np.zeros((BATCH, 28, 28, 1), np.float32),
                             device="cpu", mesh=mesh)


def test_tp_mesh_has_model_axis():
    mesh = make_mesh(model_parallel=2, device="cpu")
    assert MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] == 2
    # the default shape is unchanged for existing callers
    assert MODEL_AXIS not in make_mesh(num_clients=2, num_stages=2,
                                       device="cpu").axis_names


@pytest.mark.parametrize("data_axis,model_axis", [(1, 2), (1, 4), (2, 2)],
                         ids=["model2", "model4_row_parallel",
                              "data2_x_model2"])
def test_tp_trains_as_jax_on_the_same_mesh(data_axis, model_axis):
    """JAX's ``test_tp_matches_single_device``,
    ``test_tp4_contraction_sharding_matches_single_device`` and
    ``test_tp_composes_with_dp``: the port's meshed trainer against
    JAX's on the same mesh shape, and against its own unsharded one."""
    data = _batches(4)
    ref, init = _jax_run(data, data_axis, model_axis)
    trainer = _port(init, data_axis, model_axis)
    got = [trainer.train_step(x, y) for x, y in data]
    np.testing.assert_allclose(got, ref, **TOL)
    single = _port(init)
    np.testing.assert_allclose(
        got, [single.train_step(x, y) for x, y in data], **TOL)
    if model_axis == 4:   # 10 % 4 != 0: the fc goes row parallel
        assert trainer.state.dims[1]["fc.weight"] == 1


def _jax_params(model, shape, **kw):
    plan = jax_get_plan(model=model, mode="split", **kw)
    return jax.eval_shape(plan.init, jax.random.PRNGKey(0),
                          jnp.zeros(shape, jnp.float32
                                    if len(shape) == 4 else jnp.int32))


def _port_name(path):
    """interop's name for a flax leaf path (``stage_from_jax``)."""
    *mod, leaf = path
    if leaf == "kernel":
        return ".".join(mod + ["weight"])
    if leaf in ("scale", "embedding"):
        return ".".join(mod + ["weight"])
    if leaf == "bias":
        return ".".join(mod + ["bias"])
    return ".".join(path)


_FAMILIES = {
    "split_cnn": ((8, 28, 28, 1), {}),
    "resnet18": ((8, 32, 32, 3), {}),
    "transformer": ((8, 32), {}),
    "vit": ((8, 28, 28, 1), {}),
}


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("model", sorted(_FAMILIES))
def test_placement_is_jaxs_leaf_by_leaf(model, mp):
    """JAX's ``test_tp_actually_shards_weight_leaves``, on every family:
    for each leaf, the port's split dim (``tp_leaf_sharding`` on its
    torch leaf and name) is the torch dim that holds the dim JAX's rule
    splits, through interop's transposes; the heavy layers shard."""
    shape, kw = _FAMILIES[model]
    jmesh = jax_make_mesh(num_clients=1, num_stages=1, model_parallel=mp,
                          devices=jax.devices()[:mp])
    mesh = make_mesh(model_parallel=mp, device="cpu")
    stages = _jax_params(model, shape, **kw)
    port = get_plan(model=model, mode="split")
    seen = 0
    for i, tree in enumerate(stages):
        torch_shapes = dict(port.stages[i].module.named_parameters())
        for path, leaf in traverse_util.flatten_dict(tree["params"]).items():
            name = _port_name(list(path))
            spec = tuple(jax_tp_leaf_sharding(jmesh, leaf).spec)
            want = None
            if MODEL_AXIS in spec:
                want = interop.torch_dim(name, leaf.ndim,
                                         spec.index(MODEL_AXIS))
            got = tp_leaf_sharding(mesh, torch_shapes[name], name).dim
            assert got == want, (model, mp, name, spec)
            if path[-2:-1] and path[-2] in TP_HEAVY_PARAMS \
                    and path[-1] == "kernel" \
                    and any(d % mp == 0 for d in leaf.shape[-2:]):
                assert got is not None, name
            seen += 1
    assert seen == sum(len(dict(s.module.named_parameters()))
                       for s in port.stages)


def _whole_bytes(params):
    return sum(v.numel() * v.element_size() for st in params
               for v in st.values())


@pytest.mark.parametrize("model,shape", [("split_cnn", (8, 28, 28, 1)),
                                         ("resnet18", (8, 32, 32, 3))])
def test_tp_halves_per_rank_param_bytes(model, shape):
    """JAX's ``test_tp_halves_per_device_param_bytes``: at ``model 2`` a
    rank holds at most 0.6 of the parameter bytes, counted by rank, and
    exactly what JAX's first device holds."""
    # the bytes depend on the shapes only: zeros of JAX's init shapes
    jparams = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), _jax_params(model, shape))
    jmesh = jax_make_mesh(num_clients=1, num_stages=1, model_parallel=2,
                          devices=jax.devices()[:2])
    placed = jax.device_put(jparams, jax.tree_util.tree_map(
        lambda leaf: jax_tp_leaf_sharding(jmesh, leaf), jparams))
    jax_bytes = sum(leaf.addressable_shards[0].data.nbytes
                    for leaf in jax.tree_util.tree_leaves(placed))
    params = get_plan(model=model, mode="split").init(
        torch.Generator().manual_seed(0), torch.zeros(1))
    state = ShardedState(params, make_tx(Config()),
                         make_mesh(model_parallel=2, device="cpu"))
    per_rank = state.rank_bytes()[0]
    assert per_rank[0] == per_rank[1] == jax_bytes
    assert per_rank[0] <= 0.6 * _whole_bytes(params)


def test_tp_rejected_across_hosts(monkeypatch):
    """JAX's ``test_tp_rejected_across_hosts``: a ``model`` axis over
    several processes raises JAX's ``ValueError``, before any exchange."""
    from split_learning_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="ICI"):
        distributed.global_mesh(num_clients=2, num_stages=1,
                                model_parallel=2, device="cpu")


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_tp_transformer_trains_as_jax_and_shards(attn):
    """JAX's ``test_tp_transformer_matches_single_device_and_shards`` at
    its width (d_model 64, 4 heads, batch 32, T 32): ``model 2`` trains
    as JAX's single-device trainer, each rank attends its 2 heads, and a
    rank holds at most 0.75 of the parameter bytes."""
    rs = np.random.RandomState(5)
    xs = rs.randint(0, 256, (4, BATCH, 32)).astype(np.int32)
    ys = rs.randint(0, 10, (4, BATCH)).astype(np.int32)
    jtr = JaxFusedSplitTrainer(
        jax_get_plan(model="transformer", mode="split"),
        JaxConfig(mode="split", model="transformer", batch_size=BATCH),
        jax.random.PRNGKey(SEED), xs[0])
    init = params_from_jax(jax.device_get(jtr.params))
    ref = [jtr.train_step(x, y) for x, y in zip(xs, ys)]
    trainer = FusedSplitTrainer(
        get_plan(model="transformer", mode="split", attn=attn),
        Config(mode="split", model="transformer", transport="fused",
               batch_size=BATCH, model_parallel=2),
        init, xs[0], device="cpu",
        mesh=make_mesh(model_parallel=2, device="cpu"))
    got = [trainer.train_step(x, y) for x, y in zip(xs, ys)]
    np.testing.assert_allclose(got, ref, **TOL)
    assert max(trainer.state.rank_bytes()[0]) <= 0.75 * _whole_bytes(init)


def _lm(dtype, mesh=None, optimizer="adamw", steps=3, heads=2):
    rs = np.random.RandomState(3)
    data = [(rs.randint(0, 32, (8, 16)).astype(np.int32),
             rs.randint(0, 32, (8, 16)).astype(np.int64))
            for _ in range(steps)]
    kw = dict(vocab=32, d_model=16, num_heads=heads, client_depth=1,
              server_depth=2)
    plan = get_plan(model="transformer", mode="split", lm=True,
                    attn="flash", dtype=dtype, **kw)
    cfg = Config(mode="split", model="transformer", transport="fused",
                 batch_size=8, optimizer=optimizer, lr=1e-2,
                 weight_decay=1e-4, dtype=dtype,
                 model_parallel=1 if mesh is None else 2)
    trainer = FusedSplitTrainer(plan, cfg,
                                torch.Generator().manual_seed(0),
                                data[0][0], device="cpu", mesh=mesh)
    return [trainer.train_step(x, y) for x, y in data], trainer


def test_bf16_adamw_lm_within_two_bf16_ulps():
    """The chip's LM configuration (bf16, AdamW, 2 heads, 3 blocks,
    ``model 2``), narrow: each step's loss within two bf16 ulps of the
    unsharded trainer's (``PERF.md`` §2), the heads one a rank."""
    ref, _ = _lm("bfloat16")
    got, trainer = _lm("bfloat16", make_mesh(model_parallel=2,
                                             device="cpu"))
    ulp = 2.0 ** -7
    for a, b in zip(got, ref):
        assert abs(a - b) <= 2 * ulp * abs(b), (got, ref)
    # AdamW's moments shard with their weights
    for st in trainer.state.ranks[0]:
        mu, nu = st.opt_state
        for p, m, v in zip([t for s in st.params for t in s.values()],
                           mu, nu):
            assert m.shape == v.shape == p.shape


def test_heads_that_do_not_divide_gather_then_attend_whole():
    """3 heads over 2 ranks: the projections gather and the attention
    runs whole on the row's first rank; the forward is the unsharded
    one."""
    kw = dict(vocab=32, d_model=24, num_heads=3, client_depth=1,
              server_depth=1)
    plan = get_plan(model="transformer", mode="split", lm=True, **kw)
    params = plan.init(torch.Generator().manual_seed(1), torch.zeros(1))
    x = torch.randint(0, 32, (4, 8))
    want = plan.apply(params, x)
    state = ShardedState(params, make_tx(Config()),
                         make_mesh(model_parallel=2, device="cpu"))
    torch.testing.assert_close(plan.apply(state.params, x), want,
                               rtol=1e-5, atol=1e-6)


def test_clipping_and_momentum_count_each_leaf_once():
    """``grad_clip_norm`` over a sharded state clips by the global norm
    of the whole model (each shard once, each replicated leaf once), and
    the momentum trace shards with its weights: ``model 2`` and ``model
    4`` train as the unsharded trainer."""
    data = _batches(3)
    _, init = _jax_run(data[:1])
    kw = dict(grad_clip_norm=0.05, momentum=0.9)
    a = _port(init, **kw)
    ref = [a.train_step(x, y) for x, y in data]
    for mp in (2, 4):
        b = _port(init, model_parallel=mp, **kw)
        np.testing.assert_allclose([b.train_step(x, y) for x, y in data],
                                   ref, **TOL)
        for st in b.state.ranks[0]:
            for p, t in zip([t for s in st.params for t in s.values()],
                            st.opt_state):
                assert t.shape == p.shape


def test_checkpoint_restores_onto_any_mesh():
    """A ``model 2`` trainer's checkpoint tree holds whole leaves (the
    unsharded trainer's shapes); restored onto ``model 4``, ``data 2 x
    model 2`` and no mesh, each continues as the uninterrupted run."""
    data = _batches(4)
    _, init = _jax_run(data[:1])
    kw = dict(momentum=0.9)
    whole = _port(init, **kw)
    ref = [whole.train_step(x, y) for x, y in data]
    a = _port(init, model_parallel=2, **kw)
    for x, y in data[:2]:
        a.train_step(x, y)
    tree = a.export_states()
    flat = state_tree(_port(init, **kw).state)
    for st, want in zip(tree["trainer"]["params"], flat["params"]):
        assert {k: tuple(v.shape) for k, v in st.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    for shape in [(1, 4), (2, 2), (1, 1)]:
        b = _port(init, *shape, **kw)
        b.restore_states(tree)
        got = [b.train_step(x, y) for x, y in data[2:]]
        np.testing.assert_allclose(got, ref[2:], **TOL)


def test_placement_tables():
    """``tp_param_sharding`` over per-stage dicts, and the rule's three
    outcomes on the port's leaves: a dense weight ``[out, in]`` splits
    dim 0 (JAX's last), a class count that does not divide falls to the
    contraction (torch dim 1), biases and tables replicate or split as
    flax's axes say."""
    mesh = make_mesh(model_parallel=4, device="cpu")
    table = tp_param_sharding(mesh, get_plan().init(
        torch.Generator().manual_seed(0), torch.zeros(1)))
    assert {k: s.dim for k, s in table[1].items()} == {
        "conv2.weight": 0, "conv2.bias": None, "fc.weight": 1,
        "fc.bias": None}
    assert tp_leaf_sharding(mesh, torch.zeros(8, 64)).spec == (MODEL_AXIS,)
    assert tp_leaf_sharding(mesh, torch.zeros(6, 64)).dim == 1
    assert tp_leaf_sharding(mesh, torch.zeros(6, 6)).dim is None
    assert tp_leaf_sharding(mesh, torch.zeros(8)).spec == ()
    # an embedding table keeps flax's axes: its features (last) split
    assert tp_leaf_sharding(mesh, torch.zeros(6, 8), "tok.weight").dim == 1
    assert tp_leaf_sharding(mesh, torch.zeros(8, 6), "tok.weight").dim == 0


def test_cross_rank_moves_backward_is_the_transpose():
    """gather's backward slices, scatter's gathers, broadcast's sums and
    reduce_sum's broadcasts: against autograd of the plain ops."""
    devs = [torch.device("cpu")] * 2
    x = torch.randn(4, 6, requires_grad=True)
    g = torch.randn(4, 6)
    parts = tp.scatter(x, 1, devs)
    out = tp.gather([p * 2 for p in parts], 1, devs[0])
    (gx,) = torch.autograd.grad(out, [x], g)
    torch.testing.assert_close(gx, 2 * g)
    copies = tp.broadcast(x, devs)
    total = tp.reduce_sum([c * (i + 1) for i, c in enumerate(copies)],
                          devs[0])
    (gx,) = torch.autograd.grad(total, [x], g)
    torch.testing.assert_close(gx, 3 * g)


def test_a_sharded_parameter_refuses_what_no_rank_can_run():
    """An op the layout has no per-rank form for raises rather than
    computing on the meta stand-in."""
    p = tp.ShardedParam([[torch.ones(2, 3), torch.ones(2, 3)]], 0)
    assert tuple(p.shape) == (4, 3)
    with pytest.raises(NotImplementedError, match="sharded parameter"):
        torch.matmul(torch.ones(3, 4), p)
    with pytest.raises(NotImplementedError, match="sharded parameter"):
        p.T


def test_model_with_seq_axis_waits_for_its_item(tmp_path, capsys):
    """A mesh with both a ``model`` and a ``seq`` axis, and a
    sequence-parallel ``attn`` on a ``model`` axis, raise naming ROADMAP
    item 18.2 (the trainer, the plan and the CLI, exit 2)."""
    from split_learning_tpu_torch.launch.run import main
    mesh = make_mesh(model_parallel=2, seq_parallel=2, device="cpu")
    with pytest.raises(NotImplementedError, match="18.2"):
        FusedSplitTrainer(get_plan(), Config(transport="fused"),
                          torch.Generator().manual_seed(0), None,
                          device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="18.2"):
        get_plan(model="transformer", attn="ring",
                 mesh=make_mesh(model_parallel=2, device="cpu"))
    assert main(["train", "--device", "cpu", "--model", "transformer_lm",
                 "--dataset", "lm", "--seq-len", "16", "--d-model", "16",
                 "--model-parallel", "2", "--seq-parallel", "2",
                 "--steps", "1", "--data-dir", str(tmp_path)]) == 2
    assert "18.2" in capsys.readouterr().err


def test_cuda_ranks_lay_virtual_ranks_over_the_cards(monkeypatch):
    """``SLT_CUDA_RANKS=n`` asks a process for n ranks over its cards
    (how a command line meshes on one card): n virtual ranks on a
    one-card machine; unset, one rank a card, and a larger mesh raises."""
    from split_learning_tpu_torch.parallel import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("SLT_CUDA_RANKS", raising=False)
    card = torch.device("cuda", 0)
    assert mesh_mod.local_devices("cuda") == [card]
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        make_mesh(model_parallel=2, device="cuda")
    monkeypatch.setenv("SLT_CUDA_RANKS", "4")
    assert mesh_mod.local_devices("cuda") == [card] * 4
    mesh = make_mesh(num_clients=2, model_parallel=2, device="cuda")
    assert mesh.shape == {"data": 2, "pipe": 1, "model": 2}
    assert {str(d) for d in mesh.devices.flat} == {"cuda:0"}
