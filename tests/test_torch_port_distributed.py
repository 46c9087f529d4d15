"""The port's multi-process runtime (``parallel/distributed.py``).

In one process, against JAX's module where it has the same contract:
the single-process no-op of ``init_multi_host`` and its missing process
id, the grid rule that keeps a pipe chain within one process (JAX's
``_grid_rows`` cases), ``global_mesh`` equal to ``make_mesh``, and
``SpecLayout``'s data half. Across processes: two OS processes join a
gloo group through the ``SLT_*`` variables (one CPU rank each, or two
for the pipeline), build the global mesh, check JAX's refusals, and
train the fused trainer (data 2) and the GPipe pipeline (data 2 x pipe
2); their losses and final parameters equal those of one process with
the same mesh of CPU ranks, bit for bit (two rows add in one order
either way). Then the ``train`` CLI with ``--coordinator
--num-processes --process-id``: only the coordinator logs steps, and
both end on the one-process ``--num-clients 2`` run's loss.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from split_learning_tpu.parallel.distributed import (
    _grid_rows as jax_grid_rows)
from split_learning_tpu_torch.parallel import global_mesh, make_mesh
from split_learning_tpu_torch.parallel.distributed import (
    SpecLayout, _grid_rows, init_multi_host, is_coordinator, process_count)
from split_learning_tpu_torch.parallel.mesh import (
    batch_sharding, host_gather, make_host_mesh, replicated)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240   # seconds for the processes of one test


@dataclasses.dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


def _cluster(hosts, per_host):
    return [FakeDev(h * per_host + i, h) for h in range(hosts)
            for i in range(per_host)]


def test_init_multi_host_single_process_noop(monkeypatch):
    monkeypatch.delenv("SLT_COORDINATOR", raising=False)
    monkeypatch.delenv("SLT_NUM_PROCESSES", raising=False)
    assert init_multi_host(device="cpu") is False
    assert init_multi_host("host:1234", num_processes=1, process_id=0,
                           device="cpu") is False
    assert process_count() == 1 and is_coordinator()


def test_init_multi_host_requires_process_id(monkeypatch):
    monkeypatch.delenv("SLT_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="process id"):
        init_multi_host("host:1234", num_processes=2, process_id=None,
                        device="cpu")


@pytest.mark.parametrize("hosts,per_host,stages", [(4, 4, 2), (2, 3, 2),
                                                   (2, 4, 4), (1, 6, 3)])
def test_grid_rows_match_jax(hosts, per_host, stages):
    """Rows of one process each, processes stacked in order; a host
    whose devices do not divide into chains is refused, as in JAX."""
    devs = _cluster(hosts, per_host)
    try:
        want = jax_grid_rows(devs, stages)
    except ValueError as e:
        with pytest.raises(ValueError, match="cross DCN"):
            _grid_rows(devs, stages)
        assert "cross DCN" in str(e)
        return
    assert _grid_rows(devs, stages) == want
    for row in want:
        assert len({d.process_index for d in row}) == 1


def test_global_mesh_single_process_equals_make_mesh():
    devs = [torch.device("cpu")] * 4
    a = global_mesh(num_clients=2, num_stages=2, devices=devs)
    b = make_mesh(num_clients=2, num_stages=2, devices=devs)
    assert a == b and a.axis_names == ("data", "pipe")
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        make_mesh(num_clients=2, seq_parallel=4, devices=devs)


def test_spec_layout_and_placements():
    mesh = make_host_mesh(data=2)
    layout = SpecLayout(mesh)
    assert layout.data == 2 and layout.model == 1
    x = torch.arange(8.0).reshape(4, 2)
    parts = layout.batch().split(x)
    assert [p.shape[0] for p in parts] == [2, 2]
    assert torch.equal(batch_sharding(mesh).gather(parts), x)
    assert all(torch.equal(p, x) for p in replicated(mesh).split(x))
    np.testing.assert_array_equal(host_gather(parts, rows=3), x[:3].numpy())
    from split_learning_tpu_torch.models import get_plan
    from split_learning_tpu_torch.runtime.state import make_state, sgd
    params = get_plan().init(torch.Generator().manual_seed(0),
                             torch.zeros(1))
    spec = layout.state(make_state(params, sgd(0.1)))
    assert len(spec) == 6 and all(s.axis is None for s in spec.values())
    tp = SpecLayout(make_mesh(model_parallel=2, device="cpu"))
    with pytest.raises(NotImplementedError, match="item 18"):
        tp.model
    with pytest.raises(NotImplementedError, match="item 18"):
        make_host_mesh(data=1, model=2)


_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
from split_learning_tpu_torch.parallel.distributed import (
    global_mesh, init_multi_host, is_coordinator, process_count, shutdown)
from split_learning_tpu_torch.parallel.mesh import make_mesh
from split_learning_tpu_torch.parallel.pipeline import PipelinedTrainer
from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.runtime.fused import FusedSplitTrainer
from split_learning_tpu_torch.utils.config import Config

multi = init_multi_host(device="cpu")
assert process_count() == (2 if multi else 1)
tag = str(torch.distributed.get_rank()) if multi else "control"
rs = np.random.RandomState(0)
data = [(rs.randn(16, 28, 28, 1).astype(np.float32),
         rs.randint(0, 10, 16).astype(np.int64)) for _ in range(6)]

def report(name, trainer):
    losses = [trainer.train_step(x, y) for x, y in data]
    flat = torch.cat([t.detach().reshape(-1) for st in trainer.params
                      for t in st.values()])
    print("RESULT", tag, name, repr(losses), flat.double().sum().item(),
          flat.abs().double().sum().item(), flush=True)

cpu = [torch.device("cpu")] * {per_proc}
if multi:
    for bad in (dict(seq_parallel=2), dict(num_clients=3)):
        try:
            global_mesh(**dict(dict(num_clients=2), **bad), devices=cpu[:1],
                        device="cpu")
        except ValueError as e:
            print("REFUSED", tag, str(e).split(";")[0][:40], flush=True)
    fused_mesh = global_mesh(num_clients=2, devices=cpu[:1], device="cpu")
    pipe_mesh = global_mesh(num_clients=2, num_stages=2, devices=cpu[:2],
                            device="cpu")
    assert fused_mesh.local_rows(int(tag)) == [int(tag)]
else:
    fused_mesh = make_mesh(num_clients=2, device="cpu")
    pipe_mesh = make_mesh(num_clients=2, num_stages=2, device="cpu")
cfg = Config(transport="fused", batch_size=16, num_clients=2, lr=0.05,
             momentum=0.9)
report("fused", FusedSplitTrainer(get_plan(), cfg,
       torch.Generator().manual_seed(0), data[0][0], mesh=fused_mesh))
report("pipeline", PipelinedTrainer(get_plan(), cfg.replace(
       microbatches=2, transport="pipeline"),
       torch.Generator().manual_seed(0), data[0][0], pipe_mesh))
print("COORD", tag, is_coordinator(), flush=True)
shutdown()
"""


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, env_extra):
    env = dict(os.environ)
    for k in ("SLT_COORDINATOR", "SLT_NUM_PROCESSES", "SLT_PROCESS_ID"):
        env.pop(k, None)
    env.update(env_extra)
    return subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _collect(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_processes_over_gloo_equal_one_process():
    port = _port()
    code = _WORKER.format(repo=REPO, per_proc=2)
    procs = [_spawn([sys.executable, "-c", code], {
        "SLT_COORDINATOR": f"127.0.0.1:{port}", "SLT_NUM_PROCESSES": "2",
        "SLT_PROCESS_ID": str(pid)}) for pid in range(2)]
    procs.append(_spawn([sys.executable, "-c", code],
                        {"SLT_HOST_DEVICES": "4"}))
    lines = [ln for out, _ in _collect(procs) for ln in out.splitlines()]
    results = {}
    for ln in lines:
        if ln.startswith("RESULT"):
            _, tag, name, rest = ln.split(" ", 3)
            results[tag, name] = rest
    for name in ("fused", "pipeline"):
        assert results["0", name] == results["1", name] \
            == results["control", name], name
    refused = sorted(ln for ln in lines if ln.startswith("REFUSED"))
    assert len(refused) == 4
    assert any("context parallelism (seq axis)" in r for r in refused)
    assert any("2 devices across 2 hosts" in r for r in refused)
    assert sorted(ln for ln in lines if ln.startswith("COORD")) == [
        "COORD 0 True", "COORD 1 False", "COORD control True"]


def test_train_cli_over_two_processes(tmp_path):
    port = _port()
    base = [sys.executable, "-m", "split_learning_tpu_torch.launch.run",
            "train", "--device", "cpu", "--steps", "3", "--dataset",
            "synthetic", "--data-dir", str(tmp_path), "--num-clients", "2",
            "--batch-size", "16"]
    # the data cache first, so the processes do not race to write it
    first = _collect([_spawn(base, {"SLT_HOST_DEVICES": "2"})])
    procs = [_spawn(base + ["--coordinator", f"127.0.0.1:{port}",
                            "--num-processes", "2", "--process-id",
                            str(pid)], {"SLT_HOST_DEVICES": "1"})
             for pid in range(2)]
    (out0, _), (out1, _) = _collect(procs)

    def final(out):
        return [ln for ln in out.splitlines() if ln.startswith("[done]")][0] \
            .split("final_loss=")[1].split(" ")[0]

    assert final(out0) == final(out1) == final(first[0][0])
    assert "[step 0]" in out0 and "[step" not in out1
