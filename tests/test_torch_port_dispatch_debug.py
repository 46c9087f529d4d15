"""The port's dispatch watchdog (``obs/dispatch_debug.py``) on the CPU.

tests/conftest.py is the JAX package's and is not edited, so these tests
check the tracker themselves: each leaves the process-wide tracker
cleared, uninstalled and off.

- Off (``SLT_DISPATCH_DEBUG`` unset, not forced): ``attach`` is None and
  ``step_scope``/``expected_d2h`` hand back one shared ``nullcontext``;
  the fused trainer's losses and parameters are bit-equal off and on.
- The reporting machinery, fed the text of PyTorch's sync-debug warning
  (nothing synchronises on the CPU): a sync inside a step scope and
  outside an ``expected_d2h`` region counts into
  ``unexpected_d2h_total``, one inside the region into
  ``expected_d2h_total``, one on a thread in no scope into neither; a
  scope on one thread never flags another thread's sanctioned read;
  the ``warnings`` hook routes the warning by the calling thread; a
  scope runs its backward on its own thread (autograd multithreading off
  there only), so a sync in a custom ``autograd.Function``'s backward is
  judged in the scope.
- Steady state: a planted build (``load_kernels`` with an empty build
  directory, inside the third scope of a seen signature) is flagged and
  counted into ``compile_count``; a launch pattern that changes at
  ordinal >= 2 is flagged; a fresh signature is not.
- The runtimes' hooks: the fused trainer scopes each step and chunk, the
  two-party server and client their programs, with no violation; the
  party's ``metrics()`` carries the gauges.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from split_learning_tpu_torch.models import get_plan
from split_learning_tpu_torch.obs import dispatch_debug as dd
from split_learning_tpu_torch.ops import common
from split_learning_tpu_torch.runtime import (
    FusedSplitTrainer, ServerRuntime, SplitClientTrainer)
from split_learning_tpu_torch.transport import LocalTransport
from split_learning_tpu_torch.utils.config import Config

MSG = "called a synchronizing CUDA operation"


@pytest.fixture
def on(monkeypatch):
    monkeypatch.delenv("SLT_DISPATCH_DEBUG", raising=False)
    dd.force(True)
    dd.tracker().clear()
    try:
        yield dd.tracker()
    finally:
        dd.force(False)
        dd.uninstall()
        dd.tracker().clear()


def _data(n=4, batch=8):
    rs = np.random.RandomState(0)
    return [(rs.rand(batch, 28, 28, 1).astype(np.float32),
             rs.randint(0, 10, batch).astype(np.int64)) for _ in range(n)]


def _fused(cfg=None):
    return FusedSplitTrainer(get_plan(), cfg or Config(transport="fused",
                                                    batch_size=8),
                             torch.Generator().manual_seed(0), None,
                             device="cpu")


def test_off_is_one_shared_nullcontext(monkeypatch):
    monkeypatch.delenv("SLT_DISPATCH_DEBUG", raising=False)
    assert not dd.enabled() and dd.attach() is None
    assert dd.step_scope(None, ("k", 1)) is dd.expected_d2h(None)
    assert dd.step_scope(None, "x", sig_fn=lambda: 1 / 0) is dd._NULL_CTX
    assert common.LAUNCHES.hook is None and common.BUILD_HOOK is None
    monkeypatch.setenv("SLT_DISPATCH_DEBUG", "1")
    assert dd.enabled()
    monkeypatch.setenv("SLT_DISPATCH_DEBUG", "0")
    assert not dd.enabled()


def test_losses_bit_equal_off_and_on(on):
    data = _data()
    dd.force(False)
    off = _fused()
    assert off._dd is None
    off_losses = [off.train_step(x, y) for x, y in data]
    dd.force(True)
    tr = _fused()
    assert tr._dd is on
    on_losses = [tr.train_step(x, y) for x, y in data[:2]]
    on_losses += tr.train_epoch(np.stack([x for x, _ in data[2:]]),
                                np.stack([y for _, y in data[2:]])).tolist()
    assert on_losses == off_losses
    for a, b in zip(off.params, tr.params):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert on._ordinals[(tr._ddtok, "fused_step")] == 2
    assert on._ordinals[(tr._ddtok, "fused_epoch")] == 1
    assert on.violations == []


def test_sync_in_scope_counts_and_allowed_read_does_not():
    t = dd.DispatchTracker()
    assert t.on_sync(MSG) is False            # no scope: left alone
    with t.scope(("p", "step")):
        assert t.on_sync(MSG) is True
        with t.allow():
            assert t.on_sync(MSG) is True
    with t.allow():                          # a sanctioned read anywhere
        t.on_sync(MSG)
    g = t.gauges()
    assert g["unexpected_d2h_total"] == 1.0
    assert g["expected_d2h_total"] == 2.0
    assert [v["kind"] for v in t.violations] == ["unexpected-d2h"]


def test_another_threads_expected_read_is_not_flagged():
    t = dd.DispatchTracker()
    inside, release = threading.Event(), threading.Event()
    out = {}

    def scoped():
        with t.scope(("server", "split_step")):
            inside.set()
            release.wait(timeout=10)
            out["own"] = t.on_sync(MSG)       # this thread's own sync

    th = threading.Thread(target=scoped)
    th.start()
    inside.wait(timeout=10)
    # another thread's sanctioned read while the scope is open
    with t.allow():
        t.on_sync(MSG)
    # and another thread's unsanctioned sync outside any scope
    other = threading.Thread(target=lambda: out.setdefault(
        "bystander", t.on_sync(MSG)))
    other.start()
    other.join(timeout=10)
    release.set()
    th.join(timeout=10)
    assert out == {"own": True, "bystander": False}
    assert t.unexpected_d2h == 1 and t.expected_d2h == 1
    assert len(t.violations) == 1


def test_the_warning_hook_routes_by_the_calling_thread(on):
    dd.install()
    assert common.LAUNCHES.hook is not None
    with on.scope(("x", "step")):
        warnings.warn(MSG, UserWarning)
        with dd.expected_d2h(on):
            warnings.warn(MSG, UserWarning)
    # a sync outside any scope is dropped; any other warning goes on to
    # the warning machinery
    dd.uninstall()
    with warnings.catch_warnings(record=True) as seen:
        dd.install()
        warnings.warn(MSG, UserWarning)
        warnings.warn("unrelated", UserWarning)
    assert [str(w.message) for w in seen] == ["unrelated"]
    g = on.gauges()
    assert g["unexpected_d2h_total"] == 1.0
    assert g["expected_d2h_total"] == 1.0


class _SyncInBackward(torch.autograd.Function):
    """Identity whose backward makes a (stand-in) host sync."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        warnings.warn(MSG, UserWarning)
        return g


def test_a_scope_runs_its_backward_on_its_own_thread(on):
    # PyTorch would run a CUDA backward on its autograd device thread,
    # in no scope; a scope keeps it on the scope's thread (thread-local)
    dd.install()
    assert torch.autograd.is_multithreading_enabled()
    seen = {}
    with on.scope(("x", "step")):
        seen["in_scope"] = torch.autograd.is_multithreading_enabled()
        other = threading.Thread(target=lambda: seen.setdefault(
            "other_thread", torch.autograd.is_multithreading_enabled()))
        other.start()
        other.join(timeout=10)
        w = torch.ones(4, requires_grad=True)
        _SyncInBackward.apply(w * 2).sum().backward()
    assert seen == {"in_scope": False, "other_thread": True}
    assert torch.autograd.is_multithreading_enabled()
    assert on.gauges()["unexpected_d2h_total"] == 1.0
    assert [v["kind"] for v in on.violations] == ["unexpected-d2h"]


def test_planted_steady_state_build_is_flagged(on, tmp_path, monkeypatch):
    dd.install()
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(common, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    n_src = len(list(common.CSRC_DIR.glob("*.cu")))
    sig = (("acts", (8, 26, 26, 32)),)
    for ordinal in range(3):
        with dd.step_scope(on, ("srv", "split_step"), sig_fn=lambda: sig):
            if ordinal in (0, 2):
                with pytest.raises(RuntimeError, match="nvcc"):
                    common.load_kernels()
    kinds = [v["kind"] for v in on.violations]
    assert kinds == ["steady-state-build"]     # ordinal 0 may build
    assert on.violations[0]["ordinal"] == 2
    assert on.gauges()["compile_count"] == 2.0 * n_src
    assert on.gauges()["steady_state_recompiles"] == 1.0
    # a new signature at a late ordinal is fresh: its build is legitimate
    with dd.step_scope(on, ("srv", "split_step"), sig_fn=lambda: "other"):
        with pytest.raises(RuntimeError):
            common.load_kernels()
    assert len(on.violations) == 1


def test_launch_pattern_change_is_flagged(on):
    dd.install()
    for ordinal in range(4):
        with dd.step_scope(on, ("fused", "step"), sig_fn=lambda: "s"):
            common.LAUNCHES.add("ce_fwd")
            if ordinal == 3:
                common.LAUNCHES.add("ce_fwd")   # one more than before
    (v,) = on.violations
    assert v["kind"] == "steady-state-launch-change" and v["ordinal"] == 3
    # an early change (ordinal 1) is not a violation
    on.clear()
    for ordinal in range(3):
        with dd.step_scope(on, ("fused", "step"), sig_fn=lambda: "s"):
            for _ in range(1 if ordinal == 0 else 2):
                common.LAUNCHES.add("ce_fwd")
    assert on.violations == []


def test_two_party_hooks_and_party_gauges(on):
    plan, cfg = get_plan(), Config(batch_size=8)
    server = ServerRuntime(plan, cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    client = SplitClientTrainer(plan, cfg, torch.Generator().manual_seed(0),
                                LocalTransport(server, compress="int8"),
                                device="cpu")
    assert server._dd is on and client._dd is on
    for i, (x, y) in enumerate(_data(3)):
        client.train_step(x, y, i)
    assert on._ordinals[(server._ddtok, "split_step")] == 3
    assert on._ordinals[(client._ddtok, "client_fwd")] == 3
    assert on._ordinals[(client._ddtok, "client_bwd")] == 3
    assert on.violations == []
    gauges = server.metrics()["gauges"]
    for k in ("compile_count", "unexpected_d2h_total",
              "steady_state_recompiles", "expected_d2h_total"):
        assert gauges[k] == 0.0
