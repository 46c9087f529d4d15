"""slt-lint of the port (``split_learning_tpu_torch/analysis``) against the
JAX package's (counterpart of tests/test_analysis.py), on the CPU.

- The framework-neutral rules (SLT002-005, 011, 014, 015) run on the same
  planted sources through JAX's ``lint_paths`` and the port's: the
  findings are equal as (rule, file, line). Where the port's rules see
  further than JAX's (SLT001's host integers, SLT015's event name passed
  through a helper's parameter), the torch cases hold both sides.
- The rules the port re-points at PyTorch, on planted torch snippets,
  positive and negative: SLT001's and SLT013's host-read sinks
  (``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``float()`` /
  ``int()`` / ``bool()`` on a tensor, ``torch.cuda.synchronize()``, an
  event's ``.synchronize()``), SLT004's torch RNG, SLT014's
  ``torch.save``, and rules_torch.py's SLT006-010 (stale reads after K2 /
  ``_foreach_`` / an optimizer, capture hazards, implicit syncs,
  generator seeding, the wire schema and both ctypes bindings).
- The real tree: the lint over ``split_learning_tpu_torch/`` and
  ``chip_smoke.py`` has zero unwaived findings (its one waiver has a
  reason), the CLI's exit codes, waivers (inline, file, unreasoned),
  ``--list-rules``, the rule catalogs of both packages, and the pin that
  every analysis module but scenarios imports the stdlib only.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from split_learning_tpu.analysis import engine as jengine
from split_learning_tpu_torch.analysis import cfg as cfg_mod
from split_learning_tpu_torch.analysis import engine
from split_learning_tpu_torch.analysis import rules as prules

REPO = Path(__file__).resolve().parent.parent
NEUTRAL = ("SLT002", "SLT003", "SLT004", "SLT005", "SLT011", "SLT014",
           "SLT015")


def _write(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def _lint(tmp_path, relpath, source):
    _write(tmp_path, {relpath: source})
    return engine.lint_file(str(tmp_path / relpath))


def _rules(findings, *, waived=None):
    return sorted(f.rule for f in findings
                  if waived is None or f.waived is waived)


# ---------------------------------------------------------------------- #
# the neutral rules: the same findings as JAX's on the same sources
# ---------------------------------------------------------------------- #
NEUTRAL_CASES = {
    "slt002_early_return": {"runtime/server.py": """
        class S:
            def step(self, step):
                entry, owner = self.replay.begin(0, "op", step)
                if not owner:
                    return self.replay.wait(entry)
                res = self.compute()
                if res is None:
                    return None
                self.replay.resolve(entry, res)
                return res
    """},
    "slt002_try_except_clean": {"runtime/server.py": """
        class S:
            def step(self, step):
                entry, owner = self.replay.begin(0, "op", step)
                if not owner:
                    return self.replay.wait(entry)
                try:
                    res = self.compute()
                    if entry is not None:
                        self.replay.resolve(entry, res)
                    return res
                except BaseException as exc:
                    if entry is not None:
                        self.replay.fail(entry, exc)
                    raise
    """},
    "slt002_finally": {"transport/wire.py": """
        class S:
            def ok(self, step):
                entry, owner = self.replay.begin(0, "op", step)
                try:
                    return self.compute()
                finally:
                    self.replay.resolve(entry, None)
            def leak(self, step):
                entry, owner = self.replay.begin(0, "op", step)
                try:
                    return self.compute()
                finally:
                    self.log("done")
    """},
    "slt002_typed_handler": {"runtime/stage.py": """
        class S:
            def step(self, step):
                entry, owner = self.replay.begin(0, "op", step)
                try:
                    res = self.compute()
                except KeyError as exc:
                    self.replay.fail(entry, exc)
                    raise
                self.replay.resolve(entry, res)
                return res
    """},
    "slt003_literals": {"runtime/worker.py": """
        from split_learning_tpu_torch.obs import spans
        def go(tr, stats, reg, dt):
            tr.record("client_fwd", 0.0, dt)
            stats.record_span("wire", dt)
            reg.observe("lock_hold", dt)
            tr.record(spans.CLIENT_FWD, 0.0, dt)
            stats.record(dt)
    """},
    "slt004_global_rng": {"ops/noise.py": """
        import random
        import time
        import numpy as np
        def draw():
            a = random.random()
            rs = np.random.RandomState()
            b = np.random.rand(3)
            t = time.time()
            return a, rs, b, t
    """},
    "slt004_seeded_clean": {"transport/chaos.py": """
        import random
        import time
        import numpy as np
        def draw(seed):
            rng = random.Random(seed)
            rs = np.random.RandomState(seed & 0x7FFFFFFF)
            t0 = time.perf_counter()
            time.sleep(0.0)
            return rng.random(), rs.rand(), time.monotonic() - t0
    """},
    "slt004_nondet_import_and_scope": {
        "transport/codec.py": "from random import shuffle\n",
        "native/codec.py": "import random\nx = random.SystemRandom()\n",
        "launch/cli.py": "import time\ndef now():\n    return time.time()\n"},
    "slt005_cycles": {"runtime/sharded.py": """
        class S:
            def a(self):
                with self._alpha_lock:
                    with self._beta_lock:
                        pass
            def b(self):
                with self._beta_lock:
                    with self._alpha_lock:
                        pass
        class T:
            def outer(self):
                with self._alpha_lock:
                    self.inner()
            def inner(self):
                with self._beta_lock:
                    pass
    """},
    "slt005_consistent": {"runtime/sharded.py": """
        class S:
            def a(self):
                with self._alpha_lock:
                    with self._beta_lock:
                        pass
            def b(self):
                with self._alpha_lock:
                    with self._beta_lock:
                        pass
    """},
    "slt011_waits": {"runtime/coalesce.py": """
        class Coalescer:
            def a(self):
                with self._cond:
                    self._cond.wait(timeout=1.0)
            def b(self):
                with self.cv:
                    if not self.ready:
                        self.cv.wait()
            def c(self):
                with self._cond:
                    while not self.ready:
                        self._cond.wait(timeout=1.0)
            def d(self):
                with self.cv:
                    self.cv.wait_for(lambda: self.ready, timeout=1.0)
            def e(self):
                while self.alive:
                    def poke():
                        with self._cond:
                            self._cond.wait()
                    poke()
    """},
    "slt014_writes": {"runtime/ckpt.py": """
        import os
        import pickle
        import numpy as np
        def save_meta(path, text):
            with open(path, "w") as f:
                f.write(text)
        def save_blob(path, obj):
            with open(path, "wb") as f:
                pickle.dump(obj, f)
            np.save(path, obj)
        def atomic(path, text):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
    """},
    "slt014_pairing": {
        "runtime/state.py": """
            def export_state(self):
                return {"step": 1, "ghost": 2, "replay": []}
        """,
        "transport/wire.py": """
            def restore_state(self, rec):
                return rec["step"], rec["missing"], rec.get("replay")
        """},
    "slt015_flight_names": {"runtime/server.py": """
        from split_learning_tpu_torch.obs import flight as obs_flight
        from split_learning_tpu_torch.obs import spans
        def step(self):
            fl = obs_flight.get_recorder()
            if fl is not None:
                fl.record("my_event", step=1)
                fl.record(spans.FL_BOGUS, step=1)
                fl.record(spans.FL_DISPATCH, step=3, client_id=0)
                fl.record(FL_NOT_THERE)
    """},
}


def _neutral(findings, root):
    return sorted((f.rule, os.path.relpath(f.path, root), f.line)
                  for f in findings if f.rule in NEUTRAL)


@pytest.mark.parametrize("case", sorted(NEUTRAL_CASES))
def test_neutral_rules_match_jax(tmp_path, case):
    files = NEUTRAL_CASES[case]
    for side in ("jax", "port"):
        _write(tmp_path / side, files)
    got = _neutral(engine.lint_paths([str(tmp_path / "port")]),
                   tmp_path / "port")
    want = _neutral(jengine.lint_paths([str(tmp_path / "jax")]),
                    tmp_path / "jax")
    assert got == want
    if not case.endswith(("clean", "consistent")):
        assert got, "the planted fault must be found"


def test_flight_registry_is_the_ports_spans():
    from split_learning_tpu_torch.obs import spans
    assert prules._flight_registry() == {k for k in vars(spans)
                                         if k.startswith("FL_")}


def test_cfg_routes_return_through_finally():
    fn = ast.parse(textwrap.dedent("""
        def f(self):
            try:
                return self.work()
            finally:
                self.cleanup()
    """)).body[0]
    graph = cfg_mod.build(fn)
    ret = next(n for n in graph.nodes if isinstance(n.stmt, ast.Return))
    succs = [t for t, _c in ret.succs]
    assert graph.exit not in succs
    assert any(isinstance(t.stmt, ast.Expr) for t in succs)


# ---------------------------------------------------------------------- #
# the torch sinks and rules
# ---------------------------------------------------------------------- #
TORCH_CASES = {
    # SLT001: host reads under the runtime lock
    "slt001_torch_sinks": ("runtime/server.py", """
        import torch
        class ServerRuntime:
            def step(self):
                with self._lock:
                    a = self.loss.item()
                    b = self.g.cpu()
                    c = self.g.numpy()
                    d = self.rows.tolist()
                    e = float(self.loss)
                    f = int(self.mask.sum())
                    g = bool(torch.isfinite(self.x).all())
                    torch.cuda.synchronize()
                    self._event.synchronize()
                return a, b, c, d, e, f, g
    """, ["SLT001"] * 9 + ["SLT008"]),   # bool() of a torch value: both
    "slt001_clean_shapes": ("runtime/server.py", """
        import numpy as np
        class ServerRuntime:
            def step(self, step):
                with self._lock:
                    acts = self._to_dev(self.host)
                    n = int(step)
                    if not self.overlap:
                        g = self.g.cpu()           # gated legacy branch
                g = self.g.cpu()                   # off the lock
                return g, n
        class _GroupD2H:
            def materialize(self):
                with self._lock:                   # the D2H latch
                    self.rows = self._read.get()[0].numpy()
    """, []),
    # SLT001: float()/int() of a name that holds a host integer wherever
    # the function binds it is no device read; one other binding flags it
    "slt001_host_ints_clean": ("runtime/party.py", """
        class PartyRuntime:
            def note_wire(self, raw_bytes, wire_bytes, rows):
                raw_i, wire_i = int(raw_bytes), int(wire_bytes)
                total = 0
                total += raw_i
                n = len(rows)
                with self._lock:
                    self._metrics.incr("wire_raw_bytes", float(raw_i))
                    self._metrics.incr("wire_bytes", float(wire_i))
                    self._metrics.incr("total", float(total))
                    self._metrics.incr("rows", int(n))
    """, []),
    "slt001_host_ints_flagged": ("runtime/party.py", """
        class PartyRuntime:
            def note_wire(self, raw_bytes, parts):
                raw_i = int(raw_bytes)
                if parts:
                    raw_i = parts[0].sum()
                acc = 0
                for p in parts:
                    acc += p
                with self._lock:
                    self._metrics.incr("raw", float(raw_i))
                    self._metrics.incr("acc", float(acc))
                    self._metrics.incr("arg", float(raw_bytes))
    """, ["SLT001"] * 3),
    # SLT015: a helper's event-name parameter is registered when every
    # call site in the file feeds it an FL_* constant
    "slt015_forwarded_name_clean": ("transport/http.py", """
        from split_learning_tpu_torch.obs import flight as obs_flight
        from split_learning_tpu_torch.obs import spans
        class HttpTransport:
            def hop(self, step):
                self._hop_flight(spans.FL_HOP_SEND, step)
                out = self._post(step)
                self._hop_flight(name=spans.FL_HOP_RECV, step=step)
                return out
            @staticmethod
            def _hop_flight(name, step):
                fl = obs_flight.get_recorder()
                if fl is not None:
                    fl.record(name, step=int(step))
    """, []),
    "slt015_forwarded_name_flagged": ("transport/local.py", """
        from split_learning_tpu_torch.obs import flight as obs_flight
        from split_learning_tpu_torch.obs import spans
        class LocalTransport:
            def hop(self, step, what):
                self._hop_flight(spans.FL_HOP_SEND, step)
                self._hop_flight(what, step)
            def _hop_flight(self, name, step):
                fl = obs_flight.get_recorder()
                if fl is not None:
                    fl.record(name, step=int(step))
            def _orphan(self, label):
                fl = obs_flight.get_recorder()
                fl.record(label)
    """, ["SLT015"] * 2),
    # SLT013: a raw host read inside expected_d2h on a mesh-aware class
    "slt013_torch_sinks": ("runtime/server.py", """
        import numpy as np
        class ServerRuntime:
            def __init__(self):
                self._mesh = object()
            def step(self, tag):
                with obs_dispatch.expected_d2h(tag):
                    g = np.asarray(self.g_dev)
                    c = self.c_dev.cpu()
                    n = self.n_dev.numpy()
                    t = self.t_dev.tolist()
                    i = self.loss.item()
                return g, c, n, t, i
    """, ["SLT013"] * 5),
    "slt013_sanctioned_gather_clean": ("runtime/server.py", """
        class ServerRuntime:
            def __init__(self):
                self._mesh = object()
            def step(self, tag):
                with obs_dispatch.expected_d2h(tag):
                    g = self._host_gather(self.g_dev)
                    cb = lambda: self.x.cpu()
                n = self.host_buf.cpu()
                return g, cb, n
    """, []),
    # SLT004: torch's global RNG on the wire path
    "slt004_torch_global_rng": ("ops/noise.py", """
        import torch
        def draw(x, gen):
            a = torch.rand(3)
            b = torch.randn_like(x)
            torch.manual_seed(0)
            c = torch.randint(0, 9, (3,), generator=gen)
            return a, b, c
    """, ["SLT004"] * 3),
    # SLT014: torch.save onto the final name
    "slt014_torch_save": ("runtime/ckpt.py", """
        import torch
        def save(tree, path):
            torch.save(tree, path)
    """, ["SLT014"]),
    "slt014_torch_save_renamed_clean": ("runtime/ckpt.py", """
        import os
        import torch
        def save(tree, path):
            tmp = path + ".tmp"
            torch.save(tree, tmp)
            os.replace(tmp, path)
    """, []),
    # SLT006: a name bound to a leaf read after an in-place update
    "slt006_stale_alias": ("runtime/server.py", """
        import torch
        from split_learning_tpu_torch.ops.sgd import fused_sgd_step
        class S:
            def step(self, grads):
                w = self.params[0]
                fused_sgd_step(self.params, grads, None, 0.1)
                return w.sum()
            def adam(self, mu, g):
                old = mu[0]
                torch._foreach_add_(mu, g)
                return old
            def opt(self, grads):
                fwd = self.state.params[0]
                self._tx.update(self.state, grads)
                self.log(fwd)
            def optimizer(self):
                groups = list(self.opt.param_groups)
                self.opt.step()
                return groups
    """, ["SLT006"] * 4),
    "slt006_clean": ("runtime/server.py", """
        import torch
        from split_learning_tpu_torch.ops.sgd import fused_sgd_step
        class S:
            def step(self, grads):
                w = self.params[0].clone()
                loss = self.loss_of(self.params)
                fused_sgd_step(self.params, grads, None, 0.1)
                w2 = self.params[0]
                return w, loss, w2
            def rebind(self, mu, g):
                old = mu[0]
                torch._foreach_add_(mu, g)
                old = mu[1]
                return old
    """, []),
    # SLT007: capture hazards
    "slt007_capture": ("runtime/fused.py", """
        import torch
        class T:
            def __init__(self):
                self.lr = 0.1
                self._step = torch.compile(self._body)
            def _body(self, x):
                return x * self.lr
            def set_lr(self, lr):
                self.lr = lr
            def run(self, x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * self.lr
                return self._step(x, 1), self._step(x, 2), y
    """, ["SLT007"] * 3),
    "slt007_clean": ("runtime/fused.py", """
        import torch
        class T:
            def __init__(self):
                self.scale = 2.0
                self._step = torch.compile(self._body)
            def _body(self, x, lr):
                return x * lr * self.scale
            def run(self, x, lr):
                return self._step(x, lr), self._step(x, lr)
    """, []),
    # SLT008: implicit host syncs on device results
    "slt008_syncs": ("runtime/server.py", """
        import numpy as np
        import torch
        from split_learning_tpu_torch.ops.cross_entropy import (
            fused_cross_entropy)
        def step(logits, labels, acts):
            loss = fused_cross_entropy(logits, labels)
            if loss:
                pass
            ok = bool(torch.isfinite(acts).all())
            g = torch.autograd.grad(loss, [acts])[0]
            x = float(loss)
            return ok, x
        def pair(logits, labels):
            out = fused_cross_entropy(logits, labels)
            first = out.item()
            host = out.cpu()
            return first, host
    """, ["SLT008"] * 3),
    "slt008_clean": ("runtime/server.py", """
        import numpy as np
        from split_learning_tpu_torch.ops.cross_entropy import (
            fused_cross_entropy)
        def step(logits, labels):
            loss = fused_cross_entropy(logits, labels)
            host = loss.cpu()
            x = float(loss)
            n = int(labels.shape[0])
            if n:
                pass
            return host, x
        def lone(logits, labels):
            loss = fused_cross_entropy(logits, labels)
            return loss.item()
    """, []),
    # SLT009: generator seeding
    "slt009_seeding": ("data/datasets.py", """
        import torch
        def two(seed):
            a = torch.Generator().manual_seed(seed)
            b = torch.Generator().manual_seed(seed)
            return a, b
        def loop(seed, n):
            g = torch.Generator()
            out = []
            for i in range(n):
                g.manual_seed(seed)
                out.append(torch.rand(3, generator=g))
            return out
    """, ["SLT009"] * 2),
    "slt009_clean": ("models/init.py", """
        import torch
        def derive(seed, n):
            gens = [torch.Generator().manual_seed(seed + i)
                    for i in range(n)]
            g = torch.Generator()
            out = []
            for i in range(n):
                g.manual_seed(seed + i)
                out.append(torch.rand(3, generator=g))
            return gens, out
    """, []),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_rules(tmp_path, case):
    rel, src, want = TORCH_CASES[case]
    findings = _lint(tmp_path, rel, src)
    assert _rules(findings) == sorted(want), [f.format() for f in findings]


def test_slt006_names_the_update_and_the_binding(tmp_path):
    findings = _lint(tmp_path, "runtime/server.py", """
        from split_learning_tpu_torch.ops.sgd import fused_sgd_step
        def step(params, grads):
            w = params[0]
            fused_sgd_step(params, grads, None, 0.1)
            return w
    """)
    assert _rules(findings) == ["SLT006"]
    msg = findings[0].message
    assert "fused_sgd_step" in msg and "line 4" in msg and "clone" in msg
    assert findings[0].line == 6


def test_slt006_scope(tmp_path):
    findings = _lint(tmp_path, "launch/run.py", """
        from split_learning_tpu_torch.ops.sgd import fused_sgd_step
        def step(params, grads):
            w = params[0]
            fused_sgd_step(params, grads, None, 0.1)
            return w
    """)
    assert findings == []


# ---------------------------------------------------------------------- #
# SLT010: the wire schema and both ctypes bindings
# ---------------------------------------------------------------------- #
def test_slt010_codec_field_drift(tmp_path):
    _write(tmp_path, {"transport/codec.py": """
        def foo_compress(arr):
            return {"tag": True, "n": 3, "ghost": 1}
        def foo_decompress(d):
            return (d["tag"], d["n"], d["missing"])
    """})
    findings = engine.lint_paths([str(tmp_path)])
    assert _rules(findings) == ["SLT010", "SLT010"]
    msgs = " ".join(f.message for f in findings)
    assert "ghost" in msgs and "missing" in msgs


def test_slt010_http_reply_field_never_read(tmp_path):
    _write(tmp_path, {"transport/http.py": """
        class HttpTransport:
            def split_step(self, acts, step):
                out = self._post("/forward_pass",
                                 {"acts": acts, "step": step})
                return out["grads"], float(out["loss"])
        def handle_forward(req, runtime):
            grads, loss = runtime.split_step(req["acts"], req["step"])
            resp = {"grads": grads, "loss": loss, "debug": 1}
            return resp
    """})
    findings = engine.lint_paths([str(tmp_path)])
    assert _rules(findings) == ["SLT010"]
    assert "debug" in findings[0].message


def test_slt010_native_binding_pairing(tmp_path):
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "slt_codec.cc").write_text(
        'extern "C" {\n'
        "int slt_encode(const char* buf) {\n  return 0;\n}\n"
        "int slt_unused(int x) {\n  return 1;\n}\n"
        "}\n")
    _write(tmp_path, {"native/codec.py": """
        lib = None
        def encode(buf):
            return lib.slt_encode(buf)
        def missing(buf):
            return lib.slt_missing(buf)
    """})
    findings = engine.lint_paths([str(tmp_path)])
    assert _rules(findings) == ["SLT010", "SLT010"]
    msgs = " ".join(f.message for f in findings)
    assert "slt_missing" in msgs and "slt_unused" in msgs


def test_slt010_kernel_binding_pairing(tmp_path):
    """ops/*.py's bindings through load_kernels()["<stem>"] against the
    extern "C" exports of csrc/<stem>.cu, both directions, and a stem
    with no source."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text(
        "__global__ void body() {}\n"
        'extern "C" {\n'
        "int slt_k_launch(const float* x, int n) {\n  return 0;\n}\n"
        "int slt_k_dead(int n) {\n  return 0;\n}\n"
        "}  // extern \"C\"\n")
    _write(tmp_path, {"ops/k.py": """
        from split_learning_tpu_torch.ops.common import load_kernels
        def _lib():
            lib = load_kernels()["k"]
            lib.slt_k_launch.argtypes = []
            lib.slt_k_gone.argtypes = []
            return lib
        def _other():
            return load_kernels()["nope"]
    """})
    findings = engine.lint_paths([str(tmp_path)])
    assert _rules(findings) == ["SLT010"] * 3
    msgs = " ".join(f.message for f in findings)
    assert "slt_k_gone" in msgs and "slt_k_dead" in msgs
    assert "'nope'" in msgs


def test_slt010_real_bindings_pair_up():
    """The port's ops modules bind every csrc export and nothing else,
    and native/codec.py binds every slt_codec.cc export."""
    findings = [f for f in engine.lint_paths(
        [str(REPO / "split_learning_tpu_torch")]) if f.rule == "SLT010"]
    assert findings == []


# ---------------------------------------------------------------------- #
# waivers, exit codes, the real tree
# ---------------------------------------------------------------------- #
_BAD = """
    class ServerRuntime:
        def f(self):
            with self._lock:
                return self.dev.item()
"""


def test_inline_waiver_same_line_and_line_above(tmp_path):
    findings = _lint(tmp_path, "runtime/server.py", """
        class ServerRuntime:
            def a(self):
                with self._lock:
                    g = self.dev.cpu()  # slt-lint: disable=SLT001 (demo)
                return g
            def b(self):
                with self._lock:
                    # slt-lint: disable=SLT001 (next-line demo)
                    g = self.dev.cpu()
                return g
    """)
    assert _rules(findings, waived=True) == ["SLT001", "SLT001"]
    assert _rules(findings, waived=False) == []


def test_unreasoned_waiver_is_itself_a_finding(tmp_path):
    findings = _lint(tmp_path, "runtime/server.py", """
        class ServerRuntime:
            def a(self):
                with self._lock:
                    g = self.dev.cpu()  # slt-lint: disable=SLT001 ()
                return g
    """)
    rules = _rules(findings, waived=False)
    assert "SLT000" in rules and "SLT001" in rules


def test_main_exit_codes(tmp_path, capsys):
    _write(tmp_path, {"runtime/server.py": _BAD})
    assert engine.main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "SLT001" in out and "server.py:5" in out
    (tmp_path / "runtime" / "server.py").write_text("x = 1\n")
    assert engine.main([str(tmp_path)]) == 0


def test_waiver_file(tmp_path):
    _write(tmp_path, {"runtime/server.py": _BAD})
    wf = tmp_path / "waivers"
    wf.write_text("SLT001 runtime/server.py quarantined pending refactor\n")
    assert engine.main([str(tmp_path), "--waiver-file", str(wf)]) == 0
    wf.write_text("SLT001\n")  # malformed: no path or reason
    assert engine.main([str(tmp_path), "--waiver-file", str(wf)]) == 1


def test_syntax_error_is_a_finding(tmp_path):
    findings = _lint(tmp_path, "runtime/broken.py", "def f(:\n")
    assert _rules(findings) == ["SLT000"]


def test_list_rules(capsys):
    assert engine.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [f"SLT{n:03d}" for n in range(1, 16)]
    ids += [f"SLT{n}" for n in range(100, 117)]
    for rule in ids:
        assert f"{rule}:" in out, rule
    for torch_word in ("fused_sgd_step", "torch.compile", "torch.Generator",
                       "csrc"):
        assert torch_word in out


def test_rule_catalog_matches_jax():
    ours = set(prules.RULES) | set(prules.PROJECT_RULES) | set(
        engine.CHECK_RULES)
    theirs = set(jengine.RULES) | set(jengine.PROJECT_RULES) | set(
        jengine.CHECK_RULES)
    assert ours == theirs


def test_real_tree_has_zero_unwaived_findings(monkeypatch):
    monkeypatch.chdir(REPO)
    findings = engine.lint_paths(["split_learning_tpu_torch", "chip_smoke.py"])
    unwaived = [f.format() for f in findings if not f.waived]
    assert unwaived == []
    for f in findings:
        assert f.reason, f.format()


def test_waiver_file_at_the_root_is_empty_by_policy():
    text = (REPO / ".slt-lint.waivers").read_text()
    assert [ln for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")] == []


def test_module_cli_lints_the_port_by_default():
    out = subprocess.run([sys.executable, "-m",
                          "split_learning_tpu_torch.analysis"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "0 unwaived finding(s)" in out.stdout


def test_analysis_package_is_stdlib_only():
    """Every analysis module but scenarios imports the standard library
    and the analysis package only; sched.py's one seam import (the
    ``obs.locks`` constructors it installs its primitives into) is lazy,
    and obs/locks.py is itself stdlib-only beside spans and the flight
    recorder's trigger."""
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    allowed = {"sched": {"split_learning_tpu_torch.obs"}}
    for mod in ("__init__", "__main__", "engine", "rules", "rules_torch",
                "cfg", "sched", "invariants"):
        path = REPO / "split_learning_tpu_torch" / "analysis" / f"{mod}.py"
        tree = ast.parse(path.read_text())
        top = {n for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] in stdlib:
                    continue
                if name.startswith("split_learning_tpu_torch.analysis"):
                    continue
                assert name in allowed.get(mod, set()), (mod, name)
                assert node not in top, f"{mod}: {name} must import lazily"
    locks_src = (REPO / "split_learning_tpu_torch" / "obs" / "locks.py")
    for node in ast.walk(ast.parse(locks_src.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module.split(".")[0] in stdlib or \
                node.module == "split_learning_tpu_torch.obs", node.module


def test_importing_the_linter_pulls_in_no_torch_or_numpy():
    code = ("import sys\n"
            "for name in ('torch', 'numpy'):\n"
            "    sys.modules[name] = None\n"
            "import split_learning_tpu_torch.analysis.engine as e\n"
            "import split_learning_tpu_torch.analysis.sched\n"
            "import split_learning_tpu_torch.analysis.invariants\n"
            "sys.exit(e.main(['--list-rules']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SLT010:" in out.stdout


def test_scenarios_module_is_loaded_only_under_check():
    code = ("import sys\n"
            "import split_learning_tpu_torch.analysis.engine as e\n"
            "e.main(['split_learning_tpu_torch/obs/spans.py'])\n"
            "assert 'split_learning_tpu_torch.analysis.scenarios' "
            "not in sys.modules\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
