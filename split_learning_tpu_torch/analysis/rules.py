"""slt-lint rule catalog of the PyTorch port (counterpart of
``split_learning_tpu/analysis/rules.py``).

Each rule encodes one invariant the runtime's correctness rests on by
convention:

========  ==============================================================
SLT001    no device-to-host read or blocking transport/IO under the
          runtime/coalescer locks (``.item()``, ``.cpu()``,
          ``.numpy()``, ``.tolist()``, ``float()`` and friends on a
          tensor, ``np.asarray``, ``torch.cuda.synchronize()``, an
          event's or stream's ``.synchronize()``)
SLT002    every ``replay.begin()`` claim reaches ``resolve()`` /
          ``fail()`` (or the non-owner ``wait()``) on all exit paths --
          a leaked claim wedges every duplicate of that step forever
SLT003    span-name literals live in obs/spans.py only -- the
          client/server/trace taxonomies must not drift
SLT004    wire-path determinism -- no module-global RNG (``random``,
          ``np.random``, ``torch.rand*`` without a generator), no
          unseeded RNG construction, no wall clock in
          chaos/codec/native/ops/breaker
SLT005    lock-order -- the statically visible nested-acquisition graph
          must be acyclic
SLT011    condition ``wait()`` must sit inside a ``while``-predicate
          loop (or use ``wait_for``) -- the static twin of slt-check's
          lost-wakeup exploration
SLT012    on a deferred-apply runtime (``decouple_bwd``) every
          ``self.state.params`` read holds the apply lock or goes
          through the flush barrier -- an unlocked read can observe
          params up to ``apply_lag`` updates stale
SLT013    on a mesh-aware runtime the program-output reads
          (``expected_d2h`` blocks) use the sanctioned per-shard gather
          (``runtime/party.py`` ``_host_gather``) -- a raw
          ``np.asarray`` or ``.cpu()``/``.numpy()``/``.tolist()``/
          ``.item()`` drags every shard (padding included) to host
SLT014    runtime/ persistence is crash-atomic: tmp-write + rename,
          never an in-place ``open(.., "w")``, ``np.save``,
          ``pickle.dump`` or ``torch.save`` onto the final name -- and
          exporter-written checkpoint fields pair with restorers
SLT015    flight-recorder event names at ``flight.record(...)`` call
          sites come from the obs/spans.py ``FL_*`` registry (directly,
          or through a parameter every call site feeds one)
========  ==============================================================

The rules are project-shaped: scopes are path suffixes inside the
package (the port keeps JAX's layout), receivers are matched by the
names the runtime uses, and the known-good exceptions (the
``overlap=False`` legacy branch; the ``_GroupD2H`` materialization
latch, whose purpose is to hold its private lock across the host read)
are encoded here rather than waived at every site. Everything else goes
through the ``# slt-lint: disable=SLT00N (reason)`` waiver syntax of
engine.py. SLT006-010, the framework rules, are in rules_torch.py.

Stdlib-only: the SLT015 registry is read by parsing obs/spans.py, not
by importing it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from split_learning_tpu_torch.analysis import cfg as cfg_mod


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    reason: str = ""

    def format(self) -> str:
        tail = f"  [waived: {self.reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tail}"


@dataclasses.dataclass(frozen=True)
class Src:
    """One parsed file as the rules see it."""
    path: str       # as passed on the command line
    posix: str      # forward-slash form, for scope suffix matching
    tree: ast.AST
    text: str


def _in_dir(src: Src, *parts: str) -> bool:
    return any(f"/{p}/" in src.posix or src.posix.startswith(f"{p}/")
               for p in parts)


def _ends(src: Src, *suffixes: str) -> bool:
    return any(src.posix.endswith(s) for s in suffixes)


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on 3.9+
        return "<expr>"


# ---------------------------------------------------------------------- #
# SLT001: no D2H / blocking calls under the runtime locks
# ---------------------------------------------------------------------- #

_LOCKISH = ("lock", "cond", "mutex")

# the one class whose lock exists to serialize the D2H itself: the
# group-materialization latch holds its private lock across np.asarray
# so exactly one waiter pays the transfer — that is its contract, not a
# violation of the runtime lock discipline
_D2H_LATCH_CLASSES = frozenset({"_GroupD2H"})


def _is_lockish_name(name: str) -> bool:
    return any(tok in name for tok in _LOCKISH)


def _lock_expr_name(expr: ast.expr) -> Optional[str]:
    """'self._lock'-shaped context expr -> its source text, else None."""
    if isinstance(expr, ast.Attribute) and _is_lockish_name(expr.attr):
        return _unparse(expr)
    if isinstance(expr, ast.Name) and _is_lockish_name(expr.id):
        return expr.id
    return None


def _call_root(func: ast.expr) -> Optional[str]:
    """Leftmost Name of an attribute chain ('np' for np.random.rand)."""
    while isinstance(func, ast.Attribute):
        func = func.value
    return func.id if isinstance(func, ast.Name) else None


def _is_overlap_gate(test: ast.expr) -> Optional[bool]:
    """``if not self.overlap:`` -> True (body is the legacy branch);
    ``if self.overlap:`` -> False (the *else* is legacy)."""
    if (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Attribute)
            and test.operand.attr == "overlap"):
        return True
    if isinstance(test, ast.Attribute) and test.attr == "overlap":
        return False
    return None


# reductions and tensor-producing calls whose scalar read is a D2H sync
_TENSORISH_METHODS = frozenset({"item", "sum", "mean", "max", "min", "any",
                                "all", "norm", "amax", "amin", "count_nonzero"})
# methods that copy a tensor to the host (or wait for the card)
_D2H_METHODS = {
    "item": ".item() is a blocking device->host read",
    "cpu": ".cpu() is a blocking device->host copy",
    "numpy": ".numpy() is a device->host read",
    "tolist": ".tolist() is a blocking device->host read",
    "synchronize": ".synchronize() blocks on device completion",
}


def _tensorish(expr: ast.expr) -> bool:
    """Does ``expr`` evaluate to a tensor, as far as the AST shows: a
    ``torch.*`` call or a reduction method's result."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute):
        return f.attr in _TENSORISH_METHODS or _call_root(f) == "torch"
    return False


def _int_expr(expr: ast.expr, ints: Set[str]) -> bool:
    """Is ``expr`` a host integer: an int literal, an ``int()``/``len()``
    call, or a name already known to hold one."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, int)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        return expr.func.id in ("int", "len")
    return isinstance(expr, ast.Name) and expr.id in ints


def _host_int_names(fn: ast.AST) -> Set[str]:
    """Names that hold a host integer wherever ``fn`` binds them: every
    binding is an int literal or an ``int()``/``len()`` call (directly or
    element-wise in a tuple assignment), or a ``+=`` of one. Any other
    binding (a parameter, a loop target, an unpacked call) disqualifies
    the name, so a ``float()`` of it is no device read."""
    binds: Dict[str, List[Optional[ast.expr]]] = {}

    def bind(target: ast.expr, value: Optional[ast.expr]) -> None:
        if isinstance(target, ast.Name):
            binds.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)
                    else [None] * len(target.elts))
            for t, v in zip(target.elts, vals):
                bind(t, v)

    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            binds.setdefault(a.arg, []).append(None)
    body = getattr(fn, "body", [])
    stack: List[ast.AST] = list(body) if isinstance(body, list) else [body]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue  # a nested scope binds its own names
        if isinstance(n, ast.Assign):
            for t in n.targets:
                bind(t, n.value)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            bind(n.target, n.value)
        elif isinstance(n, (ast.For, ast.AsyncFor, ast.comprehension)):
            bind(n.target, None)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            bind(n.optional_vars, None)
        elif isinstance(n, ast.NamedExpr):
            bind(n.target, n.value)
        stack.extend(ast.iter_child_nodes(n))
    ints: Set[str] = set()
    changed = True
    while changed:  # a += of a host-int name needs that name settled first
        changed = False
        for name, values in binds.items():
            if name not in ints and all(
                    v is not None and _int_expr(v, ints) for v in values):
                ints.add(name)
                changed = True
    return ints


def _slt001_blocking(node: ast.Call, held_lock: str,
                     host_ints: Set[str] = frozenset()) -> Optional[str]:
    """Why this call must not run under the lock, or None."""
    f = node.func
    if isinstance(f, ast.Name):
        if f.id in ("float", "int") and node.args and isinstance(
                node.args[0], ast.Name) and node.args[0].id in host_ints:
            return None  # a host integer: no device read
        if f.id == "float" and node.args and not isinstance(
                node.args[0], ast.Constant):
            return ("float() on a non-constant forces device->host "
                    "materialization")
        if f.id in ("int", "bool") and node.args and _tensorish(
                node.args[0]):
            return (f"{f.id}() on a tensor forces device->host "
                    f"materialization")
        return None
    if not isinstance(f, ast.Attribute):
        return None
    recv = _unparse(f.value)
    root = _call_root(f)
    if f.attr == "asarray" and root in ("np", "numpy"):
        return "np.asarray is a blocking device->host transfer"
    if f.attr == "synchronize" and root == "torch":
        return "torch.cuda.synchronize() blocks on device completion"
    if f.attr in _D2H_METHODS and not node.args and not node.keywords:
        return _D2H_METHODS[f.attr]
    if f.attr == "sleep" and root == "time":
        return "time.sleep under the lock serializes every other caller"
    if f.attr == "_sleep_d2h":
        return "synthetic D2H delay under the lock"
    if f.attr in ("result", "join"):
        return f".{f.attr}() blocks under the lock"
    if f.attr in ("wait", "wait_for") and recv != held_lock:
        return (f".{f.attr}() on {recv!r} blocks while holding "
                f"{held_lock!r}")
    if root in ("requests", "urllib", "http") or f.attr == "getresponse":
        return "network IO under the lock"
    return None


class _Slt001Visitor(ast.NodeVisitor):
    def __init__(self, src: Src) -> None:
        self.src = src
        self.findings: List[Finding] = []
        self._class: List[str] = []
        self._held: List[str] = []
        self._legacy = 0  # depth of explicitly-gated overlap-off branches
        self._ints: List[Set[str]] = [set()]  # host-int names, per scope

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def _visit_with(self, node: Any) -> None:
        locks = [n for n in (_lock_expr_name(i.context_expr)
                             for i in node.items) if n is not None]
        exempt = bool(self._class) and self._class[-1] in _D2H_LATCH_CLASSES
        if locks and not exempt:
            self._held.extend(locks)
            self.generic_visit(node)
            del self._held[len(self._held) - len(locks):]
        else:
            self.generic_visit(node)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_If(self, node: ast.If) -> None:
        gate = _is_overlap_gate(node.test)
        for field, stmts in (("body", node.body), ("orelse", node.orelse)):
            legacy = (gate is True and field == "body") or (
                gate is False and field == "orelse")
            if legacy:
                self._legacy += 1
            for s in stmts:
                self.visit(s)
            if legacy:
                self._legacy -= 1
        self.visit(node.test)

    def _skip_nested_def(self, node: Any) -> None:
        # a def under a with-lock doesn't run there; analyze it lock-free
        held, self._held = self._held, []
        legacy, self._legacy = self._legacy, 0
        self._ints.append(_host_int_names(node))
        self.generic_visit(node)
        self._ints.pop()
        self._held, self._legacy = held, legacy

    visit_FunctionDef = _skip_nested_def
    visit_AsyncFunctionDef = _skip_nested_def
    visit_Lambda = _skip_nested_def

    def visit_Call(self, node: ast.Call) -> None:
        if self._held and not self._legacy:
            why = _slt001_blocking(node, self._held[-1], self._ints[-1])
            if why is not None:
                self.findings.append(Finding(
                    "SLT001", self.src.path, node.lineno,
                    f"{why} (inside `with {self._held[-1]}:`)"))
        self.generic_visit(node)


def check_slt001(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "transport"):
        return
    v = _Slt001Visitor(src)
    v.visit(src.tree)
    yield from v.findings


# ---------------------------------------------------------------------- #
# SLT002: replay claims paired on every path
# ---------------------------------------------------------------------- #

def _is_replay_recv(expr: ast.expr) -> bool:
    return "replay" in _unparse(expr)


def _begin_claim(stmt: ast.stmt) -> Optional[str]:
    """'entry, owner = <replay>.begin(...)' -> 'entry'."""
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        return None
    value = stmt.value
    if not (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "begin"
            and _is_replay_recv(value.func.value)):
        return None
    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
    if not targets:
        return None
    t = targets[0]
    if isinstance(t, ast.Tuple) and t.elts and isinstance(t.elts[0], ast.Name):
        return t.elts[0].id
    if isinstance(t, ast.Name):
        return t.id
    return None


def _barrier_scan_roots(stmt: ast.stmt) -> List[ast.AST]:
    """What actually executes *at* a CFG node: compound statements only
    evaluate their header there (bodies are separate nodes), and a
    def/class statement executes nothing from its body at all."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.ExceptHandler):
        return [stmt.type] if stmt.type is not None else []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def _is_barrier(stmt: Optional[ast.stmt]) -> bool:
    if stmt is None:
        return False
    for root in _barrier_scan_roots(stmt):
        if _scan_barrier_calls(root):
            return True
    return False


def _scan_barrier_calls(root: ast.AST) -> bool:
    for node in ast.walk(root):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("resolve", "fail", "wait")
                and _is_replay_recv(node.func.value)):
            return True
    return False


def _claim_branch_infeasible(cond: Any, claim: str) -> bool:
    """Prune '<claim> is None' edges: on the analyzed paths the claim
    exists (a None claim is, by construction, not a claim)."""
    if not (isinstance(cond, tuple) and cond and cond[0] == "branch"):
        return False
    _tag, test, taken = cond
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Name) and test.left.id == claim
            and len(test.comparators) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        if isinstance(test.ops[0], ast.Is):
            return taken is True       # 'claim is None' branch: impossible
        if isinstance(test.ops[0], ast.IsNot):
            return taken is False      # skipping 'claim is not None': imp.
    return False


def _leak_path_exists(graph: cfg_mod.CFG, begin_node: cfg_mod.Node,
                      claim: str) -> bool:
    seen: Set[int] = set()
    # follow only normal flow out of begin itself: if begin() raises,
    # no claim was made
    frontier = [t for t, c in begin_node.succs
                if not (isinstance(c, tuple) and c and c[0] == "exc")]
    while frontier:
        node = frontier.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if node is graph.exit:
            return True
        barrier = _is_barrier(node.stmt)
        for target, cond in node.succs:
            if barrier and not (isinstance(cond, tuple) and cond
                                and cond[0] == "exc"):
                continue  # barrier absorbs normal flow; exc may escape it
            if _claim_branch_infeasible(cond, claim):
                continue
            frontier.append(target)
    return False


def check_slt002(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "transport"):
        return
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        begins = [(s, c) for s in ast.walk(fn)
                  if isinstance(s, ast.stmt)
                  and (c := _begin_claim(s)) is not None]
        if not begins:
            continue
        graph = cfg_mod.build(fn)
        for stmt, claim in begins:
            for node in graph.nodes_for(stmt):
                if _leak_path_exists(graph, node, claim):
                    yield Finding(
                        "SLT002", src.path, stmt.lineno,
                        f"claim {claim!r} from replay begin() can reach "
                        f"exit of {fn.name}() without resolve()/fail()/"
                        f"wait() on some path")
                    break


# ---------------------------------------------------------------------- #
# SLT003: span names come from obs/spans.py
# ---------------------------------------------------------------------- #

_SPAN_SINKS = ("record", "record_span", "observe")


def check_slt003(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "transport", "obs"):
        return
    if _ends(src, "obs/spans.py"):
        return  # the registry itself is the one legal home of literals
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SPAN_SINKS and node.args):
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            yield Finding(
                "SLT003", src.path, node.lineno,
                f"span/metric name {first.value!r} passed to "
                f".{node.func.attr}() as a string literal — use the "
                f"obs/spans.py constant so taxonomies cannot drift")


# ---------------------------------------------------------------------- #
# SLT004: wire-path determinism
# ---------------------------------------------------------------------- #

_NONDET_IMPORTS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "rand", "randn", "default_rng",
}


# torch's draws from the process-global generator (unless given one)
_TORCH_GLOBAL_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson"})


def check_slt004(src: Src) -> Iterator[Finding]:
    if not (_ends(src, "transport/chaos.py", "transport/codec.py",
                  "transport/density.py", "native/codec.py",
                  "runtime/breaker.py")
            or _in_dir(src, "ops")):
        return
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "random", "numpy.random"):
            bad = [a.name for a in node.names if a.name in _NONDET_IMPORTS]
            if bad:
                yield Finding(
                    "SLT004", src.path, node.lineno,
                    f"import of module-global RNG symbol(s) {bad} from "
                    f"{node.module} — draw from an injectable seeded "
                    f"generator instead")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        root = _call_root(f)
        recv = _unparse(f.value)
        if recv == "random":
            if f.attr in ("Random", "SystemRandom"):
                if f.attr == "SystemRandom" or not node.args:
                    yield Finding(
                        "SLT004", src.path, node.lineno,
                        f"random.{f.attr}({'' if not node.args else '...'})"
                        f" is not reproducible — seed it explicitly")
            else:
                yield Finding(
                    "SLT004", src.path, node.lineno,
                    f"random.{f.attr}() draws from the module-global RNG "
                    f"— chaos/codec schedules must be pure functions of "
                    f"(seed, path, step, attempt)")
        elif recv in ("np.random", "numpy.random"):
            if f.attr in ("RandomState", "default_rng"):
                if not node.args:
                    yield Finding(
                        "SLT004", src.path, node.lineno,
                        f"{recv}.{f.attr}() without a seed is "
                        f"nondeterministic — pass one")
            else:
                yield Finding(
                    "SLT004", src.path, node.lineno,
                    f"{recv}.{f.attr}() draws from numpy's module-global "
                    f"RNG — use a seeded RandomState/Generator")
        elif root == "torch" and f.attr in _TORCH_GLOBAL_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            yield Finding(
                "SLT004", src.path, node.lineno,
                f"torch.{f.attr}() without generator= draws from torch's "
                f"module-global RNG -- pass a seeded torch.Generator")
        elif root == "torch" and f.attr == "manual_seed":
            yield Finding(
                "SLT004", src.path, node.lineno,
                "torch.manual_seed() reseeds the process-global RNG -- "
                "seed a torch.Generator of your own instead")
        elif root == "time" and f.attr in ("time", "time_ns"):
            yield Finding(
                "SLT004", src.path, node.lineno,
                f"time.{f.attr}() makes the wire path depend on the wall "
                f"clock — use step/attempt counters (time.sleep and "
                f"perf_counter/monotonic for measurement are fine)")


# ---------------------------------------------------------------------- #
# SLT005: the static lock-acquisition graph is acyclic
# ---------------------------------------------------------------------- #

class _MethodLocks(ast.NodeVisitor):
    """Per-method: directly acquired self-locks + called self-methods,
    each recorded with the lock names held at that point."""

    def __init__(self) -> None:
        self.acquires: List[Tuple[str, List[str], int]] = []
        self.calls: List[Tuple[str, List[str], int]] = []
        self._held: List[str] = []

    def _visit_with(self, node: Any) -> None:
        names = [n for n in (_lock_expr_name(i.context_expr)
                             for i in node.items) if n is not None]
        for n in names:
            self.acquires.append((n, list(self._held), node.lineno))
            self._held.append(n)
        self.generic_visit(node)
        if names:
            del self._held[len(self._held) - len(names):]

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self"):
            self.calls.append((f.attr, list(self._held), node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs execute elsewhere

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _canon(cls: Optional[str], lock: str, modstem: str) -> str:
    owner = cls if cls is not None else modstem
    return f"{owner}.{lock.replace('self.', '')}"


def check_slt005(src: Src) -> Iterator[Finding]:
    modstem = src.posix.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    # edges: (outer, inner) -> line of the witnessing acquisition
    edges: Dict[Tuple[str, str], int] = {}

    def scan_class(cls: ast.ClassDef) -> None:
        methods: Dict[str, _MethodLocks] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ml = _MethodLocks()
                for s in item.body:
                    ml.visit(s)
                methods[item.name] = ml
        # fixpoint: every lock a method can (transitively) acquire
        reach: Dict[str, Set[str]] = {
            name: {a for a, _h, _l in ml.acquires}
            for name, ml in methods.items()}
        changed = True
        while changed:
            changed = False
            for name, ml in methods.items():
                for callee, _held, _line in ml.calls:
                    if callee in reach and not reach[callee] <= reach[name]:
                        reach[name] |= reach[callee]
                        changed = True
        for name, ml in methods.items():
            for lock, held, line in ml.acquires:
                for outer in held:
                    if outer != lock:
                        edges.setdefault(
                            (_canon(cls.name, outer, modstem),
                             _canon(cls.name, lock, modstem)), line)
            for callee, held, line in ml.calls:
                if callee not in reach or not held:
                    continue
                for inner in reach[callee]:
                    for outer in held:
                        if outer != inner:
                            edges.setdefault(
                                (_canon(cls.name, outer, modstem),
                                 _canon(cls.name, inner, modstem)), line)

    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef):
            scan_class(node)

    # module-level functions: nested withs only
    for node in src.tree.body if isinstance(src.tree, ast.Module) else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ml = _MethodLocks()
            for s in node.body:
                ml.visit(s)
            for lock, held, line in ml.acquires:
                for outer in held:
                    if outer != lock:
                        edges.setdefault((_canon(None, outer, modstem),
                                          _canon(None, lock, modstem)), line)

    # cycle detection (within-file graph; the cross-object runtime graph
    # is the watchdog's job — obs/locks.py)
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    def dfs(n: str, stack: List[str]) -> Optional[List[str]]:
        color[n] = GRAY
        stack.append(n)
        for m in adj.get(n, []):
            if color.get(m, WHITE) == GRAY:
                return stack[stack.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                cyc = dfs(m, stack)
                if cyc is not None:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in list(adj):
        if color.get(n, WHITE) == WHITE:
            cyc = dfs(n, [])
            if cyc is not None:
                line = min(edges.get((a, b), 1)
                           for a, b in zip(cyc, cyc[1:]))
                yield Finding(
                    "SLT005", src.path, line,
                    f"lock-order cycle: {' -> '.join(cyc)} — two threads "
                    f"taking these in opposite orders deadlock")
                return


# ---------------------------------------------------------------------- #
# SLT011: condition wait() guarded by a while-predicate loop
# ---------------------------------------------------------------------- #

_CONDISH = ("cond", "condition", "cv")


def _is_condish_name(name: str) -> bool:
    base = name.rsplit(".", 1)[-1].lstrip("_")
    return any(tok in base for tok in _CONDISH)


class _Slt011Visitor(ast.NodeVisitor):
    """Flags ``<cond>.wait(...)`` not lexically enclosed by a ``while``
    in the same function. A bare or if-guarded wait returns on ANY
    notify (or a spurious/timeout wake) with the predicate unchecked —
    the lost-wakeup / stolen-wakeup shape slt-check explores
    dynamically; this is its static twin. ``wait_for`` is exempt (it
    loops internally)."""

    def __init__(self, src: Src) -> None:
        self.src = src
        self.findings: List[Finding] = []
        self._while = 0

    def visit_While(self, node: ast.While) -> None:
        self._while += 1
        self.generic_visit(node)
        self._while -= 1

    def _nested_def(self, node: Any) -> None:
        # a nested def's waits run in their own frame: restart tracking
        saved, self._while = self._while, 0
        self.generic_visit(node)
        self._while = saved

    visit_FunctionDef = _nested_def
    visit_AsyncFunctionDef = _nested_def
    visit_Lambda = _nested_def

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "wait"
                and _is_condish_name(_unparse(f.value))
                and self._while == 0):
            self.findings.append(Finding(
                "SLT011", self.src.path, node.lineno,
                f"{_unparse(f.value)}.wait() outside a while-predicate "
                f"loop — a notify meant for another waiter (or a timeout "
                f"wake) returns with the predicate still false; loop "
                f"`while not pred: cond.wait()` or use wait_for()"))
        self.generic_visit(node)


def check_slt011(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "transport"):
        return
    v = _Slt011Visitor(src)
    v.visit(src.tree)
    yield from v.findings


# ---------------------------------------------------------------------- #
# SLT012: server params reads happen under the apply lock / flush barrier
# ---------------------------------------------------------------------- #

# the sanctioned readers: methods whose whole job is to drain the
# deferred-apply queue and hand out post-flush state — they take the
# lock themselves, and scoping the rule to everything else keeps the
# finding message honest ("hold the lock or go through the barrier")
_FLUSH_BARRIER_METHODS = frozenset({"export_state", "flush_deferred"})

# the composable party core (runtime/party.py) and its public thin
# configurations — a subclass inherits the deferred queue and the mesh
# seams from the base even when its own body never names them, so the
# runtime rules scope by inheritance, not by per-class attribute
# sightings
_PARTY_CORE_BASES = frozenset(
    {"PartyRuntime", "ServerRuntime", "StageRuntime"})


def _is_party_subclass(cls: ast.ClassDef) -> bool:
    """True when the class derives (textually) from the party core or
    one of its public configurations."""
    for b in cls.bases:
        name = (b.id if isinstance(b, ast.Name)
                else b.attr if isinstance(b, ast.Attribute) else None)
        if name in _PARTY_CORE_BASES:
            return True
    return False


def _mentions_deferred(cls: ast.ClassDef) -> bool:
    """Does this class own a deferred-apply queue (``self._deferred``)?
    Classes without one have no stale-params hazard: ``self.state`` is
    only ever advanced synchronously under the caller's own dispatch."""
    return any(isinstance(n, ast.Attribute) and n.attr == "_deferred"
               for n in ast.walk(cls))


def _is_state_params_read(node: ast.Attribute) -> bool:
    """Exactly the ``self.state.params`` chain (loads and deeper
    subscripts both end at this Attribute)."""
    if node.attr != "params":
        return False
    v = node.value
    return (isinstance(v, ast.Attribute) and v.attr == "state"
            and isinstance(v.value, ast.Name) and v.value.id == "self")


class _Slt012Visitor(ast.NodeVisitor):
    """Within a deferred-apply-owning class: flag ``self.state.params``
    reads made with no self-lock held, outside the flush-barrier
    methods. With ``--decouple-bwd`` the queue may hold up to
    ``apply_lag`` pending weight updates, so such a read silently
    observes stale params — and worse, races the drain's
    ``self.state = ...`` writes."""

    def __init__(self, src: Src) -> None:
        self.src = src
        self.findings: List[Finding] = []
        self._held = 0
        self._barrier = 0

    def _visit_with(self, node: Any) -> None:
        locks = [n for n in (_lock_expr_name(i.context_expr)
                             for i in node.items) if n is not None]
        self._held += len(locks)
        self.generic_visit(node)
        self._held -= len(locks)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_def(self, node: Any) -> None:
        # a def under a with-lock doesn't run there (same reasoning as
        # SLT001); barrier status is keyed on the method's own name
        barrier = getattr(node, "name", "") in _FLUSH_BARRIER_METHODS
        held, self._held = self._held, 0
        if barrier:
            self._barrier += 1
        self.generic_visit(node)
        if barrier:
            self._barrier -= 1
        self._held = held

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def
    visit_Lambda = _visit_def

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (_is_state_params_read(node) and not self._held
                and not self._barrier):
            self.findings.append(Finding(
                "SLT012", self.src.path, node.lineno,
                "self.state.params read without the apply lock on a "
                "deferred-apply runtime — with --decouple-bwd up to "
                "apply_lag weight updates may still be queued, so this "
                "read observes stale params (and races the drain's "
                "state writes); hold the lock, or read via "
                "export_state()/flush_deferred()"))
        self.generic_visit(node)


def check_slt012(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime"):
        return
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef) and (
                _mentions_deferred(node) or _is_party_subclass(node)):
            v = _Slt012Visitor(src)
            for item in node.body:
                v.visit(item)
            yield from v.findings


# ---------------------------------------------------------------------- #
# SLT013: mesh-sharded program outputs cross D2H through the sanctioned
# gather helper, never a raw np.asarray / .cpu() / .numpy()
# ---------------------------------------------------------------------- #

def _mentions_mesh(cls: ast.ClassDef) -> bool:
    """Does this class run on a (possibly) mesh-sharded runtime? Keyed
    on the attributes the sharded server actually grows (``self._mesh``,
    or a ``_host_gather`` routing method/call) — single-device classes
    (the client half, the fused trainer) have no sharded outputs and
    stay out of scope."""
    return any(isinstance(n, ast.Attribute)
               and n.attr in ("_mesh", "_host_gather")
               for n in ast.walk(cls))


def _is_expected_d2h_cm(expr: ast.expr) -> bool:
    """``obs_dispatch.expected_d2h(...)``-shaped context expr — the
    watchdog marker that brackets exactly the program-output D2H sites."""
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "expected_d2h")


def _slt013_raw_gather(node: ast.Call) -> Optional[str]:
    """The offending call's rendering, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        root = _call_root(f)
        if root in ("np", "numpy") and f.attr in ("asarray", "array"):
            return f"np.{f.attr}(...)"
        if (f.attr in ("cpu", "numpy", "tolist", "item")
                and not node.args and not node.keywords):
            return f".{f.attr}()"
    return None


class _Slt013Visitor(ast.NodeVisitor):
    """Within a mesh-aware runtime class: flag raw full-value transfers
    inside ``expected_d2h`` blocks. On a sharded server those values are
    mesh-sharded program outputs, and ``np.asarray`` on one gathers EVERY
    replica/shard -- including a padded group's zero-weight tail -- onto
    the host on the hot path. The sanctioned seam
    (``self._host_gather``, ``runtime/party.py``) reads only the rows
    the caller needs and counts the bytes."""

    def __init__(self, src: Src) -> None:
        self.src = src
        self.findings: List[Finding] = []
        self._d2h_depth = 0

    def _visit_with(self, node: Any) -> None:
        marked = sum(1 for i in node.items
                     if _is_expected_d2h_cm(i.context_expr))
        self._d2h_depth += marked
        self.generic_visit(node)
        self._d2h_depth -= marked

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_def(self, node: Any) -> None:
        # nested defs execute later, outside this with-block (the SLT001
        # scoping argument)
        depth, self._d2h_depth = self._d2h_depth, 0
        self.generic_visit(node)
        self._d2h_depth = depth

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def
    visit_Lambda = _visit_def

    def visit_Call(self, node: ast.Call) -> None:
        if self._d2h_depth:
            what = _slt013_raw_gather(node)
            if what is not None:
                self.findings.append(Finding(
                    "SLT013", self.src.path, node.lineno,
                    f"{what} on a mesh-sharded program output — a raw "
                    "transfer gathers every shard (padding included) to "
                    "host on the hot path; route it through the "
                    "sanctioned gather (self._host_gather, "
                    "runtime/party.py)"))
        self.generic_visit(node)


def check_slt013(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime"):
        return
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef) and (
                _mentions_mesh(node) or _is_party_subclass(node)):
            v = _Slt013Visitor(src)
            for item in node.body:
                v.visit(item)
            yield from v.findings


# ---------------------------------------------------------------------- #
# SLT014: persistence discipline — runtime/ writes are crash-atomic
# (tmp-write+rename), and every exporter-written field has a
# restorer that consumes it
# ---------------------------------------------------------------------- #

def _open_write_mode(node: ast.Call) -> Optional[str]:
    """The mode string of a write-mode builtin ``open()`` call, else
    None (read modes and non-constant modes pass)."""
    if not (isinstance(node.func, ast.Name) and node.func.id == "open"):
        return None
    mode: Optional[str] = None
    if (len(node.args) >= 2 and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)):
        mode = node.args[1].value
    for kw in node.keywords:
        if (kw.arg == "mode" and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)):
            mode = kw.value.value
    if mode is not None and any(c in mode for c in "wax+"):
        return mode
    return None


def _scope_renames(node: ast.AST) -> bool:
    """Does this function/class body contain an ``os.replace``-style
    atomic publish? Its presence marks the tmp-write+rename idiom."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("replace", "rename")):
            return True
    return False


class _Slt014Visitor(ast.NodeVisitor):
    """Flags in-place durable writes inside runtime/: a bare write-mode
    ``open()`` whose enclosing function or class never renames (a crash
    mid-write leaves a torn file under the FINAL name -- the exact bug
    class slt-crash's DurableStore models worst-case), and the
    path-taking serializers (np.save/pickle.dump, and torch.save in a
    scope that never renames). Checkpoint state goes through the
    tmp-write+fsync+rename writers of runtime/checkpoint.py."""

    def __init__(self, src: Src) -> None:
        self.src = src
        self.findings: List[Finding] = []
        self._scopes: List[ast.AST] = []

    def _visit_scope(self, node: Any) -> None:
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    visit_ClassDef = _visit_scope
    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope

    def visit_Call(self, node: ast.Call) -> None:
        mode = _open_write_mode(node)
        if mode is not None and not any(_scope_renames(s)
                                        for s in self._scopes):
            self.findings.append(Finding(
                "SLT014", self.src.path, node.lineno,
                f"open(..., {mode!r}) writes a durable file in place — "
                f"a crash mid-write leaves a torn file under the final "
                f"name; write to a .tmp sibling and os.replace() it"))
        f = node.func
        if isinstance(f, ast.Attribute):
            root = _call_root(f)
            if ((root in ("np", "numpy")
                 and f.attr in ("save", "savez", "savez_compressed"))
                    or (root == "pickle" and f.attr == "dump")
                    or (root == "torch" and f.attr == "save"
                        and not any(_scope_renames(s)
                                    for s in self._scopes))):
                self.findings.append(Finding(
                    "SLT014", self.src.path, node.lineno,
                    f"{root}.{f.attr}() serializes straight onto its "
                    f"target path -- not crash-atomic; stage through a "
                    f".tmp + os.replace()"))
        self.generic_visit(node)


def check_slt014(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime"):
        return
    v = _Slt014Visitor(src)
    v.visit(src.tree)
    yield from v.findings


def check_slt014_pairing(srcs) -> Iterator[Finding]:
    """Cross-file half (PROJECT_RULES, like SLT010): every literal field
    an exporter writes (``export_*``/``build_extras``/
    ``finalize_extras`` in runtime/ + transport/) must be consumed by
    some restore-side function (``*restore*``/``*resume*``/
    ``*extras*``), and every field a restorer REQUIRES (subscript read)
    must be written by some exporter — an unconsumed field is dead
    checkpoint bytes, an unwritten required field is a KeyError on the
    first real recovery."""
    from split_learning_tpu_torch.analysis import rules_torch as rj
    writes: Dict[str, Tuple[str, int]] = {}
    reads: Set[str] = set()
    hard_reads: Dict[str, Tuple[str, int]] = {}
    for src in srcs:
        if not _in_dir(src, "runtime", "transport"):
            continue
        consts = rj._module_str_consts(src.tree)
        for fn in ast.walk(src.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            exporter = (fn.name.startswith("export")
                        or fn.name in ("build_extras", "finalize_extras",
                                       "state_tree"))
            restorer = any(tok in fn.name
                           for tok in ("restore", "resume", "extras"))
            if exporter:
                for k in rj._fn_writes(fn, consts):
                    writes.setdefault(k, (src.path, fn.lineno))
            if restorer:
                reads |= rj._key_reads(fn, consts)
                for k in rj._key_reads(fn, consts, hard_only=True):
                    hard_reads.setdefault(k, (src.path, fn.lineno))
                # the port's states mapping: _restore({key: live}, tree)
                # reads tree[key] for every key (a KeyError when absent)
                for n in ast.walk(fn):
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Name)
                            and n.func.id == "_restore" and n.args
                            and isinstance(n.args[0], ast.Dict)):
                        reads |= rj._dict_keys(n.args[0], consts)
    for k, (path, line) in sorted(writes.items()):
        if k not in reads:
            yield Finding(
                "SLT014", path, line,
                f"checkpoint field {k!r} is written by an exporter but "
                f"consumed by no restore path — dead bytes in every "
                f"checkpoint, or a restore that silently drops state")
    for k, (path, line) in sorted(hard_reads.items()):
        if k not in writes:
            yield Finding(
                "SLT014", path, line,
                f"checkpoint field {k!r} is required (subscript read) "
                f"by a restore path but written by no exporter — "
                f"KeyError on the first real recovery")


# ---------------------------------------------------------------------- #
# SLT015: flight-recorder event names come from the spans.py registry
# ---------------------------------------------------------------------- #

# receivers the runtime actually binds the recorder to; "fl" is the
# conventional local (`fl = obs_flight.get_recorder()`), and anything
# ending in "flight" catches module-level aliases
_FLIGHT_RECEIVERS = ("fl", "flight")


_SPANS_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "obs", "spans.py")


def _flight_registry() -> Set[str]:
    """Constant names of the FL_* registry, read off obs/spans.py by
    parsing it (no import: analysis stays stdlib-only), so the rule can
    never drift from it."""
    with open(_SPANS_PY, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out: Set[str] = set()
    for n in tree.body:
        targets = (n.targets if isinstance(n, ast.Assign)
                   else [n.target] if isinstance(n, ast.AnnAssign) else [])
        for t in targets:
            if isinstance(t, ast.Name) and t.id.startswith("FL_"):
                out.add(t.id)
    return out


def _is_registered_name(expr: ast.expr, registered: Set[str]) -> bool:
    if isinstance(expr, ast.Attribute):
        return expr.attr in registered
    return isinstance(expr, ast.Name) and expr.id in registered


def _param_fed_registered(src: Src, name: str, call: ast.Call,
                          registered: Set[str]) -> bool:
    """Is ``name`` a parameter of the function around ``call`` that every
    call site of that function in the file passes a registered ``FL_*``
    constant (a forwarding helper such as a hop's ``_hop_flight``)?"""
    fn = None
    for f in ast.walk(src.tree):
        if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                n is call for n in ast.walk(f)):
            fn = f  # ast.walk is breadth-first: the last hit is innermost
    if fn is None:
        return False
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    kwonly = [a.arg for a in fn.args.kwonlyargs]
    if name not in params and name not in kwonly:
        return False
    pos = params.index(name) if name in params else None
    sites = 0
    for n in ast.walk(src.tree):
        if not isinstance(n, ast.Call):
            continue
        callee = (n.func.id if isinstance(n.func, ast.Name)
                  else n.func.attr if isinstance(n.func, ast.Attribute)
                  else None)
        if callee != fn.name:
            continue
        passed = [k.value for k in n.keywords if k.arg == name]
        if not passed and pos is not None and pos < len(n.args):
            passed = [n.args[pos]]
        if not (passed and _is_registered_name(passed[0], registered)):
            return False
        sites += 1
    return sites > 0


def check_slt015(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "transport", "obs", "launch"):
        return
    if _ends(src, "obs/spans.py", "obs/flight.py"):
        return  # the registry itself and the recorder's own machinery
    registered = None  # resolved lazily: most files have no flight calls
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "record" and node.args):
            continue
        last = _unparse(node.func.value).rsplit(".", 1)[-1].lstrip("_")
        if not (last in _FLIGHT_RECEIVERS or last.endswith("flight")):
            continue  # a tracer/registry .record() — SLT003's turf
        if registered is None:
            registered = _flight_registry()
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            yield Finding(
                "SLT015", src.path, node.lineno,
                f"flight event name {first.value!r} passed to .record() "
                f"as a string literal — use the obs/spans.py FL_* "
                f"constant so the postmortem taxonomy cannot drift")
        elif isinstance(first, ast.Attribute) \
                and first.attr not in registered:
            yield Finding(
                "SLT015", src.path, node.lineno,
                f"flight event name {_unparse(first)} is not a "
                f"registered obs/spans.py FL_* constant")
        elif isinstance(first, ast.Name) and first.id not in registered \
                and not _param_fed_registered(src, first.id, node,
                                              registered):
            yield Finding(
                "SLT015", src.path, node.lineno,
                f"flight event name {first.id!r} is not a registered "
                f"obs/spans.py FL_* constant")


# ---------------------------------------------------------------------- #

RULES = {
    "SLT001": (check_slt001,
               "no D2H / blocking IO under the runtime or coalescer lock"),
    "SLT002": (check_slt002,
               "replay begin() claims reach resolve()/fail()/wait() on "
               "every exit path"),
    "SLT003": (check_slt003,
               "span/metric names come from obs/spans.py, never literals"),
    "SLT004": (check_slt004,
               "chaos/codec/ops/breaker stay deterministic: no global "
               "RNG, no unseeded RNG, no wall clock"),
    "SLT005": (check_slt005,
               "the static nested-lock-acquisition graph is acyclic"),
    "SLT011": (check_slt011,
               "condition wait() sits inside a while-predicate loop "
               "(or uses wait_for)"),
    "SLT012": (check_slt012,
               "self.state.params reads on a deferred-apply runtime "
               "hold the apply lock or go through the flush barrier"),
    "SLT013": (check_slt013,
               "mesh-sharded program outputs cross D2H through the "
               "sanctioned _host_gather, never a raw np.asarray/"
               ".cpu()/.numpy()/.tolist()/.item()"),
    "SLT014": (check_slt014,
               "runtime/ persistence is crash-atomic: tmp-write+rename, "
               "never in-place writes"),
    "SLT015": (check_slt015,
               "flight-recorder event names come from the obs/spans.py "
               "FL_* registry, never literals or unregistered names"),
}


def run_rules(src: Src) -> List[Finding]:
    out: List[Finding] = []
    for _rule_id, (fn, _doc) in sorted(RULES.items()):
        out.extend(fn(src))
    return out


# The framework rules live in their own module; the import sits at the
# bottom because rules_torch needs Finding/Src and the shared helpers.
from split_learning_tpu_torch.analysis import rules_torch as _rules_torch  # noqa: E402,E501

RULES.update(_rules_torch.RULES)

# Project rules see every parsed file at once (cross-file pairing);
# the engine runs them after the per-file loop. SLT014's cross-file
# half (exporter/restorer field pairing) rides beside SLT010 here.
PROJECT_RULES = dict(_rules_torch.PROJECT_RULES)
PROJECT_RULES["SLT014"] = (
    check_slt014_pairing,
    "persistence contract: exporter-written checkpoint fields pair "
    "with restore-side consumers across runtime/ + transport/")


def run_project_rules(srcs) -> List[Finding]:
    out: List[Finding] = []
    for _rule_id, (fn, _doc) in sorted(PROJECT_RULES.items()):
        out.extend(fn(srcs))
    return out
