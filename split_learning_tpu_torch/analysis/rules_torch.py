"""slt-lint's framework rules for PyTorch (SLT006-010), the counterpart
of ``split_learning_tpu/analysis/rules_jax.py``.

rules.py guards the concurrency invariants; these five guard the
dispatch discipline of the card's hot path -- the hazards that turn into
silently wrong numbers or silent host stalls instead of exceptions.
Each keeps its JAX rule id and the intent of the JAX hazard:

========  ==============================================================
SLT006    stale read after an in-place update (JAX: use-after-donate) --
          a name bound before ``fused_sgd_step`` (K2),
          ``torch._foreach_*_``, an optimizer's ``update``/``step``, to
          a leaf that call updates in place, read after it: the buffer
          now holds the updated values, as a donated buffer is dead
SLT007    capture hazards (JAX: retrace hazards) -- a ``torch.compile``,
          ``torch.jit.trace``/``script`` or ``torch.cuda.graph`` capture
          whose callable or body closes over mutable ``self``
          attributes (frozen into the captured program), and differing
          Python literals at a compiled callable's argument across call
          sites (each one a guard failure and a recompile)
SLT008    implicit host sync (JAX: same) -- ``bool()``/``if``/``while``
          on a device result always blocks; ``float()``/``int()``/
          ``.item()`` on one result of a device dispatch *before* the
          bulk host copy of another result of the same dispatch
          serializes the transfer twice
SLT009    generator discipline (JAX: PRNG key reuse) -- two
          ``manual_seed`` calls from one expression give two identical
          streams; a generator re-seeded inside the loop that draws from
          it restarts the same stream every iteration
SLT010    wire-schema contract (project-scope, as JAX's) -- codec
          encode/decode field sets, client/server HTTP payload keys, the
          ctypes bindings of ``native/codec.py`` against the
          ``extern "C"`` exports of ``native/slt_codec.cc``, and the
          bindings of ``ops/*.py`` through ``ops/common.py``
          ``load_kernels`` against the exports of ``csrc/*.cu``
========  ==============================================================

A "device dispatch" (SLT008) is a call to a kernel wrapper the file
imports from the port's ``ops`` package, a compiled callable
(SLT007's registry), ``torch.autograd.grad``, or a ``torch.*`` call
that returns a tensor; its results live on the card.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from split_learning_tpu_torch.analysis import cfg as cfg_mod
from split_learning_tpu_torch.analysis.rules import (Finding, Src,
                                                     _barrier_scan_roots,
                                                     _call_root, _in_dir,
                                                     _unparse)


# ---------------------------------------------------------------------- #
# shared statement helpers (JAX's)
# ---------------------------------------------------------------------- #

def _own_stmts(fn: ast.AST) -> Iterator[ast.stmt]:
    """Statements of ``fn`` excluding bodies of nested defs/lambdas --
    those execute in their own frame, not here."""
    stack: List[ast.stmt] = list(fn.body)
    while stack:
        s = stack.pop(0)
        yield s
        for child in ast.iter_child_nodes(s):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.stmt):
                stack.append(child)
            else:
                stack.extend(c for c in ast.walk(child)
                             if isinstance(c, ast.stmt))
    return


def _target_names(t: ast.expr) -> Set[str]:
    """Bound names of an assignment target: bare names and self-attr
    chains (``self.state``); tuple/starred targets flatten."""
    if isinstance(t, ast.Name):
        return {t.id}
    if isinstance(t, ast.Attribute):
        return {_unparse(t)}
    if isinstance(t, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in t.elts:
            out |= _target_names(e)
        return out
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    return set()


def _stmt_binds(stmt: ast.stmt) -> Set[str]:
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items
                   if i.optional_vars is not None]
    out: Set[str] = set()
    for t in targets:
        out |= _target_names(t)
    return out


def _reads_name(root: ast.AST, name: str) -> bool:
    for n in ast.walk(root):
        if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id == name):
            return True
        if (isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)
                and _unparse(n) == name):
            return True
    return False



# ---------------------------------------------------------------------- #
# SLT006: stale read after an in-place update
# ---------------------------------------------------------------------- #

# in-place updaters: callee (last name) -> positions of the updated args
_INPLACE_FUNCS = {"fused_sgd_step": (0, 2), "sgd_step_cuda": (0, 2),
                  "sgd_step_plain": (0, 2)}
# calls that hand out a view of their receiver (or, for the builtins
# and leaves_of, of their argument): the result aliases the leaf
_VIEW_METHODS = frozenset({"detach", "view", "view_as", "reshape",
                           "flatten", "squeeze", "unsqueeze", "expand",
                           "narrow", "t", "transpose", "permute",
                           "values", "items"})
_VIEW_FUNCS = frozenset({"list", "tuple", "leaves_of", "dict"})


def _inplace_targets(call: ast.Call) -> List[str]:
    """The expressions a call updates in place, rendered: the leaves of
    ``fused_sgd_step`` (K2) and its momentum trace, the first argument
    of ``torch._foreach_<op>_``, the state of an optimizer's
    ``update(state, grads)``, and the ``param_groups`` of an
    optimizer's ``step()``."""
    f = call.func
    name = (f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else None)
    out: List[str] = []
    if name in _INPLACE_FUNCS:
        out = [_unparse(call.args[i]) for i in _INPLACE_FUNCS[name]
               if i < len(call.args)]
    elif (isinstance(f, ast.Attribute) and _call_root(f) == "torch"
          and f.attr.startswith("_foreach_") and f.attr.endswith("_")
          and call.args):
        out = [_unparse(call.args[0])]
    elif isinstance(f, ast.Attribute):
        recv = _unparse(f.value).rsplit(".", 1)[-1].lstrip("_")
        if f.attr == "update" and recv in ("tx", "opt", "optimizer") \
                and call.args:
            out = [_unparse(call.args[0])]
        elif f.attr == "step" and recv in ("opt", "optimizer") \
                and not call.args:
            out = [f"{_unparse(f.value)}.param_groups"]
    return [o for o in out if o not in ("None", "[]", "()")]


def _aliases_of(rhs: ast.expr, target: str) -> bool:
    """Does ``rhs`` hand out a view of ``target`` or of a leaf under it
    (an attribute/subscript chain, a tuple or list of such, a view
    method, ``list()``/``leaves_of()``) rather than a computed value or
    a copy?"""
    if isinstance(rhs, (ast.Name, ast.Attribute, ast.Subscript)):
        txt = _unparse(rhs)
        return txt == target or txt.startswith((target + ".",
                                                target + "["))
    if isinstance(rhs, (ast.Tuple, ast.List)):
        return any(_aliases_of(e, target) for e in rhs.elts)
    if isinstance(rhs, (ast.ListComp, ast.GeneratorExp)):
        return (any(_aliases_of(g.iter, target) for g in rhs.generators)
                and isinstance(rhs.elt, (ast.Name, ast.Subscript,
                                         ast.Attribute)))
    if isinstance(rhs, ast.Call):
        f = rhs.func
        if isinstance(f, ast.Attribute) and f.attr in _VIEW_METHODS:
            return _aliases_of(f.value, target)
        if isinstance(f, ast.Name) and f.id in _VIEW_FUNCS and rhs.args:
            return _aliases_of(rhs.args[0], target)
    return False


def check_slt006(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "parallel", "ops", "models"):
        return
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stmts = sorted(_own_stmts(fn),
                       key=lambda s: (s.lineno, s.col_offset))
        sites: List[Tuple[ast.stmt, str, List[str]]] = []
        for stmt in stmts:
            for root in _barrier_scan_roots(stmt):
                for n in ast.walk(root):
                    if isinstance(n, ast.Call):
                        tg = _inplace_targets(n)
                        if tg:
                            sites.append((stmt, _unparse(n.func), tg))
        if not sites:
            continue
        graph = None
        for stmt, callee, targets in sites:
            # names bound (before the update) to a view of an updated leaf
            aliases: Dict[str, int] = {}
            for s in stmts:
                if (s.lineno, s.col_offset) >= (stmt.lineno,
                                                stmt.col_offset):
                    break
                if isinstance(s, ast.Assign) and s.value is not None:
                    for b in _stmt_binds(s):
                        if "." in b:
                            continue
                        if any(_aliases_of(s.value, t) for t in targets):
                            aliases[b] = s.lineno
                        else:
                            aliases.pop(b, None)
            if not aliases:
                continue
            if graph is None:
                graph = cfg_mod.build(fn)
            for var, bound in sorted(aliases.items()):
                hit = _first_read_after(graph, stmt, var)
                if hit is not None:
                    yield Finding(
                        "SLT006", src.path, hit,
                        f"{var!r} (bound at line {bound} to a leaf that "
                        f"{callee}() updates in place at line "
                        f"{stmt.lineno}) is read here -- it holds the "
                        f"updated values, not the ones it was bound to; "
                        f"clone() it before the update or read it before")
                    break


def _first_read_after(graph: cfg_mod.CFG, stmt: ast.stmt,
                      var: str) -> Optional[int]:
    """Line of the first reachable read of ``var`` after ``stmt`` on any
    path, or None. A statement that rebinds ``var`` without reading it
    kills the search along that path."""
    seen: Set[int] = set()
    frontier: List[cfg_mod.Node] = []
    for node in graph.nodes_for(stmt):
        # normal flow only out of the donating statement itself: if the
        # call raised, XLA never took ownership of the buffer
        frontier.extend(t for t, c in node.succs
                        if not (isinstance(c, tuple) and c
                                and c[0] == "exc"))
    while frontier:
        node = frontier.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        s = node.stmt
        if s is not None and s is not stmt:
            reads = any(_reads_name(root, var)
                        for root in _barrier_scan_roots(s))
            if not reads and isinstance(s, ast.AugAssign):
                # `var += x` reads the dead buffer even though the
                # target ctx is Store
                reads = var in _target_names(s.target)
            if reads:
                return s.lineno
            if var in _stmt_binds(s):
                continue  # rebound: the name is live again on this path
        frontier.extend(t for t, _c in node.succs)
    return None



# ---------------------------------------------------------------------- #
# SLT007: capture hazards (torch.compile / jit / CUDA graphs)
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class _CaptureSite:
    name: str                       # 'self._step' / bare local name
    fns: List[ast.AST]              # captured FunctionDef/Lambda/With
    line: int


def _is_capture_call(call: ast.Call) -> bool:
    f = call.func
    txt = _unparse(f)
    return txt in ("torch.compile", "torch.jit.trace", "torch.jit.script",
                   "torch.cuda.make_graphed_callables")


def _capture_registry(tree: ast.AST) -> Dict[str, _CaptureSite]:
    """name -> capture site for every ``<target> = torch.compile(fn, ...)``
    (or ``torch.jit.trace``/``script``) in the file, every function
    decorated with one, and every ``with torch.cuda.graph(g):`` body
    (keyed by the graph's name)."""
    local_fns: Dict[str, ast.AST] = {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local_fns.setdefault(n.name, n)
    reg: Dict[str, _CaptureSite] = {}
    for n in ast.walk(tree):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.value, ast.Call)
                and _is_capture_call(n.value)
                and isinstance(n.targets[0], (ast.Name, ast.Attribute))):
            fns: List[ast.AST] = []
            if n.value.args:
                a0 = n.value.args[0]
                if isinstance(a0, ast.Name) and a0.id in local_fns:
                    fns.append(local_fns[a0.id])
                elif isinstance(a0, ast.Lambda):
                    fns.append(a0)
                elif (isinstance(a0, ast.Attribute)
                      and isinstance(a0.value, ast.Name)
                      and a0.value.id == "self" and a0.attr in local_fns):
                    fns.append(local_fns[a0.attr])
            name = _unparse(n.targets[0])
            site = reg.setdefault(name, _CaptureSite(name, [], n.lineno))
            site.fns.extend(f for f in fns if f not in site.fns)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in n.decorator_list:
                call = d if isinstance(d, ast.Call) else None
                txt = _unparse(call.func if call is not None else d)
                if txt in ("torch.compile", "torch.jit.script"):
                    reg.setdefault(n.name, _CaptureSite(
                        n.name, [n], n.lineno))
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                e = item.context_expr
                if (isinstance(e, ast.Call)
                        and _unparse(e.func) == "torch.cuda.graph"):
                    g = _unparse(e.args[0]) if e.args else "graph"
                    site = reg.setdefault(g, _CaptureSite(g, [], n.lineno))
                    site.fns.append(n)
    return reg


def _mutable_self_attrs(tree: ast.AST) -> Set[str]:
    """Attributes assigned through ``self`` anywhere outside __init__ /
    __post_init__ -- the ones whose value can change after trace time."""
    out: Set[str] = set()
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in ("__init__", "__post_init__"):
                continue
            for n in ast.walk(meth):
                if (isinstance(n, ast.Attribute)
                        and isinstance(n.ctx, ast.Store)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"):
                    out.add(n.attr)
    return out


def check_slt007(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "parallel", "ops", "models"):
        return
    reg = _capture_registry(src.tree)
    if not reg:
        return

    # (a) captured callables closing over mutable self attributes: the
    # value is baked into the captured program (a CUDA graph replays the
    # captured addresses and scalars; a compiled graph guards on some and
    # freezes others) -- the mutation is silently ignored
    mutable = _mutable_self_attrs(src.tree)
    for site in reg.values():
        for fn in site.fns:
            for n in ast.walk(fn):
                if (isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self" and n.attr in mutable):
                    what = ("assigns" if isinstance(n.ctx, ast.Store)
                            else "closes over")
                    yield Finding(
                        "SLT007", src.path, n.lineno,
                        f"captured callable behind {site.name} {what} "
                        f"mutable attribute 'self.{n.attr}' -- the value "
                        f"is frozen into the captured program; pass it as "
                        f"an argument (a tensor) instead")

    # (b) differing Python literals at one argument of a compiled
    # callable across call sites: each distinct value is a guard failure
    # and a recompile (dynamic shapes aside)
    calls: Dict[str, List[ast.Call]] = {}
    for n in ast.walk(src.tree):
        if isinstance(n, ast.Call):
            nm = _unparse(n.func)
            if nm in reg:
                calls.setdefault(nm, []).append(n)
    for nm, cs in sorted(calls.items()):
        by_pos: Dict[int, List[Tuple[object, int]]] = {}
        for c in cs:
            for i, a in enumerate(c.args):
                if (isinstance(a, ast.Constant)
                        and isinstance(a.value, (bool, int, float))):
                    by_pos.setdefault(i, []).append((a.value, a.lineno))
        for i, vals in sorted(by_pos.items()):
            distinct = sorted({repr(v) for v, _l in vals})
            if len(distinct) > 1:
                line = max(l for _v, l in vals)
                yield Finding(
                    "SLT007", src.path, line,
                    f"{nm}() is called with differing Python literals at "
                    f"argument {i} across call sites ({', '.join(distinct)})"
                    f" -- each value specializes the compiled program "
                    f"(a recompile); pass a tensor or mark it dynamic")


# ---------------------------------------------------------------------- #
# SLT008: implicit host sync on device results
# ---------------------------------------------------------------------- #

# torch.* calls that return no device tensor
_TORCH_NON_TENSOR = frozenset({
    "device", "dtype", "no_grad", "enable_grad", "inference_mode",
    "is_tensor", "is_floating_point", "numel", "Size", "Generator",
    "get_default_dtype", "set_grad_enabled", "from_numpy", "tensor",
    "as_tensor", "finfo", "iinfo", "promote_types", "result_type",
    "is_grad_enabled", "manual_seed", "equal", "allclose"})


def _ops_imports(tree: ast.AST) -> Set[str]:
    """Names the file imports from the port's ``ops`` package: the
    kernel wrappers, whose results live on the card."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module and (
                n.module.startswith("split_learning_tpu_torch.ops")
                or (n.level and n.module.split(".")[0] == "ops")):
            out |= {a.asname or a.name for a in n.names}
    return out


def _is_dispatch(call: ast.Call, ops_names: Set[str],
                 reg: Dict[str, _CaptureSite]) -> bool:
    f = call.func
    txt = _unparse(f)
    if txt in reg or txt == "torch.autograd.grad":
        return True
    if isinstance(f, ast.Name) and f.id in ops_names:
        return True
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "torch" and f.attr not in _TORCH_NON_TENSOR):
        return True
    return False


def _device_expr(expr: ast.expr,
                 reg: Dict[str, _CaptureSite]) -> Optional[str]:
    """The rendering of ``expr`` when it computes a tensor in place (a
    ``torch.*`` call or a compiled callable in it:
    ``bool(torch.isfinite(x).all())``), else None. The ops package's
    imports are left to the named results: some of them (``_on_cuda``)
    answer on the host."""
    if not isinstance(expr, ast.Call):
        return None
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and _is_dispatch(n, set(), reg):
            return _unparse(expr)
    return None


def _match_traced(expr: ast.expr, traced: Dict[str, int]) -> Optional[str]:
    if isinstance(expr, ast.Name) and expr.id in traced:
        return expr.id
    if isinstance(expr, ast.Attribute):
        nm = _unparse(expr)
        if nm in traced:
            return nm
    return None


def _bulk_arg(n: ast.Call) -> Optional[ast.expr]:
    """The tensor a bulk host copy reads: ``np.asarray(t)``,
    ``to_host(t)``, ``t.cpu()``, ``t.numpy()``, ``t.tolist()``."""
    f = n.func
    if isinstance(f, ast.Attribute):
        if (f.attr in ("asarray", "array")
                and _call_root(f) in ("np", "numpy") and n.args):
            return n.args[0]
        if f.attr in ("cpu", "numpy", "tolist") and not n.args:
            return f.value
    if isinstance(f, ast.Name) and f.id == "to_host" and n.args:
        return n.args[0]
    return None


def check_slt008(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "runtime", "ops", "parallel"):
        return
    ops_names = _ops_imports(src.tree)
    reg = _capture_registry(src.tree)
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield from _slt008_fn(src, fn, ops_names, reg)


def _slt008_fn(src: Src, fn: ast.AST, ops_names: Set[str],
               reg: Dict[str, _CaptureSite]) -> Iterator[Finding]:
    traced: Dict[str, int] = {}   # var -> id of the producing dispatch
    call_of: Dict[str, str] = {}  # var -> callee name (messages)
    scalar_evts: List[Tuple[Tuple[int, int], int, str, int]] = []
    bulk_evts: List[Tuple[Tuple[int, int], int]] = []
    findings: List[Finding] = []
    dispatch_id = 0

    def pos(n: ast.AST) -> Tuple[int, int]:
        return (n.lineno, n.col_offset)

    stmts = sorted(_own_stmts(fn),
                   key=lambda s: (s.lineno, s.col_offset))
    for stmt in stmts:
        roots = _barrier_scan_roots(stmt)
        if isinstance(stmt, (ast.If, ast.While)):
            var = _match_traced(stmt.test, traced)
            dev = _device_expr(stmt.test, reg)
            if var is not None or dev is not None:
                what = (f"device result {var!r} (of {call_of[var]}())"
                        if var is not None else f"the device value {dev}")
                findings.append(Finding(
                    "SLT008", src.path, stmt.lineno,
                    f"branching on {what} forces a blocking host sync "
                    f"inside the hot path -- read it to the host "
                    f"explicitly first"))
        for root in roots:
            for n in ast.walk(root):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                if isinstance(f, ast.Name) and f.id == "bool" and n.args:
                    var = _match_traced(n.args[0], traced)
                    dev = _device_expr(n.args[0], reg)
                    if var is not None or dev is not None:
                        what = (f"device result {var!r} (of "
                                f"{call_of[var]}())" if var is not None
                                else f"the device value {dev}")
                        findings.append(Finding(
                            "SLT008", src.path, n.lineno,
                            f"bool() on {what} is an implicit blocking "
                            f"host sync -- read it explicitly first"))
                    continue
                scalar = None
                if (isinstance(f, ast.Name) and f.id in ("float", "int")
                        and n.args):
                    scalar = n.args[0]
                elif (isinstance(f, ast.Attribute) and f.attr == "item"
                        and not n.args):
                    scalar = f.value
                if scalar is not None:
                    var = _match_traced(scalar, traced)
                    if var is not None:
                        scalar_evts.append((pos(n), traced[var], var,
                                            n.lineno))
                    continue
                bulk = _bulk_arg(n)
                if bulk is not None:
                    var = _match_traced(bulk, traced)
                    if var is not None:
                        bulk_evts.append((pos(n), traced[var]))
        # bindings last: `g = g.cpu()` reads the device value above, then
        # rebinds the name to a host tensor
        binds = _stmt_binds(stmt)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and (
                stmt.value is not None):
            producer = next(
                (c for c in ast.walk(stmt.value) if isinstance(c, ast.Call)
                 and _is_dispatch(c, ops_names, reg)), None)
            host = _bulk_arg(stmt.value) is not None if isinstance(
                stmt.value, ast.Call) else False
            if producer is not None and not host:
                dispatch_id += 1
                for b in binds:
                    traced[b] = dispatch_id
                    call_of[b] = _unparse(producer.func)
                continue
        for b in binds:
            traced.pop(b, None)

    for spos, did, var, line in scalar_evts:
        # a bulk copy of the same dispatch at or before the scalar means
        # the stream already drained -- flag only a scalar that jumps
        # the queue ahead of a later bulk copy
        if any(bpos <= spos for bpos, bdid in bulk_evts if bdid == did):
            continue
        if any(bpos > spos for bpos, bdid in bulk_evts if bdid == did):
            findings.append(Finding(
                "SLT008", src.path, line,
                f"scalar read of {var!r} syncs the host on one result "
                f"of {call_of.get(var, '?')}() while a bulk host copy "
                f"of the same dispatch happens later -- copy the bulk "
                f"result first (or in the same statement) so the stream "
                f"drains once"))
    yield from findings


# ---------------------------------------------------------------------- #
# SLT009: generator seeding discipline
# ---------------------------------------------------------------------- #

def check_slt009(src: Src) -> Iterator[Finding]:
    if not _in_dir(src, "ops", "models", "data"):
        return
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield from _slt009_fn(src, fn)


def _varying_names(fn: ast.AST) -> Dict[int, Set[str]]:
    """id(manual_seed call) -> the names bound by the loops and
    comprehensions around it (a seed that reads one varies)."""
    out: Dict[int, Set[str]] = {}

    def walk(node: ast.AST, names: Set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            inner = names
            if isinstance(child, (ast.For, ast.AsyncFor)):
                inner = names | _target_names(child.target)
            elif isinstance(child, (ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp, ast.DictComp)):
                inner = set(names)
                for g in child.generators:
                    inner |= _target_names(g.target)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "manual_seed"):
                out[id(child)] = inner
            walk(child, inner)

    walk(fn, set())
    return out


def _slt009_fn(src: Src, fn: ast.AST) -> Iterator[Finding]:
    loops = [n for n in _own_stmts(fn)
             if isinstance(n, (ast.For, ast.AsyncFor, ast.While))]
    varying = _varying_names(fn)
    seeded: Dict[str, int] = {}   # seed expression -> first line
    for stmt in sorted(_own_stmts(fn),
                       key=lambda s: (s.lineno, s.col_offset)):
        for root in _barrier_scan_roots(stmt):
            for n in ast.walk(root):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "manual_seed" and n.args):
                    continue
                if _call_root(n.func) == "torch" and isinstance(
                        n.func.value, ast.Name):
                    continue  # torch.manual_seed: SLT004's turf
                if any(_reads_name(n.args[0], v)
                       for v in varying.get(id(n), ())):
                    continue  # a seed per iteration: distinct streams
                seed = _unparse(n.args[0])
                if seed in seeded and seeded[seed] != n.lineno:
                    yield Finding(
                        "SLT009", src.path, n.lineno,
                        f"generator seeded from {seed!r} again (first at "
                        f"line {seeded[seed]}) -- both streams draw "
                        f"identical randomness; derive distinct seeds")
                seeded.setdefault(seed, n.lineno)
                gen = _unparse(n.func.value)
                for loop in loops:
                    lo = loop.lineno
                    hi = getattr(loop, "end_lineno", lo)
                    if not lo <= n.lineno <= hi:
                        continue
                    draws = any(
                        _reads_name(c, gen) for c in ast.walk(loop)
                        if isinstance(c, ast.Call) and c is not n
                        and any(kw.arg == "generator" for kw in c.keywords))
                    if draws and not isinstance(n.func.value, ast.Call):
                        yield Finding(
                            "SLT009", src.path, n.lineno,
                            f"generator {gen!r} is re-seeded from "
                            f"{seed!r} inside the loop that draws from "
                            f"it -- every iteration replays the same "
                            f"stream; seed it once outside the loop")
                        break


# ---------------------------------------------------------------------- #
# SLT010: wire-schema contract (project-scope)
# ---------------------------------------------------------------------- #

def _module_str_consts(tree: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    body = tree.body if isinstance(tree, ast.Module) else []
    for n in body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Constant)
                and isinstance(n.value.value, str)):
            out[n.targets[0].id] = n.value.value
    return out


def _const_key(node: Optional[ast.expr],
               consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _dict_keys(d: ast.Dict, consts: Dict[str, str]) -> Set[str]:
    out: Set[str] = set()
    for k in d.keys:
        kk = _const_key(k, consts)
        if kk is not None:
            out.add(kk)
    return out


def _key_reads(root: ast.AST, consts: Dict[str, str],
               recv_ok=None, hard_only: bool = False) -> Set[str]:
    """Constant keys read via ``x[k]``, ``x.get(k…)``/``x.pop(k…)``, and
    ``k in x``. ``hard_only`` keeps only the subscript form (reads that
    raise when the field is missing). ``recv_ok`` filters the receiver
    expression."""
    reads: Set[str] = set()
    for n in ast.walk(root):
        if (isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load)):
            k = _const_key(n.slice, consts)
            if k is not None and (recv_ok is None or recv_ok(n.value)):
                reads.add(k)
        elif hard_only:
            continue
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("get", "pop") and n.args):
            k = _const_key(n.args[0], consts)
            if k is not None and (recv_ok is None
                                  or recv_ok(n.func.value)):
                reads.add(k)
        elif (isinstance(n, ast.Compare) and len(n.ops) == 1
                and isinstance(n.ops[0], (ast.In, ast.NotIn))):
            k = _const_key(n.left, consts)
            if k is not None and (recv_ok is None
                                  or recv_ok(n.comparators[0])):
                reads.add(k)
    return reads


def _fn_writes(fn: ast.AST, consts: Dict[str, str]) -> Set[str]:
    """Keys written anywhere in ``fn``: dict literals, ``d.update(k=…)``
    keywords, and ``d[k] = …`` stores."""
    writes: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Dict):
            writes |= _dict_keys(n, consts)
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "update"):
            writes |= {kw.arg for kw in n.keywords if kw.arg}
        elif (isinstance(n, ast.Subscript)
                and isinstance(n.ctx, ast.Store)):
            k = _const_key(n.slice, consts)
            if k is not None:
                writes.add(k)
    return writes


def _slt010_codec(src: Src) -> Iterator[Finding]:
    """Pair each ``<stem>_compress`` writer against every other function
    in the codec module (``<stem>_decompress``, the ``is_<stem>`` tag
    check, byte accounting): a field only one side knows about is dead
    wire bytes or a latent KeyError."""
    consts = _module_str_consts(src.tree)
    fns = {n.name: n for n in src.tree.body
           if isinstance(n, ast.FunctionDef)} if isinstance(
               src.tree, ast.Module) else {}
    for name, fn in sorted(fns.items()):
        m = re.match(r"(\w+?)_compress$", name)
        if not m:
            continue
        writes = _fn_writes(fn, consts)
        reads: Set[str] = set()
        for oname, ofn in fns.items():
            if oname != name:
                reads |= _key_reads(ofn, consts)
        for k in sorted(writes - reads):
            yield Finding(
                "SLT010", src.path, fn.lineno,
                f"wire field {k!r} is written by {name}() but read by "
                f"no decode/accounting path -- dead bytes on every "
                f"compressed exchange; drop it or consume it")
        dec = fns.get(m.group(1) + "_decompress")
        if dec is not None:
            hard = _key_reads(dec, consts, hard_only=True)
            for k in sorted(hard - writes):
                yield Finding(
                    "SLT010", src.path, dec.lineno,
                    f"wire field {k!r} is required (d[{k!r}]) by "
                    f"{dec.name}() but never written by {name}() -- "
                    f"KeyError on the first real frame")


def _assigned_first_target(stmt: ast.stmt) -> Optional[str]:
    """First bound name of an Assign: ``req, up = …`` -> 'req'."""
    if not isinstance(stmt, ast.Assign) or not stmt.targets:
        return None
    t = stmt.targets[0]
    if isinstance(t, ast.Tuple) and t.elts:
        t = t.elts[0]
    return t.id if isinstance(t, ast.Name) else None


def _slt010_http(http_src: Src,
                 peers: Sequence[Src]) -> Iterator[Finding]:
    """Pair the request direction (client payload dicts vs server reads
    of ``req``) and the reply direction (server ``resp`` dicts vs client
    reads) across transport/http.py and transport/local.py."""
    req_writes: Dict[str, int] = {}   # key -> witness line
    resp_writes: Dict[str, int] = {}
    req_reads: Set[str] = set()
    resp_reads: Set[str] = set()

    def note(dst: Dict[str, int], keys: Set[str], line: int) -> None:
        for k in keys:
            dst.setdefault(k, line)

    for src in [http_src, *peers]:
        consts = _module_str_consts(src.tree)
        for n in ast.walk(src.tree):
            # client request payloads: the dict handed to _post()
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "_post" and len(n.args) >= 2
                    and isinstance(n.args[1], ast.Dict)):
                note(req_writes, _dict_keys(n.args[1], consts), n.lineno)
            # _post-internal payload mutations: dict(payload, k=…) and
            # payload[k] = …
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "dict" and n.args
                    and isinstance(n.args[0], ast.Name)
                    and n.args[0].id == "payload"):
                note(req_writes,
                     {kw.arg for kw in n.keywords if kw.arg}, n.lineno)
            if (isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Store)
                    and isinstance(n.value, ast.Name)
                    and n.value.id in ("payload", "resp")):
                k = _const_key(n.slice, consts)
                if k is not None:
                    dst = (req_writes if n.value.id == "payload"
                           else resp_writes)
                    dst.setdefault(k, n.lineno)
            # standalone payload/resp dict literals (server replies, the
            # aggregate payload)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict):
                tgt = _assigned_first_target(n)
                if tgt == "payload":
                    note(req_writes, _dict_keys(n.value, consts), n.lineno)
                elif tgt == "resp":
                    note(resp_writes, _dict_keys(n.value, consts),
                         n.lineno)
            # LocalTransport wire emulation: `req, _ = self._wire({…})`
            # is the request direction, `resp, _ = …` the reply
            if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                    and isinstance(n.value.func, ast.Attribute)
                    and n.value.func.attr == "_wire" and n.value.args
                    and isinstance(n.value.args[0], ast.Dict)):
                tgt = _assigned_first_target(n)
                keys = _dict_keys(n.value.args[0], consts)
                if tgt == "req":
                    note(req_writes, keys, n.lineno)
                elif tgt == "resp":
                    note(resp_writes, keys, n.lineno)

        def recv_req(e: ast.expr) -> bool:
            return isinstance(e, ast.Name) and e.id == "req"

        def recv_resp(e: ast.expr) -> bool:
            return (isinstance(e, ast.Call)
                    or (isinstance(e, ast.Name)
                        and e.id in ("out", "resp", "tree")))

        req_reads |= _key_reads(src.tree, consts, recv_ok=recv_req)
        resp_reads |= _key_reads(src.tree, consts, recv_ok=recv_resp)

    for k, line in sorted(req_writes.items()):
        if k not in req_reads:
            yield Finding(
                "SLT010", http_src.path, line,
                f"request field {k!r} is sent by the client but never "
                f"read server-side -- dead wire bytes or a schema drift")
    for k, line in sorted(resp_writes.items()):
        if k not in resp_reads:
            yield Finding(
                "SLT010", http_src.path, line,
                f"reply field {k!r} is written by the server but never "
                f"read by any client path -- dead wire bytes or a "
                f"schema drift")


_CC_DEF_RE = re.compile(
    r"^\s*(?:[A-Za-z_][A-Za-z0-9_]*\s+)+?(slt_[a-z0-9_]+)\s*\(",
    re.MULTILINE)


def _slt010_native(src: Src) -> Iterator[Finding]:
    """ctypes bindings (``lib.slt_*`` in native/codec.py) vs the
    ``extern "C"`` exports of native/slt_codec.cc -- a binding without a
    symbol fails at load time on the machine that builds the library,
    an export without a binding is dead native code."""
    cc_path = os.path.join(os.path.dirname(src.path) or ".",
                           "slt_codec.cc")
    try:
        with open(cc_path, encoding="utf-8") as fh:
            cc_text = fh.read()
    except OSError:
        return  # source tree without the native half: nothing to pair
    lo = cc_text.find('extern "C"')
    defined = set(_CC_DEF_RE.findall(cc_text[lo:] if lo >= 0 else cc_text))
    bound: Dict[str, int] = {}
    for n in ast.walk(src.tree):
        if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id == "lib" and n.attr.startswith("slt_")):
            bound.setdefault(n.attr, n.lineno)
    for sym, line in sorted(bound.items()):
        if sym not in defined:
            yield Finding(
                "SLT010", src.path, line,
                f"ctypes binding {sym!r} has no extern \"C\" definition "
                f"in slt_codec.cc -- AttributeError the first time the "
                f"native library loads")
    for sym in sorted(defined - set(bound)):
        yield Finding(
            "SLT010", src.path, 1,
            f"native symbol {sym!r} is exported by slt_codec.cc but "
            f"never bound in native/codec.py -- dead native code or a "
            f"missing binding")


def _cu_exports(path: str) -> Set[str]:
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return set()
    lo = text.find('extern "C"')
    return set(_CC_DEF_RE.findall(text[lo:])) if lo >= 0 else set()


def _slt010_kernels(ops_srcs: Sequence[Src]) -> Iterator[Finding]:
    """ctypes bindings of the ops modules (``lib.slt_*`` on a library
    that ``load_kernels()["<stem>"]`` returns) vs the ``extern "C"``
    exports of ``csrc/<stem>.cu``: a binding without a symbol is an
    AttributeError on the card at the first launch, an export without a
    binding is dead kernel code."""
    if not ops_srcs:
        return
    ops_dir = os.path.dirname(ops_srcs[0].path) or "."
    csrc = os.path.join(os.path.dirname(ops_dir), "csrc")
    if not os.path.isdir(csrc):
        return
    exports: Dict[str, Set[str]] = {}
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            exports[name[:-3]] = _cu_exports(os.path.join(csrc, name))
    all_bound: Set[str] = set()
    for src in ops_srcs:
        stems: Dict[str, int] = {}
        bound: Dict[str, int] = {}
        for n in ast.walk(src.tree):
            if (isinstance(n, ast.Subscript)
                    and isinstance(n.value, ast.Call)
                    and _unparse(n.value.func).endswith("load_kernels")):
                k = n.slice
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    stems.setdefault(k.value, n.lineno)
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id == "lib" and n.attr.startswith("slt_")):
                bound.setdefault(n.attr, n.lineno)
        for stem, line in sorted(stems.items()):
            if stem not in exports:
                yield Finding(
                    "SLT010", src.path, line,
                    f"load_kernels()[{stem!r}] names no csrc/{stem}.cu -- "
                    f"KeyError on the card at the first launch")
        defined = set().union(*(exports.get(s, set()) for s in stems))
        for sym, line in sorted(bound.items()):
            if stems and sym not in defined:
                yield Finding(
                    "SLT010", src.path, line,
                    f"ctypes binding {sym!r} has no extern \"C\" "
                    f"definition in csrc/"
                    f"{{{','.join(sorted(stems))}}}.cu -- AttributeError "
                    f"on the card the first time the kernel loads")
        all_bound |= set(bound)
    for stem, syms in sorted(exports.items()):
        for sym in sorted(syms - all_bound):
            yield Finding(
                "SLT010", os.path.join(csrc, f"{stem}.cu"), 1,
                f"kernel symbol {sym!r} is exported by csrc/{stem}.cu but "
                f"bound by no ops module -- dead kernel code or a missing "
                f"binding")


def check_slt010(srcs: Sequence[Src]) -> Iterator[Finding]:
    codec_src = http_src = None
    peers: List[Src] = []
    ops_srcs: List[Src] = []
    for s in srcs:
        if s.posix.endswith("transport/codec.py"):
            codec_src = s
        elif s.posix.endswith("transport/http.py"):
            http_src = s
        elif s.posix.endswith("transport/local.py"):
            peers.append(s)
        elif s.posix.endswith("native/codec.py"):
            yield from _slt010_native(s)
        elif _in_dir(s, "ops"):
            ops_srcs.append(s)
    if codec_src is not None:
        yield from _slt010_codec(codec_src)
    if http_src is not None:
        yield from _slt010_http(http_src, peers)
    yield from _slt010_kernels(ops_srcs)


# ---------------------------------------------------------------------- #

RULES = {
    "SLT006": (check_slt006,
               "no read, through a name bound before it, of a leaf an "
               "in-place update (K2 fused_sgd_step, torch._foreach_*_, "
               "an optimizer) changed"),
    "SLT007": (check_slt007,
               "no capture hazards: torch.compile/jit/CUDA-graph "
               "captures closing over mutable self, varying literals"),
    "SLT008": (check_slt008,
               "no implicit host sync on device results (bool/if/early "
               "scalar read before the bulk copy)"),
    "SLT009": (check_slt009,
               "torch.Generator seeds: never two from one expression, "
               "never re-seeded inside the loop that draws"),
}

PROJECT_RULES = {
    "SLT010": (check_slt010,
               "wire-schema contract: codec/http field sets, native and "
               "csrc ctypes bindings pair up across both sides"),
}
