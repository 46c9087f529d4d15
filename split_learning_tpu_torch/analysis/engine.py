"""slt-lint driver of the PyTorch port (counterpart of
``split_learning_tpu/analysis/engine.py``): walk files, run rules,
apply waivers, report.

Waiver syntax (both forms require a non-empty reason -- an unreasoned
waiver is itself a finding):

* inline, on the offending line or the line directly above::

      x = np.asarray(dev)  # slt-lint: disable=SLT001 (legacy overlap-off path)

* file-scoped, one per line in the checked-in waiver file
  (``.slt-lint.waivers`` at the repo root, empty by policy --
  real violations get fixed, not parked)::

      SLT003 split_learning_tpu_torch/foo/bar.py reason text

Exit status: 0 when every finding is waived (or none), 1 otherwise --
the CI contract. With no paths it lints ``split_learning_tpu_torch``.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from split_learning_tpu_torch.analysis.invariants import (INVARIANTS,
                                                    RULE_OF_INVARIANT)
from split_learning_tpu_torch.analysis.rules import (Finding, PROJECT_RULES,
                                               RULES, Src, run_rules,
                                               run_project_rules)

# slt-check pseudo-rules (SLT1xx): one per dynamic invariant, so
# model-checking findings ride the same waiver/exit-code contract as
# the static rules. Docs come from the invariant functions themselves.
CHECK_RULES: Dict[str, Tuple[None, str]] = {
    rule_id: (None, (INVARIANTS[name].__doc__ or name).strip()
              .splitlines()[0].rstrip("."))
    for name, rule_id in sorted(RULE_OF_INVARIANT.items())
}

_WAIVER_RE = re.compile(
    r"#\s*slt-lint:\s*disable=([A-Z0-9,\s]+?)\s*\(([^)]*)\)")
_DEFAULT_WAIVER_FILE = ".slt-lint.waivers"


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


def _parse_inline_waivers(text: str, path: str
                          ) -> Tuple[Dict[int, Tuple[Set[str], str]],
                                     List[Finding]]:
    """line -> (rule ids, reason); a waiver on its own line covers the
    next line, otherwise the line it sits on."""
    waivers: Dict[int, Tuple[Set[str], str]] = {}
    problems: List[Finding] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _WAIVER_RE.search(line)
        if m is None:
            if re.search(r"#\s*slt-lint:\s*disable", line):
                problems.append(Finding(
                    "SLT000", path, lineno,
                    "malformed waiver -- expected "
                    "'# slt-lint: disable=SLT00N (reason)'"))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2).strip()
        if not reason:
            problems.append(Finding(
                "SLT000", path, lineno,
                "waiver without a reason -- say why, in the parens"))
            continue
        target = lineno + 1 if line.strip().startswith("#") else lineno
        waivers[target] = (rules, reason)
    return waivers, problems


def _load_waiver_file(path: str) -> Tuple[List[Tuple[str, str, str]],
                                          List[Finding]]:
    """Lines of 'RULE path reason...' -> (rule, path-suffix, reason)."""
    entries: List[Tuple[str, str, str]] = []
    problems: List[Finding] = []
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return entries, problems
    for lineno, line in enumerate(lines, start=1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        parts = stripped.split(None, 2)
        if len(parts) < 3 or (parts[0] not in RULES
                              and parts[0] not in PROJECT_RULES
                              and parts[0] not in CHECK_RULES):
            problems.append(Finding(
                "SLT000", path, lineno,
                "malformed waiver-file entry -- expected "
                "'SLT00N path/suffix.py reason text'"))
            continue
        entries.append((parts[0], _posix(parts[1]), parts[2]))
    return entries, problems


def iter_py_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def _waive(f: Finding,
           inline: Dict[int, Tuple[Set[str], str]],
           file_waivers: Optional[List[Tuple[str, str, str]]],
           posix: str) -> Finding:
    waived, reason = False, ""
    hit = inline.get(f.line)
    if hit is not None and f.rule in hit[0]:
        waived, reason = True, hit[1]
    if not waived and file_waivers:
        for rule, suffix, wf_reason in file_waivers:
            if rule == f.rule and posix.endswith(suffix):
                waived, reason = True, wf_reason
                break
    return Finding(f.rule, f.path, f.line, f.message,
                   waived=waived, reason=reason)


def _parse_src(path: str) -> Tuple[Optional[Src], List[Finding],
                                   Dict[int, Tuple[Set[str], str]]]:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return None, [Finding("SLT000", path, exc.lineno or 1,
                              f"cannot parse: {exc.msg}")], {}
    src = Src(path=path, posix=_posix(path), tree=tree, text=text)
    inline, problems = _parse_inline_waivers(text, path)
    return src, problems, inline


def lint_file(path: str,
              file_waivers: Optional[List[Tuple[str, str, str]]] = None
              ) -> List[Finding]:
    src, problems, inline = _parse_src(path)
    if src is None:
        return problems
    out: List[Finding] = list(problems)
    for f in run_rules(src):
        out.append(_waive(f, inline, file_waivers, src.posix))
    return out


def lint_paths(paths: Iterable[str],
               waiver_file: Optional[str] = None) -> List[Finding]:
    file_waivers: List[Tuple[str, str, str]] = []
    problems: List[Finding] = []
    if waiver_file is None and os.path.exists(_DEFAULT_WAIVER_FILE):
        waiver_file = _DEFAULT_WAIVER_FILE
    if waiver_file:
        file_waivers, problems = _load_waiver_file(waiver_file)
    findings = list(problems)
    srcs: List[Src] = []
    inline_by_posix: Dict[str, Dict[int, Tuple[Set[str], str]]] = {}
    for path in iter_py_files(paths):
        src, file_problems, inline = _parse_src(path)
        findings.extend(file_problems)
        if src is None:
            continue
        srcs.append(src)
        inline_by_posix[src.posix] = inline
        for f in run_rules(src):
            findings.append(_waive(f, inline, file_waivers, src.posix))
    # project rules see the whole parsed tree at once (cross-file
    # pairing); waivers apply against the file each finding lands in
    for f in run_project_rules(srcs):
        posix = _posix(f.path)
        findings.append(_waive(f, inline_by_posix.get(posix, {}),
                               file_waivers, posix))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------- #
# slt-check: interleaving exploration (analysis/sched.py) as a lint pass
# ---------------------------------------------------------------------- #

def _check_scenarios(only: Optional[str]):
    """Resolve the scenario registry lazily -- scenarios import numpy and
    the runtime, which the pure-lint path must never pay for."""
    from split_learning_tpu_torch.analysis.scenarios import SCENARIOS
    if only is not None:
        if only not in SCENARIOS:
            raise SystemExit(
                f"slt-check: unknown scenario {only!r} "
                f"(have: {', '.join(sorted(SCENARIOS))})")
        return {only: SCENARIOS[only]}
    return dict(sorted(SCENARIOS.items()))


def run_check(args: "argparse.Namespace") -> int:
    """Explore every registered scenario's schedules, assert the
    invariants on each run, and report violations as SLT1xx findings
    through the standard waiver/exit-code machinery."""
    import json

    from split_learning_tpu_torch.analysis.invariants import check_run
    from split_learning_tpu_torch.analysis.sched import explore

    crash_scenarios: Dict[str, Any] = {}
    if getattr(args, "crash", False):
        from split_learning_tpu_torch.analysis.scenarios import CRASH_SCENARIOS
        if args.scenario is not None and args.scenario in CRASH_SCENARIOS:
            scenarios = {}
            crash_scenarios = {args.scenario: CRASH_SCENARIOS[args.scenario]}
        else:
            scenarios = _check_scenarios(args.scenario)
            if args.scenario is None:
                crash_scenarios = dict(sorted(CRASH_SCENARIOS.items()))
    else:
        scenarios = _check_scenarios(args.scenario)
    file_waivers, problems = ([], [])
    waiver_file = args.waiver_file
    if waiver_file is None and os.path.exists(_DEFAULT_WAIVER_FILE):
        waiver_file = _DEFAULT_WAIVER_FILE
    if waiver_file:
        file_waivers, problems = _load_waiver_file(waiver_file)

    findings: List[Finding] = list(problems)
    report: Dict[str, Any] = {"scenarios": {}, "total_schedules": 0,
                              "budget_override": args.budget,
                              "mode_override": args.mode}
    for name, sc in scenarios.items():
        if not sc.available():
            print(f"slt-check: {name}: SKIPPED (requires {sc.requires})")
            report["scenarios"][name] = {"skipped": sc.requires}
            continue
        budget = args.budget if args.budget is not None else sc.budget
        bound = (args.max_preemptions if args.max_preemptions is not None
                 else sc.bound)
        mode = args.mode if args.mode is not None else sc.mode
        seed = args.seed if args.seed is not None else sc.seed
        violations: List[Any] = []
        res = explore(
            name, sc.fn, budget=budget, bound=bound, mode=mode, seed=seed,
            on_run=lambda run, _inv=sc.invariants:
                violations.extend(check_run(run, _inv)))
        entry = res.summary()
        entry["invariants"] = sorted(
            {"deadlock_free", "no_lost_wakeup", "no_errors"}
            | set(sc.invariants))
        entry["violations"] = [
            {"invariant": v.invariant, "schedule_id": v.schedule_id,
             "message": v.message} for v in violations]
        entry["sample_fingerprints"] = dict(res.sample)
        report["scenarios"][name] = entry
        report["total_schedules"] += res.schedules
        status = (f"{res.schedules} schedules, {res.pruned} pruned, "
                  f"max {res.max_preemptions} preemptions"
                  + (", exhausted" if res.exhausted else ""))
        if violations:
            status += f", {len(violations)} VIOLATION(S)"
        print(f"slt-check: {name}: {status}")
        # one finding per (scenario, invariant): the FIRST violating
        # schedule DFS reached -- shortest decision prefix, i.e. the
        # minimal counterexample -- plus how many more schedules hit it
        first: Dict[str, Any] = {}
        extra: Dict[str, int] = {}
        for v in violations:
            if v.invariant in first:
                extra[v.invariant] = extra.get(v.invariant, 0) + 1
            else:
                first[v.invariant] = v
        for inv_name, v in first.items():
            more = extra.get(inv_name, 0)
            msg = (f"[{name}] {v.message} -- replay: "
                   f"--schedule {v.schedule_id}"
                   + (f" (+{more} more schedule(s))" if more else ""))
            f = Finding(RULE_OF_INVARIANT[inv_name],
                        f"scenario://{name}", 1, msg)
            findings.append(_waive(f, {}, file_waivers, f.path))

    if crash_scenarios:
        from split_learning_tpu_torch.analysis.sched import explore_crashes
        report["crash"] = True
    for name, sc in crash_scenarios.items():
        if not sc.available():
            print(f"slt-crash: {name}: SKIPPED (requires {sc.requires})")
            report["scenarios"][name] = {"skipped": sc.requires,
                                         "crash": True}
            continue
        # --budget overrides the crash-point budget (the dominant knob);
        # the base-interleaving budget stays the scenario's own
        crash_budget = (args.budget if args.budget is not None
                        else sc.crash_budget)
        bound = (args.max_preemptions if args.max_preemptions is not None
                 else sc.bound)
        violations = []
        res = explore_crashes(
            name, sc.workload, sc.recover, budget=sc.budget, bound=bound,
            crash_budget=crash_budget,
            on_run=lambda run, _inv=sc.invariants:
                violations.extend(check_run(run, _inv)))
        entry = res.summary()
        entry["crash"] = True
        entry["invariants"] = sorted(
            {"deadlock_free", "no_lost_wakeup", "no_errors"}
            | set(sc.invariants))
        entry["violations"] = [
            {"invariant": v.invariant, "schedule_id": v.schedule_id,
             "message": v.message} for v in violations]
        entry["sample_fingerprints"] = dict(res.sample)
        report["scenarios"][name] = entry
        report["total_schedules"] += res.schedules
        status = (f"{res.schedules} schedules ({res.bases} bases, "
                  f"{res.crash_schedules} crash points), "
                  f"{res.pruned} pruned"
                  + (", exhausted" if res.exhausted else ""))
        if violations:
            status += f", {len(violations)} VIOLATION(S)"
        print(f"slt-crash: {name}: {status}")
        first = {}
        extra = {}
        for v in violations:
            if v.invariant in first:
                extra[v.invariant] = extra.get(v.invariant, 0) + 1
            else:
                first[v.invariant] = v
        for inv_name, v in first.items():
            more = extra.get(inv_name, 0)
            msg = (f"[{name}] {v.message} -- replay: "
                   f"--schedule {v.schedule_id}"
                   + (f" (+{more} more schedule(s))" if more else ""))
            f = Finding(RULE_OF_INVARIANT[inv_name],
                        f"scenario://{name}", 1, msg)
            findings.append(_waive(f, {}, file_waivers, f.path))

    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"slt-check: report written to {args.report}")

    unwaived = [f for f in findings if not f.waived]
    for f in findings:
        print(f.format())
    print(f"slt-check: {report['total_schedules']} schedules across "
          f"{sum(1 for e in report['scenarios'].values() if 'skipped' not in e)} "
          f"scenario(s); {len(unwaived)} unwaived finding(s), "
          f"{sum(1 for f in findings if f.waived)} waived")
    return 1 if unwaived else 0


def _replay_crash_schedule(sc: Any, name: str, choices_text: str,
                           crash_at: Optional[int]) -> int:
    """Re-execute one crash-restart schedule bit-for-bit: the base
    interleaving to the crash point, the process kill, the recovery --
    and re-assert the scenario's invariants over the combined run."""
    from split_learning_tpu_torch.analysis.invariants import check_run
    from split_learning_tpu_torch.analysis.sched import (decode_choices,
                                                   run_crash_schedule)
    if not sc.available():
        raise SystemExit(f"slt-check: scenario {name} requires "
                         f"{sc.requires}, which is unavailable")
    run = run_crash_schedule(name, sc.workload, sc.recover,
                             forced=decode_choices(choices_text),
                             bound=sc.bound, crash_at=crash_at)
    kind = (f"crashed at transition {crash_at}" if run.crashed
            else "clean restart")
    print(f"slt-crash: replayed {run.schedule_id} ({kind}, "
          f"{run.transitions} transitions, fingerprint "
          f"{run.trace_fingerprint()})")
    for tid, op, obj in run.trace:
        print(f"  t{tid} {op:<14} {obj}")
    violations = check_run(run, sc.invariants)
    for v in violations:
        print(f"VIOLATION {RULE_OF_INVARIANT[v.invariant]} "
              f"[{v.invariant}] {v.message}")
    if not violations:
        print("slt-check: no invariant violated on this schedule")
    return 1 if violations else 0


def replay_schedule(schedule_id: str) -> int:
    """Re-execute one schedule bit-for-bit and re-assert its scenario's
    invariants -- how a counterexample becomes a regression check."""
    from split_learning_tpu_torch.analysis.invariants import check_run
    from split_learning_tpu_torch.analysis.sched import decode_choices, run_schedule

    if ":" not in schedule_id:
        raise SystemExit(
            f"slt-check: bad schedule id {schedule_id!r} "
            f"(want '<scenario>:<choices>[@crash:<point>]')")
    crash_at: Optional[int] = None
    base_id = schedule_id
    if "@crash:" in schedule_id:
        base_id, crash_text = schedule_id.rsplit("@crash:", 1)
        try:
            crash_at = int(crash_text)
        except ValueError:
            raise SystemExit(f"slt-check: bad crash point {crash_text!r} "
                             f"in {schedule_id!r}")
    name, choices_text = base_id.split(":", 1)
    from split_learning_tpu_torch.analysis.scenarios import CRASH_SCENARIOS
    if name in CRASH_SCENARIOS:
        return _replay_crash_schedule(CRASH_SCENARIOS[name], name,
                                      choices_text, crash_at)
    if crash_at is not None:
        raise SystemExit(f"slt-check: scenario {name} is not a crash "
                         f"scenario, @crash: suffix invalid")
    scenarios = _check_scenarios(name)
    sc = scenarios[name]
    if not sc.available():
        raise SystemExit(f"slt-check: scenario {name} requires "
                         f"{sc.requires}, which is unavailable")
    run = run_schedule(name, sc.fn, forced=decode_choices(choices_text))
    print(f"slt-check: replayed {run.schedule_id} "
          f"({run.transitions} transitions, {run.preemptions} "
          f"preemptions, fingerprint {run.trace_fingerprint()})")
    for tid, kind, obj in run.trace:
        print(f"  t{tid} {kind:<12} {obj}")
    violations = check_run(run, sc.invariants)
    for v in violations:
        print(f"VIOLATION {RULE_OF_INVARIANT[v.invariant]} "
              f"[{v.invariant}] {v.message}")
    if not violations:
        print("slt-check: no invariant violated on this schedule")
    return 1 if violations else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m split_learning_tpu_torch.analysis",
        description="slt-lint: project concurrency-invariant checks")
    parser.add_argument("paths", nargs="*",
                        default=["split_learning_tpu_torch"],
                        help="files or directories to lint")
    parser.add_argument("--waiver-file", default=None,
                        help=f"file-scoped waivers (default: "
                             f"{_DEFAULT_WAIVER_FILE} if present)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    check = parser.add_argument_group(
        "slt-check", "systematic interleaving exploration (model "
        "checking) of the runtime's concurrency invariants")
    check.add_argument("--check", action="store_true",
                       help="explore scenario schedules and assert the "
                            "SLT1xx invariants instead of linting")
    check.add_argument("--crash", action="store_true",
                       help="with --check: also explore the crash-restart "
                            "scenarios (interleavings x crash points over "
                            "the durable-store abstraction, SLT109-112)")
    check.add_argument("--budget", type=int, default=None,
                       help="per-scenario schedule budget override "
                            "(default: each scenario's own)")
    check.add_argument("--max-preemptions", type=int, default=None,
                       help="preemption bound override for DFS mode")
    check.add_argument("--mode", choices=("dfs", "random"), default=None,
                       help="exploration mode override")
    check.add_argument("--seed", type=int, default=None,
                       help="random-mode seed override")
    check.add_argument("--scenario", default=None,
                       help="restrict --check to one scenario")
    check.add_argument("--schedule", default=None, metavar="ID",
                       help="replay one schedule id bit-for-bit and "
                            "re-assert its invariants")
    check.add_argument("--report", default=None, metavar="PATH",
                       help="write the explorer JSON report here")
    args = parser.parse_args(argv)

    if args.list_rules:
        catalog = {**RULES, **PROJECT_RULES, **CHECK_RULES}
        for rule_id, (_fn, doc) in sorted(catalog.items()):
            print(f"{rule_id}: {doc}")
        return 0
    if args.schedule:
        return replay_schedule(args.schedule)
    if args.check:
        return run_check(args)

    findings = lint_paths(args.paths or ["split_learning_tpu_torch"],
                          args.waiver_file)
    unwaived = [f for f in findings if not f.waived]
    for f in findings:
        print(f.format())
    n_waived = sum(1 for f in findings if f.waived)
    print(f"slt-lint: {len(unwaived)} unwaived finding(s), "
          f"{n_waived} waived")
    return 1 if unwaived else 0
