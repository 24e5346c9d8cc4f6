"""Analysis driver: whole-program passes + the lint's CI conventions.

``run_analysis`` shares the lint's building blocks — file collection,
waiver set, finding/severity model, one-line ``--report json``, exit
0/1 — but its rules are whole-program: they need the interprocedural
call graph, so they cannot run per-file from ``run_lint``:

- **nondet-reach** (ERROR): an *unwaived* nondeterminism-escape
  finding (wallclock/rng/entropy) whose function is reachable from a
  step-function entry point. The per-file lint already flags the
  source line; this names the step function it poisons and the call
  chain that gets it there — the difference between "style problem in
  a helper" and "this block program replays differently".
- **lock-order** (ERROR): acquisition-order cycles in the whole-repo
  lock graph (analysis/lockorder.py).
- **thread-race** / **join-discipline** (ERROR): lockset ∩
  happens-before race detection over the thread-root inventory
  (analysis/threads.py, analysis/races.py) — shared attributes touched
  by two roots with a write and disjoint guards, and reads of a
  worker's product not dominated by a join.

The thread-root census (analysis/threads.py) rides along next to the
FT-call-site census, fingerprinted, so CI can pin the concurrency
architecture (``clonos_tpu_torch/.clonos-threads``) the same way it
pins the call-site population (``clonos_tpu_torch/.clonos-census``).

The census (analysis/census.py) rides along in the result and the JSON
report, fingerprinted, so CI, soak verdicts and incident bundles agree
on exactly which FT call-site population they describe.

Waiver semantics mirror the lint, with one addition: staleness is only
reported for waivers that name *analysis* rules — a waiver consumed by
the per-file lint is not this runner's to second-guess.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from clonos_tpu_torch.lint.core import (ERROR, WARNING, RULES, FileContext,
                                        Finding)
from clonos_tpu_torch.lint.runner import (DEFAULT_PATHS, SYNTAX,
                                          build_waivers, collect_files)
from clonos_tpu_torch.lint.waivers import STALE_WAIVER, collect_inline

from clonos_tpu_torch.analysis import census as census_mod
from clonos_tpu_torch.analysis.callgraph import CallGraph
from clonos_tpu_torch.analysis.lockorder import (LOCK_BALANCE, LOCK_ORDER,
                                                 LockOrderGraph)
from clonos_tpu_torch.analysis import threads as threads_mod
from clonos_tpu_torch.analysis.races import (JOIN_DISCIPLINE, THREAD_RACE,
                                             run_races)

NONDET_REACH = "nondet-reach"

#: rules this runner owns (waiver staleness is scoped to these).
ANALYSIS_RULES = {NONDET_REACH, LOCK_ORDER, LOCK_BALANCE,
                  THREAD_RACE, JOIN_DISCIPLINE}

#: per-file rules whose unwaived findings seed the reach propagation.
TAINT_RULES = ("wallclock", "rng", "entropy")


def _register_reach_rule() -> None:
    from clonos_tpu_torch.lint.core import Rule, register_rule
    if NONDET_REACH in RULES:
        return

    @register_rule
    class _ReachRule(Rule):
        name = NONDET_REACH
        description = ("unlogged nondeterminism reachable from a step "
                       "function (whole-program: enforced by "
                       "`python -m clonos_tpu_torch analyze`)")

        def check(self, ctx: FileContext) -> List[Finding]:
            return []


_register_reach_rule()


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    files: List[str]
    census: Dict
    census_fingerprint: str
    threads: Dict = dataclasses.field(default_factory=dict)
    threads_fingerprint: str = ""

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == ERROR and not f.waived]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == WARNING and not f.waived]

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def ok(self) -> bool:
        return not self.errors

    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def to_dict(self, with_census: bool = True) -> dict:
        out = {
            "ok": self.ok,
            "files": len(self.files),
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "waived": len(self.waived),
            "census_fingerprint": self.census_fingerprint,
            "threads_fingerprint": self.threads_fingerprint,
            "findings": [f.to_dict() for f in self.findings],
        }
        if with_census:
            out["census"] = self.census
            out["threads"] = self.threads
        return out


def run_analysis(paths: Sequence[str] = DEFAULT_PATHS,
                 waiver_file: Optional[str] = None,
                 use_waivers: bool = True) -> AnalysisResult:
    """Whole-program analysis over ``paths`` (AST only: nothing of the
    analyzed code is imported)."""
    ws = build_waivers(waiver_file, use_waivers)
    files = collect_files(paths, ws if use_waivers else None)

    contexts: List[FileContext] = []
    findings: List[Finding] = []
    for path in files:
        try:
            with open(path) as f:
                source = f.read()
            ctx = FileContext(path, source)
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            findings.append(Finding(
                rule=SYNTAX, path=path,
                line=getattr(exc, "lineno", None) or 1,
                severity=ERROR,
                message=f"file does not parse: {exc}"))
            continue
        contexts.append(ctx)
        if use_waivers:
            inline, _problems = collect_inline(ctx)
            ws.inline.extend(inline)

    # Whole-program rules respect the lint's path scoping: test files
    # exercise clocks/threads legitimately and are not pipeline code.
    prog_ctxs = [c for c in contexts
                 if RULES[TAINT_RULES[0]].applies_to(c.path)]
    graph = CallGraph(prog_ctxs)

    findings.extend(_nondet_reach(prog_ctxs, graph, ws, use_waivers))
    lockgraph = LockOrderGraph(prog_ctxs, graph)
    findings.extend(lockgraph.findings())

    inventory = threads_mod.ThreadInventory(prog_ctxs, graph)
    findings.extend(run_races(prog_ctxs, graph, lockgraph, inventory))

    census = census_mod.build_census(prog_ctxs, graph)

    if use_waivers:
        for f in findings:
            if ws.waive(f):
                f.waived = True
        findings.extend(_stale_analysis_waivers(ws))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(findings=findings, files=files,
                          census=census,
                          census_fingerprint=census_mod.fingerprint(
                              census),
                          threads=inventory.to_dict(),
                          threads_fingerprint=threads_mod.fingerprint(
                              inventory))


def _nondet_reach(contexts: Sequence[FileContext], graph: CallGraph,
                  ws, use_waivers: bool) -> List[Finding]:
    """Escalate unwaived per-file nondet findings that a step function
    can reach. The base finding stays the lint's; this adds the
    interprocedural consequence with the proving call chain."""
    tainted: Dict[str, List[Finding]] = {}
    for ctx in contexts:
        for rule_name in TAINT_RULES:
            rule = RULES[rule_name]
            if not rule.applies_to(ctx.path):
                continue
            for f in rule.check(ctx):
                if use_waivers and ws.waive(f):
                    continue        # justified: never replayed data
                fi = graph.enclosing(f.path, f.line)
                if fi is not None:
                    tainted.setdefault(fi.qname, []).append(f)

    out: List[Finding] = []
    if not tainted:
        return out
    for entry in graph.step_entries():
        # One chain per tainted function (not just the nearest): every
        # provably-reachable escape is its own finding, so fixing one
        # does not hide the next.
        for fn_qname in sorted(tainted):
            chain = graph.chain(entry.qname, {fn_qname})
            if chain is None:
                continue
            hops = " -> ".join(q.split(".")[-1] if "<" not in q else q
                               for q in chain)
            for src in tainted[fn_qname]:
                out.append(Finding(
                    rule=NONDET_REACH, path=src.path, line=src.line,
                    severity=ERROR,
                    message=f"[{src.rule}] at {src.location()} is "
                            f"reachable from step function "
                            f"{entry.qname} ({entry.path}:{entry.line})"
                            f" via {hops} — the block program's replay "
                            f"diverges on this value; route it through "
                            f"a causal service or waive the base "
                            f"finding with a justification"))
    return out


def _stale_analysis_waivers(ws) -> List[Finding]:
    """Stale warnings scoped to analysis-owned rules (lint-owned
    waivers are the lint runner's to report)."""
    out: List[Finding] = []
    for w in ws.inline:
        if not w.used and w.rules & ANALYSIS_RULES:
            out.append(Finding(
                rule=STALE_WAIVER, path=w.path, line=w.line,
                severity=WARNING,
                message=f"stale analysis waiver allow("
                        f"{', '.join(sorted(w.rules & ANALYSIS_RULES))}"
                        f") — no analysis finding on the waived line; "
                        f"delete the comment"))
    for e in ws.entries:
        if not e.used and e.rule in ANALYSIS_RULES \
                and ws.waiver_path is not None:
            out.append(Finding(
                rule=STALE_WAIVER, path=ws.waiver_path, line=e.lineno,
                severity=WARNING,
                message=f"stale analysis waiver {e.rule} for "
                        f"{e.pattern!r} — matched no finding this run"))
    return out


def format_text(result: AnalysisResult, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in result.findings:
        if f.waived and not verbose:
            continue
        tag = f"[{f.rule}]"
        if f.waived:
            tag += " (waived)"
        elif f.severity == WARNING:
            tag += " (warning)"
        lines.append(f"{f.location()}: {tag} {f.message}")
    c = result.census
    lines.append(
        f"analyze: {len(result.files)} file(s), "
        f"{len(result.errors)} error(s), "
        f"{len(result.warnings)} warning(s), "
        f"{len(result.waived)} waived; census "
        f"{result.census_fingerprint} "
        f"({len(c['step_functions'])} step fn(s), "
        f"{len(c['service_call_sites'])} service call site(s), "
        f"{c['dets_per_step']} sync lanes/step); threads "
        f"{result.threads_fingerprint} "
        f"({len(result.threads.get('roots', []))} root(s))")
    return "\n".join(lines)


def format_json(result: AnalysisResult,
                with_census: bool = True) -> str:
    """One machine-readable line (the lint/audit CI convention)."""
    return json.dumps(result.to_dict(with_census=with_census),
                      sort_keys=True)
