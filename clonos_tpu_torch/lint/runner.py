"""Lint driver: file collection, rule dispatch, waiver application,
and the ``--report json`` / exit-code contract shared with the ``audit``
verb.

Exit semantics (CI contract): exit 1 iff any unwaived ERROR-severity
finding remains; waived findings and WARNING findings (stale waivers)
never fail the run but are always reported.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Sequence

from clonos_tpu_torch.lint.core import (ERROR, WARNING, RULES, FileContext,
                                        Finding, all_rules)
from clonos_tpu_torch.lint.waivers import (WaiverSet, collect_inline,
                                           load_waiver_file)

#: the package's own waiver file, found from the package and not from
#: the working directory (the repository root holds another package's).
DEFAULT_WAIVER_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".clonos-waivers")

#: what ``run_lint`` and the ``lint`` verb check when given no paths.
DEFAULT_PATHS = ("clonos_tpu_torch",)

#: synthetic rule for files the AST cannot parse.
SYNTAX = "syntax"

_SKIP_DIRS = {"__pycache__", ".git", "build", "dist",
              ".pytest_cache"}


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files: List[str]

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

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files": len(self.files),
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "waived": len(self.waived),
            "findings": [f.to_dict() for f in self.findings],
        }


def _norm(path: str) -> str:
    """Repo-relative forward-slash path (finding addresses are stable
    across where the linter was invoked from)."""
    rel = os.path.relpath(path)
    return rel.replace(os.sep, "/")


def collect_files(paths: Sequence[str],
                  waivers: Optional[WaiverSet] = None) -> List[str]:
    """Expand targets to .py files. Directories are walked with
    ``exclude`` waivers applied; explicitly-named files are ALWAYS
    linted, exclusions notwithstanding — pointing the linter at a file
    is the override."""
    out: List[str] = []
    seen = set()

    def add(p: str):
        n = _norm(p)
        if n not in seen:
            seen.add(n)
            out.append(n)

    for target in paths:
        if os.path.isfile(target):
            if waivers is not None:
                waivers.excluded(_norm(target), mark_only=True)
            add(target)
            continue
        if waivers is not None and os.path.isdir(target):
            waivers.traversed = True
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                p = _norm(os.path.join(dirpath, fn))
                if waivers is not None and waivers.excluded(p):
                    continue
                add(p)
    return out


def build_waivers(waiver_file: Optional[str] = None,
                  use_waivers: bool = True) -> WaiverSet:
    """Assemble the run's WaiverSet from the repo-level waiver file
    (inline waivers join per-file during the lint pass)."""
    ws = WaiverSet()
    if not use_waivers:
        return ws
    path = waiver_file
    if path is None and os.path.isfile(DEFAULT_WAIVER_FILE):
        path = DEFAULT_WAIVER_FILE
    if path is not None and os.path.isfile(path):
        entries, problems = load_waiver_file(_norm(path))
        ws.entries = entries
        ws.waiver_path = _norm(path)
        ws.problems.extend(problems)
    return ws


def run_lint(paths: Sequence[str] = DEFAULT_PATHS,
             waiver_file: Optional[str] = None,
             use_waivers: bool = True,
             rules: Optional[Iterable[str]] = None) -> LintResult:
    """Lint ``paths`` (files and/or directories) and return the result.

    ``rules`` restricts the run to a subset of registry names (used by
    tests and ``lint --rule``); unknown names raise ValueError so a
    typo'd CI invocation fails loudly rather than checking nothing."""
    ws = build_waivers(waiver_file, use_waivers)
    files = collect_files(paths, ws if use_waivers else None)

    if rules is not None:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(unknown)}")
        active = [RULES[n] for n in sorted(set(rules))]
    else:
        active = all_rules()

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
        file_findings: List[Finding] = []
        for rule in active:
            if rule.applies_to(path):
                file_findings.extend(rule.check(ctx))
        if use_waivers:
            inline, problems = collect_inline(ctx)
            ws.inline.extend(inline)
            ws.problems.extend(problems)
        findings.extend(file_findings)

    if use_waivers:
        for f in findings:
            if ws.waive(f):
                f.waived = True
        findings.extend(ws.problems)
        findings.extend(ws.stale())

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings=findings, files=files)


def format_text(result: LintResult, verbose: bool = False) -> str:
    """Human-readable report: one ``path:line: [rule] message`` per
    finding plus a summary line (waived findings only with -v)."""
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
    lines.append(
        f"lint: {len(result.files)} file(s), "
        f"{len(result.errors)} error(s), "
        f"{len(result.warnings)} warning(s), "
        f"{len(result.waived)} waived")
    return "\n".join(lines)


def format_json(result: LintResult) -> str:
    """One machine-readable line (the ``audit`` verb's convention)."""
    return json.dumps(result.to_dict(), sort_keys=True)
