"""Lint core: findings, the pluggable rule registry, per-file context.

The Clonos exactly-once guarantee is a *contract*: every
nondeterministic decision in operator/runtime code must flow through the
causal services (causal/services.py) so it lands in the determinant log
and replays bit-identically. The audit ledger (obs/audit.py) enforces
that contract at runtime — a violation shows up as a
``recovery.audit.divergence`` long after the offending line was
written. This package enforces it *statically*: an AST pass over
pipeline and runtime code that names the exact file:line where
nondeterminism escapes the log.

Rules are pluggable the same way determinant types are
(causal/determinant.py's registry): each rule subclasses :class:`Rule`
and registers under a stable name via :func:`register_rule`; waivers
(clonos_tpu_torch/lint/waivers.py) reference those names, so an unknown
name in a waiver is itself a finding.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional

#: severity levels; only unwaived ERROR findings fail the exit code.
ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Finding:
    """One lint finding, addressable as ``path:line`` (repo-relative)."""

    rule: str
    path: str
    line: int
    message: str
    severity: str = ERROR
    waived: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "severity": self.severity, "waived": self.waived,
                "message": self.message}


def _is_test_path(path: str) -> bool:
    parts = path.split("/")
    return "tests" in parts or parts[-1] == "conftest.py"


class Rule:
    """One checkable clause of the determinism contract.

    Subclasses set ``name`` (stable — waivers reference it),
    ``description`` (one line, shown by ``lint --list-rules``), and
    implement :meth:`check`. ``applies_to`` scopes a rule by path:
    the default skips test files — tests exercise clocks and threads
    legitimately and are not pipeline code (the markers rule inverts
    this)."""

    name: str = ""
    description: str = ""
    severity: str = ERROR

    def applies_to(self, path: str) -> bool:
        return not _is_test_path(path)

    def check(self, ctx: "FileContext") -> List[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", line: int,
                message: str) -> Finding:
        return Finding(rule=self.name, path=ctx.path, line=line,
                       message=message, severity=self.severity)


#: rule registry: name -> instance (the determinant-type-registry shape).
RULES: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and register a rule by its name."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if inst.name in RULES:
        raise ValueError(f"duplicate rule name {inst.name!r}")
    RULES[inst.name] = inst
    return cls


def rule_names() -> List[str]:
    return sorted(RULES)


def all_rules() -> List[Rule]:
    return [RULES[n] for n in sorted(RULES)]


class FileContext:
    """One parsed file: source lines, AST, and import-alias resolution.

    ``resolve(node)`` maps a Name/Attribute expression to its canonical
    dotted path — ``_time.time`` under ``import time as _time`` resolves
    to ``time.time``; ``datetime.now`` under ``from datetime import
    datetime`` resolves to ``datetime.datetime.now`` — so rules match
    *what is called*, not how the import spelled it."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._aliases = self._collect_aliases(self.tree)

    @staticmethod
    def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:
                    continue             # relative: package-internal
                for a in node.names:
                    aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
        # Conventional shorthands resolve to canonical module names.
        for local, canon in list(aliases.items()):
            if canon == "numpy":
                aliases[local] = "numpy"
        return aliases

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, or None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self._aliases.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""
