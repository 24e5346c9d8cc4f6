"""Marker registry rule.

Every ``pytest.mark.<name>`` in tests/ must be either a pytest builtin
or registered in :data:`REGISTERED_MARKERS`. Unregistered markers are
silent no-ops under ``-m`` filters — a test tagged with a typo'd
``slow`` would run in tier-1 forever.

The registry holds what the repository's pytest configuration
registers (``slow``, from ``tests/conftest.py``); this module keeps its
own copy so the port's lint needs nothing of another package. The rule
is line-regex based, so a marker spelled inside a string counts too.
:func:`check` is the directory scan in the historical
``<file>:<line>: unregistered marker <name>`` form.
"""

from __future__ import annotations

import os
import re
from typing import List

from clonos_tpu_torch.lint.core import (FileContext, Finding, Rule,
                                        _is_test_path, register_rule)

#: Markers this repo registers (tier-1 deselects `slow`).
REGISTERED_MARKERS = {
    "slow": "long-running test, excluded from the tier-1 gate "
            "(-m 'not slow')",
}

#: Pytest's own markers — always legal, never need registration.
BUILTIN_MARKERS = {
    "parametrize", "skip", "skipif", "xfail", "usefixtures",
    "filterwarnings",
}

_MARK_RE = re.compile(r"\bpytest\.mark\.([A-Za-z_]\w*)")


@register_rule
class MarkersRule(Rule):
    name = "markers"
    description = ("pytest marker not registered in "
                   "clonos_tpu_torch/lint/markers.py:REGISTERED_MARKERS")

    def applies_to(self, path: str) -> bool:
        # Inverted scope: this is the one rule that checks *tests*.
        return _is_test_path(path)

    def check(self, ctx: FileContext) -> List[Finding]:
        allowed = BUILTIN_MARKERS | set(REGISTERED_MARKERS)
        out: List[Finding] = []
        for lineno, line in enumerate(ctx.lines, 1):
            for m in _MARK_RE.finditer(line):
                name = m.group(1)
                if name not in allowed:
                    out.append(self.finding(
                        ctx, lineno,
                        f"unregistered marker {name!r} — a typo'd "
                        f"marker silently passes -m filters; register "
                        f"it in clonos_tpu_torch/lint/markers.py:"
                        f"REGISTERED_MARKERS"))
        return out


def check(tests_dir) -> List[str]:
    """Scan ``tests_dir`` for marker uses; return a list of
    '<file>:<line>: unregistered marker <name>' violations.

    Kept line-compatible with the historical tools/check_markers.py
    output so the conftest wiring and the shim keep working."""
    rule = MarkersRule()
    violations: List[str] = []
    for fn in sorted(os.listdir(tests_dir)):
        if not fn.endswith(".py"):
            continue
        path = os.path.join(tests_dir, fn)
        with open(path) as f:
            source = f.read()
        ctx = FileContext(os.path.join("tests", fn), source)
        for finding in rule.check(ctx):
            m = re.search(r"marker ('[^']*')", finding.message)
            name = m.group(1) if m else "?"
            violations.append(
                f"{finding.location()}: unregistered marker {name}")
    return violations
