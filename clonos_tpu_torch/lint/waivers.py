"""Waivers: every exemption is explicit, named, and auditable.

Two mechanisms, both referencing registry rule names (core.RULES):

- **inline** — ``# clonos: allow(rule[, rule...])`` on the offending
  line, or on a comment-only line directly above it. The rest of the
  comment is the justification; the self-lint waivers in
  runtime/leader.py and obs/trace.py are the exemplars.
- **waiver file** — the package's own ``clonos_tpu_torch/.clonos-waivers``
  (runner.DEFAULT_WAIVER_FILE) or one named with ``--waivers``:
  ``<rule> <glob>`` waives a rule across matching files; ``exclude
  <glob>`` drops files from *directory traversal* entirely.
  Explicitly-named command-line targets override ``exclude`` (the
  eslint ``--no-ignore`` convention): a directory can lint clean while
  naming an excluded bait file straight still fails.

Misuse is itself reported: an unknown rule name in any waiver is an
ERROR finding (a typo'd waiver that silently waives nothing is worse
than no waiver), and a waiver that no longer matches any finding is a
*stale* WARNING — delete it, the code it excused is gone.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import io
import re
import tokenize
from typing import List, Optional, Set, Tuple

from clonos_tpu_torch.lint.core import (ERROR, WARNING, FileContext, Finding,
                                        RULES)

INLINE_RE = re.compile(r"#\s*clonos:\s*allow\(([^)]*)\)")

#: synthetic rule names for waiver-machinery findings (not waivable).
UNKNOWN_RULE = "waiver-unknown-rule"
STALE_WAIVER = "stale-waiver"


@dataclasses.dataclass
class InlineWaiver:
    path: str
    line: int                 # line the waiver comment sits on
    target: int               # line whose findings it waives
    rules: Set[str]
    used: bool = False


@dataclasses.dataclass
class FileWaiverEntry:
    rule: str                 # rule name, or "exclude"
    pattern: str
    lineno: int
    used: bool = False


@dataclasses.dataclass
class WaiverSet:
    inline: List[InlineWaiver] = dataclasses.field(default_factory=list)
    entries: List[FileWaiverEntry] = dataclasses.field(
        default_factory=list)
    waiver_path: Optional[str] = None
    #: findings produced by the waiver machinery itself
    problems: List[Finding] = dataclasses.field(default_factory=list)
    #: did this run traverse any directory? exclude staleness is only
    #: meaningful when traversal could have consulted the entry.
    traversed: bool = False

    def excluded(self, path: str, mark_only: bool = False) -> bool:
        """Should directory traversal skip ``path``? Explicit targets
        call with ``mark_only=True``: the entry is credited as used (so
        deliberately linting an excluded file is not a stale waiver)
        but the file is linted anyway — see module docstring."""
        hit = False
        for e in self.entries:
            if e.rule == "exclude" and _glob_match(path, e.pattern):
                e.used = True
                hit = True
        return hit and not mark_only

    def waive(self, finding: Finding) -> bool:
        """Mark ``finding`` waived if any waiver covers it."""
        hit = False
        for w in self.inline:
            if w.path == finding.path and w.target == finding.line \
                    and finding.rule in w.rules:
                w.used = True
                hit = True
        for e in self.entries:
            if e.rule == finding.rule \
                    and _glob_match(finding.path, e.pattern):
                e.used = True
                hit = True
        return hit

    def stale(self) -> List[Finding]:
        """WARNING findings for waivers that excused nothing.

        Waivers naming only analysis-owned rules (nondet-reach,
        thread-race, …) are the analysis runner's to second-guess —
        the per-file lint never produces their findings, so from here
        they always look unused."""
        owned = _analysis_owned_rules()
        out: List[Finding] = []
        for w in self.inline:
            if not w.used and not w.rules & {UNKNOWN_RULE} \
                    and w.rules - owned:
                out.append(Finding(
                    rule=STALE_WAIVER, path=w.path, line=w.line,
                    severity=WARNING,
                    message=f"stale waiver allow("
                            f"{', '.join(sorted(w.rules))}) — no "
                            f"finding on the waived line any more; "
                            f"delete the comment"))
        for e in self.entries:
            if not e.used and self.waiver_path is not None:
                if e.rule in owned:
                    continue
                if e.rule == "exclude" and not self.traversed:
                    continue
                what = ("exclude" if e.rule == "exclude"
                        else f"{e.rule} waiver")
                out.append(Finding(
                    rule=STALE_WAIVER, path=self.waiver_path,
                    line=e.lineno, severity=WARNING,
                    message=f"stale {what} for {e.pattern!r} — "
                            f"matched no file/finding this run"))
        return out


def _glob_match(path: str, pattern: str) -> bool:
    return fnmatch.fnmatch(path, pattern) \
        or fnmatch.fnmatch(path, pattern.rstrip("/") + "/*")


def _comment_lines(source: str) -> List[Tuple[int, str]]:
    """(lineno, comment text) for real COMMENT tokens only — a waiver
    mentioned inside a docstring or string literal is documentation,
    not a waiver (this module's own docs would otherwise trip it)."""
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        pass                      # unparseable files get SYNTAX findings
    return out


def _analysis_owned_rules() -> set:
    """Rules the whole-program analysis runner owns (lazy import — see
    :func:`_register_analysis_rules`). Empty when unavailable."""
    try:
        from clonos_tpu_torch.analysis.runner import ANALYSIS_RULES
        return set(ANALYSIS_RULES)
    except ImportError:
        return set()


def _register_analysis_rules() -> None:
    """The analysis package owns the whole-program rules (nondet-reach,
    lock-order, thread-race, join-discipline, …) and registers them in
    the shared registry on import. Load it lazily so waivers naming
    those rules validate from a bare ``lint`` run too — a
    function-level import, because the analysis package imports
    lint.core and a module-level import would cycle."""
    try:
        import clonos_tpu_torch.analysis.runner  # noqa: F401
    except ImportError:            # analysis package absent/broken:
        pass                       # its rule names stay unknown


def collect_inline(ctx: FileContext) -> Tuple[List[InlineWaiver],
                                              List[Finding]]:
    """Parse ``# clonos: allow(...)`` comments in one file.

    A waiver on a comment-only line targets the next non-comment line
    (a multi-line justification block above the code works); a trailing
    waiver targets its own line. Unknown rule names are ERROR
    findings."""
    _register_analysis_rules()
    waivers: List[InlineWaiver] = []
    problems: List[Finding] = []
    for lineno, comment in _comment_lines(ctx.source):
        m = INLINE_RE.search(comment)
        if not m:
            continue
        names = {n.strip() for n in m.group(1).split(",") if n.strip()}
        unknown = sorted(n for n in names if n not in RULES)
        for n in unknown:
            problems.append(Finding(
                rule=UNKNOWN_RULE, path=ctx.path, line=lineno,
                severity=ERROR,
                message=f"waiver names unknown rule {n!r} — known "
                        f"rules: {', '.join(sorted(RULES))}"))
        names -= set(unknown)
        if not names:
            continue
        line_text = ctx.line_text(lineno)
        if line_text.strip().startswith("#"):
            target = lineno + 1
            while target <= len(ctx.lines) \
                    and ctx.line_text(target).strip().startswith("#"):
                target += 1
        else:
            target = lineno
        waivers.append(InlineWaiver(path=ctx.path, line=lineno,
                                    target=target, rules=names))
    return waivers, problems


def load_waiver_file(path: str,
                     repo_text: Optional[str] = None
                     ) -> Tuple[List[FileWaiverEntry], List[Finding]]:
    """Parse a ``.clonos-waivers`` file: ``<rule> <glob>`` /
    ``exclude <glob>`` lines, ``#`` comments. Unknown rule names are
    ERROR findings anchored to the waiver file itself."""
    _register_analysis_rules()
    entries: List[FileWaiverEntry] = []
    problems: List[Finding] = []
    if repo_text is None:
        with open(path) as f:
            repo_text = f.read()
    for lineno, raw in enumerate(repo_text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 2:
            problems.append(Finding(
                rule=UNKNOWN_RULE, path=path, line=lineno,
                severity=ERROR,
                message=f"malformed waiver line {raw.strip()!r} — "
                        f"expected '<rule> <glob>' or 'exclude <glob>'"))
            continue
        rule, pattern = parts
        if rule != "exclude" and rule not in RULES:
            problems.append(Finding(
                rule=UNKNOWN_RULE, path=path, line=lineno,
                severity=ERROR,
                message=f"waiver file names unknown rule {rule!r} — "
                        f"known rules: {', '.join(sorted(RULES))}"))
            continue
        entries.append(FileWaiverEntry(rule=rule, pattern=pattern,
                                       lineno=lineno))
    return entries, problems
