"""Whole-repo lock-order graph: acquisition-order cycles are deadlocks.

``lint/concurrency.py`` checks each class alone: a guarded attribute
mutated without its lock. What it cannot see is the *cross*-class (and
cross-method) hazard the threaded runtime actually grew into:
``dispatcher.py`` holds its admission lock while calling into a
JobMaster whose checkpoint coordinator takes ``_lock``, while a
heartbeat thread entered from the other side holds that ``_lock`` and
calls back out. If two threads acquire the same pair of locks in
opposite orders, the runtime deadlocks — under load, rarely, in
production.

This pass builds the acquisition-order digraph over every analyzed
file: node = lock identity (``Class.attr``, resolved through the call
graph's instance-attribute types when the lock lives on a collaborator,
e.g. ``self.jm._lock``); edge ``A -> B`` = somewhere, B is acquired
while A is held — either directly (nested ``with``) or transitively (a
call made under A reaches a function whose closure acquires B). Any
cycle in that digraph is an ERROR finding naming both directions'
acquisition sites.

Approximations (same spirit as the lint's):

- Reentrant re-acquisition of an already-held lock is NOT an edge (the
  runtime uses ``RLock`` where it self-nests; flagging ``A -> A`` would
  punish that pattern).
- Nested function bodies are analyzed as part of their enclosing
  function: a callback defined under a lock usually runs later, but if
  it acquires locks the conservative edge is the one worth seeing.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from clonos_tpu_torch.lint.core import ERROR, WARNING, FileContext, Finding, \
    Rule, register_rule
from clonos_tpu_torch.lint.concurrency import _lock_attr, lock_attrs

from clonos_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo

LOCK_ORDER = "lock-order"
LOCK_BALANCE = "lock-balance"


@register_rule
class LockOrderRule(Rule):
    """Registry placeholder so waivers can reference ``lock-order`` and
    ``lint --list-rules`` documents it. The check itself is
    whole-program — it needs the call graph — so it runs from
    the ``analyze`` verb (analysis/runner.py), not the per-file lint
    pass."""

    name = LOCK_ORDER
    description = ("lock acquisition-order cycle across the runtime "
                   "(whole-program: enforced by `python -m "
                   "clonos_tpu_torch analyze`)")

    def check(self, ctx: FileContext) -> List[Finding]:
        return []


@register_rule
class LockBalanceRule(Rule):
    """Registry placeholder for ``lock-balance`` (same arrangement as
    ``lock-order``: the check runs from the ``analyze`` verb)."""

    name = LOCK_BALANCE
    description = ("bare .acquire() with no matching .release() in the "
                   "same function (whole-program: enforced by "
                   "`python -m clonos_tpu_torch analyze`)")

    def check(self, ctx: FileContext) -> List[Finding]:
        return []


@dataclasses.dataclass(frozen=True)
class AcqSite:
    path: str
    line: int
    fn: str                      # qname of the acquiring function


@dataclasses.dataclass
class _FnLocks:
    """Per-function lock facts from one ordered body walk."""

    #: (lock, line, locks held at that point)
    acquires: List[Tuple[str, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: (resolved callee qname, line, locks held at the call)
    calls: List[Tuple[str, int, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: bare ``lock.acquire()`` statements: (lock, line)
    bare_acquires: List[Tuple[str, int]] = \
        dataclasses.field(default_factory=list)
    #: locks a bare ``lock.release()`` statement releases somewhere in
    #: this function (any path balances the warning)
    releases: Set[str] = dataclasses.field(default_factory=set)


class LockOrderGraph:
    """Acquisition-order digraph over a parsed file set."""

    def __init__(self, contexts: Sequence[FileContext],
                 graph: CallGraph):
        self._graph = graph
        self._fn_locks: Dict[str, _FnLocks] = {}
        #: edge (a, b) -> first site where b was taken/reached under a
        self.edge_sites: Dict[Tuple[str, str], AcqSite] = {}
        by_path = {c.path: c for c in contexts}
        # One walk per file: (name, lineno) -> def node, so per-function
        # scans don't each re-walk the whole module AST.
        self._def_index: Dict[str, Dict[Tuple[str, int], ast.AST]] = {}
        for c in contexts:
            idx: Dict[Tuple[str, int], ast.AST] = {}
            for sub in ast.walk(c.tree):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    idx[(sub.name, sub.lineno)] = sub
            self._def_index[c.path] = idx
        self._class_shorts = {cq.rsplit(".", 1)[-1]
                              for cq in graph.classes}
        # lock attr -> class short names that acquire it via `with
        # self.<attr>:` — lets a lock reached through an untyped
        # parameter unify with its owner when the name is unambiguous.
        self._lock_owners: Dict[str, Set[str]] = {}
        # Type-proven lock attributes per file (`self._cv =
        # threading.Condition()`): extends the name hints so the lock
        # identity the race pass reuses matches the lint's guard set.
        self._known_locks: Dict[str, frozenset] = {
            c.path: lock_attrs(c) for c in contexts}
        for c in contexts:
            known = self._known_locks[c.path]
            for node in ast.walk(c.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    exprs = []
                    if isinstance(sub, ast.With):
                        exprs = [i.context_expr for i in sub.items]
                    elif isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "acquire":
                        exprs = [sub.func.value]
                    for e in exprs:
                        attr = _lock_attr(e, known)
                        if attr is not None \
                                and isinstance(e, ast.Attribute) \
                                and isinstance(e.value, ast.Name) \
                                and e.value.id == "self":
                            self._lock_owners.setdefault(
                                attr, set()).add(node.name)
        for fi in graph.functions.values():
            ctx = by_path.get(fi.path)
            if ctx is not None:
                self._fn_locks[fi.qname] = self._scan(ctx, fi)
        self._closure = self._acquire_closure()
        self._build_edges()

    # --- per-function ordered walk ------------------------------------------

    def _scan(self, ctx: FileContext, fi: FunctionInfo) -> _FnLocks:
        facts = _FnLocks()
        node = self._def_index[ctx.path].get((fi.name, fi.line))
        if node is None:
            if fi.name != "<module>":
                return facts
            node = ctx.tree
        self._params = self._param_types(node)
        body = node.body if isinstance(node.body, list) else [node.body]
        self._walk(ctx, fi, facts, body, held=())
        return facts

    def _param_types(self, node: ast.AST) -> Dict[str, str]:
        """Annotated parameters whose type is a repo class (short
        name): ``def heartbeat(self, d: Dispatcher)`` -> {"d":
        "Dispatcher"}. String annotations count too."""
        out: Dict[str, str] = {}
        args = getattr(node, "args", None)
        if args is None:
            return out
        for a in list(args.posonlyargs) + list(args.args) \
                + list(args.kwonlyargs):
            ann = a.annotation
            name = None
            if isinstance(ann, ast.Name):
                name = ann.id
            elif isinstance(ann, ast.Constant) \
                    and isinstance(ann.value, str):
                name = ann.value.strip('"').rsplit(".", 1)[-1]
            elif isinstance(ann, ast.Attribute):
                name = ann.attr
            if name in self._class_shorts:
                out[a.arg] = name
        return out

    def _lock_id(self, ctx: FileContext, fi: FunctionInfo,
                 expr: ast.AST) -> Optional[str]:
        """``with self._lock:`` -> ``Cls._lock``; ``with self.jm._lock:``
        -> ``JobMaster._lock`` when ``self.jm``'s class is known; a lock
        reached through a parameter resolves via its annotation, else
        via attribute-name uniqueness across the repo's classes."""
        attr = _lock_attr(
            expr, self._known_locks.get(ctx.path, frozenset()))
        if attr is None:
            return None
        owner = "?"
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self" \
                    and fi.cls is not None:
                owner = fi.cls.rsplit(".", 1)[-1]
            elif isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and fi.cls is not None:
                tgt = self._graph.attr_types.get((fi.cls, base.attr))
                owner = (tgt.rsplit(".", 1)[-1] if tgt is not None
                         else f"{fi.cls.rsplit('.', 1)[-1]}.{base.attr}")
            elif isinstance(base, ast.Name):
                if base.id in self._params:
                    owner = self._params[base.id]
                else:
                    owners = self._lock_owners.get(attr, set())
                    if len(owners) == 1:
                        owner = next(iter(owners))
                    else:
                        dotted = ctx.resolve(base)
                        owner = dotted if dotted is not None else base.id
        return f"{owner}.{attr}"

    def _walk(self, ctx: FileContext, fi: FunctionInfo,
              facts: _FnLocks, stmts,
              held: Tuple[str, ...]) -> Tuple[str, ...]:
        # Bare ``lock.acquire()`` / ``lock.release()`` statements change
        # the held set for SUBSEQUENT statements, so the walk threads
        # ``held`` through the body in source order (a straight-line
        # approximation: a branch's acquire stays held afterwards, which
        # conservatively over-orders rather than missing an edge).
        for stmt in stmts:
            held = self._visit(ctx, fi, facts, stmt, held)
        return held

    def _bare_lock_call(self, ctx: FileContext, fi: FunctionInfo,
                        expr: ast.AST
                        ) -> Tuple[Optional[str], Optional[str]]:
        """``self._lock.acquire()`` as a bare statement ->
        (lock id, "acquire"/"release")."""
        if isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("acquire", "release"):
            lock = self._lock_id(ctx, fi, expr.func.value)
            if lock is not None:
                return lock, expr.func.attr
        return None, None

    def _visit(self, ctx: FileContext, fi: FunctionInfo,
               facts: _FnLocks, node: ast.AST,
               held: Tuple[str, ...]) -> Tuple[str, ...]:
        if fi.name == "<module>" and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)):
            return held     # bodies belong to their own function scans
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                lock = self._lock_id(ctx, fi, item.context_expr)
                if lock is not None:
                    facts.acquires.append((lock, node.lineno, inner))
                    if lock not in inner:
                        inner = inner + (lock,)
            self._walk(ctx, fi, facts, node.body, inner)
            return held                 # with-scope restores on exit
        if isinstance(node, ast.Expr):
            lock, kind = self._bare_lock_call(ctx, fi, node.value)
            if kind == "acquire":
                facts.acquires.append((lock, node.lineno, held))
                facts.bare_acquires.append((lock, node.lineno))
                if lock not in held:
                    held = held + (lock,)
                return held
            if kind == "release":
                facts.releases.add(lock)
                return tuple(h for h in held if h != lock)
        if isinstance(node, ast.Call):
            dotted = ctx.resolve(node.func)
            if dotted is not None:
                tgt = self._graph.resolve_call(fi, dotted)
                if tgt is not None and tgt != fi.qname:
                    facts.calls.append((tgt, node.lineno, held))
        for child in ast.iter_child_nodes(node):
            held = self._visit(ctx, fi, facts, child, held)
        return held

    # --- interprocedural closure --------------------------------------------

    def _acquire_closure(self) -> Dict[str, Set[str]]:
        """acq*(f): every lock f can come to hold, directly or through
        any call it makes (fixed point over the call graph)."""
        acq = {q: {a for a, _l, _h in f.acquires}
               for q, f in self._fn_locks.items()}
        changed = True
        while changed:
            changed = False
            for q, facts in self._fn_locks.items():
                cur = acq[q]
                for callee, _line, _held in facts.calls:
                    extra = acq.get(callee, set()) - cur
                    if extra:
                        cur |= extra
                        changed = True
        return acq

    def _build_edges(self) -> None:
        for q, facts in self._fn_locks.items():
            fi = self._graph.functions[q]
            for lock, line, held in facts.acquires:
                for a in held:
                    if a != lock:
                        self.edge_sites.setdefault(
                            (a, lock), AcqSite(fi.path, line, q))
            for callee, line, held in facts.calls:
                if not held:
                    continue
                for b in self._closure.get(callee, ()):
                    for a in held:
                        if a != b and b not in held:
                            self.edge_sites.setdefault(
                                (a, b), AcqSite(fi.path, line, q))

    # --- cycles -------------------------------------------------------------

    def cycles(self) -> List[List[str]]:
        """Every elementary lock-order cycle, canonicalized (rotated to
        the lexicographically smallest head, deduplicated)."""
        adj: Dict[str, Set[str]] = {}
        for a, b in self.edge_sites:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        out: List[List[str]] = []
        seen: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str],
                on_path: Set[str]) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    i = path.index(min(path))
                    canon = tuple(path[i:] + path[:i])
                    if canon not in seen:
                        seen.add(canon)
                        out.append(list(canon))
                elif nxt not in on_path and nxt > start:
                    # Only explore nodes > start: each cycle is found
                    # exactly once, from its smallest member.
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for n in sorted(adj):
            dfs(n, n, [n], {n})
        return out

    def findings(self) -> List[Finding]:
        rule = LockOrderRule()
        out: List[Finding] = []
        for cyc in self.cycles():
            pairs = list(zip(cyc, cyc[1:] + cyc[:1]))
            sites = [self.edge_sites[p] for p in pairs]
            route = "; ".join(
                f"{a} -> {b} at {s.path}:{s.line} ({s.fn.rsplit('.', 2)[-1] if '.' in s.fn else s.fn})"
                for (a, b), s in zip(pairs, sites))
            anchor = min(sites, key=lambda s: (s.path, s.line))
            out.append(Finding(
                rule=LOCK_ORDER, path=anchor.path, line=anchor.line,
                severity=ERROR,
                message=f"lock acquisition-order cycle "
                        f"{' -> '.join(cyc + [cyc[0]])}: {route} — two "
                        f"threads taking these locks in opposite orders "
                        f"deadlock; pick one global order (or drop a "
                        f"lock scope) and add a waiver only if an "
                        f"external protocol serializes the paths"))
        out.extend(self.balance_findings())
        return sorted(out, key=lambda f: (f.path, f.line))

    def balance_findings(self) -> List[Finding]:
        """WARNING per bare ``.acquire()`` whose function never calls
        ``.release()`` on the same lock: on every path out of that
        function the lock stays held — either a leak (deadlock the next
        time anyone takes it) or a cross-function hand-off the analysis
        cannot see (which deserves the ``with`` form or a waiver)."""
        out: List[Finding] = []
        for q, facts in sorted(self._fn_locks.items()):
            if not facts.bare_acquires:
                continue
            fi = self._graph.functions[q]
            for lock, line in facts.bare_acquires:
                if lock in facts.releases:
                    continue
                out.append(Finding(
                    rule=LOCK_BALANCE, path=fi.path, line=line,
                    severity=WARNING,
                    message=f"{lock}.acquire() here but {q.rsplit('.', 1)[-1]}() "
                            f"never calls {lock}.release() — the lock "
                            f"stays held on every exit path; use `with "
                            f"{lock.rsplit('.', 1)[-1]}:` or release in "
                            f"a finally block"))
        return out
