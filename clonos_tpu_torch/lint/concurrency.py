"""Rule family 3: lock discipline in the threaded runtime.

runtime/cluster.py, runtime/checkpoint.py, runtime/dispatcher.py and
obs/history.py document shared attributes as lock-guarded
(``_writer_lock``, ``_lock``, ``_rjit_lock``): every mutation of the
guarded state is supposed to happen inside ``with self.<lock>:``. The guard set is inferred rather
than declared: an attribute counts as guarded once any method mutates
it under the lock. A mutation of a guarded attribute on a path that
provably never holds the lock is then a finding — exactly the
``storage.mark_complete`` race this rule was built to catch.

Approximations, chosen to keep the rule quiet on correct code:

- ``__init__`` is exempt (no concurrent access before construction
  completes — the repo-wide convention).
- Methods named ``*_locked`` assert the caller's lock by convention;
  they are treated as lock-held, and so is any method *only* reachable
  from lock-held contexts (a fixed point over the intra-class call
  graph).
- Reads are not flagged — the runtime deliberately does lock-free
  reads of monotonic state (double-checked ``_jitted`` cache); only
  stores and mutating method calls count.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from clonos_tpu_torch.lint.core import (FileContext, Finding, Rule,
                                        register_rule)

#: attribute names that look like locks when used as `with self.X:`.
_LOCK_HINT = ("lock", "mutex", "cond")

#: constructor dotted names that make an attribute a lock regardless of
#: what it is called — `self._cv = threading.Condition()` guards state
#: exactly like `self._lock` does, and the race pass must agree with
#: the lint on that.
LOCK_TYPES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}

#: method names whose call mutates the receiver.
MUTATING_METHODS = {
    "append", "extend", "add", "update", "insert", "remove", "discard",
    "clear", "pop", "popleft", "appendleft", "setdefault", "write",
    "mark_complete", "delete", "compact_ledger", "flush", "truncate",
}

#: exempt methods: construction and teardown run single-threaded.
EXEMPT_METHODS = {"__init__", "__new__", "__enter__", "__del__",
                  "__repr__", "__str__"}


def _lock_attr(node: ast.AST,
               known: frozenset = frozenset()) -> Optional[str]:
    """`self._writer_lock` (possibly through one hop like
    `self.jm._lock`) used as a context manager -> its attribute name.
    ``known`` extends the name hints with attributes proven to be locks
    by their constructor type (:func:`lock_attrs`)."""
    if isinstance(node, ast.Attribute) \
            and (any(h in node.attr.lower() for h in _LOCK_HINT)
                 or node.attr in known):
        return node.attr
    return None


def lock_attrs(ctx: FileContext) -> frozenset:
    """Attribute names assigned a :data:`LOCK_TYPES` constructor
    anywhere in the file (``self._cv = threading.Condition()``) — the
    type-based half of guard recognition, feeding :func:`_lock_attr`'s
    ``known`` set so oddly-named guards still count."""
    out = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call):
            dotted = ctx.resolve(node.value.func)
            if dotted in LOCK_TYPES:
                for t in node.targets:
                    a = _self_attr(t)
                    if a is not None:
                        out.add(a)
    return frozenset(out)


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X...` -> base attribute name X (`self._r._parts[s]` -> _r)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        node = node.value
    return None


class _MethodScan:
    """Per-method facts: mutations split by lock-held/not, whether the
    method ever takes a lock, and intra-class calls made outside locks."""

    def __init__(self, cls_name: str, fn: ast.FunctionDef,
                 known: frozenset = frozenset()):
        self.cls_name = cls_name
        self.fn = fn
        self.name = fn.name
        self.known = known
        #: attr -> [lineno] mutated while a lock is held
        self.locked_mut: Dict[str, List[int]] = {}
        #: attr -> [(lineno, verb)] mutated with no lock held
        self.unlocked_mut: Dict[str, List[Tuple[int, str]]] = {}
        self.takes_lock = False
        #: self.method() calls made outside any lock region
        self.unlocked_calls: Set[str] = set()
        self._walk(fn.body, depth=0)

    def _walk(self, stmts, depth: int) -> int:
        # Bare `self._lock.acquire()` / `.release()` statements adjust
        # the depth for SUBSEQUENT statements, so `acquire()` +
        # try/finally-`release()` counts as a locked region exactly
        # like `with self._lock:` does.
        for stmt in stmts:
            depth = self._visit(stmt, depth)
        return depth

    def _bare_lock_verb(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("acquire", "release") \
                and _lock_attr(expr.func.value,
                               self.known) is not None:
            return expr.func.attr
        return None

    def _visit(self, node: ast.AST, depth: int) -> int:
        if isinstance(node, ast.Expr):
            verb = self._bare_lock_verb(node.value)
            if verb == "acquire":
                self.takes_lock = True
                return depth + 1
            if verb == "release":
                return max(depth - 1, 0)
        if isinstance(node, ast.With):
            inner = depth
            for item in node.items:
                if _lock_attr(item.context_expr,
                              self.known) is not None:
                    self.takes_lock = True
                    inner = depth + 1
            self._walk(node.body, inner)
            return depth
        if isinstance(node, ast.Try):
            d = self._walk(node.body, depth)
            for h in node.handlers:
                self._walk(h.body, depth)
            d = self._walk(node.orelse, d)
            return self._walk(node.finalbody, d)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # Nested defs run later, possibly on another thread — their
            # bodies are analysed as lock-free.
            body = node.body if isinstance(node.body, list) else [node.body]
            self._walk(body, 0)
            return depth
        self._record(node, depth)
        for child in ast.iter_child_nodes(node):
            self._visit(child, depth)
        return depth

    def _record(self, node: ast.AST, depth: int):
        attr = None
        verb = "stores to"
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                a = _self_attr(t)
                if a is not None:
                    attr = a
        elif isinstance(node, ast.Delete):
            # `del self._jobs[jid]` mutates the container just like a
            # store does — the dispatcher's job table shrinks this way.
            for t in node.targets:
                a = _self_attr(t)
                if a is not None:
                    attr = a
                    verb = "deletes from"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATING_METHODS:
                attr = _self_attr(node.func.value)
                verb = f"calls .{node.func.attr}() on"
            elif isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" and depth == 0:
                self.unlocked_calls.add(node.func.attr)
        if attr is None:
            return
        if depth > 0:
            self.locked_mut.setdefault(attr, []).append(node.lineno)
        else:
            self.unlocked_mut.setdefault(attr, []).append(
                (node.lineno, verb))


@register_rule
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("lock-guarded shared attribute mutated on a path "
                   "not holding the lock")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        known = lock_attrs(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node, known))
        return out

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef,
                     known: frozenset) -> List[Finding]:
        scans = [
            _MethodScan(cls.name, item, known) for item in cls.body
            if isinstance(item, ast.FunctionDef)
        ]
        if not any(s.takes_lock for s in scans):
            return []                  # class is not lock-disciplined

        # Guarded set: mutated under a lock by any non-exempt method.
        guarded: Set[str] = set()
        for s in scans:
            if s.name in EXEMPT_METHODS:
                continue
            guarded.update(s.locked_mut)
        # Lock attributes themselves are assigned, not guarded state.
        guarded = {a for a in guarded
                   if not any(h in a.lower() for h in _LOCK_HINT)
                   and a not in known}
        if not guarded:
            return []

        # Fixed point: a method is "lock-held" if named *_locked, or if
        # every intra-class caller only reaches it from inside a lock.
        by_name = {s.name: s for s in scans}
        held = {s.name for s in scans if s.name.endswith("_locked")}
        callers: Dict[str, Set[str]] = {s.name: set() for s in scans}
        for s in scans:
            for callee in s.unlocked_calls:
                if callee in callers:
                    callers[callee].add(s.name)
        # Methods called from at least one non-held context, seeded with
        # public entry points (anything can call those unlocked).
        changed = True
        while changed:
            changed = False
            for s in scans:
                if s.name in held or s.name in EXEMPT_METHODS:
                    continue
                unlocked_callers = {c for c in callers[s.name]
                                    if c not in held
                                    and c not in EXEMPT_METHODS}
                # Called intra-class, and every such call site sits
                # inside a lock region -> treat body as lock-held.
                called_anywhere = any(
                    s.name in o.unlocked_calls
                    or self._called_locked(o, s.name, known)
                    for o in scans if o is not s)
                if called_anywhere and not unlocked_callers \
                        and self._only_called_locked(scans, s.name,
                                                     known):
                    held.add(s.name)
                    changed = True

        out: List[Finding] = []
        for s in scans:
            if s.name in EXEMPT_METHODS or s.name in held:
                continue
            for attr, sites in s.unlocked_mut.items():
                if attr not in guarded:
                    continue
                for lineno, verb in sites:
                    out.append(self.finding(
                        ctx, lineno,
                        f"{cls.name}.{s.name} {verb} `self.{attr}` "
                        f"without holding the lock that guards it "
                        f"elsewhere in {cls.name} — a concurrent "
                        f"locked writer can interleave; wrap the "
                        f"mutation in the guarding `with` block"))
        return out

    @staticmethod
    def _called_locked(scan: "_MethodScan", name: str,
                       known: frozenset = frozenset()) -> bool:
        """Does ``scan`` call self.<name>() from inside a lock region?"""
        found = False

        def visit(node, depth):
            nonlocal found
            if isinstance(node, ast.With):
                inner = depth
                for item in node.items:
                    if _lock_attr(item.context_expr,
                                  known) is not None:
                        inner = depth + 1
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == name \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" and depth > 0:
                found = True
            for child in ast.iter_child_nodes(node):
                visit(child, depth)

        for stmt in scan.fn.body:
            visit(stmt, 0)
        return found

    def _only_called_locked(self, scans, name: str,
                            known: frozenset = frozenset()) -> bool:
        any_call = False
        for o in scans:
            if name in o.unlocked_calls:
                return False
            if self._called_locked(o, name, known):
                any_call = True
        return any_call
