"""Whole-program static race detection over the thread-root inventory.

Clonos's correctness story is that every nondeterministic interleaving
is either logged as a determinant or structurally impossible. The
overlapped pipelines (fence tail, recovery finalize, tiered writer,
checkpoint async writers, serve loops, heartbeat/metrics loops) are the
"structurally impossible" half — argued until now by hand-placed joins
and per-class lock discipline. This pass checks the argument, in the
Eraser lockset tradition refined with happens-before edges (RacerD's
compositional spirit: syntactic, no execution, quiet on the repo's own
conventions):

1. **Access sets** — from every thread root (analysis/threads.py),
   interprocedural reachability over the call graph to
   ``self.attr`` and one-hop collaborator (``self.obj.attr``) reads,
   writes, and mutating calls, each annotated with the lock set held
   at the site (lockorder.py's resolution, so the race pass and the
   lock-order pass agree on lock identities).
2. **Lockset ∩ happens-before** — an attribute touched by ≥2 roots
   with ≥1 write is a finding iff the roots' guard sets are disjoint
   AND no happens-before edge discharges the pair. Modeled edges:

   - ``pre-start``: writes in the spawning function before
     ``Thread.start()`` are published to the thread (this covers the
     dispatch-only overlap windows: everything inside the markers runs
     before the tail thread starts);
   - ``join``: accesses after ``t.join()`` in the same function — or
     after a call to a function that joins t (the repo's
     at-most-one-tail join points, e.g. ``run_epoch`` calling
     ``_join_fence_tail`` before touching tail state) — are ordered
     after the worker's writes;
   - ``handoff``: ``queue.Queue`` put/get and ``threading.Event``
     set/wait are synchronization objects; traffic through them is
     ordered (and the objects themselves are thread-safe);
   - ``publish``: a single writing root whose every write is a plain
     scalar attribute assignment, read by other roots — the repo's
     documented lock-free monotonic-publish convention (GIL-atomic
     pointer swap; the lint's "reads are not flagged" rule, made
     explicit and checkable).

3. **Rule split** — conflicting *writes* from two roots are a
   ``thread-race`` ERROR; a root's written product *read* by another
   root with no join/guard/handoff is a ``join-discipline`` ERROR (the
   invariant the overlapped runtime keeps only by comment: never read a
   worker's
   product without joining it first).

Findings name the racing attribute, BOTH roots, the access sites, the
missing edge/guard, and the minimal call chain from the root's entry to
the access — the same addressable-counterexample convention as
``verify``'s traces. A seeded-bug registry (``SEEDED_BUGS``) proves
each rule bites: ``analyze --races --seed-bug drop-a-join`` must
exit 1.

Approximations (deliberate, in the lint's spirit — drop, never guess):
accesses through untyped locals/parameters are invisible; reach chains
use resolved call edges only; ``__init__``/teardown are exempt
(single-threaded by repo convention). A miss is possible; a report is
a real syntactic interleaving.
"""

from __future__ import annotations

import ast
import dataclasses
import textwrap
from typing import Dict, List, Optional, Sequence, Set, Tuple

from clonos_tpu_torch.lint.core import (ERROR, FileContext, Finding, Rule,
                                        register_rule)
from clonos_tpu_torch.lint.concurrency import (EXEMPT_METHODS,
                                               MUTATING_METHODS, _self_attr)

from clonos_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from clonos_tpu_torch.analysis.lockorder import LockOrderGraph
from clonos_tpu_torch.analysis.threads import (KIND_CLOSURE, MAIN_ROOT,
                                               ThreadInventory, ThreadRoot)

THREAD_RACE = "thread-race"
JOIN_DISCIPLINE = "join-discipline"

RACE_RULES = {THREAD_RACE, JOIN_DISCIPLINE}

#: attribute types that ARE synchronization/handoff objects — calls on
#: them are ordered by construction, never racy.
_HANDOFF_TYPES = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "threading.Event",
}
_LOCK_TYPES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}
_THREAD_TYPES = {"threading.Thread"}


@register_rule
class ThreadRaceRule(Rule):
    """Registry placeholder so waivers can reference ``thread-race``;
    the check is whole-program (it needs the thread-root inventory and
    call graph) and runs from the ``analyze`` verb."""

    name = THREAD_RACE
    description = ("unguarded conflicting writes to one attribute from "
                   "two thread roots (whole-program: enforced by "
                   "`python -m clonos_tpu_torch analyze --races`)")

    def check(self, ctx: FileContext) -> List[Finding]:
        return []


@register_rule
class JoinDisciplineRule(Rule):
    """Registry placeholder for ``join-discipline`` (same arrangement
    as ``thread-race``)."""

    name = JOIN_DISCIPLINE
    description = ("worker thread's product read without a dominating "
                   "join/guard/handoff (whole-program: enforced by "
                   "`python -m clonos_tpu_torch analyze --races`)")

    def check(self, ctx: FileContext) -> List[Finding]:
        return []


READ, WRITE, MUTATE = "read", "write", "mutate"


@dataclasses.dataclass(frozen=True)
class Access:
    """One shared-state touch: ``cls.attr`` at ``path:line`` in ``fn``
    with ``held`` locks. ``plain`` marks a bare scalar attribute
    assignment (the publishable kind)."""

    cls: str
    attr: str
    kind: str                    # READ / WRITE / MUTATE
    plain: bool
    path: str
    line: int
    fn: str
    held: Tuple[str, ...]

    @property
    def writes(self) -> bool:
        return self.kind in (WRITE, MUTATE)


class _AttrTypes:
    """(class qname, attr) -> coarse type tag for lock/handoff/thread
    attrs, collected from constructor-call assignments anywhere in the
    class (``self._cv = threading.Condition()``)."""

    def __init__(self, contexts: Sequence[FileContext],
                 graph: CallGraph):
        self.tags: Dict[Tuple[str, str], str] = {}
        from clonos_tpu_torch.analysis.callgraph import module_name
        for ctx in contexts:
            mod = module_name(ctx.path)
            for cls_node in ast.walk(ctx.tree):
                if not isinstance(cls_node, ast.ClassDef):
                    continue
                cq = f"{mod}.{cls_node.name}"
                for sub in ast.walk(cls_node):
                    if not (isinstance(sub, ast.Assign)
                            and isinstance(sub.value, ast.Call)):
                        continue
                    dotted = ctx.resolve(sub.value.func)
                    if dotted is None:
                        continue
                    tag = None
                    if dotted in _LOCK_TYPES:
                        tag = "lock"
                    elif dotted in _HANDOFF_TYPES:
                        tag = "handoff"
                    elif dotted in _THREAD_TYPES:
                        tag = "thread"
                    if tag is None:
                        continue
                    for t in sub.targets:
                        a = _self_attr(t)
                        if a is not None:
                            self.tags[(cq, a)] = tag

    def tag(self, cls: str, attr: str) -> Optional[str]:
        return self.tags.get((cls, attr))


class RaceAnalysis:
    """Access-set construction + lockset/happens-before checking."""

    def __init__(self, contexts: Sequence[FileContext],
                 graph: CallGraph, lockgraph: LockOrderGraph,
                 inventory: ThreadInventory):
        self.graph = graph
        self.lock = lockgraph
        self.inventory = inventory
        self._ctx_by_path = {c.path: c for c in contexts}
        self.attr_types = _AttrTypes(contexts, graph)
        #: fn qname -> accesses recorded in its body (closure-root
        #: bodies excluded — they belong to their root)
        self._fn_accesses: Dict[str, List[Access]] = {}
        #: closure root id -> its body's accesses
        self._closure_accesses: Dict[str, List[Access]] = {}
        #: closure root id -> resolved callee qnames from its body
        self._closure_calls: Dict[str, Set[str]] = {}
        self._closure_spans: Dict[str, Tuple[int, int]] = {
            r.path: (0, 0) for r in ()}  # filled in _scan_all
        self._closure_nodes = {
            id(r.closure_node): r.root_id
            for r in inventory.roots
            if r.kind == KIND_CLOSURE and r.closure_node is not None}
        self._scan_all()
        self.root_reach: Dict[str, Set[str]] = {}
        self.root_access: Dict[str, List[Access]] = {}
        self._build_roots()
        #: root id -> fn qname -> locks held on EVERY path from the
        #: root's entry to the fn (per-root: the same helper can be
        #: always-locked inside the callback root and lock-free on the
        #: main path)
        self._always_held: Dict[str, Dict[str, Tuple[str, ...]]] = {
            rid: self._always_held_fixpoint(rid)
            for rid in self.root_reach}

    # --- access scanning -----------------------------------------------------

    def _scan_all(self) -> None:
        for fi in self.graph.functions.values():
            ctx = self._ctx_by_path.get(fi.path)
            if ctx is None or fi.cls is None:
                continue          # only methods touch self state
            if fi.name in EXEMPT_METHODS:
                continue          # construction/teardown: single-threaded
            node = self.lock._def_index[ctx.path].get((fi.name, fi.line))
            if node is None:
                continue
            self.lock._params = self.lock._param_types(node)
            out: List[Access] = []
            self._walk(ctx, fi, node.body, (), out, skip_closures=True)
            self._fn_accesses[fi.qname] = out
        # Closure roots: scan the nested def in the spawner's scope.
        for root in self.inventory.roots:
            if root.kind != KIND_CLOSURE or root.closure_node is None:
                continue
            ctx = self._ctx_by_path.get(root.path)
            fi = self.graph.functions.get(root.spawner)
            if ctx is None or fi is None:
                continue
            node = self.lock._def_index[ctx.path].get(
                (fi.name, fi.line))
            self.lock._params = (self.lock._param_types(node)
                                 if node is not None else {})
            out: List[Access] = []
            calls: Set[str] = set()
            self._walk(ctx, fi, root.closure_node.body, (), out,
                       skip_closures=False, call_sink=calls)
            self._closure_accesses[root.root_id] = out
            self._closure_calls[root.root_id] = calls

    def _walk(self, ctx: FileContext, fi: FunctionInfo, stmts,
              held: Tuple[str, ...], out: List[Access],
              skip_closures: bool,
              call_sink: Optional[Set[str]] = None
              ) -> Tuple[str, ...]:
        for stmt in stmts:
            held = self._visit(ctx, fi, stmt, held, out,
                               skip_closures, call_sink)
        return held

    def _visit(self, ctx: FileContext, fi: FunctionInfo, node: ast.AST,
               held: Tuple[str, ...], out: List[Access],
               skip_closures: bool,
               call_sink: Optional[Set[str]]) -> Tuple[str, ...]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if skip_closures and id(node) in self._closure_nodes:
                return held       # a thread root's body, not this fn's
            # Other nested defs run later, possibly off-thread: analyze
            # lock-free (concurrency.py's rule), same fn attribution.
            self._walk(ctx, fi, node.body, (), out, skip_closures,
                       call_sink)
            return held
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                lock = self.lock._lock_id(ctx, fi, item.context_expr)
                if lock is not None and lock not in inner:
                    inner = inner + (lock,)
            self._walk(ctx, fi, node.body, inner, out, skip_closures,
                       call_sink)
            return held
        if isinstance(node, ast.Expr):
            lock, kind = self.lock._bare_lock_call(ctx, fi, node.value)
            if kind == "acquire":
                if lock not in held:
                    held = held + (lock,)
                return held
            if kind == "release":
                return tuple(h for h in held if h != lock)
        if call_sink is not None and isinstance(node, ast.Call):
            dotted = ctx.resolve(node.func)
            if dotted is not None:
                tgt = self.graph.resolve_call(fi, dotted)
                if tgt is not None:
                    call_sink.add(tgt)
        self._record(ctx, fi, node, held, out)
        for child in ast.iter_child_nodes(node):
            held = self._visit(ctx, fi, child, held, out,
                               skip_closures, call_sink)
        return held

    def _record(self, ctx: FileContext, fi: FunctionInfo,
                node: ast.AST, held: Tuple[str, ...],
                out: List[Access]) -> None:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                self._record_store(fi, t, node.lineno, held, out)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    self._emit(fi, attr, WRITE, False, node.lineno,
                               held, out)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATING_METHODS:
                attr = _self_attr(node.func.value)
                if attr is not None:
                    self._emit(fi, attr, MUTATE, False, node.lineno,
                               held, out)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            # A plain `self.X` read. Method references are calls, not
            # shared state; lock/handoff/thread objects are sync
            # primitives, not data.
            if fi.cls is not None \
                    and f"{fi.cls}.{node.attr}" in self.graph.functions:
                return
            self._emit(fi, node.attr, READ, True, node.lineno, held,
                       out)

    def _record_store(self, fi: FunctionInfo, target: ast.AST,
                      lineno: int, held: Tuple[str, ...],
                      out: List[Access]) -> None:
        plain = (isinstance(target, ast.Attribute)
                 and isinstance(target.value, ast.Name)
                 and target.value.id == "self")
        attr = _self_attr(target)
        if attr is not None:
            self._emit(fi, attr, WRITE, plain, lineno, held, out)

    def _emit(self, fi: FunctionInfo, attr: str, kind: str,
              plain: bool, lineno: int, held: Tuple[str, ...],
              out: List[Access]) -> None:
        if fi.cls is None:
            return
        tag = self.attr_types.tag(fi.cls, attr)
        if tag in ("lock", "handoff", "thread"):
            return                 # sync primitives, not shared data
        out.append(Access(cls=fi.cls, attr=attr, kind=kind,
                          plain=plain, path=fi.path, line=lineno,
                          fn=fi.qname, held=held))

    # --- guard closure -------------------------------------------------------

    def _root_entries(self, rid: str) -> Set[str]:
        """Functions where this root's execution begins (always-held
        is empty there)."""
        if rid == MAIN_ROOT:
            domain = self.root_reach[rid]
            called: Set[str] = set()
            for q in domain:
                facts = self.lock._fn_locks.get(q)
                if facts is None:
                    continue
                for callee, _line, _held in facts.calls:
                    if callee in domain:
                        called.add(callee)
            return domain - called or domain
        root = self.inventory.by_id(rid)
        if root is None:
            return set()
        if root.kind == KIND_CLOSURE:
            return set(self._closure_calls.get(rid, ()))
        return {root.entry} if root.entry else set()

    def _always_held_fixpoint(self, rid: str
                              ) -> Dict[str, Tuple[str, ...]]:
        """Locks held on every path from the root's entry to each
        reachable function — accesses in its body inherit them
        (``_compact_locked`` is only ever called under
        ``MetricsHistory._lock`` on the history root, so its mutations
        count as guarded there). Transitive meet-over-call-sites
        fixpoint scoped to the root's reach; the same helper gets a
        DIFFERENT answer per root, which is the whole point."""
        domain = self.root_reach[rid]
        entries = self._root_entries(rid)
        # callee -> [(caller, held-at-site)] restricted to the domain
        sites: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}
        for q in domain:
            facts = self.lock._fn_locks.get(q)
            if facts is None:
                continue
            for callee, _line, held in facts.calls:
                if callee in domain:
                    sites.setdefault(callee, []).append((q, held))
        ah: Dict[str, Optional[Set[str]]] = {q: None for q in domain}
        for e in entries:
            if e in ah:
                ah[e] = set()
        changed = True
        while changed:
            changed = False
            for callee, callers in sites.items():
                if callee in entries:
                    continue
                new: Optional[Set[str]] = None
                for caller, held in callers:
                    inherited = ah.get(caller)
                    if inherited is None:
                        continue       # caller not yet resolved
                    at = set(held) | inherited
                    new = at if new is None else (new & at)
                if new is not None and new != ah.get(callee):
                    ah[callee] = new
                    changed = True
        return {q: tuple(sorted(v)) for q, v in ah.items()
                if v}                   # unresolved (None) -> no locks

    def _guards(self, a: Access, rid: str) -> Set[str]:
        return set(a.held) | set(
            self._always_held.get(rid, {}).get(a.fn, ()))

    # --- root access sets ----------------------------------------------------

    def _reach(self, seeds: Sequence[str]) -> Set[str]:
        seen: Set[str] = set()
        frontier = [s for s in seeds if s in self.graph.functions]
        seen.update(frontier)
        while frontier:
            nxt: List[str] = []
            for f in frontier:
                for g in self.graph.edges.get(f, ()):
                    if g not in seen:
                        seen.add(g)
                        nxt.append(g)
            frontier = nxt
        return seen

    def _build_roots(self) -> None:
        thread_fns: Set[str] = set()
        for root in self.inventory.roots:
            if root.kind == KIND_CLOSURE:
                reach = self._reach(
                    sorted(self._closure_calls.get(root.root_id, ())))
                accesses = list(
                    self._closure_accesses.get(root.root_id, ()))
            elif root.entry is not None:
                reach = self._reach([root.entry])
                accesses = []
            else:
                continue           # library target: nothing visible
            for fn in reach:
                accesses.extend(self._fn_accesses.get(fn, ()))
            self.root_reach[root.root_id] = reach
            self.root_access[root.root_id] = accesses
            thread_fns |= reach
        # Main root: every method NOT reachable from any thread entry.
        # Shared helpers are charged to the thread roots that reach
        # them (their main-side use follows the same discipline the
        # roots are checked against) — an under-approximation that
        # keeps reports real.
        main: List[Access] = []
        for fn, accesses in self._fn_accesses.items():
            if fn not in thread_fns:
                main.extend(accesses)
        self.root_reach[MAIN_ROOT] = set(self._fn_accesses) - thread_fns
        self.root_access[MAIN_ROOT] = main

    # --- happens-before ------------------------------------------------------

    def _discharged(self, a: Access, root: ThreadRoot) -> Optional[str]:
        """Is main-side access ``a`` ordered against ``root`` by a
        pre-start or join edge? Returns the edge name."""
        for path, line, fn in root.start_sites:
            if a.fn == fn and a.line < line:
                return "pre-start"
        join_fns = {fn for _p, _l, fn in root.join_sites}
        for path, line, fn in root.join_sites:
            if a.fn == fn and a.line > line:
                return "join"
        # Join-call dominance: an earlier call in a's function to a
        # function that joins the root (the at-most-one-tail join
        # points: run_epoch calls _join_fence_tail first).
        facts = self.lock._fn_locks.get(a.fn)
        if facts is not None:
            for callee, line, _held in facts.calls:
                if callee in join_fns and line < a.line:
                    return "join"
        return None

    # --- the check -----------------------------------------------------------

    def findings(self) -> List[Finding]:
        by_attr: Dict[Tuple[str, str], Dict[str, List[Access]]] = {}
        for rid, accesses in self.root_access.items():
            for a in accesses:
                by_attr.setdefault((a.cls, a.attr), {}) \
                    .setdefault(rid, []).append(a)

        out: List[Finding] = []
        for (cls, attr), parties in sorted(by_attr.items()):
            if len(parties) < 2:
                continue
            if not any(a.writes for acc in parties.values()
                       for a in acc):
                continue
            rids = sorted(parties)
            for i, r1 in enumerate(rids):
                for r2 in rids[i + 1:]:
                    f = self._check_pair(cls, attr, r1, parties[r1],
                                         r2, parties[r2])
                    if f is not None:
                        out.append(f)
        return sorted(out, key=lambda f: (f.path, f.line, f.rule))

    def _effective(self, rid_self: str, acc: List[Access],
                   rid_other: str) -> List[Access]:
        """Accesses of ``rid_self`` not ordered against ``rid_other``
        by pre-start/join edges (edges only order the side that does
        NOT run on the other root's thread)."""
        other = self.inventory.by_id(rid_other)
        if other is None or rid_self in (
                r.root_id for r in [other]):
            return acc
        # A root's own accesses are never pre-start/join discharged
        # against main; only the spawning/joining side is ordered.
        if rid_self == MAIN_ROOT or not self._runs_inside(
                rid_self, rid_other):
            return [a for a in acc
                    if self._discharged(a, other) is None]
        return acc

    def _runs_inside(self, rid: str, other_rid: str) -> bool:
        """Does root ``rid``'s code run on ``other_rid``'s thread?
        (Then start/join edges of other_rid cannot order it.)"""
        return rid == other_rid

    def _check_pair(self, cls: str, attr: str,
                    r1: str, acc1: List[Access],
                    r2: str, acc2: List[Access]) -> Optional[Finding]:
        eff1 = self._effective(r1, acc1, r2)
        eff2 = self._effective(r2, acc2, r1)
        if not eff1 or not eff2:
            return None            # fully ordered by pre-start/join
        if not any(a.writes for a in eff1 + eff2):
            return None
        w1 = [a for a in eff1 if a.writes]
        w2 = [a for a in eff2 if a.writes]
        gw1 = (set.intersection(*(self._guards(a, r1) for a in w1))
               if w1 else None)
        gw2 = (set.intersection(*(self._guards(a, r2) for a in w2))
               if w2 else None)
        short = f"{cls.rsplit('.', 1)[-1]}.{attr}"

        # Write/write: the two writers need a common guard.
        if w1 and w2 and not (gw1 & gw2):
            anchor = min(w1 + w2, key=lambda a: (a.path, a.line))
            return self._mk(THREAD_RACE, anchor, short, r1, r2,
                            gw1, gw2, eff1, eff2,
                            "no common guard orders the two writers "
                            "(write/write)")

        # Read/write: every read must share a guard with the other
        # side's writes, unless every write to the attribute is a
        # plain scalar assignment (the repo's lock-free monotonic
        # publish: a GIL-atomic reference swap is safe to read bare;
        # structural mutation is not).
        all_writes = w1 + w2
        publishable = all(a.kind == WRITE and a.plain
                          for a in all_writes)
        for reads, rid_r, wguard, rid_w in (
                ([a for a in eff1 if not a.writes], r1, gw2, r2),
                ([a for a in eff2 if not a.writes], r2, gw1, r1)):
            if wguard is None:
                continue           # other side never writes
            bare = [a for a in reads
                    if not (self._guards(a, rid_r) & wguard)]
            if not bare or publishable:
                continue
            anchor = min(bare, key=lambda a: (a.path, a.line))
            return self._mk(
                JOIN_DISCIPLINE, anchor, short, r1, r2, gw1, gw2,
                eff1, eff2,
                f"the read is not dominated by a join on "
                f"{self._root_name(rid_w)} and no shared "
                f"guard/handoff orders it")
        return None

    def _mk(self, rule: str, anchor: Access, short: str,
            r1: str, r2: str, gw1: Optional[Set[str]],
            gw2: Optional[Set[str]], eff1: List[Access],
            eff2: List[Access], missing: str) -> Finding:
        def _g(g: Optional[Set[str]]) -> str:
            return "no-writes" if g is None else (
                str(sorted(g)) if g else "unguarded")
        chains = "; ".join(filter(None, (
            self._chain_text(r1, eff1), self._chain_text(r2, eff2))))
        sites = ", ".join(sorted({
            f"{a.path}:{a.line} ({a.kind})" for a in eff1 + eff2}))
        return Finding(
            rule=rule, path=anchor.path, line=anchor.line,
            severity=ERROR,
            message=f"`{short}` is touched by thread roots "
                    f"{self._root_name(r1)} and {self._root_name(r2)} "
                    f"with at least one write and disjoint guard sets "
                    f"(write guards: {_g(gw1)} vs {_g(gw2)}) — "
                    f"{missing}; sites: {sites}; {chains}. Add a "
                    f"shared lock, hand the value through a "
                    f"queue/Event, join the worker first, or waive "
                    f"with a justification")

    def _root_name(self, rid: str) -> str:
        if rid == MAIN_ROOT:
            return "<main>"
        return rid

    def _chain_text(self, rid: str, acc: List[Access]) -> str:
        if rid == MAIN_ROOT or not acc:
            return ""
        root = self.inventory.by_id(rid)
        if root is None:
            return ""
        target = acc[0].fn
        if root.kind == KIND_CLOSURE:
            if target == root.spawner:      # closure body access
                return f"chain[{rid}]: {rid} (closure body)"
            seeds = sorted(self._closure_calls.get(rid, ()))
            for s in seeds:
                chain = self.graph.chain(s, {target})
                if chain is not None:
                    hops = " -> ".join([rid] + chain)
                    return f"chain[{rid}]: {hops}"
            return f"chain[{rid}]: {rid} -> ... -> {target}"
        if root.entry is None:
            return ""
        chain = self.graph.chain(root.entry, {target})
        if chain is None:
            return f"chain[{rid}]: {root.entry} -> ... -> {target}"
        return f"chain[{rid}]: {' -> '.join(chain)}"


def run_races(contexts: Sequence[FileContext], graph: CallGraph,
              lockgraph: LockOrderGraph,
              inventory: ThreadInventory) -> List[Finding]:
    """The race pass: lockset ∩ happens-before findings over the
    thread-root inventory."""
    return RaceAnalysis(contexts, graph, lockgraph,
                        inventory).findings()


# --- seeded-bug registry -----------------------------------------------------

#: Each entry is a minimal module that MUST produce exactly one finding
#: of the named rule on the named attribute — the proof the rule bites,
#: runnable as ``python -m clonos_tpu_torch analyze --seed-bug <name>``
#: (exit 1) and pinned by tests/test_torch_races.py. Each source also
#: contains the correct twin of the pattern (joined / guarded / through
#: the queue), which must stay quiet — the registry checks both
#: directions.
SEEDED_BUGS: Dict[str, Dict[str, str]] = {
    "drop-a-join": {
        "rule": JOIN_DISCIPLINE,
        "attr": "Runner._product",
        "source": """\
            import threading

            class Runner:
                def __init__(self):
                    self._product = []
                    self._joined_product = []
                    self._t = threading.Thread(target=self._work)
                    self._t2 = threading.Thread(target=self._work2)

                def _work(self):
                    self._product.append(1)

                def _work2(self):
                    self._joined_product.append(1)

                def run(self):
                    self._t.start()
                    return list(self._product)      # BUG: no join

                def run_joined(self):
                    self._t2.start()
                    self._t2.join()
                    return list(self._joined_product)   # ordered
            """,
    },
    "unguarded-cross-thread-write": {
        "rule": THREAD_RACE,
        "attr": "Counter._totals",
        "source": """\
            import threading

            class Counter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._totals = {}
                    self._guarded = {}
                    self._t = threading.Thread(target=self._loop,
                                               daemon=True)
                    self._t.start()

                def _loop(self):
                    self._totals["beat"] = 1        # BUG: no lock
                    with self._lock:
                        self._guarded["beat"] = 1

                def bump(self, k):
                    with self._lock:
                        self._totals[k] = self._totals.get(k, 0) + 1
                        self._guarded[k] = 1
            """,
    },
    "queue-bypass": {
        "rule": THREAD_RACE,
        "attr": "Pipeline._latest",
        "source": """\
            import queue
            import threading

            class Pipeline:
                def __init__(self):
                    self._q = queue.Queue()
                    self._latest = {}
                    self._t = threading.Thread(target=self._produce,
                                               daemon=True)
                    self._t.start()

                def _produce(self):
                    item = object()
                    self._q.put(item)               # ordered handoff
                    self._latest["last"] = item     # BUG: bypasses it

                def drain(self):
                    out = self._q.get()             # ordered handoff
                    self._latest.clear()            # races the bypass
                    return out
            """,
    },
}


def seeded_findings(name: str) -> List[Finding]:
    """Run the full race pipeline over one seeded-bug module."""
    if name not in SEEDED_BUGS:
        raise ValueError(
            f"unknown seeded bug {name!r} — known: "
            f"{', '.join(sorted(SEEDED_BUGS))}")
    src = textwrap.dedent(SEEDED_BUGS[name]["source"])
    ctx = FileContext(f"<seed:{name}>.py", src)
    graph = CallGraph([ctx])
    lockgraph = LockOrderGraph([ctx], graph)
    inventory = ThreadInventory([ctx], graph)
    return run_races([ctx], graph, lockgraph, inventory)
