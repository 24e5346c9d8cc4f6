"""Interprocedural call graph over the repo's Python modules.

The lint's rules are per-function: a ``time.time()`` buried two calls
deep in a helper escapes them because the rule never sees the step
function that (transitively) calls the helper. This module builds the
missing structure: every module-level function, class method, and
module body in the analyzed file set becomes a node; edges are resolved
through the same import-alias machinery the lint uses
(:class:`clonos_tpu_torch.lint.core.FileContext`) plus a light intra-repo
type inference pass — ``self.coordinator = CheckpointCoordinator(...)``
in ``__init__`` lets ``self.coordinator.seal_epoch()`` resolve to
``CheckpointCoordinator.seal_epoch``.

Deliberately static and approximate (no execution, no dataflow): edges
the resolver cannot prove are dropped, never guessed, so a reported
reach chain is a real syntactic call path. The consumers are
``analysis/runner.py`` (nondet-escape propagation to step entry
points) and ``analysis/lockorder.py`` (lock acquisitions reached from
under a held lock).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from clonos_tpu_torch.lint.core import FileContext

#: pseudo-function name for a module's top-level statements.
MODULE_BODY = "<module>"

#: method names that run inside the block program (operator
#: processing) or ARE the block program — the analysis's "step
#: function" entry points, where a nondet reach becomes a replay
#: divergence rather than a style problem.
STEP_ENTRY_NAMES = {
    "process", "process_block", "process_block_static_keys",
    "run_block",
}


def module_name(path: str) -> str:
    """``clonos_tpu_torch/runtime/executor.py`` -> ``clonos_tpu_torch.runtime.executor``."""
    p = path[:-3] if path.endswith(".py") else path
    p = p.replace("\\", "/").lstrip("./")
    return p.replace("/", ".")


@dataclasses.dataclass
class FunctionInfo:
    """One call-graph node: a function, method, or module body."""

    qname: str                    # canonical dotted id (mod[.Cls].fn)
    path: str
    name: str
    line: int
    end_line: int
    cls: Optional[str] = None     # canonical class qname for methods
    mod: str = ""
    #: (lineno, dotted-callee-as-written) — resolved lazily by the graph
    raw_calls: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)

    def covers(self, line: int) -> bool:
        return self.line <= line <= self.end_line


class CallGraph:
    """Whole-program call graph over a set of parsed files."""

    def __init__(self, contexts: Sequence[FileContext]):
        #: qname -> node
        self.functions: Dict[str, FunctionInfo] = {}
        #: canonical class qname -> path
        self.classes: Dict[str, str] = {}
        #: (class qname, attr) -> class qname of the instance stored there
        self.attr_types: Dict[Tuple[str, str], str] = {}
        #: caller qname -> {callee qname}
        self.edges: Dict[str, Set[str]] = {}
        #: path -> nodes in that file, for line -> function lookup
        self._by_path: Dict[str, List[FunctionInfo]] = {}
        self._ctx_by_path: Dict[str, FileContext] = {}

        for ctx in contexts:
            self._index_file(ctx)
        for ctx in contexts:
            self._collect_attr_types(ctx)
        self._resolve_edges()

    # --- pass 1: index ------------------------------------------------------

    def _index_file(self, ctx: FileContext) -> None:
        mod = module_name(ctx.path)
        self._ctx_by_path[ctx.path] = ctx
        nodes: List[FunctionInfo] = []

        def add(fi: FunctionInfo) -> None:
            # Later definitions shadow earlier ones (redefinition), which
            # matches runtime binding order.
            self.functions[fi.qname] = fi
            nodes.append(fi)

        def collect_calls(fn_node: ast.AST, fi: FunctionInfo) -> None:
            for sub in ast.walk(fn_node):
                if isinstance(sub, ast.Call):
                    dotted = ctx.resolve(sub.func)
                    if dotted is not None:
                        fi.raw_calls.append((sub.lineno, dotted))

        for item in ctx.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(
                    qname=f"{mod}.{item.name}", path=ctx.path,
                    name=item.name, line=item.lineno,
                    end_line=item.end_lineno or item.lineno, mod=mod)
                collect_calls(item, fi)
                add(fi)
            elif isinstance(item, ast.ClassDef):
                cq = f"{mod}.{item.name}"
                self.classes[cq] = ctx.path
                for m in item.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        fi = FunctionInfo(
                            qname=f"{cq}.{m.name}", path=ctx.path,
                            name=m.name, line=m.lineno,
                            end_line=m.end_lineno or m.lineno,
                            cls=cq, mod=mod)
                        collect_calls(m, fi)
                        add(fi)
        # Module body: everything not inside a def/class def above.
        body_fi = FunctionInfo(
            qname=f"{mod}.{MODULE_BODY}", path=ctx.path,
            name=MODULE_BODY, line=1,
            end_line=len(ctx.lines) or 1, mod=mod)
        for item in ctx.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for sub in ast.walk(item):
                if isinstance(sub, ast.Call):
                    dotted = ctx.resolve(sub.func)
                    if dotted is not None:
                        body_fi.raw_calls.append((sub.lineno, dotted))
        self.functions[body_fi.qname] = body_fi
        nodes.append(body_fi)
        # Innermost span first for line lookup (module body spans all).
        self._by_path[ctx.path] = sorted(
            nodes, key=lambda f: (f.end_line - f.line))

    # --- pass 2: instance-attribute types -----------------------------------

    def _collect_attr_types(self, ctx: FileContext) -> None:
        mod = module_name(ctx.path)
        for item in ctx.tree.body:
            if not isinstance(item, ast.ClassDef):
                continue
            cq = f"{mod}.{item.name}"
            for m in item.body:
                if not isinstance(m, ast.FunctionDef):
                    continue
                for sub in ast.walk(m):
                    if not isinstance(sub, ast.Assign) \
                            or not isinstance(sub.value, ast.Call):
                        continue
                    tgt_cls = self._class_of(ctx, mod, sub.value.func)
                    if tgt_cls is None:
                        continue
                    for t in sub.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            self.attr_types[(cq, t.attr)] = tgt_cls

    def _class_of(self, ctx: FileContext, mod: str,
                  func: ast.AST) -> Optional[str]:
        dotted = ctx.resolve(func)
        if dotted is None:
            return None
        if dotted in self.classes:
            return dotted
        cand = f"{mod}.{dotted}"
        if cand in self.classes:
            return cand
        return None

    # --- pass 3: edge resolution --------------------------------------------

    def resolve_call(self, fi: FunctionInfo,
                     dotted: str) -> Optional[str]:
        """Map a dotted callee as written in ``fi`` to a graph node."""
        parts = dotted.split(".")
        if parts[0] == "self" and fi.cls is not None:
            if len(parts) == 2:
                cand = f"{fi.cls}.{parts[1]}"
                return cand if cand in self.functions else None
            if len(parts) == 3:
                tgt = self.attr_types.get((fi.cls, parts[1]))
                if tgt is not None:
                    cand = f"{tgt}.{parts[2]}"
                    return cand if cand in self.functions else None
            return None
        for cand in (dotted, f"{fi.mod}.{dotted}"):
            if cand in self.functions:
                return cand
            if cand in self.classes:
                init = f"{cand}.__init__"
                return init if init in self.functions else None
        return None

    def _resolve_edges(self) -> None:
        for fi in self.functions.values():
            outs = self.edges.setdefault(fi.qname, set())
            for _line, dotted in fi.raw_calls:
                tgt = self.resolve_call(fi, dotted)
                if tgt is not None and tgt != fi.qname:
                    outs.add(tgt)

    # --- queries ------------------------------------------------------------

    def enclosing(self, path: str, line: int) -> Optional[FunctionInfo]:
        """Innermost function (or module body) containing ``path:line``."""
        for fi in self._by_path.get(path, ()):
            if fi.covers(line):
                return fi
        return None

    def step_entries(self) -> List[FunctionInfo]:
        return sorted(
            (fi for fi in self.functions.values()
             if fi.name in STEP_ENTRY_NAMES and fi.cls is not None),
            key=lambda f: f.qname)

    def chain(self, start: str, targets: Set[str]
              ) -> Optional[List[str]]:
        """Shortest call chain from ``start`` to any of ``targets``
        (BFS), as a qname list including both endpoints; None if
        unreachable."""
        if start in targets:
            return [start]
        parent: Dict[str, str] = {start: start}
        frontier = [start]
        while frontier:
            nxt: List[str] = []
            for f in frontier:
                for g in sorted(self.edges.get(f, ())):
                    if g in parent:
                        continue
                    parent[g] = f
                    if g in targets:
                        out = [g]
                        while out[-1] != start:
                            out.append(parent[out[-1]])
                        return list(reversed(out))
                    nxt.append(g)
            frontier = nxt
        return None
