"""Thread-root inventory: every place the repo leaves the main thread.

The runtime moves real work onto worker threads — the fence-tail drain,
the recovery-finalize overlap, the tiered-storage writer, checkpoint
async writers, serve/replica dispatch loops, heartbeat and metrics
loops, transport request handlers. Their safety is argued by joins and
per-class lock discipline; the race pass (analysis/races.py) checks
that argument, and this module builds the ground truth it needs: the
**roots** — every function that can run off the main thread — with
their spawn sites, daemon flags, stored thread identities, and every
``start()`` / ``join()`` site that orders them.

Three spawn idioms are resolved, through the call graph
(callgraph.py: bound methods, collaborator attribute types):

- ``threading.Thread(target=self._loop)`` / ``target=module_fn`` —
  entry is the resolved method/function qname;
- ``threading.Thread(target=_closure)`` where ``_closure`` is a def
  nested in the spawning function — entry is a synthetic
  ``<spawner>.<closure>`` root whose body is analyzed in the spawner's
  ``self`` scope (the checkpoint async writer, the bootstrap overlap
  worker);
- callback servers (``ControlServer(self._handle, ...)``) — the
  handler runs on transport threads, so the handler method is a root
  even though no ``threading.Thread`` names it (the serve/replica
  endpoints, the JobMaster wire surface).

Thread identity is tracked so joins attach to the right root: a local
name (``th = Thread(...); th.join()``), a ``self.<attr>`` store
(``self._writer``), or the repo's tail-dict idiom
(``tail["thread"] = th`` joined as ``tail["thread"].join()``).

``fingerprint`` hashes the census (entries, kinds, daemon flags, join
discipline — NOT line numbers, so routine edits don't churn the pin);
``clonos_tpu_torch/.clonos-threads`` pins it and ``analyze --expect-threads`` gates
drift: a new thread root appearing without review is exactly how the
next unchecked interleaving ships.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

from clonos_tpu_torch.lint.core import FileContext

from clonos_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                 MODULE_BODY)

#: constructors whose first argument is a handler called from threads
#: the constructor owns (callback-server idiom).
CALLBACK_SERVERS = {"ControlServer"}

#: entry kinds, ordered by how much the analysis can see of them.
KIND_METHOD = "method"        # resolved in-repo method/function
KIND_CLOSURE = "closure"      # def nested in the spawning function
KIND_CALLBACK = "callback"    # handler run on a server's threads
KIND_LIBRARY = "library"      # target is library code (serve_forever)

MAIN_ROOT = "<main>"


@dataclasses.dataclass
class ThreadRoot:
    """One way off the main thread: a spawn site plus its entry."""

    root_id: str                     # stable id (entry qname, unique)
    path: str
    line: int                        # spawn site
    kind: str                        # KIND_*
    target: str                      # target expression as written
    entry: Optional[str]             # entry qname (None for library)
    daemon: bool
    spawner: str                     # qname of the spawning function
    owner_cls: Optional[str]         # class qname owning the spawner
    #: identities the Thread object is bound to: ("local", name),
    #: ("attr", name) for self.<name>, ("key", k) for d[k] = th
    idents: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    start_sites: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)        # (path, line, fn qname)
    join_sites: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)
    #: closure def node for KIND_CLOSURE roots (not serialized)
    closure_node: Optional[ast.AST] = None

    @property
    def joined(self) -> bool:
        return bool(self.join_sites)

    def to_dict(self) -> dict:
        return {
            "root_id": self.root_id, "path": self.path,
            "line": self.line, "kind": self.kind,
            "target": self.target, "entry": self.entry,
            "daemon": self.daemon, "spawner": self.spawner,
            "idents": [list(i) for i in self.idents],
            "start_sites": [list(s) for s in self.start_sites],
            "join_sites": [list(s) for s in self.join_sites],
        }


def _const_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


class ThreadInventory:
    """All thread roots over a parsed file set."""

    def __init__(self, contexts: Sequence[FileContext],
                 graph: CallGraph):
        self.graph = graph
        self.roots: List[ThreadRoot] = []
        self._ctx_by_path = {c.path: c for c in contexts}
        for ctx in contexts:
            self._scan_file(ctx)
        self._collect_start_join(contexts)
        self.roots.sort(key=lambda r: (r.path, r.line))

    # --- spawn sites ---------------------------------------------------------

    def _scan_file(self, ctx: FileContext) -> None:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.resolve(node.func)
            if dotted == "threading.Thread":
                self._add_thread_root(ctx, node)
            elif dotted is not None and node.args and \
                    dotted.rsplit(".", 1)[-1] in CALLBACK_SERVERS:
                self._add_callback_root(ctx, node, dotted)

    def _enclosing(self, ctx: FileContext,
                   line: int) -> Optional[FunctionInfo]:
        return self.graph.enclosing(ctx.path, line)

    def _add_thread_root(self, ctx: FileContext,
                         call: ast.Call) -> None:
        target_node = None
        daemon = False
        for kw in call.keywords:
            if kw.arg == "target":
                target_node = kw.value
            elif kw.arg == "daemon":
                daemon = _const_true(kw.value)
        if target_node is None and call.args:
            target_node = call.args[0]
        fi = self._enclosing(ctx, call.lineno)
        spawner = fi.qname if fi is not None else f"{ctx.path}:?"
        owner = fi.cls if fi is not None else None
        target_src = (ast.unparse(target_node)
                      if target_node is not None else "?")

        entry: Optional[str] = None
        kind = KIND_LIBRARY
        closure_node = None
        if target_node is not None and fi is not None:
            dotted = ctx.resolve(target_node)
            if dotted is not None:
                resolved = self.graph.resolve_call(fi, dotted)
                if resolved is not None:
                    entry, kind = resolved, KIND_METHOD
            if entry is None and isinstance(target_node, ast.Name):
                closure_node = self._find_closure(
                    ctx, fi, target_node.id)
                if closure_node is not None:
                    entry = f"{fi.qname}.<{target_node.id}>"
                    kind = KIND_CLOSURE
        root_id = entry if entry is not None else \
            f"{ctx.path}:{call.lineno}:{target_src}"
        # The same qname can be spawned from several sites (restarts of
        # the same worker); they are ONE root — merge spawn metadata.
        for r in self.roots:
            if r.root_id == root_id:
                r.daemon = r.daemon or daemon
                self._bind_idents(ctx, r, call)
                return
        root = ThreadRoot(
            root_id=root_id, path=ctx.path, line=call.lineno,
            kind=kind, target=target_src, entry=entry, daemon=daemon,
            spawner=spawner, owner_cls=owner,
            closure_node=closure_node)
        self._bind_idents(ctx, root, call)
        self.roots.append(root)

    def _add_callback_root(self, ctx: FileContext, call: ast.Call,
                           dotted: str) -> None:
        handler = call.args[0]
        fi = self._enclosing(ctx, call.lineno)
        if fi is None:
            return
        hdotted = ctx.resolve(handler)
        if hdotted is None:
            return
        entry = self.graph.resolve_call(fi, hdotted)
        if entry is None:
            return
        for r in self.roots:
            if r.root_id == entry:
                return
        self.roots.append(ThreadRoot(
            root_id=entry, path=ctx.path, line=call.lineno,
            kind=KIND_CALLBACK, target=ast.unparse(call.func),
            entry=entry, daemon=True, spawner=fi.qname,
            owner_cls=fi.cls))

    @staticmethod
    def _find_closure(ctx: FileContext, fi: FunctionInfo,
                      name: str) -> Optional[ast.AST]:
        """The def node of a function named ``name`` nested inside
        ``fi``'s body (the async-writer / overlap-worker idiom)."""
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name \
                    and fi.line <= node.lineno <= fi.end_line \
                    and (node.lineno, node.name) != (fi.line, fi.name):
                return node
        return None

    def _bind_idents(self, ctx: FileContext, root: ThreadRoot,
                     call: ast.Call) -> None:
        """Walk the spawning function for stores of THIS Thread(...)
        call's result: a local name, a ``self.<attr>``, or a
        ``d[key] = th`` (possibly via the local name)."""
        fi = self._enclosing(ctx, call.lineno)
        if fi is None:
            return
        node = self._fn_node(ctx, fi)
        if node is None:
            return
        local: Optional[str] = None
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and sub.value is call:
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        local = t.id
                        self._add_ident(root, ("local", t.id))
                    elif isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        self._add_ident(root, ("attr", t.attr))
        if local is None:
            return
        # Second-hop stores of the local: self.X = th / d["k"] = th.
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign) \
                    or not isinstance(sub.value, ast.Name) \
                    or sub.value.id != local:
                continue
            for t in sub.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    self._add_ident(root, ("attr", t.attr))
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.slice, ast.Constant):
                    self._add_ident(root, ("key", str(t.slice.value)))

    @staticmethod
    def _add_ident(root: ThreadRoot, ident: Tuple[str, str]) -> None:
        if ident not in root.idents:
            root.idents.append(ident)

    def _fn_node(self, ctx: FileContext,
                 fi: FunctionInfo) -> Optional[ast.AST]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == fi.name and node.lineno == fi.line:
                return node
        return None

    # --- start/join sites ----------------------------------------------------

    def _collect_start_join(self,
                            contexts: Sequence[FileContext]) -> None:
        """Attach every ``<ident>.start()`` / ``<ident>.join()`` to the
        root(s) the ident binds. Local names match inside the spawning
        function; ``self.<attr>`` and ``d[key]`` idents match anywhere
        in the owning class's file (the tail dict travels)."""
        for ctx in contexts:
            for node in ast.walk(ctx.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("start", "join")):
                    continue
                base = node.func.value
                fi = self._enclosing(ctx, node.lineno)
                fn = fi.qname if fi is not None else "?"
                site = (ctx.path, node.lineno, fn)
                for root in self.roots:
                    if self._matches(root, ctx, base, fi):
                        dest = (root.start_sites
                                if node.func.attr == "start"
                                else root.join_sites)
                        if site not in dest:
                            dest.append(site)

    @staticmethod
    def _matches(root: ThreadRoot, ctx: FileContext, base: ast.AST,
                 fi: Optional[FunctionInfo]) -> bool:
        if root.path != ctx.path:
            return False
        for kind, name in root.idents:
            if kind == "local" and isinstance(base, ast.Name) \
                    and base.id == name and fi is not None \
                    and fi.qname == root.spawner:
                return True
            if kind == "attr" and isinstance(base, ast.Attribute) \
                    and base.attr == name \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self":
                return True
            if kind == "key" and isinstance(base, ast.Subscript) \
                    and isinstance(base.slice, ast.Constant) \
                    and str(base.slice.value) == name:
                return True
        return False

    # --- queries / census ----------------------------------------------------

    def by_id(self, root_id: str) -> Optional[ThreadRoot]:
        for r in self.roots:
            if r.root_id == root_id:
                return r
        return None

    def to_dict(self) -> dict:
        return {"schema": 1,
                "roots": [r.to_dict() for r in self.roots]}

    def census(self) -> List[dict]:
        """The pinned shape: stable across line-number churn — entries,
        kinds, daemon flags, stored idents, and whether joins exist."""
        return sorted(
            ({"entry": r.root_id, "kind": r.kind, "path": r.path,
              "daemon": r.daemon, "joined": r.joined,
              "idents": sorted(f"{k}:{n}" for k, n in r.idents)}
             for r in self.roots),
            key=lambda d: d["entry"])


def fingerprint(inventory: ThreadInventory) -> str:
    """blake2b over the canonical thread census, 16 hex chars — the
    value ``clonos_tpu_torch/.clonos-threads`` pins."""
    payload = json.dumps(inventory.census(), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.blake2b(payload.encode(),
                           digest_size=8).hexdigest()


#: package-level alias (``analysis.fingerprint`` is the census's).
threads_fingerprint = fingerprint
