"""Rule family 2: replay and sync safety of operator step functions.

Operator bodies (``process`` / ``process2`` / ``process_block`` methods
and the lambdas handed to ``StreamEnvironment.map``/``filter``) are not
traced in the port: each runs eagerly on the card once per block
(api/operators.py), queued behind the block before it. Three host-level
constructs break that:

- **host branches** — a Python ``if``/``while``/ternary on a tensor
  parameter calls ``bool()`` on it, an implicit ``.item()``: the host
  waits for every queued kernel, and the path taken is decided from
  device data on the host, where replay cannot see it;
- **mutable closures** — a step function mutating a captured host
  object smuggles state around the carry: it is invisible to the
  checkpoint, so a rebuilt worker starts from a different value;
- **host calls** — ``print``/``open`` inside a block body have effects
  that are not replayed, and ``torch.cuda.synchronize`` / ``.item()`` /
  ``.tolist()`` / ``.cpu()`` / ``.numpy()`` stall the host on the
  device once per block.

Static config branches (``if self.reduce_fn is not torch.add``) are
fine and not flagged: the rules trigger only on direct mentions of the
step function's tensor parameters (state/batch/ctx and their kin), with
static reads exempt — ``.shape``/``.dtype``/``.ndim``/``.device`` and
``.dim()``/``.numel()``/``.size(...)`` answer from tensor metadata on
the host, without touching the card.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from clonos_tpu_torch.lint.core import (FileContext, Finding, Rule,
                                        register_rule)

#: operator entry points, per the Operator base contract.
TRACED_METHODS = {"process", "process2", "process_block",
                  "process_block_static_keys"}

#: StreamEnvironment combinators whose fn argument traces.
TRACED_COMBINATORS = {"map", "filter"}

#: tensor metadata the host holds without asking the card — mentions
#: beneath them are not host branches on tensor *values*.
STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "device", "dim",
                "numel", "is_cuda"}

#: host calls that must not appear inside a block body: unreplayed
#: effects, or a wait for the whole device queue.
HOST_CALLS = {
    "print", "input", "open", "breakpoint", "exec", "eval",
    "torch.cuda.synchronize",
}
#: tensor methods that copy to the host and wait for the device.
HOST_METHOD_CALLS = {"item", "tolist", "cpu", "numpy"}

MUTATORS = {"append", "extend", "add", "update", "insert", "remove",
            "discard", "clear", "pop", "popleft", "appendleft",
            "setdefault", "write"}

#: decorators that put a def's body under capture (``torch.compile``,
#: a CUDA-graph capture helper): a host branch inside one is baked in
#: at capture time. Empty because no module of the port compiles or
#: captures a body — every block body runs eagerly; name the decorator
#: here when one does.
TRACED_DECORATORS: frozenset = frozenset()


def _traced_roots(ctx: FileContext) -> List[Tuple[ast.AST, Set[str]]]:
    """(function node, traced param names) for every step-function body
    in the file: operator methods, defs under a
    :data:`TRACED_DECORATORS` decorator, and combinator lambdas/defs."""
    roots: List[Tuple[ast.AST, Set[str]]] = []
    module_defs = {n.name: n for n in ctx.tree.body
                   if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name in TRACED_METHODS:
                    roots.append((item, _params(item, skip_self=True)))
        elif isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if ctx.resolve(target) in TRACED_DECORATORS:
                    roots.append((node, _params(node)))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in TRACED_COMBINATORS and node.args:
            fn = node.args[0]
            if isinstance(fn, ast.Lambda):
                roots.append((fn, _params(fn)))
            elif isinstance(fn, ast.Name) and fn.id in module_defs:
                d = module_defs[fn.id]
                roots.append((d, _params(d)))
    return roots


def _params(fn: ast.AST, skip_self: bool = False) -> Set[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    for v in (a.vararg, a.kwarg):
        if v is not None:
            names.append(v.arg)
    if skip_self and names and names[0] in {"self", "cls"}:
        names = names[1:]
    return set(names)


def _walk_with_nested_params(root: ast.AST, traced: Set[str]):
    """Yield (node, traced-name set in scope): nested defs inside a
    block body run per block too (per-lane helpers), with their own
    params joining the traced set."""
    stack = [(root, traced)]
    while stack:
        node, names = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.Lambda)):
                stack.append((child, names | _params(child)))
            else:
                stack.append((child, names))
            yield child, names


def _traced_mentions(ctx: FileContext, expr: ast.AST,
                     traced: Set[str]) -> Optional[str]:
    """First traced name mentioned in ``expr`` outside a static
    attribute chain, or None."""
    exempt = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    exempt.add(id(sub))
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in traced \
                and id(node) not in exempt:
            return node.id
    return None


class _TracedBodyRule(Rule):
    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for root, traced in _traced_roots(ctx):
            self._check_body(ctx, root, traced, out)
        return out

    def _check_body(self, ctx, root, traced, out):
        raise NotImplementedError


@register_rule
class HostBranchRule(_TracedBodyRule):
    name = "host-branch"
    description = ("Python-level branch/loop on a tensor parameter "
                   "inside a step function (an implicit .item())")

    def _check_body(self, ctx, root, traced, out):
        for node, names in _walk_with_nested_params(root, traced):
            test = None
            what = None
            if isinstance(node, (ast.If, ast.While)):
                test, what = node.test, "branches"
            elif isinstance(node, ast.IfExp):
                test, what = node.test, "selects"
            elif isinstance(node, ast.Assert):
                test, what = node.test, "asserts"
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                test, what = node.iter, "loops over"
            if test is None:
                continue
            hit = _traced_mentions(ctx, test, names)
            if hit is not None:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"host control flow {what} tensor value `{hit}` — "
                    f"bool() on a tensor waits for the card every block "
                    f"and decides the path on the host, outside the "
                    f"replayed data; use torch.where / a mask"))


@register_rule
class MutableClosureRule(_TracedBodyRule):
    name = "mutable-closure"
    description = ("step function mutates captured host state outside "
                   "the carry")

    def _check_body(self, ctx, root, traced, out):
        local = _collect_locals(root)
        for node, _names in _walk_with_nested_params(root, traced):
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                local = local | _collect_locals(node)
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                out.append(self.finding(
                    ctx, node.lineno,
                    f"step function rebinds enclosing name(s) "
                    f"{', '.join(node.names)} — state outside the "
                    f"carry is invisible to checkpoints and diverges "
                    f"on replay; thread it through operator state"))
                continue
            base = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        base = _base_name(t)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATORS:
                base = _base_name(node.func.value)
            if base is not None and base not in local \
                    and base not in {"self", "cls"}:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"step function mutates captured object `{base}` — "
                    f"host-side state outside the carry is not "
                    f"checkpointed and not replayed; carry it in "
                    f"operator state or log it as a determinant"))


@register_rule
class HostCallbackRule(_TracedBodyRule):
    name = "host-callback"
    description = ("host call (print/open/torch.cuda.synchronize/"
                   ".item/.cpu) inside a step function")

    def _check_body(self, ctx, root, traced, out):
        for node, names in _walk_with_nested_params(root, traced):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.resolve(node.func)
            if dotted in HOST_CALLS:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"host call `{dotted}` inside a step function runs "
                    f"once per block on the host — its effect is not "
                    f"replayed, or it waits for the whole device "
                    f"queue"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_METHOD_CALLS \
                    and _traced_mentions(ctx, node.func.value,
                                         names) is not None:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"`.{node.func.attr}()` on a tensor value copies to "
                    f"the host and waits for the card every block — "
                    f"keep the "
                    f"computation on-device"))


def _collect_locals(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (params, assignments, loop targets,
    comprehension targets, with-as, nested def names)."""
    names = _params(fn)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, ast.FunctionDef):
                names.add(node.name)
            elif isinstance(node, ast.comprehension):
                for sub in ast.walk(node.target):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
    return names


def _base_name(node: ast.AST) -> Optional[str]:
    """Peel Attribute/Subscript chains to the root Name id."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None
