"""Minimal pytree helpers over the containers the port's carries use:
NamedTuples, tuples, lists and dicts of tensors (or numpy arrays).

Dict leaves are visited in sorted-key order, the order ``jax.tree_util``
flattens dicts in, so flattened carries of the two packages line up."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` (and same-shaped ``rest``)."""
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in deterministic order (dict keys sorted)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if tree is None:
        return []
    return [tree]


def tree_structure(tree: Any) -> Any:
    """A hashable description of ``tree``'s containers (leaves elided),
    equal for two trees exactly when their leaves line up."""
    if _is_namedtuple(tree):
        return (type(tree), tuple(tree_structure(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(tree_structure(t) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, tree_structure(tree[k]))
                            for k in sorted(tree)))
    if tree is None:
        return None
    return "*"


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s containers around ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = _rebuild(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(tree: Any, it: Iterator[Any]) -> Any:
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(t, it) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if tree is None:
        return None
    return next(it)


def tree_flatten_with_path(tree: Any, prefix: tuple = ()) -> List[tuple]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order. A path is a
    tuple of NamedTuple field names, sequence indices and dict keys — the
    components ``jax.tree_util.tree_flatten_with_path`` names, so the
    sharding rules (``parallel/distributed.py``) match the same strings
    on both packages' carries."""
    if _is_namedtuple(tree):
        return [pl for f, t in zip(tree._fields, tree)
                for pl in tree_flatten_with_path(t, prefix + (f,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, t in enumerate(tree)
                for pl in tree_flatten_with_path(t, prefix + (i,))]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_path(tree[k], prefix + (k,))]
    if tree is None:
        return []
    return [(prefix, tree)]
