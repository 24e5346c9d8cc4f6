"""Carrying state across packages: the reference's ``JobCarry`` (or
``LeanSnapshot``, or a ``CompletedCheckpoint`` holding one) as numpy
arrays in, the port's carry out — and back.

The reference side hands its carry over as a tree of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, carry)``; the NamedTuples there have
the same field names and order as the port's, so the conversion is by
structure. Both packages can then start from one state and be compared.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch
from clonos_tpu_torch.causal.log import ThreadLogState
from clonos_tpu_torch.inflight.log import EdgeLogState
from clonos_tpu_torch.runtime.executor import JobCarry, LeanSnapshot

_PORT_TYPES: Dict[str, type] = {
    cls.__name__: cls for cls in (JobCarry, LeanSnapshot, RecordBatch,
                                  ThreadLogState, EdgeLogState)}


def carry_from_numpy(tree: Any, device) -> Any:
    """A tree of numpy arrays (NamedTuples matched by class name and
    fields, tuples, lists, dicts) as the port's tensors on ``device``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _PORT_TYPES.get(type(tree).__name__)
        if cls is None or tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"no port counterpart for {type(tree).__name__}"
                            f"{tuple(tree._fields)}")
        return cls(*(carry_from_numpy(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(carry_from_numpy(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: carry_from_numpy(x, device) for k, x in tree.items()}
    arr = np.array(tree, copy=True)
    return torch.from_numpy(arr).to(device)


def carry_to_numpy(carry: Any) -> Any:
    """The port's carry (any tree of tensors) as numpy arrays, same
    structure."""
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        return type(carry)(*(carry_to_numpy(x) for x in carry))
    if isinstance(carry, (tuple, list)):
        return type(carry)(carry_to_numpy(x) for x in carry)
    if isinstance(carry, dict):
        return {k: carry_to_numpy(x) for k, x in carry.items()}
    if isinstance(carry, torch.Tensor):
        return carry.detach().cpu().numpy()
    return np.asarray(carry)


def checkpoint_from_numpy(ckpt: Any, device) -> Any:
    """A reference ``CompletedCheckpoint`` whose carry (a ``LeanSnapshot``
    or ``JobCarry``) is a tree of numpy arrays, e.g.
    ``dataclasses.replace(ckpt, carry=jax.tree_util.tree_map(np.asarray,
    ckpt.carry))``, as the port's ``CompletedCheckpoint`` on ``device``."""
    from clonos_tpu_torch.runtime.checkpoint import CompletedCheckpoint
    return CompletedCheckpoint(
        checkpoint_id=int(ckpt.checkpoint_id),
        carry=carry_from_numpy(ckpt.carry, device),
        wall_time=float(ckpt.wall_time),
        size_bytes=int(getattr(ckpt, "size_bytes", 0) or 0))


def shard_carry(full: Any, placements: Any, n: int, rank: int) -> Any:
    """Rank ``rank``'s shards of a whole carry (numpy, as from the
    reference's ``jax.device_get``, or tensors): each leaf the rule table
    shards (``placements``, e.g. ``CompiledJob.placements()``) cut to its
    contiguous block of ``n``, the others whole."""
    from clonos_tpu_torch.parallel.distributed import shard_tree
    return shard_tree(full, placements, n, rank)


def unshard_carry(shards: Any, placements: Any) -> Any:
    """The whole carry from every rank's shards (a list in rank order, each
    a tree of numpy arrays or tensors): sharded leaves concatenated along
    their dim, replicated leaves taken from rank 0 — numpy out, to compare
    leaf by leaf with the reference's carry."""
    from clonos_tpu_torch.parallel.distributed import shard_dim
    from clonos_tpu_torch.utils.tree import tree_leaves, tree_unflatten
    per_rank = [[np.asarray(x.detach().cpu().numpy()
                            if isinstance(x, torch.Tensor) else x)
                 for x in tree_leaves(s)] for s in shards]
    dims = [shard_dim(p) for p in tree_leaves(placements)]
    out = [per_rank[0][i] if d is None
           else np.concatenate([r[i] for r in per_rank], axis=d)
           for i, d in enumerate(dims)]
    return tree_unflatten(carry_to_numpy(shards[0]), out)
