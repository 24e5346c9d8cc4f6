"""Multi-process distributed backend of the port (``clonos_tpu/parallel/
distributed.py``).

The reference runs one program over a mesh of devices and lets XLA's
partitioner insert the collectives. Here the idiom is one process per
device under ``torch.distributed``, which is the reference's multi-host
form (every process runs the same program over one global mesh), and
nothing partitions for us:

- **Data plane**: the executor (``runtime/executor.py``) shards the carry
  by :data:`CARRY_PARTITION_RULES` and makes the exchange and the
  determinant replication explicit collectives (:func:`all_gather` of a
  producer's block, then each rank routes only its own destination
  lanes). NCCL carries CUDA tensors, gloo CPU tensors; gloo with CUDA
  tensors (ranks sharing one card) stages every collective through
  pinned host buffers, written out here.
- **Control plane**: ``torch.distributed.init_process_group`` at the
  coordinator address (:func:`initialize`); the ``ClusterRunner`` fence
  (audit seal, ledger, checkpoint files) stays on rank 0, the reference's
  process 0.
- **In-band events** (determinant and in-flight requests of a recovery):
  point-to-point object transfers (:func:`transfer`) between the rank
  that holds the rows and the rank that replays.

Placements (``Shard(dim)`` / ``Replicate()`` of ``torch.distributed.
tensor``) are the counterpart of the reference's ``PartitionSpec``. They
only describe the layout: the carry's leaves stay plain local tensors,
and no DTensor op runs on the hot path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from clonos_tpu_torch.utils.tree import (tree_flatten_with_path, tree_leaves,
                                         tree_unflatten)


@dataclasses.dataclass
class DistributedContext:
    process_id: int
    num_processes: int
    coordinator: Optional[str]
    backend: Optional[str] = None
    device: Optional[torch.device] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


#: the process's context once :func:`initialize` ran (None before)
_CONTEXT: Optional[DistributedContext] = None


def init_method(address: str) -> str:
    """A coordinator address as an ``init_method`` URL: ``host:port``
    becomes ``tcp://host:port``; ``tcp://``, ``file://`` and ``env://``
    URLs pass as they are (tests rendezvous through a file, so parallel
    test workers never race for a port)."""
    if re.match(r"^(tcp|file|env)://", address):
        return address
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is neither "
                         f"host:port nor a tcp:// / file:// URL")
    return f"tcp://{host}:{port}"


def backend_for(device, backend: Optional[str] = None) -> str:
    """The collective backend, chosen explicitly: NCCL for CUDA tensors,
    gloo for CPU ones. ``backend="gloo"`` with a CUDA device asks for the
    host-staged collectives (ranks sharing one card); NCCL never carries
    CPU tensors. Nothing falls back to another backend."""
    dev = torch.device(device)
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only; use gloo on the "
                         "CPU")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = 1800.0,
               share_device: bool = False) -> DistributedContext:
    """Join the process group at ``coordinator_address`` as rank
    ``process_id`` of ``num_processes``. ``None`` is the no-op context of
    process 0 of 1. The backend is :func:`backend_for` ``(device,
    backend)``; its first collective runs here, so a backend that cannot
    start (NCCL refusing two ranks on one card) raises here. ``device``
    defaults to the card and raises without one; the CPU runs only when
    asked for."""
    global _CONTEXT
    if coordinator_address is None:
        return DistributedContext(0, 1, None)
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    be = backend_for(device, backend)
    from clonos_tpu_torch import device as _device
    dev = _device.rank_device(process_id, num_processes, device, be,
                              share=share_device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(be, init_method=init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    # The first collective: NCCL builds its communicator here.
    probe = torch.ones(1, device=dev if be == "nccl" else "cpu")
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"{be} all_reduce over {num_processes} ranks "
                           f"returned {probe.item()}")
    _CONTEXT = DistributedContext(dist.get_rank(), dist.get_world_size(),
                                  coordinator_address, be, dev)
    return _CONTEXT


def context() -> DistributedContext:
    """The process's context: process 0 of 1 before :func:`initialize`."""
    return _CONTEXT or DistributedContext(0, 1, None)


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    global _CONTEXT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT = None


def _single_process_group(device) -> None:
    """A one-rank group over an in-memory store, for a mesh asked for in a
    process that joined none: no address, no port, no file."""
    global _CONTEXT
    dev = torch.device(device)
    be = backend_for(dev)
    dist.init_process_group(be, store=dist.HashStore(), world_size=1,
                            rank=0)
    _CONTEXT = DistributedContext(0, 1, None, be, dev)


def _mesh_device(device) -> torch.device:
    """A mesh's device: ``device``, else the one :func:`initialize` chose,
    else the card (which raises without one). A process that joined no
    group gets a one-rank group on it."""
    from clonos_tpu_torch import device as _device
    dev = _device.resolve(device or context().device or "cuda")
    if not dist.is_initialized():
        _single_process_group(dev)
    return dev


def task_mesh(max_devices: Optional[int] = None, axis: str = "tasks",
              device=None):
    """One-axis ``DeviceMesh`` over every rank of the process group: the
    subtask-deployment axis, ranks in order, on :func:`_mesh_device`
    ``(device)``. A mesh is the whole group: ``max_devices`` must not cut
    it."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _mesh_device(device)
    world = dist.get_world_size()
    n = world if max_devices is None else int(max_devices)
    if n != world:
        raise ValueError(f"a task mesh spans the whole process group "
                         f"({world} ranks), not {n}")
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def hierarchical_mesh(axis_tasks: str = "tasks", axis_hosts: str = "hosts",
                      per_host: Optional[int] = None, device=None):
    """Two-axis mesh ``[hosts, tasks-per-host]`` for layouts that want
    replication across hosts while sharding subtasks within one.
    ``per_host`` defaults to ``LOCAL_WORLD_SIZE`` (one host when unset);
    the device is :func:`_mesh_device` ``(device)``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _mesh_device(device)
    world = dist.get_world_size()
    if per_host is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    return init_device_mesh(dev.type, (world // per_host, per_host),
                            mesh_dim_names=(axis_hosts, axis_tasks))


def mesh_size(mesh, axis: str = "tasks") -> int:
    """Ranks along ``axis``. An int stands for a one-axis mesh of that
    size (placements depend on nothing else)."""
    if isinstance(mesh, int):
        return mesh
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def mesh_rank(mesh, axis: str = "tasks") -> int:
    """This process's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


# --- rule-driven carry partitioning -----------------------------------------
#
# The executor's JobCarry is a deep tree whose leaves disagree about WHICH
# axis is the subtask axis: stacked causal logs / replicas lead with it
# ([L, cap, lanes]), in-flight ring tensors carry it second ([S, P, cap]),
# round-robin cursors and ring scalars are control state every shard must
# see. These RULES express the deployment: ordered (regex over the
# '/'-joined leaf path, shard dim | None) pairs, first match wins,
# unmatched leaves replicate — the reference's table, verbatim.

#: (path regex, dim to shard along the task axis; None = replicate).
CARRY_PARTITION_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    # In-flight ring payload tensors are [ring_step, subtask, cap].
    (r"out_rings/\d+/(keys|values|timestamps|valid)$", 1),
    # Ring bookkeeping (head/tail/epoch index) is scalar control state.
    (r"out_rings/", None),
    # Stacked causal logs + determinant replicas lead with the task axis.
    (r"(^|/)(logs|replicas)/", 0),
    # Rebalance cursors are [1] scalars shared by the whole edge.
    (r"rr_offsets/", None),
    # Operator state / depth-1 edge buffers / record counts lead with
    # the (destination) subtask axis.
    (r"(^|/)(op_states|edge_bufs|record_counts)($|/)", 0),
)


def _path_str(path: Tuple[Any, ...]) -> str:
    """Render a :func:`~clonos_tpu_torch.utils.tree.tree_flatten_with_path`
    path as 'a/0/b' — field names, indices, dict keys — the namespace the
    partition-rule regexes match against."""
    return "/".join(str(k) for k in path)


def _spec_for_leaf(path_s: str, leaf: Any, n: int, axis: str,
                   rules: Sequence[Tuple[str, Optional[int]]]):
    """First matching rule decides the shard dim; a dim the leaf lacks or
    cannot split evenly over the ``n`` ranks degrades to replication."""
    from torch.distributed.tensor import Replicate, Shard
    shape = tuple(getattr(leaf, "shape", ()))
    ndim = len(shape)
    for pat, d in rules:
        if re.search(pat, path_s):
            if d is None or ndim <= d or shape[d] == 0 or shape[d] % n != 0:
                return Replicate()
            return Shard(d)
    return Replicate()


def infer_partition_spec(tree: Any, mesh, axis: str = "tasks",
                         rules: Sequence[Tuple[str, Optional[int]]]
                         = CARRY_PARTITION_RULES) -> Any:
    """A placement tree for ``tree`` (same structure) from the rule table
    over flattened leaf names. Scalars and indivisible leaves replicate."""
    n = mesh_size(mesh, axis)
    leaves = tree_flatten_with_path(tree)
    specs = [_spec_for_leaf(_path_str(p), x, n, axis, rules)
             for p, x in leaves]
    return tree_unflatten(tree, specs)


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """One leaf's layout on a mesh: the counterpart of ``NamedSharding``
    (a leaf of the trees it sits in)."""
    mesh: Any
    spec: Any               # Shard(dim) or Replicate()

    @property
    def placements(self) -> tuple:
        return (self.spec,)


def named_shardings(tree: Any, mesh, axis: str = "tasks",
                    rules: Sequence[Tuple[str, Optional[int]]]
                    = CARRY_PARTITION_RULES) -> Any:
    """:class:`NamedPlacement` tree over ``mesh`` for ``tree``."""
    specs = infer_partition_spec(tree, mesh, axis=axis, rules=rules)
    return tree_unflatten(tree, [NamedPlacement(mesh, s)
                                 for s in tree_leaves(specs)])


def shard_dim(spec) -> Optional[int]:
    """The dim a placement shards, or None for a replicated leaf."""
    return getattr(spec, "dim", None)


def _platform(device_type: str) -> str:
    return {"cuda": "gpu"}.get(device_type, device_type)


def mesh_fingerprint(mesh) -> str:
    """Stable short id of a mesh's topology: axis names, axis sizes and
    device kind (not ordinals). The description string is the
    reference's, so a CPU mesh of one size keys the same in both
    packages."""
    if mesh is None:
        return "nomesh"
    kinds = sorted({_platform(mesh.device_type)})
    shape = tuple(int(s) for s in mesh.mesh.shape)
    desc = f"{tuple(mesh.mesh_dim_names)}|{shape}|{kinds}"
    return hashlib.blake2b(desc.encode(), digest_size=6).hexdigest()


def spec_fingerprint(specs: Any) -> str:
    """Stable short id of a placement tree (structure + every placement):
    sharded and unsharded layouts of one carry never collide."""
    paths = [(_path_str(p), repr(s)) for p, s in
             tree_flatten_with_path(specs)]
    desc = "|".join(f"{p}={s}" for p, s in paths)
    return hashlib.blake2b(desc.encode(), digest_size=6).hexdigest()


def standby_device_order(mesh, axis: str = "tasks") -> Sequence[int]:
    """Placement hint: standby replicas restore onto ranks rotated by one
    host relative to their primary, so a host loss never takes a primary
    and its standby together (RunStandbyTaskStrategy.java:186). A host
    holds ``LOCAL_WORLD_SIZE`` ranks (all of them when unset), so on one
    host the order is the identity, as the reference's is on one
    process."""
    n = mesh_size(mesh, axis)
    per_host = max(1, min(n, int(os.environ.get("LOCAL_WORLD_SIZE", n))))
    return [(i + per_host) % n for i in range(n)]


def standby_worker_order(num_workers: int) -> Sequence[int]:
    """The slot-pool scheduler's anti-affinity rule: task group ``i``'s
    standby (the redeploy target when its primary worker dies) is the
    NEXT worker in registration order, so one process loss never takes a
    group and its standby together (reference
    RunStandbyTaskStrategy.java:186 placement)."""
    if num_workers < 1:
        raise ValueError("standby_worker_order: need at least one worker")
    return [(i + 1) % num_workers for i in range(num_workers)]


# --- collectives ------------------------------------------------------------

def _group(mesh, axis: str):
    return mesh.get_group(axis)


def staged(mesh) -> bool:
    """True when collectives on ``mesh`` carry CUDA tensors over gloo:
    every one then goes through pinned host buffers."""
    return (mesh.device_type == "cuda"
            and dist.get_backend(mesh.get_group(0)) == "gloo")


def _to_wire(x: torch.Tensor, mesh) -> torch.Tensor:
    if x.is_cuda and staged(mesh):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_cuda and not x.is_cuda:
        return x.to(like.device, non_blocking=True)
    return x


#: collective calls and their wall seconds since the last reset (the
#: host-staged reading of chip_smoke.py's mesh phase); the pipelined
#: fence's worker thread counts here too, under the lock
STATS = {"collectives": 0, "seconds": 0.0, "bytes": 0}
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        STATS.update(collectives=0, seconds=0.0, bytes=0)


def _count(t0: float, nbytes: int) -> None:
    dt = time.monotonic() - t0
    with _STATS_LOCK:
        STATS["collectives"] += 1
        STATS["seconds"] += dt
        STATS["bytes"] += int(nbytes)


def all_gather(x: torch.Tensor, mesh, axis: str = "tasks", dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim``, on
    every rank, in rank order."""
    n = mesh_size(mesh, axis)
    if n == 1:
        return x
    t0 = time.monotonic()
    wire = _to_wire(x, mesh)
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=_group(mesh, axis))
    _count(t0, wire.numel() * wire.element_size() * n)
    return _from_wire(torch.cat(out, dim=dim), x)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str = "tasks"
                   ) -> torch.Tensor:
    """The element-wise sum of every rank's ``x``, on every rank."""
    if mesh_size(mesh, axis) == 1:
        return x
    t0 = time.monotonic()
    wire = _to_wire(x.clone(), mesh)
    dist.all_reduce(wire, group=_group(mesh, axis))
    _count(t0, wire.numel() * wire.element_size())
    return _from_wire(wire, x)


def broadcast(x: Optional[torch.Tensor], mesh, like: torch.Tensor,
              axis: str = "tasks", src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank; the others pass ``x=None`` and a
    tensor ``like`` of the same shape, dtype and device."""
    if mesh_size(mesh, axis) == 1:
        return x
    t0 = time.monotonic()
    me = mesh_rank(mesh, axis)
    wire = _to_wire(x if me == src else torch.empty_like(like), mesh)
    dist.broadcast(wire, src=src, group=_group(mesh, axis))
    _count(t0, wire.numel() * wire.element_size())
    return _from_wire(wire, like)


def _pack(leaves: List[torch.Tensor]) -> torch.Tensor:
    """Leaves as one flat byte tensor (each leaf's bytes in order)."""
    if not leaves:
        return torch.zeros((0,), dtype=torch.uint8)
    return torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in leaves])


def _unpack(buf: torch.Tensor, likes: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, off = [], 0
    for x in likes:
        nb = x.numel() * x.element_size()
        out.append(buf[off:off + nb].view(x.dtype).reshape(x.shape))
        off += nb
    return out


def _sharded_leaves(tree: Any, specs: Any):
    leaves = tree_leaves(tree)
    dims = [shard_dim(s) for s in tree_leaves(specs)]
    if len(leaves) != len(dims):
        raise ValueError(f"{len(leaves)} leaves against {len(dims)} "
                         f"placements")
    return leaves, dims


def _reassemble(tree: Any, leaves: List[Any], dims: List[Optional[int]],
                per_rank: List[List[torch.Tensor]]) -> Any:
    """``tree`` with each sharded leaf (``dims[i]`` not None) replaced by
    the ranks' shards of it (``per_rank[r]``, in sharded-leaf order)
    concatenated along its dim."""
    it = iter(range(len(per_rank[0])))
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        j = next(it)
        out.append(torch.cat([shards[j] for shards in per_rank], dim=d))
    return tree_unflatten(tree, out)


def all_gather_tree(tree: Any, specs: Any, mesh, axis: str = "tasks"
                    ) -> Any:
    """The full tree on every rank: each sharded leaf's shards concatenated
    along its dim (one collective for every leaf), replicated leaves as
    they are."""
    n = mesh_size(mesh, axis)
    leaves, dims = _sharded_leaves(tree, specs)
    if n == 1:
        return tree
    sh = [x for x, d in zip(leaves, dims) if d is not None]
    if not sh:
        return tree
    buf = all_gather(_pack(sh).reshape(1, -1), mesh, axis, dim=0)
    return _reassemble(tree, leaves, dims,
                       [_unpack(buf[r], sh) for r in range(n)])


def gather_tree(tree: Any, specs: Any, mesh, axis: str = "tasks",
                dst: int = 0) -> Any:
    """:func:`all_gather_tree`, delivered to rank ``dst`` only (None on
    the others): the bytes the reference's ``device_get`` of a sharded
    array brings to its one host."""
    n = mesh_size(mesh, axis)
    if n == 1:
        return tree
    leaves, dims = _sharded_leaves(tree, specs)
    sh = [x for x, d in zip(leaves, dims) if d is not None]
    me = mesh_rank(mesh, axis)
    t0 = time.monotonic()
    buf = _pack(sh)
    like = buf
    if sh and sh[0].is_cuda:
        like = buf.to(sh[0].device) if not buf.is_cuda else buf
    wire = _to_wire(buf, mesh)
    got = [torch.empty_like(wire) for _ in range(n)] if me == dst else None
    dist.gather(wire, got, dst=dst, group=_group(mesh, axis))
    _count(t0, wire.numel() * wire.element_size() * n)
    if me != dst:
        return None
    return _reassemble(tree, leaves, dims,
                       [_unpack(_from_wire(g, like), sh) for g in got])


def shard_tree(tree: Any, specs: Any, n: int, rank: int) -> Any:
    """Rank ``rank``'s shards of a full tree (tensors or numpy arrays):
    each sharded leaf's contiguous block along its dim."""
    leaves, dims = _sharded_leaves(tree, specs)
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        size = x.shape[d] // n
        idx = [slice(None)] * len(x.shape)
        idx[d] = slice(rank * size, (rank + 1) * size)
        out.append(x[tuple(idx)])
    return tree_unflatten(tree, out)


def fence_group(mesh, axis: str = "tasks"):
    """A gloo group over the mesh's ranks for the pipelined fence's worker
    thread: its gathers never interleave with the blocks' collectives on
    the mesh's own group. The executor makes a second one for the
    driving thread's host-only agreements (:func:`agree`,
    :func:`broadcast_int`), which must not interleave with the worker's
    either. Every rank creates it at the same point (a collective); None
    for a one-rank mesh."""
    n = mesh_size(mesh, axis)
    return dist.new_group(ranks=list(range(n)), backend="gloo") \
        if n > 1 else None


def agree(err: Optional[BaseException], mesh, axis: str = "tasks",
          group=None) -> None:
    """Settle a step that may fail on some ranks alone (a feed pull, a
    re-read below retention, a torn spill segment) before the next
    collective: one all-reduce of a failure flag over ``group`` (a gloo
    group, host tensors only). When any rank failed, every rank raises:
    its own error, else the lowest failed rank's, pickled across with a
    note naming that rank. So no rank waits in a later collective for a
    peer that already left."""
    if mesh_size(mesh, axis) == 1:
        if err is not None:
            raise err
        return
    t0 = time.monotonic()
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32)
    dist.all_reduce(flag, group=group or _group(mesh, axis))
    _count(t0, flag.numel() * flag.element_size())
    if int(flag.item()) == 0:
        return
    mine = None
    if err is not None:
        try:
            mine = pickle.loads(pickle.dumps(err))
        except Exception:
            mine = RuntimeError(f"{type(err).__name__}: {err}")
    errs = all_gather_object(mine, mesh, axis, group=group)
    if err is not None:
        raise err
    r, first = next((r, e) for r, e in enumerate(errs) if e is not None)
    first.add_note(f"raised on rank {r} of {len(errs)}")
    raise first


def broadcast_int(value: Optional[int], mesh, axis: str = "tasks",
                  src: int = 0, group=None) -> int:
    """Rank ``src``'s host integer on every rank (the others pass None),
    over ``group`` (a gloo group: no device tensor, no sync)."""
    if mesh_size(mesh, axis) == 1:
        return int(value)
    t0 = time.monotonic()
    me = mesh_rank(mesh, axis)
    box = torch.tensor([int(value) if me == src else 0], dtype=torch.int64)
    dist.broadcast(box, src=src, group=group or _group(mesh, axis))
    _count(t0, box.numel() * box.element_size())
    return int(box.item())


def broadcast_array(arr, mesh, axis: str = "tasks", src: int = 0,
                    group=None):
    """Rank ``src``'s numpy array on every rank (each passes one of the
    same shape and dtype), over ``group`` (a gloo group: host memory
    only, no sync)."""
    import numpy as np
    if mesh_size(mesh, axis) == 1:
        return arr
    t0 = time.monotonic()
    box = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dist.broadcast(box, src=src, group=group or _group(mesh, axis))
    _count(t0, box.numel() * box.element_size())
    return box.numpy()


def broadcast_object(obj: Any, mesh, axis: str = "tasks", src: int = 0,
                     group=None) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank (the others pass
    None), over ``group`` (default: the mesh's)."""
    if mesh_size(mesh, axis) == 1:
        return obj
    t0 = time.monotonic()
    box = [obj if mesh_rank(mesh, axis) == src else None]
    dist.broadcast_object_list(box, src=src,
                               group=group or _group(mesh, axis))
    _count(t0, 0)
    return box[0]


def scatter_object(objs: Optional[Sequence[Any]], mesh, axis: str = "tasks",
                   src: int = 0, group=None) -> Any:
    """Rank ``src``'s ``objs[r]`` on each rank ``r`` (the others pass
    None), over ``group`` (default: the mesh's)."""
    if mesh_size(mesh, axis) == 1:
        return objs[0]
    t0 = time.monotonic()
    box = [None]
    dist.scatter_object_list(
        box, list(objs) if mesh_rank(mesh, axis) == src else None,
        src=src, group=group or _group(mesh, axis))
    _count(t0, 0)
    return box[0]


def gather_object(obj: Any, mesh, axis: str = "tasks", dst: int = 0,
                  group=None) -> Optional[List[Any]]:
    """Every rank's picklable ``obj`` as a list on rank ``dst`` (None on
    the others), over ``group`` (default: the mesh's)."""
    n = mesh_size(mesh, axis)
    if n == 1:
        return [obj]
    t0 = time.monotonic()
    me = mesh_rank(mesh, axis)
    out = [None] * n if me == dst else None
    dist.gather_object(obj, out, dst=dst,
                       group=group or _group(mesh, axis))
    _count(t0, 0)
    return out


def all_gather_object(obj: Any, mesh, axis: str = "tasks", group=None
                      ) -> List[Any]:
    """Every rank's picklable ``obj`` as a list on every rank."""
    n = mesh_size(mesh, axis)
    if n == 1:
        return [obj]
    t0 = time.monotonic()
    out = [None] * n
    dist.all_gather_object(out, obj, group=group or _group(mesh, axis))
    _count(t0, 0)
    return out


def transfer(obj: Any, src: int, dsts: Sequence[int], mesh,
             axis: str = "tasks") -> Any:
    """Move a picklable ``obj`` (numpy arrays, not device tensors) from
    rank ``src`` to every rank in ``dsts``: a broadcast when they are all
    the ranks, else one point-to-point send each. Every rank calls it with
    the same ``src`` and ``dsts``; returns the object on ``src`` and the
    ``dsts``, None elsewhere. Sends and receives pair in one global order,
    so a sequence of transfers never deadlocks."""
    n = mesh_size(mesh, axis)
    me = mesh_rank(mesh, axis)
    dsts = sorted(set(int(d) for d in dsts))
    if n == 1 or dsts == [src]:
        return obj if me in dsts or me == src else None
    t0 = time.monotonic()
    group = _group(mesh, axis)
    if dsts == list(range(n)):
        box = [obj if me == src else None]
        dist.broadcast_object_list(box, src=src, group=group)
        _count(t0, 0)
        return box[0]
    got = obj if me == src else None
    for d in dsts:
        if d == src:
            continue
        if me == src:
            dist.send_object_list([obj], dst=d, group=group)
        elif me == d:
            box = [None]
            dist.recv_object_list(box, src=src, group=group)
            got = box[0]
    _count(t0, 0)
    return got if (me == src or me in dsts) else None


def barrier(mesh, axis: str = "tasks") -> None:
    if mesh_size(mesh, axis) > 1:
        dist.barrier(group=_group(mesh, axis))


# --- rank processes ---------------------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(target: str, n: int, kwargs: Optional[dict] = None, *,
          device="cuda", backend: Optional[str] = None,
          timeout_s: float = 300.0, share_device: bool = False,
          workdir: Optional[str] = None) -> List[Any]:
    """Run ``target`` (``"package.module:function"``) in ``n`` fresh rank
    processes joined by a file rendezvous, each calling ``function(ctx,
    **kwargs)`` after :func:`initialize`. Returns the ranks' return values
    (pickled through ``workdir``) in rank order. Every rank runs under
    ``timeout_s``: a hung collective kills every rank and raises, it never
    waits past its limit. A rank that fails raises with its error. Each
    rank runs one host thread. ``device`` defaults to the card and raises
    here without one."""
    from clonos_tpu_torch import device as _device
    device = _device.resolve(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="clonos_ranks_")
    os.makedirs(workdir, exist_ok=True)
    rdv = os.path.join(workdir, "rendezvous")
    if os.path.exists(rdv):
        os.unlink(rdv)
    with open(os.path.join(workdir, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs or {}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    env["OMP_NUM_THREADS"] = "1"
    spec = json.dumps({"target": target, "n": n, "device": str(device),
                       "backend": backend, "workdir": workdir,
                       "timeout_s": timeout_s, "share": share_device})
    code = ("from clonos_tpu_torch.parallel.distributed import _rank_main; "
            "_rank_main()")
    procs = []
    for r in range(n):
        err = open(os.path.join(workdir, f"rank{r}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, spec, str(r)], env=env,
            cwd=_REPO_ROOT, stdin=subprocess.DEVNULL, stdout=err,
            stderr=subprocess.STDOUT), err))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        # Poll every rank: one that fails early must not wait behind a
        # peer blocked in a collective on it.
        while failed is None:
            rcs = [p.poll() for p, _ in procs]
            bad = [(r, rc) for r, rc in enumerate(rcs)
                   if rc is not None and rc != 0]
            if bad:
                failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                failed = f"ranks exceeded their {timeout_s:.0f} s limit"
            else:
                time.sleep(0.05)
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    try:
        if failed is not None:
            tails = []
            for r in range(n):
                with open(os.path.join(workdir, f"rank{r}.err")) as f:
                    tails.append(f"--- rank {r} ---\n" + f.read()[-3000:])
            raise RuntimeError(f"{target} on {n} ranks: {failed}\n"
                               + "\n".join(tails))
        out = []
        for r in range(n):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def _rank_main() -> None:
    """A rank process of :func:`spawn` (argv: spec JSON, rank)."""
    import importlib
    spec = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    with open(os.path.join(spec["workdir"], "kwargs.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    ctx = initialize("file://" + os.path.join(spec["workdir"], "rendezvous"),
                     spec["n"], rank, device=spec["device"],
                     backend=spec["backend"], timeout_s=spec["timeout_s"],
                     share_device=spec["share"])
    mod, _, fn = spec["target"].partition(":")
    try:
        res = getattr(importlib.import_module(mod), fn)(ctx, **kwargs)
        with open(os.path.join(spec["workdir"], f"rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        shutdown()
