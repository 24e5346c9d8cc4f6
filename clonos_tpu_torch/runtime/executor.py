"""Block executor: the whole job advanced K supersteps at a time.

Port of ``clonos_tpu/runtime/executor.py``. With a ``mesh`` (a
``torch.distributed`` task mesh, ``parallel/distributed.py``) every rank
holds only its shards of the carry, by the rule table, and runs its
contiguous block of each vertex's subtasks; the exchange and the
determinant replication become explicit collectives (see
:meth:`CompiledJob.run_block`). Host-fed sources take one non-blocking
upload per block per feed, packed straight into reused pinned memory on
a card; block listeners (timers) and the block-outputs tap
(transactional sinks) run after every block on host-known values;
causal services append through ``append_async_many``.
``capture_fence`` hands a closed epoch's fence surface to the pipelined
fence's worker thread without a host sync (``FenceHandles``). With a
``spool_dir`` every closed epoch's ring steps and determinant rows move
to the tiered stores (``storage/tiered.py``) at the epoch roll, sliced
by host-known bounds: the spill hook makes no synchronising call. The
process profiler (``obs/profile.py``) times the ``spill``, ``roll``,
``truncate`` and ``async-append`` sections; the disabled default times
nothing and waits for nothing.

- Every vertex's subtasks are a ``[P]`` dim of its state and batches.
- A superstep advances every vertex by one batch: vertex v consumes the
  batch its upstream routed in the previous superstep (depth-1 edge
  buffers).
- Supersteps run in blocks of K: each vertex processes a ``[K, P, B]``
  stack (``Operator.process_block``), each exchange routes the whole
  stack, and the causal log, its replicas and the in-flight rings take one
  bulk append per block. Per-step semantics are exact: block == stepwise.
- The per-superstep determinants (TIMESTAMP, RNG, ORDER, BUFFER_BUILT) are
  built for the whole block as one ``[L, K*4, lanes]`` tensor and appended
  to the stacked log and its replicas before the block's outputs are
  returned (the piggyback guarantee).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.api.operators import (BlockContext, HostFeedSource,
                                            TwoInputOperator)
from clonos_tpu_torch.api.records import RecordBatch, empty
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.causal import replication as rep
from clonos_tpu_torch.graph.job_graph import JobGraph, PartitionType
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.obs.profile import get_profiler
from clonos_tpu_torch.obs.trace import get_tracer
from clonos_tpu_torch.parallel import routing
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map

#: determinants appended per subtask per superstep, in this fixed order:
#: TIMESTAMP, RNG, ORDER, BUFFER_BUILT.
DETS_PER_STEP = 4


class StepInputs(NamedTuple):
    """Host-fed inputs for one superstep (the single-step API)."""

    time: torch.Tensor
    rng_bits: torch.Tensor


class BlockInputs(NamedTuple):
    """Host-fed inputs for a block of K supersteps (``feeds``: each feed
    vertex's lanes this rank runs)."""

    times: torch.Tensor       # int32[K]
    rng_bits: torch.Tensor    # int32[K]
    epoch: torch.Tensor       # int32 scalar
    step0: torch.Tensor       # int32 scalar (global step index)
    feeds: Tuple[RecordBatch, ...] = ()   # per feed vertex, [K, P, B]


class JobCarry(NamedTuple):
    """The complete device-resident job state (field order as the
    reference's ``JobCarry``)."""

    op_states: Tuple[Any, ...]               # per-vertex operator state
    edge_bufs: Tuple[RecordBatch, ...]       # per-edge routed batch
    rr_offsets: Tuple[torch.Tensor, ...]     # per-edge [1] round-robin
    record_counts: torch.Tensor              # int32[L] consumed per subtask
    logs: clog.ThreadLogState                # stacked [L, cap, lanes]
    out_rings: Tuple[ifl.EdgeLogState, ...]  # per producing vertex
    replicas: clog.ThreadLogState            # stacked [R, cap, lanes]


class LeanSnapshot(NamedTuple):
    """What a checkpoint persists: operator state, the depth-1 edge
    buffers and offsets — logs and rings only by their fence heads."""

    op_states: Tuple[Any, ...]
    edge_bufs: Tuple[RecordBatch, ...]
    rr_offsets: Tuple[torch.Tensor, ...]
    record_counts: torch.Tensor
    log_heads: torch.Tensor                  # int32[L]
    ring_heads: Tuple[torch.Tensor, ...]


class StepOutputs(NamedTuple):
    sinks: Dict[int, RecordBatch]            # vertex_id -> [P, cap]
    dropped: Dict[int, torch.Tensor]         # edge index -> [P_dst]
    consumed: torch.Tensor                   # int32[L]


class BlockOutputs(NamedTuple):
    sinks: Dict[int, RecordBatch]            # vertex_id -> [K, P, cap]
    dropped: Dict[int, torch.Tensor]         # edge index -> [K, P_dst]
    consumed: torch.Tensor                   # int32[K, L]


def _block(size: int, n: int, r: int) -> Tuple[int, int]:
    """Rank ``r``'s contiguous block of a dim of ``size`` split over ``n``
    ranks — the whole dim when it does not split evenly (the rule table's
    divisibility guard replicates such a leaf)."""
    if n > 1 and size > 0 and size % n == 0:
        g = size // n
        return r * g, (r + 1) * g
    return 0, size


def _feed_planes(flat, k: int, p: int, b: int):
    """A staged fed block of ``p`` lanes, one flat int32 buffer (numpy or
    torch), as views: keys and values lane by lane, ``[2, p, k, b]`` (each
    lane's pull one contiguous run), then counts ``[k, p]``."""
    n = 2 * k * p * b
    return flat[:n].reshape(2, p, k, b), flat[n:].reshape(k, p)


def _pack_feed(pulled, k: int, b: int, pinned: bool) -> torch.Tensor:
    """The lanes' ``pull_block`` results staged in one flat int32 host
    tensor (:func:`_feed_planes`' layout), each element written once: a
    reader's arrays are whole ``[k, b]`` with the padding zeroed, so the
    buffer needs no zero fill. ``pinned`` takes it from the caching host
    allocator, which hands a block out again only after the copy recorded
    on it has run, so no write lands in a buffer still in flight;
    otherwise it is a fresh pageable buffer of this block's own."""
    p = len(pulled)
    size = k * p * (2 * b + 1)
    flat = (torch.empty(size, dtype=torch.int32, pin_memory=True) if pinned
            else torch.from_numpy(np.empty(size, np.int32)))
    kv, counts = _feed_planes(flat.numpy(), k, p, b)
    for i, (ks, vs, cnt) in enumerate(pulled):
        kv[0, i], kv[1, i] = ks, vs
        counts[:, i] = cnt
    return flat


def _feed_lanes(flat: torch.Tensor, k: int, p: int, b: int, lo: int,
                hi: int) -> np.ndarray:
    """Lanes ``[lo, hi)`` of a staged block of ``p`` lanes, in the same
    flat layout: a rank's piece of a block rank 0 scatters."""
    kv, counts = _feed_planes(flat.numpy(), k, p, b)
    return np.concatenate((kv[:, lo:hi].ravel(), counts[:, lo:hi].ravel()))


def _feed_batch(arr: torch.Tensor, k: int, p: int, b: int) -> RecordBatch:
    """A staged block on its device as a ``[k, p, b]`` batch: keys and
    values turned step-major there (one copy), timestamps zero (the
    operator stamps them), and ``valid`` built there from the counts,
    ``arange(b) < count``."""
    kv, counts = _feed_planes(arr, k, p, b)
    kv = kv.transpose(1, 2).contiguous()
    valid = (torch.arange(b, dtype=torch.int32, device=arr.device)
             < counts[..., None])
    return RecordBatch(kv[0], kv[1], torch.zeros_like(kv[0]), valid)


@dataclasses.dataclass
class CompiledJob:
    """A job graph lowered to (init_carry, run_block) functions. With a
    ``mesh``, the functions hold and advance one rank's shards."""

    job: JobGraph
    log_capacity: int = 1 << 14
    max_epochs: int = 64
    inflight_ring_steps: int = 64
    replication_factor: int = -1
    mesh: Any = None
    task_axis: str = "tasks"

    def __post_init__(self):
        self.job.validate()
        self.topo = self.job.topo_order()
        self.L = self.job.total_subtasks()
        #: host-fed sources, in id order (positions in BlockInputs.feeds)
        self.feed_vertices = [v.vertex_id for v in self.job.vertices
                              if isinstance(v.operator, HostFeedSource)]
        self.plan = rep.ReplicationPlan.from_job(
            self.job, self.job.sharing_depth,
            replication_factor=self.replication_factor)
        self._owner_idx: Dict[str, torch.Tensor] = {}
        self.ring_vertices = [v.vertex_id for v in self.job.vertices
                              if self.job.out_edges(v.vertex_id)]
        self.ring_index = {vid: i for i, vid in enumerate(self.ring_vertices)}
        # HASH edges whose producer emits statically-keyed slots get a
        # compile-time gather plan instead of the dynamic exchange; the
        # edge capacity widens (to a multiple of 128) to fit the densest
        # target, unless that would exceed 4x the request.
        self.static_route: Dict[int, routing.StaticRoutePlan] = {}
        for eidx, e in enumerate(self.job.edges):
            if e.partition != PartitionType.HASH:
                continue
            sk = self.job.vertices[e.src].operator.static_out_keys()
            if sk is None:
                continue
            src_p = self.job.vertices[e.src].parallelism
            dst_p = self.job.vertices[e.dst].parallelism
            need = routing.static_hash_capacity(
                sk, src_p, dst_p, self.job.num_key_groups)
            if need > max(4 * e.capacity, 1024):
                continue
            if need > e.capacity:
                e.capacity = -(-need // 128) * 128
            plan = routing.plan_static_hash(
                sk, src_p, dst_p, self.job.num_key_groups, e.capacity)
            if len(plan.drop_p):
                raise RuntimeError(
                    f"static plan for edge {eidx} still has "
                    f"{len(plan.drop_p)} overflow slots at capacity "
                    f"{e.capacity}")
            self.static_route[eidx] = plan
        # The rank's blocks: each vertex's subtasks, the stacked logs and
        # record counts (L), the replica stack (max(R, 1) rows).
        self.n_shards, self.shard = 1, 0
        if self.mesh is not None:
            from clonos_tpu_torch.parallel import distributed as dist_
            if len(self.mesh.mesh_dim_names) != 1:
                raise ValueError("the executor shards over a one-axis task "
                                 "mesh")
            self.n_shards = dist_.mesh_size(self.mesh, self.task_axis)
            self.shard = dist_.mesh_rank(self.mesh, self.task_axis)
        n, r = self.n_shards, self.shard
        self.vblock = {v.vertex_id: _block(v.parallelism, n, r)
                       for v in self.job.vertices}
        self.lblock = _block(self.L, n, r)
        self.rblock = _block(max(self.plan.num_replicas, 1), n, r)

    def sharded(self, vid: int) -> bool:
        """True when vertex ``vid``'s subtasks split over the ranks (else
        every rank runs all of them)."""
        lo, hi = self.vblock[vid]
        return hi - lo < self.job.vertices[vid].parallelism

    def owner_idx(self, dev: torch.device) -> torch.Tensor:
        key = str(dev)
        if key not in self._owner_idx:
            self._owner_idx[key] = self.plan.owner_index(
                dev, None if self.mesh is None else self.rblock)
        return self._owner_idx[key]

    # --- sharding -----------------------------------------------------------

    def carry_partition_spec(self, carry: "JobCarry"):
        """Placement tree for the full carry by the rule table
        (``parallel/distributed.py:CARRY_PARTITION_RULES``): ``Shard(d)``
        or ``Replicate()`` per leaf. None when no mesh is attached.
        ``carry`` is the full carry, or its template: placements follow
        its GLOBAL shapes (see :meth:`global_carry_shapes`)."""
        if self.mesh is None:
            return None
        from clonos_tpu_torch.parallel import distributed as dist_
        return dist_.infer_partition_spec(carry, self.mesh,
                                          axis=self.task_axis)

    def carry_shardings(self, carry: "JobCarry"):
        """:class:`~clonos_tpu_torch.parallel.distributed.NamedPlacement`
        tree over the task mesh for the full carry, or None without a
        mesh."""
        if self.mesh is None:
            return None
        from clonos_tpu_torch.parallel import distributed as dist_
        return dist_.named_shardings(carry, self.mesh, axis=self.task_axis)

    def global_carry_shapes(self) -> "JobCarry":
        """The full carry's leaf shapes (meta tensors, nothing allocated):
        the template every rank derives the same placements from."""
        return self.init_carry(torch.device("meta"), local=False)

    def placements(self) -> "JobCarry":
        """The carry's placement tree (cached; every leaf ``Replicate()``
        without a mesh)."""
        if not hasattr(self, "_placements"):
            from clonos_tpu_torch.parallel import distributed as dist_
            template = self.global_carry_shapes()
            self._placements = (
                self.carry_partition_spec(template) if self.mesh is not None
                else dist_.infer_partition_spec(template, 1))
        return self._placements

    def constrain_carry(self, carry: "JobCarry") -> "JobCarry":
        """Check every local leaf against its rule-assigned placement: a
        sharded leaf holds exactly its block of the global dim, a
        replicated one the whole leaf. Raises on the first leaf that does
        not; returns the carry unchanged."""
        if self.mesh is None:
            return carry
        from clonos_tpu_torch.parallel import distributed as dist_
        from clonos_tpu_torch.utils.tree import tree_flatten_with_path
        glob = tree_flatten_with_path(self.global_carry_shapes())
        specs = tree_leaves(self.placements())
        local = tree_flatten_with_path(carry)
        if len(local) != len(glob):
            raise ValueError(f"carry has {len(local)} leaves, the job's "
                             f"carry {len(glob)}")
        for (path, x), (_, g), sp in zip(local, glob, specs):
            want = list(g.shape)
            d = dist_.shard_dim(sp)
            if d is not None:
                want[d] //= self.n_shards
            if list(x.shape) != want:
                raise ValueError(
                    f"carry leaf {dist_._path_str(path)}: local shape "
                    f"{list(x.shape)}, its placement {sp!r} over "
                    f"{self.n_shards} ranks wants {want}")
        return carry

    def consumer_slot_keys(self, vid: int) -> Optional[np.ndarray]:
        """Static per-slot input keys of vertex ``vid`` ([P, cap], -1 =
        unmapped), when its single input edge is statically routed."""
        ins = self.job.in_edges(vid)
        if len(ins) == 1 and ins[0] in self.static_route:
            return self.static_route[ins[0]].slot_keys
        return None

    def vertex_out_capacity(self, vid: int) -> int:
        v = self.job.vertices[vid]
        if v.operator.out_capacity is not None:
            return v.operator.out_capacity
        ins = self.job.in_edges(vid)
        if ins:
            return self.job.edges[ins[0]].capacity
        return 1

    def init_carry(self, device="cuda", local: bool = True) -> JobCarry:
        """The empty carry on ``device``; on a mesh (``local``) only this
        rank's shards."""
        dev = (device if isinstance(device, torch.device)
               and device.type == "meta" else _device.resolve(device))
        loc = local and self.mesh is not None
        width = lambda vid: (self.vblock[vid][1] - self.vblock[vid][0]
                             if loc else self.job.vertices[vid].parallelism)
        n_logs = self.lblock[1] - self.lblock[0] if loc else self.L
        n_reps = (self.rblock[1] - self.rblock[0] if loc
                  else max(self.plan.num_replicas, 1))
        op_states = tuple(v.operator.init_state(width(v.vertex_id), dev)
                          for v in self.job.vertices)
        edge_bufs = tuple(empty((width(e.dst), e.capacity), dev)
                          for e in self.job.edges)
        rr = tuple(torch.zeros((1,), dtype=torch.int32, device=dev)
                   for _ in self.job.edges)
        logs = clog.v_create(n_logs, self.log_capacity, self.max_epochs, dev)
        out_rings = tuple(
            ifl.create(self.inflight_ring_steps, width(vid),
                       self.vertex_out_capacity(vid), self.max_epochs, dev)
            for vid in self.ring_vertices)
        replicas = clog.v_create(n_reps, self.log_capacity, self.max_epochs,
                                 dev)
        carry = JobCarry(op_states, edge_bufs, rr,
                         torch.zeros((n_logs,), dtype=torch.int32,
                                     device=dev),
                         logs, out_rings, replicas)
        return self.constrain_carry(carry) if loc else carry

    def run_block(self, carry: JobCarry, binputs: BlockInputs
                  ) -> Tuple[JobCarry, BlockOutputs]:
        """Advance K supersteps. The in-flight rings of ``carry`` are
        updated in place (see ``inflight.log.append_block``); everything
        else is returned fresh.

        On a mesh each rank runs its block ``[lo, hi)`` of every sharded
        vertex's subtasks (``BlockContext.subtask`` holds the global ids)
        and all of a vertex whose parallelism does not split. A sharded
        producer's output block is all-gathered along the subtask axis
        before routing, and each rank routes only its own destination
        lanes, so slots fill in the unsharded producer order. The emit and
        consume counts ``[K, P]`` are all-gathered once per block; each
        rank then builds the determinant rows of its own log block,
        replica block and record counts, as the rule table deals them.
        The returned sinks and drops hold the rank's lanes; ``consumed``
        is the whole ``[K, L]``."""
        job = self.job
        mesh = self.mesh
        K = binputs.times.shape[0]
        dev = carry.record_counts.device
        if DETS_PER_STEP * K > self.log_capacity:
            raise ValueError(
                f"block of {K} steps appends {DETS_PER_STEP * K} determinant"
                f" rows > log capacity {self.log_capacity}")
        if K > self.inflight_ring_steps:
            raise ValueError(
                f"block of {K} steps exceeds in-flight ring "
                f"({self.inflight_ring_steps} steps)")
        op_states = list(carry.op_states)
        rr_offsets = list(carry.rr_offsets)
        out_rings = list(carry.out_rings)
        new_edge_bufs = list(carry.edge_bufs)
        routed: Dict[int, RecordBatch] = {}
        sinks: Dict[int, RecordBatch] = {}
        dropped: Dict[int, torch.Tensor] = {}
        consumed_parts: Dict[int, torch.Tensor] = {}
        emit_parts: Dict[int, torch.Tensor] = {}

        def shifted(eidx: int) -> RecordBatch:
            # Depth-1 pipeline: block step k consumes the upstream's routed
            # output of step k-1; step 0 the carried edge buffer.
            return RecordBatch(*(torch.cat([b[None], r[:-1]], dim=0)
                                 for r, b in zip(routed[eidx],
                                                 carry.edge_bufs[eidx])))

        for vid in self.topo:
            v = job.vertices[vid]
            lo, hi = self.vblock[vid]
            p = hi - lo
            in_edges = job.in_edges(vid)
            bctx = BlockContext(
                times=binputs.times, rng_bits=binputs.rng_bits,
                epoch=binputs.epoch, step0=binputs.step0,
                subtask=torch.arange(lo, hi, dtype=torch.int32, device=dev))
            if isinstance(v.operator, TwoInputOperator):
                ins = (shifted(in_edges[0]), shifted(in_edges[1]))
                consumed = ins[0].count() + ins[1].count()          # [K, P]
            elif in_edges:
                ins = shifted(in_edges[0])
                consumed = ins.count()
            elif vid in self.feed_vertices and binputs.feeds:
                # The rank's own lanes [lo, hi): a rank pulls only those.
                ins = binputs.feeds[self.feed_vertices.index(vid)]
                if ins.keys.shape[1] != p:
                    raise ValueError(
                        f"feed of vertex {vid}: {ins.keys.shape[1]} lanes, "
                        f"this rank runs {p}")
                consumed = ins.count()
            else:
                ins = empty((K, p, self.vertex_out_capacity(vid)), dev)
                consumed = None
            slot_keys = self.consumer_slot_keys(vid)
            if slot_keys is not None and p < v.parallelism:
                slot_keys = slot_keys[lo:hi]
            # record_function ranges name the layers in a profiler trace.
            with record_function(f"op:{v.name}"):
                if slot_keys is not None and hasattr(
                        v.operator, "process_block_static_keys"):
                    state, out = v.operator.process_block_static_keys(
                        op_states[vid], ins, bctx, slot_keys)
                else:
                    state, out = v.operator.process_block(op_states[vid],
                                                          ins, bctx)
            if consumed is None:
                # Generators "consume" what they emit.
                consumed = out.count()
            op_states[vid] = state
            if in_edges and not job.out_edges(vid):
                sinks[vid] = out
            consumed_parts[vid] = consumed
            emit_parts[vid] = out.count()                         # [K, P]

            whole = out
            if job.out_edges(vid) and p < v.parallelism:
                with record_function("exchange-gather"):
                    whole = _gather_block(out, mesh, self.task_axis)
            for eidx in job.out_edges(vid):
                with record_function(f"route:{eidx}"):
                    r, d = self._route_edge(eidx, whole, rr_offsets)
                routed[eidx] = r
                dropped[eidx] = d
                new_edge_bufs[eidx] = RecordBatch(*(x[-1] for x in r))

            if vid in self.ring_index:
                # In-flight logging of the producer's raw output block;
                # consumers re-derive their inputs by re-running the
                # deterministic exchange during replay.
                ri = self.ring_index[vid]
                with record_function("inflight-ring"):
                    out_rings[ri] = ifl.append_block(out_rings[ri], out)

        if mesh is not None:
            with record_function("count-gather"):
                self._gather_counts(emit_parts, consumed_parts)
        emits_all = torch.cat([emit_parts[v.vertex_id]
                               for v in job.vertices], dim=1)      # [K, L]
        consumed_all = torch.cat([consumed_parts[v.vertex_id]
                                  for v in job.vertices], dim=1)
        llo, lhi = self.lblock
        with record_function("causal-log"):
            rows = self._det_rows(binputs, emits_all)              # [L, 4K, 8]
            mine = rows if (llo, lhi) == (0, self.L) else rows[llo:lhi]
            logs = clog.v_append_full(carry.logs, mine)
        with record_function("replicas"):
            if self.plan.num_replicas > 0:
                # The same determinants land in every downstream replica
                # before any of this block's outputs become visible.
                replicas = clog.v_append_full(carry.replicas,
                                              rows[self.owner_idx(dev)])
            else:
                replicas = carry.replicas
        consumed_mine = (consumed_all if (llo, lhi) == (0, self.L)
                         else consumed_all[:, llo:lhi])
        new_carry = JobCarry(
            tuple(op_states), tuple(new_edge_bufs), tuple(rr_offsets),
            carry.record_counts + consumed_mine.sum(dim=0, dtype=torch.int32),
            logs, tuple(out_rings), replicas)
        return new_carry, BlockOutputs(sinks, dropped, consumed_all)

    def _gather_counts(self, emit_parts: Dict[int, torch.Tensor],
                       consumed_parts: Dict[int, torch.Tensor]) -> None:
        """Replace each sharded vertex's ``[K, P/n]`` emit and consume
        counts by the whole ``[K, P]``: one all-gather for all of them."""
        from clonos_tpu_torch.parallel import distributed as dist_
        vids = [v.vertex_id for v in self.job.vertices if
                self.sharded(v.vertex_id)]
        if not vids:
            return
        local = torch.stack([torch.cat([parts[v] for v in vids], dim=1)
                             for parts in (emit_parts, consumed_parts)])
        allr = dist_.all_gather(local, self.mesh, self.task_axis, dim=0)
        allr = allr.reshape(self.n_shards, *local.shape)    # [n, 2, K, S]
        off = 0
        for v in vids:
            w = self.vblock[v][1] - self.vblock[v][0]
            both = torch.cat(list(allr[:, :, :, off:off + w]), dim=2)
            emit_parts[v], consumed_parts[v] = both[0], both[1]
            off += w

    def _route_edge(self, eidx: int, out: RecordBatch,
                    rr_offsets: List[torch.Tensor]
                    ) -> Tuple[RecordBatch, torch.Tensor]:
        """Route a producer's ``[K, P, cap]`` block over edge ``eidx``;
        a REBALANCE edge advances its entry of ``rr_offsets`` by the
        block's global count. On a mesh only this rank's destination
        lanes are routed (``out`` is the whole producer block)."""
        job = self.job
        e = job.edges[eidx]
        dst_p = job.vertices[e.dst].parallelism
        lo, hi = self.vblock[e.dst]
        lanes = None if (lo, hi) == (0, dst_p) else (lo, hi)
        if eidx in self.static_route:
            return self.static_route[eidx].apply(out, lanes)
        if e.partition == PartitionType.HASH:
            return routing.route_hash_block(out, dst_p, job.num_key_groups,
                                            e.capacity, lanes=lanes)
        if e.partition == PartitionType.FORWARD:
            if lanes is not None:
                out = RecordBatch(*(x[:, lo:hi] for x in out))
            return routing.route_forward_block(out, e.capacity)
        if e.partition == PartitionType.REBALANCE:
            counts = out.count().sum(dim=1, dtype=torch.int32)
            offs = (rr_offsets[eidx][0]
                    + torch.cumsum(counts, 0, dtype=torch.int32)
                    - counts)                                     # exclusive
            rr_offsets[eidx] = ((rr_offsets[eidx]
                                 + counts.sum(dtype=torch.int32)) % dst_p)
            return routing.route_rebalance_block(out, dst_p, e.capacity,
                                                 offs, lanes=lanes)
        return routing.route_broadcast_block(out, hi - lo, e.capacity)

    def _det_rows(self, binputs: BlockInputs, emits_all: torch.Tensor
                  ) -> torch.Tensor:
        """The block's packed determinant rows ``[L, K*4, lanes]``."""
        K = binputs.times.shape[0]
        dev = emits_all.device
        times = binputs.times.to(torch.int32)
        rows = torch.zeros((self.L, K, DETS_PER_STEP, det.NUM_LANES),
                           dtype=torch.int32, device=dev)
        rows[:, :, 0, det.LANE_TAG] = det.TIMESTAMP
        rows[:, :, 0, det.LANE_P] = torch.where(times < 0, -1, 0)
        rows[:, :, 0, det.LANE_P + 1] = times
        rows[:, :, 1, det.LANE_TAG] = det.RNG
        rows[:, :, 1, det.LANE_P] = binputs.rng_bits.to(torch.int32)
        rows[:, :, 2, det.LANE_TAG] = det.ORDER
        rows[:, :, 3, det.LANE_TAG] = det.BUFFER_BUILT
        rows[:, :, 3, det.LANE_P] = emits_all.T
        return rows.reshape(self.L, K * DETS_PER_STEP, det.NUM_LANES)

    def superstep(self, carry: JobCarry, inputs: StepInputs
                  ) -> Tuple[JobCarry, StepOutputs]:
        """One superstep (a K=1 block)."""
        dev = carry.record_counts.device
        z = torch.zeros((), dtype=torch.int32, device=dev)
        binputs = BlockInputs(times=inputs.time.reshape(1),
                              rng_bits=inputs.rng_bits.reshape(1),
                              epoch=z, step0=z)
        carry, outs = self.run_block(carry, binputs)
        return carry, StepOutputs(
            sinks={vid: RecordBatch(*(x[0] for x in b))
                   for vid, b in outs.sinks.items()},
            dropped={e: d[0] for e, d in outs.dropped.items()},
            consumed=outs.consumed[0])


def _gather_block(out: RecordBatch, mesh, axis: str) -> RecordBatch:
    """Every rank's ``[K, P/n, cap]`` output block as the whole ``[K, P,
    cap]``, in one all-gather (the four fields packed into one int32
    tensor)."""
    from clonos_tpu_torch.parallel import distributed as dist_
    packed = torch.stack([out.keys, out.values, out.timestamps,
                          out.valid.to(torch.int32)])
    whole = dist_.all_gather(packed, mesh, axis, dim=2)
    return RecordBatch(whole[0], whole[1], whole[2], whole[3] != 0)


def _canon_log(state: clog.ThreadLogState) -> clog.ThreadLogState:
    """Zero a stack of logs' ring rows outside [tail, head) and epoch slots
    outside the live epoch range: the logically-dead storage two
    equivalent runs may disagree on."""
    L = state.head.shape[0]
    dev = state.head.device
    cap = state.capacity
    ar = torch.arange(cap, dtype=torch.int32, device=dev)
    lidx = torch.arange(L, device=dev)[:, None]
    pos = ((state.tail[:, None] + ar[None, :]) & (cap - 1)).to(torch.int64)
    live = torch.zeros((L, cap), dtype=torch.bool, device=dev)
    live[lidx.expand(L, cap), pos] = ar[None, :] < (state.head
                                                    - state.tail)[:, None]
    m = state.max_epochs
    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    lo = torch.maximum(state.epoch_base, state.latest_epoch - m + 1)
    e_abs = lo[:, None] + eidx[None, :]
    live_e = torch.zeros((L, m), dtype=torch.bool, device=dev)
    live_e[lidx.expand(L, m), (e_abs % m).to(torch.int64)] = \
        e_abs <= state.latest_epoch[:, None]
    return state._replace(
        rows=torch.where(live[:, :, None], state.rows, 0),
        epoch_starts=torch.where(live_e, state.epoch_starts, 0))


def _canon_ring(state: ifl.EdgeLogState) -> ifl.EdgeLogState:
    S = state.ring_steps
    dev = state.head.device
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    pos = ((state.tail + ar) & (S - 1)).to(torch.int64)
    live = torch.zeros((S,), dtype=torch.bool, device=dev)
    live[pos] = ar < (state.head - state.tail)
    lv = live[:, None, None]
    m = state.max_epochs
    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    lo = torch.maximum(state.epoch_base, state.latest_epoch - m + 1)
    live_e = torch.zeros((m,), dtype=torch.bool, device=dev)
    live_e[((lo + eidx) % m).to(torch.int64)] = lo + eidx <= \
        state.latest_epoch
    return state._replace(
        keys=torch.where(lv, state.keys, 0),
        values=torch.where(lv, state.values, 0),
        timestamps=torch.where(lv, state.timestamps, 0),
        valid=state.valid & lv,
        epoch_starts=torch.where(live_e, state.epoch_starts, 0))


def _window_bounds(starts: torch.Tensor, head: torch.Tensor, epoch: int
                   ) -> torch.Tensor:
    """``[..., 2]`` (start, end) offsets of one closed epoch in a log or
    ring (a stack or one): an end not stamped yet (below the start) is
    the head."""
    me = starts.shape[-1]
    s = starts[..., epoch % me]
    t = starts[..., (epoch + 1) % me]
    return torch.stack([s, torch.where(t < s, head, t)], dim=-1)


def _slice_log_window(logs: clog.ThreadLogState, bounds: np.ndarray
                      ) -> torch.Tensor:
    """Every log's rows ``[start, end)`` (host ``bounds[L, 2]``), gathered
    on the device and concatenated in flat order: ``[sum(n), lanes]``."""
    cap = logs.capacity
    flat = np.concatenate([np.full(int(e - s), f, np.int64)
                           for f, (s, e) in enumerate(bounds)] or
                          [np.zeros(0, np.int64)])
    pos = np.concatenate([np.arange(s, e, dtype=np.int64) & (cap - 1)
                          for s, e in bounds] or [np.zeros(0, np.int64)])
    dev = logs.rows.device
    return logs.rows[_device.upload(flat, dev), _device.upload(pos, dev)]


def _ring_window_total(el: ifl.EdgeLogState, bounds: torch.Tensor
                       ) -> torch.Tensor:
    """The valid records in one ring's steps ``[start, end)`` (device
    ``bounds[2]``), counted on the device: int32 ``[1]``."""
    rel = (torch.arange(el.ring_steps, dtype=torch.int32,
                        device=bounds.device) - bounds[0]) \
        & (el.ring_steps - 1)
    per_step = el.valid.sum(dim=(1, 2), dtype=torch.int32)
    return torch.where(rel < bounds[1] - bounds[0], per_step, 0).sum(
        dtype=torch.int32).reshape(1)


def _slice_ring_window(el: ifl.EdgeLogState, lo: int, hi: int, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring's steps ``[lo, hi)`` compacted on the device into its
    ``n`` valid records, int32 ``[3, n]`` (keys, values, timestamps) in
    step, lane, slot order, and the per-step counts ``[steps]`` that cut
    them back into steps. Each record's slot is its int32 ``cumsum`` rank;
    invalid ones land in a spare slot past the end, so no shape depends
    on the data (a boolean mask would sync)."""
    pos = torch.arange(int(lo), int(hi), dtype=torch.int64,
                       device=el.head.device) & (el.ring_steps - 1)
    m = el.valid[pos]
    flat_m = m.reshape(-1)
    dest = torch.where(flat_m, torch.cumsum(flat_m, 0, dtype=torch.int32)
                       - 1, int(n)).to(torch.int64)
    recs = torch.stack([el.keys[pos], el.values[pos], el.timestamps[pos]]
                       ).reshape(3, -1).to(torch.int32)
    out = torch.zeros((3, int(n) + 1), dtype=torch.int32,
                      device=el.head.device)
    out.scatter_(1, dest.expand(3, -1), recs)
    return out[:, :int(n)], m.sum(dim=(1, 2), dtype=torch.int32)


def iter_ring_steps(window: Dict[str, Any]):
    """Deterministic scan order over one ``epoch_window`` dict's ring
    section: ``(vertex_id, step_seq, keys, values, timestamps)`` tuples,
    vertices ascending, steps in epoch-relative order, records in the
    (lane, slot) order :func:`_slice_ring_window` compacted them in. The
    lineage plane's dye scan (obs/lineage.py) reads windows through
    this, so the window's shape stays owned here."""
    rings = window.get("rings", {}) or {}
    for vid in sorted(rings, key=int):
        for seq, (keys, values, stamps) in enumerate(rings[vid]):
            yield int(vid), seq, keys, values, stamps


def canonical_carry(carry: JobCarry) -> JobCarry:
    """The carry with all logically-dead storage zeroed — the equality
    domain of the bit-identical-recovery property."""
    return carry._replace(
        logs=_canon_log(carry.logs),
        replicas=_canon_log(carry.replicas),
        out_rings=tuple(_canon_ring(r) for r in carry.out_rings))


class FenceHandles:
    """One closed epoch's fence surface on its way to the host: the health
    vector and, for the audit seal, the epoch's causal-log rows and ring
    steps. Made by :meth:`LocalExecutor.capture_fence` on the thread that
    drives the blocks; :meth:`health` and :meth:`window` may run on any
    thread and only wait for the capture's own copies (never for a block
    queued after it), so a fence worker drains them while the next
    epoch's compute runs."""

    def __init__(self, epoch: int, health: _device.HostCopy,
                 window: Optional[_device.HostCopy],
                 log_counts: np.ndarray, steps: Tuple[int, int],
                 ring_vids: Sequence[int], executor=None):
        self.epoch = epoch
        self._health = health
        self._window = window
        self._log_counts = log_counts
        self._steps = steps
        self._ring_vids = list(ring_vids)
        #: on a mesh, the capturing LocalExecutor: :meth:`health` and
        #: :meth:`window` then gather every rank's piece over its fence
        #: group (every rank's worker calls both, in this order)
        self._executor = executor

    def health(self) -> np.ndarray:
        vec = self._health.wait()
        ex = self._executor
        if ex is None or ex.compiled.n_shards == 1:
            return vec
        from clonos_tpu_torch.parallel import distributed as dist_
        parts = dist_.all_gather_object(vec, ex.mesh, ex.compiled.task_axis,
                                        group=ex._fence_group)
        return ex._combine_health(
            torch.from_numpy(np.stack(parts))).numpy()

    def window(self) -> Optional[Dict[str, Any]]:
        """The captured surface in :meth:`LocalExecutor.epoch_window`'s
        exact shape (None when captured without one; on a mesh, on every
        rank but 0). The host-derived bounds the capture sliced by are
        checked against the device's."""
        if self._window is None:
            return None
        win = self._local_window()
        ex = self._executor
        if ex is None or ex.compiled.n_shards == 1:
            return win
        from clonos_tpu_torch.parallel import distributed as dist_
        parts = dist_.gather_object(win, ex.mesh, ex.compiled.task_axis,
                                    group=ex._fence_group)
        return None if parts is None else ex._merge_windows(parts)

    def _local_window(self) -> Dict[str, Any]:
        w = self._window.wait()
        L = self._log_counts.shape[0]
        starts, heads = w["bounds"][:L], w["bounds"][L:2 * L]
        if not np.array_equal(heads - starts, self._log_counts):
            raise RuntimeError(
                f"epoch {self.epoch}: host log window counts "
                f"{self._log_counts.tolist()} != device "
                f"{(heads - starts).tolist()}")
        lo, hi = self._steps
        rb = w["bounds"][2 * L:].reshape(-1, 2)
        for vid, (s, t) in zip(self._ring_vids, rb):
            if (int(s), int(t)) != (lo, hi):
                raise RuntimeError(
                    f"epoch {self.epoch}: ring of vertex {vid} holds steps "
                    f"[{int(s)}, {int(t)}), host expected [{lo}, {hi})")
        cuts = np.concatenate([[0], np.cumsum(self._log_counts)])
        ex = self._executor
        flat0 = ex.compiled.lblock[0] if ex is not None else 0
        logs = {flat0 + f: w["log_rows"][cuts[f]:cuts[f + 1]]
                for f in range(L)}
        rings: Dict[int, list] = {}
        for vid, (recs, counts) in zip(self._ring_vids, w["rings"]):
            at = np.concatenate([[0], np.cumsum(counts)])
            rings[vid] = [(recs[0, at[s]:at[s + 1]], recs[1, at[s]:at[s + 1]],
                           recs[2, at[s]:at[s + 1]]) for s in range(hi - lo)]
        return {"logs": logs, "rings": rings}


class CausalTimeSource:
    """Host clock for the live path: int32 millis since executor start,
    recorded in every task's log as TIMESTAMP determinants."""

    def __init__(self):
        self._t0 = _time.monotonic()

    def now(self) -> int:
        return int((_time.monotonic() - self._t0) * 1000) & 0x7FFFFFFF


class LogicalTimeSource:
    """Deterministic causal time: 1 ms per superstep, read as the absolute
    step index about to be stamped."""

    def __init__(self, executor: "LocalExecutor"):
        self._ex = executor

    def now(self) -> int:
        return len(self._ex.step_input_history) & 0x7FFFFFFF


class LocalExecutor:
    """Single-process job driver: owns the compiled job, the carry, the
    causal time/RNG sources and the epoch loop. ``device`` defaults to
    ``"cuda"`` and raises without a card."""

    def __init__(self, job: JobGraph, steps_per_epoch: int = 16,
                 log_capacity: int = 1 << 14, max_epochs: int = 64,
                 inflight_ring_steps: int = 64,
                 spool_dir: Optional[str] = None,
                 spill_policy: str = ifl.SpillPolicy.EAGER,
                 spill_host_budget_epochs: Optional[int] = 2,
                 block_steps: Optional[int] = None,
                 replication_factor: int = -1,
                 seed: int = 0, logical_time: bool = False,
                 device="cuda", mesh=None, task_axis: str = "tasks"):
        self.device = _device.resolve(device)
        self.compiled = CompiledJob(job, log_capacity=log_capacity,
                                    max_epochs=max_epochs,
                                    inflight_ring_steps=inflight_ring_steps,
                                    replication_factor=replication_factor,
                                    mesh=mesh, task_axis=task_axis)
        #: the task mesh (None: the job is one implicit shard)
        self.mesh = mesh
        #: the pipelined fence worker's own gloo group over the mesh, and
        #: the driving thread's for host-only agreements (a failed feed
        #: pull, the checkpoint-completion gate, a recovery step that
        #: failed on one rank)
        self._fence_group = self._host_group = None
        if mesh is not None:
            from clonos_tpu_torch.parallel import distributed as dist_
            self._fence_group = dist_.fence_group(mesh, task_axis)
            self._host_group = dist_.fence_group(mesh, task_axis)
        self.job = job
        self.steps_per_epoch = steps_per_epoch
        self.block_steps = min(block_steps or 512, steps_per_epoch,
                               inflight_ring_steps)
        self.time_source = (LogicalTimeSource(self) if logical_time
                            else CausalTimeSource())
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.epoch_id = 0
        self.step_in_epoch = 0
        #: (flat, epoch) -> async rows appended in that epoch's roll gap
        #: (after the roll, before its first step); recovery subtracts it
        #: when re-deriving epoch start offsets from TIMESTAMP anchors.
        self.roll_gap_async: Dict[Tuple[int, int], int] = {}
        #: (flat, epoch) -> all async rows appended in that epoch.
        self.async_counts: Dict[Tuple[int, int], int] = {}
        #: supersteps actually executed
        self._steps_executed = 0
        self.step_input_history: List[Tuple[int, int]] = []
        #: the last closed epoch's superstep range [lo, hi)
        self.closed_steps: Tuple[int, int] = (0, 0)
        #: host mirrors of the in-flight ring bounds: epoch -> its first
        #: superstep (every ring's head counts supersteps), and the ring
        #: tail, which moves only at the truncation the host orders
        self._epoch_first: Dict[int, int] = {0: 0}
        self._ring_tail = 0
        #: (epoch, its log window) gathered by the spill hook, reused by
        #: capture_fence at the same fence
        self._log_window_cache: Optional[Tuple[int, tuple]] = None
        # Tiered storage: one spill owner per ring vertex and one store
        # for the stacked determinant logs (None = spill off). On a mesh
        # each rank spills its own lanes of every sharded ring and its own
        # log block under ``spool_dir/rank<r>``; a ring or a log stack
        # that does not split is spilled by rank 0 alone (the entry is
        # None on the other ranks). Policies and host budgets are a
        # rank's.
        self.spill_policy = spill_policy
        self.spill_logs: Optional[List[Optional[
            ifl.SpillingInFlightLog]]] = None
        self.det_store = None
        #: per-ring epochs (epoch, first step, steps) the AVAILABILITY
        #: policy deferred, awaiting a later spill or truncation
        self._pending_spill: List[List[Tuple[int, int, int]]] = [
            [] for _ in self.compiled.ring_vertices]
        if spool_dir is not None:
            from clonos_tpu_torch.storage import TieredEpochStore
            comp = self.compiled
            lead = comp.shard == 0
            if mesh is not None:
                spool_dir = os.path.join(spool_dir, f"rank{comp.shard}")
            self.spill_logs = [
                ifl.SpillingInFlightLog(
                    spool_dir, edge_id=vid, policy=spill_policy,
                    host_budget_epochs=spill_host_budget_epochs)
                if lead or comp.sharded(vid) else None
                for vid in comp.ring_vertices]
            if lead or comp.lblock != (0, comp.L):
                self.det_store = TieredEpochStore(
                    spool_dir, "dets",
                    durable=spill_policy != ifl.SpillPolicy.DISABLED,
                    host_budget_epochs=spill_host_budget_epochs)
        # Epoch 0 starts at log offset 0 for every log.
        self.carry = self._roll(self.compiled.init_carry(self.device), 0)
        #: vid -> FeedReader of a HostFeedSource vertex (None on a rank
        #: that rank 0's one reader serves)
        self.feed_readers: Dict[int, Any] = {}
        #: feed vertices whose one reader (rank 0's) serves every rank
        self._single_feeds: set = set()
        #: called after every block with (last causal time, record stamp):
        #: the superstep-boundary hook timer services advance on
        self.block_listeners: List[Any] = []
        #: called after every block with (BlockOutputs, epoch id): the
        #: transactional sinks' egress tap
        self.on_block_outputs: Optional[Any] = None

    @property
    def plan(self) -> rep.ReplicationPlan:
        return self.compiled.plan

    def release_groups(self) -> None:
        """Let go of this executor's two gloo groups (a runner fenced off
        by a live re-cut): the fenced-off executor makes no collective
        afterwards."""
        if self.mesh is None:
            return
        import torch.distributed as dist
        for g in (self._fence_group, self._host_group):
            if g is not None:
                dist.destroy_process_group(g)
        self._fence_group = self._host_group = None

    def _roll(self, carry: JobCarry, e: int) -> JobCarry:
        """Epoch fence: stamp the new epoch's start offset on every log,
        replica and in-flight ring."""
        replicas = carry.replicas
        if self.compiled.plan.num_replicas > 0:
            replicas = rep.sync_replica_epochs(replicas, e)
        return carry._replace(
            logs=clog.v_start_epoch(carry.logs, e),
            out_rings=tuple(ifl.start_epoch(el, e)
                            for el in carry.out_rings),
            replicas=replicas)

    def _trunc(self, carry: JobCarry, e: int) -> JobCarry:
        replicas = carry.replicas
        if self.compiled.plan.num_replicas > 0:
            replicas = clog.v_truncate(replicas, e)
        return carry._replace(
            logs=clog.v_truncate(carry.logs, e),
            out_rings=tuple(ifl.truncate(el, e) for el in carry.out_rings),
            replicas=replicas)

    def register_feed(self, vertex_id: int, reader) -> None:
        """Attach a rewindable reader (``api/feeds.py``) to a
        HostFeedSource vertex. On a mesh every rank registers in lockstep
        (the ranks check that they agree): each its own reader of the
        same feed (it pulls only its own lanes), or, for a
        ``SocketFeedReader``, one reader for every rank: rank 0 registers
        it (only rank 0 opens the connection) and every other rank
        registers None. Rank 0 then pulls every lane at each block and
        sends each rank its lanes (the whole batch for a vertex that does
        not split), serves a recovery's re-reads from its retention and
        commits every lane's offset."""
        from clonos_tpu_torch.api.feeds import SocketFeedReader
        comp = self.compiled
        if vertex_id not in comp.feed_vertices:
            raise ValueError(f"vertex {vertex_id} is not a HostFeedSource")
        if comp.n_shards == 1:
            if reader is None:
                raise ValueError(f"vertex {vertex_id}: no feed reader")
            self.feed_readers[vertex_id] = reader
            return
        from clonos_tpu_torch.parallel import distributed as dist_
        single = reader is None or isinstance(reader, SocketFeedReader)
        got = dist_.all_gather_object((single, reader is None), self.mesh,
                                      comp.task_axis, group=self._host_group)
        if len({m for m, _ in got}) != 1 or (got[0][0] and [
                none for _, none in got] != [False] + [True] * (len(got) - 1)):
            raise ValueError(
                f"vertex {vertex_id}: the ranks disagree on its reader — "
                f"a SocketFeedReader (one for every rank) is registered on "
                f"rank 0 and None on every other rank")
        if single:
            self._single_feeds.add(vertex_id)
        self.feed_readers[vertex_id] = reader

    def _pull_feeds(self, k: int) -> Tuple[RecordBatch, ...]:
        """k steps' worth of records from every feed reader as stacked
        ``[k, P, B]`` batches: one non-blocking upload per feed of keys,
        values and per-step counts, from which the card builds the valid
        plane. On a card the readers' arrays are packed straight into
        pinned memory that the caching host allocator hands back from
        block to block (``feed.pack``'s ``pinned`` is 1), and the copy is
        enqueued from there; a block rank 0 scatters is packed on the host
        and each piece uploaded through :func:`device.upload` (``pinned``
        0, as on the CPU, where each block has a buffer of its own).

        On a mesh a rank pulls only the lanes it runs (``[k, hi - lo,
        B]``); a feed vertex whose parallelism does not split is pulled
        whole on every rank, each from its own reader, which holds the
        same state on every rank. A pull that raises on one rank is
        settled across the ranks (:func:`~clonos_tpu_torch.parallel.
        distributed.agree`) before the block's first collective, so every
        rank raises there and none waits for it."""
        comp = self.compiled
        tr = get_tracer()
        hosts: List[Optional[np.ndarray]] = []
        err: Optional[BaseException] = None
        for vid in comp.feed_vertices:
            b = self.job.vertices[vid].operator.batch_size
            # One reader for every rank: rank 0 pulls every lane.
            lo, hi = ((0, self.job.vertices[vid].parallelism)
                      if vid in self._single_feeds else comp.vblock[vid])
            reader = self.feed_readers.get(vid)
            if reader is None or err is not None:
                hosts.append(None)
                continue
            host = None
            # Packed straight into pinned memory on a card, unless rank 0
            # scatters the block to the other ranks from the host.
            pinned = (self.device.type == "cuda"
                      and vid not in self._single_feeds)
            try:
                # The reader's calls (with any wait for arrivals), then
                # the staging array: two spans.
                with tr.span("feed.pull", vertex=vid):
                    pulled = [reader.pull_block(s, b, k)
                              for s in range(lo, hi)]
                with tr.span("feed.pack", vertex=vid,
                             pinned=int(pinned)) as sp:
                    allocs = (_device.cuda_allocs(self.device)
                              if tr.enabled and pinned else None)
                    host = _pack_feed(pulled, k, b, pinned)
                    if allocs is not None:
                        sp.args["cuda_allocs"] = (
                            _device.cuda_allocs(self.device) - allocs)
            except Exception as e:          # settled below, on every rank
                err = e
            hosts.append(host)
        if comp.n_shards > 1 and comp.feed_vertices:
            from clonos_tpu_torch.parallel import distributed as dist_
            dist_.agree(err, self.mesh, comp.task_axis,
                        group=self._host_group)
        elif err is not None:
            raise err
        feeds = []
        for vid, host in zip(comp.feed_vertices, hosts):
            lo, hi = comp.vblock[vid]
            b = self.job.vertices[vid].operator.batch_size
            if vid in self._single_feeds:
                p = self.job.vertices[vid].parallelism
                host = dist_.scatter_object(
                    [_feed_lanes(host, k, p, b,
                                 *_block(p, comp.n_shards, r))
                     for r in range(comp.n_shards)] if host is not None
                    else None, self.mesh, comp.task_axis,
                    group=self._host_group)
            if host is None:
                feeds.append(empty((k, hi - lo, b), self.device))
                continue
            with tr.span("feed.upload", vertex=vid,
                         bytes=int(host.nbytes)) as sp:
                allocs = (_device.cuda_allocs(self.device) if tr.enabled
                          else None)
                if isinstance(host, np.ndarray):    # a scattered piece
                    arr = _device.upload(host, self.device)
                else:
                    # Pinned: one copy, enqueued. On the CPU the block's
                    # own buffer, taken as it is.
                    arr = host.to(self.device, non_blocking=True)
                if allocs is not None:
                    sp.args["cuda_allocs"] = (
                        _device.cuda_allocs(self.device) - allocs)
            feeds.append(_feed_batch(arr, k, hi - lo, b))
        return tuple(feeds)

    def _next_block_inputs(self, k: int) -> BlockInputs:
        host = np.empty((2, k), np.int32)
        for i in range(k):
            t = self.time_source.now()
            r = int(self._rng.randint(0, 2 ** 31, dtype=np.int64))
            host[0, i], host[1, i] = t, r
            self.step_input_history.append((t, r))
        if self.compiled.n_shards > 1 and not isinstance(
                self.time_source, LogicalTimeSource):
            # One causal time for the whole mesh: every rank takes rank
            # 0's readings (a wall clock reads differently on each rank,
            # and a replica's rows must equal its owner's on another).
            # Logical time and the seeded RNG read the same on every rank.
            from clonos_tpu_torch.parallel import distributed as dist_
            host = dist_.broadcast_array(host, self.mesh,
                                         self.compiled.task_axis,
                                         group=self._host_group)
            self.step_input_history[-k:] = [
                (int(t), int(r)) for t, r in zip(host[0], host[1])]
        both = _device.upload(host, self.device)
        return BlockInputs(
            times=both[0], rng_bits=both[1],
            epoch=_device.scalar(self.epoch_id, self.device),
            step0=_device.scalar(len(self.step_input_history) - k,
                                 self.device),
            feeds=self._pull_feeds(k))

    def _run_block(self, k: int) -> BlockOutputs:
        tr = get_tracer()
        with tr.span("block.inputs"):
            binputs = self._next_block_inputs(k)
        with tr.span("block.run", steps=k):
            self.carry, outs = self.compiled.run_block(self.carry, binputs)
        self.step_in_epoch += k
        self._steps_executed += k
        with tr.span("block.listeners"):
            if self.on_block_outputs is not None:
                self.on_block_outputs(outs, self.epoch_id)
            self._notify_block()
        return outs

    def _notify_block(self) -> None:
        """Block listeners get the last executed step's causal time and
        the record stamp: host-known values, no device read."""
        if self.block_listeners and self._steps_executed:
            t = self.step_input_history[self._steps_executed - 1][0]
            stamp = self.global_record_stamp()
            for fn in self.block_listeners:
                fn(t, stamp)

    def step(self) -> StepOutputs:
        """Run one superstep (a K=1 block)."""
        outs = self._run_block(1)
        return StepOutputs(
            sinks={vid: RecordBatch(*(x[0] for x in b))
                   for vid, b in outs.sinks.items()},
            dropped={e: d[0] for e, d in outs.dropped.items()},
            consumed=outs.consumed[0])

    def run_epoch(self) -> Optional[BlockOutputs]:
        """Run the rest of the current epoch in blocks, then roll the
        epoch (the checkpoint fence). Returns the last block's outputs."""
        outs = None
        self._log_window_cache = None
        first = self._steps_executed - self.step_in_epoch
        while self.step_in_epoch < self.steps_per_epoch:
            outs = self._run_block(min(
                self.block_steps, self.steps_per_epoch - self.step_in_epoch))
        closed, hi = self.epoch_id, self._steps_executed
        prof = get_profiler()
        if self.spill_logs is not None:
            # Before the roll stamps the next epoch: the closed epoch's
            # log windows are [epoch start, head).
            with record_function("spill"), prof.section("spill"):
                self._spill_epoch(closed, first, hi)
        self.epoch_id += 1
        self.step_in_epoch = 0
        with prof.section("roll"):
            self.carry = self._roll(self.carry, self.epoch_id)
            prof.fence(self.carry.logs)
        self._epoch_first[self.epoch_id] = hi
        #: the closed epoch's superstep range (what capture_fence slices)
        self.closed_steps = (first, hi)
        return outs

    def _spill_epoch(self, epoch: int, lo: int, hi: int) -> None:
        """Move the just-closed epoch's ring steps ``[lo, hi)`` and its
        determinant windows to the tiered stores. Every bound is the
        host's own (heads count supersteps; the tail moves only at the
        truncation the host orders), so nothing here reads the device:
        each slice is gathered into a fresh tensor (later blocks write
        the rings in place) and its copy to the host starts now.

        Policy AVAILABILITY skips epochs while the ring has headroom, but
        a skipped epoch is only deferred: before a later ring wrap could
        clobber its steps it is spilled retroactively."""
        for i, el in enumerate(self.carry.out_rings):
            S = el.ring_steps
            sl = self.spill_logs[i]
            if sl is None:
                continue                 # another rank spills this ring
            if (self.spill_policy == ifl.SpillPolicy.AVAILABILITY
                    and (hi - self._ring_tail) / S
                    < sl.availability_trigger):
                if hi > lo:
                    self._pending_spill[i].append((epoch, lo, hi - lo))
            elif hi > lo:
                sl.spill_epoch(epoch, lo, ifl.slice_steps_at(el, lo, hi - lo))
            # Retroactive flush: whatever a wrap could reach within the
            # next epoch's appends leaves the ring now.
            danger = hi + self.steps_per_epoch - S
            keep = []
            for (e, s, m) in self._pending_spill[i]:
                if s < hi - S:
                    raise RuntimeError(
                        f"in-flight ring {i}: epoch {e} steps "
                        f"[{s}, {s + m}) were clobbered before spilling "
                        f"(AVAILABILITY policy deferred too long)")
                if s < danger:
                    sl.spill_epoch(e, s, ifl.slice_steps_at(el, s, m))
                else:
                    keep.append((e, s, m))
            self._pending_spill[i] = keep
        if self.det_store is not None:
            self._spill_det_epoch(epoch, lo, hi)

    def _spill_det_epoch(self, epoch: int, lo: int, hi: int) -> None:
        """The closed epoch's determinant windows of every stacked log,
        padded to ``[L, max count, lanes]`` with their counts and start
        offsets (the reference's segment layout), from the same log-window
        gather the pipelined fence's capture uses."""
        counts, flat_d, rel_d, starts, rows = self._log_window(epoch, lo, hi)
        nmax = max(int(counts.max()) if counts.size else 0, 1)
        # On a mesh: this rank's log block.
        padded = torch.zeros((len(counts), nmax, det.NUM_LANES),
                             dtype=torch.int32, device=self.device)
        padded[flat_d, rel_d] = rows
        self.det_store.put(epoch, None, _device.HostCopy({
            "rows": padded, "counts": counts.astype(np.int32),
            "starts": starts.to(torch.int32)}))

    def notify_checkpoint_complete(self, epoch: int) -> None:
        """Truncate determinant and in-flight logs, and their spilled
        tiers, for epochs <= ``epoch``."""
        get_tracer().event("epoch.inflight_truncate", epoch=epoch)
        prof = get_profiler()
        with prof.section("truncate"):
            self.carry = self._trunc(self.carry, epoch)
            prof.fence(self.carry.logs)
            for st in self._tier_stores():
                st.truncate(epoch)
        first = self._epoch_first.get(epoch + 1)
        if first is not None:
            self._ring_tail = max(self._ring_tail, first)
        self._epoch_first = {e: s for e, s in self._epoch_first.items()
                             if e > epoch}
        self._pending_spill = [[p for p in pend if p[0] > epoch]
                               for pend in self._pending_spill]
        self.roll_gap_async = {k: v for k, v in self.roll_gap_async.items()
                               if k[1] > epoch}
        self.async_counts = {k: v for k, v in self.async_counts.items()
                             if k[1] > epoch}

    # --- tiered-storage surface (storage/tiered.py) --------------------------

    def _tier_stores(self) -> list:
        out = []
        if self.spill_logs is not None:
            out.extend(sl.store for sl in self.spill_logs if sl is not None)
        if self.det_store is not None:
            out.append(self.det_store)
        return out

    def attach_spill_digests(self, epoch: int, dg) -> None:
        """Stamp the sealed epoch's audit fingerprints onto its spilled
        tiers: each ring segment carries its ``ring/v<vid>`` channel
        chain, the determinant segment one fold over the ``log/<flat>``
        chains — the digests the ledger entry pins."""
        if self.spill_logs is not None:
            for i, vid in enumerate(self.compiled.ring_vertices):
                ch = dg.channels.get(f"ring/v{vid}")
                if ch is not None and self.spill_logs[i] is not None:
                    self.spill_logs[i].attach_digest(epoch, ch[1].hex())
        if self.det_store is not None:
            h = hashlib.blake2b(digest_size=8)
            for name in sorted(dg.channels):
                if name.startswith("log/"):
                    h.update(name.encode() + b"\x00" + dg.channels[name][1])
            self.det_store.attach_digest(epoch, h.hexdigest())

    def det_rows_for_epoch(self, flat: int, epoch: int) -> np.ndarray:
        """One subtask's determinant rows of a spilled epoch from whichever
        tier holds it — equal to ``epoch_window(epoch)["logs"][flat]``
        taken at the seal."""
        if self.det_store is None:
            raise RuntimeError("determinant tier disabled (no spool_dir, "
                               "or another rank holds this log block)")
        llo, lhi = self.compiled.lblock
        if not llo <= flat < lhi:
            raise ValueError(f"log {flat} is not in this rank's block "
                             f"[{llo}, {lhi})")
        _, arrs = self.det_store.load_epoch(epoch)
        c = int(np.asarray(arrs["counts"])[flat - llo])
        return np.ascontiguousarray(np.asarray(arrs["rows"])[flat - llo, :c])

    def spill_occupancy(self) -> Dict[str, int]:
        """Tier residency summed across every spill owner (rings + dets)."""
        agg = {"host_epochs": 0, "host_bytes": 0,
               "disk_epochs": 0, "disk_bytes": 0}
        for st in self._tier_stores():
            for k, v in st.occupancy().items():
                agg[k] += v
        return agg

    def spill_stats(self) -> Dict[str, Any]:
        """Cumulative spill/refill movement counters summed across
        stores."""
        agg: Dict[str, Any] = {}
        for st in self._tier_stores():
            for k, v in st.stats().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def drain_spill(self) -> None:
        """Block until every queued segment write is done."""
        for st in self._tier_stores():
            st.drain()

    def close_spill(self) -> None:
        """Drain, then stop every tiered store's writer thread (a stopped
        store still serves refills from what it holds)."""
        self.drain_spill()
        for st in self._tier_stores():
            st.close()

    def _health_vector(self, carry: JobCarry) -> torch.Tensor:
        """Packed int32 health flags, the total record count and the
        per-task log heads — one device value, one host read. On a mesh
        one all-gather of every rank's :meth:`_local_health`."""
        out = self._local_health(carry)
        if self.compiled.n_shards == 1:
            return out
        from clonos_tpu_torch.parallel import distributed as dist_
        allr = dist_.all_gather(out, self.mesh, self.compiled.task_axis)
        return self._combine_health(allr.reshape(self.compiled.n_shards, -1))

    def _combine_health(self, allr: torch.Tensor) -> torch.Tensor:
        """Every rank's local health ``[n, m]`` as the job's: the flags of
        any rank, the record total over the log blocks, every rank's
        block of heads in flat order."""
        nf = allr.shape[1] - 1 - (self.compiled.lblock[1]
                                  - self.compiled.lblock[0])
        split = self.compiled.lblock != (0, self.compiled.L)
        rec = (allr[:, nf].sum(dtype=torch.int32) if split
               else allr[0, nf]).reshape(1)
        heads = allr[:, nf + 1:].reshape(-1) if split else allr[0, nf + 1:]
        return torch.cat([allr[:, :nf].max(dim=0).values, rec, heads])

    def _local_health(self, carry: JobCarry) -> torch.Tensor:
        """:meth:`_health_vector` of this rank's shards."""
        logs = carry.logs
        cap = self.compiled.log_capacity
        flags = [
            (logs.head - logs.tail > cap).any(),
            clog.epoch_index_overflowed(logs).any(),
            clog.near_offset_wrap(logs).any(),
        ]
        for el in carry.out_rings:
            flags.append(ifl.overflowed(el))
        if self.compiled.plan.num_replicas > 0:
            flags.append((carry.replicas.head - carry.replicas.tail
                          > cap).any())
        else:
            flags.append(torch.zeros((), dtype=torch.bool,
                                     device=self.device))
        vec = torch.stack([f.to(torch.int32) for f in flags])
        return torch.cat([vec, carry.record_counts.sum(
            dtype=torch.int32).reshape(1), carry.logs.head])

    def health_vector(self) -> np.ndarray:
        return self._health_vector(self.carry).cpu().numpy()

    def _placed(self, tree, specs):
        """All-gather a tree of this rank's shards into the full tree."""
        from clonos_tpu_torch.parallel import distributed as dist_
        return dist_.all_gather_tree(tree, specs, self.mesh,
                                     self.compiled.task_axis)

    def full_carry(self) -> JobCarry:
        """The whole carry on every rank (the live carry without a mesh):
        one all-gather of every sharded leaf."""
        if self.mesh is None:
            return self.carry
        return self._placed(self.carry, self.compiled.placements())

    def per_shard_health(self) -> Optional[np.ndarray]:
        """int32 ``[n_shards, 3]`` (records, live log rows, live ring
        slots) summed over each rank's contiguous task-axis block, the
        blocks the reference's mesh deals (a leaf that does not split is
        cut into ceil-sized blocks, as the reference pads it). None
        without a mesh. A collective: every rank calls it."""
        if self.mesh is None:
            return None
        return self._per_shard_health().cpu().numpy()

    def _per_shard_health(self) -> torch.Tensor:
        """:meth:`per_shard_health` left on the device: one all-reduce,
        no host read."""
        from clonos_tpu_torch.parallel import distributed as dist_
        comp = self.compiled
        n, me = comp.n_shards, comp.shard
        c = self.carry
        dev = self.device

        def blocks(x: torch.Tensor, sharded: bool) -> torch.Tensor:
            """[n] block sums: this rank's row of a sharded leaf, every
            row of a replicated one (rank 0 counts it, once)."""
            out = torch.zeros((n,), dtype=torch.int32, device=dev)
            if sharded:
                out[me] = x.sum(dtype=torch.int32)
            elif me == 0:
                g = -(-x.shape[0] // n)
                pad = torch.zeros((g * n - x.shape[0],) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=dev)
                out = torch.cat([x, pad]).reshape(n, -1).sum(
                    dim=1, dtype=torch.int32)
            return out

        lsplit = comp.lblock != (0, comp.L)
        rec = blocks(c.record_counts, lsplit)
        rows = blocks(c.logs.head - c.logs.tail, lsplit)
        ring = torch.zeros((n,), dtype=torch.int32, device=dev)
        for vid, el in zip(comp.ring_vertices, c.out_rings):
            # [P(local), ...] per-lane counts of valid slots
            per_lane = el.valid.sum(dim=(0, 2), dtype=torch.int32)
            ring = ring + blocks(per_lane, comp.sharded(vid))
        mine = torch.stack([rec, rows, ring], dim=1)
        return dist_.all_reduce_sum(mine, self.mesh, comp.task_axis)

    def overflow_messages(self, vec: np.ndarray) -> List[str]:
        """Decode :meth:`health_vector` flags into violation strings."""
        out = []
        if vec[0]:
            out.append("causal log ring overflow (appends clobbered "
                       "un-truncated determinants)")
        if vec[1]:
            out.append("causal log epoch index overflow (> max_epochs "
                       "un-truncated epochs)")
        if vec[2]:
            out.append("causal log absolute offsets near int32 wrap "
                       "(rebase required)")
        # A spilled ring may wrap: its older steps live in the tiers.
        spilled = self.spill_logs is not None
        for i in range(len(self.carry.out_rings)):
            if vec[3 + i] and not spilled:
                out.append(f"in-flight ring of vertex "
                           f"{self.compiled.ring_vertices[i]} overflowed "
                           f"with spill disabled")
        if vec[3 + len(self.carry.out_rings)]:
            out.append("replica log ring overflow")
        return out

    def check_overflow(self) -> List[str]:
        """Overflow guards to heed at every epoch roll; empty = healthy."""
        return self.overflow_messages(self.health_vector())

    def plan_replicas_overflowed(self) -> bool:
        """True when some replica log holds more rows than the log
        capacity (one device read; on a mesh every rank's replica block
        counts, a collective every rank makes)."""
        if self.compiled.plan.num_replicas == 0:
            return False
        reps = self.carry.replicas
        over = (reps.head - reps.tail
                > self.compiled.log_capacity).any().to(torch.int32)
        if self.compiled.n_shards > 1:
            from clonos_tpu_torch.parallel import distributed as dist_
            over = dist_.all_reduce_sum(over.reshape(1), self.mesh,
                                        self.compiled.task_axis)
        return bool(over.sum().item())

    def global_record_stamp(self) -> int:
        """Monotone nonzero stamp for async rows (1 + supersteps run)."""
        return self._steps_executed + 1

    def async_rows_since(self, flat_subtask: int, from_epoch: int) -> int:
        """How many async determinant rows this task's log holds in epochs
        >= ``from_epoch`` (host ledger — no device read)."""
        return sum(v for (f, e), v in self.async_counts.items()
                   if f == flat_subtask and e >= from_epoch)

    def epoch_window(self, epoch: int) -> Dict[str, Any]:
        """Host snapshot of one CLOSED epoch's causal surface — the single
        extraction path behind the audit digests (``obs/audit.py``): the
        live seal at the fence and the recovery-time recompute both read
        through here, so their chain chunk boundaries agree.

        Returns ``{"logs": {flat: int32 rows[n, NUM_LANES]}, "rings":
        {vid: [(keys, values, timestamps) per step]}}`` — every task's
        determinant rows of the epoch and, per output ring, each step's
        valid records in (lane, slot) order. The epoch's steps are sliced
        and compacted on the device; the data crosses to the host in one
        copy after one small read of the window bounds and each ring's
        count of valid records.

        On a mesh every rank extracts its own log block and ring lanes and
        the pieces gather to rank 0, which returns the whole window (in the
        unsharded order: flats ascending, each step's records lane by
        lane); the other ranks return None. A collective: every rank calls
        it."""
        win = self._local_epoch_window(epoch)
        if self.compiled.n_shards == 1:
            return win
        from clonos_tpu_torch.parallel import distributed as dist_
        parts = dist_.gather_object(win, self.mesh, self.compiled.task_axis)
        return None if parts is None else self._merge_windows(parts)

    def _merge_windows(self, parts: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Every rank's :meth:`epoch_window` piece, in rank order, as the
        job's window: flats ascending, each step's records lane by lane."""
        comp = self.compiled
        logs: Dict[int, np.ndarray] = {}
        for part in (parts if comp.lblock != (0, comp.L) else parts[:1]):
            logs.update(part["logs"])
        rings: Dict[int, list] = {}
        for vid in parts[0]["rings"]:
            own = parts if comp.sharded(vid) else parts[:1]
            steps = zip(*(part["rings"][vid] for part in own))
            rings[vid] = [tuple(np.concatenate([x[f] for x in step])
                                for f in range(3)) for step in steps]
        return {"logs": {f: logs[f] for f in sorted(logs)}, "rings": rings}

    def _local_epoch_window(self, epoch: int) -> Dict[str, Any]:
        """:meth:`epoch_window` of this rank's shards (flats keyed
        globally)."""
        c = self.carry
        rings = [(vid, c.out_rings[ri])
                 for vid, ri in sorted(self.compiled.ring_index.items())]
        L = c.logs.head.shape[0]
        flat0 = self.compiled.lblock[0]
        ring_bounds = [_window_bounds(el.epoch_starts, el.head, epoch)
                       for _, el in rings]
        small = torch.cat(
            [_window_bounds(c.logs.epoch_starts, c.logs.head,
                            epoch).reshape(-1)]
            + [torch.cat([b, _ring_window_total(el, b)])
               for b, (_, el) in zip(ring_bounds, rings)]
        ).cpu().numpy().astype(np.int64)
        bounds = small[:2 * L].reshape(L, 2)
        pieces = [_slice_log_window(c.logs, bounds).reshape(-1)]
        ring_counts = []
        spilled: Dict[int, list] = {}
        for i, (vid, el) in enumerate(rings):
            lo, hi, n = small[2 * L + 3 * i:2 * L + 3 * i + 3]
            if (self.spill_logs is not None
                    and lo < self._steps_executed - el.ring_steps):
                # A wrap clobbered the epoch's leading steps: read them
                # from the spill tiers (a ring that does not split is rank
                # 0's; the merge takes that ring from rank 0's piece).
                ri = self.compiled.ring_index[vid]
                spilled[vid] = ([] if self.spill_logs[ri] is None else
                                self._spilled_ring_window(ri, epoch, int(lo),
                                                          int(hi)))
                continue
            recs, counts = _slice_ring_window(el, lo, hi, n)
            pieces += [counts, recs.reshape(-1)]
            ring_counts.append(counts.shape[0])
        flat = torch.cat([p.to(torch.int32) for p in pieces]).cpu().numpy()
        n_log = bounds[:L, 1] - bounds[:L, 0]
        rows = flat[:int(n_log.sum()) * det.NUM_LANES].reshape(
            -1, det.NUM_LANES)
        off = rows.size
        cuts = np.concatenate([[0], np.cumsum(n_log)])
        logs = {flat0 + f: rows[cuts[f]:cuts[f + 1]] for f in range(L)}
        out_rings: Dict[int, list] = dict(spilled)
        for (vid, _), n_steps in zip([r for r in rings
                                      if r[0] not in spilled], ring_counts):
            counts = flat[off:off + n_steps].astype(np.int64)
            off += n_steps
            n = int(counts.sum())
            recs = flat[off:off + 3 * n].reshape(3, n)
            off += 3 * n
            at = np.concatenate([[0], np.cumsum(counts)])
            out_rings[vid] = [(recs[0, at[s]:at[s + 1]],
                               recs[1, at[s]:at[s + 1]],
                               recs[2, at[s]:at[s + 1]])
                              for s in range(n_steps)]
        return {"logs": logs, "rings": {vid: out_rings[vid]
                                        for vid, _ in rings}}

    def _spilled_ring_window(self, ri: int, epoch: int, lo: int, hi: int
                             ) -> list:
        """:meth:`epoch_window`'s ring entry of a spilled epoch: each
        step's valid records in (lane, slot) order, from the tiers."""
        start, b = self.spill_logs[ri].load_epoch(epoch)
        if (start, start + b.keys.shape[0]) != (lo, hi):
            raise RuntimeError(
                f"spilled epoch {epoch} of ring {ri} holds steps "
                f"[{start}, {start + b.keys.shape[0]}), the ring's index "
                f"says [{lo}, {hi})")
        return [(b.keys[s][b.valid[s]], b.values[s][b.valid[s]],
                 b.timestamps[s][b.valid[s]]) for s in range(hi - lo)]

    def append_async_determinant(self, flat_subtask: int,
                                 d: det.Determinant) -> None:
        """Append one determinant row to a task's log (and every replica
        of it) between blocks: the causal services' and timers' path."""
        self.append_async_many([flat_subtask], d)

    def service_factory(self, flat_subtask: int, sidecar: det.SidecarStore,
                        replay_feed=None, seed: int = 0, clock=None):
        """A task's causal-service bundle: time, random and external-call
        wrappers whose values record into its log and replay after a
        failure."""
        from clonos_tpu_torch.causal.services import CausalServiceFactory
        return CausalServiceFactory(
            append=lambda d: self.append_async_determinant(flat_subtask, d),
            sidecar=sidecar, epoch_of=lambda: self.epoch_id,
            replay_feed=replay_feed, seed=seed, clock=clock)

    def vertex_state(self, vertex_id: int):
        """One vertex's operator state as numpy arrays (the reference's
        ``jax.device_get`` of it: same keys, same dtypes)."""
        st = self.carry.op_states[vertex_id]
        if self.mesh is not None:
            st = self._placed(st, self.compiled.placements().op_states[
                vertex_id])
        return _device.HostCopy(st).wait()

    def log_sizes(self) -> np.ndarray:
        """Buffered determinant rows per task log (one device read)."""
        logs = self.carry.logs
        size = logs.head - logs.tail
        if self.mesh is not None:
            size = self._placed(size, self.compiled.placements().logs.head)
        return size.cpu().numpy()

    def append_async_many(self, flat_subtasks: Sequence[int],
                          d: det.Determinant) -> None:
        """Append one determinant row to several subtask logs and every
        replica of each, between blocks (checkpoint broadcasts)."""
        row = d.pack().copy()
        if row[det.LANE_RC] == 0 and row[det.LANE_TAG] in (det.TIMESTAMP,
                                                           det.RNG):
            row[det.LANE_RC] = self.global_record_stamp()
        for f in flat_subtasks:
            k = (f, self.epoch_id)
            if self.step_in_epoch == 0:
                # Roll-gap append: belongs to the NEW epoch though it
                # precedes the epoch's first TIMESTAMP anchor.
                self.roll_gap_async[k] = self.roll_gap_async.get(k, 0) + 1
            self.async_counts[k] = self.async_counts.get(k, 0) + 1
        L = self.compiled.L
        rows1 = np.zeros((L, 1, det.NUM_LANES), np.int32)
        counts = np.zeros((L,), np.int32)
        rows1[list(flat_subtasks), 0] = row
        counts[list(flat_subtasks)] = 1
        llo, lhi = self.compiled.lblock
        with get_profiler().section("async-append"):
            rows_t = _device.upload(rows1, self.device)
            counts_t = _device.upload(counts, self.device)
            c = self.carry
            replicas = c.replicas
            if self.compiled.plan.num_replicas > 0:
                oi = self.compiled.owner_idx(self.device)
                replicas = clog.v_append(replicas, rows_t[oi], counts_t[oi])
            # On a mesh: this rank's block of the stacked logs.
            self.carry = c._replace(
                logs=clog.v_append(c.logs, rows_t[llo:lhi],
                                   counts_t[llo:lhi]),
                replicas=replicas)

    def local_lean_snapshot(self) -> LeanSnapshot:
        """This rank's shards of the fence snapshot: deep copies (the live
        carry's rings are updated in place by later blocks)."""
        c = self.carry
        cp = lambda t: tree_map(lambda x: x.clone(), t)
        return LeanSnapshot(
            op_states=cp(c.op_states), edge_bufs=cp(c.edge_bufs),
            rr_offsets=cp(c.rr_offsets), record_counts=cp(c.record_counts),
            log_heads=c.logs.head.clone(),
            ring_heads=tuple(r.head.clone() for r in c.out_rings))

    def lean_snapshot(self, local: Optional[LeanSnapshot] = None
                      ) -> Optional[LeanSnapshot]:
        """The fence snapshot (``local``, default
        :meth:`local_lean_snapshot`). On a mesh the sharded leaves gather
        to rank 0, which gets the whole snapshot, byte for byte an
        unsharded one's; the other ranks get None."""
        snap = self.local_lean_snapshot() if local is None else local
        if self.mesh is None:
            return snap
        from clonos_tpu_torch.parallel import distributed as dist_
        return dist_.gather_tree(snap, self._snapshot_placements(),
                                 self.mesh, self.compiled.task_axis)

    def _snapshot_placements(self) -> LeanSnapshot:
        pl = self.compiled.placements()
        return LeanSnapshot(pl.op_states, pl.edge_bufs, pl.rr_offsets,
                            pl.record_counts, pl.logs.head,
                            tuple(r.head for r in pl.out_rings))

    def gather_snapshot(self, local: LeanSnapshot) -> Optional[LeanSnapshot]:
        """Every rank's host copy of its lean snapshot shards (numpy) as
        the whole snapshot on rank 0, None on the others: the pipelined
        fence worker's half of :meth:`lean_snapshot`, over the fence
        group."""
        from clonos_tpu_torch.convert import unshard_carry
        from clonos_tpu_torch.parallel import distributed as dist_
        parts = dist_.gather_object(local, self.mesh, self.compiled.task_axis,
                                    group=self._fence_group)
        if parts is None:
            return None
        return unshard_carry(parts, self._snapshot_placements())

    def capture_fence(self, with_window: bool = True) -> FenceHandles:
        """Capture the fence surface of the epoch :meth:`run_epoch` just
        closed, dispatch-only: the health vector and (``with_window``)
        the epoch's log rows and its ring steps' valid records (compacted
        as :meth:`epoch_window` does) are gathered into fresh tensors
        (later blocks update the rings in place) and their copies to
        pinned host memory start now. The slice bounds come from the
        host — the closed epoch's superstep range and its async-row
        ledger — so nothing waits on the device; the device's own bounds
        ride along and are checked when the window is drained. Call it
        right after :meth:`run_epoch`, before any row of the new epoch."""
        c = self.carry
        closed = self.epoch_id - 1
        lo, hi = self.closed_steps
        # On a mesh: this rank's shards only; the fence worker gathers
        # them over the fence group (``FenceHandles``).
        health = _device.HostCopy(self._local_health(c))
        counts = self._log_counts(closed, lo, hi)
        window = None
        if with_window:
            _, _, _, starts, log_rows = self._log_window(closed, lo, hi)
            self._log_window_cache = None
            bounds = [starts, c.logs.head]
            rings = []
            for vid in self.compiled.ring_vertices:
                el = c.out_rings[self.compiled.ring_index[vid]]
                # Compacted on the device into a buffer as long as every
                # slot of the epoch (the valid count is on the device):
                # the host only cuts it by the per-step counts.
                slots = (hi - lo) * el.keys.shape[1] * el.keys.shape[2]
                rings.append(_slice_ring_window(el, lo, hi, slots))
                bounds.append(torch.stack(
                    [el.epoch_starts[closed % el.max_epochs], el.head]))
            window = _device.HostCopy({
                "log_rows": log_rows,
                "bounds": torch.cat([b.reshape(-1).to(torch.int32)
                                     for b in bounds]),
                "rings": rings})
        return FenceHandles(closed, health, window, counts, (lo, hi),
                            self.compiled.ring_vertices,
                            executor=self if self.mesh is not None else None)

    def _log_counts(self, closed: int, lo: int, hi: int) -> np.ndarray:
        """Host-known row counts of every log's window of epoch ``closed``
        (supersteps ``[lo, hi)``): the sync blocks plus the async rows
        the host ledger counted."""
        return np.asarray(
            [DETS_PER_STEP * (hi - lo) + self.async_counts.get((f, closed),
                                                               0)
             for f in range(*self.compiled.lblock)], np.int64)

    def _log_window(self, closed: int, lo: int, hi: int) -> tuple:
        """Every log's rows of epoch ``closed``, gathered on the device by
        host-known counts (no read): ``(counts, flat_d, rel_d, starts,
        rows)`` — rows ``[sum(counts), lanes]`` in flat order, row ``j``
        being log ``flat_d[j]``'s ``rel_d[j]``-th row of the epoch. The
        spill hook's gather is reused by capture_fence at the same fence
        (the roll in between moves no row)."""
        cached = self._log_window_cache
        if cached is not None and cached[0] == closed:
            return cached[1]
        counts = self._log_counts(closed, lo, hi)
        logs = self.carry.logs
        dev = self.device
        flat = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        rel = np.concatenate([np.arange(n, dtype=np.int64) for n in counts]
                             or [np.zeros(0, np.int64)])
        flat_d = _device.upload(flat, dev)
        rel_d = _device.upload(rel, dev)
        starts = logs.epoch_starts[:, closed % logs.max_epochs]
        pos = (starts.to(torch.int64)[flat_d] + rel_d) & (logs.capacity - 1)
        win = (counts, flat_d, rel_d, starts, logs.rows[flat_d, pos])
        self._log_window_cache = (closed, win)
        return win

    def install_replay_ledgers(self,
                               roll_gap: Dict[Tuple[int, int], int],
                               async_counts: Dict[Tuple[int, int], int]
                               ) -> None:
        """Merge re-derived roll-gap / async-row ledgers (a standby-host
        bootstrap derives them from mirrored streams). Install before
        anything reads them: recovery's patch reads ``roll_gap_async``."""
        self.roll_gap_async.update(roll_gap)
        self.async_counts.update(async_counts)

    def first_step_inputs(self) -> BlockInputs:
        """Zeroed host-fed inputs of the FIRST-STEP block program's
        shapes — what :func:`utils.compile_cache.aot_lower_first_step`
        dispatches on: ``times`` and ``rng_bits`` ``int32[K]`` with ``K =
        block_steps``, a zero ``epoch`` and ``step0``, and for each feed
        vertex a zero ``[K, P, B]`` batch of the lanes this rank runs,
        the shapes :meth:`_pull_feeds` returns. Nothing is drawn from the
        host RNG or a reader.

        Unlike the reference, which passes ``feeds=()``: here a feed
        vertex given no batch takes ``run_block``'s generator branch (an
        empty batch of its output capacity), not the feed branch the live
        block takes, so the warm would not dispatch the live shapes."""
        k = self.block_steps
        comp = self.compiled
        dev = self.device
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return BlockInputs(
            times=torch.zeros((k,), dtype=torch.int32, device=dev),
            rng_bits=torch.zeros((k,), dtype=torch.int32, device=dev),
            epoch=z, step0=z.clone(),
            feeds=tuple(
                empty((k, comp.vblock[vid][1] - comp.vblock[vid][0],
                       self.job.vertices[vid].operator.batch_size), dev)
                for vid in comp.feed_vertices))

    def fast_forward_host_rng(self, steps: int) -> None:
        """Reset the host RNG to its seeded stream and consume one draw per
        superstep for ``steps`` supersteps: a rebuilt job's next draw is
        then the one a never-failed run would make (replay reads recorded
        draws and never touches this stream)."""
        self._rng = np.random.RandomState(self._seed)
        for _ in range(steps):
            self._rng.randint(0, 2 ** 31, dtype=np.int64)

    def restore(self, carry, epoch_id: int) -> None:
        """Adopt a checkpointed carry (tensors or numpy arrays) at an
        epoch boundary; leaves are copied onto this executor's device."""
        if self.mesh is not None:
            # A whole carry: keep this rank's shards.
            from clonos_tpu_torch.parallel import distributed as dist_
            carry = dist_.shard_tree(carry, self.compiled.placements(),
                                     self.compiled.n_shards,
                                     self.compiled.shard)
        self.carry = tree_map(
            lambda x: torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x).to(self.device).clone(), carry)
        self.compiled.constrain_carry(self.carry)
        self.epoch_id = epoch_id
        self.step_in_epoch = 0
