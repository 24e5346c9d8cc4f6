"""Slot-pool scheduler: one job spanning several worker processes (port
of ``clonos_tpu/runtime/scheduler.py``).

The deployment layer (reference jobmaster/slotpool/SlotPool.java's
offer/allocate path, TaskExecutor.java:422 submitTask,
TaskDeploymentDescriptor, and the JobMaster leader sessions whose
fencing token rides every RPC):

- **Slots** (:class:`SlotPool`): workers advertise slot capacity at
  registration (``slots`` in the REGISTER info, topped up by SLOT_OFFER);
  the JobMaster-side pool tracks which task group occupies which slot.
- **Slicing** (:func:`partition_vertices` + ``JobGraph.subgraph``): the
  job's vertices are cut into contiguous topological slices, one per
  worker, balanced by subtask count, every cut on exchange edges. The
  slice structure is a pure function of ``(vertex_ids, feed_batch)``, so
  the JobMaster and the worker derive identical topologies.
- **Cross-worker edges** (:class:`EdgeExportServer` +
  :class:`RemoteEdgeFeedReader`): at every epoch fence the upstream
  worker gathers each cut edge's fresh ring steps on the card, compacts
  their valid records there in (step, lane, slot) order, and brings
  them to the host in one ``device.HostCopy`` on the driving thread; the
  retained buffer is served over the control transport (FETCH_EDGE /
  EDGE_DATA, byte for byte the reference's frames). The downstream slice
  consumes it through a BLOCKING exact-count reader, so per-step batch
  boundaries never depend on transport timing, and ``read_at``
  re-serves exact absolute ranges for causal replay.
- **Fenced deployment** (:class:`SlotPoolScheduler` +
  :class:`TaskExecutorEndpoint`): the scheduler acts only while holding
  the ``FileLeaderElection`` lease and stamps its fencing epoch on every
  DEPLOY; the worker endpoint rejects a token that is not the highest
  existing claim in the shared lease directory, and any token below the
  highest it ever accepted.
- **Per-task recovery**: on worker death the scheduler redeploys ONLY
  the dead worker's task groups, preferring each group's standby worker
  (rotate-by-one anti-affinity, ``distributed.standby_worker_order``),
  with its mirrored determinant rows in the DEPLOY frame; the surviving
  worker drives ``ClusterRunner.bootstrap_standby`` for that slice while
  every other slice keeps running.

The device is a property of the worker process, never of the wire:
:class:`SliceWorker` builds every runner (and every ``bootstrap_standby``
rebuild) on its own device, and names it in its REGISTER info; the
scheduler keeps its mirrors on its own device. Both default to the card
and raise without one.

The HLC and lineage planes ride the DEPLOY and FETCH_EDGE headers as in
the reference (``attach_hlc`` / ``adopt_hlc``, ``attach_lineage`` /
``adopt_lineage``); with those planes off nothing is attached, so the
headers are the reference's either way.

- **Live re-cut control plane** (:class:`RescaleCoordinator`): the
  fence -> drain -> migrate -> redirect walk that
  ``ClusterRunner.rescale_live`` drives, with guards that raise
  :class:`RescaleProtocolError` on any out-of-order step.

Known limits (as in the reference): a rebuilt slice re-exports only what
its replayed rings retain; slices co-hosted on one worker step
round-robin one epoch at a time, so a co-hosted downstream slice must
stay an epoch of feed demand behind its upstream (the blocking reader
fails loudly on timeout rather than deadlocking).
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import json
import queue
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.api.feeds import RetentionExpiredError, SocketFeedReader
from clonos_tpu_torch.causal import serde
from clonos_tpu_torch.graph.job_graph import JobGraph, PartitionType
from clonos_tpu_torch.obs import get_tracer
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.parallel.distributed import standby_worker_order
from clonos_tpu_torch.runtime import remote as rm
from clonos_tpu_torch.runtime.leader import FileLeaderElection, job_lease_path
from clonos_tpu_torch.utils import metrics as met


class NotLeaderError(RuntimeError):
    """A scheduler action was attempted without holding the lease."""


class RescaleProtocolError(RuntimeError):
    """A live re-cut step was attempted out of protocol order."""


class RescaleCoordinator:
    """Control plane of ONE live re-cut: fence → drain → migrate →
    redirect (the reference's ``verify/models.py`` ``RepartitionModel``
    is the checked abstraction of this object; its observation stream
    is the reference coordinator's, call for call).

    The JobMaster-side driver (``ClusterRunner.rescale_live``) walks it
    through the protocol while doing the data-plane work beside each
    step:

    - :meth:`fence` — a COMPLETED checkpoint fence is the cut point;
      the old incarnation stops admitting records.
    - :meth:`drain` — the old incarnation hands group ``g``'s buffered
      in-flight edge records into the migration payload (in the real
      re-cut they ride the checkpoint's edge buffers through
      ``route_hash_block``; "drained" here means *accounted for*, the
      opposite of dying with the old incarnation).
    - :meth:`migrate` — group ``g``'s keyed state moves to the N±k
      incarnation. Guarded on an empty in-flight count: migrating over
      a non-empty buffer is the ``migrate-skips-drain`` record-loss
      bug the model proves bites.
    - :meth:`redirect` — traffic cuts over. Guarded on every group
      having migrated (``redirect-before-migrate`` restarts unmigrated
      groups empty).

    Guards raise :class:`RescaleProtocolError`: the implementation
    refuses the model's seeded bugs. ``transition_observers``
    (``fn(kind, **fields)``) emit the observation stream."""

    PHASES = ("PRE", "FENCED", "REDIRECTED")

    def __init__(self, num_groups: int):
        if int(num_groups) < 1:
            raise ValueError("RescaleCoordinator needs >= 1 group")
        self.num_groups = int(num_groups)
        self.phase = "PRE"
        self.inflight = [0] * self.num_groups
        self.migrated = [False] * self.num_groups
        self.fence_checkpoint: Optional[int] = None
        #: transition observers: ``fn(kind, **fields)`` on every
        #: protocol step
        self.transition_observers: List = []

    def _observe(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

    def _check_group(self, group: int) -> int:
        group = int(group)
        if not 0 <= group < self.num_groups:
            raise ValueError(f"group {group} out of range "
                             f"[0, {self.num_groups})")
        return group

    def note_inflight(self, group: int, n: int = 1) -> None:
        """Pre-fence bookkeeping: ``n`` records entered (``n > 0``) or
        left (``n < 0``) group ``group``'s in-flight edge buffers. Not
        a protocol transition — nothing is observed."""
        group = self._check_group(group)
        if self.phase == "REDIRECTED":
            raise RescaleProtocolError(
                "note_inflight after redirect — the old incarnation "
                "no longer owns any group")
        if self.inflight[group] + n < 0:
            raise RescaleProtocolError(
                f"group {group} in-flight count would go negative "
                f"({self.inflight[group]} {n:+d})")
        self.inflight[group] += int(n)

    def fence(self, checkpoint_id: int) -> None:
        """A completed checkpoint fence: the cut point. PRE → FENCED."""
        if self.phase != "PRE":
            raise RescaleProtocolError(
                f"fence in phase {self.phase} — one re-cut per "
                f"coordinator")
        self.phase = "FENCED"
        self.fence_checkpoint = int(checkpoint_id)
        self._observe("fence", checkpoint_id=self.fence_checkpoint)

    def drain(self, group: int, n: int = 1) -> None:
        """``n`` buffered records of ``group`` handed into the
        migration payload."""
        group = self._check_group(group)
        if self.phase != "FENCED":
            raise RescaleProtocolError(
                f"drain({group}) in phase {self.phase} — draining is "
                f"only legal between fence and redirect")
        if self.migrated[group]:
            raise RescaleProtocolError(
                f"drain({group}) after the group migrated — the old "
                f"incarnation no longer owns it (stale writer)")
        if self.inflight[group] < n:
            raise RescaleProtocolError(
                f"drain({group}, {n}) exceeds the {self.inflight[group]} "
                f"record(s) in flight")
        self.inflight[group] -= int(n)
        self._observe("drain", group=group, n=int(n))

    def migrate(self, group: int) -> None:
        """Group ``group``'s keyed state moves to the new incarnation."""
        group = self._check_group(group)
        if self.phase != "FENCED":
            raise RescaleProtocolError(
                f"migrate({group}) in phase {self.phase}")
        if self.migrated[group]:
            raise RescaleProtocolError(f"group {group} already migrated")
        if self.inflight[group] != 0:
            raise RescaleProtocolError(
                f"migrate({group}) with {self.inflight[group]} in-flight "
                f"record(s) undrained — they would die with the old "
                f"incarnation at redirect (records lost)")
        self.migrated[group] = True
        self._observe("migrate", group=group)

    def redirect(self) -> None:
        """Traffic cuts over to the new incarnation. FENCED →
        REDIRECTED; the old incarnation is fenced off."""
        if self.phase != "FENCED":
            raise RescaleProtocolError(
                f"redirect in phase {self.phase}")
        missing = [g for g in range(self.num_groups)
                   if not self.migrated[g]]
        if missing:
            raise RescaleProtocolError(
                f"redirect with group(s) {missing} unmigrated — they "
                f"would restart empty on the new incarnation")
        self.phase = "REDIRECTED"
        self._observe("redirect")


def _load_job(spec: str) -> JobGraph:
    """'module.path:function' -> JobGraph (the CLI's job-spec form; the
    JobMaster and every worker resolve the same spec)."""
    mod_name, _, fn_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    job = getattr(mod, fn_name or "build_job")()
    if not isinstance(job, JobGraph):
        raise TypeError(f"{spec} returned {type(job).__name__}, "
                        f"not JobGraph")
    return job


# --- placement ---------------------------------------------------------------


def partition_vertices(job: JobGraph, k: int) -> List[List[int]]:
    """Cut the topological order into ``k`` contiguous, non-empty slices
    balanced by subtask count, with every cut landing where ALL crossing
    edges are exchange edges (the wire-export constraint of
    ``JobGraph.subgraph``). Deterministic for a given job."""
    order = job.topo_order()
    n = len(order)
    if not 1 <= k <= n:
        raise ValueError(f"partition_vertices: cannot cut {n} vertices "
                         f"into {k} slices")
    pos = {vid: i for i, vid in enumerate(order)}
    valid = [i for i in range(1, n)
             if all(e.partition != PartitionType.FORWARD
                    for e in job.edges if pos[e.src] < i <= pos[e.dst])]
    if len(valid) < k - 1:
        raise ValueError(
            f"partition_vertices: only {len(valid)} exchange-edge cut "
            f"points for {k} slices — fewer workers or more exchanges")
    weights = [job.vertices[vid].parallelism for vid in order]
    total = sum(weights)
    prefix = np.cumsum([0] + weights)          # prefix[i] = subtasks before i
    cuts: List[int] = []
    for j in range(1, k):
        target = total * j / k
        # Closest valid cut to the balance target, strictly after the
        # previous cut and leaving enough cut points for the slices left.
        lo = cuts[-1] if cuts else 0
        cands = [i for i in valid if i > lo]
        cands = cands[: len(cands) - (k - 1 - j)]
        if not cands:
            raise ValueError("partition_vertices: cut points exhausted")
        cuts.append(min(cands, key=lambda i: (abs(prefix[i] - target), i)))
    bounds = [0] + cuts + [n]
    return [order[bounds[i]: bounds[i + 1]] for i in range(k)]


def cut_edges(job: JobGraph, part: Sequence[int]
              ) -> Tuple[List[int], List[int]]:
    """(in-cut, out-cut) original edge indices for a vertex slice."""
    keep = set(part)
    ins = [i for i, e in enumerate(job.edges)
           if e.dst in keep and e.src not in keep]
    outs = [i for i, e in enumerate(job.edges)
            if e.src in keep and e.dst not in keep]
    return ins, outs


@dataclasses.dataclass
class TaskSlot:
    """One deployment slot on a worker (SlotPool's allocation unit).

    ``group`` is the occupying task-group key: a bare int in single-job
    mode, a ``(job_id, group)`` tuple when many jobs share the pool
    (``runtime/dispatcher.py``) — the pool needs it only hashable and
    orderable within one deployment."""

    worker_id: str
    index: int
    group: Optional[object] = None     # occupying task group, or free


class SlotPool:
    """JobMaster-side ledger of advertised slots and their occupants
    (reference SlotPool.java: offers come in from TaskExecutors, the
    scheduler allocates against them, a dead worker releases its slots
    and strands its groups for redeployment). One pool may be shared by
    many jobs' schedulers; group keys are then job-scoped tuples."""

    def __init__(self):
        self._slots: Dict[str, List[TaskSlot]] = {}

    def sync_offers(self, offers: Dict[str, int]) -> None:
        """Absorb the JobMasterServer's current slot advertisements
        (idempotent; capacity only grows — a shrinking advertisement
        never yanks a slot out from under a running task)."""
        for wid, cap in offers.items():
            cur = self._slots.setdefault(wid, [])
            while len(cur) < cap:
                cur.append(TaskSlot(wid, len(cur)))

    def workers(self) -> List[str]:
        return sorted(w for w, ss in self._slots.items() if ss)

    def free_slots(self, avoid: Sequence[str] = ()) -> List[TaskSlot]:
        return [s for w in self.workers() if w not in set(avoid)
                for s in self._slots[w] if s.group is None]

    def allocate(self, group, prefer: Optional[str] = None,
                 avoid: Sequence[str] = ()) -> TaskSlot:
        free = self.free_slots(avoid)
        if prefer is not None:
            preferred = [s for s in free if s.worker_id == prefer]
            free = preferred or free
        if not free:
            raise RuntimeError(
                f"SlotPool: no free slot for group {group} "
                f"(avoid={sorted(set(avoid))})")
        slot = free[0]
        slot.group = group
        return slot

    def release_group(self, group) -> None:
        for ss in self._slots.values():
            for s in ss:
                if s.group == group:
                    s.group = None

    def drop_worker(self, worker_id: str) -> List[object]:
        """Worker died: forget its slots; returns the task groups that
        were running there (the redeployment work list)."""
        lost = self._slots.pop(worker_id, [])
        return sorted(s.group for s in lost if s.group is not None)

    def placements(self) -> Dict[object, str]:
        return {s.group: w for w, ss in self._slots.items()
                for s in ss if s.group is not None}


# --- cross-worker edges ------------------------------------------------------


def _compact_ring_steps(el, lo: int, n: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring steps ``[lo, lo + n)`` (host-known, all retained) as their
    valid records, on the ring's device: ``(count, rows [N, 2])`` where
    the first ``count`` rows are (key, value) in (step, lane, slot)
    order and ``N`` is every slot of the window. Ranks come from a
    prefix sum and invalid slots scatter to a spill row, so nothing here
    reads the device."""
    dev = el.keys.device
    steps = torch.arange(lo, lo + n, dtype=torch.int64, device=dev)
    pos = steps & (el.ring_steps - 1)
    keys = el.keys[pos].reshape(-1)
    vals = el.values[pos].reshape(-1)
    valid = el.valid[pos].reshape(-1)
    total = valid.numel()
    rank = torch.cumsum(valid, 0, dtype=torch.int64) - 1
    dest = torch.where(valid, rank, torch.full_like(rank, total))
    rows = torch.zeros((total + 1, 2), dtype=torch.int32, device=dev)
    rows[dest] = torch.stack([keys, vals], dim=1)
    return valid.sum(dtype=torch.int64), rows[:total]


class EdgeExportServer:
    """Serves a slice's cut out-edges to downstream workers.

    At every epoch fence the driving thread calls :meth:`publish`: each
    cut edge's producer ring's fresh steps are compacted on the ring's
    device and appended, in (step, lane, slot) order, to a retained
    per-edge buffer. Remote readers fetch ``[start, start+n)`` windows by
    ABSOLUTE record offset (FETCH_EDGE), so the stream is rewindable for
    causal replay; retention is unbounded (the ``floor`` field in
    EDGE_DATA reserves the trim protocol). The wire analog of handing the
    in-flight log across hosts (reference InFlightLogRequestEvent),
    lifted to record streams so the consumer can be a HostFeedSource
    boundary."""

    def __init__(self, runner, exports: Dict[int, int],
                 host: str = "127.0.0.1", port: int = 0):
        self.runner = runner
        self._srcs = {int(e): int(vid) for e, vid in exports.items()}
        self._recs: Dict[int, np.ndarray] = {
            e: np.zeros((0, 2), np.int32) for e in self._srcs}
        self._published: Dict[int, Optional[int]] = {
            e: None for e in self._srcs}
        self._final = False
        self._lock = threading.Lock()
        #: publishes that moved records (one ``HostCopy`` wait each) and
        #: their wall time, for the worker's status lines
        self.publishes = 0
        self.publish_s = 0.0
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address
        # Publish inside run_epoch's fence window: checkpoint completion
        # truncates the producer rings at the fence, so reading their
        # fresh steps AFTER run_epoch returns would already be too late.
        runner.fence_hooks.append(lambda _closed: self.publish())

    def publish(self) -> None:
        """Fence hook (driving thread): absorb each producer ring's fresh
        steps into the retained record buffers. Ring bounds are the
        host's own (heads count supersteps, the tail moves only at the
        truncation the host orders); the compacted records of every edge
        come to the host in one copy."""
        t0 = time.monotonic()
        ex = self.runner.executor
        head, tail = int(ex._steps_executed), int(ex._ring_tail)
        pending = []
        for eidx, vid in self._srcs.items():
            el = ex.carry.out_rings[ex.compiled.ring_index[vid]]
            lo = self._published[eidx]
            if lo is None:
                # First publish: a fresh runner's ring starts at 0; a
                # REBUILT runner's ring starts at its recovery fence (it
                # re-exports only what replay retained).
                lo = tail
            if lo < tail:
                raise RuntimeError(
                    f"edge export {eidx}: ring truncated past the last "
                    f"published step ({lo} < tail {tail}) — publish at "
                    f"every fence")
            if head <= lo:
                continue
            pending.append((eidx, _compact_ring_steps(el, lo, head - lo)))
        if not pending:
            return
        got = _device.HostCopy([p[1] for p in pending]).wait()
        for (eidx, _), (count, rows) in zip(pending, got):
            recs = np.ascontiguousarray(rows[:int(count)], np.int32)
            with self._lock:
                if recs.shape[0]:
                    self._recs[eidx] = np.concatenate(
                        [self._recs[eidx], recs])
                self._published[eidx] = head
        self.publishes += 1
        self.publish_s += time.monotonic() - t0

    def exported(self) -> Dict[int, int]:
        """Records retained so far per exported edge."""
        with self._lock:
            return {e: int(a.shape[0]) for e, a in self._recs.items()}

    def mark_final(self) -> None:
        """The producing slice finished its run: readers blocked past the
        end of the stream fail loudly instead of waiting forever."""
        with self._lock:
            self._final = True

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype != tp.FETCH_EDGE:
            return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})
        req = tp.unpack_json(payload)
        tp.adopt_trace(req)
        tp.adopt_hlc(req, verb="FETCH_EDGE")
        eidx, start, count = (int(req["edge"]), int(req["start"]),
                              int(req["count"]))
        with self._lock:
            if eidx not in self._recs:
                return tp.ERROR, tp.pack_json(
                    {"error": f"edge {eidx} is not exported here "
                              f"(have {sorted(self._recs)})"})
            arr = self._recs[eidx]
            final = self._final
        avail = arr.shape[0]
        lo, hi = min(start, avail), min(start + count, avail)
        rows = np.ascontiguousarray(arr[lo:hi])
        tr = get_tracer()
        if tr.enabled and hi > lo:
            # only non-empty serves — blocked readers poll this endpoint
            tr.event("edge.serve", edge=eidx, start=lo, count=hi - lo)
        hdr = tp.pack_json({"edge": eidx, "start": lo,
                            "count": int(hi - lo), "avail": avail,
                            "floor": 0, "final": final})
        return tp.EDGE_DATA, (len(hdr).to_bytes(4, "little") + hdr
                              + rows.tobytes())

    def close(self) -> None:
        self.server.close()


class RemoteEdgeFeedReader:
    """Rewindable feed over a remote :class:`EdgeExportServer` — the
    downstream side of a cut edge (the ``api/feeds.py`` contract).

    Live pulls BLOCK until the full requested count is available:
    deterministic per-step batch boundaries are what make a spanned
    job's digests reproducible across runs (and are exactly what the
    BUFFER_BUILT determinants pin for replay). ``read_at`` re-fetches
    exact absolute ranges during causal replay. A stream the upstream
    marked final, or a wait past ``timeout_s``, raises instead of
    hanging. Pulls run on the driving thread, inside ``run_block``'s feed
    pull; the reader itself touches host data only."""

    def __init__(self, address: Tuple[str, int], edge: int,
                 num_subtasks: int = 1, poll_s: float = 0.02,
                 timeout_s: float = 180.0):
        if num_subtasks != 1:
            raise ValueError(
                "RemoteEdgeFeedReader serves one flattened stream; the "
                "boundary HostFeedSource runs at parallelism 1")
        self._address = tuple(address)
        self._edge = int(edge)
        self._client = tp.ControlClient(self._address)
        self._cursor = [0]
        self._poll = poll_s
        self._timeout = timeout_s
        #: seconds spent waiting for records not yet exported (the
        #: blocked-read time of the worker's status lines)
        self.blocked_s = 0.0
        # Pulls run on the worker main thread; checkpoint-complete
        # notifications may arrive from a coordinator writer thread.
        self._lock = threading.RLock()

    def _fetch_exact(self, start: int, n: int) -> np.ndarray:
        """Blocking fetch of records [start, start+n) as [n, 2] int32."""
        if n == 0:
            return np.zeros((0, 2), np.int32)
        t0 = time.monotonic()
        deadline = t0 + self._timeout
        waited = False
        while True:
            with self._lock:
                rt, resp = self._client.call(
                    tp.FETCH_EDGE,
                    tp.pack_json(tp.attach_hlc(tp.attach_trace(
                        {"edge": self._edge, "start": start,
                         "count": n}), verb="FETCH_EDGE")))
            if rt == tp.ERROR:
                raise RuntimeError(tp.unpack_json(resp)["error"])
            hlen = int.from_bytes(resp[:4], "little")
            hdr = tp.unpack_json(resp[4: 4 + hlen])
            if int(hdr["floor"]) > start:
                raise RetentionExpiredError(
                    f"edge {self._edge}: offset {start} below upstream "
                    f"retention floor {hdr['floor']}")
            if int(hdr["count"]) == n:
                if waited:
                    self.blocked_s += time.monotonic() - t0
                rows = np.frombuffer(resp[4 + hlen:], np.int32)
                return rows.reshape(n, 2)
            if hdr.get("final") and int(hdr["avail"]) < start + n:
                raise RuntimeError(
                    f"edge {self._edge}: upstream finished with "
                    f"{hdr['avail']} records; cannot serve "
                    f"[{start}, {start + n})")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"edge {self._edge}: waited {self._timeout}s for "
                    f"records [{start}, {start + n}) "
                    f"(upstream at {hdr['avail']}) — upstream stalled "
                    f"or co-hosted slice ordering starves this feed")
            waited = True
            time.sleep(self._poll)

    def seek(self, subtask: int, offset: int) -> None:
        """Reposition the live cursor (after a bootstrap replay, the
        cursor resumes at the recovered HostFeedSource offset)."""
        self._cursor[subtask] = int(offset)

    def rewire(self, address: Tuple[str, int]) -> None:
        """Point at a redeployed upstream's export endpoint."""
        with self._lock:
            self._client.close()
            self._address = tuple(address)
            self._client = tp.ControlClient(self._address)

    # --- FeedReader contract -------------------------------------------------

    def pull(self, subtask: int, max_n: int):
        rows = self._fetch_exact(self._cursor[subtask], max_n)
        self._cursor[subtask] += max_n
        return rows[:, 0].tolist(), rows[:, 1].tolist()

    def pull_block(self, subtask: int, batch: int, k: int):
        flat = self._fetch_exact(self._cursor[subtask], k * batch)
        self._cursor[subtask] += k * batch
        blk = flat.reshape(k, batch, 2)
        return (np.ascontiguousarray(blk[:, :, 0]),
                np.ascontiguousarray(blk[:, :, 1]),
                np.full((k,), batch, np.int32))

    def read_at(self, subtask: int, offset: int, n: int):
        rows = self._fetch_exact(int(offset), int(n))
        return rows[:, 0].tolist(), rows[:, 1].tolist()

    def notify_checkpoint_complete(self, offsets: Sequence[int]) -> None:
        """No-op: upstream retention is unbounded for now (the EDGE_DATA
        ``floor`` field reserves the trim protocol)."""

    def close(self) -> None:
        self._client.close()


# --- worker side -------------------------------------------------------------


class TaskExecutorEndpoint:
    """Worker-side deployment gateway (TaskExecutorGateway.submitTask).

    Every DEPLOY carries the JobMaster's fencing token; it is checked
    against (a) the shared lease directory — the token must be the
    highest EXISTING claim (``FileLeaderElection.fencing_valid``) — and
    (b) the highest token this worker has ever accepted for that job,
    which stays monotone even while the lease directory is briefly
    unreadable. A deposed JobMaster's late orders are rejected at this
    door, before any runner state is touched. Accepted descriptors are
    queued; the driving loop builds them (all CUDA work stays on the
    thread that drives the runners)."""

    def __init__(self, lease_path: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.queue: "queue.Queue[dict]" = queue.Queue()
        self._lease_path = lease_path
        # Highest accepted token PER JOB: every job runs its own
        # election (leader.job_lease_path), so epoch sequences are
        # independent. "" is the single-job cluster.
        self._highest: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: transition observers: ``fn(kind, **fields)`` on every fencing
        #: decision (accept / reject-stale / reject-invalid)
        self.transition_observers: List = []
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address

    def _observe(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

    def _check_fencing(self, epoch, job_id: str = "") -> None:
        if epoch is None:
            self._observe("fence-reject", job_id=job_id, epoch=None,
                          why="missing")
            raise PermissionError("DEPLOY carries no fencing token")
        epoch = int(epoch)
        with self._lock:
            if epoch < self._highest.get(job_id, -1):
                self._observe("fence-reject", job_id=job_id,
                              epoch=epoch, why="stale")
                raise PermissionError(
                    f"stale fencing token {epoch} < highest accepted "
                    f"{self._highest[job_id]} (deposed JobMaster)")
        if self._lease_path is not None:
            observer = FileLeaderElection(
                job_lease_path(self._lease_path, job_id), "observer")
            if not observer.fencing_valid(epoch):
                self._observe("fence-reject", job_id=job_id,
                              epoch=epoch, why="not-current-claim")
                raise PermissionError(
                    f"fencing token {epoch} is not the current lease "
                    f"claim — deposed or forged JobMaster identity")
        with self._lock:
            self._highest[job_id] = max(self._highest.get(job_id, -1),
                                        epoch)
        self._observe("fence-accept", job_id=job_id, epoch=epoch)

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype != tp.DEPLOY:
            return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})
        hlen = int.from_bytes(payload[:4], "little")
        tdd = tp.unpack_json(payload[4: 4 + hlen])
        try:
            self._check_fencing(tdd.get("fencing_epoch"),
                                str(tdd.get("job_id") or ""))
        except PermissionError as e:
            return tp.ERROR, tp.pack_json({"error": str(e)})
        frame = payload[4 + hlen:]
        if frame:
            tdd["_mirror_rows"] = {
                flat: (np.asarray(rows, np.int32), start)
                for flat, start, rows in serde.decode_delta(frame)}
        self.queue.put(tdd)
        return tp.OK, tp.pack_json({"accepted": True,
                                    "group": tdd.get("group")})

    def close(self) -> None:
        self.server.close()


@dataclasses.dataclass
class _DeployedSlice:
    group: int
    runner: object
    log_ep: rm.HostLogEndpoint
    export: Optional[EdgeExportServer]
    readers: Dict[int, object]
    target_epochs: int
    complete_every: int
    attempt: int
    finished: bool = False
    job_id: str = ""                   # "" = single-job cluster
    #: the deploying JobMaster's trace context — re-adopted before every
    #: epoch so co-hosted slices of DIFFERENT jobs each span under their
    #: own job's trace id
    trace_ctx: Optional[dict] = None


class SliceWorker:
    """TaskExecutor-process driver: advertise slots, accept fenced
    DEPLOYs, and run every deployed slice's epochs round-robin on the
    driving thread — publishing its edge exports and refreshing its
    determinant-log endpoint at every fence, reporting TASK_STATE
    transitions, and emitting one JSON status line per (group, epoch) on
    stdout (digest BEFORE the endpoint refresh, so a mirror never holds
    a fence whose digest was not reported).

    Every slice runs on ``device`` (default the card; raises without
    one), which the REGISTER info names. A slice with an edge export adds
    ``publish_ms`` and ``publishes`` (cumulative) to its epoch lines; one
    fed by a cut edge adds ``blocked_ms``, the reader's cumulative wait
    for records not yet exported."""

    def __init__(self, executor_id: str, jm_address: Tuple[str, int],
                 lease_path: Optional[str] = None, slots: int = 1,
                 bind_host: str = "127.0.0.1",
                 heartbeat_interval: float = 0.5, emit=None,
                 chaos_step_delay_s: float = 0.0, device="cuda"):
        self.executor_id = executor_id
        self.bind_host = bind_host
        self.device = _device.resolve(device)
        #: gray-failure injection (``slotworker --chaos-step-delay``):
        #: every epoch round sleeps this long FIRST, so the worker is
        #: degraded — late fences — but never dead: heartbeats flow.
        self.chaos_step_delay_s = float(chaos_step_delay_s)
        self.endpoint = TaskExecutorEndpoint(lease_path, bind_host)
        self._jm = tp.ControlClient(tuple(jm_address))
        # Heartbeats piggyback the worker's last metric snapshot. The
        # cache is refreshed on the driving thread — snapshot() evaluates
        # gauges that read device state — and the heartbeat thread only
        # ships the cached host dict.
        self._metrics_cache: Dict[str, object] = {}
        self._metrics_lock = threading.Lock()
        self.tx = rm.TaskExecutorClient(
            executor_id, jm_address, interval_s=heartbeat_interval,
            info={"slots": slots, "deploy_host": bind_host,
                  "deploy_port": self.endpoint.address[1],
                  "device": str(self.device)},
            payload_fn=self._hb_payload)
        #: deployed slices keyed (job_id, group) — one worker may host
        #: slices of many concurrent jobs (the multi-tenant pool)
        self.slices: Dict[Tuple[str, int], _DeployedSlice] = {}
        #: recovery rebuilds deferred behind healthy epochs (fence
        #: priority — see :meth:`step`)
        self._recovery_backlog: Deque[dict] = collections.deque()
        self._emit = emit or (lambda obj: print(json.dumps(obj),
                                                flush=True))

    def _hb_payload(self) -> dict:
        with self._metrics_lock:
            cache = self._metrics_cache
        return {"metrics": cache} if cache else {}

    def _refresh_metrics(self) -> None:
        """Driving-thread snapshot of every slice's registry (replaces
        the cache wholesale; the heartbeat thread only reads the old
        ref). Job-scoped slices prefix ``job.<jid>.`` so the JobMaster
        can roll metrics up per tenant (``cluster_metrics``)."""
        snap: Dict[str, object] = {}
        for (jid, group), sl in self.slices.items():
            prefix = (f"job.{jid}.group.{group}." if jid
                      else f"group.{group}.")
            for k, v in sl.runner.metrics.snapshot().items():
                snap[prefix + k] = v
        with self._metrics_lock:
            self._metrics_cache = snap

    def _task_state(self, group: int, state: str, job_id: str = "",
                    **extra) -> None:
        msg = {"executor_id": self.executor_id, "group": group,
               "state": state, **extra}
        if job_id:
            msg["job_id"] = job_id
        try:
            self._jm.call_json(tp.TASK_STATE, msg)
        except (OSError, RuntimeError):
            pass        # JM unreachable; its heartbeat deadline arbitrates

    def _make_reader(self, spec: dict):
        kind = spec.get("kind")
        if kind == "edge":
            return RemoteEdgeFeedReader(
                (spec["host"], int(spec["port"])), edge=int(spec["edge"]),
                timeout_s=float(spec.get("timeout_s", 180.0)))
        if kind == "socket":
            return SocketFeedReader(
                spec["host"], int(spec["port"]),
                num_subtasks=int(spec.get("num_subtasks", 1)),
                retention=spec.get("retention"))
        raise ValueError(f"unknown feed kind {kind!r}")

    def build(self, tdd: dict) -> _DeployedSlice:
        """Materialize one deployment descriptor into a running slice on
        this worker's device (a fresh runner, or a ``bootstrap_standby``
        causal rebuild when the descriptor ships mirror rows)."""
        from clonos_tpu_torch.runtime.cluster import ClusterRunner
        group = int(tdd["group"])
        jid = str(tdd.get("job_id") or "")
        attempt = int(tdd.get("attempt", 0))
        # Join the deploying JobMaster's trace, audit, profiling and
        # lineage stances (each job's JobMaster runs its own tracer; the
        # context is kept on the slice and re-adopted before every
        # epoch), and fold its HLC stamp into this process's clock.
        tp.adopt_trace(tdd)
        tp.adopt_audit(tdd)
        tp.adopt_profile(tdd)
        tp.adopt_lineage(tdd)
        tp.adopt_hlc(tdd, verb="DEPLOY")
        tr = get_tracer()
        self._task_state(group, "DEPLOYING", job_id=jid, attempt=attempt)
        job = _load_job(tdd["job"])
        sub, vmap, feeds, exports = job.subgraph(
            [int(v) for v in tdd["vertices"]],
            feed_batch_size=int(tdd.get("feed_batch", 8)))
        readers: Dict[int, object] = {}
        for eidx_s, spec in (tdd.get("feeds") or {}).items():
            readers[feeds[int(eidx_s)]] = self._make_reader(spec)
        for vid_s, spec in (tdd.get("external_feeds") or {}).items():
            readers[vmap[int(vid_s)]] = self._make_reader(spec)
        # The device is this process's, never the descriptor's.
        kw = dict(tdd.get("runner_kw") or {}, device=self.device)
        recovered = bool(tdd.get("recover"))
        span_kw = {"job": jid} if jid else {}
        if recovered:
            with tr.span("recovery.rebuild", group=group,
                         attempt=attempt, **span_kw):
                runner, _report = ClusterRunner.bootstrap_standby(
                    sub, tdd["checkpoint_dir"],
                    tdd.get("_mirror_rows") or {},
                    ignored_checkpoints=tdd.get("ignored") or (),
                    feed_readers=readers, **kw)
            # Live pulls resume at the replayed feed offsets.
            for nvid, r in readers.items():
                if hasattr(r, "seek"):
                    off = np.asarray(
                        runner.executor.vertex_state(nvid)["offset"])
                    for s in range(off.shape[0]):
                        r.seek(s, int(off[s]))
        else:
            runner = ClusterRunner(sub, checkpoint_dir=tdd["checkpoint_dir"],
                                   **kw)
            for nvid, r in readers.items():
                runner.executor.register_feed(nvid, r)
        export = (EdgeExportServer(runner, exports, host=self.bind_host)
                  if exports else None)
        if export is not None:
            export.publish()
        log_ep = rm.HostLogEndpoint(runner.executor, host=self.bind_host)
        sl = _DeployedSlice(
            group=group, runner=runner, log_ep=log_ep, export=export,
            readers=readers,
            target_epochs=int(tdd.get("target_epochs", 8)),
            complete_every=int(tdd.get("complete_every", 1)),
            attempt=attempt, job_id=jid, trace_ctx=tdd.get("trace"))
        self.slices[(jid, group)] = sl
        if recovered:
            tr.event("recovery.caught_up", group=group, attempt=attempt,
                     epoch=runner.executor.epoch_id,
                     global_step=runner.global_step, **span_kw)
        self._task_state(
            group, "RUNNING", job_id=jid, attempt=attempt,
            log_port=log_ep.address[1],
            export_ports={str(e): export.address[1] for e in exports}
            if export else {},
            num_subtasks=sub.total_subtasks(), recovered=recovered)
        status = {"deployed": group, "attempt": attempt,
                  "vertices": [int(v) for v in tdd["vertices"]],
                  "recovered": recovered,
                  "epoch": runner.executor.epoch_id,
                  "global_step": runner.global_step,
                  "digest": runner.state_digest()}
        if jid:
            status["job"] = jid
        self._emit(status)
        return sl

    @staticmethod
    def _edge_stats(sl: _DeployedSlice) -> dict:
        out: dict = {}
        if sl.export is not None:
            out["publish_ms"] = sl.export.publish_s * 1e3
            out["publishes"] = sl.export.publishes
        blocked = [r.blocked_s for r in sl.readers.values()
                   if isinstance(r, RemoteEdgeFeedReader)]
        if blocked:
            out["blocked_ms"] = sum(blocked) * 1e3
        return out

    def step(self) -> bool:
        """Drain pending deployments, run one epoch of every due slice,
        then build AT MOST ONE recovery rebuild. Returns whether anything
        progressed.

        Ordering is the worker-side tenant-isolation mechanism: fresh
        deployments build immediately, but recovery rebuilds (causal
        replay, the expensive part of another tenant's failure storm) are
        deferred to a backlog and admitted one per round, AFTER every
        healthy slice has run its epoch. Between any two rebuilds every
        co-hosted healthy tenant therefore reaches its next checkpoint
        fence."""
        progressed = False
        while True:
            try:
                tdd = self.endpoint.queue.get_nowait()
            except queue.Empty:
                break
            if tdd.get("recover"):
                self._recovery_backlog.append(tdd)
            else:
                self.build(tdd)
            progressed = True
        tr = get_tracer()
        for key in sorted(self.slices):
            sl = self.slices[key]
            group = sl.group
            if tr.enabled and sl.trace_ctx:
                # Each slice's spans land under its OWN job's trace id.
                tr.adopt(sl.trace_ctx)
            if sl.runner.executor.epoch_id >= sl.target_epochs:
                if not sl.finished:
                    sl.finished = True
                    if sl.export is not None:
                        sl.export.mark_final()
                    self._task_state(group, "FINISHED", job_id=sl.job_id,
                                     attempt=sl.attempt)
                    status = {"finished": group,
                              "epoch": sl.runner.executor.epoch_id,
                              "global_step": sl.runner.global_step,
                              "digest": sl.runner.state_digest()}
                    if sl.job_id:
                        status["job"] = sl.job_id
                    self._emit(status)
                continue
            closed = sl.runner.executor.epoch_id
            if self.chaos_step_delay_s:
                time.sleep(self.chaos_step_delay_s)
            sl.runner.run_epoch(
                complete_checkpoint=(closed % sl.complete_every == 0))
            # Status BEFORE the refresh (see class docstring).
            status = {"group": group,
                      "epoch": sl.runner.executor.epoch_id,
                      "global_step": sl.runner.global_step,
                      "digest": sl.runner.state_digest()}
            if sl.job_id:
                status["job"] = sl.job_id
            status.update(self._edge_stats(sl))
            self._emit(status)
            sl.log_ep.refresh()
            progressed = True
        if self._recovery_backlog:
            self.build(self._recovery_backlog.popleft())
            progressed = True
        if progressed:
            self._refresh_metrics()
        return progressed

    def run(self, max_seconds: float = 600.0, idle_sleep: float = 0.05,
            epoch_sleep: float = 0.0) -> None:
        """Serve until killed (or the wall guard lapses): finished slices
        keep their exports and log endpoints up — downstream workers and
        JobMaster mirrors still read them."""
        deadline = time.monotonic() + max_seconds
        while time.monotonic() < deadline:
            if self.step():
                if epoch_sleep:
                    time.sleep(epoch_sleep)
            else:
                time.sleep(idle_sleep)

    def close(self) -> None:
        self.tx.close()
        self._jm.close()
        self.endpoint.close()
        for sl in self.slices.values():
            sl.log_ep.close()
            if sl.export is not None:
                sl.export.close()


# --- JobMaster side ----------------------------------------------------------


class SlotPoolScheduler:
    """JobMaster-side deployment driver: partition the job over the
    registered workers' slots, deploy each slice with standby
    anti-affinity, mirror every slice's determinant logs, and on worker
    death redeploy ONLY the lost task groups (with their mirrored rows
    in the DEPLOY frame) onto surviving slots. Owns the
    :class:`FileLeaderElection` lease — every action requires a live
    renewal, and every outbound DEPLOY is stamped with the current
    fencing epoch. The mirrors' logs live on ``device`` (default the
    card; raises without one)."""

    def __init__(self, jm: rm.JobMasterServer,
                 election: FileLeaderElection, job_spec: str,
                 runner_kw: Optional[dict] = None, feed_batch: int = 8,
                 target_epochs: int = 8, complete_every: int = 1,
                 checkpoint_root: str = "/tmp/clonos-scheduler",
                 mirror_capacity: int = 1 << 14,
                 mirror_max_epochs: int = 64,
                 deploy_timeout_s: float = 240.0,
                 job_id: str = "", tenant: str = "",
                 pool: Optional[SlotPool] = None, tracer=None,
                 device="cuda"):
        self.device = _device.resolve(device)
        self.jm = jm
        self.election = election
        self.job_spec = job_spec
        self.job = _load_job(job_spec)
        self.runner_kw = dict(runner_kw or {})
        self.feed_batch = feed_batch
        self.target_epochs = target_epochs
        self.complete_every = complete_every
        self.checkpoint_root = checkpoint_root
        self.mirror_capacity = mirror_capacity
        self.mirror_max_epochs = mirror_max_epochs
        self.deploy_timeout_s = deploy_timeout_s
        #: multi-tenant identity (``runtime/dispatcher.py``): a non-empty
        #: job_id namespaces slot keys, DEPLOY headers, task_state
        #: lookups and standby bookkeeping so many schedulers share one
        #: pool. "" is the one-job-per-cluster mode.
        self.job_id = str(job_id)
        self.tenant = str(tenant)
        #: a dispatcher passes its SHARED pool; a standalone scheduler
        #: owns a private one and syncs offers itself on deploy()
        self.pool = SlotPool() if pool is None else pool
        self._owns_pool = pool is None
        #: per-job tracer injected by the dispatcher; None = the process
        #: tracer
        self._tracer = tracer
        self.parts: List[List[int]] = []
        self.placements: Dict[int, str] = {}
        self.standby: Dict[int, str] = {}
        self.mirrors: Dict[int, rm.RemoteReplicaMirror] = {}
        self.groups: Dict[int, dict] = {}          # deployed descriptors
        self._export_addr: Dict[int, Tuple[str, int]] = {}
        self._attempts: Dict[int, int] = {}
        self._deploy_clients: Dict[str, tp.ControlClient] = {}
        # JobMaster-side latency distributions for the scheduler's own
        # recovery phases (the worker-side phases ride heartbeats).
        self.metrics = met.MetricRegistry()
        g = self.metrics.group("scheduler")
        self._m_deploy_ms = g.histogram("deploy-ms")
        self._m_fetch_ms = g.histogram("recovery.determinant-fetch-ms")
        self._m_redeploy_ms = g.histogram("recovery.redeploy-ms")
        self._detected: set = set()    # workers already traced as failed

    def _tr(self):
        return self._tracer if self._tracer is not None else get_tracer()

    def _slot_key(self, group: int):
        """Pool allocation key: job-scoped when this scheduler shares a
        pool with other jobs, the bare group otherwise."""
        return (self.job_id, int(group)) if self.job_id else int(group)

    # --- leadership ----------------------------------------------------------

    def _require_leadership(self) -> None:
        if not self.election.is_leader() or not self.election.renew():
            raise NotLeaderError(
                f"scheduler {self.election.contender_id!r} does not hold "
                f"the JobMaster lease — refusing to issue deployments")

    # --- plumbing ------------------------------------------------------------

    def _worker_info(self, worker_id: str) -> dict:
        info = self.jm.info(worker_id)
        if "deploy_port" not in info:
            raise RuntimeError(
                f"worker {worker_id} registered without a deploy "
                f"endpoint (not a slot worker)")
        return info

    def _deploy_client(self, worker_id: str) -> tp.ControlClient:
        if worker_id not in self._deploy_clients:
            info = self._worker_info(worker_id)
            self._deploy_clients[worker_id] = tp.ControlClient(
                (info.get("deploy_host", "127.0.0.1"),
                 int(info["deploy_port"])))
        return self._deploy_clients[worker_id]

    def _send_deploy(self, worker_id: str, tdd: dict,
                     frame: bytes = b"") -> dict:
        hdr = tp.pack_json(tdd)
        rt, resp = self._deploy_client(worker_id).call(
            tp.DEPLOY, len(hdr).to_bytes(4, "little") + hdr + frame)
        if rt == tp.ERROR:
            raise RuntimeError(tp.unpack_json(resp)["error"])
        return tp.unpack_json(resp)

    def _wait_running(self, worker_id: str, group: int,
                      attempt: int) -> dict:
        deadline = time.monotonic() + self.deploy_timeout_s
        while time.monotonic() < deadline:
            st = self.jm.task_state(worker_id, group, self.job_id)
            if (st and st.get("state") == "RUNNING"
                    and int(st.get("attempt", -1)) == attempt):
                return st
            time.sleep(0.05)
        raise TimeoutError(
            f"group {group} (attempt {attempt}) did not reach RUNNING "
            f"on {worker_id} within {self.deploy_timeout_s}s")

    def _descriptor(self, group: int, part: Sequence[int],
                    external_feeds: Dict[int, dict]) -> dict:
        ins, _outs = cut_edges(self.job, part)
        feeds_spec = {}
        for eidx in ins:
            if eidx not in self._export_addr:
                raise RuntimeError(
                    f"group {group}: upstream export for edge {eidx} "
                    f"not deployed yet (deploy slices in topo order)")
            host, port = self._export_addr[eidx]
            feeds_spec[str(eidx)] = {"kind": "edge", "host": host,
                                     "port": port, "edge": eidx}
        tdd = {
            "group": group,
            "job": self.job_spec,
            "vertices": [int(v) for v in part],
            "feed_batch": self.feed_batch,
            "feeds": feeds_spec,
            "external_feeds": {str(v): spec
                               for v, spec in external_feeds.items()
                               if v in set(part)},
            "checkpoint_dir": f"{self.checkpoint_root}/g{group}",
            "runner_kw": self.runner_kw,
            "target_epochs": self.target_epochs,
            "complete_every": self.complete_every,
            "standby_worker": self.standby.get(group),
        }
        if self.job_id:
            # Routes per-job worker state (slice keying, metric prefixes,
            # per-job fencing); absent in single-job mode.
            tdd["job_id"] = self.job_id
            tdd["tenant"] = self.tenant
        return tdd

    def _place(self, group: int, tdd: dict, worker_id: str,
               frame: bytes = b"") -> dict:
        """Stamp, send, await RUNNING, and wire mirror + exports."""
        attempt = self._attempts.get(group, -1) + 1
        self._attempts[group] = attempt
        hdr = dict(tdd, attempt=attempt, fencing_epoch=self.election.epoch)
        # Like tp.attach_trace but through THIS job's tracer, so every
        # worker span for this slice joins this job's trace id.
        ctx = self._tr().wire_context()
        if ctx is not None:
            hdr["trace"] = ctx
        tdd = tp.attach_hlc(
            tp.attach_lineage(tp.attach_profile(tp.attach_audit(hdr))),
            verb="DEPLOY")
        span_kw = {"job": self.job_id} if self.job_id else {}
        t0 = time.monotonic()
        with self._tr().span("deploy", group=group, worker=worker_id,
                             attempt=attempt,
                             recover=bool(tdd.get("recover")), **span_kw):
            self._send_deploy(worker_id, tdd, frame)
            st = self._wait_running(worker_id, group, attempt)
        self._m_deploy_ms.update((time.monotonic() - t0) * 1e3)
        info = self._worker_info(worker_id)
        host = info.get("deploy_host", "127.0.0.1")
        _ins, outs = cut_edges(self.job, tdd["vertices"])
        for eidx in outs:
            self._export_addr[eidx] = (
                host, int(st["export_ports"][str(eidx)]))
        old = self.mirrors.pop(group, None)
        if old is not None:
            old.close()
        self.mirrors[group] = rm.RemoteReplicaMirror(
            (host, int(st["log_port"])),
            flats=list(range(int(st["num_subtasks"]))),
            capacity=self.mirror_capacity,
            max_epochs=self.mirror_max_epochs, device=self.device)
        self.placements[group] = worker_id
        self.groups[group] = tdd
        return st

    # --- deployment ----------------------------------------------------------

    def deploy(self, workers: Optional[List[str]] = None,
               external_feeds: Optional[Dict[int, dict]] = None,
               num_slices: Optional[int] = None) -> Dict[int, str]:
        """Partition the job across the given workers (default: every
        registered worker with slot capacity, in id order) and deploy
        slice by slice in topological order — each slice's cut in-edges
        dial the export endpoints its upstream slices just reported.
        ``num_slices`` decouples the cut count from the worker count;
        default one slice per worker. Returns {group: worker}."""
        self._require_leadership()
        if self._owns_pool:
            self.pool.sync_offers(self.jm.slots())
        workers = list(workers) if workers else self.pool.workers()
        if not workers:
            raise RuntimeError("deploy: no workers with slots registered")
        k = int(num_slices) if num_slices else len(workers)
        self.parts = partition_vertices(self.job, k)
        order = standby_worker_order(len(workers))
        for gi in range(len(self.parts)):
            self.standby[gi] = workers[order[gi % len(workers)]]
        for gi, part in enumerate(self.parts):
            slot = self.pool.allocate(self._slot_key(gi),
                                      prefer=workers[gi % len(workers)])
            tdd = self._descriptor(gi, part, external_feeds or {})
            self._place(gi, tdd, slot.worker_id)
        return dict(self.placements)

    def sync(self) -> Dict[int, int]:
        """One mirror pull round over groups on healthy workers."""
        out = {}
        dead = set(self.jm.expired())
        for group, mirror in self.mirrors.items():
            if self.placements.get(group) in dead:
                continue
            try:
                out[group] = mirror.sync()
            except OSError:
                out[group] = -1      # endpoint gone; heartbeats decide
        return out

    def failed_workers(self) -> List[str]:
        placed = set(self.placements.values())
        out = [w for w in self.jm.expired() if w in placed]
        tr = self._tr()
        if tr.enabled:
            for w in out:
                if w not in self._detected:     # once per worker death
                    self._detected.add(w)
                    tr.event("recovery.detect", worker=w,
                             groups=sorted(
                                 g for g, pw in self.placements.items()
                                 if pw == w))
        return out

    def recover_worker(self, dead_worker: str,
                       max_groups: Optional[int] = None
                       ) -> Dict[int, str]:
        """A worker died: redeploy ONLY its task groups — preferring each
        group's standby worker — shipping the mirrored determinant rows
        for the causal rebuild. Every other group keeps running.
        ``max_groups`` caps how many groups ONE CALL redeploys (the
        dispatcher's per-tenant recovery cap; the rest stay attributed to
        the dead worker for a later call). Returns {group: new worker}."""
        self._require_leadership()
        lost = sorted(g for g, w in self.placements.items()
                      if w == dead_worker)
        self.pool.drop_worker(dead_worker)       # idempotent across jobs
        self._deploy_clients.pop(dead_worker, None)
        if max_groups is not None:
            lost = lost[: max(0, int(max_groups))]
        with self.jm._lock:
            ignored = sorted(set(self.jm._ignored))
        moved: Dict[int, str] = {}
        tr = self._tr()
        span_kw = {"job": self.job_id} if self.job_id else {}
        t0 = time.monotonic()
        with tr.span("recovery.redeploy", worker=dead_worker,
                     groups=lost, **span_kw):
            for group in lost:
                target = self.standby.get(group)
                if (target == dead_worker
                        or target not in self.pool.workers()):
                    target = None
                slot = self.pool.allocate(self._slot_key(group),
                                          prefer=target,
                                          avoid=(dead_worker,))
                mirror = self.mirrors[group]
                tf = time.monotonic()
                with tr.span("recovery.determinant_fetch", group=group):
                    deltas = []
                    for flat in mirror.flats:
                        rows, start = mirror.rows_with_start(flat)
                        deltas.append(
                            (flat, start, np.asarray(rows, np.int32)))
                    frame = serde.encode_delta(deltas)
                self._m_fetch_ms.update((time.monotonic() - tf) * 1e3)
                tdd = dict(self.groups[group], recover=True,
                           ignored=ignored)
                self._place(group, tdd, slot.worker_id, frame)
                moved[group] = slot.worker_id
        self._m_redeploy_ms.update((time.monotonic() - t0) * 1e3)
        return moved

    def release_pool_slots(self) -> None:
        """Free every pool slot this job occupies (the dispatcher calls
        this on job completion / cancellation so queued jobs admit)."""
        for group in list(self.placements):
            self.pool.release_group(self._slot_key(group))

    def close(self) -> None:
        for m in self.mirrors.values():
            m.close()
        for c in self._deploy_clients.values():
            c.close()
