"""Cluster runner: failure detection, standby management, causal recovery.

Port of ``clonos_tpu/runtime/cluster.py`` — the control plane tying the
executor, the checkpoint coordinator, the replication plan and the
recovery FSM together:

- ``HeartbeatMonitor``: deadline-based liveness;
- ``StandbyPool``: the latest completed checkpoint standbys restore from;
- ``ClusterRunner``: the sequential epoch fence (health read, audit seal,
  ledger, checkpoint trigger, source fence determinants, completion) and
  the full local-recovery protocol for any set of failed subtasks, in
  topological order: ignore the checkpoints the dead never acked, back
  off, rebuild each failed subtask from the last completed checkpoint
  plus determinant replay, patch it into the live carry, rebuild the
  replica rows it held, and close with one packed device read that
  checks every deferred assert. An upstream's rebuilt ring lane feeds its
  downstream's replay in the same call (connected failures).

Failure model: the unit of loss is a subtask's device state — its
operator-state row, its causal-log row, the replica rows it holds for
others and its lane of its vertex's in-flight ring. Healthy subtasks are
never rolled back; the proof obligation is that the patched carry equals
a never-failed run on the canonical (logically live) state
(``executor.canonical_carry``).

Overlapped runtime, each with its sequential control behind a switch:
the pipelined epoch fence (``overlap_epoch``; the fence tail drains on a
worker thread while the next epoch computes), asynchronous checkpoint
writes, the overlapped recovery finalize (``overlap_recovery``), standby-
host bootstrap (``bootstrap_standby``), latency markers and the metrics
registry they feed, and the routed-window cache shared by one vertex's
failed subtasks.

Tiered storage: with a ``spool_dir`` (passed through to the executor)
every closed epoch's ring steps and determinant rows spill to host and
disk tiers, and a recovery whose replay span outruns the ring refills
the leading steps from them (uploaded once per recovery, spliced ahead
of the ring's steps, routed as ring steps are); a torn segment raises a
labelled ``RecoveryError``. With spill the pipelined fence settles
strictly. ``incremental_checkpoints`` writes device-diffed delta chains
(``runtime/incremental.py``).

Host boundaries: host-fed sources commit their checkpointed offsets to
their readers when the checkpoint completes, and a failed one re-reads
its lost records (``_reread_feed``); processing-time timers advance at
block boundaries on host-known causal time and re-fire after recovery;
transactional sinks tap every block's outputs into per-epoch
transactions (a ``device.HostCopy`` started on the main thread, waited at
the seal), seal them at the fence, commit them on checkpoint completion
and rebuild a failed subtask's shards from its replay. A two-input
vertex replays from both of its input edges.

Observability, off by default: the process tracer (``obs/trace.py``)
records the ``epoch`` / ``epoch.steps`` / ``epoch.fence`` spans and the
``recovery`` span with a ``recovery.<phase>`` child per recovery phase
(``phase_ms``'s keys), each opened when its phase starts; the process
profiler (``obs/profile.py``), bound
to the job's metric group, times the fence's sections (``health-read``,
``digest-seal``, ``ledger-write``, ``snapshot``, ``source-append``,
``timer-advance``) against ``compute`` and rolls them into the
``overhead.ft-fraction`` gauge at every fence. ``from_config`` builds a
runner from the typed options (``config/defaults.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time as _time
import types
import warnings
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.api.operators import (HostFeedSource,
                                            TransactionalSinkOperator,
                                            TwoInputOperator)
from clonos_tpu_torch.api.records import RecordBatch, empty
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.causal.epoch import EpochTracker
from clonos_tpu_torch.graph.job_graph import JobGraph, PartitionType
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.obs import audit as _audit
from clonos_tpu_torch.obs import incident as obs_incident
from clonos_tpu_torch.obs import lineage as obs_lineage
from clonos_tpu_torch.obs import profile as _prof
from clonos_tpu_torch.obs.timeline import get_timeline
from clonos_tpu_torch.obs.trace import configure as configure_tracer
from clonos_tpu_torch.obs.trace import get_tracer
from clonos_tpu_torch.parallel import routing
from clonos_tpu_torch.runtime import checkpoint as cp
from clonos_tpu_torch.runtime.timers import ProcessingTimeService
from clonos_tpu_torch.runtime.txn import TransactionLog
from clonos_tpu_torch.runtime.executor import (DETS_PER_STEP, JobCarry,
                                               LeanSnapshot, LocalExecutor,
                                               _gather_block)
from clonos_tpu_torch.storage import SegmentCorruptError, StorageError
from clonos_tpu_torch.utils import metrics as met
from clonos_tpu_torch.utils.tree import tree_map

#: the ``spill.*`` gauges: tier occupancy (``spill_occupancy``), then
#: movement (``spill_stats``)
_SPILL_OCCUPANCY = ("host_epochs", "disk_epochs", "host_bytes", "disk_bytes")
_SPILL_KEYS = _SPILL_OCCUPANCY + ("bytes_spilled", "bytes_refilled")


class HeartbeatMonitor:
    """Deadline-based liveness tracking. ``clock`` is injectable."""

    def __init__(self, subtasks: Sequence[int], timeout_s: float = 5.0,
                 clock=_time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        self._last: Dict[int, float] = {s: clock() for s in subtasks}
        self._dead: Set[int] = set()
        #: injected per-subtask heartbeat delay (seconds): a gray-failed
        #: worker's beats arrive this much late — alive and making slow
        #: progress, so degraded, not dead. Empty in production.
        self.lag: Dict[int, float] = {}

    def beat(self, subtask: int) -> None:
        if subtask not in self._dead:
            self._last[subtask] = (self._clock()
                                   - self.lag.get(subtask, 0.0))

    def beat_all_except(self, dead: Set[int]) -> None:
        now = self._clock()
        for s in self._last:
            if s not in dead and s not in self._dead:
                self._last[s] = now - self.lag.get(s, 0.0)

    def mark_dead(self, subtask: int) -> None:
        self._dead.add(subtask)

    def expired(self) -> List[int]:
        now = self._clock()
        return sorted(s for s, t in self._last.items()
                      if s not in self._dead and now - t > self.timeout_s)

    def _alive(self) -> Dict[int, float]:
        return {s: t for s, t in self._last.items() if s not in self._dead}

    def degraded(self, grace_s: float = 0.0) -> List[int]:
        """Subtasks whose beats arrive late but inside the death timeout
        (gray failures). Lateness is measured against the freshest live
        beat, not wall time, so only a worker lagging its peers by more
        than ``grace_s`` is degraded. Disjoint from :meth:`expired`."""
        alive = self._alive()
        if not alive:
            return []
        freshest = max(alive.values())
        now = self._clock()
        return sorted(s for s, t in alive.items()
                      if freshest - t > grace_s
                      and now - t <= self.timeout_s)

    def ages_ms(self) -> Dict[int, float]:
        """Per-subtask beat age behind the freshest live beat, in ms
        (0.0 for the freshest; empty when no one is alive)."""
        alive = self._alive()
        if not alive:
            return {}
        freshest = max(alive.values())
        return {s: (freshest - t) * 1e3 for s, t in alive.items()}

    def revive(self, subtask: int) -> None:
        self._dead.discard(subtask)
        self.lag.pop(subtask, None)
        self._last[subtask] = self._clock()


class StandbyPool:
    """Holds the state standbys restore from: the latest completed
    checkpoint, refreshed on every completion, for
    ``num_standby_per_vertex`` standbys of each subtask."""

    def __init__(self, num_standby_per_vertex: int = 1):
        self.num_standby_per_vertex = num_standby_per_vertex
        self.latest: Optional[cp.CompletedCheckpoint] = None
        self.dispatch_count = 0

    def on_completed_checkpoint(self, ckpt: cp.CompletedCheckpoint) -> None:
        # Monotonic: a stale completion never regresses the restore point.
        if self.latest is None \
                or ckpt.checkpoint_id >= self.latest.checkpoint_id:
            self.latest = ckpt
        self.dispatch_count += 1

    def has_state(self) -> bool:
        return self.latest is not None


class LatencyMarkers:
    """Latency markers through the causal RNG: a step is a marker step
    when its recorded RNG draw is divisible by ``every``, so a recovered
    task re-derives the same schedule. A record emitted at source step
    ``s`` reaches the sink at step ``s + depth`` (the depth-1 superstep
    pipeline), so a marker's latency is the causal-time delta between
    those two steps' inputs. Feeds the ``latency-ms`` histogram."""

    def __init__(self, runner: "ClusterRunner", every: int):
        self.runner = runner
        self.every = every
        job = runner.job
        # Pipeline depth: the longest source -> sink path in edges.
        depth = {v.vertex_id: 0 for v in job.vertices}
        for vid in job.topo_order():
            for e in job.in_edges(vid):
                depth[vid] = max(depth[vid], depth[job.edges[e].src] + 1)
        self.depth = max(depth.values()) if depth else 0
        self.hist = runner.metrics.group(
            f"job.{job.name}").histogram("latency-ms")
        self._seen = 0
        #: the newest ``(source step, latency)`` pairs behind the histogram
        self.samples: List[Tuple[int, float]] = []
        self.max_samples = 8192

    @staticmethod
    def schedule(rngs, every: int):
        """Marker steps of an rng-draw stream."""
        return [i for i, r in enumerate(rngs) if r % every == 0]

    def observe(self) -> None:
        hist = self.runner.executor.step_input_history
        upto = len(hist) - self.depth
        for s in range(self._seen, max(upto, 0)):
            t, r = hist[s]
            if r % self.every == 0:
                lat = hist[s + self.depth][0] - t
                self.hist.update(lat)
                self.samples.append((s, float(lat)))
        if len(self.samples) > self.max_samples:
            del self.samples[:len(self.samples) - self.max_samples]
        self._seen = max(self._seen, upto, 0)


@dataclasses.dataclass
class RecoveryReport:
    """What one failure's recovery did."""

    failed_subtasks: Tuple[int, ...]
    from_epoch: int
    steps_replayed: int
    determinants_replayed: int
    records_replayed: int
    ignored_checkpoints: Tuple[int, ...]
    recovery_ms: float
    managers: Tuple[rec.RecoveryManager, ...]
    #: wall ms per recovery phase (restore / fetch_determinants / inputs /
    #: replay / patch / replica_rebuild / finalize.* / audit)
    phase_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: True for failover rehearsals (failover_drill): not in ``reports``
    drill: bool = False
    #: bytes the shard-local restore moved (failed subtasks' checkpoint
    #: rows, determinant streams, replayed input windows) ...
    restore_bytes: int = 0
    #: ... against the whole checkpoint a global rollback would reload
    checkpoint_bytes: int = 0
    #: ``bootstrap_standby`` only: the part of each overlapped
    #: ``finalize.*`` sub-span the rebuild waited for (the rest is in
    #: ``finalize.overlap-saved``)
    blocked_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def results(self) -> Tuple[rec.ReplayResult, ...]:
        return tuple(m.result for m in self.managers)


class _Lap:
    """One ``recovery.<phase>`` span and its length: ``ms`` once it has
    closed."""

    __slots__ = ("span", "t0", "ms")

    def __init__(self, span, t0: float):
        self.span, self.t0, self.ms = span, t0, 0.0


class _RecoverySpans:
    """A recovery's spans on the process tracer: ``recovery`` from the
    recovery's start to its report and, inside it, one phase at a time,
    each a ``recovery.<phase>`` span opened when the phase's work starts.
    ``phases`` (the report's ``phase_ms``) sums each phase's span
    durations; with the tracer off the same intervals are read on the
    monotonic clock. With the tracer on, ``recovery`` carries
    ``cuda_allocs``: the caching allocators' trips to CUDA over it, and
    :meth:`count` adds counters to the open phase's span. Used around
    the whole recovery: one that raises closes what it opened."""

    def __init__(self, drill: bool, device):
        self._tracer = get_tracer()
        self._drill = drill
        self._device = device
        self._lock = threading.Lock()
        self.phases: Dict[str, float] = {}
        self._recovery = None
        self._allocs: Optional[int] = None
        self._open: Optional[Tuple[str, _Lap]] = None

    @property
    def span_id(self) -> Optional[str]:
        """The ``recovery`` span's id (the parent of a worker's phase)."""
        return self._recovery.span_id

    def begin(self) -> float:
        """Open ``recovery`` and its first phase, ``restore``; returns
        the start on the monotonic clock."""
        t0 = _time.monotonic()
        self._recovery = self._tracer.span("recovery", drill=self._drill)
        self._recovery.__enter__()
        if self._tracer.enabled:
            self._allocs = _device.cuda_allocs(self._device)
        self.enter("restore")
        return t0

    def _start(self, name: str, parent: Optional[str] = None) -> _Lap:
        span = (self._tracer.span_in(parent, f"recovery.{name}",
                                     drill=self._drill)
                if parent is not None else
                self._tracer.span(f"recovery.{name}", drill=self._drill))
        span.__enter__()
        return _Lap(span, _time.monotonic())

    def _finish(self, name: str, lap: _Lap,
                exc=(None, None, None)) -> None:
        lap.span.__exit__(*exc)
        lap.ms = (lap.span.dur * 1e3 if self._tracer.enabled
                  else (_time.monotonic() - lap.t0) * 1e3)
        with self._lock:            # a worker's phase adds in too
            self.phases[name] = self.phases.get(name, 0.0) + lap.ms

    def enter(self, name: str) -> None:
        """Close the open phase and open ``name``."""
        self.stop()
        self._open = (name, self._start(name))

    def count(self, counts: Dict[str, int]) -> None:
        """Add ``counts`` to the open phase's span (tracer on only)."""
        if not self._tracer.enabled or self._open is None:
            return
        args = self._open[1].span.args
        for k, v in counts.items():
            args[k] = args.get(k, 0) + int(v)

    def stop(self, exc=(None, None, None)) -> float:
        """Close the open phase; returns now on the monotonic clock."""
        if self._open is not None:
            name, lap = self._open
            self._open = None
            self._finish(name, lap, exc)
        return _time.monotonic()

    @contextlib.contextmanager
    def phase(self, name: str, parent: Optional[str] = None):
        """``name`` over the ``with`` body, outside the sequence of
        :meth:`enter` (a part of the finalize, the audit); ``parent``
        names the recovery span from a worker thread. Yields its
        :class:`_Lap`."""
        lap = self._start(name, parent)
        try:
            yield lap
        except BaseException as e:
            self._finish(name, lap, (type(e), e, e.__traceback__))
            raise
        self._finish(name, lap)

    @contextlib.contextmanager
    def aside(self, name: str):
        """``name`` as a phase of its own while the open phase pauses:
        the open one closes and opens again after the body."""
        held = self._open[0] if self._open is not None else None
        self.stop()
        with self.phase(name):
            yield
        if held is not None:
            self.enter(held)

    def close(self, **args) -> None:
        """Close ``recovery`` with ``args`` (the report's figures)."""
        self.stop()
        span, self._recovery = self._recovery, None
        if self._tracer.enabled:
            span.args.update(args)
            if self._allocs is not None:
                span.args["cuda_allocs"] = (
                    _device.cuda_allocs(self._device) - self._allocs)
        span.__exit__(None, None, None)

    def __enter__(self) -> "_RecoverySpans":
        return self

    def __exit__(self, *exc) -> bool:
        # A recovery that raised: close its open phase, then itself.
        self.stop(exc)
        if self._recovery is not None:
            span, self._recovery = self._recovery, None
            span.__exit__(*exc)
        return False


class OverflowError_(RuntimeError):
    """An un-checkpointed log/ring overflow was detected: recovery state
    was clobbered and the control plane must not keep running."""


def _put_row(stack: torch.Tensor, one: torch.Tensor, i: int
             ) -> torch.Tensor:
    """``stack`` with its row ``i`` replaced by ``one`` (a copy)."""
    stack = stack.clone()
    stack[i] = one
    return stack


class ClusterRunner:
    """Cluster with failure injection. Drives epochs; at every epoch
    fence triggers a checkpoint, collects acks from healthy subtasks, and
    on completion truncates logs and refreshes standbys. With ``mesh=``
    (a task mesh, passed through to the executor) every rank runs one
    runner over its shards, making the same calls in the same order.

    ``overlap_epoch`` (default False, the strict order) selects the
    pipelined fence for :meth:`run_epoch`; ``overlap_recovery`` (default
    True) the overlapped finalize for :meth:`recover`. The other setting
    of each is the sequential control, reached only through the switch.

    ``compile_cache_dir`` points every kernel build at that directory
    (``utils/compile_cache.py``), so a restarted process loads what an
    earlier one built; ``prewarm=True`` calls :meth:`prewarm_recovery`
    at the end of construction."""

    def __init__(self, job: JobGraph, steps_per_epoch: int = 8,
                 num_standby: int = 1, heartbeat_timeout_s: float = 5.0,
                 checkpoint_dir: Optional[str] = None,
                 recovery_block_steps: Optional[int] = None,
                 latency_marker_every: Optional[int] = None,
                 audit: Optional[bool] = None,
                 audit_on_divergence: Optional[str] = None,
                 lineage=None,
                 overlap_recovery: bool = True,
                 overlap_epoch: bool = False,
                 incremental_checkpoints: bool = False,
                 incremental_base_every: int = 8,
                 prewarm: bool = False,
                 compile_cache_dir: Optional[str] = None,
                 device="cuda", **executor_kw):
        self.job = job
        #: the kernel build cache in use (None: the default build
        #: directory). Set before the executor is built, in the mesh's
        #: namespace, then refined by the carry's placement tree once the
        #: executor exists — the reference's sequence, which a restarted
        #: process replays exactly.
        self._compile_cache_dir: Optional[str] = None
        if compile_cache_dir:
            from clonos_tpu_torch.utils.compile_cache import (
                enable_compile_cache)
            self._compile_cache_dir = enable_compile_cache(
                compile_cache_dir, mesh=executor_kw.get("mesh"))
        self.executor = LocalExecutor(job, steps_per_epoch=steps_per_epoch,
                                      device=device, **executor_kw)
        self.device = self.executor.device
        compiled = self.executor.compiled
        self.plan = compiled.plan
        #: the task mesh (``parallel/distributed.py``): every rank runs
        #: this runner in lockstep; rank 0 owns the audit seal, the ledger
        #: and the checkpoint files (None: one process, no mesh)
        self.mesh = compiled.mesh
        self.rank = compiled.shard
        if compile_cache_dir and self.mesh is not None:
            self._compile_cache_dir = enable_compile_cache(
                compile_cache_dir, mesh=self.mesh,
                specs=compiled.placements())
        if self.mesh is not None and self.rank != 0:
            # Only rank 0 writes checkpoint files (a delta chain too) and
            # the ledger; the others run the same coordinator protocol in
            # memory.
            checkpoint_dir = None
            incremental_checkpoints = False
        self.overlap_recovery = overlap_recovery
        self.overlap_epoch = overlap_epoch
        #: the in-flight fence tail (pipelined fence): None, or a dict with
        #: the worker thread, the captured handles and its results. Joined
        #: at the next fence, before a kill, a recovery or a drain.
        self._fence_tail: Optional[dict] = None
        #: fence.* wall ms of the last sequential or joined fence, with
        #: "fence-tail" (the wall the epoch waited) and, pipelined only,
        #: "fence.overlap-saved" (sum(fence.*) - overlap-saved ==
        #: fence-tail); the sequential control never writes that key
        self.last_fence_phases: Dict[str, float] = {}
        self.fence_overlap_saved_total_ms = 0.0
        self._fence_headroom_checked = False
        if incremental_checkpoints:
            if checkpoint_dir is None:
                raise ValueError(
                    "incremental_checkpoints requires checkpoint_dir")
            from clonos_tpu_torch.runtime.incremental import (
                IncrementalCheckpointStorage)
            storage: cp.CheckpointStorage = IncrementalCheckpointStorage(
                checkpoint_dir, base_every=incremental_base_every)
        elif checkpoint_dir:
            storage = cp.FileCheckpointStorage(checkpoint_dir)
        else:
            storage = cp.InMemoryCheckpointStorage()
        self.coordinator = cp.CheckpointCoordinator(
            storage, num_subtasks=job.total_subtasks(),
            base_interval_steps=steps_per_epoch)
        if compiled.n_shards > 1:
            # The first completion listener: nothing on any rank commits,
            # truncates or releases for a checkpoint before rank 0 holds
            # it durably.
            self.coordinator.subscribe_completion(self._completion_gate)
        self.standbys = StandbyPool(num_standby)
        self.coordinator.subscribe_completed_state(
            self.standbys.on_completed_checkpoint)
        self.coordinator.subscribe_completion(
            self.executor.notify_checkpoint_complete)
        # A completed checkpoint commits the feed offsets it captured, so
        # bounded-retention readers may release history below them.
        self.coordinator.subscribe_completed_state(self._commit_feed_offsets)
        self.coordinator.transition_observers.append(self._drop_feed_copy)
        #: checkpoint id -> host copy of its feed offsets, started with
        #: the fence snapshot (the completion never reads the device).
        #: Written on the main thread, taken at completion (possibly on a
        #: writer thread), dropped when its checkpoint is ignored or
        #: discarded: every touch holds the lock.
        self._feed_offset_copies: Dict[int, _device.HostCopy] = {}
        self._feed_copies_lock = threading.Lock()
        self.heartbeats = HeartbeatMonitor(
            range(job.total_subtasks()), timeout_s=heartbeat_timeout_s)
        self.failed: Set[int] = set()
        #: ``fn(closed)`` at every epoch fence, on the driving thread,
        #: before checkpoint completion truncates the logs and rings
        #: (queryable state refreshes its fence snapshot here)
        self.fence_hooks: List = []
        #: read-replica delta feeds (``runtime/serve.py``): ``fn(epoch,
        #: window)`` when an epoch seals, with the same extracted window
        #: the audit digests. On the fence worker when the fence is
        #: pipelined: subscribers are host-only and thread-safe.
        self.serve_feeds: List = []
        #: the last epoch whose fence tail sealed (-1 before the first):
        #: the freshness stamp of every queryable-state snapshot
        self.last_sealed_epoch = -1
        self.global_step = 0
        #: epoch -> global step at its start
        self._fence_step: Dict[int, int] = {0: 0}
        self.reports: List[RecoveryReport] = []
        # Metrics (names and value shapes as the reference's registry).
        self.metrics = met.MetricRegistry()
        g = self.metrics.group(f"job.{job.name}")
        self._mgroup = g
        self._m_steps = g.counter("supersteps")
        self._m_records = g.meter("records-per-sec")
        self._m_epochs = g.counter("epochs")
        g.gauge("checkpoint.latest-bytes",
                lambda: (self.standbys.latest.size_bytes
                         if self.standbys.latest else 0))
        self._m_recovery_ms = g.histogram("recovery.duration-ms")
        self._m_recovered_records = g.counter("recovery.records-replayed")
        self._m_epoch_steps_ms = g.histogram("epoch.steps-ms")
        self._m_epoch_fence_ms = g.histogram("epoch.fence-ms")
        self._m_ckpt_latency_ms = g.histogram(
            "checkpoint.trigger-to-complete-ms")
        self.coordinator.subscribe_completion(
            lambda cid: self._m_ckpt_latency_ms.update(
                self.coordinator.completion_latency_s.get(cid, 0.0) * 1e3))
        #: on a mesh with spill: every rank's ``spill.*`` readings as the
        #: last fence gathered them (a list in rank order; None before)
        self._spill_by_rank: Optional[List[Dict[str, int]]] = None
        if self.executor.spill_logs is not None:
            # Tier occupancy and movement over every spill owner (on a
            # mesh: this rank's; ``spill.total.*`` sums every rank's as
            # the last fence gathered them, never computed in a scrape).
            ex = self.executor
            for key in _SPILL_KEYS:
                g.gauge(f"spill.{key.replace('_', '-')}",
                        lambda k=key: self._spill_reading(k))
                if compiled.n_shards > 1:
                    g.gauge(f"spill.total.{key.replace('_', '-')}",
                            lambda k=key: self._spill_total(k))
        # Exactly-once audit: audit=None inherits the process-global
        # stance, and so does the divergence policy unless
        # audit_on_divergence names one; the default NullAuditor reads
        # and writes nothing.
        self._audit_layout = tuple(
            (v.vertex_id, v.parallelism) for v in job.vertices)
        stance = _audit.get_auditor()
        if audit is None:
            audit = stance.enabled
        self.auditor: _audit.NullAuditor = (
            _audit.Auditor(on_divergence=(audit_on_divergence
                                          or stance.on_divergence))
            if audit else _audit.NullAuditor())
        self._m_audit_sealed = g.counter("audit.epochs-sealed")
        self._m_audit_matches = g.counter("audit.epochs-validated")
        self._m_audit_div = g.counter("audit.divergences")
        # Overhead attribution: the runner inherits the process profiler;
        # an enabled one feeds its overhead.<section>-ms histograms and
        # the overhead.ft-fraction gauge into this group. The default
        # NullProfiler binds to nothing and waits for nothing.
        self.profiler = _prof.get_profiler()
        if self.profiler.enabled:
            self.profiler.bind(g)
        g.gauge("audit.enabled", lambda: int(self.auditor.enabled))
        g.gauge("audit.last-sealed-epoch", lambda: self.auditor.last_epoch)
        # Incident bundles: a live process IncidentManager's capture
        # counters ride the heartbeat piggyback; the default registers
        # nothing.
        _inc = obs_incident.get_incidents()
        if _inc.enabled:
            _inc.register_gauges(self.metrics)
        # Record lineage, bound per runner like the auditor: None
        # inherits the process plane (configured, or adopted from a
        # DEPLOY header); runners sharing a process pass their own plane
        # so each writes its own file. The NullLineage default scans and
        # registers nothing.
        self.lineage = (lineage if lineage is not None
                        else obs_lineage.get_lineage())
        if self.lineage.enabled:
            self.lineage.register_gauges(self.metrics)
        #: vertex id -> parallelism, for the seal scan's key-group and
        #: subtask attribution
        self._lineage_topology = {v.vertex_id: v.parallelism
                                  for v in job.vertices}
        # Live exactly-once health, from host mirrors (no device read):
        # how much of the in-flight rings un-truncated history holds, and
        # how many supersteps a failure now would replay.
        g.gauge("backpressure.inflight-occupancy", self._inflight_occupancy)
        g.gauge("recovery.replay-lag-steps", self._replay_lag_steps)
        # Determinant-log occupancy (one device read per scrape).
        self.watchdog = met.LogOccupancyWatchdog(self.executor, g)
        # Per-shard health on a mesh: one gauge triple per task-axis
        # shard, read from the [n, 3] the last fence or recovery left on
        # its way to the host (a scrape never computes it, so it never
        # runs a collective; None before the first fence).
        self._shard_health: Optional[_device.HostCopy] = None
        self._shard_health_epoch = -1
        if self.mesh is not None:
            n_sh = compiled.n_shards
            g.gauge("mesh.shards", lambda n_sh=n_sh: n_sh)
            for i in range(n_sh):
                for col, name in enumerate(("records", "log-rows",
                                            "ring-slots")):
                    g.gauge(f"shard.{i}.{name}",
                            lambda i=i, col=col: self._shard_gauge(i, col))
        #: the validator of the last audited recovery (its ``events``)
        self.last_audit: Optional[rec.AuditValidator] = None
        #: routed edge windows shared by one vertex's failed subtasks
        #: within one recover() (only when >= 2 of them failed)
        self._route_cache: Dict[Tuple[int, int], RecordBatch] = {}
        self._route_cache_enabled = False
        #: cache hits in the last recover()
        self._route_cache_hits = 0
        #: ring index -> ((lo, hi), steps on the device) refilled from the
        #: spill tiers within one recover()
        self._spill_cache: Dict[int, Tuple[Tuple[int, int], RecordBatch]] = {}
        self._last_records_total = 0
        #: checkpoint id -> np [L] log heads at that fence, from the fence
        #: health read (recovery reads them here, not from the device).
        #: Written by the fence tail (the worker when pipelined), pruned at
        #: completion, read by recovery: every touch holds the lock.
        self._ck_log_heads: Dict[int, np.ndarray] = {}
        self._ck_heads_lock = threading.Lock()
        #: host mirror of the in-flight ring offsets: heads advance one per
        #: superstep, tails move only at checkpoint completion. Recovery's
        #: coverage decisions read it; the device bounds are checked
        #: against it in recovery's final packed read.
        self._ring_tail_mirror = 0
        self._ring_mirror_valid = True
        self._bounds_cache: Optional[Dict[int, Tuple[int, int]]] = None
        self.coordinator.subscribe_completion(self._update_ring_mirror)
        self.epoch_tracker = EpochTracker()
        self.coordinator.subscribe_completion(
            self.epoch_tracker.notify_checkpoint_complete)
        self.latency = (LatencyMarkers(self, latency_marker_every)
                        if latency_marker_every else None)
        #: flat subtask -> ProcessingTimeService; timers fire at block
        #: boundaries and log TIMER_TRIGGER determinants
        self.timer_services: Dict[int, ProcessingTimeService] = {}
        self.executor.block_listeners.append(self._advance_timers)
        # Transactional sinks: per-block emissions tap into per-epoch
        # transactions, sealed at fences, committed on completion.
        self.txn_logs: Dict[int, TransactionLog] = {
            v.vertex_id: TransactionLog(v.vertex_id)
            for v in job.vertices
            if isinstance(v.operator, TransactionalSinkOperator)}
        if self.txn_logs:
            self.executor.on_block_outputs = self._absorb_sink_outputs
            self.coordinator.subscribe_completion(
                lambda e: [tl.commit(e) for tl in self.txn_logs.values()])
        #: source subtasks log SOURCE_CHECKPOINT at every trigger
        self._source_flats = [
            job.subtask_base(v.vertex_id) + s
            for v in job.vertices if not job.in_edges(v.vertex_id)
            for s in range(v.parallelism)]
        self._recovery_ch = min(
            recovery_block_steps or self.executor.block_steps,
            compiled.inflight_ring_steps,
            compiled.log_capacity // DETS_PER_STEP)
        if prewarm:
            self.prewarm_recovery()

    # --- host boundaries: feeds, timers, transactional sinks ----------------

    def _stage_feed_offsets(self, closed: int, snap: LeanSnapshot
                            ) -> LeanSnapshot:
        """Start the host copy of the fence snapshot's feed offsets (on the
        thread that queued the blocks); the completion reads it. On a mesh
        ``snap`` is this rank's local snapshot: its lanes' offsets, which
        its own readers commit (the snapshot gathered to rank 0 carries
        every lane's, in the operator state)."""
        readers = self.executor.feed_readers
        if readers and snap is not None:
            copy = _device.HostCopy(
                {vid: snap.op_states[vid]["offset"] for vid in readers})
            with self._feed_copies_lock:
                self._feed_offset_copies[closed] = copy
        return snap

    def _drop_feed_copy(self, kind: str, cid: int = -1, **_) -> None:
        """Transition observer: an ignored or discarded checkpoint never
        completes, so its offsets copy is dropped."""
        if kind in ("ignore", "discard"):
            with self._feed_copies_lock:
                self._feed_offset_copies.pop(cid, None)

    def _commit_feed_offsets(self, ckpt: cp.CompletedCheckpoint) -> None:
        """Completion listener (possibly on a checkpoint writer's thread):
        commit the checkpoint's feed offsets to their readers."""
        cid = ckpt.checkpoint_id
        with self._feed_copies_lock:
            copy = self._feed_offset_copies.pop(cid, None)
            for k in [k for k in self._feed_offset_copies if k < cid]:
                del self._feed_offset_copies[k]
        if copy is None:
            return
        ex = self.executor
        comp = ex.compiled
        for vid, off in copy.wait().items():
            # Lanes another rank owns stay at 0 (never pulled here).
            full = [0] * self.job.vertices[vid].parallelism
            lo = comp.vblock[vid][0]
            full[lo:lo + len(off)] = [int(x) for x in off]
            if vid in ex._single_feeds:
                # One reader for every rank: rank 0 commits every lane's
                # offset, each rank's lanes gathered to it (on the
                # driving thread, where every rank completes in order).
                from clonos_tpu_torch.parallel import distributed as dist_
                got = dist_.gather_object((lo, full[lo:lo + len(off)]),
                                          self.mesh, comp.task_axis,
                                          group=ex._host_group)
                if got is None:
                    continue
                for lo_r, off_r in got:
                    full[lo_r:lo_r + len(off_r)] = off_r
            ex.feed_readers[vid].notify_checkpoint_complete(full)

    def _fence_snapshot(self, closed: int) -> Optional[LeanSnapshot]:
        """The sequential fence's snapshot with the feed offsets staged:
        unsharded the lean snapshot; on a mesh each rank stages its own
        lanes from its local shards, which then gather to rank 0 (None on
        the other ranks)."""
        ex = self.executor
        if self.mesh is None:
            return self._stage_feed_offsets(closed, ex.lean_snapshot())
        local = self._stage_feed_offsets(closed, ex.local_lean_snapshot())
        return ex.lean_snapshot(local)

    def _absorb_sink_outputs(self, outs, epoch: int) -> None:
        """The block's sink emissions into their transactions. On a mesh
        a rank absorbs the sink lanes it runs, keyed by global subtask;
        a sink vertex that does not split runs on every rank and is
        absorbed on rank 0 alone, so nothing is emitted twice."""
        comp = self.executor.compiled
        for vid, tl in self.txn_logs.items():
            b = outs.sinks.get(vid)
            if b is not None and self._owns_txn(vid):
                tl.absorb(epoch, _device.HostCopy(b),
                          lane0=comp.vblock[vid][0])

    def _owns_txn(self, vid: int) -> bool:
        """True when this rank holds sink vertex ``vid``'s transactions
        (its own lanes; rank 0 for a vertex that does not split)."""
        return self.rank == 0 or self.executor.compiled.sharded(vid)

    def _txn_subtasks(self, vid: int) -> Optional[range]:
        """The sink subtasks whose part files this rank writes, commits
        and sweeps (None: all of them, off a mesh)."""
        if self.mesh is None:
            return None
        if not self._owns_txn(vid):
            return range(0)
        return range(*self.executor.compiled.vblock[vid])

    def _seal_txns(self, closed: int) -> None:
        for tl in self.txn_logs.values():
            tl.seal(closed)

    def timer_service(self, flat_subtask: int) -> ProcessingTimeService:
        """The task's processing-time timer service (created on first
        use): its callbacks fire at block boundaries on causal time and
        their TIMER_TRIGGER determinants replay after a failure. On a mesh
        every rank keeps the service and appends its determinants (each
        to the log and replica rows it holds), and the first rank that
        runs the task (rank 0 for a vertex that does not split) alone
        runs its callbacks, live and when a recovery re-fires them."""
        svc = self.timer_services.get(flat_subtask)
        if svc is None:
            vid, sub = self._vertex_of(flat_subtask)
            svc = ProcessingTimeService(
                append=lambda d, f=flat_subtask:
                    self.executor.append_async_determinant(f, d),
                fires=(self.mesh is None
                       or self._vertex_ranks(vid, sub)[0] == self.rank))
            self.timer_services[flat_subtask] = svc
        return svc

    def _advance_timers(self, now: int, stamp: int) -> None:
        if not self.timer_services:
            return
        with self.profiler.section("timer-advance"):
            for flat, svc in self.timer_services.items():
                if flat not in self.failed:
                    svc.advance(now, stamp)

    @classmethod
    def from_config(cls, job: JobGraph, config=None, device="cuda",
                    **overrides) -> "ClusterRunner":
        """Build a runner from the typed configuration
        (``config/defaults.py``); explicit ``overrides`` win. The
        ``observability.profile.enabled`` option installs the process
        profiler and ``observability.tracing.*`` the process tracer
        (``trace-runner.jsonl`` under the tracing dir), unless one is
        already installed."""
        from clonos_tpu_torch.config import defaults as D
        from clonos_tpu_torch.config.options import Configuration
        cfg = config or Configuration()
        job.sharing_depth = cfg.get(D.DETERMINANT_SHARING_DEPTH)
        kw: Dict[str, Any] = dict(
            steps_per_epoch=cfg.get(D.CHECKPOINT_INTERVAL_STEPS),
            num_standby=(cfg.get(D.NUM_STANDBY_TASKS)
                         if cfg.get(D.FAILOVER_STRATEGY) == "standbytask"
                         else 0),
            heartbeat_timeout_s=cfg.get(D.HEARTBEAT_TIMEOUT_MS) / 1e3,
            log_capacity=cfg.get(D.DETERMINANT_LOG_CAPACITY),
            max_epochs=cfg.get(D.DETERMINANT_MAX_EPOCHS),
            inflight_ring_steps=cfg.get(D.INFLIGHT_CAPACITY_BATCHES),
        )
        if cfg.get(D.INFLIGHT_TYPE) == "spillable":
            kw["spool_dir"] = os.path.join(cfg.get(D.CHECKPOINT_DIR),
                                           "spill")
            kw["spill_policy"] = cfg.get(D.INFLIGHT_SPILL_POLICY)
            kw["spill_host_budget_epochs"] = cfg.get(
                D.INFLIGHT_HOST_BUDGET_EPOCHS)
        if cfg.contains(D.CHECKPOINT_DIR):
            kw["checkpoint_dir"] = cfg.get(D.CHECKPOINT_DIR)
        if cfg.get(D.AUDIT_ENABLED):
            kw["audit"] = True
            kw["audit_on_divergence"] = cfg.get(D.AUDIT_ON_DIVERGENCE)
        if cfg.get(D.PROFILE_ENABLED) and not _prof.get_profiler().enabled:
            _prof.configure_profile()
        if cfg.get(D.TRACING_ENABLED) and not get_tracer().enabled:
            trace_dir = cfg.get(D.TRACE_DIR)
            os.makedirs(trace_dir, exist_ok=True)
            configure_tracer(
                "runner", path=os.path.join(trace_dir, "trace-runner.jsonl"),
                buffer=cfg.get(D.TRACE_BUFFER_EVENTS))
        kw.update(overrides)
        runner = cls(job, device=device, **kw)
        runner.coordinator.backoff_multiplier = cfg.get(
            D.CHECKPOINT_BACKOFF_MULTIPLIER)
        return runner

    def attach_file_sink(self, vertex_id: int, root: str, token: int = 0):
        """Back a transactional sink with durable part files
        (``runtime/filesink.py``): pendings persist at every seal, and here
        for epochs already sealed; commits are atomic renames, and stale
        pendings at or below ``token`` are swept here. On a mesh every
        rank calls it with the same root."""
        from clonos_tpu_torch.runtime.filesink import FileSystemSink
        if vertex_id not in self.txn_logs:
            raise ValueError(
                f"vertex {vertex_id} is not a transactional sink")
        # On a mesh every rank attaches to the shared root and writes,
        # commits and sweeps only the part files of its own subtasks.
        fs = FileSystemSink(root, token=token,
                            subtasks=self._txn_subtasks(vertex_id))
        tl = self.txn_logs[vertex_id]
        tl.pre_committer = fs.write_pending
        tl.committer = fs.commit
        fs.sweep_pending(keep_epochs=tl.pending_epochs())
        # Epochs sealed before the sink was attached (a standby rebuild
        # seals its replayed epochs) persist their pendings under this
        # token now, so their commit finds them.
        for e in tl.sealed_epochs():
            fs.write_pending(e, tl.pending_shards(e))
        return fs

    @property
    def audit_stats(self) -> Dict[str, int]:
        return {"epochs-sealed": self._m_audit_sealed.value,
                "epochs-validated": self._m_audit_matches.value,
                "divergences": self._m_audit_div.value}

    def per_shard_health(self) -> Optional[np.ndarray]:
        """int32 ``[n_shards, 3]`` (records, live log rows, live ring
        slots) per task-axis shard, cached per epoch. None without a mesh.
        The fence and the recovery refresh it on every rank; a call in a
        later epoch computes it, a collective, so every rank must make
        it."""
        if self.mesh is None:
            return None
        if self._shard_health_epoch != self.executor.epoch_id \
                or self._shard_health is None:
            self._refresh_shard_health()
        return self._shard_health.wait()

    def _refresh_shard_health(self) -> None:
        """The per-shard sums (one all-reduce, in lockstep on every rank),
        copied to the host behind the work that made them (no sync)."""
        self._shard_health = _device.HostCopy(
            self.executor._per_shard_health())
        self._shard_health_epoch = self.executor.epoch_id

    def _spill_reading(self, key: str) -> int:
        """One ``spill.*`` gauge: this rank's stores."""
        ex = self.executor
        if key in _SPILL_OCCUPANCY:
            return ex.spill_occupancy()[key]
        return ex.spill_stats().get(key, 0)

    def _refresh_spill_by_rank(self) -> None:
        """Every rank's tier readings (occupancy and every movement
        counter), gathered in lockstep on the driving thread's host group
        at a fence or a recovery: what ``spill.total.*`` and
        :meth:`spill_by_rank` read."""
        ex = self.executor
        if ex.spill_logs is None or ex.compiled.n_shards == 1:
            return
        from clonos_tpu_torch.parallel import distributed as dist_
        mine = dict(ex.spill_occupancy(), **ex.spill_stats())
        self._spill_by_rank = dist_.all_gather_object(
            mine, self.mesh, ex.compiled.task_axis, group=ex._host_group)

    def spill_by_rank(self) -> Optional[List[Dict[str, int]]]:
        """Every rank's tier readings as the last fence or recovery
        gathered them (None without spill on a multi-rank mesh)."""
        return self._spill_by_rank

    def _spill_total(self, key: str) -> Optional[int]:
        rows = self._spill_by_rank
        return None if rows is None else sum(r.get(key, 0) for r in rows)

    def _completion_gate(self, cid: int) -> None:
        """The first completion listener on a multi-rank mesh: rank 0
        completes a checkpoint only once it is durable there (its write
        returned), and every rank completes the same ones in the same
        order on the driving thread (``ack_all`` at the fence or the
        join). Here each rank learns rank 0's completion of ``cid`` (one
        broadcast on the host group), so no rank commits a transaction,
        a feed offset or a truncation for a checkpoint that a restore
        could still miss."""
        from clonos_tpu_torch.parallel import distributed as dist_
        ex = self.executor
        got = dist_.broadcast_int(cid if self.rank == 0 else None, self.mesh,
                                  ex.compiled.task_axis,
                                  group=ex._host_group)
        if got != cid:
            raise RuntimeError(f"checkpoint {cid} completed on rank "
                               f"{self.rank}, but rank 0 completed {got}")

    def _shard_gauge(self, i: int, col: int) -> Optional[int]:
        """One ``shard.<i>.*`` gauge: the cached ``[n, 3]``, never
        computed here."""
        h = self._shard_health
        return None if h is None else int(h.wait()[i, col])

    def _inflight_occupancy(self) -> float:
        """Fraction of the in-flight rings' capacity holding un-truncated
        steps (rises when checkpoint completion lags the fences)."""
        if not self.executor.carry.out_rings:
            return 0.0
        cap = self.executor.compiled.inflight_ring_steps
        held = self.global_step - self._ring_tail_mirror
        return min(max(held, 0) / cap, 1.0)

    def _replay_lag_steps(self) -> int:
        """Supersteps a failure now would replay (the distance from the
        latest completed checkpoint's fence)."""
        ck = self.standbys.latest
        if ck is None:
            return self.global_step
        f = self._fence_step.get(ck.checkpoint_id + 1)
        return self.global_step - f if f is not None else 0

    def state_digest(self) -> str:
        """Canonical digest of the recoverable job state: operator states,
        log heads, each log's live row window and the record counts — sha1
        over the reference's bytes in the reference's order, so a rebuilt
        job (``bootstrap_standby``) reproduces the dead worker's digest at
        its last mirrored fence, and the two packages' digests of one
        state agree. One device-to-host copy, waited on this thread."""
        import hashlib
        c = self.executor.full_carry()
        ops, heads, tails, rows, counts = _device.HostCopy(
            (c.op_states, c.logs.head, c.logs.tail, c.logs.rows,
             c.record_counts)).wait()
        h = hashlib.sha1()
        for st in ops:
            for k in sorted(st):
                h.update(np.asarray(st[k]).tobytes())
        cap = rows.shape[1]
        h.update(heads.tobytes())
        for flat in range(rows.shape[0]):
            pos = np.arange(int(tails[flat]), int(heads[flat])) & (cap - 1)
            h.update(rows[flat][pos].tobytes())
        h.update(counts.tobytes())
        return h.hexdigest()

    # --- steady state --------------------------------------------------------

    def run_epoch(self, complete_checkpoint: bool = True,
                  overlap_fence: Optional[bool] = None) -> None:
        """Run to the next epoch fence and trigger its checkpoint.
        ``complete_checkpoint=False`` leaves it pending (no acks): logs and
        rings keep accumulating across epochs, and a failure before the
        next completion replays from the older checkpoint.

        ``overlap_fence`` (default: the runner's ``overlap_epoch``) selects
        the pipelined fence: the closed epoch's fence surface is captured
        without a host sync and its tail (health read, audit seal, ledger
        append, asynchronous checkpoint write) drains on one fence worker
        while the next epoch's compute runs; it joins at the next fence,
        where the deferred overflow check and the checkpoint ack run on
        this thread. ``drain_fence()`` settles it on demand."""
        if self.failed:
            raise rec.RecoveryError(
                f"cannot run with failed subtasks {sorted(self.failed)}; "
                f"call recover() first")
        overlap = (self.overlap_epoch if overlap_fence is None
                   else overlap_fence)
        if overlap and not self._fence_headroom_checked:
            self._check_fence_headroom()
        # A mode switch settles strictly, and so does spill: the tail's
        # worker (attach_spill_digests) and this epoch's spill hook share
        # the tiered stores, so the tail joins before this epoch's compute.
        if self._fence_tail is not None and (
                not overlap or self.executor.spill_logs is not None):
            self._join_fence_tail()
        ex = self.executor
        closed = ex.epoch_id
        n = ex.steps_per_epoch - ex.step_in_epoch
        tr = get_tracer()
        prof = self.profiler
        with tr.span("epoch", epoch=closed, steps=n):
            t0 = _time.monotonic()
            ex.run_epoch()
            if not overlap:
                # An enabled profiler waits for the card here, so
                # "compute" is the blocks' execution; never on the
                # pipelined path, whose overlap this wait would undo.
                prof.fence(ex.carry)
            steps_s = _time.monotonic() - t0
            self._m_epoch_steps_ms.update(steps_s * 1e3)
            tr.complete("epoch.steps", steps_s, epoch=closed, steps=n)
            prof.observe("compute", steps_s, kind=_prof.COMPUTE)
            # The previous epoch's tail overlapped this epoch's dispatch;
            # it joins before any of this fence's state is touched.
            self._join_fence_tail()
            t_fence = _time.monotonic()
            self.global_step += n
            self._fence_step[ex.epoch_id] = self.global_step
            self.heartbeats.beat_all_except(self.failed)
            self._m_steps.inc(n)
            self._m_epochs.inc()
            if self.latency is not None:
                self.latency.observe()
            if overlap:
                self._begin_fence_tail(closed, complete_checkpoint, prof)
            else:
                self._run_fence_tail_inline(closed, complete_checkpoint,
                                            t_fence, tr, prof)
            # Close the attribution window: FT seconds / (FT + compute)
            # since the previous fence.
            prof.rollup()
        if self.mesh is not None:
            self._refresh_shard_health()
            self._refresh_spill_by_rank()

    def step(self) -> None:
        if self.failed:
            raise rec.RecoveryError("failed subtasks present; recover() first")
        self.executor.step()
        self.global_step += 1
        self._m_steps.inc()
        self.heartbeats.beat_all_except(self.failed)

    def _absorb_fence_health(self, closed: int, vec: np.ndarray) -> int:
        """Fold one fence's health vector into the host mirrors: the
        heads at this fence ARE checkpoint ``closed``'s log heads. Returns
        the epoch's record delta."""
        nf = 4 + len(self.executor.carry.out_rings)
        total_records = int(vec[nf])
        with self._ck_heads_lock:
            self._ck_log_heads[closed] = vec[nf + 1:].astype(np.int64)
            while len(self._ck_log_heads) > 128:
                self._ck_log_heads.pop(next(iter(self._ck_log_heads)))
        delta = total_records - self._last_records_total
        self._m_records.mark(delta)
        self._last_records_total = total_records
        return delta

    def _sealed_channels(self, dg, group):
        """The sealed epoch's ``ring/`` and ``log/`` channel chains (what
        :meth:`LocalExecutor.attach_spill_digests` reads), from rank 0 to
        every rank on a mesh (one object broadcast over ``group``)."""
        chans = (None if dg is None else
                 {k: v for k, v in dg.channels.items()
                  if k.startswith(("ring/", "log/"))})
        if self.executor.compiled.n_shards > 1:
            from clonos_tpu_torch.parallel import distributed as dist_
            chans = dist_.broadcast_object(
                chans, self.mesh, self.executor.compiled.task_axis,
                group=group)
        return types.SimpleNamespace(channels=chans)

    def _sealed_parts(self, closed: int, group) -> Dict[int, Dict]:
        """Every transactional sink's sealed shards of epoch ``closed``,
        by vertex and global subtask; on a mesh each rank's gathered to
        rank 0 (one object gather over ``group``; the other ranks get
        {})."""
        mine = {vid: txl.pending_shards(closed)
                for vid, txl in self.txn_logs.items()}
        # Every rank runs the same job, so every rank skips alike.
        if self.executor.compiled.n_shards == 1 or not mine:
            return mine
        from clonos_tpu_torch.parallel import distributed as dist_
        got = dist_.gather_object(mine, self.mesh,
                                  self.executor.compiled.task_axis,
                                  group=group)
        if got is None:
            return {}
        return {vid: dict(sorted(
            (sub, recs) for part in got for sub, recs in part[vid].items()))
            for vid in mine}

    def _seal_and_trigger(self, closed: int, window_fn, snap_fn,
                          phases: Dict[str, float], prof, async_write: bool,
                          group=None) -> None:
        """The fence tail's persistence half, shared by both modes: audit
        seal over the closed epoch's causal surface, ledger append,
        checkpoint trigger. ``window_fn``/``snap_fn`` say where the state
        comes from (the live carry, or the pipelined capture), so the
        digests are byte-identical either way. One window extraction
        feeds the audit digest, the serve feeds and the lineage scan.
        ``group`` is the gloo group the calling thread's host exchanges
        use on a mesh (the driving thread's, or the fence worker's)."""
        win = (window_fn() if self.auditor.enabled or self.serve_feeds
               or self.lineage.enabled else None)
        # On a mesh the window gathered to rank 0, which seals, writes the
        # ledger and feeds the subscribers; every rank triggers the
        # checkpoint (the snapshot's gather is a collective).
        lead = self.rank == 0
        if self.auditor.enabled and lead:
            t = _time.monotonic()
            with prof.section("digest-seal"):
                dg = _audit.digest_epoch_window(closed, win,
                                                layout=self._audit_layout)
                self.auditor.seal(dg)
            phases["fence.digest-seal"] = (_time.monotonic() - t) * 1e3
            t = _time.monotonic()
            with prof.section("ledger-write"):
                self.coordinator.record_ledger(dg.to_entry())
            phases["fence.ledger-write"] = (_time.monotonic() - t) * 1e3
            self.epoch_tracker.notify_epoch_sealed(closed, dg)
            self._m_audit_sealed.inc()
        if self.auditor.enabled and self.executor.spill_logs is not None:
            # Segment index entries carry the ledger's fingerprints: on a
            # mesh rank 0 hands the sealed channels to every rank, which
            # stamps its own tiers.
            self.executor.attach_spill_digests(
                closed, self._sealed_channels(dg if lead else None, group))
        self.last_sealed_epoch = max(self.last_sealed_epoch, closed)
        tl = get_timeline()
        if tl.enabled:
            tl.record("epoch.seal", epoch=int(closed),
                      audited=bool(self.auditor.enabled))
        if self.serve_feeds and lead:
            t = _time.monotonic()
            for fn in list(self.serve_feeds):
                fn(closed, win)
            phases["fence.serve-feed"] = (_time.monotonic() - t) * 1e3
        # Lineage at the seal: scan the same window for dyed keys, and the
        # epoch's sealed transaction shards for the sink termini (sealed
        # before this seal, on the thread that runs it).
        if self.lineage.enabled:
            # (On a mesh the window reached rank 0 alone.)
            t = _time.monotonic()
            parts = self._sealed_parts(closed, group)
            if lead and win is not None:
                self.lineage.observe_epoch(
                    closed, win, num_key_groups=self.job.num_key_groups,
                    topology=self._lineage_topology, parts=parts)
            phases["fence.lineage-observe"] = (
                _time.monotonic() - t) * 1e3
        t = _time.monotonic()
        with prof.section("snapshot"):
            self.coordinator.trigger(closed, snap_fn(),
                                     async_write=async_write, owned=True)
            if async_write:
                # The worker makes its own write durable before it exits,
                # so completion (acked at the join) never fires on a
                # writer.
                self.coordinator.drain()
        phases["fence.snapshot"] = (_time.monotonic() - t) * 1e3

    def _append_source_fence_determinant(self, closed: int,
                                         phases: Dict[str, float],
                                         prof) -> None:
        """Every source logs the checkpoint-trigger arrival — after the
        fence capture / lean snapshot, so the checkpointed log heads stay
        at the fence (the rows belong to the new epoch)."""
        if not self._source_flats:
            return
        ex = self.executor
        t_ms = ex.step_input_history[-1][0] if ex.step_input_history else 0
        t = _time.monotonic()
        with prof.section("source-append"):
            ex.append_async_many(
                self._source_flats, det.SourceCheckpointDeterminant(
                    record_count=ex.global_record_stamp(),
                    checkpoint_id=closed, timestamp=t_ms))
            prof.fence(ex.carry.logs)
        phases["fence.source-append"] = (_time.monotonic() - t) * 1e3

    def _run_fence_tail_inline(self, closed: int, complete_checkpoint: bool,
                               t_fence: float, tr, prof) -> None:
        """The strict fence order (the sequential control): one health
        read (overflow flags, record total, fence log heads), audit seal +
        ledger + trigger, source fence determinants, then completion
        (which truncates)."""
        ex = self.executor
        phases: Dict[str, float] = {}
        t = _time.monotonic()
        with prof.section("health-read"):
            vec = ex.health_vector()
        phases["fence.health-read"] = (_time.monotonic() - t) * 1e3
        delta = self._absorb_fence_health(closed, vec)
        violations = ex.overflow_messages(vec)
        if violations:
            raise OverflowError_("; ".join(violations))
        self.epoch_tracker.inc_record_count(delta)
        self.epoch_tracker.start_new_epoch(ex.epoch_id)
        self._seal_and_trigger(
            closed, lambda: ex.epoch_window(closed),
            lambda: self._fence_snapshot(closed), phases, prof,
            async_write=False, group=ex._host_group)
        self._append_source_fence_determinant(closed, phases, prof)
        self._seal_txns(closed)
        # Before completion: ack_all truncates the logs and rings.
        for hook in self.fence_hooks:
            hook(closed)
        if complete_checkpoint:
            self.coordinator.ack_all(closed)
        fence_s = _time.monotonic() - t_fence
        phases["fence-tail"] = fence_s * 1e3
        self.last_fence_phases = phases
        self._m_epoch_fence_ms.update(phases["fence-tail"])
        tr.complete("epoch.fence", fence_s, epoch=closed)

    def _check_fence_headroom(self) -> None:
        """The pipelined fence defers the overflow check to the next
        fence, so the in-flight rings must absorb one extra epoch before
        they wrap; asserted once. Spilled rings are exempt: a wrap is
        what spill serves."""
        self._fence_headroom_checked = True
        rings = self.executor.carry.out_rings
        if not rings or self.executor.spill_logs is not None:
            return
        min_steps = min(r.ring_steps for r in rings)
        spe = self.executor.steps_per_epoch
        if min_steps < 2 * spe:
            raise ValueError(
                f"overlap_epoch needs one epoch of ring headroom: "
                f"inflight_ring_steps={min_steps} < 2*steps_per_epoch="
                f"{2 * spe} — raise inflight_ring_steps or use the "
                f"sequential fence (overlap_epoch=False)")

    def _begin_fence_tail(self, closed: int, complete_checkpoint: bool,
                          prof) -> None:
        """Capture this fence's state and hand the tail to the fence
        worker. The capture window makes no host sync: every device-to-
        host copy starts here, on the thread that queues the blocks, and
        the worker only waits for those copies."""
        ex = self.executor
        t = _time.monotonic()
        phases: Dict[str, float] = {}
        # clonos: overlap-window-begin
        handles = ex.capture_fence(
            with_window=self.auditor.enabled or bool(self.serve_feeds)
            or self.lineage.enabled)
        storage = self.coordinator.storage
        if self.mesh is not None:
            # This rank's shards on their way to the host (its lanes' feed
            # offsets staged from them); the worker gathers them to rank 0
            # over the fence group.
            snap = _device.HostCopy(self._stage_feed_offsets(
                closed, ex.local_lean_snapshot()))
        elif storage.wants_host:
            snap = _device.HostCopy(
                self._stage_feed_offsets(closed, ex.lean_snapshot()))
        else:
            # A device-diffing storage dispatches its diff here; its one
            # packed read waits for the join.
            snap = self._stage_feed_offsets(closed, ex.lean_snapshot())
            snap = storage.stage(snap, closed) or snap
        self._append_source_fence_determinant(closed, phases, prof)
        # clonos: overlap-window-end
        for hook in self.fence_hooks:
            hook(closed)
        pre_ms = (_time.monotonic() - t) * 1e3
        phases["fence.capture"] = max(
            0.0, pre_ms - phases.get("fence.source-append", 0.0))
        tail = {"epoch": closed, "complete": complete_checkpoint,
                "handles": handles, "snap": snap, "phases": phases,
                "pre_ms": pre_ms, "vec": None, "err": None}
        th = threading.Thread(target=self._fence_worker, args=(tail,),
                              name="fence-tail", daemon=True)
        tail["thread"] = th
        self._fence_tail = tail
        th.start()

    def _fence_worker(self, tail: dict) -> None:
        """The fence tail off the critical path: drain the health copy,
        fold the host mirrors, advance the epoch tracker, then seal +
        ledger + checkpoint from the captured handles, and wait out its
        own asynchronous write. Host work only: it queues nothing on the
        card. Errors are held and raised at the join, where the deferred
        overflow check and the ack also run (on the main thread)."""
        closed = tail["epoch"]
        phases = tail["phases"]
        try:
            t = _time.monotonic()
            vec = tail["handles"].health()
            phases["fence.health-read"] = (_time.monotonic() - t) * 1e3
            tail["vec"] = vec
            # The epoch's sink emissions are host copies the main thread
            # started; the seal waits for them here, off its path.
            self._seal_txns(closed)
            delta = self._absorb_fence_health(closed, vec)
            self.epoch_tracker.inc_record_count(delta)
            # By value: the main thread may have rolled further epochs.
            self.epoch_tracker.start_new_epoch(closed + 1)
            # No profiler sections here: the join observes this tail's
            # phases under their section names on the main thread.
            snap_fn = ((lambda: self.executor.gather_snapshot(
                tail["snap"].wait())) if self.mesh is not None
                else (lambda: tail["snap"]))
            self._seal_and_trigger(closed, tail["handles"].window, snap_fn,
                                   phases, _prof.NullProfiler(),
                                   async_write=True,
                                   group=self.executor._fence_group)
        except BaseException as e:      # raised at the join
            tail["err"] = e

    def _join_fence_tail(self) -> None:
        """Join the in-flight fence tail (main thread only: the deferred
        overflow check, and the checkpoint ack whose completion listeners
        replace ``executor.carry``). Closes the tail's attribution: the
        sub-spans keep their true walls, ``fence-tail`` is the wall the
        main thread paid (capture + join), and the difference is
        ``fence.overlap-saved``."""
        tail = self._fence_tail
        if tail is None:
            return
        self._fence_tail = None
        t = _time.monotonic()
        if isinstance(tail["snap"], cp.StagedWrite):
            # The staged write's host read and copies belong to this
            # thread; the worker's write waits for them.
            tail["snap"].finish()
        tail["thread"].join()
        joined_ms = (_time.monotonic() - t) * 1e3
        phases = tail["phases"]
        tail_ms = tail["pre_ms"] + joined_ms
        spans = sum(v for k, v in phases.items() if k.startswith("fence."))
        saved = max(0.0, spans - tail_ms)
        phases["fence-tail"] = tail_ms
        phases["fence.overlap-saved"] = saved
        self.fence_overlap_saved_total_ms += saved
        self.last_fence_phases = phases
        prof = self.profiler
        for key, section in (("fence.health-read", "health-read"),
                             ("fence.digest-seal", "digest-seal"),
                             ("fence.ledger-write", "ledger-write"),
                             ("fence.snapshot", "snapshot")):
            if key in phases:
                prof.observe(section, phases[key] / 1e3)
        self._m_epoch_fence_ms.update(tail_ms)
        get_tracer().complete("epoch.fence", tail_ms / 1e3,
                              epoch=tail["epoch"])
        if tail["err"] is not None:
            raise tail["err"]
        violations = self.executor.overflow_messages(tail["vec"])
        if violations:
            raise OverflowError_(
                f"deferred fence check (pipelined fence, epoch "
                f"{tail['epoch']}): " + "; ".join(violations))
        if tail["complete"]:
            self.coordinator.ack_all(tail["epoch"])

    def fence_tail_in_flight(self) -> bool:
        """True while a pipelined fence tail is still unjoined."""
        return self._fence_tail is not None

    def drain_fence(self) -> None:
        """Settle the pipelined fence: join the in-flight tail (its
        deferred overflow check and ack) and wait out asynchronous
        checkpoint writes. Afterwards ledger, completion and truncation
        match a sequential run at the same fence."""
        self._join_fence_tail()
        self.coordinator.drain()

    def _update_ring_mirror(self, completed_epoch: int) -> None:
        """Checkpoint-completion hook: advance the host ring-tail mirror
        to the completed epoch's end fence (as ``ifl.truncate`` does). A
        completion whose fence the runner never saw invalidates it."""
        f = self._fence_step.get(completed_epoch + 1)
        if f is None:
            self._ring_mirror_valid = False
        else:
            self._ring_tail_mirror = max(self._ring_tail_mirror, f)
        # Recovery restores only from the latest completed checkpoint.
        with self._ck_heads_lock:
            self._ck_log_heads = {k: v for k, v in self._ck_log_heads.items()
                                  if k >= completed_epoch}

    # --- failure injection ---------------------------------------------------

    def _vertex_of(self, flat: int) -> Tuple[int, int]:
        for v in self.job.vertices:
            base = self.job.subtask_base(v.vertex_id)
            if base <= flat < base + v.parallelism:
                return v.vertex_id, flat - base
        raise ValueError(f"no subtask {flat}")

    def inject_failure(self, flat_subtasks: Sequence[int]) -> None:
        """Kill subtasks: zero their operator-state row, causal log row,
        held replica rows and their lane of the vertex's in-flight ring.
        A pipelined fence tail in flight is joined first (its seal and ack
        land), so the kill sees a completed fence or a pending one."""
        self._join_fence_tail()
        ex = self.executor
        c = ex.carry
        for flat in flat_subtasks:
            self.failed.add(flat)
            self.heartbeats.mark_dead(flat)
            c = self._killed(c, flat)
        ex.carry = c

    def _killed(self, c: JobCarry, flat: int) -> JobCarry:
        """``c`` with subtask ``flat``'s device state zeroed. On a mesh
        each rank zeroes the pieces of the subtask it holds (its vertex
        block, log block and replica block, at local rows)."""
        compiled = self.executor.compiled
        llo, lhi = compiled.lblock
        rlo, rhi = compiled.rblock
        vid, sub = self._vertex_of(flat)
        vlo, vhi = compiled.vblock[vid]
        fresh = clog.create(compiled.log_capacity, compiled.max_epochs,
                            self.device)

        def put(stack, rows, one):
            stack = stack.clone()
            stack[rows] = one
            return stack

        ops = list(c.op_states)
        logs, rc = c.logs, c.record_counts
        rings = list(c.out_rings)
        if vlo <= sub < vhi:
            ops[vid] = tree_map(lambda x: put(x, sub - vlo, 0), ops[vid])
            if vid in compiled.ring_index:
                ri = compiled.ring_index[vid]
                el = rings[ri]
                lane = (slice(None), sub - vlo)
                rings[ri] = el._replace(
                    keys=put(el.keys, lane, 0),
                    values=put(el.values, lane, 0),
                    timestamps=put(el.timestamps, lane, 0),
                    valid=put(el.valid, lane, False))
        if llo <= flat < lhi:
            logs = tree_map(lambda s_, fr: put(s_, flat - llo, fr),
                            c.logs, fresh)
            rc = put(c.record_counts, flat - llo, 0)
        held = [r - rlo for r in self.plan.replicas_held_by(flat)
                if rlo <= r < rhi]
        replicas = c.replicas
        if held:
            idx = _device.upload(np.asarray(held, np.int64), self.device)
            replicas = tree_map(lambda s_, fr: put(s_, idx, fr),
                                c.replicas, fresh)
        return c._replace(op_states=tuple(ops), logs=logs,
                          replicas=replicas, out_rings=tuple(rings),
                          record_counts=rc)

    def detect_failures(self) -> List[int]:
        return self.heartbeats.expired()

    # --- recovery ------------------------------------------------------------

    def recover(self, drill: bool = False,
                host_rows: Optional[Dict[int, Tuple[np.ndarray, int]]]
                = None,
                overlap_finalize: Optional[bool] = None,
                pre_patch_join: Optional[Callable[[], None]] = None
                ) -> RecoveryReport:
        """:meth:`_recover_impl`, which lands an incident bundle
        (obs/incident.py) when the protocol itself fails: a recovery that
        cannot complete is the moment its evidence (ledgers, determinant
        windows, the timeline) is about to become unreachable. A plain
        pass-through while the incident plane is off."""
        try:
            with _RecoverySpans(drill, self.device) as ph:
                return self._recover_impl(
                    ph, drill=drill, host_rows=host_rows,
                    overlap_finalize=overlap_finalize,
                    pre_patch_join=pre_patch_join)
        except Exception as e:
            obs_incident.get_incidents().signal(
                "recovery.failure",
                epoch=int(getattr(self.auditor, "last_epoch", -1)),
                error=f"{type(e).__name__}: {str(e)[:200]}",
                drill=bool(drill),
                failed=sorted(self.failed))
            raise

    def _recover_impl(self, ph: "_RecoverySpans", drill: bool = False,
                      host_rows: Optional[Dict[int, Tuple[np.ndarray, int]]]
                      = None,
                      overlap_finalize: Optional[bool] = None,
                      pre_patch_join: Optional[Callable[[], None]] = None
                      ) -> RecoveryReport:
        """Run the causal-recovery protocol for all failed subtasks, in
        topological order.

        ``drill=True`` (failover rehearsal) runs the identical replay but
        makes none of the failure-handling decisions: pending checkpoints
        are not ignored, no IGNORE_CHECKPOINT determinants are logged and
        the checkpoint interval is not backed off — so the job state is
        unchanged afterwards.

        ``host_rows`` maps flat subtask -> (rows, abs_start): determinants
        from outside the card (a standby host's mirror) in place of the
        replica fetch for those subtasks.

        ``overlap_finalize`` (default: the runner's ``overlap_recovery``)
        drains the final packed read on a worker thread while this thread
        runs the audit validator; the join and the deferred asserts run
        before revive, and an audit divergence is raised after revive —
        the order of the sequential control (``False``: barrier read,
        state verify, revive, audit).

        ``pre_patch_join`` is called once just before the first patch (the
        earliest read of the roll-gap ledger); its blocked wall is billed
        to ``finalize.listener-reattach``. ``ph`` opens the recovery's
        spans and sums its ``phase_ms``."""
        if not self.failed:
            raise rec.RecoveryError("no failed subtasks")
        if self.mesh is not None:
            return self._recover_mesh(ph, drill, host_rows, pre_patch_join)
        t0, failed, ignored = self._recovery_prologue(drill, ph)
        ex = self.executor
        ckpt = self.standbys.latest
        from_epoch = ckpt.checkpoint_id + 1
        fence = self._fence_step[from_epoch]
        n_steps = self.global_step - fence
        snap: LeanSnapshot = self._on_device(ckpt.carry)
        restore_bytes = 0
        checkpoint_bytes = (int(ckpt.size_bytes or 0)
                            or cp.carry_nbytes(ckpt.carry))
        phases = ph.phases

        patched = ex.carry
        nrings = len(patched.out_rings)
        bounds_dev = self._ring_bounds_dev()
        if self._ring_mirror_valid:
            # Heads advance once per executed superstep.
            self._bounds_cache = {
                ri: (self._ring_tail_mirror, ex._steps_executed)
                for ri in range(nrings)}
        else:
            barr = (_device.to_numpy(bounds_dev) if nrings
                    else np.zeros((0, 2), np.int32))
            self._bounds_cache = {ri: (int(barr[ri, 0]), int(barr[ri, 1]))
                                  for ri in range(nrings)}
        self._route_cache = {}
        self._route_cache_hits = 0
        self._spill_cache = {}
        vid_failed_counts: Dict[int, int] = {}
        for flat in failed:
            v_of = self._vertex_of(flat)[0]
            vid_failed_counts[v_of] = vid_failed_counts.get(v_of, 0) + 1
        prev_vid = None
        ph.enter("fetch_determinants")

        # ---- phase A: determinant metadata for every failed subtask ----
        # Dispatch every device parse/meta up front, then pay at most ONE
        # host read. Subtasks whose cleanness the host derives itself (no
        # async rows since the fence, fence heads in hand) skip even that:
        # their metadata becomes deferred asserts in the final read.
        with self._ck_heads_lock:
            ck_heads = self._ck_log_heads.get(ckpt.checkpoint_id)
        prep: Dict[int, Dict[str, Any]] = {}
        slow_reads: List[Tuple[int, str, torch.Tensor]] = []
        for flat in failed:
            if host_rows is not None and flat in host_rows:
                prep[flat] = {"holders": [], "fast": False, "host": True}
                continue
            vid_a, _ = self._vertex_of(flat)
            holders_a = [(r, h) for r, (o, h) in enumerate(self.plan.pairs)
                         if o == flat and h not in self.failed]
            p: Dict[str, Any] = {"holders": holders_a}
            op_a = self.job.vertices[vid_a].operator
            eligible = (bool(holders_a) and n_steps > 0
                        and op_a.replay_pad_safe
                        and not isinstance(op_a, HostFeedSource)
                        and n_steps <= self._pad_steps())
            if eligible:
                t_d, r_d, e_d, small_d = self._device_parse(
                    patched.replicas, holders_a[0][0], from_epoch)
                p["det_device"] = (t_d, r_d, e_d)
                p["small_d"] = small_d
            if holders_a:
                p["meta_d"] = self._fetch_meta(
                    patched.replicas, [r for r, _ in holders_a], from_epoch)
            p["fast"] = (eligible and ck_heads is not None
                         and vid_a not in self.txn_logs
                         and ex.async_rows_since(flat, from_epoch) == 0)
            if not p["fast"]:
                for kind in ("small", "meta"):
                    if f"{kind}_d" in p:
                        slow_reads.append((flat, kind, p[f"{kind}_d"]))
            prep[flat] = p
        slow_vals: Dict[Tuple[int, str], np.ndarray] = {}
        if slow_reads:
            packed = _device.to_numpy(torch.cat(
                [d.reshape(-1).to(torch.int32) for _f, _k, d in slow_reads]))
            off = 0
            for flat, kind, d in slow_reads:
                slow_vals[(flat, kind)] = packed[off:off + d.numel()] \
                    .reshape(tuple(d.shape))
                off += d.numel()

        managers: List[rec.RecoveryManager] = []
        total_dets = 0
        total_records = 0
        for flat in failed:
            ph.enter("fetch_determinants")
            vid, sub = self._vertex_of(flat)
            if vid != prev_vid:
                # Routed windows are final only once the upstream rings
                # they read are (upstreams were patched earlier in topo
                # order): share them within one vertex's consumers, and
                # only under a byte budget for the all-lane blocks.
                self._route_cache = {}
                share = vid_failed_counts[vid] >= 2
                if share and n_steps > 0:
                    ch_ = self._recovery_ch
                    est = sum(
                        -(-n_steps // ch_) * ch_
                        * self.job.vertices[self.job.edges[e2].dst]
                        .parallelism * self.job.edges[e2].capacity * 4 * 4
                        for e2 in self.job.in_edges(vid))
                    share = est <= (1 << 30)
                self._route_cache_enabled = share
                prev_vid = vid
            mgr = self._recovery_manager(vid, sub, flat)
            managers.append(mgr)
            in_edges = self.job.in_edges(vid)
            out_edges = self.job.out_edges(vid)

            p = prep[flat]
            holders = p["holders"]
            fast = p["fast"]
            synthesized = False
            if p.get("host"):
                # Mirror-sourced determinants: everything after the fetch
                # (merge, replay, verify, patch) is the same.
                rows_h, start_h = host_rows[flat]
                mgr.expect_determinant_responses(1)
                mgr.notify_determinant_response(
                    np.asarray(rows_h, np.int32), int(start_h))
            elif not holders and n_steps > 0:
                if out_edges:
                    raise rec.RecoveryError(
                        f"subtask {flat}: no surviving replica holds its "
                        f"determinant log (sharing depth / replication "
                        f"factor too shallow for this failure pattern)")
                # Pure sink: nobody replicates its log. Its inputs replay
                # exactly from the upstream ring; its step inputs are
                # re-synthesized from the input ledger.
                synthesized = True
            r_best = None
            det_device = None
            clean_n = None
            clean_start = 0
            if fast:
                # Zero async rows since the fence: the log holds exactly
                # n_steps sync blocks from the checkpointed head.
                det_device = p["det_device"]
                clean_n, clean_start = (DETS_PER_STEP * n_steps,
                                        int(ck_heads[flat]))
                r_best = holders[0][0]
                mgr.expect_determinant_responses(1)
                mgr.notify_determinant_response(
                    np.zeros((0, det.NUM_LANES), np.int32), clean_start)
            elif holders:
                # Holders are bit-identical replicas by construction: when
                # their metadata agrees, pull one body (or none, when the
                # device parse says the stream is pure sync rows).
                meta = slow_vals[(flat, "meta")]
                consistent = (len(np.unique(meta[:, 0])) == 1
                              and len(np.unique(meta[:, 1])) == 1)
                if consistent and (flat, "small") in slow_vals:
                    cnt_s, start_s, nanch, cleanflag = (
                        int(x) for x in slow_vals[(flat, "small")])
                    if cleanflag and nanch == n_steps:
                        det_device = p["det_device"]
                        clean_n, clean_start = cnt_s, start_s
                        mgr.expect_determinant_responses(1)
                        mgr.notify_determinant_response(
                            np.zeros((0, det.NUM_LANES), np.int32), start_s)
                if det_device is None:
                    use = [holders[0]] if consistent else holders
                    mgr.expect_determinant_responses(len(use))
                    for j, (r, _h) in enumerate(use):
                        mgr.notify_determinant_response(
                            self._fetch_rows(patched.replicas, r, from_epoch,
                                             int(meta[j, 0])),
                            int(meta[j, 1]))
                # A consistent replica's device bytes restore the log.
                r_best = holders[0][0] if consistent else None
            elif not p.get("host"):
                mgr.expect_determinant_responses(0)
            if synthesized:
                rows = self._synthesize_det_rows(fence, n_steps)
                start = (int(ck_heads[flat]) if ck_heads is not None
                         else int(snap.log_heads[flat]))
            elif det_device is not None:
                rows = np.zeros((0, det.NUM_LANES), np.int32)
                start = clean_start
            else:
                rows, start = mgr.merged_determinants()
            n_rows = clean_n if clean_n is not None else len(rows)
            total_dets += n_rows
            # ``host_rows``: fetched to the host (a replica's body, a
            # mirror's rows) for the replay to parse there.
            ph.count({"rows": n_rows, "host_rows": 0 if (
                det_device is not None or synthesized) else n_rows})
            ph.enter("inputs")

            # Lost inputs: the checkpointed edge buffer + the upstream
            # ring re-routed into this lane. An upstream lane zeroed by a
            # connected failure was rebuilt earlier in this loop.
            # Both edges of a two-input vertex; a host-fed source
            # re-reads its feed.
            v = self.job.vertices[vid]
            input_steps = None
            if isinstance(v.operator, TwoInputOperator):
                input_steps = list(zip(*(
                    self._replay_inputs(patched, snap, e, sub, fence,
                                        n_steps) for e in in_edges)))
            elif in_edges:
                input_steps = self._replay_inputs(patched, snap, in_edges[0],
                                                  sub, fence, n_steps)
            elif isinstance(v.operator, HostFeedSource) and n_steps > 0:
                input_steps = self._reread_feed(
                    vid, sub, int(_device.to_numpy(
                        snap.op_states[vid]["offset"][sub])),
                    rows, n_steps)
            ph.enter("replay")

            plan = rec.ReplayPlan(
                vertex_id=vid, subtask=sub, flat_subtask=flat,
                from_epoch=from_epoch, input_steps=input_steps,
                det_rows=rows, det_start=start,
                checkpoint_op_state=snap.op_states[vid],
                n_steps=n_steps, verify_outputs=not synthesized,
                det_device=det_device)
            restore_bytes += rec.plan_restore_nbytes(plan)
            # Fast path: dispatch only; verification and the consumed
            # total ride the final packed read.
            result = mgr.run_replay(plan, self.device, defer_sync=fast)
            if not result.deferred:
                total_records += result.records_replayed
            ph.count({"steps": n_steps, "inputs": len(in_edges),
                      "rows": (n_rows if det_device is not None
                               else len(result.rebuilt_log_rows)),
                      "async": len(result.async_events)})
            # Recovered timers re-run their callbacks (the rows are back
            # in the rebuilt log already).
            svc = self.timer_services.get(flat)
            if svc is not None and not drill:
                for _step_i, ad in result.async_events:
                    if isinstance(ad, det.TimerTriggerDeterminant):
                        svc.refire(ad)
            # A transactional sink's pending shards died with the task:
            # rebuild them from the replayed outputs before any commit.
            if vid in self.txn_logs and n_steps > 0:
                self.txn_logs[vid].drop_uncommitted_shards(sub)
                self._rebuild_txn_shards(vid, sub, result, from_epoch,
                                         fence, n_steps)
            ph.enter("patch")

            rebuilt = self._check_rebuilt(flat, result, rows, synthesized)
            if pre_patch_join is not None:
                # The wait is not the patch's.
                with ph.aside("finalize.listener-reattach"):
                    pre_patch_join()
                pre_patch_join = None
            patched = self._patch(
                patched, snap, vid, sub, flat, result, rebuilt, from_epoch,
                fence, n_steps, replica_src=r_best, det_n=clean_n,
                clean_sync=det_device is not None,
                ck_head=(int(ck_heads[flat]) if ck_heads is not None
                         else None))

        ph.enter("replica_rebuild")
        # Replica rows the revived subtasks held: replicas equal their
        # owner's log by construction, so copy the owner's (possibly just
        # restored) row — one batched scatter for the whole set.
        rs, os_ = [], []
        for flat in failed:
            for r in self.plan.replicas_held_by(flat):
                rs.append(r)
                os_.append(self.plan.pairs[r][0])
        if rs:
            ri_d = _device.upload(np.asarray(rs, np.int64), self.device)
            oi_d = _device.upload(np.asarray(os_, np.int64), self.device)

            def copy_rows(s, lg):
                s = s.clone()
                s[ri_d] = lg[oi_d]
                return s

            patched = patched._replace(replicas=tree_map(
                copy_rows, patched.replicas, patched.logs))
        ex.carry = patched
        self._bounds_cache = None
        self._route_cache = {}
        self._spill_cache = {}
        t_fin0 = ph.stop()

        # ---- final packed read: completion barrier + deferred asserts ----
        # One device->host copy closes the protocol: the restored log
        # heads, the ring bounds recovery routed against, and for every
        # fast-path subtask its parse/meta metadata, its output-cut flag
        # and its consumed total. Dispatched last, it is also the barrier.
        # ``finalize.barrier-read`` is the wait for it, ``finalize.state-
        # verify`` the host asserts; overlapped, the audit validator runs
        # inside the barrier window and ``finalize.overlap-saved`` carries
        # the credit (sum(finalize.*) - overlap-saved == finalize).
        overlap = (self.overlap_recovery if overlap_finalize is None
                   else bool(overlap_finalize))
        fast_mgrs = [m for m in managers if prep[m.flat_subtask]["fast"]]
        pieces = [torch.stack([patched.logs.head[f] for f in failed])
                  .to(torch.int32)]
        if nrings:
            pieces.append(bounds_dev.reshape(-1).to(torch.int32))
        for m in fast_mgrs:
            pf = prep[m.flat_subtask]
            pieces += [pf["small_d"].to(torch.int32),
                       pf["meta_d"].reshape(-1).to(torch.int32),
                       m.result.verify_ok_d.to(torch.int32).reshape(1),
                       m.result.consumed_d.to(torch.int32).reshape(1)]
        # Issued here, on the thread that queued the recovery's work; the
        # barrier worker only waits for this copy.
        final = _device.HostCopy(torch.cat(pieces))
        barrier: Dict[str, Any] = {"arr": None, "err": None, "ms": 0.0}

        def _drain_barrier() -> None:
            # On the worker too, a part of the recovery span.
            with ph.phase("finalize.barrier-read",
                          parent=ph.span_id) as lap:
                try:
                    barrier["arr"] = final.wait()
                except Exception as err:    # raised after the join
                    barrier["err"] = err
            barrier["ms"] = lap.ms

        def _audit() -> float:
            if not self.auditor.enabled:
                return 0.0
            with ph.phase("audit") as lap:
                self._validate_replayed(ex, range(from_epoch, ex.epoch_id))
            return lap.ms

        audit_ms = 0.0
        audit_err: Optional[Exception] = None
        if overlap:
            th = threading.Thread(target=_drain_barrier,
                                  name="recovery-finalize-barrier")
            th.start()
            # Revive stays after the join and the verify, as in the
            # control: a failed verify leaves the subtasks dead and the
            # recovery retryable. A divergence is held until after revive.
            t_a0 = _time.monotonic()
            try:
                audit_ms = _audit()
            except Exception as err:
                audit_err = err
                audit_ms = (_time.monotonic() - t_a0) * 1e3
            finally:
                th.join()
        else:
            _drain_barrier()
        if barrier["err"] is not None:
            raise barrier["err"]
        with ph.phase("finalize.state-verify") as lap:
            total_records += self._verify_final(
                barrier["arr"], failed, nrings, fast_mgrs, prep, ck_heads,
                n_steps)
        verify_ms = lap.ms
        # Not one interval: the tail's wall less the audit that ran
        # inside it, so a record of its measured length.
        fin_ms = (_time.monotonic() - t_fin0) * 1e3 - audit_ms
        phases["finalize"] = phases.get("finalize", 0.0) + fin_ms
        get_tracer().complete("recovery.finalize", fin_ms / 1e3,
                              drill=drill)
        self._revive(failed, drill)
        if overlap:
            if audit_err is not None:
                raise audit_err
            phases["finalize.overlap-saved"] = (
                phases.get("finalize.overlap-saved", 0.0)
                + max(0.0, barrier["ms"] + verify_ms - fin_ms))
        else:
            _audit()
        return self._close_recovery(
            ph, t0, failed_subtasks=failed, from_epoch=from_epoch,
            steps_replayed=n_steps, determinants_replayed=total_dets,
            records_replayed=total_records, ignored_checkpoints=ignored,
            managers=tuple(managers), phase_ms=phases, drill=drill,
            restore_bytes=restore_bytes, checkpoint_bytes=checkpoint_bytes)

    # --- the steps both recovery paths share ----------------------------------

    def _recovery_prologue(self, drill: bool, ph: "_RecoverySpans"
                           ) -> Tuple[float, Tuple[int, ...], Tuple[int, ...]]:
        """Join the pipelined fence (recovery never runs against a
        half-sealed tail), check there is a checkpoint to restore, open
        the recovery's spans (``ph``), order the failed subtasks
        topologically, and (not in a drill) ignore the checkpoints the
        dead never acked, back off the interval and have the healthy
        tasks log the ignore decision. Returns the recovery's start time,
        the ordered failed subtasks and the ignored checkpoints."""
        self._join_fence_tail()
        if not self.standbys.has_state():
            raise rec.RecoveryError(
                "no completed checkpoint to restore standbys from")
        if self.mesh is not None and not self._ring_mirror_valid:
            raise rec.RecoveryError("ring bound mirror invalid; a mesh "
                                    "recovery routes by the host mirror")
        ex = self.executor
        t0 = ph.begin()
        topo_pos = {vid: i for i, vid in enumerate(ex.compiled.topo)}
        failed = tuple(sorted(
            self.failed, key=lambda f: (topo_pos[self._vertex_of(f)[0]], f)))
        ignored: Tuple[int, ...] = ()
        if not drill:
            ignored = tuple(self.coordinator.ignore_unacked_for(set(failed)))
            self.coordinator.backoff()
            healthy = [f for f in range(self.job.total_subtasks())
                       if f not in self.failed]
            for cid in ignored:
                ex.append_async_many(healthy, det.IgnoreCheckpointDeterminant(
                    record_count=ex.global_record_stamp(),
                    checkpoint_id=cid))
        return t0, failed, ignored

    def _recovery_manager(self, vid: int, sub: int, flat: int
                          ) -> rec.RecoveryManager:
        """A failed subtask's recovery FSM, taken from standby to
        connections re-established and state restored."""
        mgr = rec.RecoveryManager(vid, sub, flat,
                                  self._make_replayer(vid, sub))
        in_edges = self.job.in_edges(vid)
        out_edges = self.job.out_edges(vid)
        mgr.notify_start_recovery(in_edges, out_edges)
        mgr.notify_state_restoration_complete()
        for e in in_edges:
            mgr.notify_new_input_channel(e)
        for e in out_edges:
            mgr.notify_new_output_channel(e)
        return mgr

    @staticmethod
    def _check_rebuilt(flat: int, result: rec.ReplayResult,
                       rows: np.ndarray, synthesized: bool) -> np.ndarray:
        """The replay's rebuilt log rows, which must equal the recovered
        determinant stream (not checked for a synthesized one)."""
        rebuilt = np.asarray(result.rebuilt_log_rows)
        if not synthesized and not result.rebuilt_is_view \
                and not np.array_equal(rebuilt, rows[:rebuilt.shape[0]]):
            raise rec.RecoveryError(
                f"subtask {flat}: replayed determinant stream diverges "
                f"from the recovered log")
        return rebuilt

    def _revive(self, failed: Tuple[int, ...], drill: bool) -> None:
        for flat in failed:
            self.heartbeats.revive(flat)
        self.failed.clear()
        if not drill:
            self.coordinator.reset_interval()

    def _validate_replayed(self, source: Any, epochs) -> None:
        """Recompute every replayed closed epoch's digest from ``source``
        (anything with ``epoch_window``) against the sealed ledger; the
        abort policy raises before the job resumes."""
        validator = rec.AuditValidator(
            source, self.coordinator.read_ledger(),
            on_divergence=self.auditor.on_divergence)
        self.last_audit = validator
        try:
            validator.validate(epochs)
        finally:
            self._m_audit_matches.inc(validator.stats["match"])
            self._m_audit_div.inc(validator.stats["divergence"])

    def _close_recovery(self, ph: "_RecoverySpans", t0: float,
                        **fields) -> RecoveryReport:
        """The recovery's report (``fields`` are its fields but the wall
        time), recorded with its metrics unless it was a drill, and its
        span closed."""
        ph.stop()
        report = RecoveryReport(
            recovery_ms=(_time.monotonic() - t0) * 1e3, **fields)
        if not report.drill:
            self.reports.append(report)
            self._m_recovery_ms.update(report.recovery_ms)
            self._m_recovered_records.inc(report.records_replayed)
            for pname, ms in report.phase_ms.items():
                self._mgroup.histogram(f"recovery.{pname}-ms").update(ms)
        ph.close(failed=list(report.failed_subtasks),
                 from_epoch=report.from_epoch,
                 steps_replayed=report.steps_replayed,
                 records_replayed=report.records_replayed)
        return report

    # --- recovery on a mesh ---------------------------------------------------

    def _vertex_ranks(self, vid: int, sub: int) -> List[int]:
        """Ranks holding subtask ``sub`` of vertex ``vid`` (every rank when
        the vertex does not split)."""
        comp = self.executor.compiled
        if not comp.sharded(vid):
            return list(range(comp.n_shards))
        p = self.job.vertices[vid].parallelism
        return [sub // (p // comp.n_shards)]

    def _row_ranks(self, row: int, size: int) -> List[int]:
        """Ranks holding row ``row`` of a leaf of ``size`` rows split by
        the rule table (every rank when it does not split)."""
        n = self.executor.compiled.n_shards
        if n == 1 or size % n:
            return list(range(n))
        return [row // (size // n)]

    def _host(self, tree):
        return _device.HostCopy(tree).wait()

    def _recover_mesh(self, ph: "_RecoverySpans", drill: bool = False,
                      host_rows: Optional[Dict[int, Tuple[np.ndarray, int]]]
                      = None,
                      pre_patch_join: Optional[Callable[[], None]] = None
                      ) -> RecoveryReport:
        """The recovery protocol on a mesh, run by every rank in lockstep.
        Each failed subtask replays on the rank that owns it (every rank,
        for a vertex that does not split):

        - rank 0 sends it the subtask's checkpoint slice
          (``snapshot_subtask_slice``), its edge-buffer rows, cursors and
          fence head;
        - the rank holding the first surviving replica of its log sends
          that replica row; the ranks holding the upstream ring's lanes
          send their steps of the replay window, the steps their ring no
          longer holds spliced in from their own spill tier
          (:meth:`_mesh_window`);
        - the owner replays (a host-fed source re-reads its own reader
          from the checkpointed offset), rebuilds a transactional sink's
          pending shards where it holds them, grafts the operator row and
          ring lane into its own shards, and sends the rebuilt log row
          and record count to the rank holding that row of the log block
          (:meth:`_mesh_replay`);
        - the replica rows the revived subtasks held are copied from their
          owners' log rows, rank to rank.

        A step that fails on one rank (a re-read below the feed's
        retention, a torn spill segment) fails on every rank at the same
        point (``distributed.agree``). No other rank's live shard is
        rewritten, and nothing gathers the whole carry. Not taken here:
        the device-resident fast path and the overlapped finalize.

        ``host_rows`` (a standby bootstrap's mirror rows, on every rank)
        stand in for the replica transfer: each owner takes its
        subtask's rows from them. ``pre_patch_join`` runs on every rank
        just before the first replay's patch. ``ph`` holds the spans and
        phase times."""
        from clonos_tpu_torch.parallel import distributed as dist_
        ex = self.executor
        comp = ex.compiled
        mesh, axis = self.mesh, comp.task_axis
        me, n = comp.shard, comp.n_shards
        t0, failed, ignored = self._recovery_prologue(drill, ph)
        ckpt = self.standbys.latest
        from_epoch = ckpt.checkpoint_id + 1
        fence = self._fence_step[from_epoch]
        n_steps = self.global_step - fence
        snap = ckpt.carry if me == 0 else None
        checkpoint_bytes = dist_.transfer(
            (int(ckpt.size_bytes or 0) or cp.carry_nbytes(ckpt.carry))
            if me == 0 else None, 0, range(n), mesh, axis)
        with self._ck_heads_lock:
            ck_heads = self._ck_log_heads.get(ckpt.checkpoint_id)
        ch = self._recovery_ch
        span = -(-n_steps // ch) * ch
        ring_lo = max(self._ring_tail_mirror,
                      ex._steps_executed - comp.inflight_ring_steps)
        self._bounds_cache = {ri: (self._ring_tail_mirror, ex._steps_executed)
                              for ri in range(len(comp.ring_vertices))}
        self._route_cache = {}
        self._route_cache_enabled = False
        self._route_cache_hits = 0
        llo, _ = comp.lblock
        rlo, _ = comp.rblock
        L, R = comp.L, max(self.plan.num_replicas, 1)
        carry = ex.carry
        managers: List[rec.RecoveryManager] = []
        restore_bytes = total_records = total_dets = 0
        self._spill_cache = {}
        for flat in failed:
            ph.enter("fetch_determinants")
            vid, sub = self._vertex_of(flat)
            owners = self._vertex_ranks(vid, sub)
            lead = me == owners[0]
            mine = me in owners
            in_edges = self.job.in_edges(vid)
            out_edges = self.job.out_edges(vid)
            # The checkpoint slice, from rank 0.
            piece = None
            if me == 0:
                ops = cp.snapshot_subtask_slice(snap, vid, sub)
                piece = self._host({
                    "op": ops,
                    "edge": {e: tuple(x[sub:sub + 1]
                                      for x in snap.edge_bufs[e])
                             for e in in_edges},
                    "rr": {e: snap.rr_offsets[e] for e in in_edges},
                    "rc": snap.record_counts[flat],
                    "head": snap.log_heads[flat]})
            piece = dist_.transfer(piece, 0, owners, mesh, axis)
            ck_head = (int(ck_heads[flat]) if ck_heads is not None
                       else int(piece["head"]) if mine else None)
            # The first surviving replica of its log, from its holder
            # (mirror rows, where given, take its place).
            host = (host_rows.get(flat) if host_rows is not None
                    else None)
            holders = [r for r, (o, h) in enumerate(self.plan.pairs)
                       if o == flat and h not in self.failed]
            replica = None
            if host is not None:
                pass
            elif holders:
                r0 = holders[0]
                src = self._row_ranks(r0, R)[0]
                one = (self._host(tree_map(lambda x: x[r0 - rlo],
                                           carry.replicas))
                       if me == src else None)
                replica = dist_.transfer(one, src, owners, mesh, axis)
            elif n_steps > 0 and out_edges:
                raise rec.RecoveryError(
                    f"subtask {flat}: no surviving replica holds its "
                    f"determinant log (sharing depth / replication "
                    f"factor too shallow for this failure pattern)")
            # The upstream rings' replay windows, lane blocks from their
            # ranks (upstreams failed earlier were rebuilt already).
            windows: Dict[int, RecordBatch] = {}
            for e in in_edges if n_steps > 0 else ():
                windows.update(self._mesh_window(
                    e, carry, owners, fence, n_steps, span, ring_lo))
            # An owner's inputs end inside _mesh_replay, where its replay
            # starts; the other ranks wait out the replay.
            ph.enter("inputs" if mine else "replay")
            # A feed whose one reader rank 0 holds: the owner sends it
            # the replayed steps' counts, and it sends back the re-read.
            feed_host = None
            if vid in ex._single_feeds and n_steps > 0:
                feed_host = self._mesh_reread(vid, sub, flat, owners, piece,
                                              replica, host, from_epoch,
                                              n_steps)
            log_piece = None
            err: Optional[BaseException] = None
            if pre_patch_join is not None:
                # The wait is not the replay's.
                with ph.aside("finalize.listener-reattach"):
                    pre_patch_join()
                pre_patch_join = None
            try:
                if mine:
                    carry, log_piece, mgr, rb, rec_n, n_dets = \
                        self._mesh_replay(
                            vid, sub, flat, piece, replica, windows, carry,
                            from_epoch, fence, n_steps, ck_head, ph,
                            drill, host, feed_host)
                    managers.append(mgr)
                    if lead:
                        restore_bytes += rb
                        total_records += rec_n
                        total_dets += n_dets
            except Exception as e:          # settled below, on every rank
                err = e
            # A replay that failed on its owner (a re-read below the
            # feed's retention) fails on every rank, here, before the
            # next transfer.
            dist_.agree(err, mesh, axis, group=ex._host_group)
            ph.enter("patch")
            # The rebuilt log row and record count, to the log block's rank.
            dsts = self._row_ranks(flat, L)
            log_piece = dist_.transfer(log_piece, owners[0], dsts, mesh, axis)
            if me in dsts:
                new = self._on_device(log_piece)
                put = functools.partial(_put_row, i=flat - llo)
                carry = carry._replace(
                    logs=tree_map(put, carry.logs, new["log"]),
                    record_counts=put(carry.record_counts,
                                      new["rc"].to(torch.int32)))
        ph.enter("replica_rebuild")
        # Replica rows the revived subtasks held: replicas equal their
        # owner's log by construction, so copy the owner's (possibly just
        # restored) row, from the rank holding it.
        for flat in failed:
            for r in self.plan.replicas_held_by(flat):
                o = self.plan.pairs[r][0]
                src = self._row_ranks(o, L)[0]
                dsts = self._row_ranks(r, R)
                if dsts == [src]:
                    # Owner row and replica row on one rank: on the device.
                    if me == src:
                        carry = carry._replace(replicas=tree_map(
                            functools.partial(_put_row, i=r - rlo),
                            carry.replicas,
                            tree_map(lambda x: x[o - llo], carry.logs)))
                    continue
                row = (self._host(tree_map(lambda x: x[o - llo], carry.logs))
                       if me == src else None)
                row = dist_.transfer(row, src, dsts, mesh, axis)
                if me in dsts:
                    carry = carry._replace(replicas=tree_map(
                        functools.partial(_put_row, i=r - rlo),
                        carry.replicas, self._on_device(row)))
        comp.constrain_carry(carry)
        ex.carry = carry
        self._bounds_cache = None
        self._spill_cache = {}
        ph.stop()
        sums = dist_.all_gather_object(
            (restore_bytes, total_records, total_dets), mesh, axis)
        restore_bytes, total_records, total_dets = (
            sum(x[k] for x in sums) for k in range(3))
        self._refresh_shard_health()
        self._refresh_spill_by_rank()
        self._revive(failed, drill)
        if self.auditor.enabled:
            # Every replayed closed epoch's window gathers to rank 0 (all
            # ranks take part), which validates them against its ledger.
            with ph.phase("audit"):
                wins = {e: ex.epoch_window(e)
                        for e in range(from_epoch, ex.epoch_id)}
                if me == 0:
                    self._validate_replayed(
                        types.SimpleNamespace(epoch_window=wins.__getitem__),
                        sorted(wins))
        return self._close_recovery(
            ph, t0, failed_subtasks=failed, from_epoch=from_epoch,
            steps_replayed=n_steps, determinants_replayed=total_dets,
            records_replayed=total_records, ignored_checkpoints=ignored,
            managers=tuple(managers), phase_ms=ph.phases, drill=drill,
            restore_bytes=restore_bytes, checkpoint_bytes=checkpoint_bytes)

    def _mesh_window(self, eidx: int, carry: JobCarry, owners: List[int],
                     fence: int, n_steps: int, span: int, ring_lo: int
                     ) -> Dict[int, RecordBatch]:
        """Edge ``eidx``'s producer ring steps ``[fence - 1, fence - 1 +
        span)`` over every producer lane, as ``{eidx: window}`` on the
        ranks in ``owners`` (empty elsewhere). Each rank holding producer
        lanes slices them from its ring and splices in, from its own
        spill tier, the steps the ring no longer holds (below
        ``ring_lo``); the pieces travel by transfer to the owners. A ring
        that does not split is every rank's, but spilled by rank 0 alone,
        which then sends the spliced window. A splice that fails on one
        rank (a torn segment) fails on every rank."""
        from clonos_tpu_torch.parallel import distributed as dist_
        ex = self.executor
        comp = ex.compiled
        mesh, axis = self.mesh, comp.task_axis
        me, n = comp.shard, comp.n_shards
        src_vid = self.job.edges[eidx].src
        ri = comp.ring_index[src_vid]
        spill = fence < ring_lo
        sharded = comp.sharded(src_vid)
        senders = (list(range(n)) if sharded
                   else [0] if spill else list(owners))
        local, err = None, None
        if me in senders:
            try:
                local = ifl.slice_steps_at(carry.out_rings[ri], fence - 1,
                                           span)
                if spill:
                    local = self._splice_spilled(
                        local, ri, src_vid, fence, fence - 1,
                        min(fence - 1 + span, ring_lo),
                        min(ring_lo, fence - 1 + n_steps))
            except Exception as e:          # settled below, on every rank
                err = e
        if spill:
            dist_.agree(err, mesh, axis, group=ex._host_group)
        elif err is not None:
            raise err
        if not sharded and not spill:
            return {eidx: local} if me in owners else {}
        parts = [dist_.transfer(self._host(local) if me == r else None, r,
                                owners, mesh, axis) for r in senders]
        if me not in owners:
            return {}
        return {eidx: RecordBatch(*(
            _device.upload(np.concatenate(f, axis=1), self.device)
            for f in zip(*parts)))}

    def _mesh_replay(self, vid: int, sub: int, flat: int, piece: dict,
                     replica, windows: Dict[int, RecordBatch],
                     carry: JobCarry, from_epoch: int, fence: int,
                     n_steps: int, ck_head: int, ph: "_RecoverySpans",
                     drill: bool, host=None, feed_host=None):
        """One failed subtask's replay on a rank that runs it
        (:meth:`_recover_mesh`): its determinants from ``host`` (mirror
        rows), else the transferred replica row (or synthesized, for a
        sink nobody replicates), its
        inputs from the transferred windows and checkpointed edge row, or
        for a host-fed source from this rank's reader at the checkpointed
        offset; recovered timers re-fired (not in a drill); a
        transactional sink's pending shards rebuilt where this rank holds
        them; the operator row and ring lane grafted into this
        rank's shards. Returns (carry, the rebuilt log row and record
        count on the first owner, else None, the manager, restore bytes,
        records and determinants replayed). Its inputs end and its replay
        starts at ``ph.enter("replay")``."""
        comp = self.executor.compiled
        v = self.job.vertices[vid]
        in_edges = self.job.in_edges(vid)
        lead = comp.shard == self._vertex_ranks(vid, sub)[0]
        mgr = self._recovery_manager(vid, sub, flat)
        synthesized = False
        one_dev = None
        if host is not None:
            # Mirror-sourced determinants (a standby bootstrap).
            mgr.expect_determinant_responses(1)
            mgr.notify_determinant_response(np.asarray(host[0], np.int32),
                                            int(host[1]))
            rows, start = mgr.merged_determinants()
        elif replica is not None:
            one_dev = self._on_device(replica)
            stack = tree_map(lambda x: x[None], one_dev)
            cnt, start = (int(x) for x in _device.to_numpy(
                self._fetch_meta(stack, [0], from_epoch))[0])
            mgr.expect_determinant_responses(1)
            mgr.notify_determinant_response(
                self._fetch_rows(stack, 0, from_epoch, cnt), start)
            rows, start = mgr.merged_determinants()
        elif n_steps > 0:
            synthesized = True
            mgr.expect_determinant_responses(0)
            rows = self._synthesize_det_rows(fence, n_steps)
            start = ck_head
        else:
            mgr.expect_determinant_responses(0)
            rows = np.zeros((0, det.NUM_LANES), np.int32)
            start = ck_head
        input_steps = None
        dev_piece = self._on_device({"edge": piece["edge"],
                                     "rr": piece["rr"], "op": piece["op"]})
        inputs = [self._replay_inputs(
            None, None, e, sub, fence, n_steps, window=windows[e],
            edge_row=RecordBatch(*dev_piece["edge"][e]),
            rr=dev_piece["rr"][e]) for e in in_edges] \
            if n_steps > 0 else [[] for _ in in_edges]
        if isinstance(v.operator, TwoInputOperator):
            input_steps = list(zip(*inputs))
        elif in_edges:
            input_steps = inputs[0]
        elif feed_host is not None:
            input_steps = self._upload_feed(feed_host)
        elif isinstance(v.operator, HostFeedSource) and n_steps > 0:
            offset = int(np.asarray(piece["op"]["offset"]).reshape(-1)[0])
            input_steps = self._reread_feed(vid, sub, offset, rows, n_steps)
        ph.enter("replay")
        plan = rec.ReplayPlan(
            vertex_id=vid, subtask=sub, flat_subtask=flat,
            from_epoch=from_epoch, input_steps=input_steps,
            det_rows=rows, det_start=start,
            checkpoint_op_state=dev_piece["op"], n_steps=n_steps,
            verify_outputs=not synthesized, state_row=0)
        result = mgr.run_replay(plan, self.device)
        rebuilt = self._check_rebuilt(flat, result, rows, synthesized)
        # Recovered timers re-run their callbacks (on the rank that fires
        # them; the rows are back in the rebuilt log already).
        svc = self.timer_services.get(flat)
        if svc is not None and not drill:
            for _step_i, ad in result.async_events:
                if isinstance(ad, det.TimerTriggerDeterminant):
                    svc.refire(ad)
        if vid in self.txn_logs and n_steps > 0 and self._owns_txn(vid):
            # Exactly once: its pending shards, rebuilt on the rank that
            # holds its transactions.
            self.txn_logs[vid].drop_uncommitted_shards(sub)
            self._rebuild_txn_shards(vid, sub, result, from_epoch, fence,
                                     n_steps)
        restored = self._restored_log(
            one_dev if not synthesized else None, rebuilt, flat,
            from_epoch, fence, ck_head)
        carry = self._graft_lane(carry, vid, sub - comp.vblock[vid][0],
                                 result, fence, n_steps)
        log_piece = (self._host({
            "log": restored,
            "rc": int(piece["rc"]) + result.records_replayed})
            if lead else None)
        return (carry, log_piece, mgr, rec.plan_restore_nbytes(plan),
                result.records_replayed, len(rows))

    def _mesh_reread(self, vid: int, sub: int, flat: int,
                     owners: List[int], piece, replica, host,
                     from_epoch: int, n_steps: int) -> Optional[np.ndarray]:
        """A recovering feed source's re-read when rank 0 holds the
        feed's one reader: the first owner derives each replayed step's
        record count from the determinants it replays (mirror rows or
        the transferred replica), rank 0 reads them from its retention at
        the checkpointed offset, and the records travel to the owners. A
        read below retention fails on every rank. Returns the host
        records on the owners, None elsewhere."""
        from clonos_tpu_torch.parallel import distributed as dist_
        comp = self.executor.compiled
        mesh, axis, me = self.mesh, comp.task_axis, comp.shard
        counts = None
        if me == owners[0]:
            if host is not None:
                rows = np.asarray(host[0], np.int32)
            else:
                stack = tree_map(lambda x: x[None],
                                 self._on_device(replica))
                cnt = int(_device.to_numpy(
                    self._fetch_meta(stack, [0], from_epoch))[0, 0])
                rows = self._fetch_rows(stack, 0, from_epoch, cnt)
            counts = self._feed_counts(rows, n_steps)
        counts = dist_.transfer(counts, owners[0], [0], mesh, axis)
        got, err = None, None
        if me == 0:
            try:
                offset = int(np.asarray(piece["op"]["offset"])
                             .reshape(-1)[0])
                got = self._read_feed(vid, sub, offset, counts, n_steps)
            except Exception as e:          # settled below, on every rank
                err = e
        dist_.agree(err, mesh, axis, group=self.executor._host_group)
        return dist_.transfer(got, 0, owners, mesh, axis)

    def _ring_bounds_dev(self) -> Optional[torch.Tensor]:
        """Device ``[R, 2]`` (tail, head) of every in-flight ring —
        dispatch only; recovery folds it into its final packed read."""
        rings = self.executor.carry.out_rings
        if not rings:
            return None
        return torch.stack([torch.stack([el.tail, el.head]) for el in rings])

    def _verify_final(self, arr: np.ndarray, failed: Tuple[int, ...],
                      nrings: int, fast_mgrs, prep, ck_heads,
                      n_steps: int) -> int:
        """The final read's deferred asserts. Returns the fast-path
        subtasks' consumed records."""
        ex = self.executor
        off = len(failed)
        heads_after = arr[:off]
        if nrings:
            bounds = arr[off:off + 2 * nrings].reshape(nrings, 2)
            off += 2 * nrings
            if self._ring_mirror_valid:
                want = (self._ring_tail_mirror, ex._steps_executed)
                for ri in range(nrings):
                    got = (int(bounds[ri, 0]), int(bounds[ri, 1]))
                    if got != want:
                        raise rec.RecoveryError(
                            f"ring {ri}: host bound mirror {want} diverges "
                            f"from device bounds {got} — recovery routed "
                            f"against wrong coverage; state suspect")
        want_n = DETS_PER_STEP * n_steps
        records = 0
        for m in fast_mgrs:
            flat = m.flat_subtask
            ck_head = int(ck_heads[flat])
            small = tuple(int(x) for x in arr[off:off + 4])
            off += 4
            nh = len(prep[flat]["holders"])
            meta = arr[off:off + 2 * nh].reshape(nh, 2)
            off += 2 * nh
            ok, consumed = int(arr[off]), int(arr[off + 1])
            off += 2
            if small != (want_n, ck_head, n_steps, 1):
                raise rec.RecoveryError(
                    f"subtask {flat}: host-derived clean stream (n={want_n},"
                    f" start={ck_head}, anchors={n_steps}) contradicted by "
                    f"device parse {list(small)} — async-row ledger or "
                    f"fence-head cache is wrong; state suspect")
            for j in range(nh):
                if (int(meta[j, 0]), int(meta[j, 1])) != (want_n, ck_head):
                    raise rec.RecoveryError(
                        f"subtask {flat}: replica holder {j} metadata "
                        f"{meta[j].tolist()} disagrees with ({want_n}, "
                        f"{ck_head}) — replicas inconsistent")
            head = int(heads_after[failed.index(flat)])
            if head != ck_head + want_n:
                raise rec.RecoveryError(
                    f"subtask {flat}: restored log head {head} != fence "
                    f"head {ck_head} + {want_n} rows")
            if not ok:
                try:
                    m.result.verify()
                except rec.RecoveryError as err:
                    raise rec.RecoveryError(f"subtask {flat}: {err}") \
                        from None
                raise rec.RecoveryError(
                    f"subtask {flat}: device verify flag tripped but host "
                    f"recheck passed — flag/stream mismatch")
            m.result.records_replayed = consumed
            records += consumed
        return records

    def failover_drill(self, flats: Optional[Sequence[int]] = None
                       ) -> float:
        """Rehearse a failover end to end and return its wall seconds:
        inject a failure, run the full recovery protocol, and rely on
        bit-identical recovery to leave the canonical state unchanged.
        Default drill set: one subtask of every vertex class, failed
        together. A set that would leave some log without a surviving
        replica holder is refused BEFORE any state is zeroed."""
        self._join_fence_tail()
        if self.failed:
            raise rec.RecoveryError("cannot drill with real failures "
                                    "pending")
        if not self.standbys.has_state():
            raise rec.RecoveryError(
                "failover_drill needs a completed checkpoint")
        t0 = _time.monotonic()
        fence = self._fence_step[self.standbys.latest.checkpoint_id + 1]
        if self.global_step == fence:
            warnings.warn(
                "failover_drill at an epoch fence replays zero steps; "
                "run it mid-epoch so the chunked replay path executes")
        if flats is None:
            flats = [self.job.subtask_base(v.vertex_id)
                     for v in self.job.vertices]
        flats = list(flats)
        if self.global_step > fence:
            fset = set(flats)
            for flat in flats:
                vid, _ = self._vertex_of(flat)
                if not self.job.out_edges(vid):
                    continue       # sinks synthesize; no holder needed
                if not any(o == flat and h not in fset
                           for (o, h) in self.plan.pairs):
                    raise rec.RecoveryError(
                        f"failover_drill: subtask {flat} would have no "
                        f"surviving determinant replica under drill set "
                        f"{sorted(fset)} — drill fewer subtasks at once "
                        f"or deepen sharing/replication")
            # Input reconstruction needs the whole replay window in the
            # upstream rings or the tiers: checked before any state goes.
            n_steps = self.global_step - fence
            if (n_steps > self.executor.compiled.inflight_ring_steps
                    and self.executor.spill_logs is None):
                raise rec.RecoveryError(
                    f"failover_drill: {n_steps} steps since the last "
                    f"completed checkpoint exceed the in-flight ring "
                    f"({self.executor.compiled.inflight_ring_steps} "
                    f"steps) and spill is disabled — drill earlier or "
                    f"enable spill")
        self.inject_failure(flats)
        self.recover(drill=True)
        return _time.monotonic() - t0

    def prewarm_recovery(self, vertex_ids: Optional[Sequence[int]] = None,
                         spill_paths: bool = False) -> float:
        """Dispatch once, at job start, every device function
        :meth:`recover` runs and the live block does not, on disposable
        zero inputs of recovery's own shapes — the reference's deployed
        standby, whose analog compiles every recovery program. On the
        card this builds and loads the kernel libraries, loads each
        kernel module a recovery launches and grows the caching allocator
        to recovery's shapes, so the failure path does none of it. It
        ends with :func:`utils.compile_cache.aot_lower_first_step`.

        The steps follow the reference's order: the replica fetch and
        parse, the replica log restore and copy, the ring bounds, the
        shared log restore, then for each vertex (``vertex_ids``, default
        all) its routed windows in both routing variants with the first
        chunk's edge-buffer splice, its replay chain at the recovery
        chunk (every subtask of a statically routed consumer), its kill,
        graft and ring write. ``spill_paths`` adds each window's spilled
        splice. The reference compiles independent programs on a thread
        pool; the port dispatches on one stream, so the steps run in
        turn.

        Nothing live moves: the steps run on a zero carry of their own,
        freed before returning, and the live carry, the step counters,
        the host RNG, the ledger, the coordinator and the sinks'
        transactions are untouched. The kernel launches count as warm
        launches (``ops/histogram.py``). On a mesh each rank warms the
        subtasks it runs, with no collective but the first-step block's,
        so every rank calls this in lockstep.

        Requires ``num_standby >= 1``. Returns the wall seconds."""
        if self.standbys.num_standby_per_vertex < 1:
            raise rec.RecoveryError(
                "prewarm_recovery needs num_standby >= 1 (no standby "
                "programs requested)")
        t0 = _time.monotonic()
        from clonos_tpu_torch.ops.histogram import counting_as_warm
        from clonos_tpu_torch.utils.compile_cache import (
            aot_lower_first_step, load_kernels)
        load_kernels(self.device)
        with counting_as_warm():
            self._prewarm_steps(vertex_ids, spill_paths)
        aot_lower_first_step(self.executor, self._mgroup)
        return _time.monotonic() - t0

    def _prewarm_steps(self, vertex_ids: Optional[Sequence[int]],
                       spill_paths: bool) -> None:
        """:meth:`prewarm_recovery`'s recovery steps on a zero carry."""
        ex = self.executor
        comp = ex.compiled
        dev = self.device
        job = self.job
        ch = self._recovery_ch
        n_rows = ch * DETS_PER_STEP
        no_rows = np.zeros((0, det.NUM_LANES), np.int32)
        dummy = tree_map(torch.zeros_like, ex.carry)
        # Past the newest epoch: the epoch index rebuilt is empty.
        from_epoch = ex.epoch_id + 1
        # Replica fetch and parse, the replica log restore and copy.
        replica_src = None
        if self.plan.num_replicas > 0 and dummy.replicas.head.shape[0]:
            self._device_parse(dummy.replicas, 0, from_epoch)
            holders: Dict[int, int] = {}
            for o, _h in self.plan.pairs:
                holders[o] = holders.get(o, 0) + 1
            for h in sorted(set(holders.values())):
                self._fetch_meta(dummy.replicas, [0] * h, from_epoch)
            self._fetch_rows(dummy.replicas, 0, from_epoch, 0)
            replica_src = 0
            self._restored_log(tree_map(lambda x: x[0], dummy.replicas),
                               no_rows, 0, from_epoch, 0, 0, det_n=n_rows,
                               clean_sync=True)
            if dummy.logs.head.shape[0]:
                idx = _device.upload(np.zeros((1,), np.int64), dev)

                def copy_rows(s_, lg):
                    s_ = s_.clone()
                    s_[idx] = lg[idx]
                    return s_

                tree_map(copy_rows, dummy.replicas, dummy.logs)
        if dummy.out_rings:
            torch.stack([torch.stack([el.tail, el.head])
                         for el in dummy.out_rings])
        # The shared log restore from uploaded rows.
        self._restored_log(None,
                           np.zeros((n_rows, det.NUM_LANES), np.int32), 0,
                           from_epoch, 0, 0)
        snap0 = LeanSnapshot(dummy.op_states, dummy.edge_bufs,
                             dummy.rr_offsets, dummy.record_counts,
                             dummy.logs.head,
                             tuple(el.head for el in dummy.out_rings))
        pad = self._pad_steps()
        det_device = tuple(torch.zeros((pad,), dtype=torch.int32,
                                       device=dev) for _ in range(3))
        rr = torch.zeros((), dtype=torch.int32, device=dev)
        vids = (list(vertex_ids) if vertex_ids is not None
                else [v.vertex_id for v in job.vertices])
        for vid in vids:
            v = job.vertices[vid]
            lo, hi = comp.vblock[vid]
            if hi <= lo:
                continue
            static = comp.consumer_slot_keys(vid) is not None
            subs = range(lo, hi) if static else [lo]
            # Each input edge's routed window: the fused lane and the
            # all-lane route with its select, and the first chunk's
            # edge-buffer splice.
            lanes = []
            for eidx in job.in_edges(vid):
                e = job.edges[eidx]
                el = dummy.out_rings[comp.ring_index[e.src]]
                src_p = job.vertices[e.src].parallelism
                raw = (ifl.slice_steps_at(el, 0, ch)
                       if el.keys.shape[1] == src_p else
                       empty((ch, src_p, comp.vertex_out_capacity(e.src)),
                             dev))
                if spill_paths:
                    spilled = RecordBatch(*(_device.upload(
                        np.zeros(tuple(x.shape),
                                 np.bool_ if x.dtype == torch.bool
                                 else np.int32), dev) for x in raw))
                    raw = RecordBatch(*(torch.cat([sp[:1], x[1:]])
                                        for sp, x in zip(spilled, raw)))
                lane = self._route_lane(eidx, raw, subs[0], rr)
                routed = self._route_all(eidx, raw, rr)
                RecordBatch(*(x[:, 0] for x in routed))
                edge_row = RecordBatch(*(b[0]
                                         for b in dummy.edge_bufs[eidx]))
                lanes.append(RecordBatch(*(
                    torch.cat([b[None], x[1:]])
                    for x, b in zip(lane, edge_row))))
            if isinstance(v.operator, TwoInputOperator):
                input_steps = [tuple(lanes)]
            elif lanes:
                input_steps = [lanes[0]]
            elif isinstance(v.operator, HostFeedSource):
                input_steps = self._upload_feed(np.zeros(
                    (3, ch, v.operator.batch_size), np.int32))
            else:
                input_steps = None
            # The replay chain, then the kill, graft and ring write.
            for sub in subs:
                plan = rec.ReplayPlan(
                    vertex_id=vid, subtask=sub,
                    flat_subtask=job.subtask_base(vid) + sub,
                    from_epoch=from_epoch, input_steps=input_steps,
                    det_rows=no_rows, det_start=0,
                    checkpoint_op_state=dummy.op_states[vid], n_steps=ch,
                    det_device=det_device, state_row=sub - lo)
                result = self._make_replayer(vid, sub).replay(
                    plan, dev, defer_sync=True)
            flat = job.subtask_base(vid) + sub
            dummy = self._killed(dummy, flat)
            if self.mesh is None:
                dummy = self._patch(
                    dummy, snap0, vid, sub, flat, result, no_rows,
                    from_epoch, 0, ch, replica_src=replica_src,
                    det_n=n_rows, clean_sync=True, ck_head=0)
            else:
                dummy = self._graft_lane(dummy, vid, sub - lo, result, 0,
                                         ch)
        del dummy

    @classmethod
    def bootstrap_standby(cls, job: JobGraph, checkpoint_dir: str,
                          mirror_rows: Dict[int, Tuple[np.ndarray, int]],
                          ignored_checkpoints: Sequence[int] = (),
                          feed_readers: Optional[Dict[int, object]] = None,
                          **runner_kw
                          ) -> Tuple["ClusterRunner", RecoveryReport]:
        """Standby-host failover: rebuild the whole job in a fresh runner
        after the loss of its host, from the durable checkpoint in
        ``checkpoint_dir`` and mirrored determinant rows (flat subtask ->
        (rows, abs_start), covering every subtask and ending at an epoch
        fence). Every subtask is recovered through the causal protocol in
        topological order, so the rebuilt state equals the dead runner's
        at its last mirrored fence.

        A worker thread derives the roll-gap / async-row ledgers from the
        mirrored streams (joined just before recovery's first patch),
        fast-forwards the host RNG past the replayed prefix and warms the
        first step (:func:`utils.compile_cache.aot_lower_first_step`:
        the kernels built or loaded from ``compile_cache_dir``, the
        first-step block dispatched on zero inputs), so the first live
        step builds and loads nothing (joined before returning; its wall
        is ``finalize.first-step-recompile``). Rebalance edges are
        refused: their round-robin cursors are not in the fence snapshot.

        ``feed_readers`` maps HostFeedSource vertex ids to rewindable
        readers (the ``api/feeds.py`` contract), registered BEFORE the
        replay so the feed re-read path serves the recorded offset
        windows: a scheduler slice whose cut in-edges arrive over the
        wire needs them.

        On a mesh (``mesh=`` in ``runner_kw``) a fresh set of rank
        processes each calls it with the same arguments (every rank is
        given every subtask's mirror rows): rank 0 alone reads the
        checkpoint directory and finds the restore point, which it hands
        to every rank; the mesh recovery then sends each subtask's slice
        to its owners, which replay it from their mirror rows in place of
        a replica, and each rank derives the ledgers of its own subtasks
        and log rows on its worker, which loads the kernel libraries only:
        the first-step block, a collective there, runs on the main thread
        after the join."""
        for e in job.edges:
            if e.partition == PartitionType.REBALANCE:
                raise rec.RecoveryError(
                    "bootstrap_standby: rebalance edges not supported "
                    "(post-replay round-robin cursors are not "
                    "reconstructible from the fence snapshot)")
        # Rebuild stages around recover(): each is a
        # recovery.finalize.<stage> span and folds into phase_ms.
        tr = get_tracer()
        sub_ms: Dict[str, float] = {}
        t_sub = _time.monotonic()

        def _stage(name: str) -> None:
            nonlocal t_sub
            now = _time.monotonic()
            sub_ms[name] = sub_ms.get(name, 0.0) + (now - t_sub) * 1e3
            tr.complete(f"recovery.{name}", now - t_sub)
            t_sub = now

        runner = cls(job, checkpoint_dir=checkpoint_dir, **runner_kw)
        for vid, reader in (feed_readers or {}).items():
            runner.executor.register_feed(vid, reader)
        ex = runner.executor
        dev = runner.device
        comp = ex.compiled
        ignored = set(ignored_checkpoints)
        L = job.total_subtasks()
        missing = [f for f in range(L) if f not in mirror_rows]
        if missing:
            raise rec.RecoveryError(
                f"bootstrap_standby: mirror rows missing for subtasks "
                f"{missing}")
        spe = ex.steps_per_epoch
        found, err = None, None
        if runner.rank == 0:
            try:
                found = runner._bootstrap_point(
                    checkpoint_dir, ignored,
                    [int(mirror_rows[f][1]) for f in range(L)])
            except Exception as e:      # settled below, on every rank
                err = e
        if comp.n_shards > 1:
            # Rank 0 alone read the directory: its restore point (or its
            # refusal) reaches every rank.
            from clonos_tpu_torch.parallel import distributed as dist_
            dist_.agree(err, runner.mesh, comp.task_axis,
                        group=ex._host_group)
            head = dist_.broadcast_object(
                None if found is None else found[1:], runner.mesh,
                comp.task_axis, group=ex._host_group)
            if found is None:
                found = (cp.CompletedCheckpoint(head[0], None, 0.0),) + head
        elif err is not None:
            raise err
        ckpt, cid, top, fence, ck_log_heads = found
        runner.standbys.on_completed_checkpoint(ckpt)
        runner.coordinator.mark_ignored(ignored)
        # Completing checkpoint max(ids) committed every epoch up to it:
        # restored from an older one, the replay and the live rerun of
        # those epochs must not commit their sink records a second time.
        for tl in runner.txn_logs.values():
            tl.mark_committed_through(top)
        from_epoch = cid + 1
        anchors_by_flat = {flat: det.sync_anchors(np.asarray(rows,
                                                             np.int32))
                           for flat, (rows, _start) in mirror_rows.items()}
        ns = {len(a) for a in anchors_by_flat.values()}
        if len(ns) != 1:
            raise rec.RecoveryError(
                f"bootstrap_standby: mirror streams disagree on the "
                f"replayed step count: {sorted(ns)}")
        n_steps = ns.pop()
        if n_steps % spe != 0:
            raise rec.RecoveryError(
                f"bootstrap_standby: mirrored {n_steps} steps is not a "
                f"whole number of {spe}-step epochs (mirrors refresh at "
                f"fences)")
        k = n_steps // spe

        # The control-plane bookkeeping the dead runner had.
        runner.global_step = fence + n_steps
        ex._steps_executed = fence + n_steps
        # Per-step (time, rng) inputs are global across the lockstep
        # supersteps, so any subtask's stream reproduces them; entries
        # below the fence are placeholders (nothing replays there).
        a0 = anchors_by_flat[0]
        rows0 = np.asarray(mirror_rows[0][0], np.int32)
        hist = [(0, 0)] * fence
        for j in range(n_steps):
            hist.append((int(rows0[a0[j], det.LANE_P + 1]),
                         int(rows0[a0[j] + 1, det.LANE_P])))
        ex.step_input_history = hist
        if runner.latency is not None:
            # Placeholders (rng 0) would all read as markers.
            runner.latency._seen = len(hist)
        ex.epoch_id = from_epoch + k
        ex.step_in_epoch = 0
        for j in range(k + 1):
            runner._fence_step[from_epoch + j] = fence + j * spe
            ex._epoch_first[from_epoch + j] = fence + j * spe
        runner._ring_tail_mirror = fence
        ex._ring_tail = fence
        with runner._ck_heads_lock:
            runner._ck_log_heads[cid] = ck_log_heads
        _stage("finalize.state-rehydrate")
        # The ledgers a rank reads: its subtasks' (the patch) and its log
        # rows' (the fence's window counts); every one off a mesh.
        own = [f for f in range(L)
               if runner.rank in runner._vertex_ranks(*runner._vertex_of(f))
               or comp.lblock[0] <= f < comp.lblock[1]]

        ov: Dict[str, Any] = {"derive_ms": 0.0, "warm_ms": 0.0,
                              "rg": {}, "ac": {}, "err": None}
        derived = threading.Event()

        def _overlap_work() -> None:
            # Roll-gap / async ledgers from the mirrored streams: rows
            # between one epoch's last sync block and the next epoch's
            # first anchor are that next epoch's roll-gap appends.
            t_d = _time.monotonic()
            try:
                rg: Dict[Tuple[int, int], int] = {}
                ac: Dict[Tuple[int, int], int] = {}
                for flat in own:
                    nrows = np.asarray(mirror_rows[flat][0]).shape[0]
                    a = anchors_by_flat[flat]
                    for j in range(k + 1):
                        if j == 0:
                            gap = int(a[0]) if len(a) else nrows
                        else:
                            prev_end = int(a[j * spe - 1]) + DETS_PER_STEP
                            nxt = int(a[j * spe]) if j < k else nrows
                            gap = nxt - prev_end
                        if gap > 0:
                            rg[(flat, from_epoch + j)] = gap
                    for j in range(k):
                        lo = int(a[j * spe])
                        hi = int(a[(j + 1) * spe]) if j + 1 < k else nrows
                        total_async = ((hi - lo) - spe * DETS_PER_STEP
                                       + (rg.get((flat, from_epoch), 0)
                                          if j == 0 else 0))
                        if total_async > 0:
                            ac[(flat, from_epoch + j)] = total_async
                ov["rg"], ov["ac"] = rg, ac
            except Exception as err:          # raised at the join
                ov["err"] = err
            finally:
                ov["derive_ms"] = (_time.monotonic() - t_d) * 1e3
                derived.set()
            if ov["err"] is not None:
                return
            # Replay reads recorded draws and never touches the host RNG,
            # so this thread owns it until the join. Then the first-step
            # warm: with a build cache (compile_cache_dir) the libraries
            # load from it instead of being built. On a mesh the block
            # warm gathers across the ranks, and this thread issues no
            # collective beside the main thread's: it only loads the
            # libraries, and the block warm runs after the join.
            t_w = _time.monotonic()
            try:
                ex.fast_forward_host_rng(fence + n_steps)
                from clonos_tpu_torch.utils import compile_cache as _cc
                if runner.mesh is None:
                    _cc.aot_lower_first_step(ex, runner._mgroup)
                else:
                    _cc.load_kernels(dev)
            except Exception as err:
                ov["err"] = err
            ov["warm_ms"] = (_time.monotonic() - t_w) * 1e3

        worker = threading.Thread(target=_overlap_work,
                                  name="bootstrap-finalize-overlap")
        worker.start()

        def _join_ledgers() -> None:
            derived.wait()
            if ov["err"] is not None:
                raise ov["err"]
            ex.install_replay_ledgers(ov["rg"], ov["ac"])

        try:
            # Ring offsets as the dead runner had them: the content is
            # rebuilt by recovery's ring write-backs, but the offsets must
            # read (fence, fence + n) for its routing coverage.
            c = ex.carry
            new_rings = []
            for el in c.out_rings:
                starts = el.epoch_starts.cpu().numpy().copy()
                me = starts.shape[0]
                for j in range(k + 1):
                    starts[(from_epoch + j) % me] = fence + j * spe
                new_rings.append(el._replace(
                    head=_device.scalar(fence + n_steps, dev),
                    tail=_device.scalar(fence, dev),
                    epoch_starts=_device.upload(starts, dev),
                    latest_epoch=_device.scalar(from_epoch + k, dev),
                    epoch_base=_device.scalar(from_epoch, dev)))
            ex.carry = c._replace(out_rings=tuple(new_rings))
            _stage("finalize.ring-reregister")

            runner.failed = set(range(L))
            for f in range(L):
                runner.heartbeats.mark_dead(f)
            report = runner.recover(host_rows=mirror_rows,
                                    pre_patch_join=_join_ledgers)
            t_sub = _time.monotonic()   # recover() attributes its own time
            # The dead runner sealed every replayed epoch at its fence:
            # their transactions are sealed here too, so they commit with
            # the next completed checkpoint (a file sink attached after
            # this persists their pendings again). Epochs it already
            # committed seal nothing (mark_committed_through).
            for j in range(k):
                runner._seal_txns(from_epoch + j)

            # The depth-1 edge buffers (the batch produced at step
            # fence+n-1, consumed by the next live step) are outside the
            # replay's input range: route that step from the rebuilt
            # rings. With nothing replayed the fence snapshot holds them.
            # On a mesh a sharded producer's step is gathered whole and
            # each rank routes its own consumer lanes.
            c = ex.carry
            if n_steps > 0:
                bufs = []
                for eidx, e in enumerate(job.edges):
                    el = c.out_rings[comp.ring_index[e.src]]
                    raw = ifl.slice_steps_at(el, fence + n_steps - 1, 1)
                    if comp.sharded(e.src):
                        raw = _gather_block(raw, runner.mesh, comp.task_axis)
                    routed = runner._route_all(eidx, raw,
                                               _device.scalar(0, dev))
                    bufs.append(RecordBatch(*(x[0] for x in routed)))
            elif comp.n_shards > 1:
                whole = dist_.broadcast_object(
                    runner._host(ckpt.carry.edge_bufs) if runner.rank == 0
                    else None, runner.mesh, comp.task_axis,
                    group=ex._host_group)
                bufs = list(runner._on_device(dist_.shard_tree(
                    whole, comp.placements().edge_bufs, comp.n_shards,
                    comp.shard)))
            else:
                bufs = list(runner._on_device(ckpt.carry.edge_bufs))
            ex.carry = c._replace(edge_bufs=tuple(bufs))
            _stage("finalize.edge-rehydrate")
        finally:
            t_j2 = _time.monotonic()
            worker.join()
        if ov["err"] is not None:
            raise ov["err"]
        if runner.mesh is not None:
            # Every rank in lockstep, after the recovery's collectives.
            from clonos_tpu_torch.utils.compile_cache import (
                aot_lower_first_step)
            t_b = _time.monotonic()
            aot_lower_first_step(ex, runner._mgroup)
            ov["warm_ms"] += (_time.monotonic() - t_b) * 1e3
        warm_blocked_ms = (_time.monotonic() - t_j2) * 1e3

        # The rebuild stages extend the finalize phase; each sub-span
        # keeps its true wall, only the blocked remainders extend the
        # finalize total, and the rest is finalize.overlap-saved.
        pm = report.phase_ms
        for name, ms in sub_ms.items():
            pm[name] = pm.get(name, 0.0) + ms
            pm["finalize"] = pm.get("finalize", 0.0) + ms
            runner._mgroup.histogram(f"recovery.{name}-ms").update(ms)
        reattach_blocked_ms = pm.get("finalize.listener-reattach", 0.0)
        pm["finalize.listener-reattach"] = ov["derive_ms"]
        pm["finalize.first-step-recompile"] = (
            pm.get("finalize.first-step-recompile", 0.0) + ov["warm_ms"])
        pm["finalize"] = (pm.get("finalize", 0.0) + reattach_blocked_ms
                          + warm_blocked_ms)
        pm["finalize.overlap-saved"] = (
            pm.get("finalize.overlap-saved", 0.0)
            + max(ov["derive_ms"] - reattach_blocked_ms, 0.0)
            + max(ov["warm_ms"] - warm_blocked_ms, 0.0))
        for name in ("finalize.listener-reattach",
                     "finalize.first-step-recompile",
                     "finalize.overlap-saved"):
            runner._mgroup.histogram(f"recovery.{name}-ms").update(pm[name])
        report.blocked_ms = {
            "finalize.listener-reattach": reattach_blocked_ms,
            "finalize.first-step-recompile": warm_blocked_ms}
        return runner, report

    def _bootstrap_point(self, checkpoint_dir: str, ignored: Set[int],
                         starts: List[int]):
        """:meth:`bootstrap_standby`'s restore point, read from this
        runner's checkpoint storage: the newest completed, non-ignored
        checkpoint whose log heads equal the mirror starts. A mirror
        synced before the owner's refresh still starts at an older
        checkpoint's heads than the newest completed one (the coordinator
        retains two), and replaying it onto the newer one would land on a
        wrong state. Returns ``(checkpoint, its id, the newest completed
        id, its fence superstep, its log heads)``."""
        storage = self.coordinator.storage
        # Only fully acked checkpoints are restore points.
        ids = [i for i in storage.completed_ids() if i not in ignored]
        if not ids:
            raise rec.RecoveryError(
                "bootstrap_standby: no durable completed non-ignored "
                f"checkpoint in {checkpoint_dir}")
        ckpt, candidates = None, []
        for cid in sorted(ids, reverse=True):
            cand = storage.read(cid)
            heads = [int(h) for h in np.asarray(cand.carry.log_heads)]
            if heads == starts:
                ckpt = cand
                break
            candidates.append(f"{cid}: {heads}")
        if ckpt is None:
            err = rec.RecoveryError(
                f"bootstrap_standby: no completed checkpoint's log heads "
                f"equal the mirror starts {starts} (candidates "
                f"{'; '.join(candidates)})")
            obs_incident.get_incidents().signal(
                "recovery.failure", error=str(err)[:200],
                source="bootstrap_standby")
            raise err
        # The fence's absolute superstep: ring heads count supersteps; a
        # job without rings pins it by the checkpoint cadence.
        if ckpt.carry.ring_heads:
            fence = int(np.asarray(ckpt.carry.ring_heads[0]))
        else:
            fence = (ckpt.checkpoint_id + 1) * self.executor.steps_per_epoch
        return (ckpt, ckpt.checkpoint_id, max(ids), fence,
                np.asarray(ckpt.carry.log_heads).astype(np.int64))

    # --- planned and live rescaling ------------------------------------------

    @classmethod
    def restore_rescaled(cls, job_new: JobGraph, job_old: JobGraph,
                         ckpt: cp.CompletedCheckpoint,
                         **runner_kw) -> "ClusterRunner":
        """Restore a completed checkpoint into a job whose keyed vertices
        run at a DIFFERENT parallelism (the planned-rescale restart).
        Dense keyed state splits and merges by key-group ownership
        (``Operator.rescale_keyed_state``); the checkpointed depth-1
        edge buffers are re-cut through the hash exchange at the new
        parallelism (``route_hash_block``: the keyed-histogram kernel on
        the card), and an overflow of the new cut's capacity raises. The
        restored incarnation starts a fresh causal-log epoch 0, and its
        ``record_counts`` and ``rr_offsets`` stay fresh (``[L]`` changes
        with the parallelism), as in the reference.

        A HASH edge that the NEW job routes statically
        (``CompiledJob.static_route``: the window -> reduce edge) is
        placed by that plan instead, whatever the old edge was: each
        valid record goes to the slot whose static key is its own, on
        its key's new owner, since the consumer reads every slot as the
        key the plan assigns it. The plan's inverse is built on the host
        and uploaded once; a valid record whose key has no slot raises,
        in the same read as the drop counts. This is a repair: the
        reference routes such a buffer through the hash exchange, which
        places records at arrival ranks, and its reduce then folds them
        into the wrong keys.

        Constraints: the topology (vertex and edge counts, operator
        types, edge partition kinds) must match; a rescaled vertex's
        input edges must be HASH; vertices without a keyed rescaling
        story keep their parallelism.

        On a mesh (``mesh=`` in ``runner_kw``, of any number of ranks,
        whatever mesh wrote the checkpoint) every rank calls it in
        lockstep: rank 0, which alone reads ``ckpt`` (the others may pass
        None), builds the whole restored state as above and sends every
        rank its shards (a parallelism that does not split over the ranks
        is whole on every rank)."""
        if len(job_new.vertices) != len(job_old.vertices) or \
                len(job_new.edges) != len(job_old.edges):
            raise rec.RecoveryError(
                "restore_rescaled: topology mismatch between jobs")
        runner = cls(job_new, **runner_kw)
        ex = runner.executor
        comp = ex.compiled
        if comp.n_shards == 1:
            ops, bufs = runner._rescaled_state(job_old, ckpt)
        else:
            # A mesh: rank 0 (the only rank that holds the checkpoint)
            # builds the whole restored state with the unsharded code and
            # sends every rank its shards; a refusal on rank 0 is raised
            # on every rank.
            from clonos_tpu_torch.parallel import distributed as dist_
            mesh, axis = runner.mesh, comp.task_axis
            whole, err = None, None
            if runner.rank == 0:
                try:
                    whole = runner._rescaled_state(job_old, ckpt)
                except Exception as e:  # settled below, on every rank
                    err = e
            dist_.agree(err, mesh, axis, group=ex._host_group)
            pl = comp.placements()
            mine = None
            for r in range(comp.n_shards):
                piece = (runner._host(dist_.shard_tree(
                    whole, (pl.op_states, pl.edge_bufs), comp.n_shards, r))
                    if runner.rank == 0 else None)
                got = dist_.transfer(piece, 0, [r], mesh, axis)
                if r == runner.rank:
                    mine = got
            ops, bufs = runner._on_device(mine)
        ex.carry = comp.constrain_carry(ex.carry._replace(
            op_states=tuple(ops), edge_bufs=tuple(bufs)))
        return runner

    def _rescaled_state(self, job_old: JobGraph,
                        ckpt: cp.CompletedCheckpoint):
        """:meth:`restore_rescaled`'s whole restored operator states and
        edge buffers of this runner's (new) job, on its device: every
        vertex's state split and merged by key group, every edge buffer
        re-cut, with the refusals."""
        job_new = self.job
        cpy = lambda t: tree_map(lambda x: x.clone(), self._on_device(t))
        snap = ckpt.carry
        ops = []
        for v_new, v_old in zip(job_new.vertices, job_old.vertices):
            if type(v_new.operator) is not type(v_old.operator):
                raise rec.RecoveryError(
                    f"restore_rescaled: vertex {v_new.vertex_id} operator "
                    f"type changed")
            vid = v_new.vertex_id
            st = cpy(snap.op_states[vid])
            if v_new.parallelism == v_old.parallelism:
                ops.append(st)
                continue
            for eidx in job_new.in_edges(vid):
                if job_new.edges[eidx].partition != PartitionType.HASH:
                    raise rec.RecoveryError(
                        f"restore_rescaled: vertex {vid} rescaled but "
                        f"input edge {eidx} is not HASH-partitioned")
            ops.append(v_new.operator.rescale_keyed_state(
                st, v_new.parallelism, job_new.num_key_groups))
        bufs = []
        drops = []
        static = self.executor.compiled.static_route
        for eidx, (e_new, e_old) in enumerate(zip(job_new.edges,
                                                  job_old.edges)):
            if e_new.partition != e_old.partition:
                raise rec.RecoveryError(
                    f"restore_rescaled: edge {eidx} partition changed")
            old_buf = cpy(snap.edge_bufs[eidx])
            dst_p = job_new.vertices[e_new.dst].parallelism
            if eidx in static:
                placed, unplaced = static[eidx].place(
                    old_buf, job_new.vertices[e_new.src].parallelism,
                    job_new.num_key_groups)
                drops.append((eidx, dst_p, e_new.capacity, unplaced,
                              "static"))
                bufs.append(placed)
            elif e_new.partition == PartitionType.HASH:
                raw = RecordBatch(*(x[None] for x in old_buf))
                routed, dropped = routing.route_hash_block(
                    raw, dst_p, job_new.num_key_groups, e_new.capacity)
                drops.append((eidx, dst_p, e_new.capacity,
                              dropped.sum(dtype=torch.int64), "hash"))
                bufs.append(RecordBatch(*(x[0] for x in routed)))
            else:
                want = (dst_p, e_new.capacity)
                if tuple(old_buf.keys.shape) != want:
                    raise rec.RecoveryError(
                        f"restore_rescaled: edge {eidx} buffer shape "
                        f"{tuple(old_buf.keys.shape)} != {want} and the "
                        f"edge is not HASH-rescalable")
                bufs.append(old_buf)
        if drops:
            # Rescaling DOWN concentrates old lanes' records; an overflow
            # would silently lose in-flight records. One read for every
            # edge's drop count (and every static placement's misses).
            lost = torch.stack([d[3] for d in drops]).cpu().tolist()
            for (eidx, dst_p, capacity, _, how), n in zip(drops, lost):
                if n > 0 and how == "static":
                    raise rec.RecoveryError(
                        f"restore_rescaled: edge {eidx} buffer holds {n} "
                        f"record(s) with no slot of their own in its static "
                        f"plan at parallelism {dst_p}")
                if n > 0:
                    raise rec.RecoveryError(
                        f"restore_rescaled: edge {eidx} buffer overflows "
                        f"capacity {capacity} at parallelism {dst_p} — "
                        f"widen the edge capacity of the rescaled job")
        return tuple(ops), tuple(bufs)

    def rescale_live(self, job_new: JobGraph,
                     observers: Sequence = (),
                     feed_readers: Optional[Dict[int, object]] = None,
                     **runner_kw
                     ) -> Tuple["ClusterRunner", Dict[str, Any]]:
        """Elastic re-cut under live traffic: at THIS runner's completed
        checkpoint fence, stand up a new incarnation of the job at a
        different keyed parallelism and hand off exactly once. The
        protocol is fence → drain → migrate → redirect, walked through a
        :class:`~clonos_tpu_torch.runtime.scheduler.RescaleCoordinator`
        whose ``transition_observers`` (and ``observers``) see every
        step:

        fence    — the latest completed checkpoint, which must be the
                   current fence, is the handoff point (the pipelined
                   fence is drained first, so its write has landed);
        drain    — the old lanes' in-flight edge buffers captured in that
                   checkpoint are counted into the migration payload;
        migrate  — keyed state splits and merges by key-group ownership
                   and the drained buffers re-route at the new
                   parallelism (``restore_rescaled``); the old→new group
                   directories come from ``obs/audit.key_group_directory``;
        redirect — the new incarnation adopts the epoch cursor, the host
                   mirrors of the fence, the ledger and the RNG stream,
                   re-fences the handoff checkpoint in the new shape, and
                   the OLD incarnation is fenced off: every subtask
                   failed, so a stale ``run_epoch``/``step`` raises.

        ``runner_kw`` builds the new runner (its device defaults to this
        runner's). Returns ``(new_runner, stats)``; the caller rebinds
        its handle and re-homes any read tier (``ServeTier.rehome``).

        On a mesh every rank calls it in lockstep at the same fence, and
        the new runner keeps this runner's mesh (a live group cannot take
        in new ranks: another ``mesh=`` is refused). Rank 0 alone holds
        the checkpoint's carry and the ledger, walks the coordinator and
        counts the drained records; every rank runs the drain, the
        epoch-continuity surgery on its own shards and the re-fence, and
        gets rank 0's ``stats``. The fenced-off runner releases its gloo
        groups, so a round trip leaks none."""
        from clonos_tpu_torch.runtime.executor import LogicalTimeSource
        from clonos_tpu_torch.runtime.scheduler import RescaleCoordinator
        if runner_kw.get("mesh", self.mesh) is not self.mesh:
            raise ValueError(
                "rescale_live: the new runner keeps this runner's mesh — a "
                "live group cannot take in new ranks (re-cut onto another "
                "mesh through a checkpoint and restore_rescaled)")
        if self.mesh is not None:
            runner_kw["mesh"] = self.mesh
        lead = self.rank == 0
        multi = self.executor.compiled.n_shards > 1
        if self.failed:
            raise rec.RecoveryError(
                f"rescale_live: failed subtasks {sorted(self.failed)} — "
                f"recover() first; a re-cut needs a healthy fence")
        self.drain_fence()
        if self.executor.step_in_epoch != 0:
            raise rec.RecoveryError(
                f"rescale_live: mid-epoch (step {self.executor.step_in_epoch}"
                f"/{self.executor.steps_per_epoch}) — a re-cut happens at "
                f"an epoch fence; finish the epoch first")
        ids = self.coordinator.storage.completed_ids()
        if not ids:
            raise rec.RecoveryError(
                "rescale_live: no completed checkpoint — the fence the "
                "re-cut hands off at does not exist yet")
        ckpt = self.coordinator.storage.read(max(ids))
        if ckpt.checkpoint_id != self.executor.epoch_id - 1:
            raise rec.RecoveryError(
                f"rescale_live: latest completed checkpoint "
                f"{ckpt.checkpoint_id} is not the current fence "
                f"(epoch {self.executor.epoch_id - 1}) — run the epoch "
                f"to completion (complete_checkpoint=True) first")
        runner_kw.setdefault("device", self.device)
        tr = get_tracer()
        job_old = self.job

        # One protocol group per OLD lane of each rescaled vertex.
        rescaled = [(v_new, v_old)
                    for v_new, v_old in zip(job_new.vertices,
                                            job_old.vertices)
                    if v_new.parallelism != v_old.parallelism]
        lanes: List[Tuple[int, int]] = []   # (vertex_id, old lane)
        for v_new, v_old in rescaled:
            lanes += [(v_old.vertex_id, s)
                      for s in range(v_old.parallelism)]
        # The protocol walks once, on rank 0 (on a mesh the others hold
        # no checkpoint carry and observe nothing).
        coord = RescaleCoordinator(len(lanes))
        events: List[tuple] = []
        coord.transition_observers.append(
            lambda kind, **f: events.append((kind, tuple(sorted(f.items())))))
        coord.transition_observers.extend(observers)
        inflight = [0] * len(lanes)
        if lead:
            # Per-old-lane in-flight counts: the depth-1 edge buffers the
            # fence checkpoint captured, brought to the host in one copy.
            valid = _device.HostCopy(
                {eidx: ckpt.carry.edge_bufs[eidx].valid
                 for vid, _ in lanes
                 for eidx in job_old.in_edges(vid)}).wait()
            for g, (vid, lane) in enumerate(lanes):
                for eidx in job_old.in_edges(vid):
                    inflight[g] += int(np.asarray(valid[eidx])[lane].sum())
                if inflight[g]:
                    coord.note_inflight(g, inflight[g])
            coord.fence(ckpt.checkpoint_id)

        # Migration from the SAME fence checkpoint.
        t_mig = _time.monotonic()
        runner = type(self).restore_rescaled(job_new, job_old, ckpt,
                                             **runner_kw)
        for vid, reader in (feed_readers or {}).items():
            runner.executor.register_feed(vid, reader)
        directories = {
            v_old.vertex_id: _audit.key_group_directory(
                v_old.parallelism, v_new.parallelism,
                job_new.num_key_groups)
            for v_new, v_old in rescaled}
        for g, (vid, lane) in enumerate(lanes if lead else ()):
            if inflight[g]:
                coord.drain(g, inflight[g])
            coord.migrate(g)
        migrate_ms = (_time.monotonic() - t_mig) * 1e3

        # Epoch continuity (bootstrap_standby's zero-replay recipe): the
        # new incarnation resumes at the fence with the same epoch
        # cursor, global step and host-RNG position, and the host mirrors
        # of the ring bounds the next fence truncates by.
        ex = runner.executor
        dev = runner.device
        from_epoch = ckpt.checkpoint_id + 1
        fence = None
        if not lead:
            pass
        elif ckpt.carry.ring_heads:
            fence = int(_device.HostCopy(ckpt.carry.ring_heads[0]).wait())
        else:
            fence = from_epoch * ex.steps_per_epoch
        if multi:
            from clonos_tpu_torch.parallel import distributed as dist_
            fence = dist_.broadcast_int(fence, self.mesh,
                                        ex.compiled.task_axis,
                                        group=ex._host_group)
        runner.global_step = fence
        ex._steps_executed = fence
        ex.step_input_history = [(0, 0)] * fence
        if runner.latency is not None:
            runner.latency._seen = fence
        ex.epoch_id = from_epoch
        ex.step_in_epoch = 0
        runner._fence_step[from_epoch] = fence
        ex._epoch_first[from_epoch] = fence
        runner._ring_tail_mirror = fence
        ex._ring_tail = fence
        c = ex.carry
        heads = (c.logs.head if ex.mesh is None else ex._placed(
            c.logs.head, ex.compiled.placements().logs.head))
        host = _device.HostCopy({"heads": heads, "starts": [
            el.epoch_starts for el in c.out_rings]}).wait()
        with runner._ck_heads_lock:
            runner._ck_log_heads[ckpt.checkpoint_id] = np.asarray(
                host["heads"]).astype(np.int64)
        new_rings = []
        for el, starts in zip(c.out_rings, host["starts"]):
            starts = np.array(starts)
            starts[from_epoch % starts.shape[0]] = fence
            new_rings.append(el._replace(
                head=_device.scalar(fence, dev),
                tail=_device.scalar(fence, dev),
                epoch_starts=_device.upload(starts, dev),
                latest_epoch=_device.scalar(from_epoch, dev),
                epoch_base=_device.scalar(from_epoch, dev)))
        ex.carry = c._replace(out_rings=tuple(new_rings))
        ex.fast_forward_host_rng(fence)
        # A live time source carries over (a fresh one would restart
        # causal time and shift every window fire); logical time is bound
        # to its executor, whose rebuilt history already resumes here.
        if not isinstance(self.executor.time_source, LogicalTimeSource):
            ex.time_source = self.executor.time_source

        # One audit chain spans the re-cut: post-re-cut epochs diff
        # against pre-re-cut ones through the group directory
        # (diff_ledgers_cross).
        if runner.auditor.enabled and self.auditor.enabled:
            runner.auditor.adopt(self.auditor.ledger())
        runner.last_sealed_epoch = max(runner.last_sealed_epoch,
                                       self.last_sealed_epoch)

        # The durable restore point in the NEW shape: a failure in the
        # first post-re-cut epoch recovers at the new parallelism.
        runner.coordinator.trigger(ckpt.checkpoint_id, ex.lean_snapshot(),
                                   async_write=False, owned=True)
        # The fence's SOURCE_CHECKPOINT rows open the new epoch's source
        # logs, as the old incarnation's fence wrote them (the reference
        # leaves them out, so the first epoch after a re-cut back to the
        # old layout seals one row short of a never-rescaled run's).
        if runner._source_flats:
            hist = self.executor.step_input_history
            ex.append_async_many(
                runner._source_flats, det.SourceCheckpointDeterminant(
                    record_count=ex.global_record_stamp(),
                    checkpoint_id=ckpt.checkpoint_id,
                    timestamp=hist[-1][0] if hist else 0))
        runner.coordinator.ack_all(ckpt.checkpoint_id)

        # Redirect; the old incarnation is fenced off and lets go of its
        # gloo groups.
        if lead:
            coord.redirect()
        self.failed = set(range(job_old.total_subtasks()))
        for f in self.failed:
            self.heartbeats.mark_dead(f)
        self.executor.release_groups()

        stats = {
            "fence_checkpoint": ckpt.checkpoint_id,
            "from_epoch": from_epoch,
            "groups": len(lanes),
            "drained_records": int(sum(inflight)),
            "moved_key_groups": {
                vid: len(_audit.moved_key_groups(d))
                for vid, d in directories.items()},
            "migrate_ms": migrate_ms,
            "transitions": events,
        }
        if multi:
            # Every rank returns rank 0's reading (its wall clock).
            stats = dist_.broadcast_object(stats, self.mesh,
                                           ex.compiled.task_axis,
                                           group=ex._host_group)
        tr.event("rescale.redirect", **{k: v for k, v in stats.items()
                                        if k != "transitions"})
        return runner, stats

    # --- recovery helpers ----------------------------------------------------

    def _on_device(self, tree):
        """A checkpointed snapshot's leaves as tensors on this runner's
        device (file storage holds numpy)."""
        def leaf(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device)
            return _device.upload(np.asarray(x), self.device)

        return tree_map(leaf, tree)

    def _pad_steps(self) -> int:
        ch = self._recovery_ch
        return -(-self.executor.compiled.inflight_ring_steps // ch) * ch

    def _make_replayer(self, vid: int, sub: int) -> rec.LogReplayer:
        v = self.job.vertices[vid]
        slot_keys = self.executor.compiled.consumer_slot_keys(vid)
        return rec.LogReplayer(
            v.operator, v.parallelism, block_steps=self._recovery_ch,
            in_slot_keys=(slot_keys[sub:sub + 1]
                          if slot_keys is not None else None),
            pad_steps=self.executor.compiled.inflight_ring_steps)

    def _fetch_meta(self, replicas: clog.ThreadLogState, rs: List[int],
                    from_epoch: int) -> torch.Tensor:
        """Device ``[h, 2]`` (count, start) of each holder's response —
        dispatch only."""
        cap = self.executor.compiled.log_capacity
        out = []
        for r in rs:
            one = tree_map(lambda x: x[r], replicas)
            off = clog.epoch_start_offset(one, from_epoch)
            out.append(torch.stack([(one.head - off).clamp(0, cap), off]))
        return torch.stack(out)

    def _fetch_rows(self, replicas: clog.ThreadLogState, r: int,
                    from_epoch: int, count: int) -> np.ndarray:
        """One holder's determinant rows from ``from_epoch`` on, on the
        host (the slow path)."""
        one = tree_map(lambda x: x[r], replicas)
        buf, _, _ = clog.get_determinants(
            one, from_epoch, self.executor.compiled.log_capacity)
        return _device.to_numpy(buf[:count])

    def _device_parse(self, replicas: clog.ThreadLogState, r: int,
                      from_epoch: int):
        """Parse a replica's determinant stream on the device: locate the
        per-step sync anchors, extract the time/RNG/expected-cut lanes
        (padded to the replayer's fixed stream length) and report whether
        the stream is clean (pure sync rows, exact layout) as ``small =
        [count, start, anchors, clean]``. Dispatch only: the anchor index
        is an int32 cumsum rank scattered into a ``[maxn + 1]`` buffer
        whose spare slot takes every non-anchor (no data-dependent
        shape, so no host sync)."""
        cap = self.executor.compiled.log_capacity
        maxn = self._pad_steps()
        k = DETS_PER_STEP
        dev = self.device
        one = tree_map(lambda x: x[r], replicas)
        buf, count, start = clog.get_determinants(one, from_epoch, cap)
        tags = buf[:, det.LANE_TAG]
        ar = torch.arange(cap, dtype=torch.int32, device=dev)
        cond = ((ar < count) & (tags == det.TIMESTAMP)
                & (buf[:, det.LANE_RC] == 0))
        n_anchors = cond.sum(dtype=torch.int32)
        rank = torch.cumsum(cond.to(torch.int32), 0, dtype=torch.int32) - 1
        slot = torch.where(cond & (rank < maxn), rank, maxn).to(torch.int64)
        ids = torch.full((maxn + 1,), cap - k, dtype=torch.int32,
                         device=dev).scatter(0, slot, ar)[:maxn]
        amask = torch.arange(maxn, dtype=torch.int32, device=dev) < n_anchors
        # Reads past the buffer clamp to its last row (as XLA gathers do).
        at = lambda j: (ids + j).clamp(max=cap - 1).to(torch.int64)
        layout = (~amask | ((buf[at(1), det.LANE_TAG] == det.RNG)
                            & (buf[at(2), det.LANE_TAG] == det.ORDER)
                            & (buf[at(3), det.LANE_TAG]
                               == det.BUFFER_BUILT))).all()
        clean = layout & (count == n_anchors * k)
        last = (n_anchors - 1).clamp(min=0).to(torch.int64).reshape(1)
        t_raw = buf[at(0), det.LANE_P + 1]
        r_raw = buf[at(1), det.LANE_P]
        times = torch.where(amask, t_raw, t_raw[last])
        rngs = torch.where(amask, r_raw, r_raw[last])
        expected = torch.where(amask, buf[at(3), det.LANE_P], 0)
        small = torch.stack([count.to(torch.int32), start.to(torch.int32),
                             n_anchors, clean.to(torch.int32)])
        return times, rngs, expected, small

    def _rebuild_txn_shards(self, vid: int, sub: int,
                            result: rec.ReplayResult, from_epoch: int,
                            fence: int, n_steps: int) -> None:
        """The failed sink subtask's pending transaction shards, epoch by
        epoch, from its replayed output chunks (one copy to the host)."""
        tl = self.txn_logs[vid]
        chunks = _device.HostCopy(list(result.out_chunks or [])).wait()
        ch = self._recovery_ch

        def steps_slice(lo: int, hi: int) -> np.ndarray:
            rows = []
            for i, c in enumerate(chunks):
                base = i * ch
                for s in range(max(lo, base), min(hi, base + c.keys.shape[0])):
                    m = c.valid[s - base]
                    if m.any():
                        rows.append(np.stack(
                            [c.keys[s - base][m], c.values[s - base][m],
                             c.timestamps[s - base][m]], axis=1))
            return (np.concatenate(rows, axis=0) if rows
                    else np.zeros((0, 3), np.int32))

        cur = self.executor.epoch_id
        for e in range(from_epoch, cur + 1):
            if e not in self._fence_step:
                continue
            lo = self._fence_step[e] - fence
            hi = (self._fence_step.get(e + 1, fence + n_steps) - fence
                  if e < cur else n_steps)
            tl.rebuild_shard(e, sub, steps_slice(lo, min(hi, n_steps)))

    def _reread_feed(self, vid: int, sub: int, offset: int,
                     rows: np.ndarray, n_steps: int) -> List[RecordBatch]:
        """A host-fed source's lost input batches: from ``offset`` (the
        checkpointed operator state's), each step's count from its
        recorded BUFFER_BUILT determinant, the records from the rewindable
        reader (on a mesh, the owning rank's; rank 0 serves a feed whose
        one reader it holds, :meth:`_recover_mesh`). Returns
        recovery-block-sized chunks (zero-padded tail), uploaded in one
        pinned copy."""
        return self._upload_feed(self._read_feed(
            vid, sub, offset, self._feed_counts(rows, n_steps), n_steps))

    @staticmethod
    def _feed_counts(rows: np.ndarray, n_steps: int) -> np.ndarray:
        """Each replayed step's feed record count, from its recorded
        BUFFER_BUILT determinant."""
        anchors = det.sync_anchors(rows)[:n_steps]
        return rows[anchors + 3, det.LANE_P].astype(np.int64)

    def _read_feed(self, vid: int, sub: int, offset: int,
                   counts: np.ndarray, n_steps: int) -> np.ndarray:
        """The re-read records, ``[3, n_steps padded to the recovery
        block, B]`` int32 (keys, values, valid) on the host, from this
        rank's reader at ``offset``."""
        reader = self.executor.feed_readers.get(vid)
        if reader is None:
            raise rec.RecoveryError(
                f"vertex {vid}: HostFeedSource has no registered feed "
                f"reader to re-read from")
        b = self.job.vertices[vid].operator.batch_size
        ch = self._recovery_ch
        host = np.zeros((3, -(-n_steps // ch) * ch, b), np.int32)
        for i, c in enumerate(counts):
            ks, vs = reader.read_at(sub, offset, int(c))
            host[0, i, :c], host[1, i, :c] = ks, vs
            host[2, i, :c] = 1
            offset += int(c)
        return host

    def _upload_feed(self, host: np.ndarray) -> List[RecordBatch]:
        """:meth:`_read_feed`'s records as recovery-block-sized chunks on
        the device, in one pinned copy."""
        ch = self._recovery_ch
        arr = _device.upload(host, self.device)
        return [RecordBatch(arr[0, lo:lo + ch], arr[1, lo:lo + ch],
                            torch.zeros_like(arr[0, lo:lo + ch]),
                            arr[2, lo:lo + ch] != 0)
                for lo in range(0, host.shape[1], ch)]

    def _synthesize_det_rows(self, fence_global: int,
                             n_steps: int) -> np.ndarray:
        """A sink's per-step determinant rows rebuilt from the executor's
        step-input ledger (BUFFER_BUILT payloads are placeholders the
        replayer fills)."""
        hist = self.executor.step_input_history[fence_global:
                                                fence_global + n_steps]
        if len(hist) < n_steps:
            raise rec.RecoveryError("step-input ledger shorter than the "
                                    "lost step range")
        rows = np.zeros((n_steps * DETS_PER_STEP, det.NUM_LANES), np.int32)
        for i, (t, r) in enumerate(hist):
            base = i * DETS_PER_STEP
            rows[base, det.LANE_TAG] = det.TIMESTAMP
            rows[base, det.LANE_P] = -1 if t < 0 else 0
            rows[base, det.LANE_P + 1] = t
            rows[base + 1, det.LANE_TAG] = det.RNG
            rows[base + 1, det.LANE_P] = r
            rows[base + 2, det.LANE_TAG] = det.ORDER
            rows[base + 3, det.LANE_TAG] = det.BUFFER_BUILT
        return rows

    def _replay_inputs(self, carry: Optional[JobCarry],
                       snap: Optional[LeanSnapshot], eidx: int,
                       sub: int, fence: int, n_steps: int,
                       window: Optional[RecordBatch] = None,
                       edge_row: Optional[RecordBatch] = None,
                       rr: Optional[torch.Tensor] = None
                       ) -> List[RecordBatch]:
        """The failed consumer's lost inputs on edge ``eidx``: the
        checkpointed depth-1 edge buffer (its input at the first lost step)
        followed by the upstream ring's outputs re-routed into its lane.

        Windows are uniform ``[ch]`` steps: window i covers absolute steps
        ``[fence-1+i*ch, fence-1+(i+1)*ch)``; slot 0 of window 0 is the
        dead pre-fence slot, masked and replaced by the edge buffer.
        Coverage comes from the host bound mirror; the round-robin cursor
        stays on the device. Steps the ring no longer holds (below its
        tail, or clobbered by a wrap while the tail stood still) come
        from the spill tiers, spliced ahead of the ring's steps.

        On a mesh the caller passes what this rank does not hold: the
        producer ring's steps ``[fence - 1, fence - 1 + windows * ch)``
        over every producer lane (``window``), the checkpointed edge-buffer
        row (``edge_row``, ``[1, cap]``) and the edge's round-robin cursor
        (``rr``)."""
        if n_steps <= 0:
            return []
        e = self.job.edges[eidx]
        ch = self._recovery_ch
        ri = self.executor.compiled.ring_index[e.src]
        el = carry.out_rings[ri] if window is None else None
        tail, head = self._bounds_cache[ri]
        # Steps the ring physically retains: a wrap clobbers steps below
        # head - ring_steps even while the tail has not moved.
        ring_lo = max(tail, head - self.executor.compiled.inflight_ring_steps)
        if rr is None:
            rr = snap.rr_offsets[eidx]
        rr = rr[0].to(torch.int32)
        if edge_row is None:
            edge_row = RecordBatch(*(b[sub] for b in snap.edge_bufs[eidx]))
        else:
            edge_row = RecordBatch(*(b[0] for b in edge_row))
        need = n_steps
        lead = 1
        idx = torch.arange(ch, dtype=torch.int32, device=self.device)
        chunks = []
        for i in range(-(-n_steps // ch)):
            h_start = fence - 1 + i * ch
            lo_real = max(h_start, fence)
            h_need = max(min(h_start + ch, fence - 1 + n_steps) - lo_real, 0)
            if head - lo_real < h_need:
                raise rec.RecoveryError(
                    f"in-flight ring of vertex {e.src} ends at step {head}, "
                    f"before the replay window [{lo_real}, "
                    f"{lo_real + h_need})")
            routed = (self._route_cache.get((eidx, i))
                      if self._route_cache_enabled else None)
            if routed is not None:
                self._route_cache_hits += 1
                lane = RecordBatch(*(x[:, sub] for x in routed))
            else:
                raw = (ifl.slice_steps_at(el, h_start, ch) if window is None
                       else RecordBatch(*(x[i * ch:(i + 1) * ch]
                                          for x in window)))
                # A mesh's window arrives with its spilled steps in place.
                if h_need and lo_real < ring_lo and window is None:
                    raw = self._splice_spilled(
                        raw, ri, e.src, fence, h_start,
                        min(h_start + ch, ring_lo),
                        min(ring_lo, fence - 1 + n_steps))
                live = (idx >= lead) & (idx < min(max(need, 0), ch))
                raw = raw._replace(valid=raw.valid & live[:, None, None])
                if self._route_cache_enabled:
                    # Several failed consumers: route the window to every
                    # lane once and select per consumer.
                    routed = self._route_all(eidx, raw, rr)
                    self._route_cache[(eidx, i)] = routed
                    lane = RecordBatch(*(x[:, sub] for x in routed))
                else:
                    lane = self._route_lane(eidx, raw, sub, rr)
                rr = rr + raw.count().sum(dtype=torch.int32)
            need -= ch
            lead = 0
            if i == 0:
                lane = RecordBatch(*(torch.cat([b[None], x[1:]])
                                     for x, b in zip(lane, edge_row)))
            chunks.append(lane)
        return chunks

    def _splice_spilled(self, raw: RecordBatch, ri: int, src_vid: int,
                        fence: int, h_start: int, lead_end: int,
                        spill_end: int) -> RecordBatch:
        """Replace a ring window's leading slots (steps ``[h_start,
        lead_end)``, which the ring no longer holds) with the spilled
        steps. Slots before ``fence`` are dead (zeros; the replay masks
        them). The spilled span ``[fence, spill_end)`` is read through the
        prefetching ReplayIterator and uploaded once per recovery."""
        lo = max(h_start, fence)
        spilled = self._spilled_span(ri, src_vid, fence, spill_end)
        parts = []
        for x, sp in zip(raw, spilled):
            got = sp[lo - fence:lead_end - fence]
            # Dead slots: before the fence, and past the needed span.
            pre = torch.zeros_like(x[:lo - h_start])
            post = torch.zeros_like(x[:lead_end - lo - got.shape[0]])
            parts.append(torch.cat([pre, got, post,
                                    x[lead_end - h_start:]]))
        return RecordBatch(*parts)

    def _spilled_span(self, ri: int, src_vid: int, lo: int, hi: int
                      ) -> RecordBatch:
        """Ring ``ri``'s steps ``[lo, hi)`` from the spill tiers, on the
        device — read and uploaded once per recovery (the host arrays
        cross in one pinned copy per field). A torn, corrupt or missing
        segment raises a labelled RecoveryError."""
        cached = self._spill_cache.get(ri)
        if cached is not None and cached[0] == (lo, hi):
            return cached[1]
        spill = (self.executor.spill_logs[ri]
                 if self.executor.spill_logs is not None else None)
        if spill is None:
            raise rec.RecoveryError(
                f"in-flight ring of vertex {src_vid} no longer holds steps "
                f"[{lo}, {hi}) and spill is disabled")
        parts: List[RecordBatch] = []
        have = lo
        eps = spill.retained_epochs()
        if eps:
            it = ifl.ReplayIterator(spill, eps[0], eps[-1])
            try:
                for ep_start, ep_batch in it.epochs():
                    if ep_start > have:
                        break         # a hole: refused below, never spliced
                    a = max(have, ep_start)
                    b = min(ep_start + ep_batch.keys.shape[0], hi)
                    if b > a:
                        parts.append(RecordBatch(
                            *(x[a - ep_start:b - ep_start]
                              for x in ep_batch)))
                        have = b
                    if have >= hi:
                        break
            except (SegmentCorruptError, StorageError) as err:
                raise rec.RecoveryError(
                    f"vertex {src_vid}: tiered refill failed — {err}"
                ) from err
            finally:
                it.close()
        if have < hi:
            raise rec.RecoveryError(
                f"vertex {src_vid}: spill does not cover steps "
                f"[{have}, {hi})")
        span = RecordBatch(*(_device.upload(np.concatenate(xs), self.device)
                             for xs in zip(*parts)))
        self._spill_cache[ri] = ((lo, hi), span)
        return span

    def _route_all(self, eidx: int, raw: RecordBatch, rr: torch.Tensor
                   ) -> RecordBatch:
        """A ``[m, P_src, cap]`` producer window routed over edge ``eidx``
        to every consumer lane (``rr``: the round-robin offset at its
        first step)."""
        routed, _ = self.executor.compiled._route_edge(
            eidx, raw, {eidx: rr.reshape(1)})
        return routed

    def _route_lane(self, eidx: int, raw: RecordBatch, sub: int,
                    rr: torch.Tensor) -> RecordBatch:
        """Consumer lane ``sub`` of :meth:`_route_all`, computed directly
        (one lane's scatter instead of all of them)."""
        e = self.job.edges[eidx]
        compiled = self.executor.compiled
        dst_p = self.job.vertices[e.dst].parallelism
        if eidx in compiled.static_route:
            r, _ = compiled.static_route[eidx].apply(raw)
            return RecordBatch(*(x[:, sub] for x in r))
        if e.partition == PartitionType.HASH:
            return routing.route_hash_block_lane(
                raw, sub, dst_p, self.job.num_key_groups, e.capacity)
        if e.partition == PartitionType.FORWARD:
            return routing.route_forward_block_lane(raw, sub, e.capacity)
        if e.partition == PartitionType.REBALANCE:
            counts = raw.count().sum(dim=1, dtype=torch.int32)
            offs = rr + torch.cumsum(counts, 0, dtype=torch.int32) - counts
            return routing.route_rebalance_block_lane(
                raw, sub, dst_p, e.capacity, offs)
        return routing.route_broadcast_block_lane(raw, sub, e.capacity)

    def _patch(self, carry: JobCarry, snap: LeanSnapshot, vid: int,
               sub: int, flat: int, result: rec.ReplayResult,
               det_rows: np.ndarray, from_epoch: int, fence: int,
               n_steps: int, replica_src: Optional[int] = None,
               det_n: Optional[int] = None, clean_sync: bool = False,
               ck_head: Optional[int] = None) -> JobCarry:
        """Graft the rebuilt subtask back into the live carry: operator
        row, log row (from a consistent replica's device bytes, else
        uploaded rows), record count, and its lane of its ring.

        ``clean_sync``: the stream is pure sync blocks, so the anchors
        are exactly ``i * DETS_PER_STEP`` and ``det_n`` is its row count."""
        tr = get_tracer()
        if ck_head is None:
            ck_head = int(_device.to_numpy(snap.log_heads[flat]))
        one = (tree_map(lambda x: x[replica_src], carry.replicas)
               if replica_src is not None else None)
        with tr.span("recovery.patch.log"):
            restored = self._restored_log(one, det_rows, flat, from_epoch,
                                          fence, ck_head, det_n, clean_sync)

        def put(stack, i, one_):
            stack = stack.clone()
            stack[i] = one_
            return stack

        # A deferred replay's consumed total stays on the device.
        rc = snap.record_counts[flat] + (
            result.consumed_d if result.deferred
            else result.records_replayed)
        carry = carry._replace(
            logs=tree_map(lambda s_, r: put(s_, flat, r), carry.logs,
                          restored),
            record_counts=put(carry.record_counts, flat, rc))
        with tr.span("recovery.patch.lane"):
            return self._graft_lane(carry, vid, sub, result, fence, n_steps)

    def _restored_log(self, replica: Optional[clog.ThreadLogState],
                      det_rows: np.ndarray, flat: int, from_epoch: int,
                      fence: int, ck_head: int, det_n: Optional[int] = None,
                      clean_sync: bool = False) -> clog.ThreadLogState:
        """The failed subtask's rebuilt log: the rows from ``ck_head`` on
        (``replica``'s device bytes when given — the replayed stream was
        verified equal to it — else the uploaded ``det_rows``) and its
        epoch index, re-derived from the fence-step ledger."""
        compiled = self.executor.compiled
        dev = self.device
        cap = compiled.log_capacity
        n = det_rows.shape[0] if det_n is None else det_n
        if clean_sync:
            ts_pos = np.arange(n // DETS_PER_STEP,
                               dtype=np.int64) * DETS_PER_STEP
        elif n > 0:
            ts_pos = det.sync_anchors(det_rows)
        else:
            ts_pos = np.zeros((0,), np.int64)
        # The epoch->offset index died with the task; rebuild it from the
        # fence-step ledger. Sync blocks anchor at TIMESTAMP rows; rows
        # appended in an epoch's roll gap belong to the new epoch.
        me = compiled.max_epochs
        starts = np.zeros((me,), np.int32)
        mask = np.zeros((me,), np.int32)
        latest = 0
        for e in range(from_epoch, self.executor.epoch_id + 1):
            if e not in self._fence_step:
                continue
            step_i = self._fence_step[e] - fence
            gap = self.executor.roll_gap_async.get((flat, e), 0)
            if step_i == 0:
                off = ck_head
            elif step_i < len(ts_pos):
                off = ck_head + int(ts_pos[step_i]) - gap
            else:
                off = ck_head + n - gap
            starts[e % me] = off
            mask[e % me] = 1
            latest = max(latest, e)
        restored = clog.create(cap, me, dev)
        base = _device.scalar(ck_head, dev)
        restored = restored._replace(head=base, tail=base.clone())
        if replica is not None:
            buf, _, _ = clog.get_determinants(replica, from_epoch, cap)
            restored = clog.append(restored, buf, n)
        elif n > 0:
            restored = clog.append(restored,
                                   _device.upload(det_rows[:n], dev), n)
        index = _device.upload(np.stack([starts, mask]), dev)
        return restored._replace(
            epoch_starts=torch.where(index[1] > 0, index[0],
                                     restored.epoch_starts),
            latest_epoch=restored.latest_epoch.clamp(min=latest),
            epoch_base=restored.epoch_base.clamp(min=from_epoch))

    def _graft_lane(self, carry: JobCarry, vid: int, lane: int,
                    result: rec.ReplayResult, fence: int, n_steps: int
                    ) -> JobCarry:
        """The rebuilt operator row and in-flight ring lane of a failed
        subtask at local row ``lane`` of its vertex's state and ring."""
        compiled = self.executor.compiled
        dev = self.device

        def put(stack, i, one):
            stack = stack.clone()
            stack[i] = one
            return stack

        ops = list(carry.op_states)
        ops[vid] = tree_map(lambda live, new: put(live, lane, new[0]),
                            ops[vid], result.op_state)
        carry = carry._replace(op_states=tuple(ops))
        # Rebuild the failed producer's lane of its in-flight ring from the
        # replayed outputs at their original steps (only the last
        # ring_steps replayed steps fit). Written in place: the ring
        # belongs to the live carry being patched, and a later consumer
        # in this recovery reads the rebuilt lane.
        if vid in compiled.ring_index and result.out_chunks is not None:
            el = carry.out_rings[compiled.ring_index[vid]]
            keep_from = fence + n_steps - min(n_steps, el.ring_steps)
            step = fence
            for chunk in result.out_chunks:
                m = chunk.keys.shape[0]
                a = max(step, keep_from)
                if step + m > a:
                    pos = torch.arange(a, step + m, dtype=torch.int64,
                                       device=dev) & (el.ring_steps - 1)
                    for ring_f, chunk_f in zip(
                            (el.keys, el.values, el.timestamps, el.valid),
                            chunk):
                        ring_f[pos, lane] = chunk_f[a - step:]
                step += m
        return carry
