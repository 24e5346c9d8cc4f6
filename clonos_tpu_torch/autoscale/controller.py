"""AutoscaleController: fence-aligned evaluation, determinant-logged
decisions, replay-not-re-decide recovery (port of
``clonos_tpu/autoscale/controller.py``).

The paper's rule for every nondeterministic control event — log it as
a determinant so replay is bit-identical — is what makes an AUTONOMOUS
scaling decision safe inside an exactly-once system. The controller
therefore:

- evaluates ONLY at completed (and drained) fences, through the pure
  :class:`~clonos_tpu_torch.autoscale.policy.ScalePolicy`;
- logs every decision — holds included — as a ``SCALE`` determinant
  row (causal/determinant.py) into its own host-side append log,
  alongside a JSONL sidecar carrying the full signal snapshot the
  policy saw (the row pins the snapshot by crc32, sidecar discipline
  borrowed from SERIALIZABLE);
- on recovery, REPLAYS the log instead of re-deciding: the policy is
  re-run over the logged snapshots and every reproduced decision must
  equal its logged row byte-for-byte (a divergence means the log or
  the policy changed underfoot — refuse loudly); fences already in the
  log return the logged decision without re-executing, so a worker
  kill mid-cooldown can never trigger a second re-cut.

The SCALE rows deliberately live in a controller-owned log, NOT in any
task's device determinant stream: epoch seal digests cover task
determinant windows, and rows only the autoscaled run has would make
the byte-exact audit diff against the fault-free control twin diverge
by construction.

Execution is delegated through injected callbacks (worker re-cuts ride
the fence→drain→migrate→redirect path via
``ClusterRunner.rescale_live``; replica changes ride
``ServeTier.add_replica``/``drop_replica``) so the controller itself
touches no device and tests can drive it with fakes.
``transition_observers`` fire ``fn(kind, **fields)`` on every
protocol-visible step (observe/fence/decide/log/execute/refuse).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from clonos_tpu_torch.autoscale.policy import (ACTION_CODES, HOLD,
                                               SCALE_REPLICAS, SCALE_WORKERS,
                                               PolicyState, ScaleDecision,
                                               ScalePolicy)
from clonos_tpu_torch.autoscale.signals import ScaleSignals
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.obs.incident import get_incidents
from clonos_tpu_torch.obs.timeline import get_timeline
from clonos_tpu_torch.utils.jsonl import JsonlAppender, read_jsonl


def decision_row(decision: ScaleDecision) -> det.ScaleDeterminant:
    """The packed-row view of one decision. ``record_count`` carries
    the sequence number (nonzero — a SCALE row can never alias a sync
    anchor); the single target lane carries whichever dimension the
    action moves (workers for hold/scale-workers, replicas for
    scale-replicas)."""
    target = (decision.target_replicas
              if decision.action == SCALE_REPLICAS
              else decision.target_workers)
    return det.ScaleDeterminant(
        record_count=decision.seq, epoch=decision.epoch,
        action=ACTION_CODES[decision.action], delta=decision.delta,
        target=target, signal_crc=decision.signal_crc)


class DecisionLog:
    """Append-only SCALE determinant log + JSONL signal sidecar.

    ``path=None`` keeps both in memory (unit tests).
    On-disk layout: ``<path>`` holds contiguous packed rows
    (``determinant.to_bytes`` encoding — the byte-identity the tests
    compare), ``<path>.signals.jsonl`` one record per decision with the
    canonical signal snapshot and the decision dict. Both loads are
    tail-tolerant (a torn final row / line is dropped), the repo-wide
    append-log convention.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: List[np.ndarray] = []
        self.records: List[Dict[str, Any]] = []   # {"signals":…, "decision":…}
        self._sidecar_writer = None
        if path is not None:
            self._sidecar_writer = JsonlAppender(self.sidecar_path,
                                                 sort_keys=True)
            if os.path.exists(path):
                self._load()

    @property
    def sidecar_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".signals.jsonl"

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            data = f.read()
        whole = len(data) - len(data) % det.ROW_BYTES
        self.rows = list(det.from_bytes(data[:whole]))
        self.records = []
        if os.path.exists(self.sidecar_path):
            # Shared torn-tail discipline (utils/jsonl): a SIGKILLed
            # writer's torn final line is dropped; mid-file junk raises
            # naming file:line instead of silently truncating replay.
            self.records = read_jsonl(self.sidecar_path,
                                      label=self.sidecar_path)
        if len(self.records) < len(self.rows):
            # a torn sidecar invalidates replay for the rows past it —
            # truncate to the shorter prefix, both views must agree.
            self.rows = self.rows[:len(self.records)]
        self.records = self.records[:len(self.rows)]

    def append_scale_determinant(self, row: det.ScaleDeterminant,
                                 signals: ScaleSignals,
                                 decision: ScaleDecision) -> None:
        packed = row.pack()
        rec = {"signals": json.loads(signals.canonical()),
               "decision": decision.to_dict()}
        self.rows.append(packed)
        self.records.append(rec)
        if self.path is not None:
            with open(self.path, "ab") as f:
                f.write(det.to_bytes(packed.reshape(1, -1)))
            # Sidecar rides the shared durable appender (utils/jsonl):
            # same flush-per-record policy as every other JSONL log.
            self._sidecar_writer.append(rec)

    def determinants(self) -> List[det.ScaleDeterminant]:
        return [det.Determinant.unpack(r) for r in self.rows]

    def to_bytes(self) -> bytes:
        if not self.rows:
            return b""
        return det.to_bytes(np.stack(self.rows))

    def digest(self) -> str:
        return hashlib.blake2b(self.to_bytes(), digest_size=8).hexdigest()

    def __len__(self) -> int:
        return len(self.rows)


class AutoscaleController:
    """Closes the loop: signals in, logged decision out, re-cut at the
    fence. See module docstring for the protocol; the step methods
    (``observe`` → ``note_fence`` → ``decide`` → ``execute``) mirror
    the reference's ScalePolicyModel actions one-to-one, and
    ``on_fence`` bundles them for a driver's fence loop."""

    def __init__(self, policy: Optional[ScalePolicy] = None, *,
                 log: Optional[DecisionLog] = None,
                 execute_workers: Optional[Callable[[int], Any]] = None,
                 add_replica: Optional[Callable[[], Any]] = None,
                 drop_replica: Optional[Callable[[], Any]] = None,
                 healthy: Optional[Callable[[], bool]] = None,
                 mesh=None):
        self.policy = policy if policy is not None else ScalePolicy()
        #: a task mesh whose ranks each drive a controller in lockstep
        #: (``parallel/distributed.py``): rank 0 decides and logs, and
        #: every rank executes the worker re-cut it decided, at the same
        #: fence (over a gloo group of its own, made here in lockstep)
        self.mesh = mesh
        self._group = None
        if mesh is not None:
            from clonos_tpu_torch.parallel import distributed as dist_
            self._group = dist_.fence_group(mesh)
        # identity check, not truthiness: an empty DecisionLog is falsy
        self.log = log if log is not None else DecisionLog()
        self._execute_workers = execute_workers
        self._add_replica = add_replica
        self._drop_replica = drop_replica
        self._healthy = healthy or (lambda: True)
        self.transition_observers: List[Callable[..., None]] = []
        self.state = PolicyState()
        self.pending: Optional[ScaleDecision] = None
        self._signals: Optional[ScaleSignals] = None
        self._fence: int = -1
        self._logged_by_epoch: Dict[int, ScaleDecision] = {}
        # counters surfaced as autoscale.* gauges
        self.decisions_total = 0
        self.rescales_executed = 0
        self.replicas_added = 0
        self.replicas_dropped = 0
        self.replayed_decisions = 0
        self.refusals = 0
        if len(self.log):
            self._replay_log()

    def bind(self, *, execute_workers=None, add_replica=None,
             drop_replica=None, healthy=None) -> "AutoscaleController":
        """Late-bind execution callbacks (a driver builds its
        harness after the controller exists). Only non-None arguments
        replace the current binding; returns self for chaining."""
        if execute_workers is not None:
            self._execute_workers = execute_workers
        if add_replica is not None:
            self._add_replica = add_replica
        if drop_replica is not None:
            self._drop_replica = drop_replica
        if healthy is not None:
            self._healthy = healthy
        return self

    # --- recovery: replay the log, never re-decide ---------------------------

    def _replay_log(self) -> None:
        """Rebuild PolicyState by re-running the pure policy over the
        logged signal snapshots, proving each reproduced decision equals
        its logged row bit-for-bit along the way."""
        st = PolicyState()
        for i, (row, rec) in enumerate(zip(self.log.rows,
                                           self.log.records)):
            logged = det.Determinant.unpack(row)
            sig = ScaleSignals.from_dict(rec["signals"])
            if sig.crc() != logged.signal_crc:
                self._signal_conformance(i, "signal-crc-pin")
                raise ValueError(
                    f"decision log entry {i}: signal sidecar fails its "
                    f"crc pin (crc {sig.crc():#x} != logged "
                    f"{logged.signal_crc:#x})")
            dec, st = self.policy.decide(sig, st)
            if not np.array_equal(decision_row(dec).pack(), row):
                self._signal_conformance(i, "decision-replay")
                raise ValueError(
                    f"decision log entry {i} does not replay "
                    f"bit-identically: policy now yields {dec}")
            self._logged_by_epoch[dec.epoch] = dec
        self.state = st

    @staticmethod
    def _signal_conformance(entry: int, check: str) -> None:
        """Replay-not-re-decide broke: capture a bundle before the
        raise tears the process down (no-op when disabled)."""
        get_incidents().signal("conformance.mismatch",
                               source="decision-log-replay",
                               entry=entry, check=check)

    # --- protocol steps (model-action aligned) -------------------------------

    def _observe_hooks(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

    def observe(self, signals: ScaleSignals) -> None:
        """Take this fence's signal snapshot (model action: signal)."""
        self._signals = signals
        self._observe_hooks("observe", epoch=signals.epoch,
                            load=signals.load)

    def note_fence(self, epoch: int) -> None:
        """A fence completed and drained (model action: fence)."""
        self._fence = int(epoch)
        self._observe_hooks("fence", epoch=int(epoch))

    def decide(self) -> ScaleDecision:
        """Evaluate the policy on the last observed snapshot (model
        action: decide). Fences already in the log return the LOGGED
        decision — no policy call, no append, no pending execution."""
        if self._signals is None:
            raise RuntimeError("decide() before observe()")
        s = self._signals
        replayed = self._logged_by_epoch.get(s.epoch)
        if replayed is not None:
            self.replayed_decisions += 1
            self._observe_hooks("decide", epoch=replayed.epoch,
                                action=replayed.action,
                                seq=replayed.seq, replayed=True)
            return replayed
        decision, self.state = self.policy.decide(s, self.state)
        self.decisions_total += 1
        self.log.append_scale_determinant(decision_row(decision), s,
                                          decision)
        self._logged_by_epoch[decision.epoch] = decision
        self._observe_hooks("decide", epoch=decision.epoch,
                            action=decision.action, seq=decision.seq,
                            replayed=False)
        self._observe_hooks("log", seq=decision.seq)
        tl = get_timeline()
        if tl.enabled:
            tl.record("scale.decision", epoch=decision.epoch,
                      action=decision.action, seq=decision.seq,
                      reason=decision.reason, signal_crc=s.crc())
        if decision.scales:
            self.pending = decision
        return decision

    def execute(self) -> Optional[ScaleDecision]:
        """Carry out the pending scale action, if still safe (model
        action: execute). Health is re-checked HERE, not just at decide
        time — a failure can land between the two, and executing a
        re-cut over an in-progress recovery is the seeded
        ``rescale-mid-recovery`` bug the model proves fatal."""
        return self._execute(self._healthy())

    def _execute(self, healthy: bool) -> Optional[ScaleDecision]:
        """:meth:`execute` on a health reading already taken (a mesh's
        rank 0 sends the re-cut it reads as safe before it runs it)."""
        if self.pending is None:
            return None
        decision, self.pending = self.pending, None
        if not healthy:
            self.refusals += 1
            self._observe_hooks("refuse", epoch=decision.epoch,
                                action=decision.action)
            return None
        if decision.action == SCALE_WORKERS:
            if self._execute_workers is not None:
                self._execute_workers(decision.target_workers)
            self.rescales_executed += 1
        elif decision.action == SCALE_REPLICAS:
            if decision.delta > 0:
                if self._add_replica is not None:
                    self._add_replica()
                self.replicas_added += 1
            else:
                if self._drop_replica is not None:
                    self._drop_replica()
                self.replicas_dropped += 1
        self._observe_hooks("execute", epoch=decision.epoch,
                            action=decision.action,
                            target=(decision.target_replicas
                                    if decision.action == SCALE_REPLICAS
                                    else decision.target_workers))
        return decision

    def on_fence(self, epoch: int, signals: ScaleSignals
                 ) -> Tuple[ScaleDecision, Optional[ScaleDecision]]:
        """A driver's one call per completed fence: observe,
        note the fence, decide, execute. Returns (decision, executed)
        where executed is None for holds / replays / refusals.

        On a multi-rank mesh rank 0 observes, decides and logs, and sends
        its decision and the worker re-cut it is about to run (None for
        none) to every rank (one object broadcast); each other rank runs
        that re-cut through its own ``execute_workers`` and returns the
        pair it received (a replica action runs on rank 0 alone)."""
        from clonos_tpu_torch.parallel import distributed as dist_
        if self.mesh is None or dist_.mesh_size(self.mesh) == 1:
            self.observe(signals)
            self.note_fence(epoch)
            decision = self.decide()
            return decision, self.execute()
        if dist_.mesh_rank(self.mesh) != 0:
            decision, recut = dist_.broadcast_object(None, self.mesh,
                                                     group=self._group)
            if recut is not None:
                if self._execute_workers is not None:
                    self._execute_workers(recut.target_workers)
                self.rescales_executed += 1
            return decision, recut
        self.observe(signals)
        self.note_fence(epoch)
        decision = self.decide()
        p = self.pending
        healthy = self._healthy() if p is not None else True
        recut = (p if p is not None and healthy
                 and p.action == SCALE_WORKERS else None)
        dist_.broadcast_object((decision, recut), self.mesh,
                               group=self._group)
        return decision, self._execute(healthy)

    def close(self) -> None:
        """Let go of the gloo group a mesh controller made (every rank
        calls it, once it makes no further decision)."""
        if self._group is not None:
            import torch.distributed as dist
            dist.destroy_process_group(self._group)
            self._group = None

    # --- observability -------------------------------------------------------

    def register_gauges(self, registry, *,
                        actual_workers: Callable[[], int] = None,
                        actual_replicas: Callable[[], int] = None
                        ) -> None:
        """``autoscale.*`` gauges into a MetricRegistry — ride the same
        heartbeat piggyback / ``cluster_metrics()`` rollup the signal
        plane samples from, and render as the ``top`` verb's
        autoscale: row."""
        g = registry.group("autoscale")
        g.gauge("decisions-total", lambda: self.decisions_total)
        g.gauge("rescales-executed", lambda: self.rescales_executed)
        g.gauge("replicas-added", lambda: self.replicas_added)
        g.gauge("replicas-dropped", lambda: self.replicas_dropped)
        g.gauge("replayed-decisions", lambda: self.replayed_decisions)
        g.gauge("cooldown-active", lambda: self.state.cooldown)
        g.gauge("last-action",
                lambda: ACTION_CODES.get(self.state.last_action, 0))
        g.gauge("target-workers", lambda: self._last_target("workers"))
        g.gauge("target-replicas", lambda: self._last_target("replicas"))
        if actual_workers is not None:
            g.gauge("actual-workers", actual_workers)
        if actual_replicas is not None:
            g.gauge("actual-replicas", actual_replicas)

    def _last_target(self, dim: str) -> int:
        for rec in reversed(self.log.records):
            return int(rec["decision"]["target_" + dim])
        return 0

    def last_decision(self) -> Optional[ScaleDecision]:
        for rec in reversed(self.log.records):
            return ScaleDecision(**rec["decision"])
        return None
