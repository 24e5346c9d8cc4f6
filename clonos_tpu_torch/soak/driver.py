"""Open-loop soak driver: fixed-rate load + chaos + exactly-once audit
(port of ``clonos_tpu/soak/driver.py``).

The driver paces a live :class:`ClusterRunner` with a token bucket: a
chunk of supersteps is DUE at a fixed schedule (``rate`` records/sec),
regardless of whether the cluster is keeping up. End-to-end latency is
measured from the chunk's *intended*-send instant — a chunk that runs
while the driver is busy recovering a kill is charged the whole stall,
which is what an open-loop client would have experienced (the
coordinated-omission correction the closed-loop bench numbers lack).

The chaos harness applies :class:`soak.chaos.ChaosEvent` faults to the
running cluster and, after every event, re-validates the audit ledger
against a fault-free **control twin**: a second runner of the same job,
same seed, logical time on both, advanced epoch-by-epoch to the soak
runner's last sealed epoch. Any digest divergence is an exactly-once
violation and fails the run — the Jepsen-style check the Clonos
reference delegates to flink-jepsen.

Kill scheduling detail: a kill is applied only in the epoch after a
*completing* fence (the driver forces one when a kill is due). With no
pending checkpoints, recovery ignores nothing, so the healthy tasks log
no IGNORE_CHECKPOINT determinants and the post-recovery digest chain
stays byte-comparable with the control twin — the audit asserts the
recovery itself was exactly-once, not merely that the run finished.

Where the port differs from the reference: the ``nondet`` fault salts
the rings with ``torch.where`` on their device. The verdict's
``census_fingerprint`` is the port's own (analysis/census.py over
``clonos_tpu_torch``), the value ``clonos_tpu_torch/.clonos-census``
pins.
Threads: the ``stall`` fault's storage wrapper runs on the pipelined
fence worker and only sleeps; the perturbation, the recoveries and the
re-cuts run on the driving thread. A steady paced chunk reads host
counters only (``step_in_epoch``); ``records_per_step`` is derived after
``drain_fence()``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from clonos_tpu_torch.autoscale import SignalAggregator
from clonos_tpu_torch.obs.detect import GraySnapshot, get_detector
from clonos_tpu_torch.obs.digest import diff_ledgers
from clonos_tpu_torch.obs.trace import get_tracer

from .chaos import ChaosEvent, ChaosSchedule
from .slo import SLOSpec, SLOTracker, quantile

#: multiplicative salt for the injected nondeterminism fault — the
#: examples/audit_nondet.py pattern: perturb ring VALUES only (keys,
#: counts, and ordering stay plausible) so every structural invariant
#: passes and only the digest chain catches it.
_NONDET_MULT, _NONDET_ADD, _NONDET_MOD = 31, 1009, 9973


def _salted(values: torch.Tensor) -> torch.Tensor:
    """``(v * 31 + 1009) % 9973`` as the reference computes it on int32:
    the product and the sum wrap at 32 bits, and ``%`` is the floor
    modulo (a non-negative result)."""
    w = values.to(torch.int64) * _NONDET_MULT + _NONDET_ADD
    w = (w + (1 << 31)) % (1 << 32) - (1 << 31)
    return torch.remainder(w, _NONDET_MOD).to(values.dtype)


def _keyed_parallelism(runner) -> int:
    """The re-cuttable cut: the keyed (interior) stages' parallelism —
    the quantity ``rescale_live``'s target names. Source and sink keep
    theirs across a re-cut, so only interior vertices count."""
    job = runner.job
    pars = [v.parallelism for v in job.vertices
            if job.in_edges(v.vertex_id) and job.out_edges(v.vertex_id)]
    if not pars:
        pars = [v.parallelism for v in job.vertices]
    return max(pars)


def _max_actions_per_cooldown(records, cooldown: int) -> int:
    """Worst-case count of SCALE ACTIONS (non-holds) inside any
    ``cooldown``-fence window of the decision log — the verdict's
    rate-limit witness (must be <= 1 when the cooldown held)."""
    seqs = [r["decision"]["seq"] for r in records
            if r["decision"]["action"] != "hold"]
    best = 0
    for i, s in enumerate(seqs):
        n = sum(1 for t in seqs[i:] if t - s < cooldown)
        best = max(best, n)
    return best


class SoakHarness:
    """Applies chaos events to a live runner and owns the post-event
    audit re-validation against the fault-free control twin."""

    def __init__(self, runner, control=None, election=None, tracer=None):
        self.runner = runner
        self.control = control
        self.election = election
        self.tracer = tracer or get_tracer()
        #: flat subtask -> soak-clock instant its gray failure expires
        self.gray_until: Dict[int, float] = {}
        #: current per-chunk transport slowdown from active gray faults
        self.gray_delay_s = 0.0
        self._stall_orig = None
        self._stall_until = 0.0
        #: soak-clock instant until which checkpoint completion is
        #: suppressed (the `backlog` fault): truncation stops, the
        #: replay backlog grows past the device rings into the spill
        #: tiers (storage/tiered.py), and any recovery in that window
        #: replays from host/disk segments.
        self.backlog_until = 0.0
        #: set on every applied fault; the driver runs an audit check at
        #: the next fence and clears it
        self.audit_pending = False
        self.divergences: List[str] = []
        self.epochs_checked = 0
        self.faults_injected = 0
        self.faults_survived = 0
        self.by_kind: Dict[str, int] = {}
        self.recoveries_ms: List[float] = []
        #: per-kill overlapped-recovery evidence: every chaos kill runs
        #: the overlapped finalize tail, so each appends its
        #: finalize.overlap-saved attribution and the immediate
        #: post-recovery ledger re-diff vs the control twin (must stay
        #: empty — a mis-speculated replay is caught HERE, before the
        #: job resumes, not at the next fence).
        self.kill_overlap_saved_ms: List[float] = []
        self.kill_rediff_problems = 0
        #: kills that landed while the PIPELINED fence tail (seal /
        #: ledger / checkpoint on the fence worker) was still in
        #: flight — inject_failure joins the tail first, so each such
        #: kill proves the drain ordering under fire.
        self.kills_mid_fence_tail = 0
        #: read tier under test (runtime/serve.ServeTier), attached by
        #: the driver when a serve read load rides the run — the
        #: ``replica-kill`` fault targets it (and a ``rescale`` re-homes
        #: it onto the new incarnation).
        self.serve_tier = None
        self.replica_kills = 0
        #: live re-cuts applied (the ``rescale`` chaos event): count and
        #: per-event handoff stats for the verdict
        self.rescales = 0
        self.rescale_stats: List[Dict[str, Any]] = []
        #: offered-load spike (the ``load-spike`` chaos event): the
        #: token bucket's chunk period divides by this factor until the
        #: expiry instant. Pacing ONLY — record contents are logical-
        #: time-deterministic on both runners, so the fault-free
        #: control twin experiences the identical spike and the ledger
        #: diff keeps gating byte-exactly through it.
        self.spike_factor = 1.0
        self.spike_until = 0.0
        #: self-directed re-cuts (autoscale/controller.py closing the
        #: loop): counted apart from the operator ``rescale`` event —
        #: the closed-loop acceptance bar is ZERO operator events with
        #: the system re-cutting itself.
        self.autoscale_rescales = 0
        self.autoscale_stats: List[Dict[str, Any]] = []

    # --- fault application ---------------------------------------------------

    def apply(self, event: ChaosEvent, now_s: float) -> None:
        """Apply one fault NOW (``now_s`` is the soak clock, for expiry
        bookkeeping + the trace instant)."""
        self.tracer.event("soak.chaos", kind=event.kind,
                          at_s=round(now_s, 3),
                          targets=list(event.targets))
        from clonos_tpu_torch.obs.timeline import get_timeline
        tl = get_timeline()
        if tl.enabled:
            tl.record("chaos", chaos_kind=event.kind,
                      at_s=round(now_s, 3), targets=list(event.targets))
        self.faults_injected += 1
        self.by_kind[event.kind] = self.by_kind.get(event.kind, 0) + 1
        getattr(self, "_apply_" + event.kind.replace("-", "_"))(
            event, now_s)
        self.audit_pending = True

    def _apply_kill(self, event: ChaosEvent, now_s: float) -> None:
        # Cascading SIGKILL mid-epoch (the config4 pattern when the
        # schedule targets one subtask per vertex class), then the full
        # causal-recovery protocol inline — the pacer keeps charging
        # intended-send time throughout, so the outage lands in p99.
        r = self.runner
        r.inject_failure(list(event.targets))
        t0 = _time.monotonic()
        report = r.recover()
        ms = (_time.monotonic() - t0) * 1e3
        self.recoveries_ms.append(ms)
        self.faults_survived += 1
        # Overlapped-tail acceptance, under fire: record the kill's
        # finalize.overlap-saved attribution (present == the overlapped
        # pipeline ran) and re-diff the ledger against the fault-free
        # control twin IMMEDIATELY — not only at the next fence — so a
        # mis-speculated replay is caught before the job resumes.
        saved = report.phase_ms.get("finalize.overlap-saved", 0.0)
        self.kill_overlap_saved_ms.append(round(saved, 1))
        rediff = self.audit_check()
        self.kill_rediff_problems += len(rediff)
        self.tracer.event("soak.chaos.recovered", kind="kill",
                          targets=list(event.targets),
                          recovery_ms=round(ms, 1),
                          overlap_saved_ms=round(saved, 1),
                          rediff_problems=len(rediff))

    def _apply_gray(self, event: ChaosEvent, now_s: float) -> None:
        # Degraded, not dead: the worker's heartbeats arrive late and
        # its transport stretches every chunk, but it keeps stepping.
        # The monitor must report it in degraded(), never in expired().
        flat = event.targets[0]
        self.runner.heartbeats.lag[flat] = event.delay_s
        self.gray_until[flat] = now_s + event.duration_s
        self.gray_delay_s = max(self.gray_delay_s, event.delay_s)

    def _apply_leader_loss(self, event: ChaosEvent, now_s: float) -> None:
        # A rival claims the next fencing epoch: our renew() becomes a
        # no-op for every reader and returns False. The driver pauses
        # ingestion while deposed and re-acquires once the rival's
        # deadline lapses (hold_s).
        el = self.election
        if el is None:
            return
        import json as _json
        epoch = (el.epoch or max(el._claims() or [0])) + 1
        tmp = el._claim_path(epoch) + ".chaos.tmp"
        with open(tmp, "w") as f:
            _json.dump({"leader_id": "chaos-rival",
                        "deadline_wall": el._clock() + event.hold_s}, f)
        os.replace(tmp, el._claim_path(epoch))

    def _apply_stall(self, event: ChaosEvent, now_s: float) -> None:
        # Checkpoint-storage write stall: every durable write sleeps
        # delay_s for the fault's duration. run_epoch triggers with
        # async_write=False, so the stall lands squarely in fence
        # latency (and therefore in the corrected latency of the chunks
        # queued behind it).
        storage = self.runner.coordinator.storage
        if self._stall_orig is None:
            self._stall_orig = storage.write
        orig, delay = self._stall_orig, event.delay_s

        def stalled_write(*a, **k):
            _time.sleep(delay)
            return orig(*a, **k)

        storage.write = stalled_write
        # The same fault tortures the spill path: segment writes on the
        # tiered stores' writer threads sleep too. The fence must NOT
        # stretch by this (spilling is asynchronous — the soak stall
        # scenario pins exactly that), and replay through the stalled
        # tier must still round-trip bit-identically.
        for st in self.runner.executor._tier_stores():
            st.write_delay_s = max(st.write_delay_s, delay)
        self._stall_until = max(self._stall_until,
                                now_s + event.duration_s)

    def _apply_backlog(self, event: ChaosEvent, now_s: float) -> None:
        # Long-backlog torture: the driver suppresses checkpoint
        # completion while active (see _run_paced), so truncation stops
        # and sealed epochs pile up past device ring capacity — replay
        # after this window MUST refill from the host/disk tiers.
        self.backlog_until = max(self.backlog_until,
                                 now_s + event.duration_s)

    def backlog_active(self, now_s: float) -> bool:
        return now_s < self.backlog_until

    def _apply_load_spike(self, event: ChaosEvent,
                          now_s: float) -> None:
        # Not a fault in the cluster — a LOAD event: the open-loop
        # client offers chunks factor-x faster for the window (the
        # autoscaler's cue). Only wall-clock pacing changes; logical
        # time keeps record contents identical on both runners, so the
        # control twin's ledger stays byte-comparable through the
        # spike and the exactly-once audit keeps gating.
        self.spike_factor = max(self.spike_factor, event.factor)
        self.spike_until = max(self.spike_until,
                               now_s + event.duration_s)
        self.tracer.event("soak.chaos.load-spike",
                          factor=event.factor,
                          until_s=round(self.spike_until, 3))

    def rate_factor(self, now_s: float) -> float:
        """Current offered-rate multiplier (1.0 outside a spike)."""
        return self.spike_factor if now_s < self.spike_until else 1.0

    def _apply_replica_kill(self, event: ChaosEvent,
                            now_s: float) -> None:
        # Read-tier chaos: a serve replica dies mid-run. Degradation —
        # not failure — is the acceptance bar: the router re-routes the
        # dead replica's key groups to the owner (a counted REROUTE,
        # zero client-visible errors; the read load's error counter is
        # the witness), staleness spikes, and the replica revives at the
        # next seal from the standby pool's restore point. No audit
        # impact: the read tier never writes job state.
        tier = self.serve_tier
        if tier is None:
            self.tracer.event("soak.chaos.replica-kill.skipped",
                              reason="no serve tier attached")
            return
        idx = event.targets[0] if event.targets else 0
        tier.kill_replica(idx)
        self.replica_kills += 1
        self.faults_survived += 1
        self.tracer.event("soak.chaos.replica-kill", replica=idx)

    def _apply_rescale(self, event: ChaosEvent, now_s: float) -> None:
        # Elastic re-cut under live traffic: at the completing fence the
        # driver just forced, hand the job off to a new incarnation at
        # the event's keyed parallelism (fence -> drain -> migrate ->
        # redirect; runtime/cluster.rescale_live). The control twin is
        # re-cut identically at the SAME fence, so the ledger diff stays
        # byte-comparable across the re-cut — exactly-once over a live
        # repartition is audited, not assumed.
        target = int(event.targets[0])
        rescale = getattr(self.runner, "_soak_rescaler", None)
        if rescale is None:
            self.tracer.event("soak.chaos.rescale.skipped",
                              reason="runner has no rescaler attached")
            return
        if self._stall_orig is not None:
            # an active storage stall dies with the old incarnation —
            # restoring it later onto the NEW runner's storage would
            # rebind writes to the fenced-off one
            self.runner.coordinator.storage.write = self._stall_orig
            self._stall_orig = None
            for st in self.runner.executor._tier_stores():
                st.write_delay_s = 0.0
            self._stall_until = 0.0
        t0 = _time.monotonic()
        self.runner, stats = rescale(target)
        stall_ms = (_time.monotonic() - t0) * 1e3
        c = self.control
        if c is not None:
            while c.executor.epoch_id < stats["from_epoch"]:
                c.run_epoch(complete_checkpoint=True)
            c.drain_fence()
            self.control, _ = c._soak_rescaler(target)
        if self.serve_tier is not None:
            # read tier re-homes onto the new incarnation: reads in
            # the handoff window reroute to live views, never error
            self.serve_tier.rehome(self.runner)
        self.rescales += 1
        self.rescale_stats.append({
            "target": target,
            "fence_checkpoint": stats["fence_checkpoint"],
            "groups": stats["groups"],
            "drained_records": stats["drained_records"],
            "moved_key_groups": stats["moved_key_groups"],
            "fence_stall_ms": round(stall_ms, 1),
        })
        # the fence stall is an outage the open-loop client saw:
        # charge it like a recovery so SLO windows see it
        self.recoveries_ms.append(stall_ms)
        self.faults_survived += 1
        self.tracer.event("soak.chaos.rescaled", target=target,
                          fence_checkpoint=stats["fence_checkpoint"],
                          drained=stats["drained_records"],
                          stall_ms=round(stall_ms, 1))

    def autoscale_rescale(self, target: int) -> Dict[str, Any]:
        """Execute an autoscaler-decided re-cut at the completed fence
        the driver just drained — the exact fence → drain → migrate →
        redirect path the operator ``rescale`` event takes (control
        twin re-cut identically at the SAME fence, serve tier re-homed)
        but charged to the AUTOSCALE ledger, not the fault counters:
        the closed-loop acceptance bar is zero operator events."""
        target = int(target)
        rescale = getattr(self.runner, "_soak_rescaler", None)
        if rescale is None:
            raise RuntimeError(
                "autoscale re-cut requested but the runner has no "
                "rescaler attached (build_soak_fixture arms one)")
        if self._stall_orig is not None:
            # same rule as the operator path: an active storage stall
            # dies with the old incarnation
            self.runner.coordinator.storage.write = self._stall_orig
            self._stall_orig = None
            for st in self.runner.executor._tier_stores():
                st.write_delay_s = 0.0
            self._stall_until = 0.0
        t0 = _time.monotonic()
        self.runner, stats = rescale(target)
        stall_ms = (_time.monotonic() - t0) * 1e3
        c = self.control
        if c is not None:
            while c.executor.epoch_id < stats["from_epoch"]:
                c.run_epoch(complete_checkpoint=True)
            c.drain_fence()
            self.control, _ = c._soak_rescaler(target)
        if self.serve_tier is not None:
            self.serve_tier.rehome(self.runner)
        self.autoscale_rescales += 1
        self.autoscale_stats.append({
            "target": target,
            "fence_checkpoint": stats["fence_checkpoint"],
            "groups": stats["groups"],
            "drained_records": stats["drained_records"],
            "moved_key_groups": stats["moved_key_groups"],
            "fence_stall_ms": round(stall_ms, 1),
        })
        # the fence stall is still an outage the open-loop client saw
        self.recoveries_ms.append(stall_ms)
        # re-validate exactly-once at the next fence, like any re-cut
        self.audit_pending = True
        self.tracer.event("soak.autoscale.rescaled", target=target,
                          fence_checkpoint=stats["fence_checkpoint"],
                          drained=stats["drained_records"],
                          stall_ms=round(stall_ms, 1))
        return stats

    def _apply_nondet(self, event: ChaosEvent, now_s: float) -> None:
        # Unlogged value perturbation on-device (audit bait): occupied
        # in-flight ring slots get salted values. Counts, keys, and
        # timestamps stay exactly right — the next seal's ring-channel
        # digest is the only thing that can catch this.
        ex = self.runner.executor
        rings = tuple(
            el._replace(values=torch.where(el.valid, _salted(el.values),
                                           el.values))
            for el in ex.carry.out_rings)
        ex.carry = ex.carry._replace(out_rings=rings)

    # --- expiry + audit ------------------------------------------------------

    def tick(self, now_s: float) -> None:
        """Expire time-bounded degradations (gray, stall)."""
        for flat, until in list(self.gray_until.items()):
            if now_s >= until:
                del self.gray_until[flat]
                self.runner.heartbeats.lag.pop(flat, None)
                self.faults_survived += 1
                self.tracer.event("soak.chaos.expired", kind="gray",
                                  target=flat)
        if not self.gray_until:
            self.gray_delay_s = 0.0
        if self._stall_orig is not None and now_s >= self._stall_until:
            self.runner.coordinator.storage.write = self._stall_orig
            self._stall_orig = None
            for st in self.runner.executor._tier_stores():
                st.write_delay_s = 0.0
            self.faults_survived += 1
            self.tracer.event("soak.chaos.expired", kind="stall")
        if self.backlog_until and now_s >= self.backlog_until:
            self.backlog_until = 0.0
            self.faults_survived += 1
            self.tracer.event("soak.chaos.expired", kind="backlog")
        if self.spike_until and now_s >= self.spike_until:
            self.spike_until = 0.0
            self.spike_factor = 1.0
            self.faults_survived += 1
            self.tracer.event("soak.chaos.expired", kind="load-spike")

    def audit_check(self) -> List[str]:
        """Advance the control twin to the soak runner's last sealed
        epoch and diff the two ledgers. Divergences accumulate; any at
        run end means exactly-once did NOT hold."""
        r, c = self.runner, self.control
        if c is None or not r.auditor.enabled:
            return []
        while c.auditor.last_epoch < r.auditor.last_epoch:
            c.run_epoch(complete_checkpoint=True)
        hi = r.auditor.last_epoch
        expected = [e for e in c.auditor.ledger() if e["epoch"] <= hi]
        actual = [e for e in r.auditor.ledger() if e["epoch"] <= hi]
        problems = diff_ledgers(expected, actual)
        self.epochs_checked = max(self.epochs_checked, len(actual))
        for p in problems:
            if p not in self.divergences:
                self.divergences.append(p)
                self.tracer.event("soak.audit.divergence", problem=p)
                # Capture the flight-recorder bundle while both
                # ledgers + determinant windows are still in hand
                # (no-op when the incident plane is disabled).
                from clonos_tpu_torch.obs.incident import get_incidents
                m = re.match(r"epoch (\d+)", p)
                get_incidents().signal(
                    "audit.divergence",
                    epoch=int(m.group(1)) if m else None,
                    problem=p)
        return problems


@dataclasses.dataclass
class SoakConfig:
    """Pacing + cadence knobs for one soak run."""

    rate: float                  # records/sec the token bucket releases
    duration_s: float = 60.0
    window_s: float = 5.0        # SLO evaluation window
    chunk_steps: int = 8         # supersteps released per token
    #: complete every Nth checkpoint: the in-between fences leave their
    #: checkpoints pending, so the in-flight rings grow across epochs —
    #: checkpoint-under-load and the spill regime stay engaged.
    complete_every: int = 2
    #: beats later than this (but inside the death timeout) classify a
    #: worker as degraded
    degraded_grace_s: float = 0.01
    #: renew the leader lease at most this often
    renew_every_s: float = 0.5


class SoakDriver:
    """Runs the paced loop: token-bucket ingestion, chaos events on the
    soak clock, SLO windows, and a JSON verdict."""

    def __init__(self, runner, config: SoakConfig,
                 schedule: Optional[ChaosSchedule] = None,
                 spec: Optional[SLOSpec] = None,
                 control=None, election=None,
                 records_per_step: Optional[int] = None,
                 read_load=None, autoscaler=None, detector=None):
        self.runner = runner
        self.cfg = config
        self.schedule = schedule if schedule is not None \
            else ChaosSchedule([])
        self.spec = spec or SLOSpec()
        self.tracer = get_tracer()
        self.harness = SoakHarness(runner, control=control,
                                   election=election,
                                   tracer=self.tracer)
        #: mixed-load read side (soak.serveload.ServeLoad): pumped once
        #: per ingest chunk so reads contend with live ingestion, and
        #: the replica-kill fault has a tier to hit.
        self.read_load = read_load
        if read_load is not None:
            self.harness.serve_tier = read_load.tier
        self.slo = SLOTracker(self.spec, window_s=config.window_s,
                              tracer=self.tracer)
        self.records_per_step = records_per_step
        #: wall seconds of the runner's ``prewarm_recovery()`` before the
        #: paced clock started (None before :meth:`run`)
        self.prewarm_s: Optional[float] = None
        self._rate_now = 0.0
        self._backlog_chunks = 0
        self._truncated = False
        self._soak_now = 0.0
        #: closed-loop policy engine (autoscale.AutoscaleController):
        #: when attached, the driver samples ScaleSignals at every
        #: completed+drained fence and lets the controller decide and
        #: execute — worker re-cuts ride harness.autoscale_rescale
        #: (zero operator events), replica moves ride the serve tier.
        #: gray-failure detector (obs/detect.py): scored at every
        #: completed+drained fence; its sustained-suspect count feeds
        #: the signal plane's unhealthy arm. Defaults to the process
        #: detector — NullDetector unless configure_detector() ran.
        self.detector = detector if detector is not None \
            else get_detector()
        self.autoscaler = autoscaler
        self._signals = None
        if autoscaler is not None:
            self._signals = SignalAggregator()
            tier = self.harness.serve_tier
            autoscaler.bind(
                execute_workers=self.harness.autoscale_rescale,
                add_replica=(tier.add_replica if tier is not None
                             else None),
                drop_replica=(tier.drop_replica if tier is not None
                              else None),
                healthy=lambda: (
                    not self.runner.heartbeats.expired()
                    and not self.runner.fence_tail_in_flight()))
        self._register_gauges()
        self._attach_incident_providers()

    def _attach_incident_providers(self) -> None:
        """Hand the flight recorder (obs/incident.py) the soak run's
        evidence sources: both ledgers (runner vs control twin), both
        determinant windows, the chaos schedule, the decision log, the
        cluster metrics rollup, and the run config. Providers are
        closures over live objects — the manager snapshots through
        them only at capture time, so the enabled-but-quiet cost is
        zero; when the plane is disabled this attaches nothing at
        all."""
        from clonos_tpu_torch.obs.incident import (capture_epoch_window,
                                                   get_incidents)
        mgr = get_incidents()
        if not mgr.enabled:
            return

        def ledgers():
            out = {"actual": list(self.runner.auditor.ledger())}
            if self.harness.control is not None:
                out["expected"] = list(
                    self.harness.control.auditor.ledger())
            return out

        def det_window(epoch):
            out = {"actual": capture_epoch_window(
                self.runner.executor, epoch)}
            if self.harness.control is not None:
                out["expected"] = capture_epoch_window(
                    self.harness.control.executor, epoch)
            return out

        mgr.attach(
            ledgers=ledgers,
            det_window=det_window,
            chaos=lambda: self.schedule.to_text(),
            metrics=lambda: [{"metrics": self.runner.metrics.snapshot()}],
            decisions=lambda: (list(self.autoscaler.log.records)
                               if self.autoscaler is not None else []),
            config=lambda: {"rate": self.cfg.rate,
                            "duration_s": self.cfg.duration_s,
                            "window_s": self.cfg.window_s,
                            "chunk_steps": self.cfg.chunk_steps},
        )
        mgr.register_gauges(self.runner.metrics)

    def _register_gauges(self) -> None:
        g = self.runner.metrics.group("soak")
        cfg, h, slo = self.cfg, self.harness, self.slo
        g.gauge("target-rate", lambda: cfg.rate)
        # what the open-loop client is CURRENTLY offering: the base
        # rate times any live load-spike factor — the signal plane's
        # numerator (autoscale/signals.py reads it by suffix).
        g.gauge("offered-rate", lambda: round(
            cfg.rate * h.rate_factor(self._soak_now), 1))
        g.gauge("rate", lambda: round(self._rate_now, 1))
        g.gauge("backlog-chunks", lambda: self._backlog_chunks)
        g.gauge("windows-breached",
                lambda: len(slo.breached_windows()))
        g.gauge("faults-injected", lambda: h.faults_injected)
        g.gauge("faults-survived", lambda: h.faults_survived)
        g.gauge("p99-ms", lambda: round(quantile(
            (slo.closed[-1].corrected_ms if slo.closed
             else slo.current.corrected_ms), 0.99), 3))
        g.gauge("audit-ok", lambda: int(not h.divergences))
        g.gauge("rescales", lambda: h.rescales)
        g.gauge("degraded-workers", lambda: len(
            self.runner.heartbeats.degraded(cfg.degraded_grace_s)))
        if self.detector.enabled:
            # cluster.health.* rides the same rollup — re-registered
            # (like soak.*) on the NEW incarnation's registry
            self.detector.register_gauges(self.runner.metrics)
        if self.autoscaler is not None:
            # autoscale.* rides the same rollup — re-registered (like
            # soak.*) on the NEW incarnation's registry after a re-cut
            self.autoscaler.register_gauges(
                self.runner.metrics,
                actual_workers=lambda: _keyed_parallelism(self.runner),
                actual_replicas=lambda: (
                    len(self.read_load.tier.replicas)
                    if self.read_load is not None else 0))

    # --- leadership gate -----------------------------------------------------

    def _leadership_gate(self, soak_now: float) -> None:
        el = self.harness.election
        if el is None:
            return
        if soak_now < getattr(self, "_next_renew_s", 0.0):
            return
        self._next_renew_s = soak_now + self.cfg.renew_every_s
        if el.renew():
            return
        # Deposed: ingestion pauses (split-brain structurally excluded —
        # a non-leader never fences deployments) while records keep
        # queueing on the intended schedule; the pause is an outage the
        # corrected latency and max_recovery_ms both see.
        self.tracer.event("soak.leader.lost")
        t0 = _time.monotonic()
        while not el.try_acquire():
            _time.sleep(0.02)
        ms = (_time.monotonic() - t0) * 1e3
        self.harness.recoveries_ms.append(ms)
        self.harness.faults_survived += 1
        self.slo.observe_recovery(soak_now, ms)
        self.tracer.event("soak.leader.reacquired",
                          pause_ms=round(ms, 1))

    # --- gray-failure detection ----------------------------------------------

    def _detect_fence(self, r, ex) -> None:
        """One detector evaluation at a completed+drained fence: build
        the pinnable :class:`GraySnapshot` off the same rollup the
        signal plane samples (plus the heartbeat monitor's peer-relative
        ages) and run the pure scorer. Emits ``health.gray-suspect``
        timeline events and updates the ``cluster.health.suspects``
        gauge — BEFORE the autoscale sample of the same fence, so the
        policy's unhealthy arm sees this fence's verdict."""
        snap = r.metrics.snapshot()
        staleness = {
            k[:-len(".staleness-epochs")]: float(v)
            for k, v in snap.items()
            if k.endswith(".staleness-epochs")
            and isinstance(v, (int, float))}
        epoch_ms = {}
        for k, v in snap.items():
            # per-worker epoch timing from the cluster rollup
            # (worker.<eid>.….epoch.steps-ms histograms)
            if k.endswith(".epoch.steps-ms") and k.startswith("worker.") \
                    and isinstance(v, dict):
                epoch_ms[k.split(".", 2)[1]] = float(v.get("mean", 0.0))
        stall = 0.0
        for k, v in snap.items():
            if k.endswith("epoch.fence-ms") and isinstance(v, dict):
                stall = max(stall,
                            float(v.get("p99", 0.0))
                            - float(v.get("p50", 0.0)))
        self.detector.on_fence(GraySnapshot.build(
            epoch=ex.epoch_id,
            hb_age_ms={f"w{f}": a
                       for f, a in r.heartbeats.ages_ms().items()},
            epoch_ms=epoch_ms, staleness=staleness,
            fence_stall_ms=stall))

    # --- the closed loop -----------------------------------------------------

    def _autoscale_fence(self, r, ex, now_s: float):
        """One autoscaler evaluation at a completed+drained fence:
        sample :class:`ScaleSignals` off the metric rollup, let the
        controller decide (the decision and its snapshot land in the
        SCALE determinant log regardless of outcome) and execute. An
        executed worker re-cut swaps the runner incarnation underneath
        us — rebind every live handle and re-register the gauges,
        exactly like the operator ``rescale`` path. Returns the
        (possibly new) ``(runner, executor)`` pair."""
        h = self.harness
        sigs = self._signals.sample_from(
            r.metrics.snapshot(), epoch=ex.epoch_id,
            workers=_keyed_parallelism(r),
            failed_subtasks=len(r.heartbeats.expired()),
            unfenced=r.fence_tail_in_flight(),
            gray_suspects=len(self.detector.suspects()))
        decision, executed = self.autoscaler.on_fence(ex.epoch_id, sigs)
        if executed is not None and h.runner is not r:
            # a worker re-cut ran: the fence stall is an outage the
            # paced load paid — charge it like any recovery window
            self.slo.observe_recovery(now_s, h.recoveries_ms[-1])
            r = self.runner = h.runner
            ex = r.executor
            self._register_gauges()
        return r, ex

    # --- the paced loop ------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        cfg, r, h = self.cfg, self.runner, self.harness
        ex = r.executor
        spe = ex.steps_per_epoch
        if spe % cfg.chunk_steps:
            raise ValueError(
                f"steps_per_epoch {spe} must be a multiple of "
                f"chunk_steps {cfg.chunk_steps}")
        max_epochs = ex.compiled.max_epochs
        with self.tracer.span("soak", rate=cfg.rate,
                              duration_s=cfg.duration_s,
                              events=len(self.schedule)):
            verdict = self._run_paced(cfg, r, h, ex, spe, max_epochs)
        return verdict

    def _run_paced(self, cfg, r, h, ex, spe, max_epochs):
        # Warmup epoch 0 via run_epoch (staged program + restore point),
        # epoch 1 via step() chunks (the K=1 live program the paced loop
        # uses compiles here, off the measured clock).
        r.run_epoch(complete_checkpoint=True)
        for _ in range(spe):
            r.step()
        r.run_epoch(complete_checkpoint=True)   # fence-only: 0 steps left
        # deployed-standby analog: the recovery path's kernels load and
        # its shapes dispatch off the paced clock, so the first kill
        # measures the protocol
        self.prewarm_s = r.prewarm_recovery()
        # pipelined fence: _last_records_total is absorbed on the fence
        # worker — join any in-flight warmup tail before reading it
        r.drain_fence()
        if self.records_per_step is None:
            self.records_per_step = max(
                1, r._last_records_total // max(r.global_step, 1))
        rps = self.records_per_step
        chunk_records = cfg.chunk_steps * rps
        period_s = chunk_records / cfg.rate
        events = list(self.schedule)
        ei = 0
        due: List[ChaosEvent] = []
        pending_kills: List[ChaosEvent] = []
        pending_rescales: List[ChaosEvent] = []
        kill_armed = False       # last fence completed; no pendings
        force_complete = False
        fences = 0
        sent_chunks = 0
        sent_records = 0
        t0 = _time.monotonic()
        # accumulating token bucket: ``intended_s`` is the instant the
        # NEXT chunk is due. A live load-spike divides the period, so
        # the offered schedule genuinely accelerates mid-run (and the
        # corrected latency of every queued chunk is charged against
        # the spiked schedule, open-loop style).
        intended_s = 0.0

        while True:
            if intended_s >= cfg.duration_s:
                break
            if ex.epoch_id >= max_epochs - 2:
                self._truncated = True
                self.tracer.event("soak.truncated",
                                  epoch=ex.epoch_id)
                break
            now_s = _time.monotonic() - t0
            if now_s < intended_s:
                _time.sleep(intended_s - now_s)
                now_s = intended_s
            self._backlog_chunks = max(
                0, int((now_s - intended_s) / period_s))
            # -- due chaos events (soak clock): collected here, applied
            # AFTER the chunk — every fault lands mid-epoch, with this
            # epoch's window already holding live causal state for the
            # perturbation (nondet) or replay span (kill) to hit.
            while ei < len(events) and events[ei].at_s <= now_s:
                ev = events[ei]
                ei += 1
                if ev.kind == "kill":
                    # defer further, to the epoch after a completing
                    # fence: with nothing pending, recovery appends no
                    # IGNORE_CHECKPOINT determinants and the digest
                    # chain stays control-comparable (module docstring)
                    pending_kills.append(ev)
                    force_complete = True
                elif ev.kind == "rescale":
                    # a re-cut happens AT a completing fence (the
                    # protocol's fence phase) — defer like a kill,
                    # forcing the next fence to complete
                    pending_rescales.append(ev)
                    force_complete = True
                else:
                    due.append(ev)
            self._leadership_gate(now_s)
            # -- one chunk of supersteps (the token's worth of load)
            send_wall = _time.monotonic()
            for _ in range(cfg.chunk_steps):
                r.step()
            if h.gray_delay_s:
                # the degraded worker stretches the chunk's transport
                _time.sleep(h.gray_delay_s)
            done_wall = _time.monotonic()
            now_s = done_wall - t0
            self._soak_now = now_s
            sent_chunks += 1
            sent_records += chunk_records
            self._rate_now = sent_records / max(now_s, 1e-9)
            self.slo.observe(now_s,
                             corrected_ms=(now_s - intended_s) * 1e3,
                             actual_ms=(done_wall - send_wall) * 1e3,
                             records=chunk_records)
            # advance the bucket by one (possibly spiked) period — the
            # factor at the chunk's wall instant, so a spike window on
            # the soak clock accelerates exactly the chunks inside it
            intended_s += period_s / h.rate_factor(now_s)
            # -- read load rides the same clock: each ingest chunk is
            # chased by a burst of routed reads, so read latency and
            # staleness are measured UNDER concurrent ingest, and a
            # replica-kill mid-run shows up as reroutes + a staleness
            # spike in the read windows — never as client errors.
            if self.read_load is not None:
                self.read_load.pump(now_s)
            # -- collected events fire mid-epoch, right after a chunk
            for ev in due:
                h.apply(ev, now_s)
                self.slo.observe_fault(now_s, ev.kind)
                # A replica-kill's degradation window can close at the
                # very next seal (revival is one fence away) — chase it
                # with an immediate read burst so the reroutes and the
                # staleness spike are WITNESSED while the replica is
                # down, not inferred.
                if (ev.kind == "replica-kill"
                        and self.read_load is not None):
                    self.read_load.pump(now_s)
            due.clear()
            # -- armed kills fire mid-epoch, right after a chunk
            if kill_armed and pending_kills and ex.step_in_epoch > 0:
                for ev in pending_kills:
                    h.apply(ev, now_s)
                    self.slo.observe_fault(now_s, ev.kind)
                    if h.recoveries_ms:
                        self.slo.observe_recovery(
                            now_s, h.recoveries_ms[-1])
                pending_kills.clear()
                kill_armed = False
            # -- epoch fence
            if ex.step_in_epoch >= spe:
                # backlog fault: suppress completion (truncation stops,
                # the spill tiers absorb the sealed epochs), but a
                # deferred kill's fence still completes — the kill
                # invariant (no pendings at kill time) wins.
                complete = (force_complete
                            or (fences % cfg.complete_every == 0
                                and not h.backlog_active(now_s)))
                r.run_epoch(complete_checkpoint=complete)
                fences += 1
                if not complete and h.backlog_active(now_s):
                    # abandon immediately: suppressed fences must leave
                    # nothing pending either, or a kill in the backlog
                    # window appends IGNORE determinants the control
                    # twin never sees (digest divergence by design,
                    # not by bug). Pipelined fence: the in-flight tail
                    # is still creating this epoch's pending — join it
                    # first or the discard races the worker's trigger.
                    r.drain_fence()
                    r.coordinator.discard_pending_through(
                        ex.epoch_id - 1)
                if complete:
                    fence_drained = False
                    if pending_kills and r.fence_tail_in_flight():
                        # kill MID-fence-tail: abandon only the OLDER
                        # skipped checkpoints (sparing the in-flight
                        # epoch's), then fire the kill NOW, while the
                        # seal/ledger/checkpoint tail is still on the
                        # fence worker. inject_failure joins the tail
                        # first, so the seal and ack complete, nothing
                        # is pending at kill time, and recovery appends
                        # no IGNORE determinants — the digest chain
                        # stays byte-comparable with the control twin.
                        r.coordinator.discard_pending_through(
                            ex.epoch_id - 2)
                        h.kills_mid_fence_tail += len(pending_kills)
                        for ev in pending_kills:
                            h.apply(ev, now_s)
                            self.slo.observe_fault(now_s, ev.kind)
                            if h.recoveries_ms:
                                self.slo.observe_recovery(
                                    now_s, h.recoveries_ms[-1])
                        pending_kills.clear()
                    else:
                        # abandon OLDER skipped fences' checkpoints: a
                        # completing fence must leave nothing pending,
                        # or the next kill's recovery ignores them and
                        # the IGNORE determinants diverge from the
                        # control. Join the in-flight tail first — its
                        # ack (completion) lands at the join.
                        r.drain_fence()
                        r.coordinator.discard_pending_through(
                            ex.epoch_id - 1)
                        fence_drained = True
                    force_complete = False
                    kill_armed = bool(pending_kills)
                    if pending_rescales:
                        # the fence completed and drained: the handoff
                        # point (latest completed checkpoint == this
                        # fence) exists NOW, before the next chunk
                        r.drain_fence()
                        for ev in pending_rescales:
                            h.apply(ev, now_s)
                            self.slo.observe_fault(now_s, ev.kind)
                            if h.recoveries_ms:
                                self.slo.observe_recovery(
                                    now_s, h.recoveries_ms[-1])
                        pending_rescales.clear()
                        # the harness swapped incarnations underneath
                        # us: rebind every live handle and re-register
                        # the gauges on the new runner's registry
                        r = self.runner = h.runner
                        ex = r.executor
                        self._register_gauges()
                    if fence_drained and self.detector.enabled:
                        # gray-failure scoring at the same fence cadence
                        # as the signal plane, and BEFORE its sample —
                        # this fence's verdict reaches this fence's
                        # policy evaluation
                        self._detect_fence(r, ex)
                    if self.autoscaler is not None and fence_drained:
                        # the closed loop: signals sampled off the
                        # metric rollup at THIS completed+drained
                        # fence, policy decides, and a scale action
                        # executes here — the only place a self-
                        # directed re-cut is allowed to happen
                        r, ex = self._autoscale_fence(r, ex, now_s)
                if h.audit_pending:
                    # the fence worker may be mid seal -> ledger
                    # append; diffing now would report a false
                    # missing-entry divergence
                    r.drain_fence()
                    h.audit_check()
                    h.audit_pending = False
            h.tick(now_s)

        # -- drain: still-pending kills get their completed fence first
        # (same no-IGNORE invariant as the paced path), then the last
        # epoch closes and the final audit sweep covers every seal.
        now_s = _time.monotonic() - t0
        if due:
            if ex.step_in_epoch == 0:
                for _ in range(cfg.chunk_steps):
                    r.step()
            for ev in due:
                h.apply(ev, now_s)
                self.slo.observe_fault(now_s, ev.kind)
            due.clear()
        if pending_kills:
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
            r.coordinator.discard_pending_through(ex.epoch_id - 1)
            for _ in range(cfg.chunk_steps):
                r.step()
            for ev in pending_kills:
                h.apply(ev, now_s)
                self.slo.observe_fault(now_s, ev.kind)
                if h.recoveries_ms:
                    self.slo.observe_recovery(now_s,
                                              h.recoveries_ms[-1])
        h.tick(float("inf"))
        r.run_epoch(complete_checkpoint=True)
        r.drain_fence()      # final sweep must see every in-flight seal
        if pending_rescales:
            # a re-cut due in the last window still hands off at a real
            # completed fence (the one just run) — the final audit then
            # covers the post-re-cut ledger too
            for ev in pending_rescales:
                h.apply(ev, now_s)
                self.slo.observe_fault(now_s, ev.kind)
                if h.recoveries_ms:
                    self.slo.observe_recovery(now_s,
                                              h.recoveries_ms[-1])
            pending_rescales.clear()
            r = self.runner = h.runner
            ex = r.executor
        h.audit_check()
        if self.read_load is not None:
            # one post-drain pump: the final fence sealed, so this burst
            # witnesses staleness RECOVERY after any replica-kill
            self.read_load.pump(_time.monotonic() - t0, final=True)
        wall_s = _time.monotonic() - t0
        return self._verdict(wall_s, sent_records, ei)

    # --- verdict -------------------------------------------------------------

    def _verdict(self, wall_s: float, sent_records: int,
                 events_fired: int) -> Dict[str, Any]:
        h, cfg = self.harness, self.cfg
        windows = self.slo.finish()
        corrected = self.slo.all_corrected_ms()
        actual = self.slo.all_actual_ms()
        audited = h.control is not None and h.runner.auditor.enabled
        audit_ok = audited and not h.divergences
        exactly_once = (audit_ok and h.epochs_checked > 0) \
            if audited else None
        breached = self.slo.breached_windows()
        slo_ok = not breached
        passed = slo_ok and (not self.spec.exactly_once
                             or bool(exactly_once))
        worst = self.slo.worst_window()
        out = {
            "metric": "soak_slo_verdict",
            "pass": passed,
            "rate_target": cfg.rate,
            "rate_achieved": round(sent_records / max(wall_s, 1e-9), 1),
            "duration_s": round(wall_s, 2),
            "records": sent_records,
            "latency": {
                "basis": "corrected (intended-send time; "
                         "coordinated-omission-free)",
                "p50_ms": round(quantile(corrected, 0.50), 3),
                "p99_ms": round(quantile(corrected, 0.99), 3),
                "p999_ms": round(quantile(corrected, 0.999), 3),
                "actual_send_p99_ms": round(quantile(actual, 0.99), 3),
            },
            "windows": [w.stats() for w in windows],
            "worst_window": worst.stats() if worst else None,
            "windows_breached": len(breached),
            "faults": {
                "injected": h.faults_injected,
                "survived": h.faults_survived,
                "by_kind": dict(sorted(h.by_kind.items())),
                "recoveries_ms": [round(m, 1)
                                  for m in h.recoveries_ms],
                # Overlapped recovery under chaos kill: per-kill
                # finalize.overlap-saved attribution, and the count of
                # ledger problems from the immediate post-kill re-diff
                # vs the control twin (0 == every overlapped recovery
                # left bit-identical state).
                "kill_overlap_saved_ms": list(h.kill_overlap_saved_ms),
                "kill_rediff_problems": h.kill_rediff_problems,
                # kills fired while the pipelined fence tail was still
                # in flight (inject joins it first): each one exercised
                # the kill-mid-seal drain ordering under load.
                "kills_mid_fence_tail": h.kills_mid_fence_tail,
                # live re-cuts (the `rescale` event): per-handoff fence
                # checkpoint, drained in-flight records, moved key
                # groups, and the fence-stall cost the paced load paid.
                "rescales": h.rescales,
                "rescale_stats": list(h.rescale_stats),
            },
            "audit": {
                "enabled": audited,
                "exactly_once": exactly_once,
                "epochs_checked": h.epochs_checked,
                "divergences": h.divergences[:8],
            },
            "slo": self.spec.to_dict(),
            "events_fired": events_fired,
            "schedule": self.schedule.to_text(),
            "truncated": self._truncated,
        }
        if self.read_load is not None:
            # Read-tier verdict rides the soak verdict: the serve
            # numbers only mean anything against the ingest load they
            # contended with (the honest-measurement requirement).
            out["serve"] = self.read_load.summary()
            out["serve"]["replica_kills"] = h.replica_kills
        if self.detector.enabled:
            # Gray-failure verdict: the sustained suspects at run end,
            # the per-fence scoring history length, and a bit-identical
            # replay proof over the pinned snapshots (the same
            # discipline the SCALE log's verdict pins with its digest).
            d = self.detector
            try:
                d.replay()
                replay_ok = True
            except ValueError:
                replay_ok = False
            out["health"] = {
                "suspects": d.suspects(),
                "gray_events": d.events_emitted,
                "fences_scored": len(d.log),
                "replay_bit_identical": replay_ok,
            }
        if self.autoscaler is not None:
            # Closed-loop verdict: every decision is in the SCALE log
            # (digest pins the byte encoding), scale actions are rate-
            # limited by the cooldown (max_actions_per_cooldown must be
            # <= 1 for a well-behaved policy), and the self-directed
            # re-cuts are itemized apart from operator events — the
            # acceptance bar is operator_rescale_events == 0 with
            # autoscale_rescales > 0 under a load spike.
            a = self.autoscaler
            by_action: Dict[str, int] = {}
            for rec in a.log.records:
                act = rec["decision"]["action"]
                by_action[act] = by_action.get(act, 0) + 1
            out["autoscale"] = {
                "decisions": len(a.log),
                "by_action": dict(sorted(by_action.items())),
                "rescales_executed": a.rescales_executed,
                "replicas_added": a.replicas_added,
                "replicas_dropped": a.replicas_dropped,
                "refusals": a.refusals,
                "replayed_decisions": a.replayed_decisions,
                "max_actions_per_cooldown": _max_actions_per_cooldown(
                    a.log.records, a.policy.cfg.cooldown_fences),
                "cooldown_fences": a.policy.cfg.cooldown_fences,
                "operator_rescale_events": h.rescales,
                "autoscale_rescales": h.autoscale_rescales,
                "rescale_stats": list(h.autoscale_stats),
                "log_digest": a.log.digest(),
                "log_path": a.log.path,
            }
        # The FT call-site population this run exercised
        # (analysis/census.py): a verdict stays traceable to the exact
        # source shape that produced it.
        from clonos_tpu_torch.analysis import census_fingerprint
        out["census_fingerprint"] = census_fingerprint()
        return out


def default_kill_targets(job) -> List[int]:
    """One flat subtask per vertex class (subtask 1 where parallelism
    allows, else 0) — the config4 cascading-failure pattern. A cascade
    drawn from this pool never takes out ALL replicas of one vertex,
    which would leave no survivor holding the dead task's determinant
    log (unrecoverable by design, not a harness bug)."""
    return [job.subtask_base(v.vertex_id) + min(1, v.parallelism - 1)
            for v in job.vertices]


def next_soak_artifact_path(root: Optional[str] = None) -> str:
    """Next free ``SOAK_r0N.json`` slot next to the BENCH artifacts."""
    root = root or os.getcwd()
    n = 1
    while os.path.exists(os.path.join(root, f"SOAK_r{n:02d}.json")):
        n += 1
    return os.path.join(root, f"SOAK_r{n:02d}.json")


def next_serve_artifact_path(root: Optional[str] = None) -> str:
    """Next free ``SERVE_r0N.json`` slot (the ``bench --serve``
    verdict artifact, sibling of SOAK/BENCH)."""
    root = root or os.getcwd()
    n = 1
    while os.path.exists(os.path.join(root, f"SERVE_r{n:02d}.json")):
        n += 1
    return os.path.join(root, f"SERVE_r{n:02d}.json")


def next_rescale_artifact_path(root: Optional[str] = None) -> str:
    """Next free ``RESCALE_r0N.json`` slot (the ``bench --rescale``
    verdict artifact, sibling of SOAK/BENCH/SERVE)."""
    root = root or os.getcwd()
    n = 1
    while os.path.exists(os.path.join(root, f"RESCALE_r{n:02d}.json")):
        n += 1
    return os.path.join(root, f"RESCALE_r{n:02d}.json")


def next_autoscale_artifact_path(root: Optional[str] = None) -> str:
    """Next free ``AUTOSCALE_r0N.json`` slot (the ``soak --autoscale``
    closed-loop verdict artifact, sibling of SOAK/BENCH/SERVE)."""
    root = root or os.getcwd()
    n = 1
    while os.path.exists(os.path.join(root,
                                      f"AUTOSCALE_r{n:02d}.json")):
        n += 1
    return os.path.join(root, f"AUTOSCALE_r{n:02d}.json")


def build_soak_fixture(workdir: str, rate: float, duration_s: float,
                       steps_per_epoch: int = 64, par: int = 2,
                       batch: int = 8, seed: int = 11,
                       audit: bool = True, lease_ttl_s: float = 2.0,
                       num_keys: int = 101,
                       overlap_epoch: bool = False,
                       serve_vertex: bool = False,
                       device: str = "cuda"):
    """Construct the soak trio: runner, fault-free control twin, and a
    held leader lease — same job, same seed, logical time on BOTH
    runners (digest chains are only byte-comparable across runs when
    timestamps are causal step counts, the multichip-probe precedent).

    Sizing: the ring must hold the longest un-truncated span
    (``complete_every`` epochs plus the live one), the log the same span
    of determinant rows, and ``max_epochs`` the whole run plus warmup
    slack — all rounded to powers of two, the bench idiom. Both runners
    live on ``device``.
    """
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.executor import DETS_PER_STEP
    from clonos_tpu_torch.runtime.leader import FileLeaderElection

    def build(keyed_par=None):
        # ``keyed_par`` re-cuts the keyed stages only (the live-rescale
        # job shape: source and sink keep their parallelism, keyed
        # vertices move — restore_rescaled's constraint).
        env = StreamEnvironment(name="soak", num_key_groups=16)
        s = (env.synthetic_source(vocab=num_keys, batch_size=batch,
                                  parallelism=par)
             .key_by()
             .window_count(num_keys=num_keys, window_size=1 << 30,
                           name="window", parallelism=keyed_par))
        if serve_vertex:
            # a KeyedReduceOperator stage (emits_running_value) so the
            # read tier's replicas can tail it to fence freshness
            s = s.key_by().reduce(num_keys=num_keys, name="reduce",
                                  parallelism=keyed_par)
        # the sink keeps its cut across a re-cut (it would otherwise
        # inherit the keyed stage's), and its input edge is HASH so the
        # edge type is stable when the upstream parallelism moves —
        # restore_rescaled re-routes HASH buffers, not FORWARD ones
        s.key_by().sink(parallelism=par)
        return env.build()

    records_per_step = par * batch
    expected_epochs = int(np.ceil(
        duration_s * rate / (records_per_step * steps_per_epoch)))
    max_epochs = 1 << (expected_epochs + 8).bit_length()
    span = 4 * steps_per_epoch
    log_capacity = 1 << (2 * span * DETS_PER_STEP).bit_length()
    ring_steps = 1 << (span - 1).bit_length()

    def lineage_for(sub):
        # One plane per twin, SAME dye config (k, salt come from the
        # armed process plane): both runners dye identical records —
        # the dye is a pure key-hash function and logical time makes
        # their windows bit-identical — but observations land in
        # per-twin files, so `clonos_tpu_torch lineage` can diff the faulted
        # path against the fault-free one byte for byte.
        from clonos_tpu_torch.obs.lineage import LineagePlane, get_lineage
        g = get_lineage()
        if not g.enabled:
            return None
        return LineagePlane(g.root, service=f"soak-{sub}", k=g.k,
                            salt=g.salt)

    def runner_for(sub, overlap=False):
        return ClusterRunner(
            build(), steps_per_epoch=steps_per_epoch,
            log_capacity=log_capacity, max_epochs=max_epochs,
            inflight_ring_steps=ring_steps,
            checkpoint_dir=os.path.join(workdir, sub),
            audit=audit, logical_time=True, seed=seed,
            lineage=lineage_for(sub),
            overlap_epoch=overlap, device=device)

    def arm_rescaler(r, sub, overlap=False):
        """Arm a runner for the chaos ``rescale`` event: a closure that
        re-cuts THIS runner to a new keyed parallelism at its completed
        fence (ClusterRunner.rescale_live) with the same sizing knobs,
        then re-arms the new incarnation so repeated re-cuts compose."""
        def rescale(target):
            nr, stats = r.rescale_live(
                build(keyed_par=int(target)),
                steps_per_epoch=steps_per_epoch,
                log_capacity=log_capacity, max_epochs=max_epochs,
                inflight_ring_steps=ring_steps,
                checkpoint_dir=os.path.join(workdir, sub),
                audit=audit, logical_time=True, seed=seed,
                lineage=r.lineage, overlap_epoch=overlap, device=device)
            arm_rescaler(nr, sub, overlap)
            return nr, stats
        r._soak_rescaler = rescale
        return r

    # Only the soak runner pipelines its fence; the control twin stays
    # strictly sequential, so the ledger diff is always overlapped-vs-
    # sequential — the strongest bit-identity witness available.
    runner = arm_rescaler(runner_for("run", overlap_epoch), "run",
                          overlap_epoch)
    control = (arm_rescaler(runner_for("control"), "control")
               if audit else None)
    election = FileLeaderElection(os.path.join(workdir, "lease"),
                                  "soak-driver", lease_ttl_s=lease_ttl_s)
    election.try_acquire()
    return runner, control, election
