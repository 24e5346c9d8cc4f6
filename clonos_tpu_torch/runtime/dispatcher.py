"""Multi-tenant dispatcher: one slot pool, many concurrent jobs (port of
``clonos_tpu/runtime/dispatcher.py``).

Reference shape (PAPER.md layer 4): ``Dispatcher.submitJob`` spawns a
per-job JobMaster over a shared TaskManager pool — many JobGraphs, one
cluster:

- **Job intake** (:meth:`Dispatcher.submit_job`, also served over the
  control wire as SUBMIT_JOB / JOB_STATUS / CANCEL_JOB): a job spec +
  :class:`TenantConfig` mints a deterministic job id
  (``<tenant>-<seq>``) and enters admission.
- **Fair-share admission** (:class:`AdmissionController`): per-tenant
  slot quotas reject over-quota submissions with a TYPED error
  (:class:`QuotaExceededError`, machine-readable over the wire), and a
  full pool queues jobs strict-FIFO; completions and cancellations
  release slots and drain the queue head. FIFO is the fairness rule: a
  large job at the head is never starved by small jobs skipping past
  it.
- **Per-job isolation**: each admitted job gets its own
  ``FileLeaderElection`` (lease scoped by ``leader.job_lease_path``), its
  own ``SlotPoolScheduler`` bound to the SHARED :class:`SlotPool` (slot
  keys job-scoped), a checkpoint/ledger root at ``<root>/<job_id>/``,
  and its own job-tagged tracer.
- **Recovery-storm containment**: a worker death strikes every tenant
  placed on it. The dispatcher round-robins ``recover_worker`` calls
  across the affected jobs with ``max_groups =
  TenantConfig.max_concurrent_recoveries`` per call, and the slice
  worker defers rebuild work behind healthy epochs (one rebuild per
  round, ``SliceWorker.step``), so one tenant's storm inflates a
  neighbour's fence latency by a bounded factor.
- **Per-tenant observability**: ``metrics_extra`` (a
  ``MetricsEndpoint`` ``extra`` supplier) merges
  ``JobMasterServer.cluster_metrics()`` — which rolls worker keys up
  into ``cluster.job.<jid>.*`` — with ``tenant.<t>.slots-held/quota/
  jobs-running/jobs-queued`` and ``dispatcher.queue-depth``.

Threading: wire handlers (ControlServer threads) only take
``self._lock`` and mutate bookkeeping dicts — all slow work (deploys,
recovery, pool mutation, the mirrors on the card) happens on the
driving thread inside :meth:`step`. The shared :class:`SlotPool` is
therefore driving-thread-only; admission decisions use the accounting
view (live advertised slots minus held) instead of touching the pool.

Every job's scheduler keeps its mirrors on the dispatcher's ``device``
(default the card; raises without one). A job that fails lands a
``job.failure`` incident bundle (obs/incident.py; a no-op while the
incident plane is off).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import collections

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.obs import NullTracer, Tracer, get_tracer
from clonos_tpu_torch.obs.incident import get_incidents
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.runtime import remote as rm
from clonos_tpu_torch.runtime.leader import (FileLeaderElection,
                                             job_lease_path)
from clonos_tpu_torch.runtime.scheduler import SlotPool, SlotPoolScheduler


class QuotaExceededError(RuntimeError):
    """A tenant asked for more slots than its quota allows. Typed — the
    wire handler serializes ``error_type`` + the fields so a client can
    distinguish policy rejection from infrastructure failure."""

    error_type = "quota-exceeded"

    def __init__(self, tenant: str, requested: int, quota: int,
                 held: int):
        super().__init__(
            f"tenant {tenant!r}: requesting {requested} slot(s) would "
            f"exceed quota {quota} ({held} already held or queued)")
        self.tenant = tenant
        self.requested = requested
        self.quota = quota
        self.held = held

    def wire_payload(self) -> dict:
        return {"error": str(self), "error_type": self.error_type,
                "tenant": self.tenant, "requested": self.requested,
                "quota": self.quota, "held": self.held}


@dataclasses.dataclass
class TenantConfig:
    """Per-submission tenancy knobs (the SUBMIT_JOB ``tenant_config``
    field; every knob has a safe default so ``{}`` is a valid config).

    ``slots`` is how many slices the job is cut into — each occupies
    one pool slot. ``workers`` is a soft placement hint (slice *i*
    prefers ``workers[i % len]``; allocation falls back to any free
    slot). ``max_concurrent_recoveries`` caps how many of this job's
    groups one recovery round may rebuild — the storm-containment
    knob."""

    tenant: str = "default"
    slots: int = 1
    max_concurrent_recoveries: int = 1
    workers: Optional[List[str]] = None

    def __post_init__(self):
        self.tenant = str(self.tenant)
        # Tenant names embed into job ids, metric keys (split on "."),
        # and lease paths — keep them flat tokens.
        if (not self.tenant or "." in self.tenant or "/" in self.tenant
                or "-" in self.tenant):
            raise ValueError(
                f"tenant name {self.tenant!r} must be non-empty and "
                f"contain no '.', '/' or '-'")
        self.slots = int(self.slots)
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        self.max_concurrent_recoveries = max(
            1, int(self.max_concurrent_recoveries))
        if self.workers is not None:
            self.workers = [str(w) for w in self.workers]

    @classmethod
    def from_any(cls, obj) -> "TenantConfig":
        if obj is None:
            return cls()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in obj.items() if k in known})
        raise TypeError(f"tenant_config: expected dict or TenantConfig, "
                        f"got {type(obj).__name__}")


class AdmissionController:
    """Fair-share admission over one slot pool: per-tenant quotas,
    strict-FIFO queueing on a full pool, typed rejection.

    Pure bookkeeping with no lock of its own — the Dispatcher serializes
    every call under its lock. Quota is charged against a tenant's
    RESERVATION (held + queued): a submission that would overflow the
    quota even counting its queued jobs is rejected up front rather
    than admitted later in violation."""

    def __init__(self, quotas: Optional[Dict[str, int]] = None,
                 default_quota: Optional[int] = None):
        self.quotas = {str(t): int(q) for t, q in (quotas or {}).items()}
        self.default_quota = (None if default_quota is None
                              else int(default_quota))
        self._held: Dict[str, int] = {}
        self._queue: Deque[str] = collections.deque()
        self._pending: Dict[str, Tuple[str, int]] = {}
        #: transition observers: ``fn(kind, **fields)`` on every
        #: admission transition (admit/queue/reject/cancel/release) —
        #: the verify conformance layer's observation surface. Called
        #: under the Dispatcher's lock like everything else here.
        self.transition_observers: List = []

    def _observe(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

    def quota(self, tenant: str) -> Optional[int]:
        return self.quotas.get(tenant, self.default_quota)

    def held(self, tenant: str) -> int:
        return self._held.get(tenant, 0)

    def total_held(self) -> int:
        return sum(self._held.values())

    def reserved(self, tenant: str) -> int:
        return self.held(tenant) + sum(
            n for t, n in self._pending.values() if t == tenant)

    def queued(self) -> List[str]:
        return list(self._queue)

    def request(self, job_id: str, tenant: str, slots: int,
                free_slots: int) -> str:
        """Admit (``"admitted"``: slots held), queue (``"queued"``: FIFO
        behind earlier arrivals), or raise :class:`QuotaExceededError`.
        A non-empty queue always queues — later arrivals never jump
        earlier ones even when slots happen to be free for them."""
        q = self.quota(tenant)
        if q is not None and self.reserved(tenant) + slots > q:
            self._observe("reject", job_id=job_id, tenant=tenant,
                          slots=slots)
            raise QuotaExceededError(tenant, slots, q,
                                     self.reserved(tenant))
        if self._queue or free_slots < slots:
            self._queue.append(job_id)
            self._pending[job_id] = (tenant, slots)
            self._observe("queue", job_id=job_id, tenant=tenant,
                          slots=slots)
            return "queued"
        self._held[tenant] = self.held(tenant) + slots
        self._observe("admit", job_id=job_id, tenant=tenant,
                      slots=slots)
        return "admitted"

    def admit_queued(self, free_slots: int) -> List[str]:
        """Drain the queue head while slots last — STRICT FIFO: a head
        job too large for the remaining slots blocks the drain (no
        skipping — that is the no-starvation rule). Returns the job ids
        admitted this call, slots now held."""
        out: List[str] = []
        while self._queue:
            tenant, slots = self._pending[self._queue[0]]
            if slots > free_slots:
                break
            jid = self._queue.popleft()
            del self._pending[jid]
            self._held[tenant] = self.held(tenant) + slots
            free_slots -= slots
            self._observe("admit", job_id=jid, tenant=tenant,
                          slots=slots)
            out.append(jid)
        return out

    def cancel_queued(self, job_id: str) -> bool:
        if job_id not in self._pending:
            return False
        tenant, slots = self._pending[job_id]
        del self._pending[job_id]
        self._queue.remove(job_id)
        self._observe("cancel", job_id=job_id, tenant=tenant,
                      slots=slots)
        return True

    def release(self, tenant: str, slots: int) -> None:
        self._held[tenant] = max(0, self.held(tenant) - int(slots))
        self._observe("release", tenant=tenant, slots=int(slots))


#: job lifecycle: QUEUED -> ADMITTED -> DEPLOYING -> RUNNING ->
#: FINISHED, with CANCELLED / FAILED terminal exits and CANCELLING the
#: main-loop handoff for cancelling a deployed job
_ACTIVE_STATES = ("ADMITTED", "DEPLOYING", "RUNNING", "CANCELLING")


@dataclasses.dataclass
class JobRecord:
    job_id: str
    tenant: str
    config: TenantConfig
    job_spec: str
    state: str
    external_feeds: Dict[int, dict]
    target_epochs: int
    scheduler: Optional[SlotPoolScheduler] = None
    election: Optional[FileLeaderElection] = None
    tracer: object = None
    error: Optional[str] = None


class Dispatcher:
    """One dispatcher process: accepts jobs, runs a per-job JobMaster
    state machine (election + scheduler) against one shared slot pool,
    and contains each tenant's failure blast radius. See the module
    docstring for the architecture; the driving loop is
    ``while ...: dispatcher.step()`` on one thread (CUDA work and pool
    mutation live there), with submissions arriving from wire handler
    threads at any time."""

    def __init__(self, lease_path: str,
                 checkpoint_root: str = "/tmp/clonos-dispatcher",
                 quotas: Optional[Dict[str, int]] = None,
                 default_quota: Optional[int] = None,
                 runner_kw: Optional[dict] = None, feed_batch: int = 8,
                 target_epochs: int = 8, complete_every: int = 1,
                 deploy_timeout_s: float = 240.0,
                 trace_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: float = 5.0,
                 jm: Optional[rm.JobMasterServer] = None,
                 serve: bool = True, device="cuda"):
        self.device = _device.resolve(device)
        self.lease_path = lease_path
        self.checkpoint_root = checkpoint_root
        self.runner_kw = dict(runner_kw or {})
        self.feed_batch = feed_batch
        self.target_epochs = target_epochs
        self.complete_every = complete_every
        self.deploy_timeout_s = deploy_timeout_s
        self.trace_dir = trace_dir
        self.jm = jm if jm is not None else rm.JobMasterServer(
            heartbeat_timeout_s=heartbeat_timeout_s, host=host)
        self._owns_jm = jm is None
        self.pool = SlotPool()              # driving-thread-only (see above)
        self.admission = AdmissionController(quotas, default_quota)
        self._jobs: Dict[str, JobRecord] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.server = (tp.ControlServer(self._handle, host, port)
                       if serve else None)
        self.address = self.server.address if self.server else None

    # --- intake (wire-thread safe) -------------------------------------------

    def _free_slots_locked(self) -> int:
        """Admission's pool view: live advertised slots minus held.
        (The SlotPool itself is driving-thread-only; this accounting view
        agrees with it because every admitted job holds exactly
        ``config.slots`` pool slots until release.)"""
        dead = set(self.jm.expired())
        total = sum(n for eid, n in self.jm.slots().items()
                    if eid not in dead)
        return max(0, total - self.admission.total_held())

    def submit_job(self, job_spec: str, tenant_config=None,
                   external_feeds: Optional[Dict[int, dict]] = None,
                   target_epochs: Optional[int] = None) -> dict:
        """Mint a job id and run admission. Returns ``{"job_id",
        "state"}`` (ADMITTED or QUEUED); raises
        :class:`QuotaExceededError` on policy rejection. Deployment
        happens on the next main-loop :meth:`step`."""
        cfg = TenantConfig.from_any(tenant_config)
        feeds = {int(v): dict(spec)
                 for v, spec in (external_feeds or {}).items()}
        with self._lock:
            self._seq += 1
            job_id = f"{cfg.tenant}-{self._seq:03d}"
            verdict = self.admission.request(
                job_id, cfg.tenant, cfg.slots, self._free_slots_locked())
            rec = JobRecord(
                job_id=job_id, tenant=cfg.tenant, config=cfg,
                job_spec=str(job_spec),
                state="ADMITTED" if verdict == "admitted" else "QUEUED",
                external_feeds=feeds,
                target_epochs=int(target_epochs or self.target_epochs))
            self._jobs[job_id] = rec
            return {"job_id": job_id, "state": rec.state}

    def cancel_job(self, job_id: str) -> dict:
        """Cancel a job. Queued jobs leave the queue; admitted-but-
        undeployed jobs release their held slots; deployed jobs are
        handed to the main loop (CANCELLING) which releases their pool
        slots and abandons the deployment — there is no UNDEPLOY wire
        verb, so the workers run the already-shipped slices to their
        epoch target but the slots are free for the next admission."""
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                raise KeyError(
                    f"unknown job {job_id!r} (have "
                    f"{sorted(self._jobs)})")
            if rec.state == "QUEUED":
                self.admission.cancel_queued(job_id)
                rec.state = "CANCELLED"
            elif rec.state == "ADMITTED":
                self.admission.release(rec.tenant, rec.config.slots)
                rec.state = "CANCELLED"
            elif rec.state in ("DEPLOYING", "RUNNING"):
                rec.state = "CANCELLING"
            return {"job_id": job_id, "state": rec.state}

    def _job_info_locked(self, rec: JobRecord) -> dict:
        info = {"job_id": rec.job_id, "tenant": rec.tenant,
                "state": rec.state, "slots": rec.config.slots}
        if rec.error:
            info["error"] = rec.error
        if rec.scheduler is not None:
            info["placements"] = {
                str(g): w for g, w in sorted(
                    rec.scheduler.placements.items())}
        return info

    def jobs(self) -> List[dict]:
        with self._lock:
            return [self._job_info_locked(rec)
                    for _, rec in sorted(self._jobs.items())]

    # --- wire surface --------------------------------------------------------

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype == tp.SUBMIT_JOB:
            req = tp.unpack_json(payload)
            try:
                res = self.submit_job(
                    req["job"], req.get("tenant_config"),
                    external_feeds=req.get("external_feeds"),
                    target_epochs=req.get("target_epochs"))
            except QuotaExceededError as e:
                return tp.ERROR, tp.pack_json(e.wire_payload())
            return tp.OK, tp.pack_json(res)
        if mtype == tp.JOB_STATUS:
            req = tp.unpack_json(payload) if payload else {}
            job_id = (req or {}).get("job_id")
            if job_id:
                with self._lock:
                    rec = self._jobs.get(job_id)
                    if rec is None:
                        return tp.ERROR, tp.pack_json(
                            {"error": f"unknown job {job_id!r} (have "
                                      f"{sorted(self._jobs)})"})
                    return tp.OK, tp.pack_json(self._job_info_locked(rec))
            return tp.OK, tp.pack_json({"jobs": self.jobs()})
        if mtype == tp.CANCEL_JOB:
            req = tp.unpack_json(payload)
            return tp.OK, tp.pack_json(self.cancel_job(req["job_id"]))
        return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})

    # --- main loop -----------------------------------------------------------

    def _job_tracer(self, job_id: str):
        """Per-job tracer: file sink under ``trace_dir`` when set, ring
        only when the process tracer is on, Null otherwise (tracing-off
        dispatchers add no wire fields). The trace id is job-tagged —
        every span of this job, on any worker, carries the job id."""
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            tr = Tracer(f"jm.{job_id}", path=os.path.join(
                self.trace_dir, f"trace-jm.{job_id}.jsonl"))
        elif get_tracer().enabled:
            tr = Tracer(f"jm.{job_id}")
        else:
            return NullTracer()
        tr.trace_id = f"{job_id}:{tr.trace_id}"
        return tr

    def _live_offers(self) -> Dict[str, int]:
        dead = set(self.jm.expired())
        return {eid: n for eid, n in self.jm.slots().items()
                if eid not in dead}

    def _launch(self, rec: JobRecord) -> None:
        """Driving thread: election + scheduler + deploy for one admitted
        job. Everything durable lands under ``<root>/<job_id>/`` and
        the lease under ``job_lease_path`` — full per-job namespace."""
        job_id = rec.job_id
        election = FileLeaderElection(
            job_lease_path(self.lease_path, job_id),
            f"dispatcher.{job_id}")
        if not election.try_acquire():
            raise RuntimeError(
                f"job {job_id}: could not acquire its leader lease "
                f"(stale claim under {self.lease_path!r}?)")
        rec.election = election
        rec.tracer = self._job_tracer(job_id)
        rec.scheduler = SlotPoolScheduler(
            self.jm, election, rec.job_spec, runner_kw=self.runner_kw,
            feed_batch=self.feed_batch,
            target_epochs=rec.target_epochs,
            complete_every=self.complete_every,
            checkpoint_root=os.path.join(self.checkpoint_root, job_id),
            deploy_timeout_s=self.deploy_timeout_s,
            job_id=job_id, tenant=rec.tenant, pool=self.pool,
            tracer=rec.tracer, device=self.device)
        self.pool.sync_offers(self._live_offers())
        rec.scheduler.deploy(workers=rec.config.workers,
                             external_feeds=rec.external_feeds,
                             num_slices=rec.config.slots)

    def _teardown(self, rec: JobRecord, state: str,
                  error: Optional[str] = None) -> None:
        """Driving thread: release the job's pool slots and admission
        hold, close its scheduler/tracer, move it to a terminal
        state."""
        if rec.scheduler is not None:
            rec.scheduler.release_pool_slots()
            rec.scheduler.close()
        if rec.tracer is not None:
            rec.tracer.close()
        with self._lock:
            self.admission.release(rec.tenant, rec.config.slots)
            rec.state = state
            if error:
                rec.error = error
        if state == "FAILED":
            # A terminal job failure is an incident trigger: the bundle
            # lands before the job's scheduler and tracer are gone (a
            # no-op while the incident plane is off).
            get_incidents().signal(
                "job.failure", job_id=rec.job_id, tenant=rec.tenant,
                error=(error or "")[:200])

    def _deploy_ready(self) -> bool:
        with self._lock:
            ready = [rec for rec in self._jobs.values()
                     if rec.state == "ADMITTED"]
            for rec in ready:
                rec.state = "DEPLOYING"
        for rec in ready:
            try:
                self._launch(rec)
            except Exception as e:
                self._teardown(rec, "FAILED", error=str(e))
                continue
            with self._lock:
                if rec.state == "DEPLOYING":   # not cancelled meanwhile
                    rec.state = "RUNNING"
        return bool(ready)

    def _running(self) -> List[JobRecord]:
        with self._lock:
            return [rec for rec in self._jobs.values()
                    if rec.state == "RUNNING"]

    def _detect_failures(self) -> bool:
        """Round-robin recovery across the jobs a dead worker struck:
        each affected job rebuilds at most
        ``max_concurrent_recoveries`` groups per pass, so no single
        tenant's storm monopolizes the recovery path (worker-side, the
        slice worker additionally admits one rebuild per epoch round —
        fence traffic first)."""
        progressed = False
        for worker in sorted(set(self.jm.expired())):
            while True:
                remaining = False
                for rec in self._running():
                    sched = rec.scheduler
                    if sched is None or worker not in set(
                            sched.placements.values()):
                        continue
                    remaining = True
                    try:
                        sched.recover_worker(
                            worker,
                            max_groups=rec.config
                            .max_concurrent_recoveries)
                    except Exception as e:
                        self._teardown(
                            rec, "FAILED",
                            error=f"recovery from {worker} failed: {e}")
                    progressed = True
                if not remaining:
                    break
        return progressed

    def _reap_finished(self) -> bool:
        progressed = False
        for rec in self._running():
            sched = rec.scheduler
            if sched is None or not sched.placements:
                continue
            done = True
            for group, worker in sched.placements.items():
                st = self.jm.task_state(worker, group, rec.job_id)
                if not st or st.get("state") != "FINISHED":
                    done = False
                    break
            if done:
                self._teardown(rec, "FINISHED")
                progressed = True
        return progressed

    def _reap_cancelling(self) -> bool:
        with self._lock:
            cancelling = [rec for rec in self._jobs.values()
                          if rec.state == "CANCELLING"
                          and rec.scheduler is not None]
        for rec in cancelling:
            self._teardown(rec, "CANCELLED")
        return bool(cancelling)

    def _admit_from_queue(self) -> bool:
        with self._lock:
            admitted = self.admission.admit_queued(
                self._free_slots_locked())
            for job_id in admitted:
                self._jobs[job_id].state = "ADMITTED"
        return bool(admitted)

    def step(self) -> bool:
        """One main-loop round: tear down cancellations, deploy
        admitted jobs, pull every running job's mirrors, recover from
        dead workers (round-robin, capped), reap completions, and drain
        the admission queue into freed slots. Returns whether anything
        changed."""
        progressed = self._reap_cancelling()
        progressed |= self._deploy_ready()
        for rec in self._running():
            if rec.scheduler is not None:
                rec.scheduler.sync()
        progressed |= self._detect_failures()
        progressed |= self._reap_finished()
        progressed |= self._admit_from_queue()
        return progressed

    def run(self, max_seconds: float = 600.0,
            poll_s: float = 0.2) -> None:
        deadline = time.monotonic() + max_seconds
        while time.monotonic() < deadline:
            if not self.step():
                time.sleep(poll_s)
            with self._lock:
                active = any(rec.state in _ACTIVE_STATES or
                             rec.state == "QUEUED"
                             for rec in self._jobs.values())
            if not active and self.server is None:
                return          # embedded mode: nothing left to drive

    # --- observability -------------------------------------------------------

    def metrics_extra(self) -> Dict[str, object]:
        """``MetricsEndpoint(extra=...)`` supplier: the cluster rollup
        (including ``cluster.job.<jid>.*``) plus per-tenant admission
        gauges and dispatcher totals."""
        out: Dict[str, object] = dict(self.jm.cluster_metrics())
        with self._lock:
            counts: Dict[str, Dict[str, int]] = {}
            for rec in self._jobs.values():
                c = counts.setdefault(rec.tenant,
                                      {"running": 0, "queued": 0})
                if rec.state in _ACTIVE_STATES:
                    c["running"] += 1
                elif rec.state == "QUEUED":
                    c["queued"] += 1
            tenants = sorted(set(counts) | set(self.admission.quotas))
            for tenant in tenants:
                out[f"tenant.{tenant}.slots-held"] = \
                    self.admission.held(tenant)
                quota = self.admission.quota(tenant)
                if quota is not None:
                    out[f"tenant.{tenant}.quota"] = quota
                c = counts.get(tenant, {"running": 0, "queued": 0})
                out[f"tenant.{tenant}.jobs-running"] = c["running"]
                out[f"tenant.{tenant}.jobs-queued"] = c["queued"]
            out["dispatcher.queue-depth"] = \
                len(self.admission.queued())
            out["dispatcher.jobs-total"] = len(self._jobs)
        return out

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
        with self._lock:
            recs = list(self._jobs.values())
        for rec in recs:
            if rec.scheduler is not None:
                rec.scheduler.close()
            if rec.tracer is not None:
                rec.tracer.close()
        if self._owns_jm:
            self.jm.close()
