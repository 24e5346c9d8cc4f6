"""Cross-host control plane: JobMaster endpoint and remote determinant
mirroring (port of ``clonos_tpu/runtime/remote.py``).

- :class:`JobMasterServer` — registration, deadline heartbeats and the
  ignore-checkpoint RPC surface (reference JobMaster.java:151, heartbeat
  wiring :258-266, TaskExecutorGateway.java:170-233), served over
  ``parallel/transport.py``.
- :class:`HostLogEndpoint` — a running host answers determinant-delta
  requests for the task logs it owns: the logs' live suffixes are copied
  to the host once a fence, on the main thread, and framed with
  ``causal/serde.py`` on request.
- :class:`RemoteReplicaMirror` — a standby host keeps replica logs of
  remote tasks by polling deltas and merging them with the offset-dedup
  rule of on-card replication (``log.merge_delta``). After a host loss
  these mirrors are the determinant source the rebuilt job recovers
  from: replication that survives the loss of a whole host.
- :class:`JobMasterController` — mirrors every registered worker and
  rebuilds a dead worker's whole job through
  ``ClusterRunner.bootstrap_standby``.

Threads: the transport's handler threads and the heartbeat thread touch
host data only (numpy, dicts, sockets), never the card. Every read of
device state happens on the thread that drives the runner.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.causal import serde
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.obs import get_tracer
from clonos_tpu_torch.parallel import transport as tp


class JobMasterServer:
    """JobMaster endpoint: executors register, then heartbeat against a
    deadline; expiry marks them failed (the trigger for standby-host
    failover).

    Registration carries a ``slots`` advertisement, SLOT_OFFER adds
    capacity later, and TASK_STATE records per-task transitions keyed by
    ``(executor_id, job_id, group)`` — the scheduler's feed."""

    def __init__(self, heartbeat_timeout_s: float = 5.0,
                 host: str = "127.0.0.1", port: int = 0):
        self.timeout_s = heartbeat_timeout_s
        self._last: Dict[str, float] = {}
        self._meta: Dict[str, dict] = {}
        self._ignored: List[int] = []
        self._slots: Dict[str, int] = {}
        #: (executor_id, job_id, group) -> last TASK_STATE report;
        #: job_id "" is the single-job cluster
        self._tasks: Dict[Tuple[str, str, int], dict] = {}
        #: executor_id -> last metric snapshot piggybacked on HEARTBEAT
        self._hb_metrics: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype == tp.REGISTER:
            info = tp.unpack_json(payload)
            with self._lock:
                self._meta[info["executor_id"]] = info
                self._last[info["executor_id"]] = time.monotonic()
                self._slots[info["executor_id"]] = int(info.get("slots", 0))
            return tp.OK, tp.pack_json({"registered": True})
        if mtype == tp.HEARTBEAT:
            info = tp.unpack_json(payload)
            tp.adopt_hlc(info, verb="HEARTBEAT")
            with self._lock:
                self._last[info["executor_id"]] = time.monotonic()
                metrics = info.get("metrics")
                if metrics is not None:
                    self._hb_metrics[info["executor_id"]] = metrics
            return tp.OK, b""
        if mtype == tp.IGNORE_CHECKPOINT:
            info = tp.unpack_json(payload)
            with self._lock:
                self._ignored.append(info["checkpoint_id"])
            return tp.OK, b""
        if mtype == tp.SLOT_OFFER:
            info = tp.unpack_json(payload)
            eid = info["executor_id"]
            with self._lock:
                self._slots[eid] = self._slots.get(eid, 0) \
                    + int(info["slots"])
                slots = self._slots[eid]
            return tp.OK, tp.pack_json({"slots": slots})
        if mtype == tp.TASK_STATE:
            info = tp.unpack_json(payload)
            key = (info["executor_id"], str(info.get("job_id") or ""),
                   int(info["group"]))
            with self._lock:
                self._tasks[key] = info
            return tp.OK, b""
        return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})

    def registered(self) -> List[str]:
        with self._lock:
            return sorted(self._meta)

    def slots(self) -> Dict[str, int]:
        """Advertised slot capacity per registered executor."""
        with self._lock:
            return dict(self._slots)

    def info(self, executor_id: str) -> dict:
        """The registration record of ``executor_id``."""
        with self._lock:
            if executor_id not in self._meta:
                raise KeyError(f"executor {executor_id!r} never registered")
            return dict(self._meta[executor_id])

    def task_state(self, executor_id: str, group: int,
                   job_id: str = "") -> Optional[dict]:
        """Latest TASK_STATE report for ``(executor_id, job_id, group)``."""
        with self._lock:
            return self._tasks.get((executor_id, str(job_id or ""),
                                    int(group)))

    def cluster_metrics(self) -> Dict[str, object]:
        """Cluster-wide metric view: every worker's last heartbeat
        snapshot flattened under ``worker.<executor_id>.``, with
        ``cluster.audit.*``, ``cluster.overhead.*`` and per-job
        ``cluster.job.<jid>.*`` rollups where workers report them."""
        with self._lock:
            snaps = {eid: dict(m) for eid, m in self._hb_metrics.items()}
            slots = dict(self._slots)
        out = {f"worker.{eid}.{name}": v
               for eid, m in sorted(snaps.items())
               for name, v in m.items()}
        for eid, n in sorted(slots.items()):
            if n:  # zero-slot registrants host no tasks
                out[f"worker.{eid}.slots"] = int(n)
        audit = {k: v for k, v in out.items()
                 if ".audit." in k and isinstance(v, (int, float))}
        if audit:
            sealed = sum(v for k, v in audit.items()
                         if k.endswith("audit.epochs-sealed"))
            validated = sum(v for k, v in audit.items()
                            if k.endswith("audit.epochs-validated"))
            div = sum(v for k, v in audit.items()
                      if k.endswith("audit.divergences"))
            out["cluster.audit.epochs-sealed"] = int(sealed)
            out["cluster.audit.epochs-validated"] = int(validated)
            out["cluster.audit.divergences"] = int(div)
            out["cluster.audit.exactly-once-ok"] = int(div == 0)
        # The worst per-worker FT fraction is the cluster's headline.
        fracs = [v for k, v in out.items()
                 if k.endswith("overhead.ft-fraction")
                 and isinstance(v, (int, float))]
        if fracs:
            out["cluster.overhead.ft-fraction-max"] = round(max(fracs), 6)
            out["cluster.overhead.ft-fraction-mean"] = round(
                sum(fracs) / len(fracs), 6)
        # Per-job rollups: slice workers prefix a job-scoped slice's
        # metrics ``job.<jid>.group.<g>.``.
        jobs: Dict[str, dict] = {}
        for k, v in out.items():
            parts = k.split(".")
            if (len(parts) < 6 or parts[0] != "worker"
                    or parts[2] != "job" or parts[4] != "group"):
                continue
            rec = jobs.setdefault(parts[3], {
                "groups": set(), "sealed": 0, "validated": 0,
                "div": 0, "audited": False})
            rec["groups"].add(parts[5])
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            for suffix, field in (("audit.epochs-sealed", "sealed"),
                                  ("audit.epochs-validated", "validated"),
                                  ("audit.divergences", "div")):
                if k.endswith(suffix):
                    rec[field] += v
                    rec["audited"] = True
                    break
        for jid, rec in sorted(jobs.items()):
            out[f"cluster.job.{jid}.groups"] = len(rec["groups"])
            if rec["audited"]:
                out[f"cluster.job.{jid}.audit.epochs-sealed"] = \
                    int(rec["sealed"])
                out[f"cluster.job.{jid}.audit.epochs-validated"] = \
                    int(rec["validated"])
                out[f"cluster.job.{jid}.audit.divergences"] = \
                    int(rec["div"])
                out[f"cluster.job.{jid}.audit.exactly-once-ok"] = \
                    int(rec["div"] == 0)
        return out

    def heartbeat_ages_ms(self) -> Dict[str, float]:
        """Milliseconds since each registered executor's last beat: the
        heartbeat evidence a gray-failure snapshot (obs/detect.py) is
        built from."""
        now = time.monotonic()
        with self._lock:
            return {e: (now - t) * 1e3 for e, t in self._last.items()}

    def expired(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return sorted(e for e, t in self._last.items()
                          if now - t > self.timeout_s)

    def close(self) -> None:
        self.server.close()


class TaskExecutorClient:
    """Executor-side stub: register once, heartbeat on a thread.

    ``payload_fn`` (zero-arg, returns a dict) is merged into every
    HEARTBEAT. It runs on the heartbeat thread, so it must return host
    data only: the thread never touches the card."""

    def __init__(self, executor_id: str, jm_address: Tuple[str, int],
                 interval_s: float = 1.0,
                 info: Optional[dict] = None,
                 payload_fn=None):
        self.executor_id = executor_id
        self._client = tp.ControlClient(tuple(jm_address))
        self._client.call_json(tp.REGISTER, {"executor_id": executor_id,
                                             **(info or {})})
        self._payload_fn = payload_fn
        self._interval = interval_s
        #: consecutive heartbeat RPC failures (0 when healthy)
        self.missed_beats = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._beat, daemon=True)
        self._t.start()

    def _beat(self) -> None:
        # A transient socket error must not kill the heartbeat thread: a
        # dead thread would make the JobMaster declare a healthy executor
        # failed. The JobMaster's deadline decides real failure.
        while not self._stop.wait(self._interval):
            try:
                msg = {"executor_id": self.executor_id}
                if self._payload_fn is not None:
                    try:
                        msg.update(self._payload_fn() or {})
                    except Exception:
                        pass       # the beat matters more than the extras
                tp.attach_hlc(msg, verb="HEARTBEAT")
                self._client.call_json(tp.HEARTBEAT, msg)
                self.missed_beats = 0
            except (OSError, RuntimeError):
                self.missed_beats += 1

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=max(1.0, 2 * self._interval))
        self._client.close()


class HostLogEndpoint:
    """Serves this host's determinant logs to remote mirrors.

    The request handler runs on a server thread and touches no device
    state: it serves a host-side numpy snapshot that the thread driving
    the runner refreshes at fences (:meth:`refresh`, one device-to-host
    copy waited there). Served deltas are prefix-consistent and at most
    one refresh behind, the lag the offset-dedup merge tolerates."""

    def __init__(self, executor, host: str = "127.0.0.1", port: int = 0):
        self.executor = executor
        self._lock = threading.Lock()
        self._rows: Dict[int, np.ndarray] = {}    # flat -> [n, lanes]
        self._starts: Dict[int, int] = {}         # abs offset of rows[0]
        #: ring -> (window start step, window end step, field arrays):
        #: the served in-flight tail (refresh_inflight)
        self._inflight: Dict[int, Tuple[int, int, Optional[dict]]] = {}
        self.refresh()
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address

    def refresh(self) -> None:
        """Snapshot every log's live suffix (call on the driving
        thread)."""
        logs = self.executor.carry.logs
        heads, tails, rows = _device.HostCopy(
            (logs.head, logs.tail, logs.rows)).wait()
        cap = rows.shape[1]
        snap_rows: Dict[int, np.ndarray] = {}
        snap_starts: Dict[int, int] = {}
        for flat in range(rows.shape[0]):
            t, h = int(tails[flat]), int(heads[flat])
            snap_rows[flat] = rows[flat][np.arange(t, h) & (cap - 1)]
            snap_starts[flat] = t
        with self._lock:
            self._rows = snap_rows
            self._starts = snap_starts

    def refresh_inflight(self, max_steps: int = 256) -> None:
        """Snapshot every in-flight ring's tail window (at most
        ``max_steps`` steps) for remote serving — the wire analog of the
        reference's InFlightLogRequestEvent path (call on the driving
        thread)."""
        rings = self.executor.carry.out_rings
        bounds = _device.HostCopy([(el.head, el.tail) for el in rings]
                                  ).wait()
        windows = []
        for el, (head, tail) in zip(rings, bounds):
            head, tail = int(head), int(tail)
            lo = max(tail, head - max_steps)
            batch = None
            if head > lo:
                batch, _, _ = ifl.slice_steps(el, lo, head - lo)
                batch = {"keys": batch.keys, "values": batch.values,
                         "timestamps": batch.timestamps,
                         "valid": batch.valid}
            windows.append((lo, head, batch))
        fields = _device.HostCopy([w[2] for w in windows]).wait()
        snap = {ri: (lo, head, f)
                for ri, ((lo, head, _), f) in enumerate(zip(windows, fields))}
        with self._lock:
            self._inflight = snap

    def _handle_inflight(self, payload: bytes) -> Tuple[int, bytes]:
        req = tp.unpack_json(payload)
        ri, start, count = req["ring"], req["start"], req["count"]
        with self._lock:
            win = self._inflight.get(ri)
        if win is None:
            return tp.ERROR, tp.pack_json(
                {"error": f"no in-flight snapshot for ring {ri}"})
        lo, head, fields = win
        got_lo = max(start, lo)
        got_hi = min(start + count, head)
        if fields is None or got_hi <= got_lo:
            hdr = tp.pack_json({"ring": ri, "start": got_lo, "count": 0,
                                "floor": lo})
            return tp.INFLIGHT_RESPONSE, (
                len(hdr).to_bytes(4, "little") + hdr)
        sl = slice(got_lo - lo, got_hi - lo)
        k = np.ascontiguousarray(fields["keys"][sl], np.int32)
        v = np.ascontiguousarray(fields["values"][sl], np.int32)
        t = np.ascontiguousarray(fields["timestamps"][sl], np.int32)
        m = np.ascontiguousarray(fields["valid"][sl], np.uint8)
        hdr = tp.pack_json({"ring": ri, "start": got_lo,
                            "count": got_hi - got_lo, "floor": lo,
                            "shape": list(k.shape)})
        return tp.INFLIGHT_RESPONSE, (
            len(hdr).to_bytes(4, "little") + hdr
            + k.tobytes() + v.tobytes() + t.tobytes() + m.tobytes())

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype == tp.INFLIGHT_REQUEST:
            return self._handle_inflight(payload)
        if mtype != tp.DETERMINANT_REQUEST:
            return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})
        req = tp.unpack_json(payload)
        known = req.get("known_heads", {})
        encoding = req.get("encoding", "flat")
        tp.adopt_trace(req)
        tp.adopt_hlc(req, verb="DETERMINANT_REQUEST")
        tr = get_tracer()
        deltas = []
        floors: Dict[int, int] = {}
        with self._lock:
            for flat in req["flats"]:
                rows = self._rows.get(flat)
                if rows is None:
                    continue
                start = self._starts[flat]
                floors[flat] = start
                lo = max(int(known.get(str(flat), -1)), start)
                if lo - start >= rows.shape[0]:
                    continue
                deltas.append((flat, lo, rows[lo - start:]))
        if deltas and tr.enabled:
            # Only when rows are served: empty polling rounds would drown
            # the trace.
            tr.event("determinants.served",
                     flats=[d[0] for d in deltas],
                     rows=int(sum(d[2].shape[0] for d in deltas)))
        frame = serde.encode_delta(deltas, encoding=encoding)
        # Response = u32 header length | JSON header | delta frame. The
        # floors (each owner log's truncation point) let mirrors release
        # rows below them — a remote notifyCheckpointComplete.
        hdr = tp.pack_json({"floors": {str(f): v
                                       for f, v in floors.items()}})
        return (tp.DETERMINANT_RESPONSE,
                len(hdr).to_bytes(4, "little") + hdr + frame)

    def close(self) -> None:
        self.server.close()


class JobMasterController:
    """Drives standby-host failover around :class:`JobMasterServer`
    (reference JobMaster.java:151 failover driving and
    RunStandbyTaskStrategy dispatch):

    - every registered worker that advertises a log endpoint gets a
      :class:`RemoteReplicaMirror`, pulled by :meth:`sync`;
    - :meth:`failed` names the heartbeat-expired workers;
    - :meth:`rebuild` rebuilds a dead worker's whole job in this process
      through ``ClusterRunner.bootstrap_standby`` — durable checkpoint
      plus mirror rows — never restoring an ignored checkpoint.

    The mirrors' logs live on ``device``, as does the rebuilt job unless
    ``rebuild`` is given another."""

    def __init__(self, jm: JobMasterServer,
                 mirror_capacity: int = 1 << 14, max_epochs: int = 64,
                 device="cuda"):
        self.jm = jm
        self.mirror_capacity = mirror_capacity
        self.max_epochs = max_epochs
        self.device = _device.resolve(device)
        self.mirrors: Dict[str, RemoteReplicaMirror] = {}

    def attach(self) -> List[str]:
        """Create mirrors for newly registered workers (idempotent)."""
        new = []
        with self.jm._lock:
            meta = dict(self.jm._meta)
        for eid, info in meta.items():
            if eid in self.mirrors or "log_port" not in info:
                continue
            self.mirrors[eid] = RemoteReplicaMirror(
                (info.get("log_host", "127.0.0.1"), info["log_port"]),
                flats=list(range(info["num_subtasks"])),
                capacity=self.mirror_capacity, max_epochs=self.max_epochs,
                device=self.device)
            new.append(eid)
        return sorted(new)

    def sync(self) -> Dict[str, int]:
        """One pull round over every healthy worker's mirror."""
        out = {}
        dead = set(self.jm.expired())
        for eid, m in self.mirrors.items():
            if eid in dead:
                continue
            try:
                out[eid] = m.sync()
            except OSError:
                out[eid] = -1          # endpoint gone; heartbeats decide
        return out

    def failed(self) -> List[str]:
        return self.jm.expired()

    def ignored_checkpoints(self) -> List[int]:
        with self.jm._lock:
            return sorted(set(self.jm._ignored))

    def rebuild(self, executor_id: str, job, **runner_kw):
        """Standby-host failover for ``executor_id``'s job: bootstrap a
        fresh runner in this process from the worker's durable
        checkpoint dir and this controller's mirror of its logs. Returns
        ``(runner, RecoveryReport)``."""
        from clonos_tpu_torch.runtime.cluster import ClusterRunner
        with self.jm._lock:
            info = dict(self.jm._meta[executor_id])
        mirror = self.mirrors[executor_id]
        rows = {f: mirror.rows_with_start(f) for f in mirror.flats}
        runner_kw.setdefault("device", self.device)
        return ClusterRunner.bootstrap_standby(
            job, info["checkpoint_dir"], rows,
            ignored_checkpoints=self.ignored_checkpoints(), **runner_kw)

    def close(self) -> None:
        for m in self.mirrors.values():
            m.close()


class RemoteReplicaMirror:
    """Standby-host replica of remote task logs: one
    :class:`clog.ThreadCausalLog` per owner log, on ``device``, merged
    with the on-card offset-dedup rule."""

    def __init__(self, address: Tuple[str, int], flats: List[int],
                 capacity: int = 1 << 14, max_epochs: int = 64,
                 encoding: str = "flat", device="cuda"):
        self._client = tp.ControlClient(tuple(address))
        self.flats = list(flats)
        self.encoding = encoding
        self._replicas: Dict[int, clog.ThreadCausalLog] = {
            f: clog.ThreadCausalLog(capacity, max_epochs, device=device)
            for f in self.flats}
        #: bytes of the last response's delta frame, and rows it held
        self.last_frame_bytes = 0
        self.last_rows = 0

    def head(self, flat: int) -> int:
        return self._replicas[flat].head

    def rows(self, flat: int) -> np.ndarray:
        log = self._replicas[flat]
        return log.delta_for_consumer(
            log.tail, max(0, log.head - log.tail))[0]

    def rows_with_start(self, flat: int) -> Tuple[np.ndarray, int]:
        """(live rows, absolute offset of rows[0]) — the determinant
        source form ``ClusterRunner.bootstrap_standby`` consumes."""
        log = self._replicas[flat]
        return (self.rows(flat), int(log.tail))

    def fetch_inflight(self, ring: int, start: int, count: int
                       ) -> Tuple[int, Optional[dict]]:
        """Pull a window of a remote upstream's in-flight log: returns
        (absolute start of the served window, field dict with
        keys/values/timestamps ``[n, P, cap]`` int32 and valid ``[n, P,
        cap]`` bool), or (floor, None) when the range holds no retained
        step."""
        rt, resp = self._client.call(
            tp.INFLIGHT_REQUEST,
            tp.pack_json({"ring": ring, "start": start, "count": count}))
        if rt == tp.ERROR:
            raise RuntimeError(tp.unpack_json(resp)["error"])
        hlen = int.from_bytes(resp[:4], "little")
        hdr = tp.unpack_json(resp[4: 4 + hlen])
        if hdr["count"] == 0:
            return hdr["floor"], None
        shape = tuple(hdr["shape"])
        n = int(np.prod(shape)) * 4
        body = resp[4 + hlen:]
        k = np.frombuffer(body[:n], np.int32).reshape(shape)
        v = np.frombuffer(body[n:2 * n], np.int32).reshape(shape)
        t = np.frombuffer(body[2 * n:3 * n], np.int32).reshape(shape)
        m = np.frombuffer(body[3 * n:3 * n + n // 4],
                          np.uint8).reshape(shape).astype(bool)
        return hdr["start"], {"keys": k, "values": v, "timestamps": t,
                              "valid": m}

    def sync(self) -> int:
        """One pull round: request each owned log's suffix past our head
        and merge it with offset dedup. Returns the rows absorbed.

        A merge gap (a delta starting past our head) can only mean the
        owner truncated its log across a completed checkpoint — pulling
        from the known head never skips live rows — so the mirror applies
        the same truncation: it rebases to the delta's start and absorbs
        from there."""
        known = {str(f): self.head(f) for f in self.flats}
        req = tp.attach_hlc(
            tp.attach_trace({"flats": self.flats, "known_heads": known,
                             "encoding": self.encoding}),
            verb="DETERMINANT_REQUEST")
        rt, resp = self._client.call(tp.DETERMINANT_REQUEST,
                                     tp.pack_json(req))
        if rt == tp.ERROR:
            raise RuntimeError(tp.unpack_json(resp)["error"])
        hlen = int.from_bytes(resp[:4], "little")
        floors = tp.unpack_json(resp[4: 4 + hlen]).get("floors", {})
        frame = resp[4 + hlen:]
        absorbed = 0
        for flat, start, rows in serde.decode_delta(frame):
            log = self._replicas[flat]
            rows = np.asarray(rows, np.int32)
            if rows.shape[0] > log.capacity:
                raise RuntimeError(
                    f"mirror of log {flat}: delta of {rows.shape[0]} rows "
                    f"exceeds mirror capacity {log.capacity} — size the "
                    f"mirror at least as large as the owner's log")
            if not log.merge_delta(rows, start):
                # Rebuilt on the log's device, like every offset.
                log.state = log.state._replace(
                    head=_device.scalar(start, log.device),
                    tail=_device.scalar(start, log.device))
                if not log.merge_delta(rows, start):
                    raise RuntimeError(
                        f"mirror of log {flat}: delta rejected even "
                        f"after rebase to {start}")
            absorbed += rows.shape[0]
        # Owner truncation points release mirror history; a mirror that
        # still overflows is undersized for the owner's un-truncated
        # window, so fail loudly instead of serving a wrapped ring.
        for flat, log in self._replicas.items():
            tail, head = log.tail, log.head
            floor = int(floors.get(str(flat), tail))
            if floor > tail:
                # The floor can sit past our merged head (the owner
                # truncated its whole log before we absorbed those rows):
                # rebase to an empty window at the floor, never tail >
                # head.
                head = max(floor, head)
                tail = floor
                log.state = log.state._replace(
                    tail=_device.scalar(tail, log.device),
                    head=_device.scalar(head, log.device))
            if head - tail > log.capacity:
                raise RuntimeError(
                    f"mirror of log {flat}: {head - tail} live rows exceed "
                    f"capacity {log.capacity}; increase mirror capacity or "
                    f"checkpoint more often")
        self.last_frame_bytes = len(frame)
        self.last_rows = absorbed
        return absorbed

    def close(self) -> None:
        self._client.close()
