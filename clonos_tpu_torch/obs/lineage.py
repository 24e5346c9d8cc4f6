"""Record-level lineage plane (port of ``clonos_tpu/obs/lineage.py``):
explain any output record end to end.

The audit plane proves *epochs* are exactly-once, the timeline orders
*events*, incident forensics localizes a divergence to a first
determinant row — but none of them answers the operator's first
question: "where did THIS record come from, and why does it have THIS
value?". The paper's premise makes that answerable: every
nondeterministic influence on a record is already a determinant row,
so a record's causal derivation is latently recorded. This module
materializes it:

- a **deterministic dye sampler**: ``k`` records per epoch are marked
  at the source *by key hash* (:func:`select_dyed` — a pure function
  of the epoch's key set, so the soak control twin dyes the SAME
  records with zero coordination and zero wire fields);
- :class:`LineagePlane` — at every epoch seal it scans the sealed
  determinant window (the in-flight ring steps, the sink transaction
  shards, the ORDER/TIMESTAMP/RNG determinant rows) for dyed keys and
  appends compact **tag observations** to a per-process lineage JSONL
  (``utils/jsonl`` discipline: torn-tail tolerant, one writer rule);
- a **pure reconstructor** (:func:`reconstruct`) that joins
  observations from any number of processes into one per-record causal
  path — source offset → every vertex/step it touched (with the
  determinant rows that influenced it) → sink part file or serve read
  — rendered byte-identically across processes
  (:func:`render_trace`, the rootcause.py convention).

Zero overhead off: :class:`NullLineage` is the process default — no
wire fields, no per-record work, no seal-time scan (the NullTracer
convention). Enabling is the explicit :func:`configure_lineage`
opt-in; ``python -m clonos_tpu_torch lineage`` is the CLI over the files.

The observation format is pinned: :data:`LINEAGE_SCHEMA` has one
canonical fingerprint (:func:`lineage_schema_fingerprint`) checked
against ``.clonos-lineage-schema`` in conftest, so silent format
drift fails the session like census/bundle drift does.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence

from clonos_tpu_torch.obs.incident import canonical_json
from clonos_tpu_torch.utils.jsonl import JsonlAppender, read_jsonl

#: Observation kinds one lineage JSONL may carry (anything else is a
#: typo'd dead observation and raises).
OBSERVATION_KINDS = (
    "dye",      # dye decision: key marked at its source offset
    "hop",      # dyed key seen in a vertex's in-flight ring step
    "det",      # ORDER/TIMESTAMP/RNG determinant rows for one epoch
    "sink",     # dyed key landed in a sink transaction part
    "serve",    # dyed key read through the serve tier
)

#: The pinned observation/report format. PURE data — any change here
#: changes :func:`lineage_schema_fingerprint` and must be re-pinned in
#: ``.clonos-lineage-schema`` (conftest enforces).
LINEAGE_SCHEMA = {
    "format": "clonos-lineage",
    "version": 1,
    "kinds": {
        "dye": "key/epoch/vertex/step/pos — the source offset",
        "hop": "key/epoch/vertex/step/pos/value/timestamp/"
               "key_group/subtask",
        "det": "epoch/flat/rows (ORDER|TIMESTAMP|RNG lanes)/truncated",
        "sink": "key/epoch/vertex/subtask/part/value/timestamp",
        "serve": "key/epoch/replica/rerouted",
    },
    "path": "dyed_at -> hops[] (+determinants[]) -> sinks[]/serves[]",
}


def lineage_schema_fingerprint() -> str:
    """Fingerprint of :data:`LINEAGE_SCHEMA` (the
    ``.clonos-lineage-schema`` pin)."""
    return hashlib.blake2b(canonical_json(LINEAGE_SCHEMA).encode(),
                           digest_size=8).hexdigest()


# --- the dye sampler ---------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: the one stateless hash under the dye."""
    x &= _M64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _M64
    x ^= x >> 33
    return x


def dye_hash(key: int, epoch: int, salt: int) -> int:
    """Per-(key, epoch) dye rank — a pure function, so every process
    (and the soak control twin) ranks identically."""
    return _mix64((int(key) & _M64)
                  ^ _mix64((int(epoch) * 0x9E3779B97F4A7C15
                            + int(salt)) & _M64))


def select_dyed(keys: Iterable[int], epoch: int, *, salt: int,
                k: int) -> List[int]:
    """The ``k`` dyed keys of one epoch: the distinct keys with the
    smallest dye hash (ties by key). A pure function of the SET of
    keys — scan order, duplicates, and process boundaries cannot
    change the selection."""
    distinct = {int(x) for x in keys}
    ranked = sorted(distinct,
                    key=lambda x: (dye_hash(x, epoch, salt), x))
    return ranked[:max(0, int(k))]


# --- the disabled plane ------------------------------------------------------


class NullLineage:
    """The disabled plane: every hook is a constant no-op — zero wire
    fields, zero per-record work, no seal-time window scan (the
    NullTracer convention)."""

    enabled = False
    k = 0
    salt = 0
    dyed = 0
    observations = 0
    epochs_observed = 0
    serve_hits = 0

    def observe_epoch(self, epoch: int, window, **ctx) -> int:
        return 0

    def observe_serve(self, key: int, **fields) -> bool:
        return False

    def is_dyed(self, key: int) -> bool:
        return False

    def wire_config(self) -> Optional[dict]:
        return None

    def register_gauges(self, registry) -> None:
        pass

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


# --- the live plane ----------------------------------------------------------


class LineagePlane:
    """One process's lineage writer: dye selection + seal-time
    observation capture into ``lineage-<service>.jsonl``.

    All capture runs at epoch *seal* on the host — the per-step/
    per-record hot path is untouched even when enabled; the dye needs
    no stored bit because it is a pure key-hash function. Observation
    files from any number of planes (workers, the soak twins) feed one
    :func:`reconstruct` join.
    """

    enabled = True

    def __init__(self, root: str, *, service: Optional[str] = None,
                 k: int = 4, salt: int = 0xC109_0519,
                 det_rows: int = 64, dyed_cache: int = 4096,
                 fsync_every: int = 0):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.service = service
        self.k = int(k)
        self.salt = int(salt)
        self.det_rows = int(det_rows)
        self.dyed_cache = int(dyed_cache)
        # clonos: allow(entropy) — the pid only names this process's
        # observation FILE; it never enters an observation record, and
        # the reconstructor joins by content (service/seq excluded), so
        # a restarted writer under a new pid changes nothing replayed.
        name = f"lineage-{service or f'pid{os.getpid()}'}.jsonl"
        self.path = os.path.join(root, name)
        self._app = JsonlAppender(self.path, sort_keys=True,
                                  default=str,
                                  fsync_every=int(fsync_every))
        self._lock = threading.Lock()
        self._observed: set = set()       # epochs already captured
        self._dyed_recent: Dict[int, None] = {}   # insertion-ordered
        self.dyed = 0
        self.observations = 0
        self.epochs_observed = 0
        self.serve_hits = 0

    # --- wire convention (parallel/transport.attach_lineage) ----------------

    def wire_config(self) -> Optional[dict]:
        """The dye config a JobMaster stamps on DEPLOY headers so every
        worker dyes the SAME records — the multi-host down-payment for
        per-record tag piggybacking (causal/serde lineage tag codec)."""
        return {"root": self.root, "k": self.k, "salt": self.salt}

    # --- capture -------------------------------------------------------------

    def _append(self, rec: Dict[str, Any]) -> None:
        if rec["kind"] not in OBSERVATION_KINDS:
            raise ValueError(
                f"unknown lineage observation kind {rec['kind']!r} "
                f"(kinds: {', '.join(OBSERVATION_KINDS)})")
        rec["service"] = self.service
        rec["seq"] = self.observations
        self._app.append(rec)
        self.observations += 1

    def _remember_dyed(self, keys: Sequence[int]) -> None:
        for key in keys:
            self._dyed_recent[int(key)] = None
        while len(self._dyed_recent) > self.dyed_cache:
            self._dyed_recent.pop(next(iter(self._dyed_recent)))

    def is_dyed(self, key: int) -> bool:
        """Whether ``key`` was dyed in a recently observed epoch (the
        serve-read terminus test)."""
        return int(key) in self._dyed_recent

    def observe_epoch(self, epoch: int, window: Dict[str, Any], *,
                      num_key_groups: Optional[int] = None,
                      topology: Optional[Dict[int, int]] = None,
                      parts: Optional[Dict[int, Dict[int, Any]]] = None,
                      ) -> int:
        """Capture one sealed epoch: select the dye set over the
        window's ring keys, then append dye/hop/det/sink observations
        for every dyed key. ``window`` is one
        ``LocalExecutor.epoch_window`` snapshot (live or from
        ``FenceHandles.window()``); ``topology`` maps vertex id →
        parallelism so hops carry key-group/subtask; ``parts`` maps
        sink vertex id → per-subtask ``[n, 3]`` pending records.
        Idempotent per epoch (a recovery replay re-seals bit-identical
        windows; capturing them twice would only duplicate rows the
        reconstructor dedups anyway). Returns observations appended."""
        import numpy as np

        from clonos_tpu_torch.runtime.executor import iter_ring_steps

        epoch = int(epoch)
        with self._lock:
            if epoch in self._observed:
                return 0
            self._observed.add(epoch)
            before = self.observations

            steps = [(vid, seq,
                      np.asarray(keys, np.int64).reshape(-1),
                      np.asarray(values, np.int64).reshape(-1),
                      np.asarray(stamps, np.int64).reshape(-1))
                     for vid, seq, keys, values, stamps
                     in iter_ring_steps(window)]
            union: set = set()
            for _, _, keys, _, _ in steps:
                union.update(int(x) for x in keys.tolist())
            dyed = select_dyed(union, epoch, salt=self.salt, k=self.k)
            if dyed:
                self._remember_dyed(dyed)
                self.dyed += len(dyed)
                dyed_arr = np.asarray(sorted(dyed), np.int64)

                # Hop rows, and the source offset: the first (vertex,
                # step, pos) occurrence in deterministic scan order.
                src: Dict[int, tuple] = {}
                for vid, seq, keys, values, stamps in steps:
                    hit = np.nonzero(np.isin(keys, dyed_arr))[0]
                    if hit.size == 0:
                        continue
                    kg = sub = None
                    par = (topology or {}).get(vid)
                    if par and num_key_groups:
                        from clonos_tpu_torch.runtime.query import \
                            owner_subtask_np
                        kg, sub = owner_subtask_np(
                            keys[hit].astype(np.int32), int(par),
                            int(num_key_groups))
                    for i, pos in enumerate(hit.tolist()):
                        key = int(keys[pos])
                        src.setdefault(key, (vid, seq, pos))
                        rec = {"kind": "hop", "key": key,
                               "epoch": epoch, "vertex": int(vid),
                               "step": int(seq), "pos": int(pos),
                               "value": int(values[pos]),
                               "timestamp": int(stamps[pos])}
                        if kg is not None:
                            rec["key_group"] = int(kg[i])
                            rec["subtask"] = int(sub[i])
                        self._append(rec)
                for key in dyed:
                    vid, seq, pos = src.get(key, (-1, -1, -1))
                    self._append({"kind": "dye", "key": int(key),
                                  "epoch": epoch, "vertex": int(vid),
                                  "step": int(seq), "pos": int(pos)})

                # The determinant rows that influenced this epoch —
                # ORDER/TIMESTAMP/RNG lanes only (the nondeterminism
                # the paper logs; checkpoint/fence bookkeeping rows
                # are not record influences).
                from clonos_tpu_torch.causal.determinant import (LANE_TAG,
                                                           ORDER, RNG,
                                                           TIMESTAMP)
                for flat in sorted(window.get("logs", {}), key=int):
                    rows = np.asarray(window["logs"][flat],
                                      np.int64).reshape(-1, 8)
                    m = np.isin(rows[:, LANE_TAG],
                                [ORDER, TIMESTAMP, RNG])
                    sel = rows[m]
                    if sel.shape[0] == 0:
                        continue
                    self._append({
                        "kind": "det", "epoch": epoch,
                        "flat": int(flat),
                        "rows": sel[:self.det_rows].tolist(),
                        "truncated": bool(sel.shape[0]
                                          > self.det_rows)})

                # Sink termini: dyed keys inside the epoch's sealed
                # transaction shards. The part name is the stable
                # ``part-<epoch>-<sub>`` prefix (the filesink token
                # suffix is attempt-scoped, not record identity).
                for vid in sorted(parts or {}):
                    for sub in sorted(parts[vid]):
                        recs = np.asarray(parts[vid][sub],
                                          np.int64).reshape(-1, 3)
                        hit = np.nonzero(
                            np.isin(recs[:, 0], dyed_arr))[0]
                        for pos in hit.tolist():
                            self._append({
                                "kind": "sink",
                                "key": int(recs[pos, 0]),
                                "epoch": epoch, "vertex": int(vid),
                                "subtask": int(sub),
                                "part": f"part-{epoch}-{int(sub)}",
                                "value": int(recs[pos, 1]),
                                "timestamp": int(recs[pos, 2])})
            self.epochs_observed += 1
            self._app.sync()
            return self.observations - before

    def observe_serve(self, key: int, *, epoch: int, replica: str,
                      rerouted: bool = False) -> bool:
        """Serve-read terminus: append an observation when ``key`` is
        dyed (the ``ServeRouter`` provenance-stamp hook). Returns
        whether the read was recorded."""
        with self._lock:
            if not self.is_dyed(key):
                return False
            self._append({"kind": "serve", "key": int(key),
                          "epoch": int(epoch), "replica": str(replica),
                          "rerouted": bool(rerouted)})
            self.serve_hits += 1
            return True

    # --- plumbing ------------------------------------------------------------

    def register_gauges(self, registry) -> None:
        """``lineage.*`` gauges — registered into a runner's
        MetricRegistry they ride the HEARTBEAT piggyback; ``python -m
        clonos_tpu_torch top`` renders the lineage: row from them."""
        g = registry.group("lineage")
        g.gauge("dyed", lambda: self.dyed)
        g.gauge("observations", lambda: self.observations)
        g.gauge("epochs-observed", lambda: self.epochs_observed)
        g.gauge("serve-hits", lambda: self.serve_hits)
        g.gauge("k", lambda: self.k)

    def sync(self) -> None:
        self._app.sync()

    def close(self) -> None:
        self._app.close()


# --- reading + reconstruction (pure) -----------------------------------------


def read_observations(paths) -> List[dict]:
    """Read lineage observations from one path or a list of paths,
    torn-tail tolerantly (a SIGKILLed writer leaves at most one torn
    final line; utils/jsonl drops it)."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    out: List[dict] = []
    for path in paths:
        out.extend(read_jsonl(path, label=str(path)))
    return out


def _hop_key(h: dict) -> tuple:
    return (h["epoch"], h["vertex"], h["step"], h["pos"])


def reconstruct(observations: Iterable[dict]) -> Dict[str, Any]:
    """Join observations (from any number of processes) into
    per-record causal paths. PURE: a function of the observation
    CONTENT only — per-process ``service``/``seq`` fields and file
    order never reach the report, so two processes reconstructing the
    same observations render byte-identical traces
    (:func:`render_trace`).

    A path is **broken** when (a) hops exist with no dye decision
    (``no-dye`` — a partial file set), or (b) the dyed record never
    reaches a terminus while other records did (``no-terminus`` — the
    record was lost in flight)."""
    dyes: Dict[int, List[dict]] = {}
    hops: Dict[int, Dict[tuple, dict]] = {}
    sinks: Dict[int, Dict[tuple, dict]] = {}
    serves: Dict[int, Dict[tuple, dict]] = {}
    dets: Dict[tuple, dict] = {}
    total = 0
    for rec in observations:
        total += 1
        kind = rec.get("kind")
        if kind == "dye":
            dyes.setdefault(int(rec["key"]), []).append(
                {"epoch": int(rec["epoch"]),
                 "vertex": int(rec["vertex"]),
                 "step": int(rec["step"]), "pos": int(rec["pos"])})
        elif kind == "hop":
            h = {"epoch": int(rec["epoch"]),
                 "vertex": int(rec["vertex"]),
                 "step": int(rec["step"]), "pos": int(rec["pos"]),
                 "value": int(rec["value"]),
                 "timestamp": int(rec["timestamp"])}
            if "key_group" in rec:
                h["key_group"] = int(rec["key_group"])
                h["subtask"] = int(rec["subtask"])
            hops.setdefault(int(rec["key"]), {})[_hop_key(h)] = h
        elif kind == "sink":
            s = {"epoch": int(rec["epoch"]),
                 "vertex": int(rec["vertex"]),
                 "subtask": int(rec["subtask"]),
                 "part": str(rec["part"]),
                 "value": int(rec["value"]),
                 "timestamp": int(rec["timestamp"])}
            sinks.setdefault(int(rec["key"]), {})[
                (s["epoch"], s["part"], s["value"],
                 s["timestamp"])] = s
        elif kind == "serve":
            v = {"epoch": int(rec["epoch"]),
                 "replica": str(rec["replica"]),
                 "rerouted": bool(rec["rerouted"])}
            serves.setdefault(int(rec["key"]), {})[
                (v["epoch"], v["replica"], v["rerouted"])] = v
        elif kind == "det":
            d = {"epoch": int(rec["epoch"]), "flat": int(rec["flat"]),
                 "rows": [[int(x) for x in row]
                          for row in rec["rows"]],
                 "truncated": bool(rec["truncated"])}
            dets[(d["epoch"], d["flat"],
                  canonical_json(d["rows"]))] = d

    any_terminus = bool(sinks) or bool(serves)
    keys = sorted(set(dyes) | set(hops) | set(sinks) | set(serves))
    paths: Dict[str, Any] = {}
    broken_keys: List[int] = []
    for key in keys:
        dye_list = sorted(
            dyes.get(key, []),
            key=lambda d: (d["epoch"], d["vertex"], d["step"],
                           d["pos"]))
        path: Dict[str, Any] = {
            "key": key,
            "dyed_at": dye_list[0] if dye_list else None,
            "hops": [hops[key][hk]
                     for hk in sorted(hops.get(key, {}))],
            "sinks": [sinks[key][sk]
                      for sk in sorted(sinks.get(key, {}))],
            "serves": [serves[key][vk]
                       for vk in sorted(serves.get(key, {}))],
        }
        touched = {h["epoch"] for h in path["hops"]}
        if path["dyed_at"] is not None:
            touched.add(path["dyed_at"]["epoch"])
        path["determinants"] = [
            dets[dk] for dk in sorted(dets)
            if dets[dk]["epoch"] in touched]
        broken: List[str] = []
        if not dye_list:
            broken.append("no-dye")
        elif (any_terminus and not path["sinks"]
                and not path["serves"]):
            broken.append("no-terminus")
        path["broken"] = broken
        if broken:
            broken_keys.append(key)
        paths[str(key)] = path
    return {
        "format": (f"{LINEAGE_SCHEMA['format']}"
                   f"/v{LINEAGE_SCHEMA['version']}"),
        "schema_fingerprint": lineage_schema_fingerprint(),
        "observations": total,
        "keys": paths,
        "broken_keys": broken_keys,
        "ok": not broken_keys,
    }


def trace_key(observations: Iterable[dict], key: int) -> Dict[str, Any]:
    """One record's reconstructed causal path (the ``lineage --key``
    view): the full join, narrowed to ``key``."""
    report = reconstruct(observations)
    path = report["keys"].get(str(int(key)))
    return {
        "format": report["format"],
        "schema_fingerprint": report["schema_fingerprint"],
        "key": int(key),
        "path": path,
        "ok": bool(path) and not path["broken"],
    }


def render_trace(report: Dict[str, Any]) -> str:
    """The byte encoding two processes must agree on: canonical JSON +
    newline (the rootcause.py convention)."""
    return canonical_json(report) + "\n"


def format_trace(report: Dict[str, Any]) -> str:
    """Human-readable rendering of a :func:`reconstruct` report."""
    lines = [f"lineage {report['format']} — "
             f"{report['observations']} observations, "
             f"{len(report['keys'])} dyed records, "
             f"{'OK' if report['ok'] else 'BROKEN paths'}"]
    for key in sorted(report["keys"], key=int):
        p = report["keys"][key]
        d = p["dyed_at"]
        srcs = (f"v{d['vertex']} step {d['step']} pos {d['pos']} "
                f"@ epoch {d['epoch']}" if d else "UNKNOWN SOURCE")
        lines.append(f"  key {key}: dyed at {srcs}")
        for h in p["hops"]:
            where = (f" -> sub {h['subtask']} (kg {h['key_group']})"
                     if "subtask" in h else "")
            lines.append(
                f"    hop   epoch {h['epoch']} v{h['vertex']} "
                f"step {h['step']} pos {h['pos']} "
                f"value={h['value']} ts={h['timestamp']}{where}")
        for s in p["sinks"]:
            lines.append(
                f"    sink  epoch {s['epoch']} v{s['vertex']} "
                f"{s['part']} value={s['value']} "
                f"ts={s['timestamp']}")
        for v in p["serves"]:
            rr = " (rerouted)" if v["rerouted"] else ""
            lines.append(f"    serve epoch {v['epoch']} "
                         f"replica {v['replica']}{rr}")
        ndet = sum(len(d["rows"]) for d in p["determinants"])
        if ndet:
            lines.append(f"    dets  {ndet} ORDER/TIMESTAMP/RNG rows "
                         f"across {len(p['determinants'])} windows")
        if p["broken"]:
            lines.append(f"    BROKEN: {', '.join(p['broken'])}")
    return "\n".join(lines) + "\n"


def to_trace_records(report: Dict[str, Any]) -> List[dict]:
    """Paths as tracer-style records for the validated Chrome export
    path (obs/chrome.to_chrome): one instant event per hop/terminus,
    pid = vertex, tid = subtask, logical ts = epoch + step/1000."""
    out: List[dict] = []
    for key in sorted(report["keys"], key=int):
        p = report["keys"][key]
        for h in p["hops"]:
            out.append({"name": f"key {key} hop",
                        "service": f"vertex-{h['vertex']}",
                        "pid": int(h["vertex"]),
                        "tid": int(h.get("subtask", 0)),
                        "ts": h["epoch"] + h["step"] / 1000.0,
                        "args": {"key": key, "value": h["value"],
                                 "pos": h["pos"]}})
        for s in p["sinks"]:
            out.append({"name": f"key {key} sink",
                        "service": f"vertex-{s['vertex']}",
                        "pid": int(s["vertex"]),
                        "tid": int(s["subtask"]),
                        "ts": s["epoch"] + 0.999,
                        "args": {"key": key, "part": s["part"]}})
        for v in p["serves"]:
            out.append({"name": f"key {key} serve",
                        "service": str(v["replica"]),
                        "pid": 0, "tid": 0,
                        "ts": v["epoch"] + 0.999,
                        "args": {"key": key,
                                 "rerouted": v["rerouted"]}})
    return out


# --- process-global plane ----------------------------------------------------

_global_lineage = NullLineage()
_global_lock = threading.Lock()


def get_lineage():
    """The process lineage plane (Null unless configured)."""
    return _global_lineage


def configure_lineage(root: str, **kw) -> LineagePlane:
    """Install a live lineage plane (the opt-in gate)."""
    global _global_lineage
    with _global_lock:
        _global_lineage = LineagePlane(root, **kw)
        return _global_lineage


def reset_lineage() -> None:
    """Back to the disabled NullLineage (tests)."""
    global _global_lineage
    with _global_lock:
        _global_lineage = NullLineage()


# --- self-check --------------------------------------------------------------


def _synthetic_observations() -> List[dict]:
    """A three-record observation set covering the reconstruction
    regimes: key 7 has a complete source → hops → sink path (with
    determinant context), key 9 was dyed but never reached a terminus
    (a lost record: ``no-terminus``), key 11 has a hop with no dye
    decision (a partial file set: ``no-dye``). ``service``/``seq``
    vary to prove they never reach the report."""
    import json as _json
    obs = [
        {"kind": "dye", "key": 7, "epoch": 1, "vertex": 0, "step": 0,
         "pos": 2, "service": "a", "seq": 0},
        {"kind": "hop", "key": 7, "epoch": 1, "vertex": 0, "step": 0,
         "pos": 2, "value": 70, "timestamp": 1000, "key_group": 3,
         "subtask": 1, "service": "a", "seq": 1},
        {"kind": "hop", "key": 7, "epoch": 1, "vertex": 1, "step": 2,
         "pos": 0, "value": 71, "timestamp": 1002, "key_group": 3,
         "subtask": 0, "service": "b", "seq": 0},
        {"kind": "det", "epoch": 1, "flat": 0, "truncated": False,
         "rows": [[1, 0, 1000, 0, 0, 0, 0, 0],
                  [2, 0, 42, 0, 0, 0, 0, 0]],
         "service": "a", "seq": 2},
        {"kind": "sink", "key": 7, "epoch": 1, "vertex": 2,
         "subtask": 0, "part": "part-1-0", "value": 71,
         "timestamp": 1002, "service": "b", "seq": 1},
        {"kind": "dye", "key": 9, "epoch": 1, "vertex": 0, "step": 1,
         "pos": 0, "service": "a", "seq": 3},
        {"kind": "hop", "key": 9, "epoch": 1, "vertex": 0, "step": 1,
         "pos": 0, "value": 90, "timestamp": 1001, "service": "a",
         "seq": 4},
        {"kind": "hop", "key": 11, "epoch": 2, "vertex": 1, "step": 0,
         "pos": 1, "value": 110, "timestamp": 2000, "service": "b",
         "seq": 2},
    ]
    # the JSON round-trip below mirrors two fresh processes
    return _json.loads(_json.dumps(obs))


def lineage_self_check() -> List[dict]:
    """Deterministic in-memory lineage self-check (the conftest /
    ``python -m clonos_tpu_torch lineage --self-check`` gate): reconstruct the
    synthetic observation set twice — once as-built, once through a
    JSON round-trip (the two-fresh-process equivalence) — and demand
    byte-identical traces that join and break paths exactly. Pure: no
    files, no wall clock, no device. Returns findings (empty == sound)."""
    import json as _json

    findings: List[dict] = []

    def check(rule: str, ok: bool, detail: str) -> None:
        if not ok:
            findings.append({"rule": rule, "detail": detail})

    obs = _synthetic_observations()
    rep = reconstruct(obs)
    text = render_trace(rep)
    text2 = render_trace(
        reconstruct(_json.loads(canonical_json(obs))))
    check("deterministic", text == text2,
          "trace not byte-identical across a JSON round-trip")
    # shuffled observation order (another process's file interleaving)
    # must not change a single byte either
    text3 = render_trace(reconstruct(list(reversed(obs))))
    check("order-free", text == text3,
          "trace depends on observation file order")

    p7 = rep["keys"].get("7") or {}
    check("join", p7.get("dyed_at") == {"epoch": 1, "vertex": 0,
                                        "step": 0, "pos": 2}
          and len(p7.get("hops", [])) == 2
          and p7.get("hops", [{}])[-1].get("vertex") == 1
          and len(p7.get("sinks", [])) == 1
          and p7.get("sinks", [{}])[0].get("part") == "part-1-0",
          f"key 7 path mis-joined: {p7}")
    check("determinants", len(p7.get("determinants", [])) == 1
          and len(p7["determinants"][0]["rows"]) == 2,
          "key 7 must carry its epoch's ORDER/TIMESTAMP/RNG rows")
    check("complete", not p7.get("broken", ["missing"]),
          f"key 7 must be unbroken, got {p7.get('broken')}")
    p9 = rep["keys"].get("9") or {}
    check("lost", p9.get("broken") == ["no-terminus"],
          f"key 9 must break as no-terminus, got {p9.get('broken')}")
    p11 = rep["keys"].get("11") or {}
    check("orphan", p11.get("broken") == ["no-dye"],
          f"key 11 must break as no-dye, got {p11.get('broken')}")
    check("verdict", rep["ok"] is False
          and rep["broken_keys"] == [9, 11],
          f"expected broken keys [9, 11], got {rep['broken_keys']}")

    # A clean subset must report ok (the --report json exit-0 path).
    clean = reconstruct([r for r in obs if r.get("key") == 7
                         or r["kind"] == "det"])
    check("clean-ok", clean["ok"] is True, "key-7-only set must be ok")

    # Dye selection: pure in the key SET — permutation/duplication
    # invariant, bounded by k, ties broken deterministically.
    a = select_dyed([5, 3, 9, 3, 5, 12], 4, salt=17, k=2)
    b = select_dyed([12, 9, 5, 3], 4, salt=17, k=2)
    check("dye-pure", a == b and len(a) == 2,
          f"dye selection not a pure set function: {a} vs {b}")
    check("schema", lineage_schema_fingerprint()
          == lineage_schema_fingerprint(),
          "schema fingerprint not stable")
    return findings
