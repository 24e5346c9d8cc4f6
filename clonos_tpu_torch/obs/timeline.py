"""The unified causal timeline (port of ``clonos_tpu/obs/timeline.py``):
every evidence plane, one HLC order.

The repo's incident evidence is scattered across trace JSONL, audit
ledgers, decision logs, chaos schedules and SLO windows — diagnosing a
kill mid-fence-tail means hand-joining them by wall clock, which stops
working across processes. This module gives every plane ONE sink:

- :class:`TimelineStore` appends typed records (``kind`` + fields),
  each stamped with the process HLC (obs/hlc.py) so records from
  different processes merge into a causally-consistent order. Same
  file discipline as the tracer: bounded in-memory ring + JSONL file,
  one append handle, flushed per record (SIGKILL loses at most the
  record being written).
- The emitting call sites are the planes themselves: epoch seals
  (``epoch.seal`` — runtime/cluster.py), recovery FSM transitions
  (``recovery.fsm`` — causal/recovery.py), gray-failure suspicion
  (``health.gray-suspect`` — obs/detect.py), landed incident bundles
  (``incident.captured`` — obs/incident.py), and every cross-process
  message send/receive (``msg.send`` / ``msg.recv`` —
  parallel/transport.py attach_hlc / adopt_hlc, which echo the sender's
  stamp into the receive record so causality is checkable per record).
  The reference's scale decisions, chaos injections and SLO breaches
  come with the port's autoscaler and soak harness; the store takes
  any kind.
- Reading is tail-tolerant via utils/jsonl; :func:`merge_records`
  sorts by HLC stamp (wall-clock fallback for un-stamped records) and
  :func:`causality_inversions` proves the merged order sound: a
  receive whose stamp does not order strictly after its send is an
  inversion, and so is a recv/send pair the merge laid out backwards.

``python -m clonos_tpu_torch timeline`` is the CLI: filter by
job/worker/epoch/kind, ``--diff`` two timelines, ``--report json`` (exit 0/1 on inversions),
``--chrome`` via obs/chrome.py.

Zero overhead off: the process-global store starts as
:class:`NullTimeline` (every ``record()`` a no-op); enabling is the
explicit :func:`configure_timeline` opt-in, the NullTracer convention.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from clonos_tpu_torch.obs.hlc import HybridLogicalClock, get_hlc, stamp_key

#: record fields owned by the store; everything else is caller payload
_RESERVED = ("kind", "ts", "hlc", "service", "pid")


class NullTimeline:
    """The disabled store: ``record()`` is a no-op, call sites pay
    nothing (the NullTracer convention)."""

    enabled = False
    service = None

    def record(self, kind: str, hlc=None, **fields) -> None:
        pass

    def record_stamped(self, kind: str, stamp_fn, **fields):
        return stamp_fn()

    def records(self) -> List[dict]:
        return []

    def close(self) -> None:
        pass


class TimelineStore:
    """Process timeline sink: bounded ring + optional JSONL file,
    every record stamped with the process HLC."""

    enabled = True

    def __init__(self, service: str, path: Optional[str] = None,
                 # clonos: allow(wallclock): record timestamps are
                 # observability metadata, never operator state.
                 clock=time.time, buffer: int = 8192):
        from clonos_tpu_torch.utils.jsonl import JsonlAppender
        self.service = service
        self._path = path
        self._clock = clock
        self._writer = (JsonlAppender(path, default=str)
                        if path is not None else None)
        self._lock = threading.Lock()
        self._ring: Deque[dict] = collections.deque(maxlen=buffer)
        # clonos: allow(entropy): pid tags records, never replayed data
        self._pid = os.getpid()

    def record(self, kind: str, hlc=None, **fields) -> None:
        """Append one typed record. ``hlc`` is normally None — the
        process clock is ticked here — but a caller may pass a stamp it
        already minted."""
        self.record_stamped(kind, (lambda: hlc) if hlc is not None
                            else get_hlc().tick, **fields)

    def record_stamped(self, kind: str, stamp_fn, **fields):
        """Mint a stamp with ``stamp_fn()`` and append the record carrying
        it, both under the store's lock, and return the stamp: threads
        that stamp and record at once (the driving thread, the fence
        worker, the heartbeat and handler threads) then append in stamp
        order, which the streaming merge (:func:`iter_merged`) relies
        on. attach/adopt mint the wire stamp this way, so record and
        header agree."""
        with self._lock:
            hlc = stamp_fn()
            rec = {"kind": str(kind), "ts": self._clock(),
                   "hlc": list(hlc) if hlc is not None else None,
                   "service": self.service, "pid": self._pid}
            for k, v in fields.items():
                if k not in _RESERVED:
                    rec[k] = v
            self._ring.append(rec)
            if self._writer is not None:
                self._writer.append(rec)
            return hlc

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()


# --- process-global store ----------------------------------------------------

_global_timeline = NullTimeline()
_global_lock = threading.Lock()


def get_timeline():
    """The process timeline (NullTimeline unless configured)."""
    return _global_timeline


def configure_timeline(service: str, path: Optional[str] = None,
                       **kw) -> TimelineStore:
    """Install a real timeline store (replacing and closing the old
    one). Also installs a process HLC if none is configured yet — a
    timeline without causal stamps cannot be merged across processes."""
    from clonos_tpu_torch.obs.hlc import configure_hlc
    global _global_timeline
    with _global_lock:
        old = _global_timeline
        if not get_hlc().enabled:
            configure_hlc(node=service)
        _global_timeline = TimelineStore(service, path=path, **kw)
        old.close()
        return _global_timeline


def reset_timeline() -> None:
    """Back to the disabled NullTimeline (tests; closes the file)."""
    global _global_timeline
    with _global_lock:
        _global_timeline.close()
        _global_timeline = NullTimeline()


# --- reading / merging -------------------------------------------------------

def read_timeline(paths) -> List[dict]:
    """Read timeline records from one path or many, torn-tail
    tolerantly (utils/jsonl: a SIGKILLed writer's torn final line is
    dropped; mid-file junk raises naming file:line)."""
    from clonos_tpu_torch.utils.jsonl import read_jsonl
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    records: List[dict] = []
    for path in paths:
        records.extend(read_jsonl(str(path), label=str(path)))
    return records


def record_key(rec: dict) -> Tuple[int, int, str]:
    """The merge key: the HLC stamp when present, a wall-clock-derived
    stand-in otherwise (c = -1 keeps unstamped records sorting before
    any stamped record sharing the same microsecond)."""
    hlc = rec.get("hlc")
    if hlc:
        return stamp_key(hlc)
    return (int(float(rec.get("ts", 0.0)) * 1e6), -1,
            str(rec.get("service") or ""))


def merge_records(records: Sequence[dict]) -> List[dict]:
    """One HLC-ordered timeline from any number of processes' records
    (a stable sort: same-stamp records keep their input order)."""
    return sorted(records, key=record_key)


def iter_merged(paths):
    """Stream the HLC-merged timeline of many per-process files with
    **O(open files)** memory: a k-way ``heapq.merge`` over per-file
    streaming cursors (utils/jsonl.iter_jsonl, torn tails dropped).
    Sound because each per-process file is appended in stamp order —
    the process HLC only ticks forward, and the unstamped fallback key
    (record ``ts``) is the same monotone append clock — so every
    cursor is already sorted by :func:`record_key`. Merging a long
    soak's files stays flat in memory instead of O(total events)."""
    import heapq
    from clonos_tpu_torch.utils.jsonl import iter_jsonl
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    cursors = [iter_jsonl(str(p), label=str(p)) for p in paths]
    return heapq.merge(*cursors, key=record_key)


def causality_inversions_stream(merged) -> List[dict]:
    """:func:`causality_inversions` over an already-merged streaming
    iterator (:func:`iter_merged`), single pass: memory is the live
    send-stamp set plus receives still awaiting their send — stamp
    keys, not records. A recv seen before its send in merged order is
    a merge inversion; a recv whose send never appears at all (file
    not collected) is not."""
    findings: List[dict] = []
    open_sends: set = set()
    pending: Dict[Tuple[int, int, str], dict] = {}
    for rec in merged:
        kind = rec.get("kind")
        if kind == "msg.send" and rec.get("hlc"):
            k = stamp_key(rec["hlc"])
            open_sends.add(k)
            recv = pending.pop(k, None)
            if recv is not None:
                findings.append(
                    {"rule": "merge", "recv": recv.get("hlc"),
                     "sent": recv.get("sent"),
                     "verb": recv.get("verb"),
                     "detail": "merged order lays the receive out "
                               "before its send"})
            continue
        if kind != "msg.recv":
            continue
        sent, own = rec.get("sent"), rec.get("hlc")
        if not sent or not own:
            continue
        sent_k, own_k = stamp_key(sent), stamp_key(own)
        if own_k <= sent_k:
            findings.append({"rule": "stamp", "recv": own,
                             "sent": sent, "verb": rec.get("verb"),
                             "detail": "receive stamp does not order "
                                       "after its send stamp"})
        if sent_k not in open_sends:
            pending[sent_k] = {"hlc": own, "sent": sent,
                               "verb": rec.get("verb")}
    return findings


def from_trace_records(trace_records: Sequence[dict]) -> List[dict]:
    """Normalize tracer JSONL records (obs/trace.py shape) into
    timeline shape so trace spans/instants merge into the same order.
    Trace records carry no HLC stamp — they order by wall clock, which
    is exact within one process and approximate across."""
    out = []
    for r in trace_records:
        rec = {"kind": f"trace.{r.get('name', '?')}",
               "ts": float(r.get("ts", 0.0)), "hlc": None,
               "service": r.get("service"), "pid": r.get("pid")}
        if r.get("ph") == "X":
            rec["dur"] = r.get("dur")
        args = r.get("args")
        if isinstance(args, dict):
            for k, v in args.items():
                rec.setdefault(k, v)
        out.append(rec)
    return out


def to_trace_records(records: Sequence[dict]) -> List[dict]:
    """Timeline records in tracer-record shape, for the Chrome export
    path (obs/chrome.to_chrome): every record an instant, HLC stamp
    preserved under args."""
    out = []
    for r in records:
        args = {k: v for k, v in r.items() if k not in _RESERVED}
        if r.get("hlc"):
            args["hlc"] = r["hlc"]
        out.append({"ts": float(r.get("ts", 0.0)),
                    "name": str(r.get("kind", "?")), "ph": "i",
                    "trace": "timeline",
                    "service": r.get("service"),
                    "pid": int(r.get("pid") or 0), "tid": 0,
                    "span": None, "parent": None, "args": args})
    return out


def causality_inversions(records: Sequence[dict]) -> List[dict]:
    """Prove the merged order causally sound. Two checks:

    - **stamp rule**: every ``msg.recv`` record echoes the sender's
      stamp (``sent``); its own stamp must order strictly after it —
      the HLC receive rule guarantees this, so a violation means a
      record was forged, torn or mis-merged;
    - **merge rule**: for every send/recv pair (matched by the sent
      stamp, which is unique per send — the HLC ticks), the merged
      order must lay the send out first.

    Returns one finding dict per violation (empty == sound).
    """
    merged = merge_records(records)
    findings: List[dict] = []
    send_pos: Dict[Tuple[int, int, str], int] = {}
    for i, rec in enumerate(merged):
        if rec.get("kind") == "msg.send" and rec.get("hlc"):
            send_pos.setdefault(stamp_key(rec["hlc"]), i)
    for i, rec in enumerate(merged):
        if rec.get("kind") != "msg.recv":
            continue
        sent, own = rec.get("sent"), rec.get("hlc")
        if not sent or not own:
            continue
        sent_k, own_k = stamp_key(sent), stamp_key(own)
        if own_k <= sent_k:
            findings.append({"rule": "stamp", "recv": own, "sent": sent,
                             "verb": rec.get("verb"),
                             "detail": "receive stamp does not order "
                                       "after its send stamp"})
        pos = send_pos.get(sent_k)
        if pos is not None and pos >= i:
            findings.append({"rule": "merge", "recv": own, "sent": sent,
                             "verb": rec.get("verb"),
                             "detail": "merged order lays the receive "
                                       "out before its send"})
    return findings


def diff_timelines(a: Sequence[dict], b: Sequence[dict],
                   ignore: Sequence[str] = ("ts", "hlc", "pid",
                                            "service", "sent")
                   ) -> List[dict]:
    """Structural diff of two timelines: records are compared as
    (kind + payload fields) multisets, ignoring the per-process /
    per-run volatile fields. Returns findings ``{"only": "a"|"b",
    "record": ..., "count": n}`` — empty means the runs emitted the
    same events."""
    def keyed(recs):
        counts: Dict[str, int] = {}
        for r in recs:
            k = json.dumps(
                {k: v for k, v in sorted(r.items()) if k not in ignore},
                sort_keys=True, default=str)
            counts[k] = counts.get(k, 0) + 1
        return counts

    ca, cb = keyed(a), keyed(b)
    out = []
    for k in sorted(set(ca) | set(cb)):
        d = ca.get(k, 0) - cb.get(k, 0)
        if d > 0:
            out.append({"only": "a", "record": json.loads(k), "count": d})
        elif d < 0:
            out.append({"only": "b", "record": json.loads(k),
                        "count": -d})
    return out


# --- self-check --------------------------------------------------------------

def timeline_self_check() -> List[dict]:
    """Deterministic in-memory causality self-check (the conftest /
    ``python -m clonos_tpu_torch timeline --self-check`` gate): two simulated processes
    with SKEWED logical wall clocks exchange messages both ways; the
    merged stream must show zero inversions even though process B's
    clock runs behind A's by more than the message interval. Pure —
    fake counters for clocks, no wall time, no files."""
    clocks = {"a": [1_000_000.0], "b": [0.5]}    # b skewed far behind

    def mk(node):
        def clock():
            clocks[node][0] += 0.001
            return clocks[node][0]
        return HybridLogicalClock(node=node, clock=clock)

    ha, hb = mk("a"), mk("b")
    records: List[dict] = []

    def send(src, h_src, dst, h_dst, verb, ts):
        stamp = h_src.tick()
        records.append({"kind": "msg.send", "ts": ts, "verb": verb,
                        "hlc": list(stamp), "service": src})
        recv = h_dst.observe(stamp)
        records.append({"kind": "msg.recv", "ts": ts, "verb": verb,
                        "hlc": list(recv), "sent": list(stamp),
                        "service": dst})

    for i in range(16):
        send("a", ha, "b", hb, "DEPLOY", float(i))
        send("b", hb, "a", ha, "HEARTBEAT", float(i))
    return causality_inversions(records)
