"""Chrome ``trace_event`` conversion for flight-recorder JSON lines
(port of ``clonos_tpu/obs/chrome.py``).

The tracer's native record (``obs/trace.py``) keeps wall-clock seconds
and trace/span/parent ids. Chrome's Trace Event Format (the JSON
Perfetto and ``about:tracing`` load) wants microseconds, a ``ph`` phase
letter and pid/tid lanes. :func:`to_chrome` maps

- ``ph: "X"`` records to complete events (``ts`` + ``dur`` in µs),
- ``ph: "i"`` records to instant events (process scope),
- each distinct (pid, service) to a ``process_name`` metadata event, so
  the viewer labels lanes by service,

and keeps the trace/span ids under ``args``. :func:`validate_chrome` is
the validity check run over emitted documents.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from clonos_tpu_torch.utils.jsonl import parse_jsonl_lines

_KNOWN_PH = {"X", "i", "B", "E", "M", "C"}


def load_jsonl(paths) -> List[dict]:
    """Read tracer records from one path or a list of paths, sorted by
    timestamp. A torn final line (a killed process) is dropped; a decode
    failure on any earlier line raises."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    records: List[dict] = []
    for path in paths:
        with open(path) as f:
            lines = f.read().splitlines()
        records.extend(parse_jsonl_lines(lines, label=str(path)))
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def to_chrome(records: Iterable[dict],
              trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Convert tracer records to a Chrome trace document, optionally
    keeping only one trace id."""
    events: List[dict] = []
    named_procs = set()
    for rec in records:
        if trace_id is not None and rec.get("trace") != trace_id:
            continue
        pid = int(rec.get("pid", 0))
        tid = int(rec.get("tid", 0))
        service = rec.get("service") or f"pid {pid}"
        if (pid, service) not in named_procs:
            named_procs.add((pid, service))
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": str(service)}})
        ev = {"name": str(rec.get("name", "?")),
              "cat": str(rec.get("service", "clonos")),
              "pid": pid, "tid": tid,
              "ts": float(rec.get("ts", 0.0)) * 1e6,
              "args": dict(rec.get("args") or {},
                           trace=rec.get("trace"), span=rec.get("span"),
                           parent=rec.get("parent"))}
        if rec.get("ph") == "X":
            ev["ph"] = "X"
            ev["dur"] = max(0.0, float(rec.get("dur", 0.0))) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "p"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome(doc: Dict[str, Any]) -> int:
    """Check ``doc`` is a well-formed Chrome trace (JSON-serializable,
    a ``traceEvents`` list, each event carrying the fields its phase
    requires). Returns the event count; raises ValueError otherwise."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: missing traceEvents list")
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            raise ValueError(f"traceEvents[{i}]: unknown ph {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}]: missing name")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"traceEvents[{i}]: missing numeric ts")
            if not isinstance(ev.get("pid"), int) or not isinstance(
                    ev.get("tid"), int):
                raise ValueError(f"traceEvents[{i}]: missing pid/tid")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            raise ValueError(
                f"traceEvents[{i}]: complete event needs dur >= 0")
    json.dumps(doc)
    return len(doc["traceEvents"])


def summarize(records: List[dict]) -> Dict[str, Any]:
    """Digest of a record list: traces present, per-name span counts and
    total durations, and the ordered event timeline of the dominant
    trace."""
    traces: Dict[str, int] = {}
    by_name: Dict[str, Dict[str, float]] = {}
    for rec in records:
        tr = str(rec.get("trace"))
        traces[tr] = traces.get(tr, 0) + 1
        st = by_name.setdefault(str(rec.get("name")),
                                {"count": 0, "total_s": 0.0})
        st["count"] += 1
        if rec.get("ph") == "X":
            st["total_s"] += float(rec.get("dur", 0.0))
    main = max(traces, key=traces.get) if traces else None
    timeline = [
        {"ts": rec.get("ts"), "ph": rec.get("ph"),
         "service": rec.get("service"), "name": rec.get("name"),
         "dur": rec.get("dur")}
        for rec in records if str(rec.get("trace")) == main]
    return {"records": len(records), "traces": traces,
            "main_trace": main, "names": by_name, "timeline": timeline}
