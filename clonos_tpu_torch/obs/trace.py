"""Tracing and the recovery flight recorder (port of
``clonos_tpu/obs/trace.py``).

Where does the time go during an epoch and during a recovery? The
runtime answers with spans:

- :class:`Tracer` mints trace/span ids, records **complete spans**
  (``ph: "X"``: wall ``ts`` + ``dur``) and **instant events**
  (``ph: "i"``), each tagged with the trace id, the emitting service and
  the pid. Records go to (a) a bounded in-memory ring, the flight
  recorder, dumpable after the fact and served on ``MetricsEndpoint``'s
  ``/trace``, and (b) optionally a JSON-lines file (one handle, append
  mode, flushed per record so a killed process's trace survives it).
- The parent-span stack is per thread, so spans opened on the fence
  worker or the recovery's finalize thread never nest under the main
  thread's.
- :meth:`Tracer.wire_context` / :meth:`Tracer.adopt` carry a trace id
  from one tracer to another (``{"trace_id", "span"}``): a receiver that
  adopts the sender's context records under the same trace id.
- **Nothing by default**: the process-global tracer starts as
  :class:`NullTracer` (``enabled`` False, every method a no-op), so an
  unconfigured run adds no host work. Enabling is an explicit opt-in
  (:func:`configure`, or the ``observability.tracing.*`` options through
  ``ClusterRunner.from_config``).

``obs/chrome.py`` converts a recorded file to Chrome trace JSON
(Perfetto, ``about:tracing``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional


def _new_id() -> str:
    # clonos: allow(entropy) — trace/span ids are correlation metadata;
    # they never feed operator state and are not expected to replay.
    return uuid.uuid4().hex[:16]


class _NullSpan:
    """No-op context manager handed out by the disabled tracer."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op and
    ``wire_context()`` is None, so instrumented call sites add no
    per-record work."""

    enabled = False
    trace_id = None
    service = None
    dropped = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **args) -> None:
        pass

    def complete(self, name: str, dur_s: float, **args) -> None:
        pass

    def wire_context(self) -> None:
        return None

    def adopt(self, ctx) -> None:
        pass

    def records(self) -> List[dict]:
        return []

    def close(self) -> None:
        pass


class _Span:
    """A live span: a context manager that emits one complete record on
    exit. Exceptions propagate; the span still closes (its ``error`` arg
    records the fact)."""

    __slots__ = ("_tracer", "name", "span_id", "parent", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional[str], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.span_id = _new_id()
        self.parent = parent
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        self._tracer._push(self.span_id)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._pop()
        if exc_type is not None:
            self.args = dict(self.args, error=repr(exc))
        self._tracer._emit(
            self.name, "X", self._t0,
            dur=self._tracer._clock() - self._t0,
            span=self.span_id, parent=self.parent, args=self.args)
        return False


class Tracer:
    """Process tracer: one trace id (minted or adopted), a bounded
    flight-recorder ring, and an optional JSON-lines file sink.

    Thread-safe: spans and events may come from worker threads (the fence
    tail, the recovery's finalize barrier, checkpoint writers) as well as
    the main loop; the parent-span stack is thread-local."""

    enabled = True

    def __init__(self, service: str, path: Optional[str] = None,
                 # clonos: allow(wallclock): span timestamps, obs-only
                 trace_id: Optional[str] = None, clock=time.time,
                 buffer: int = 8192):
        self.service = service
        self.trace_id = trace_id or _new_id()
        self._path = path
        self._clock = clock
        self._file = None
        self._lock = threading.Lock()
        self._local = threading.local()
        #: the flight recorder: most recent records, bounded
        self._ring: Deque[dict] = collections.deque(maxlen=buffer)
        #: records evicted from the ring at overflow: nonzero means the
        #: in-memory timeline is truncated (the file, if any, still has
        #: everything). Served as ``trace.dropped-records``.
        self.dropped = 0
        # clonos: allow(entropy): trace metadata, never replayed data
        self._pid = os.getpid()

    # --- span stack (thread-local parents) -----------------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span_id: str) -> None:
        self._stack().append(span_id)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def current_span(self) -> Optional[str]:
        st = self._stack()
        return st[-1] if st else None

    # --- recording -----------------------------------------------------------

    def _emit(self, name: str, ph: str, ts: float, dur: float = 0.0,
              span: Optional[str] = None, parent: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None) -> None:
        rec = {"ts": ts, "name": name, "ph": ph,
               "trace": self.trace_id, "service": self.service,
               "pid": self._pid, "tid": threading.get_ident() & 0xFFFF,
               "span": span or _new_id(),
               "parent": parent if parent is not None
               else self.current_span()}
        if ph == "X":
            rec["dur"] = dur
        if args:
            rec["args"] = args
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1      # eviction, not silence
            self._ring.append(rec)
            if self._path is not None:
                # One append-mode handle for the tracer's lifetime,
                # flushed per record: a kill loses at most the record
                # being written.
                if self._file is None:
                    self._file = open(self._path, "a")
                self._file.write(json.dumps(rec, default=str) + "\n")
                self._file.flush()

    def span(self, name: str, **args) -> _Span:
        """Context manager: records a complete span over the ``with``
        body, parented to the enclosing span of this thread."""
        return _Span(self, name, self.current_span(), args)

    def event(self, name: str, **args) -> None:
        """Instant event at now."""
        self._emit(name, "i", self._clock(), args=args)

    def complete(self, name: str, dur_s: float, **args) -> None:
        """Record an already-measured span ending now (the caller timed
        it; ``ts`` is back-dated so the timeline lays out correctly)."""
        self._emit(name, "X", self._clock() - dur_s, dur=dur_s, args=args)

    # --- context propagation -------------------------------------------------

    def wire_context(self) -> Dict[str, Any]:
        """The trace context a receiver adopts: ``{trace_id, span}``."""
        return {"trace_id": self.trace_id, "span": self.current_span()}

    def adopt(self, ctx: Optional[Dict[str, Any]]) -> None:
        """Join the sender's trace: later spans and events land under the
        sender's trace id (idempotent; None is ignored)."""
        if ctx and ctx.get("trace_id"):
            self.trace_id = str(ctx["trace_id"])

    # --- flight recorder -----------------------------------------------------

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# --- process-global tracer ---------------------------------------------------

_global_tracer: Any = NullTracer()
_global_lock = threading.Lock()


def get_tracer():
    """The process tracer (NullTracer unless :func:`configure` ran)."""
    return _global_tracer


def configure(service: str, path: Optional[str] = None,
              trace_id: Optional[str] = None, **kw) -> Tracer:
    """Install a real process tracer (replacing the previous one, which
    is closed): the opt-in gate for all span instrumentation."""
    global _global_tracer
    with _global_lock:
        old = _global_tracer
        _global_tracer = Tracer(service, path=path, trace_id=trace_id,
                                **kw)
        old.close()
        return _global_tracer


def reset() -> None:
    """Back to the disabled NullTracer (also closes the file)."""
    global _global_tracer
    with _global_lock:
        _global_tracer.close()
        _global_tracer = NullTracer()
