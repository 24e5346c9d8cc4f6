"""Control-plane transport: length-prefixed typed messages over TCP.

Port of ``clonos_tpu/parallel/transport.py``, the same bytes on the wire.
It carries the cross-host analogs of the reference's typed gateways and
recovery events: registration, heartbeats, checkpoint RPCs, and
determinant-delta fetches between a running host and a remote standby
host (``runtime/remote.py`` drives it; the delta bytes use
``causal/serde.py``). Everything here is host code: no handler touches
the card.

Wire: frame = u32 length | u16 msg_type | payload. Payloads are either
raw bytes (delta frames) or UTF-8 JSON for small control records —
explicit, versionable, no pickle on the wire.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from clonos_tpu_torch import obs

_FRAME = struct.Struct("<IH")

# message types (reference gateway methods / task events)
REGISTER = 1               # TaskExecutor -> JobMaster
HEARTBEAT = 2              # TaskExecutor -> JobMaster
TRIGGER_CHECKPOINT = 3     # JobMaster -> TaskExecutor
ACK_CHECKPOINT = 4
NOTIFY_COMPLETE = 5
IGNORE_CHECKPOINT = 6      # rpcIgnoreUnacknowledgedPendingCheckpointsFor
DETERMINANT_REQUEST = 7    # standby host -> running host
DETERMINANT_RESPONSE = 8   # payload = serde delta frame
INFLIGHT_REQUEST = 9
INFLIGHT_RESPONSE = 10
SHUTDOWN = 11
OK = 12
ERROR = 13
QUERY_STATE = 14           # external client -> queryable-state endpoint
QUERY_RESPONSE = 15
# scheduler / slot-pool surface
SLOT_OFFER = 16            # TaskExecutor -> JobMaster: add slot capacity
DEPLOY = 17                # JobMaster -> TaskExecutor: fenced task slice
TASK_STATE = 18            # TaskExecutor -> JobMaster: task transition
FETCH_EDGE = 19            # downstream worker -> upstream edge export
EDGE_DATA = 20             # payload = JSON header | int32 record rows
# dispatcher surface
SUBMIT_JOB = 21            # client -> Dispatcher: JobGraph + tenant config
JOB_STATUS = 22            # client -> Dispatcher: one job / list all jobs
CANCEL_JOB = 23            # client -> Dispatcher: cancel / abandon a job
# read-path serving surface
QUERY_BATCH = 24           # client -> serve endpoint: many keys, one gather
QUERY_BATCH_RESPONSE = 25
SERVE_STATUS = 26          # client -> serve endpoint: epoch/staleness probe


def _send(sock: socket.socket, mtype: int, payload: bytes) -> None:
    sock.sendall(_FRAME.pack(len(payload), mtype) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv(sock: socket.socket) -> Tuple[int, bytes]:
    hdr = _recv_exact(sock, _FRAME.size)
    length, mtype = _FRAME.unpack(hdr)
    return mtype, _recv_exact(sock, length)


def pack_json(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


def unpack_json(b: bytes) -> Any:
    return json.loads(b.decode("utf-8"))


# --- trace-context convention ------------------------------------------------
# Control messages whose payload is a JSON header MAY carry a ``trace``
# field: the sender's Tracer.wire_context() dict. Receivers adopt it so
# both sides' spans land under one trace id. A disabled tracer attaches
# nothing, so the wire bytes equal an untraced build's.

def attach_trace(header: Dict[str, Any]) -> Dict[str, Any]:
    """Add the process tracer's context to a JSON header (in place)."""
    ctx = obs.get_tracer().wire_context()
    if ctx is not None:
        header["trace"] = ctx
    return header


def adopt_trace(header: Dict[str, Any]) -> None:
    """Join the trace a received JSON header carries (no-op when the
    local tracer is disabled or the header has no ``trace``)."""
    tr = obs.get_tracer()
    if tr.enabled:
        tr.adopt(header.get("trace"))


# --- audit-context convention ------------------------------------------------
# The same shape for the exactly-once audit plane: an auditing JobMaster
# stamps its stance on DEPLOY headers. A disabled auditor attaches
# nothing.

def attach_audit(header: Dict[str, Any]) -> Dict[str, Any]:
    """Add the process auditor's stance to a JSON header (in place)."""
    a = obs.get_auditor()
    if a.enabled:
        header["audit"] = {"on_divergence": a.on_divergence}
    return header


def adopt_audit(header: Dict[str, Any]) -> None:
    """Enable process-wide auditing per a received header's ``audit``
    field (no-op without one; runners built after adoption inherit)."""
    ctx = header.get("audit")
    if ctx and not obs.get_auditor().enabled:
        obs.configure_audit(on_divergence=ctx.get("on_divergence", "warn"))


# --- profile-context convention ----------------------------------------------
# The same shape for overhead attribution: a profiling JobMaster stamps
# DEPLOY headers so every deployed runner attributes its overhead. A
# disabled profiler attaches nothing.

def attach_profile(header: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp the process profiler's stance on a JSON header (in
    place)."""
    if obs.get_profiler().enabled:
        header["profile"] = True
    return header


def adopt_profile(header: Dict[str, Any]) -> None:
    """Enable process-wide overhead profiling per a received header's
    ``profile`` field (runners built after adoption inherit)."""
    if header.get("profile") and not obs.get_profiler().enabled:
        obs.configure_profile()


# --- hlc-context convention --------------------------------------------------
# The same shape for the causal timeline (obs/hlc.py, obs/timeline.py):
# a cross-process control message (DEPLOY, HEARTBEAT, FETCH_EDGE,
# DETERMINANT_REQUEST, the query and serve verbs) may carry an ``hlc``
# field, the sender's hybrid-logical-clock stamp. The receiver folds it
# into its own clock, so the two processes' timeline records merge into
# one causal order whatever their wall clocks say. A disabled clock
# attaches nothing.

def attach_hlc(header: Dict[str, Any],
               verb: Optional[str] = None) -> Dict[str, Any]:
    """Tick the process HLC and stamp a JSON header (in place); records a
    ``msg.send`` timeline entry carrying the same stamp (minted under the
    timeline's lock, so each process's file stays in stamp order)."""
    h = obs.get_hlc()
    if h.enabled:
        stamp = obs.get_timeline().record_stamped("msg.send", h.tick,
                                                  verb=verb)
        header["hlc"] = {"ts": [stamp[0], stamp[1]], "node": stamp[2]}
    return header


def adopt_hlc(header: Dict[str, Any],
              verb: Optional[str] = None) -> None:
    """Fold a received header's ``hlc`` stamp into the process clock
    (no-op when either side has no clock); records a ``msg.recv``
    timeline entry echoing the sender's stamp, so causality is checkable
    per record."""
    h = obs.get_hlc()
    ctx = header.get("hlc")
    if h.enabled and isinstance(ctx, dict) and "ts" in ctx:
        sent = (int(ctx["ts"][0]), int(ctx["ts"][1]),
                str(ctx.get("node", "?")))
        obs.get_timeline().record_stamped(
            "msg.recv", lambda: h.observe(sent), verb=verb,
            sent=list(sent))


# --- lineage-context convention ----------------------------------------------
# The same shape for the record-lineage plane (obs/lineage.py): a
# JobMaster with lineage on stamps its dye config (root, k, salt) on
# DEPLOY headers, so every worker dyes the same records (the dye is a
# pure key-hash function). A disabled plane attaches nothing.

def attach_lineage(header: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp the process lineage plane's dye config on a JSON header (in
    place)."""
    ctx = obs.get_lineage().wire_config()
    if ctx is not None:
        header["lineage"] = ctx
    return header


def adopt_lineage(header: Dict[str, Any]) -> None:
    """Enable process-wide lineage per a received header's ``lineage``
    field (no-op without one, or when this process already has a plane;
    runners built after adoption inherit it)."""
    ctx = header.get("lineage")
    if ctx and not obs.get_lineage().enabled:
        obs.configure_lineage(str(ctx["root"]), k=int(ctx.get("k", 4)),
                              salt=int(ctx.get("salt", 0)))


class ControlServer:
    """Threaded request/response endpoint. ``handler(mtype, payload) ->
    (mtype, payload)`` runs per request on a server thread; one TCP
    connection may carry many requests."""

    def __init__(self, handler: Callable[[int, bytes], Tuple[int, bytes]],
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        mtype, payload = _recv(self.request)
                        if mtype == SHUTDOWN:
                            _send(self.request, OK, b"")
                            return
                        try:
                            rt, rp = outer._handler(mtype, payload)
                        except Exception as e:       # surface, don't die
                            rt, rp = ERROR, pack_json({"error": str(e)})
                        prof = obs.get_profiler()
                        if prof.enabled:
                            # Only the response write: the loop's recv
                            # waits for the next request, which is idle
                            # time, not overhead.
                            with prof.section("transport-send"):
                                _send(self.request, rt, rp)
                        else:
                            _send(self.request, rt, rp)
                except (ConnectionError, OSError):
                    return

        self._handler = handler
        self._srv = socketserver.ThreadingTCPServer((host, port), _H)
        self._srv.daemon_threads = True
        self.address: Tuple[str, int] = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class ControlClient:
    """Blocking request/response client for a ControlServer.

    A failed call may leave the stream with a half-read response, so the
    socket is dropped on any transport error and re-established on the
    next call — callers retry calls, never manage connections."""

    def __init__(self, address: Tuple[str, int], timeout_s: float = 10.0):
        self._address = tuple(address)
        self._timeout = timeout_s
        self._closed = False
        self._sock: Optional[socket.socket] = socket.create_connection(
            self._address, timeout=timeout_s)

    def call(self, mtype: int, payload: bytes = b"") -> Tuple[int, bytes]:
        if self._closed:
            raise RuntimeError("ControlClient is closed")
        prof = obs.get_profiler()
        try:
            if self._sock is None:
                self._sock = socket.create_connection(
                    self._address, timeout=self._timeout)
            if not prof.enabled:
                _send(self._sock, mtype, payload)
                return _recv(self._sock)
            # The request write and the blocking wait for the response.
            with prof.section("transport-send"):
                _send(self._sock, mtype, payload)
            with prof.section("transport-recv"):
                return _recv(self._sock)
        except OSError:
            self._drop()
            raise

    def call_json(self, mtype: int, obj: Any) -> Any:
        rt, rp = self.call(mtype, pack_json(obj))
        if rt == ERROR:
            raise RuntimeError(unpack_json(rp)["error"])
        return unpack_json(rp) if rp else None

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._closed = True
        self._drop()
