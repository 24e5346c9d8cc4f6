"""Queryable state: external point and batch lookups of live keyed state
(port of ``clonos_tpu/runtime/query.py``).

Keyed state is a dense per-key table ``[P, K]`` on the card. The
endpoint serves a fence snapshot that the driving thread refreshes at
epoch boundaries (:meth:`QueryableStateEndpoint.refresh`, through
``LocalExecutor.vertex_state``, as ``HostLogEndpoint.refresh`` does); the
transport's handler threads serve numpy only and never touch the card.
A lookup resolves the key's owning subtask with the key-group assignment
the exchange uses, so the served value is the owning task's table entry.

Freshness: every snapshot is stamped with the runner's last sealed
epoch, not the live epoch counter; reads are rejected until the first
seal, and every response carries ``(epoch, staleness_epochs)``.

The client owns liveness: a per-request socket timeout with bounded
exponential backoff, then a typed :class:`QueryTimeoutError`.
"""

from __future__ import annotations

import socket
import threading
import time as _time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.parallel.routing import (hash32_np,
                                               subtask_for_key_group)


class QueryTimeoutError(TimeoutError):
    """A query's budget (timeout x bounded retries) ran out without a
    response: the endpoint is hung, unreachable or overloaded."""

    def __init__(self, address, attempts: int, budget_s: float):
        self.address = tuple(address)
        self.attempts = attempts
        self.budget_s = budget_s
        super().__init__(
            f"query to {self.address} timed out after {attempts} "
            f"attempt(s) within {budget_s:.3f}s")


class QueryRejectedError(RuntimeError):
    """The endpoint refused the read (most often: no epoch has sealed
    yet, so there is no fence-consistent snapshot to serve)."""


def owner_subtask_np(keys: np.ndarray, parallelism: int,
                     num_key_groups: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(key_group, owning_subtask)`` of every key: the host twin of
    the exchange's key-to-owner map, shared by every read path (owner
    endpoint, replicas, router)."""
    kg = (hash32_np(np.asarray(keys, np.int64))
          % num_key_groups).astype(np.int64)
    sub = np.asarray(subtask_for_key_group(kg, parallelism,
                                           num_key_groups), np.int64)
    return kg, sub


def _call_with_retry(client: tp.ControlClient, mtype: int,
                     payload: bytes, address, timeout_s: float,
                     retries: int, backoff_s: float):
    """One logical request with bounded exponential backoff: transport
    errors retry after ``backoff_s * 2**i`` (capped at 1 s), then raise
    :class:`QueryTimeoutError`. ERROR frames pass straight through."""
    t0 = _time.monotonic()
    attempts = 0
    while True:
        attempts += 1
        try:
            return client.call(mtype, payload)
        except (socket.timeout, TimeoutError, OSError):
            # The client dropped its socket; the next call reconnects.
            if attempts > retries:
                raise QueryTimeoutError(
                    address, attempts, _time.monotonic() - t0) from None
            _time.sleep(min(backoff_s * (2 ** (attempts - 1)), 1.0))


def _verb(mtype: int) -> str:
    return "QUERY_STATE" if mtype == tp.QUERY_STATE else "QUERY_BATCH"


def _client_call(client: tp.ControlClient, mtype: int, payload: dict,
                 address, timeout_s: float, retries: int,
                 backoff_s: float) -> dict:
    """Request/response with the typed error mapping shared by both
    clients: a rejection raises :class:`QueryRejectedError`, any other
    ERROR frame ``KeyError``. Reads carry the process HLC stamp."""
    if mtype in (tp.QUERY_STATE, tp.QUERY_BATCH):
        tp.attach_hlc(payload, verb=_verb(mtype))
    rt, resp = _call_with_retry(client, mtype, tp.pack_json(payload),
                                address, timeout_s, retries, backoff_s)
    out = tp.unpack_json(resp)
    if rt == tp.ERROR:
        if out.get("rejected"):
            raise QueryRejectedError(out["error"])
        raise KeyError(out["error"])
    return out


class QueryableStateEndpoint:
    """Serves (vertex, state name, key) lookups over the control
    transport, point-wise or batched."""

    def __init__(self, runner, host: str = "127.0.0.1", port: int = 0):
        self.runner = runner
        self._lock = threading.Lock()
        self._snap: Dict[Tuple[int, str], np.ndarray] = {}
        self._epoch = -1
        self.reads = 0
        self.refresh()
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address

    def refresh(self, epoch: Optional[int] = None) -> None:
        """Fence snapshot of every vertex's array states, on the driving
        thread, stamped with the runner's last sealed epoch (-1 before
        the first seal: reads are rejected). ``epoch`` overrides the
        stamp for fence hooks: on the pipelined fence the seal is still
        in flight on the fence worker when the hook runs, so the hook
        passes the fence it captured."""
        sealed = (int(epoch) if epoch is not None
                  else int(getattr(self.runner, "last_sealed_epoch", -1)))
        snap: Dict[Tuple[int, str], np.ndarray] = {}
        if sealed >= 0:
            for v in self.runner.job.vertices:
                st = self.runner.executor.vertex_state(v.vertex_id)
                if not isinstance(st, dict):
                    continue
                for name, arr in st.items():
                    snap[(v.vertex_id, name)] = np.asarray(arr)
        with self._lock:
            self._snap = snap
            self._epoch = sealed

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def _resolve(self, req: dict):
        """(array, epoch, parallelism), or an (ERROR, payload) reply."""
        vid = req["vertex"]
        name = req.get("state", "acc")
        with self._lock:
            arr = self._snap.get((vid, name))
            epoch = self._epoch
        if epoch < 0:
            return tp.ERROR, tp.pack_json(
                {"error": "no epoch sealed yet: refresh() ran before "
                          "the first fence tail completed — reads have "
                          "no consistency point", "rejected": True})
        if arr is None:
            return tp.ERROR, tp.pack_json(
                {"error": f"no state ({vid}, {name})"})
        p = self.runner.job.vertices[vid].parallelism
        if arr.ndim < 2 or arr.shape[0] != p:
            return tp.ERROR, tp.pack_json(
                {"error": f"state ({vid}, {name}) of shape "
                          f"{list(arr.shape)} is not keyed"})
        return arr, epoch, p

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype not in (tp.QUERY_STATE, tp.QUERY_BATCH,
                         tp.SERVE_STATUS):
            return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})
        if mtype == tp.SERVE_STATUS:
            with self._lock:
                epoch = self._epoch
            return tp.QUERY_RESPONSE, tp.pack_json(
                {"epoch": epoch, "staleness_epochs": 0,
                 "role": "owner", "reads": self.reads})
        req = tp.unpack_json(payload)
        tp.adopt_hlc(req, verb=_verb(mtype))
        got = self._resolve(req)
        if len(got) == 2:
            return got
        arr, epoch, p = got
        num_key_groups = self.runner.job.num_key_groups
        if mtype == tp.QUERY_STATE:
            key = req["key"]
            if not 0 <= key < arr.shape[-1]:
                return tp.ERROR, tp.pack_json(
                    {"error": f"key {key} out of range "
                              f"[0, {arr.shape[-1]})"})
            kg, sub = owner_subtask_np(np.asarray(key), p, num_key_groups)
            self.reads += 1
            val = arr[int(sub), ..., key]
            return tp.QUERY_RESPONSE, tp.pack_json(
                {"value": np.asarray(val).tolist(),
                 "subtask": int(sub), "key_group": int(kg),
                 "epoch": epoch, "staleness_epochs": 0})
        keys = np.asarray(req["keys"], np.int64)
        if keys.size and (keys.min() < 0 or keys.max() >= arr.shape[-1]):
            return tp.ERROR, tp.pack_json(
                {"error": f"key out of range [0, {arr.shape[-1]})"})
        kg, sub = owner_subtask_np(keys, p, num_key_groups)
        self.reads += int(keys.size)
        vals = arr[sub, ..., keys]
        return tp.QUERY_BATCH_RESPONSE, tp.pack_json(
            {"values": np.asarray(vals).tolist(),
             "subtasks": sub.tolist(), "key_groups": kg.tolist(),
             "epoch": epoch, "staleness_epochs": 0})

    def close(self) -> None:
        self.server.close()


class QueryableStateClient:
    """External lookup client with a per-request timeout and bounded
    exponential backoff: a hung endpoint costs a bounded wait and a
    :class:`QueryTimeoutError`. One connection, not thread-safe."""

    def __init__(self, address: Tuple[str, int],
                 timeout_s: float = 5.0, retries: int = 2,
                 backoff_s: float = 0.05):
        self.address = tuple(address)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self._client = tp.ControlClient(self.address,
                                        timeout_s=self.timeout_s)

    def _call(self, mtype: int, payload: dict) -> dict:
        return _client_call(self._client, mtype, payload, self.address,
                            self.timeout_s, self.retries, self.backoff_s)

    def query(self, vertex: int, key: int, state: str = "acc") -> dict:
        return self._call(tp.QUERY_STATE,
                          {"vertex": vertex, "state": state, "key": key})

    def query_batch(self, vertex: int, keys: Sequence[int],
                    state: str = "acc") -> dict:
        """Many keys in one request and one response."""
        return self._call(tp.QUERY_BATCH,
                          {"vertex": vertex, "state": state,
                           "keys": [int(k) for k in keys]})

    def status(self) -> dict:
        """Freshness probe: ``{"epoch", "staleness_epochs", ...}``."""
        return self._call(tp.SERVE_STATUS, {})

    def close(self) -> None:
        self._client.close()
