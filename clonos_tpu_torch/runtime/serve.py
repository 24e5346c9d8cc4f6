"""Read-path scale-out: queryable state served from standby replicas
(port of ``clonos_tpu/runtime/serve.py``).

The standby pool restores every completed checkpoint and the audit plane
extracts each sealed epoch's causal surface at the fence
(``epoch_window``). This module composes the two into a read tier:

- :class:`ReadReplica` keeps a restored checkpoint fence-fresh by
  tailing sealed-epoch windows off the runner's serve feed
  (``ClusterRunner.serve_feeds``). For operators that emit their updated
  running value per record (``emits_running_value``, the reduce), the
  last emitted value per key in the window's (step, lane, slot) order is
  the key's fence value, so applying the window to the dense table
  rebuilds the owner's fence state bit for bit. It does so in numpy,
  last write wins by a reverse-unique, never by a scatter whose order
  the device picks. Other operators are checkpoint-fresh only.

- :class:`ReplicaServeEndpoint` coalesces concurrent lookups into one
  gather per dispatch: the transport's handler threads enqueue keys and
  a single dispatch thread drains the queue and issues one fused
  ``acc[owner_subtask(keys), keys]`` read for the whole batch.

- :class:`ServeRouter` routes lookups by key group across owner and
  replicas with a staleness bound; a replica past its bound, dead or
  mid-revival is skipped for the owner (a counted reroute, never a
  client-visible error).

Threads. Apart from the thread that drives the runner, the endpoint's
dispatch thread is the one thread that queues work on the card, and only
on the replica's own tensors, never on the job's carry. It works on its
own ``torch.cuda.Stream``: the table is uploaded through pinned memory
once per epoch stamp, the keys once per dispatch, and the results come
back through a ``device.HostCopy`` whose event on that stream is all the
thread ever waits for. On the default stream every read would queue
behind the job's blocks (20-36 ms each at the headline's widths). The
replica's feed callbacks run on the fence worker when the fence is
pipelined: they are host-only and lock-guarded. Its restore points are
copied to the host where checkpoints complete (the driving thread),
and the feed only waits for those copies.

Consistency: a replica at epoch ``e`` serves exactly the state the owner
had at fence ``e``; staleness is ``last_sealed_epoch - replica_epoch``;
replicas only ever publish whole sealed-epoch states.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.parallel import routing
from clonos_tpu_torch.obs.lineage import get_lineage
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.runtime.query import (QueryableStateClient,
                                            QueryableStateEndpoint,
                                            QueryRejectedError,
                                            QueryTimeoutError, _client_call,
                                            _verb, owner_subtask_np)

#: padded gather sizes: a mixed read load sees O(log max_batch) shapes
_MIN_BUCKET = 64


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def _gather_fn(parallelism: int, num_key_groups: int):
    """One fused read for a whole key batch: key -> ``hash32`` -> key
    group -> owning subtask -> table entry (the device twin of
    :func:`owner_subtask_np`). ``f(acc, keys) -> (values, subtasks,
    key_groups)``; subtasks and key groups are int32."""
    def fn(acc: torch.Tensor, keys: torch.Tensor):
        kg = routing.key_group(keys, num_key_groups)
        sub = routing.subtask_for_key_group(kg, parallelism, num_key_groups)
        return acc[sub.long(), keys.long()], sub, kg
    return fn


class ReadReplica:
    """A standby's live read view of one vertex's dense keyed state.

    Restores from completed checkpoints and advances one sealed epoch at
    a time off the runner's serve feed."""

    def __init__(self, runner, vertex_id: int, state: str = "acc",
                 name: str = "replica-0"):
        self.runner = runner
        self.vertex_id = int(vertex_id)
        self.state_name = state
        self.name = name
        v = runner.job.vertices[self.vertex_id]
        self.parallelism = v.parallelism
        self.num_key_groups = runner.job.num_key_groups
        self.device = torch.device(runner.device)
        #: the running-value contract makes tailing the window exact;
        #: without it the replica is checkpoint-fresh only
        self.tailable = bool(getattr(v.operator, "emits_running_value",
                                     False))
        self._lock = threading.Lock()
        self._arr: Optional[np.ndarray] = None     # host [P, K]
        self._epoch = -1                           # fence the view is at
        self._owner_of: Optional[np.ndarray] = None
        #: (checkpoint id, HostCopy of its table or None) of the latest
        #: completed checkpoint: the restore point a revival adopts
        self._restore: Optional[Tuple[int, Optional[_device.HostCopy]]] \
            = None
        self.alive = True
        self.applied_epochs = 0
        self.restores = 0
        self.revivals = 0
        #: the table on the card for the gather, touched only by the
        #: endpoint's dispatch thread
        self._dev: Optional[torch.Tensor] = None
        self._dev_epoch = -1
        runner.serve_feeds.append(self._on_seal)
        runner.coordinator.subscribe_completed_state(self._on_checkpoint)
        ck = runner.standbys.latest
        if ck is not None:
            self._on_checkpoint(ck)

    # --- state plane (runner-side callbacks) -----------------------------

    def _stage_table(self, ckpt) -> Optional[_device.HostCopy]:
        """Start the host copy of the checkpoint's table (None when the
        vertex has no keyed ``[P, ...]`` state of that name)."""
        st = ckpt.carry.op_states[self.vertex_id]
        if not isinstance(st, dict) or self.state_name not in st:
            return None
        arr = st[self.state_name]
        if len(arr.shape) < 2 or arr.shape[0] != self.parallelism:
            return None
        return _device.HostCopy(arr)

    def _on_checkpoint(self, ckpt) -> None:
        """Completion listener (the driving thread): record the restore
        point, and adopt it if it is fresher than the current view
        (checkpoint id == the epoch it fences). For tailable operators
        the feed usually got there first and nothing is adopted."""
        cid = int(ckpt.checkpoint_id)
        table = self._stage_table(ckpt)
        with self._lock:
            # Monotonic, as the standby pool's latest.
            if self._restore is None or cid >= self._restore[0]:
                self._restore = (cid, table)
            if not self.alive or cid <= self._epoch or table is None:
                return
            self._adopt(np.array(table.wait()), cid)
            self.restores += 1

    def _adopt(self, arr: np.ndarray, epoch: int) -> None:
        self._arr = arr
        self._epoch = epoch
        if self._owner_of is None or len(self._owner_of) != arr.shape[-1]:
            _, self._owner_of = owner_subtask_np(
                np.arange(arr.shape[-1]), self.parallelism,
                self.num_key_groups)

    def _on_seal(self, epoch: int, window) -> None:
        """Serve-feed tail: apply one sealed epoch's output-ring window.
        Windows only advance ``e-1 -> e``; a gap (late attach, revival)
        waits for a checkpoint to close it, so staleness stays visible
        rather than wrong."""
        with self._lock:
            if not self.alive:
                # Revival at the first seal after a kill: re-adopt the
                # latest restore point; staleness is (sealed - checkpoint)
                # until the tail catches up.
                if self._restore is None or self._restore[1] is None:
                    return
                cid, table = self._restore
                self.alive = True
                self.revivals += 1
                self._epoch = -1
                self._adopt(np.array(table.wait()), cid)
                self.restores += 1
            if (not self.tailable or self._arr is None
                    or self._epoch != epoch - 1 or window is None):
                return
            steps = window.get("rings", {}).get(self.vertex_id)
            if steps is None:
                return
            self._apply_running_values(steps)
            self._epoch = epoch
            self.applied_epochs += 1

    def _apply_running_values(self, steps) -> None:
        """Last write wins: each valid record carries its key's value
        after that record folded in, and the window's steps are in
        deterministic order, so the last record per key is the owner's
        fence value for that key."""
        ks = [np.asarray(k, np.int64) for k, _, _ in steps if len(k)]
        vs = [np.asarray(v) for k, v, _ in steps if len(k)]
        if not ks:
            return
        keys = np.concatenate(ks)
        vals = np.concatenate(vs)
        # np.unique keeps first occurrences: the first in the reversed
        # order is the last overall.
        rk, rv = keys[::-1], vals[::-1]
        uk, first = np.unique(rk, return_index=True)
        self._arr[self._owner_of[uk], uk] = rv[first]

    # --- serve plane -----------------------------------------------------

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def _staleness_locked(self) -> int:
        sealed = int(self.runner.last_sealed_epoch)
        if self._epoch < 0:
            return sealed + 1
        return max(0, sealed - self._epoch)

    def staleness_epochs(self) -> int:
        """Fences behind the owner's last seal (0 = fence-fresh; grows
        while dead or gapped)."""
        with self._lock:
            return self._staleness_locked()

    def status(self) -> dict:
        with self._lock:
            return {"epoch": self._epoch,
                    "staleness_epochs": self._staleness_locked(),
                    "alive": self.alive, "role": "replica",
                    "name": self.name, "tailable": self.tailable,
                    "applied_epochs": self.applied_epochs,
                    "restores": self.restores}

    def host_view(self) -> Tuple[Optional[np.ndarray], int]:
        """(a copy of the table, its epoch) under the lock; (None, epoch)
        while dead or before any restore."""
        with self._lock:
            if not self.alive or self._arr is None:
                return None, self._epoch
            return self._arr.copy(), self._epoch

    def device_view(self) -> Tuple[Optional[torch.Tensor], int]:
        """The table on the replica's device, uploaded again only when
        its epoch stamp moved. Called only from the endpoint's dispatch
        thread, inside its stream: the upload is a pinned,
        non-blocking copy on that stream."""
        with self._lock:
            if (self.alive and self._dev is not None
                    and self._dev_epoch == self._epoch):
                return self._dev, self._epoch
        arr, epoch = self.host_view()
        if arr is None:
            return None, epoch
        dev = _device.upload(arr, self.device)
        with self._lock:
            self._dev = dev
            self._dev_epoch = epoch
        return dev, epoch

    def kill(self) -> None:
        """The replica stops serving and drops its view (its staleness
        becomes ``sealed + 1``); the router reroutes to the owner. It
        revives at the next seal."""
        with self._lock:
            self.alive = False
            self._arr = None
            self._epoch = -1
            self._dev = None
            self._dev_epoch = -1

    def rehome(self, new_runner) -> None:
        """Re-attach to the new incarnation after a live re-cut
        (``ClusterRunner.rescale_live``). The key-group owner map changes
        with the vertex's parallelism, so the old view, its restore point
        and its device table (all of the old shape) are dropped and the
        replica re-adopts from the new runner's restore point (the re-cut
        re-fences the handoff checkpoint in the new shape). Until then it
        has no view: the router reroutes to the owner, and clients see
        staleness, never an error."""
        with self._lock:
            try:
                self.runner.serve_feeds.remove(self._on_seal)
            except ValueError:
                pass
            self.runner = new_runner
            v = new_runner.job.vertices[self.vertex_id]
            self.parallelism = v.parallelism
            self.num_key_groups = new_runner.job.num_key_groups
            self.tailable = bool(getattr(v.operator, "emits_running_value",
                                         False))
            self.alive = True
            self._arr = None
            self._epoch = -1
            self._owner_of = None
            self._restore = None
            self._dev = None
            self._dev_epoch = -1
        new_runner.serve_feeds.append(self._on_seal)
        new_runner.coordinator.subscribe_completed_state(self._on_checkpoint)
        ck = new_runner.standbys.latest
        if ck is not None:
            self._on_checkpoint(ck)

    def close(self) -> None:
        with self._lock:
            try:
                self.runner.serve_feeds.remove(self._on_seal)
            except ValueError:
                pass


class ReplicaServeEndpoint:
    """Serves a :class:`ReadReplica` over the control transport with
    request coalescing: handler threads enqueue keys and block on a
    ticket; the single dispatch thread drains the whole queue into one
    padded gather per dispatch."""

    def __init__(self, replica: ReadReplica, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 4096):
        self.replica = replica
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._closed = False
        #: dispatches vs keys served: the coalescing ratio
        self.dispatches = 0
        self.keys_served = 0
        self.requests = 0
        self._stream = None         # made by the dispatch thread
        self._thread = threading.Thread(
            target=self._serve_loop, name=f"serve-{replica.name}",
            daemon=True)
        self._thread.start()
        self.server = tp.ControlServer(self._handle, host, port)
        self.address = self.server.address

    # --- transport side --------------------------------------------------

    def _handle(self, mtype: int, payload: bytes) -> Tuple[int, bytes]:
        if mtype == tp.SERVE_STATUS:
            st = self.replica.status()
            st["dispatches"] = self.dispatches
            st["keys_served"] = self.keys_served
            return tp.QUERY_RESPONSE, tp.pack_json(st)
        if mtype not in (tp.QUERY_STATE, tp.QUERY_BATCH):
            return tp.ERROR, tp.pack_json({"error": f"bad mtype {mtype}"})
        req = tp.unpack_json(payload)
        tp.adopt_hlc(req, verb=_verb(mtype))
        if req["vertex"] != self.replica.vertex_id or \
                req.get("state", "acc") != self.replica.state_name:
            return tp.ERROR, tp.pack_json(
                {"error": f"replica serves (vertex "
                          f"{self.replica.vertex_id}, "
                          f"{self.replica.state_name!r}) only"})
        single = mtype == tp.QUERY_STATE
        keys = np.asarray([req["key"]] if single else req["keys"],
                          np.int64)
        ticket = {"keys": keys, "event": threading.Event(),
                  "out": None, "err": None}
        with self._cv:
            if self._closed:
                return tp.ERROR, tp.pack_json(
                    {"error": "endpoint closed", "rejected": True})
            self._pending.append(ticket)
            self.requests += 1
            self._cv.notify()
        ticket["event"].wait()
        if ticket["err"] is not None:
            return tp.ERROR, tp.pack_json(ticket["err"])
        vals, subs, kgs, epoch, stal = ticket["out"]
        name = self.replica.name
        if single:
            return tp.QUERY_RESPONSE, tp.pack_json(
                {"value": vals[0], "subtask": subs[0],
                 "key_group": kgs[0], "epoch": epoch,
                 "staleness_epochs": stal, "served_by": name,
                 "replica": name})
        return tp.QUERY_BATCH_RESPONSE, tp.pack_json(
            {"values": vals, "subtasks": subs, "key_groups": kgs,
             "epoch": epoch, "staleness_epochs": stal,
             "served_by": name, "replica": name})

    # --- the single dispatch thread --------------------------------------

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                batch: List[dict] = []
                n = 0
                while self._pending and n < self.max_batch:
                    t = self._pending.popleft()
                    batch.append(t)
                    n += len(t["keys"])
            try:
                if self.replica.device.type == "cuda":
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(
                            self.replica.device)
                    with torch.cuda.stream(self._stream):
                        self._dispatch(batch)
                else:
                    self._dispatch(batch)
            except Exception as e:       # keep the loop alive; fail the batch
                for t in batch:
                    if not t["event"].is_set():
                        t["err"] = {"error": f"serve dispatch failed: {e}",
                                    "rejected": True}
                        t["event"].set()

    def _dispatch(self, batch: List[dict]) -> None:
        r = self.replica
        arr_dev, epoch = r.device_view()
        if arr_dev is None:
            why = ("replica dead" if not r.alive
                   else "replica has no restored state yet")
            for t in batch:
                t["err"] = {"error": why, "rejected": True}
                t["event"].set()
            return
        num_keys = arr_dev.shape[-1]
        all_keys = np.concatenate([t["keys"] for t in batch])
        if all_keys.min() < 0 or all_keys.max() >= num_keys:
            for t in batch:
                if t["keys"].min() < 0 or t["keys"].max() >= num_keys:
                    t["err"] = {"error": f"key out of range "
                                         f"[0, {num_keys})"}
                    t["event"].set()
            batch = [t for t in batch if not t["event"].is_set()]
            if not batch:
                return
            all_keys = np.concatenate([t["keys"] for t in batch])
        n = len(all_keys)
        padded = np.zeros(_bucket(n), np.int32)
        padded[:n] = all_keys
        fn = _gather_fn(r.parallelism, r.num_key_groups)
        keys_dev = _device.upload(padded, r.device)
        # clonos: serve-window-begin
        out = fn(arr_dev, keys_dev)
        # clonos: serve-window-end
        # The wait is outside the dispatch-only window: it waits for
        # this stream's copy event alone.
        vals, subs, kgs = (x[:n].tolist()
                           for x in _device.HostCopy(out).wait())
        stal = r.staleness_epochs()
        self.dispatches += 1
        self.keys_served += n
        off = 0
        for t in batch:
            m = len(t["keys"])
            t["out"] = (vals[off:off + m], subs[off:off + m],
                        kgs[off:off + m], epoch, stal)
            off += m
            t["event"].set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.server.close()
        self._thread.join(timeout=5.0)


class ReplicaStateClient:
    """Client for a :class:`ReplicaServeEndpoint` (the wire protocol and
    the timeout discipline of ``QueryableStateClient``). One connection,
    not thread-safe: concurrent readers hold one client each."""

    def __init__(self, address, timeout_s: float = 5.0,
                 retries: int = 2, backoff_s: float = 0.05):
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
        return self._call(tp.QUERY_BATCH,
                          {"vertex": vertex, "state": state,
                           "keys": [int(k) for k in keys]})

    def status(self) -> dict:
        return self._call(tp.SERVE_STATUS, {})

    def close(self) -> None:
        self._client.close()


#: what a replica failure looks like to the router: reroute, not error
#: (IndexError: the tier shrank between routing and the call)
_REPLICA_FAILURES = (QueryTimeoutError, QueryRejectedError, OSError,
                     IndexError)


class ServeRouter:
    """Routes keyed lookups across owner and replicas by key group.

    Endpoints are duck-typed (``query`` / ``query_batch`` / ``status``).
    Key -> key group -> replica ``kg % R``; the replica is used iff its
    last-known status is alive and within ``staleness_bound`` sealed
    epochs of the owner, otherwise the read reroutes to the owner
    (counted). A replica that fails the read itself (timeout, rejection,
    transport) also reroutes: clients see degradation as staleness and
    latency, not exceptions."""

    def __init__(self, owner, replicas: Sequence, num_key_groups: int,
                 staleness_bound: int = 2, status_ttl_s: float = 0.05,
                 lineage=None):
        self.owner = owner
        #: lineage plane for serve-read termini (obs/lineage.py); None
        #: resolves to the process plane per read, so a router built
        #: before the plane was configured still records. Dyed keys only.
        self.lineage = lineage
        self.replicas = list(replicas)
        self.num_key_groups = int(num_key_groups)
        self.staleness_bound = int(staleness_bound)
        self.status_ttl_s = float(status_ttl_s)
        self.reads = 0
        self.reroutes = 0
        self.replica_reads = 0
        self.owner_reads = 0
        self.errors = 0
        #: recent end-to-end read latencies (ms) for the p99 gauge
        self.recent_ms: deque = deque(maxlen=8192)
        self._status: List[Optional[dict]] = [None] * len(self.replicas)
        self._status_at = [0.0] * len(self.replicas)
        self._lock = threading.Lock()

    # --- policy ----------------------------------------------------------

    def key_group(self, key: int) -> int:
        kg, _ = owner_subtask_np(np.asarray(key), 1, self.num_key_groups)
        return int(kg)

    def replica_for_group(self, kg: int) -> Optional[int]:
        if not self.replicas:
            return None
        return int(kg) % len(self.replicas)

    def replica_staleness(self, i: int) -> Optional[int]:
        st = self._probe(i)
        if st is None:
            return None
        return int(st.get("staleness_epochs", 0))

    def _probe(self, i: int) -> Optional[dict]:
        """Freshness probe, cached for ``status_ttl_s`` per replica (the
        routing decision must not double every read's round trips)."""
        now = _time.monotonic()
        with self._lock:
            if (self._status[i] is not None
                    and now - self._status_at[i] < self.status_ttl_s):
                return self._status[i]
        try:
            st = self.replicas[i].status()
        except (QueryTimeoutError, QueryRejectedError, OSError, KeyError):
            st = None
        with self._lock:
            self._status[i] = st
            self._status_at[i] = _time.monotonic()
        return st

    def _usable(self, i: Optional[int]) -> bool:
        if i is None:
            return False
        st = self._probe(i)
        return (st is not None and st.get("alive", True)
                and int(st.get("staleness_epochs", 0))
                <= self.staleness_bound)

    def _invalidate(self, i: int) -> None:
        with self._lock:
            if i < len(self._status):
                self._status[i] = None

    # --- reads -----------------------------------------------------------

    def _lineage(self):
        return self.lineage if self.lineage is not None else get_lineage()

    def query(self, vertex: int, key: int, state: str = "acc") -> dict:
        t0 = _time.monotonic()
        i = self.replica_for_group(self.key_group(key))
        out = None
        rerouted = False
        if self._usable(i):
            try:
                out = self.replicas[i].query(vertex, key, state=state)
                self.replica_reads += 1
            except _REPLICA_FAILURES:
                self._invalidate(i)
                out = None
        if out is None:
            if i is not None:
                self.reroutes += 1
                rerouted = True
            out = self.owner.query(vertex, key, state=state)
            self.owner_reads += 1
        # Provenance: which endpoint answered, and whether the read fell
        # back to the owner.
        out = dict(out)
        out["replica"] = str(out.get("served_by", "owner"))
        out["rerouted"] = rerouted
        lin = self._lineage()
        if lin.enabled:
            lin.observe_serve(key, epoch=int(out.get("epoch", -1)),
                              replica=out["replica"], rerouted=rerouted)
        self.reads += 1
        self.recent_ms.append((_time.monotonic() - t0) * 1e3)
        return out

    def query_batch(self, vertex: int, keys: Sequence[int],
                    state: str = "acc") -> dict:
        """Batched routed read: keys are grouped by destination and each
        group goes out as one wire request. Results come back in input
        order with per-key provenance."""
        t0 = _time.monotonic()
        keys = [int(k) for k in keys]
        groups: Dict[object, List[int]] = {}
        routed_away: List[int] = []
        for pos, k in enumerate(keys):
            i = self.replica_for_group(self.key_group(k))
            dest = i if self._usable(i) else None
            if dest is None and i is not None:
                self.reroutes += 1
                routed_away.append(pos)
            groups.setdefault(dest, []).append(pos)
        n = len(keys)
        values = [None] * n
        epochs = [None] * n
        stals = [None] * n
        served = [None] * n
        rerouted = [False] * n
        for dest, positions in groups.items():
            sub_keys = [keys[p] for p in positions]
            out = None
            if dest is not None:
                try:
                    out = self.replicas[dest].query_batch(
                        vertex, sub_keys, state=state)
                    self.replica_reads += len(positions)
                except _REPLICA_FAILURES:
                    self._invalidate(dest)
                    self.reroutes += len(positions)
                    for p in positions:
                        rerouted[p] = True
                    out = None
            if out is None:
                out = self.owner.query_batch(vertex, sub_keys, state=state)
                self.owner_reads += len(positions)
            who = out.get("served_by", "owner")
            for j, p in enumerate(positions):
                values[p] = out["values"][j]
                epochs[p] = out["epoch"]
                stals[p] = out.get("staleness_epochs", 0)
                served[p] = who
        for p in routed_away:
            rerouted[p] = True
        lin = self._lineage()
        if lin.enabled:
            for p, k in enumerate(keys):
                lin.observe_serve(k, epoch=int(epochs[p] or -1),
                                  replica=str(served[p]),
                                  rerouted=rerouted[p])
        self.reads += n
        self.recent_ms.append((_time.monotonic() - t0) * 1e3)
        return {"values": values, "epochs": epochs,
                "staleness_epochs": stals, "served_by": served,
                "rerouted": rerouted}


class ServeTier:
    """One runner's read tier: the owner endpoint, replicas with their
    endpoints and clients, the router, and the ``serve.*`` metrics."""

    def __init__(self, runner, vertex_id: int, n_replicas: int = 2,
                 staleness_bound: int = 2, state: str = "acc",
                 timeout_s: float = 5.0):
        self.runner = runner
        self.vertex_id = int(vertex_id)
        self.state_name = state
        self.timeout_s = float(timeout_s)
        #: replicas made so far: names are never reused, even where an
        #: index is (a drop, then an add)
        self._n_created = 0
        self.owner_endpoint = QueryableStateEndpoint(runner)
        self.owner_client = QueryableStateClient(
            self.owner_endpoint.address, timeout_s=timeout_s)
        self.replicas: List[ReadReplica] = []
        self.endpoints: List[ReplicaServeEndpoint] = []
        self.clients: List[ReplicaStateClient] = []
        for _ in range(n_replicas):
            self._build_replica()
        self.router = ServeRouter(
            self.owner_client, self.clients,
            num_key_groups=runner.job.num_key_groups,
            staleness_bound=staleness_bound,
            lineage=getattr(runner, "lineage", None))
        # The owner's snapshot refreshes at every fence, before
        # completion truncates.
        runner.fence_hooks.append(self._on_fence)
        self._register_gauges()

    def _build_replica(self) -> ReadReplica:
        """One replica with its endpoint and client, appended to the
        tier's lists (not yet visible to the router)."""
        rep = ReadReplica(self.runner, self.vertex_id, state=self.state_name,
                          name=f"replica-{self._n_created}")
        self._n_created += 1
        ep = ReplicaServeEndpoint(rep)
        self.replicas.append(rep)
        self.endpoints.append(ep)
        self.clients.append(ReplicaStateClient(ep.address,
                                               timeout_s=self.timeout_s))
        return rep

    def add_replica(self) -> int:
        """Grow the tier by one replica at runtime. It adopts the latest
        restore point at once and fills at the next seal, so it serves
        with honest staleness from its first read; the router's
        ``kg % R`` map takes the new count once it is published under
        the router's lock. Returns its index."""
        i = len(self.replicas)
        self._build_replica()
        with self.router._lock:
            self.router.replicas.append(self.clients[i])
            self.router._status.append(None)
            self.router._status_at.append(0.0)
        g = self.runner.metrics.group("serve")
        g.gauge(f"replica.{i}.staleness-epochs",
                lambda i=i: self.replicas[i].staleness_epochs())
        return i

    def drop_replica(self) -> int:
        """Shrink the tier by its last replica. The router stops routing
        to it under its lock before the endpoint closes, so a read that
        already picked it reroutes to the owner (staleness, never an
        error); its staleness gauge is unregistered. Never below one
        replica. Returns the dropped index."""
        if len(self.replicas) <= 1:
            raise ValueError("cannot drop the last read replica")
        i = len(self.replicas) - 1
        with self.router._lock:
            self.router.replicas.pop()
            self.router._status = [None] * len(self.router.replicas)
            self.router._status_at = [0.0] * len(self.router.replicas)
        client = self.clients.pop()
        ep = self.endpoints.pop()
        rep = self.replicas.pop()
        client.close()
        ep.close()
        rep.close()
        self.runner.metrics.unregister(f"serve.replica.{i}.staleness-epochs")
        return i

    def _on_fence(self, closed: int) -> None:
        # On the pipelined fence the seal is still in flight: the
        # executor's state is this fence's, so stamp ``closed``.
        self.owner_endpoint.refresh(epoch=closed)

    def _register_gauges(self) -> None:
        from clonos_tpu_torch.soak.slo import quantile
        g = self.runner.metrics.group("serve")
        router = self.router
        g.gauge("reads", lambda: router.reads)
        g.gauge("reroutes", lambda: router.reroutes)
        g.gauge("replica-reads", lambda: router.replica_reads)
        g.gauge("owner-reads", lambda: router.owner_reads)
        g.gauge("read-errors", lambda: router.errors)
        g.gauge("p99-read-ms", lambda: round(
            quantile(list(router.recent_ms), 0.99), 3))
        g.gauge("replicas-alive",
                lambda: sum(1 for r in self.replicas if r.alive))
        self._meter = g.meter("reads-per-sec")
        for i in range(len(self.replicas)):
            g.gauge(f"replica.{i}.staleness-epochs",
                    lambda i=i: self.replicas[i].staleness_epochs())

    def mark_reads(self, n: int) -> None:
        self._meter.mark(n)

    def rehome(self, new_runner) -> None:
        """Re-home the tier after a live re-cut: the owner endpoint
        snapshots the NEW runner, every replica re-adopts in the new
        shape, and the fence hook and gauges move over. Reads issued
        during the handoff reroute to the owner."""
        try:
            self.runner.fence_hooks.remove(self._on_fence)
        except ValueError:
            pass
        self.runner = new_runner
        self.owner_endpoint.runner = new_runner
        self.owner_endpoint.refresh()
        for rep in self.replicas:
            rep.rehome(new_runner)
        # Probes cached against the old incarnation would route on its
        # staleness for a TTL.
        with self.router._lock:
            self.router._status = [None] * len(self.router.replicas)
        new_runner.fence_hooks.append(self._on_fence)
        self._register_gauges()

    def kill_replica(self, i: int) -> None:
        self.replicas[i % len(self.replicas)].kill()

    def staleness(self) -> List[int]:
        return [r.staleness_epochs() for r in self.replicas]

    def close(self) -> None:
        for c in self.clients:
            c.close()
        for ep in self.endpoints:
            ep.close()
        for r in self.replicas:
            r.close()
        self.owner_client.close()
        self.owner_endpoint.close()
        try:
            self.runner.fence_hooks.remove(self._on_fence)
        except ValueError:
            pass


def build_serve_tier(runner, vertex_id: int, n_replicas: int = 2,
                     staleness_bound: int = 2,
                     state: str = "acc") -> ServeTier:
    return ServeTier(runner, vertex_id, n_replicas=n_replicas,
                     staleness_bound=staleness_bound, state=state)
