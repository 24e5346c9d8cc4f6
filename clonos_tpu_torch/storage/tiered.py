"""TieredEpochStore: host staging buffer + immutable disk segments (port
of ``clonos_tpu/storage/tiered.py``).

One store owns the spilled sealed epochs of ONE log (an in-flight ring
vertex or the stacked determinant logs). Tiers and movement:

- **host tier**: the staging buffer. ``put`` takes numpy arrays, or a
  ``device.HostCopy`` whose device-to-host copies the caller started on
  the thread that queued the tensors' work, and returns at once. The
  writer thread only waits for that copy's event: it never queues CUDA
  work of its own (a copy issued from another thread would run on that
  thread's stream behind the next epoch's blocks and turn the overlap
  into a wait). Sealed epochs are immutable, so the staged copy is final.
- **disk tier**: one checksummed segment file per epoch
  (``storage/segment.py``) plus a JSONL segment index under the torn-tail
  rule (``utils/jsonl.py``) — a killed writer leaves at most one torn
  index line, which the reader drops. Once a segment is durable, host
  copies beyond ``host_budget_epochs`` demote to disk-only (the budget
  bounds host memory as the ring bounds device memory).
- **refill**: ``load_epoch`` serves host hits without I/O; disk hits
  re-hash the segment against the indexed checksum and refuse torn bytes
  loudly (:class:`SegmentCorruptError` → recovery raises a labelled error
  instead of replaying garbage).

The writer's queue lets the fence stage epoch N+1 while the thread
still flushes epoch N; ``drain`` joins the queue. ``attach_digest``
records the audit ledger's digest of a spilled epoch in the segment
index, so a spilled epoch carries the fingerprint the ledger pinned.
The process profiler (``obs/profile.py``) receives the writer's
``spill-write`` and a disk refill's ``refill`` seconds.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from clonos_tpu_torch.device import HostCopy
from clonos_tpu_torch.obs.profile import get_profiler
from clonos_tpu_torch.storage.segment import read_segment, write_segment
from clonos_tpu_torch.utils.jsonl import read_jsonl


class StorageError(RuntimeError):
    """Tiered-store failure a caller must not paper over (missing epoch,
    corrupt segment, unusable index)."""


class _Epoch:
    """One sealed epoch's residency record across the tiers."""

    __slots__ = ("start", "arrays", "path", "nbytes", "checksum",
                 "digest", "host_bytes")

    def __init__(self, start: Optional[int], arrays: Any):
        self.start = start
        #: numpy dict, a HostCopy still in flight, or None (disk-only)
        self.arrays = arrays
        self.path: Optional[str] = None
        self.nbytes = 0               # serialized segment payload bytes
        self.checksum: Optional[str] = None
        self.digest: Optional[str] = None   # audit-ledger digest
        self.host_bytes = 0


def _host_arrays(staged: Any) -> Dict[str, np.ndarray]:
    """A staged epoch as numpy arrays: waits for a HostCopy's own event
    (queues no device work); numpy input passes through."""
    if isinstance(staged, HostCopy):
        return staged.wait()
    return {k: np.asarray(v) for k, v in staged.items()}


class TieredEpochStore:
    """Host-buffer + disk-segment owner of one log's spilled epochs."""

    def __init__(self, spool_dir: Optional[str], name: str,
                 durable: bool = True,
                 host_budget_epochs: Optional[int] = 2):
        self.name = name
        self.spool_dir = spool_dir
        self.durable = durable and spool_dir is not None
        self.host_budget_epochs = host_budget_epochs
        #: chaos hook (the soak's ``stall`` fault): a sleep before each
        #: segment write, on the writer thread
        self.write_delay_s = 0.0
        if spool_dir:
            os.makedirs(spool_dir, exist_ok=True)
        self._epochs: Dict[int, _Epoch] = {}
        self._lock = threading.Lock()
        # Movement counters (the spill.* gauges, chip_smoke phase 8).
        self.bytes_spilled = 0
        self.bytes_refilled = 0
        self.spill_seconds = 0.0
        self.refill_seconds = 0.0
        self.segments_written = 0
        self.host_hits = 0
        self.disk_hits = 0
        #: writer commands that raised (the epoch keeps its host copy)
        self.write_errors: List[str] = []
        #: epochs whose segment record is on the index and not yet
        #: covered by a truncate record (the writer thread's own)
        self._indexed: set = set()
        self._writer_queue: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._writer_loop,
                                        name=f"spill-{name}", daemon=True)
        self._writer.start()

    # --- paths ---------------------------------------------------------------

    def segment_path(self, epoch: int) -> str:
        return os.path.join(self.spool_dir, f"{self.name}_epoch{epoch}.seg")

    def index_path(self) -> str:
        return os.path.join(self.spool_dir, f"{self.name}.index.jsonl")

    def _label(self, epoch: int) -> str:
        return f"{self.name}:epoch{epoch}"

    # --- hot-path API --------------------------------------------------------

    def put(self, epoch: int, start: Optional[int], arrays: Any) -> None:
        """Accept one sealed epoch into the host tier and schedule its
        segment write. ``arrays`` is a mapping of numpy arrays or a
        ``HostCopy`` of a dict of tensors. ``start=None`` defers the
        epoch's start to the least entry of its ``starts`` array once
        the copy lands (the determinant tier: its per-log starts live on
        the device)."""
        staged = arrays if isinstance(arrays, HostCopy) else dict(arrays)
        ep = _Epoch(start, staged)
        ep.host_bytes = (staged.nbytes if isinstance(staged, HostCopy)
                         else sum(int(np.asarray(v).nbytes)
                                  for v in staged.values()))
        with self._lock:
            self._epochs[epoch] = ep
        if self.durable:
            self._writer_queue.put(("write", epoch))

    def attach_digest(self, epoch: int, digest: str) -> None:
        """Record the audit ledger's digest for a spilled epoch; the index
        entry lands via the writer thread (no fence-path I/O)."""
        with self._lock:
            ep = self._epochs.get(epoch)
            if ep is None:
                return
            ep.digest = digest
        if self.durable:
            # The digest rides the command: a truncate() between here and
            # the writer drops the epoch from the tiers, not its stamp.
            self._writer_queue.put(("digest", (epoch, digest)))

    def truncate(self, through_epoch: int) -> None:
        """Checkpoint complete: drop epochs <= ``through_epoch`` from every
        tier. Durable segments unlink at once; epochs whose writes are
        still queued are handled by the queued truncate command (the
        writer re-checks residency before writing, and the command,
        ordered after every pending write, sweeps any segment that slipped
        through the check)."""
        with self._lock:
            dead = [e for e in self._epochs if e <= through_epoch]
            paths = [self._epochs[e].path for e in dead
                     if self._epochs[e].path is not None]
            for e in dead:
                del self._epochs[e]
        for p in paths:
            try:
                os.remove(p)
            except OSError:
                pass
        if self.durable and dead:
            self._writer_queue.put(("truncate", through_epoch))

    def retained_epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._epochs)

    def epoch_digest(self, epoch: int) -> Optional[str]:
        with self._lock:
            ep = self._epochs.get(epoch)
            return ep.digest if ep is not None else None

    # --- refill --------------------------------------------------------------

    def load_epoch(self, epoch: int) -> Tuple[int, Dict[str, np.ndarray]]:
        """One epoch back from whichever tier holds it, as numpy arrays:
        a host hit reads the staged copy (waiting for its event if it is
        still in flight); a disk hit re-hashes the segment against the
        indexed checksum before trusting a byte."""
        with self._lock:
            ep = self._epochs.get(epoch)
            if ep is None:
                raise StorageError(
                    f"{self._label(epoch)}: epoch not retained by any "
                    f"tier (truncated or never spilled)")
            staged, start = ep.arrays, ep.start
            path, checksum = ep.path, ep.checksum
            if staged is not None:
                self.host_hits += 1
        if staged is not None:
            arrays = _host_arrays(staged)
            if start is None:
                start = _least_start(arrays)
            return start, arrays
        if path is None:
            raise StorageError(
                f"{self._label(epoch)}: epoch resident in no tier "
                f"(host copy dropped before its segment was durable)")
        t0 = time.monotonic()
        start, arrays = read_segment(path, checksum, self._label(epoch))
        dur = time.monotonic() - t0
        with self._lock:
            self.disk_hits += 1
            self.refill_seconds += dur
            self.bytes_refilled += sum(a.nbytes for a in arrays.values())
        get_profiler().observe("refill", dur)
        return start, arrays

    # --- background writer ---------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            item = self._writer_queue.get()
            try:
                if item is None:
                    return
                kind, arg = item
                if kind == "write":
                    self._write_one(arg)
                elif kind == "digest":
                    self._index_digest(*arg)
                elif kind == "truncate":
                    self._truncate_disk(arg)
            except Exception as e:
                # The thread must survive a poisoned command: its death
                # would deadlock every later drain() and stop all
                # spilling. The epoch keeps its staged host copy, so a
                # refill still reads it (and re-raises a failed copy's
                # error there); the failure is kept in ``write_errors``.
                with self._lock:
                    self.write_errors.append(f"{item}: {e!r}")
            finally:
                self._writer_queue.task_done()

    def _write_one(self, epoch: int) -> None:
        with self._lock:
            ep = self._epochs.get(epoch)
            if ep is None or ep.arrays is None:
                return                 # truncated while queued
            staged = ep.arrays
            digest = ep.digest
        arrays = _host_arrays(staged)
        start = ep.start if ep.start is not None else _least_start(arrays)
        if self.write_delay_s:
            time.sleep(self.write_delay_s)      # chaos `stall` fault
        t0 = time.monotonic()
        try:
            nbytes, checksum = write_segment(
                self.segment_path(epoch), start, arrays)
            self._index_append({
                "kind": "segment", "epoch": epoch, "start": start,
                "file": os.path.basename(self.segment_path(epoch)),
                "blake2b": checksum, "bytes": nbytes,
                "digest": digest,
            })
            self._indexed.add(epoch)
        except OSError:
            # Flush failure: keep the host copy so replay still works —
            # materialized, so the pinned staging buffers go either way.
            with self._lock:
                if epoch in self._epochs:
                    self._epochs[epoch].arrays = arrays
                    self._epochs[epoch].start = start
            raise
        dur = time.monotonic() - t0
        with self._lock:
            cur = self._epochs.get(epoch)
            if cur is not None:
                cur.arrays = arrays     # host tier now holds numpy copies
                cur.start = start
                cur.path = self.segment_path(epoch)
                cur.nbytes = nbytes
                cur.checksum = checksum
            self.segments_written += 1
            self.bytes_spilled += nbytes
            self.spill_seconds += dur
            self._enforce_host_budget_locked()
        get_profiler().observe("spill-write", dur)

    def _enforce_host_budget_locked(self) -> None:
        """Demote durable host copies beyond the budget to disk-only
        (oldest epochs first — refill wants the newest near)."""
        if self.host_budget_epochs is None:
            return
        resident = sorted(e for e, ep in self._epochs.items()
                          if ep.arrays is not None and ep.path is not None)
        excess = len(resident) - self.host_budget_epochs
        for e in resident[:max(excess, 0)]:
            self._epochs[e].arrays = None

    def _index_digest(self, epoch: int, digest: str) -> None:
        # Writer thread: the epoch's write command ran before this one, so
        # either its segment record is on the index (stamp it, truncated
        # since or not) or it never will be (nothing to stamp).
        if epoch in self._indexed:
            self._index_append({"kind": "digest", "epoch": epoch,
                                "digest": digest})

    def _truncate_disk(self, through_epoch: int) -> None:
        prefix = f"{self.name}_epoch"
        for fn in list(os.listdir(self.spool_dir)):
            if not (fn.startswith(prefix) and fn.endswith(".seg")):
                continue
            try:
                e = int(fn[len(prefix):-len(".seg")])
            except ValueError:
                continue
            if e <= through_epoch:
                try:
                    os.remove(os.path.join(self.spool_dir, fn))
                except OSError:
                    pass
        self._indexed -= {e for e in self._indexed if e <= through_epoch}
        # Recorded unconditionally: truncate() already unlinked some
        # segments, and open_index must not resurrect their entries.
        self._index_append({"kind": "truncate", "through": through_epoch})

    def _index_append(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True,
                          separators=(",", ":")) + "\n"
        with open(self.index_path(), "a") as f:
            f.write(line)
            f.flush()

    # --- occupancy / lifecycle -----------------------------------------------

    def occupancy(self) -> Dict[str, int]:
        """Tier residency right now (the spill.* occupancy gauges)."""
        with self._lock:
            eps = list(self._epochs.values())
        host = [ep for ep in eps if ep.arrays is not None]
        disk = [ep for ep in eps if ep.path is not None]
        return {"host_epochs": len(host),
                "host_bytes": sum(ep.host_bytes for ep in host),
                "disk_epochs": len(disk),
                "disk_bytes": sum(ep.nbytes for ep in disk)}

    def stats(self) -> Dict[str, Any]:
        """Cumulative movement counters."""
        with self._lock:
            return {
                "bytes_spilled": self.bytes_spilled,
                "bytes_refilled": self.bytes_refilled,
                "spill_seconds": round(self.spill_seconds, 6),
                "refill_seconds": round(self.refill_seconds, 6),
                "segments_written": self.segments_written,
                "host_hits": self.host_hits,
                "disk_hits": self.disk_hits,
                "write_errors": len(self.write_errors),
            }

    def drain(self) -> None:
        """Block until every queued spill/index write is done."""
        self._writer_queue.join()

    def close(self) -> None:
        self._writer_queue.put(None)

    # --- fresh-process refill ------------------------------------------------

    @classmethod
    def open_index(cls, spool_dir: str, name: str) -> "TieredEpochStore":
        """Rebuild a store's disk tier from its segment index in a fresh
        process: replay the index records in order, tail-tolerantly (a
        killed writer's torn final line drops; earlier corruption raises
        the labelled error)."""
        store = cls(spool_dir, name)
        records = read_jsonl(store.index_path(), label=f"{name}-index")
        with store._lock:
            for rec in records:
                kind = rec.get("kind")
                if kind == "segment":
                    ep = _Epoch(int(rec["start"]), None)
                    ep.path = os.path.join(spool_dir, rec["file"])
                    ep.checksum = rec.get("blake2b")
                    ep.nbytes = int(rec.get("bytes", 0))
                    ep.digest = rec.get("digest")
                    store._epochs[int(rec["epoch"])] = ep
                elif kind == "digest":
                    ep = store._epochs.get(int(rec["epoch"]))
                    if ep is not None:
                        ep.digest = rec.get("digest")
                elif kind == "truncate":
                    thr = int(rec["through"])
                    for e in [e for e in store._epochs if e <= thr]:
                        del store._epochs[e]
        return store


def _least_start(arrays: Mapping[str, np.ndarray]) -> int:
    starts = np.asarray(arrays["starts"])
    return int(starts.min()) if starts.size else 0
