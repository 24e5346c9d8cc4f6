"""Transactional (exactly-once) sink egress, the two-phase-commit analog
(port of ``clonos_tpu/runtime/txn.py``).

The sink operator stays a device op; this host-side log buffers each
epoch's emitted records as the epoch's pending transaction, sharded per
sink subtask, seals it at the epoch fence and commits it when the
checkpoint coordinator reports the epoch's checkpoint complete. A failed
sink subtask loses its pending shards; recovery replays the lost epochs
and rebuilds them before any commit, so the committed stream equals a
never-failed run's.

Per-block emissions arrive as ``device.HostCopy`` handles started on the
thread that drives the blocks (:meth:`TransactionLog.absorb`); they are
waited for and sharded at the seal, which may run on the fence worker,
so every method holds the log's lock around its bookkeeping.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class _Txn:
    epoch: int
    #: per-subtask accumulated [n, 3] (key, value, timestamp) records
    shards: Dict[int, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)
    sealed: bool = False


class TransactionLog:
    """Per-sink-vertex two-phase-commit state with per-subtask shards."""

    def __init__(self, vertex_id: int,
                 committer: Optional[Callable[[int, np.ndarray], None]]
                 = None):
        self.vertex_id = vertex_id
        self.committer = committer
        #: called at the seal with the epoch's per-subtask shards: durable
        #: sinks persist pending parts here, before the checkpoint can
        #: complete (``runtime/filesink.py``)
        self.pre_committer: Optional[
            Callable[[int, Dict[int, np.ndarray]], None]] = None
        self._pending: Dict[int, _Txn] = {}
        #: epoch -> block copies not yet sharded, in block order
        self._copies: Dict[int, list] = {}
        self.committed: List[Tuple[int, np.ndarray]] = []
        #: epochs at or below this were committed by an earlier incarnation
        #: (:meth:`mark_committed_through`): their records are dropped
        self.committed_through = -1
        self._lock = threading.Lock()

    # --- pre-commit side -----------------------------------------------------

    def _open(self, epoch: int) -> _Txn:
        txn = self._pending.setdefault(epoch, _Txn(epoch))
        if txn.sealed:
            raise RuntimeError(f"epoch {epoch} transaction already sealed")
        return txn

    def _shard(self, txn: _Txn, keys, values, timestamps, valid,
               lane0: int = 0) -> None:
        for sub in range(keys.shape[1]):
            m = valid[:, sub].reshape(-1)
            txn.shards.setdefault(lane0 + sub, []).append(np.stack(
                [keys[:, sub].reshape(-1)[m], values[:, sub].reshape(-1)[m],
                 timestamps[:, sub].reshape(-1)[m]], axis=1))

    def absorb(self, epoch: int, copy, lane0: int = 0) -> None:
        """Append one block's sink emissions, a ``device.HostCopy`` of its
        ``[K, P, cap]`` RecordBatch, to the epoch's pending transaction;
        they are sharded per subtask when the epoch settles. ``lane0`` is
        the global subtask of the block's first lane (a rank's lanes on a
        mesh)."""
        with self._lock:
            if epoch <= self.committed_through:
                return
            self._open(epoch)
            self._copies.setdefault(epoch, []).append((copy, lane0))

    def _settle(self, epoch: int) -> None:
        """Wait for an epoch's queued copies (outside the lock: the main
        thread may keep queueing later epochs) and shard them."""
        with self._lock:
            copies = self._copies.pop(epoch, [])
        for c, lane0 in copies:
            b = c.wait()
            with self._lock:
                self._shard(self._pending[epoch], b.keys, b.values,
                            b.timestamps, b.valid, lane0)

    def _settle_all(self) -> None:
        with self._lock:
            epochs = sorted(self._copies)
        for e in epochs:
            self._settle(e)

    def seal(self, epoch: int) -> None:
        """Epoch fence: the transaction stops accepting records and its
        shards are pre-committed."""
        self._settle(epoch)
        with self._lock:
            if epoch <= self.committed_through:
                return
            txn = self._pending.setdefault(epoch, _Txn(epoch))
            txn.sealed = True
            merged = self._merged_shards(txn)
        if self.pre_committer is not None:
            self.pre_committer(epoch, merged)

    @staticmethod
    def _merged_shards(txn: _Txn) -> Dict[int, np.ndarray]:
        return {s: (np.concatenate(txn.shards[s], axis=0)
                    if txn.shards[s] else np.zeros((0, 3), np.int32))
                for s in sorted(txn.shards)}

    # --- commit / abort ------------------------------------------------------

    def commit(self, epoch: int) -> None:
        """Checkpoint complete: externalise every transaction up to
        ``epoch`` in epoch order, subtask-major within an epoch."""
        done = []
        with self._lock:
            for e in sorted(self._pending):
                if e > epoch:
                    break
                txn = self._pending.pop(e)
                parts = [np.concatenate(txn.shards[s], axis=0)
                         for s in sorted(txn.shards) if txn.shards[s]]
                recs = (np.concatenate(parts, axis=0) if parts
                        else np.zeros((0, 3), np.int32))
                self.committed.append((e, recs))
                done.append((e, recs))
        if self.committer is not None:
            for e, recs in done:
                self.committer(e, recs)

    def mark_committed_through(self, epoch: int) -> None:
        """An earlier incarnation already committed every epoch up to
        ``epoch`` (a standby restored an older checkpoint than the newest
        completed one): drop their pending transactions, and absorb, seal
        or rebuild nothing for them again, so no record commits twice."""
        with self._lock:
            self.committed_through = max(self.committed_through, epoch)
            for e in [e for e in self._pending if e <= epoch]:
                del self._pending[e]
            for e in [e for e in self._copies if e <= epoch]:
                del self._copies[e]

    def drop_uncommitted_shards(self, sub: int) -> List[int]:
        """Sink-subtask failure: its pending shards lived with the task
        and are lost; recovery rebuilds them from replayed outputs."""
        self._settle_all()
        lost = []
        with self._lock:
            for e, txn in self._pending.items():
                if sub in txn.shards:
                    del txn.shards[sub]
                    lost.append(e)
        return sorted(lost)

    def rebuild_shard(self, epoch: int, sub: int,
                      records: np.ndarray) -> None:
        """Install a replay-reconstructed shard for (epoch, subtask), and
        persist it again if the epoch already sealed (the replayed bytes
        are bit-identical: abort and regenerate)."""
        with self._lock:
            if epoch <= self.committed_through:
                return
            txn = self._pending.setdefault(epoch, _Txn(epoch))
            txn.shards[sub] = [records]
            sealed = txn.sealed
        if sealed and self.pre_committer is not None:
            self.pre_committer(epoch, {sub: np.asarray(records, np.int32)})

    # --- introspection -------------------------------------------------------

    def pending_shards(self, epoch: int) -> Dict[int, np.ndarray]:
        """One epoch's accumulated per-subtask ``[n, 3]`` records."""
        self._settle(epoch)
        with self._lock:
            txn = self._pending.get(epoch)
            return self._merged_shards(txn) if txn is not None else {}

    def committed_stream(self) -> np.ndarray:
        """All committed records in commit order."""
        with self._lock:
            if not self.committed:
                return np.zeros((0, 3), np.int32)
            return np.concatenate([r for _, r in self.committed], axis=0)

    def pending_epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._pending)

    def sealed_epochs(self) -> List[int]:
        """Pending epochs already sealed (pre-committed, awaiting their
        checkpoint's completion)."""
        with self._lock:
            return sorted(e for e, t in self._pending.items() if t.sealed)
