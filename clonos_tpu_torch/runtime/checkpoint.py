"""Checkpoint coordination: epoch fences, snapshots, truncation, standby
push, the audit ledger (port of ``clonos_tpu/runtime/checkpoint.py``,
synchronous writes only).

- A checkpoint IS an epoch fence: the coordinator triggers at superstep
  boundaries, so the lockstep superstep is the aligned barrier.
- In-memory storage keeps the fence snapshot's device tensors (the
  executor's ``lean_snapshot`` is a deep copy, so holding it is a
  consistent snapshot with no device-to-host copy); file storage pickles
  a numpy tree (``convert.carry_to_numpy``).
- Completion truncates the causal and in-flight logs back to the fence
  and pushes the completed state to the standbys; a pending checkpoint a
  dead task never acked is ignored and never completes.
- The per-epoch audit ledger lives next to the checkpoints; a file
  storage writes ``ledger.jsonl`` in the reference's line format (one
  ``json.dumps(entry, sort_keys=True)`` line per sealed epoch).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class CompletedCheckpoint:
    """An epoch-boundary snapshot."""

    checkpoint_id: int          # == the epoch it fences (epoch e ends here)
    carry: Any                  # LeanSnapshot (tensors, or numpy on disk)
    wall_time: float
    size_bytes: int = 0


class CheckpointStorage:
    """Storage SPI."""

    #: True = the coordinator hands the storage a numpy tree (durable
    #: storage). False = the storage keeps device tensors.
    wants_host = True

    def write(self, ckpt: CompletedCheckpoint) -> None:
        raise NotImplementedError

    def read(self, checkpoint_id: int) -> CompletedCheckpoint:
        raise NotImplementedError

    def delete(self, checkpoint_id: int) -> None:
        raise NotImplementedError

    def list_ids(self) -> List[int]:
        raise NotImplementedError

    def _path(self, checkpoint_id: int) -> str:
        raise NotImplementedError

    def mark_complete(self, checkpoint_id: int) -> None:
        """Durable completion marker: snapshots are written at trigger,
        but only fully-acked checkpoints are restore points."""
        with open(self._path(checkpoint_id) + ".done", "wb"):
            pass

    # --- epoch audit ledger (in memory by default) ---------------------------

    def write_ledger(self, entry: dict) -> None:
        if not hasattr(self, "_ledger"):
            self._ledger: List[dict] = []
        self._ledger.append(dict(entry))

    def flush_ledger(self) -> None:
        """Make every appended ledger entry durable now."""

    def read_ledger(self) -> List[dict]:
        return [dict(e) for e in getattr(self, "_ledger", [])]

    def compact_ledger(self, below_epoch: int) -> int:
        """Collapse entries for epochs below ``below_epoch`` to one per
        epoch, last wins. Returns the number of entries dropped."""
        led = getattr(self, "_ledger", None)
        if not led:
            return 0
        compacted = compact_ledger_entries(led, below_epoch)
        dropped = len(led) - len(compacted)
        if dropped:
            self._ledger = compacted
        return dropped


class InMemoryCheckpointStorage(CheckpointStorage):
    wants_host = False

    def __init__(self):
        self._store: Dict[int, CompletedCheckpoint] = {}
        self._complete: set = set()

    def write(self, ckpt: CompletedCheckpoint) -> None:
        self._store[ckpt.checkpoint_id] = ckpt

    def read(self, checkpoint_id: int) -> CompletedCheckpoint:
        return self._store[checkpoint_id]

    def delete(self, checkpoint_id: int) -> None:
        self._store.pop(checkpoint_id, None)
        self._complete.discard(checkpoint_id)

    def list_ids(self) -> List[int]:
        return sorted(self._store)

    def mark_complete(self, checkpoint_id: int) -> None:
        self._complete.add(checkpoint_id)


class FileCheckpointStorage(CheckpointStorage):
    """One file per checkpoint (pickle of the numpy tree) and an append-
    only ``ledger.jsonl``; deletion reclaims space like subsumed-
    checkpoint disposal."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._ledger_file = None

    def _path(self, cid: int) -> str:
        return os.path.join(self.root, f"chk_{cid}.pkl")

    def write(self, ckpt: CompletedCheckpoint) -> None:
        tmp = self._path(ckpt.checkpoint_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(ckpt, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._path(ckpt.checkpoint_id))

    def read(self, checkpoint_id: int) -> CompletedCheckpoint:
        with open(self._path(checkpoint_id), "rb") as f:
            return pickle.load(f)

    def delete(self, checkpoint_id: int) -> None:
        for p in (self._path(checkpoint_id),
                  self._path(checkpoint_id) + ".done"):
            try:
                os.remove(p)
            except OSError:
                pass

    def list_ids(self) -> List[int]:
        return sorted(int(fn[4:-4]) for fn in os.listdir(self.root)
                      if fn.startswith("chk_") and fn.endswith(".pkl"))

    def ledger_path(self) -> str:
        return os.path.join(self.root, "ledger.jsonl")

    def write_ledger(self, entry: dict) -> None:
        """Append one JSON line per sealed epoch, flushed to the OS at
        once; :meth:`flush_ledger` fsyncs (checkpoint completion)."""
        if self._ledger_file is None:
            self._ledger_file = open(self.ledger_path(), "a")
        self._ledger_file.write(json.dumps(entry, sort_keys=True) + "\n")
        self._ledger_file.flush()

    def flush_ledger(self) -> None:
        if self._ledger_file is not None:
            os.fsync(self._ledger_file.fileno())

    def _close_ledger(self) -> None:
        if self._ledger_file is not None:
            self.flush_ledger()
            self._ledger_file.close()
            self._ledger_file = None

    def read_ledger(self) -> List[dict]:
        return read_ledger_file(self.ledger_path())

    def compact_ledger(self, below_epoch: int) -> int:
        """Atomic last-wins rewrite of the entries below the fence (a
        crash leaves the old file or the new one, never a mix)."""
        path = self.ledger_path()
        self._close_ledger()          # os.replace swaps the inode under us
        entries = read_ledger_file(path)
        compacted = compact_ledger_entries(entries, below_epoch)
        dropped = len(entries) - len(compacted)
        if dropped == 0:
            return 0
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for e in compacted:
                f.write(json.dumps(e, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return dropped


def compact_ledger_entries(entries: List[dict],
                           below_epoch: int) -> List[dict]:
    """Entries for epochs < ``below_epoch`` collapse to one per epoch
    (last wins), in epoch order; everything else keeps its append order
    after them."""
    last: Dict[int, dict] = {}
    tail: List[dict] = []
    for e in entries:
        try:
            ep: Optional[int] = int(e["epoch"])
        except (KeyError, TypeError, ValueError):
            ep = None
        if ep is not None and ep < below_epoch:
            last[ep] = e
        else:
            tail.append(e)
    return [last[ep] for ep in sorted(last)] + tail


def read_ledger_file(path: str) -> List[dict]:
    """Read a ledger.jsonl, tolerating a torn final line (a kill mid
    append); a decode failure on any earlier line raises. A missing file
    is an empty ledger."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    out: List[dict] = []
    for i, ln in enumerate(lines):
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise
    return out


def carry_nbytes(carry) -> int:
    """Bytes of a carry's leaves (tensors or numpy arrays)."""
    total = 0
    for x in tree_leaves(carry):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return total


def snapshot_subtask_nbytes(snapshot, vertex_id: int, subtask: int) -> int:
    """Bytes of one subtask's row of a snapshot's vertex state — what a
    shard-local restore moves, against :func:`carry_nbytes` of the whole
    snapshot."""
    total = 0
    for x in tree_leaves(snapshot.op_states[vertex_id]):
        n = carry_nbytes(x)
        n0 = x.shape[0] if len(getattr(x, "shape", ())) > 0 else 1
        total += n // max(1, n0)
    return total


def _copy_leaf(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    return np.array(x, copy=True)


class CheckpointCoordinator:
    """Host control plane for checkpoints.

    ``num_subtasks`` flat subtask ids are expected to ack. In the single-
    program executor all healthy subtasks ack at the fence in one call;
    the per-subtask ledger exists so the failure path can leave a pending
    checkpoint un-acked and ignore it, as the reference does."""

    def __init__(self, storage: CheckpointStorage,
                 num_subtasks: int,
                 max_retained: int = 2,
                 base_interval_steps: int = 16,
                 backoff_multiplier: float = 2.0,
                 max_backoff_steps: int = 256):
        self.storage = storage
        self.num_subtasks = num_subtasks
        self.max_retained = max_retained
        self.base_interval_steps = base_interval_steps
        self.backoff_multiplier = backoff_multiplier
        self.max_backoff_steps = max_backoff_steps
        self._interval_steps = base_interval_steps
        self._pending: Dict[int, Set[int]] = {}       # cid -> missing acks
        self._ignored: Set[int] = set()
        self._completed_ids: List[int] = []
        self._listeners: List[Callable[[CompletedCheckpoint], None]] = []
        self._complete_listeners: List[Callable[[int], None]] = []

    # --- listener registration ----------------------------------------------

    def subscribe_completed_state(
            self, fn: Callable[[CompletedCheckpoint], None]) -> None:
        """Standby state dispatch: ``fn`` receives every newly completed
        checkpoint."""
        self._listeners.append(fn)

    def subscribe_completion(self, fn: Callable[[int], None]) -> None:
        """Log-truncation hook: ``fn(checkpoint_id)`` after durability."""
        self._complete_listeners.append(fn)

    # --- trigger / ack / complete -------------------------------------------

    def trigger(self, checkpoint_id: int, carry,
                async_write: bool = False, owned: bool = False) -> None:
        """Fence checkpoint ``checkpoint_id`` over ``carry`` (the state
        exactly at the epoch boundary), written synchronously.
        ``owned=True`` promises nothing else will mutate the buffers (e.g.
        ``lean_snapshot``'s deep copy); otherwise device-kept storage
        copies them."""
        if async_write:
            raise NotImplementedError(
                "asynchronous checkpoint writes come with a later slice of "
                "the port")
        if checkpoint_id in self._ignored:
            return
        self._pending[checkpoint_id] = set(range(self.num_subtasks))
        if self.storage.wants_host:
            carry = carry_to_numpy(carry)
        elif not owned:
            carry = tree_map(_copy_leaf, carry)
        self.storage.write(CompletedCheckpoint(
            checkpoint_id=checkpoint_id, carry=carry,
            wall_time=time.monotonic(), size_bytes=carry_nbytes(carry)))
        self._maybe_complete(checkpoint_id)

    def ack(self, checkpoint_id: int, subtask: int) -> None:
        missing = self._pending.get(checkpoint_id)
        if missing is None:
            return
        missing.discard(subtask)
        self._maybe_complete(checkpoint_id)

    def ack_all(self, checkpoint_id: int,
                except_subtasks: Tuple[int, ...] = ()) -> None:
        missing = self._pending.get(checkpoint_id)
        if missing is None:
            return
        missing.intersection_update(except_subtasks)
        self._maybe_complete(checkpoint_id)

    def discard_pending_through(self, checkpoint_id: int) -> List[int]:
        """Abandon every pending checkpoint at or below ``checkpoint_id``
        (superseded fences that must never complete late). Returns the
        abandoned ids."""
        cids = sorted(c for c in self._pending if c <= checkpoint_id)
        for cid in cids:
            self._ignored.add(cid)
            del self._pending[cid]
        return cids

    def _maybe_complete(self, checkpoint_id: int) -> None:
        if self._pending.get(checkpoint_id):
            return
        if checkpoint_id not in self._pending:
            return
        try:
            ckpt = self.storage.read(checkpoint_id)
        except (KeyError, FileNotFoundError):
            return
        del self._pending[checkpoint_id]
        self._completed_ids.append(checkpoint_id)
        # A durable completion marker never outruns the sealed entries it
        # certifies.
        self.storage.flush_ledger()
        try:
            self.storage.mark_complete(checkpoint_id)
        except NotImplementedError:
            pass
        for fn in self._complete_listeners:
            fn(checkpoint_id)
        for fn in self._listeners:
            fn(ckpt)
        self._retain()
        self.storage.compact_ledger(checkpoint_id)

    def _retain(self) -> None:
        while len(self._completed_ids) > self.max_retained:
            self.storage.delete(self._completed_ids.pop(0))

    # --- epoch audit ledger --------------------------------------------------

    def record_ledger(self, entry: dict) -> None:
        """Persist one sealed epoch digest next to the checkpoints."""
        self.storage.write_ledger(entry)

    def read_ledger(self) -> List[dict]:
        """All persisted ledger entries in append order (duplicates
        resolve last-wins at the consumer)."""
        return self.storage.read_ledger()

    # --- failure-path hooks --------------------------------------------------

    def ignore_unacked_for(self, failed_subtasks: Set[int]) -> List[int]:
        """A task died: any pending checkpoint still missing one of its
        acks can never complete — mark it ignored. Returns the ignored
        ids (broadcast as IGNORE_CHECKPOINT determinants)."""
        dead = [cid for cid, missing in self._pending.items()
                if missing & set(failed_subtasks)]
        for cid in dead:
            self._ignored.add(cid)
            del self._pending[cid]
        return sorted(dead)

    def backoff(self) -> int:
        """Stretch the checkpoint interval during recovery. Returns the
        new interval in supersteps."""
        self._interval_steps = min(
            int(self._interval_steps * self.backoff_multiplier),
            self.max_backoff_steps)
        return self._interval_steps

    def reset_interval(self) -> int:
        self._interval_steps = self.base_interval_steps
        return self._interval_steps

    @property
    def interval_steps(self) -> int:
        return self._interval_steps

    @property
    def latest_completed_id(self) -> Optional[int]:
        return self._completed_ids[-1] if self._completed_ids else None

    def latest_completed(self) -> Optional[CompletedCheckpoint]:
        cid = self.latest_completed_id
        return None if cid is None else self.storage.read(cid)
