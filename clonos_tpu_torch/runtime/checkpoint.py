"""Checkpoint coordination: epoch fences, snapshots, truncation, standby
push, the audit ledger (port of ``clonos_tpu/runtime/checkpoint.py``).

- A checkpoint IS an epoch fence: the coordinator triggers at superstep
  boundaries, so the lockstep superstep is the aligned barrier.
- In-memory storage keeps the fence snapshot's device tensors (the
  executor's ``lean_snapshot`` is a deep copy, so holding it is a
  consistent snapshot with no device-to-host copy); file storage pickles
  a numpy tree.
- Writes are asynchronous by default: a writer thread per trigger, the
  storage serialised by ``_writer_lock`` and the pending/ignored/completed
  books by ``_state_lock``. The snapshot's device-to-host copy is started
  on the triggering thread (``device.HostCopy``) and the writer only waits
  for it, so a writer never queues CUDA work behind later blocks. A
  storage that diffs on the device (``runtime/incremental.py``) stages
  its device work on the triggering thread too (:class:`StagedWrite`).
- Completion (all acks in, snapshot durable) has exactly one completer,
  whichever thread gets there first: it fsyncs the ledger, marks the
  checkpoint complete, truncates the causal and in-flight logs back to
  the fence, pushes the completed state to the standbys and compacts the
  ledger below the fence. A pending checkpoint a dead task never acked is
  ignored and never completes.
- The per-epoch audit ledger lives next to the checkpoints; a file
  storage writes ``ledger.jsonl`` in the reference's line format (one
  ``json.dumps(entry, sort_keys=True)`` line per sealed epoch), group-
  committed: every line flushed at once, an fsync every
  ``ledger_group_commit`` appends and at completion.
- With a tracer configured (``obs/trace.py``): a ``checkpoint.trigger``
  event at the trigger, a ``checkpoint`` span over trigger-to-complete
  (with ``size_bytes``) and a ``checkpoint.truncate`` event at
  completion.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from clonos_tpu_torch.device import HostCopy
from clonos_tpu_torch.obs.trace import get_tracer
from clonos_tpu_torch.utils.jsonl import JsonlAppender, atomic_rewrite_jsonl
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class CompletedCheckpoint:
    """An epoch-boundary snapshot."""

    checkpoint_id: int          # == the epoch it fences (epoch e ends here)
    carry: Any                  # LeanSnapshot (tensors, or numpy on disk)
    wall_time: float
    size_bytes: int = 0


class StagedWrite:
    """A checkpoint write whose device work was dispatched on the thread
    that queued the snapshot's work (:meth:`CheckpointStorage.stage`).
    :meth:`finish` runs on that thread too, once, before the storage's
    ``write`` may complete; ``write`` itself may run on any thread and
    only waits. :meth:`discard` drops a write that will never happen."""

    #: bytes of the staged snapshot
    nbytes = 0

    def finish(self) -> None:
        raise NotImplementedError

    def discard(self) -> None:
        """The checkpoint was ignored before its write."""


class CheckpointStorage:
    """Storage SPI."""

    #: True = the coordinator hands the storage a numpy tree (durable
    #: storage). False = the storage keeps device tensors, or stages its
    #: own copies (:meth:`stage`).
    wants_host = True

    def stage(self, carry, checkpoint_id: int) -> Optional[StagedWrite]:
        """Start checkpoint ``checkpoint_id``'s device work on the calling
        thread; None when the storage has none (it takes ``carry`` as it
        is)."""
        return None

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

    def completed_ids(self) -> List[int]:
        """Ids of the fully acked checkpoints storage holds (a standby
        host tells restore points from triggered-only snapshots here)."""
        return sorted(c for c in self.list_ids()
                      if os.path.exists(self._path(c) + ".done"))

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

    def completed_ids(self) -> List[int]:
        return sorted(self._complete & set(self._store))


class FileCheckpointStorage(CheckpointStorage):
    """One file per checkpoint (pickle of the numpy tree) and an append-
    only ``ledger.jsonl``; deletion reclaims space like subsumed-
    checkpoint disposal."""

    #: group-commit width: fsync the ledger every K appends (and at every
    #: checkpoint completion / explicit flush). The crash window is at
    #: most K-1 sealed-but-unsynced lines plus one torn line, all at the
    #: tail, which the tolerant reader already drops.
    ledger_group_commit = 8

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._ledger_w: Optional[JsonlAppender] = None

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
        """Append one JSON line per sealed epoch through the durable
        appender (``utils/jsonl``): every line is flushed to the OS at
        once, the fsync is batched every ``ledger_group_commit`` appends,
        and completion calls :meth:`flush_ledger`, so a durable checkpoint
        never outruns its sealed entries."""
        if self._ledger_w is None:
            self._ledger_w = JsonlAppender(
                self.ledger_path(), sort_keys=True,
                fsync_every=self.ledger_group_commit)
        self._ledger_w.append(entry)

    @property
    def _ledger_unsynced(self) -> int:
        """Sealed-but-unsynced tail lines in the group-commit window (0
        with no appender open)."""
        return self._ledger_w.unsynced if self._ledger_w is not None \
            else 0

    def flush_ledger(self) -> None:
        if self._ledger_w is not None:
            self._ledger_w.sync()

    def _close_ledger(self) -> None:
        if self._ledger_w is not None:
            self._ledger_w.close()
            self._ledger_w = None

    def read_ledger(self) -> List[dict]:
        return read_ledger_file(self.ledger_path())

    def compact_ledger(self, below_epoch: int) -> int:
        """Atomic last-wins rewrite of the entries below the fence
        (``atomic_rewrite_jsonl``: a crash leaves the old file or the new
        one, never a mix)."""
        path = self.ledger_path()
        self._close_ledger()          # os.replace swaps the inode under us
        entries = read_ledger_file(path)
        if not entries:
            return 0
        compacted = compact_ledger_entries(entries, below_epoch)
        dropped = len(entries) - len(compacted)
        if dropped == 0:
            return 0
        atomic_rewrite_jsonl(path, compacted, sort_keys=True)
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


def snapshot_subtask_slice(snapshot, vertex_id: int, subtask: int) -> Any:
    """The one-subtask slice of a snapshot's vertex state — what a
    recovery on a sharded job restores (the failed subtask's row of the
    ``[P, ...]`` tree) while healthy shards keep their live buffers. A
    tree of ``[1, ...]`` leaves; scalar leaves pass whole."""
    return tree_map(lambda x: x[subtask][None]
                    if len(getattr(x, "shape", ())) > 0 else x,
                    snapshot.op_states[vertex_id])


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
    checkpoint un-acked and ignore it, as the reference does.

    Thread safety: the caller's thread, a pipelined fence worker and the
    writer threads all reach ``_maybe_complete``; ``_state_lock`` guards
    the books (never held while calling listeners or storage) and
    ``_writer_lock`` every storage call."""

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
        self._writer_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._async_threads: List[threading.Thread] = []
        #: ``fn(kind, **fields)`` on every protocol transition (trigger /
        #: ack / complete / ignore / discard); completion may fire them on
        #: a writer thread, so keep them cheap and host-only.
        self.transition_observers: List[Callable[..., None]] = []
        self._trigger_wall: Dict[int, float] = {}     # cid -> trigger time
        #: cid -> trigger-to-complete seconds (the runner's
        #: ``checkpoint.trigger-to-complete-ms`` histogram reads it)
        self.completion_latency_s: Dict[int, float] = {}

    def _observe(self, kind: str, **fields) -> None:
        for fn in self.transition_observers:
            fn(kind, **fields)

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
                async_write: bool = True, owned: bool = False) -> None:
        """Fence checkpoint ``checkpoint_id`` over ``carry`` (the state
        exactly at the epoch boundary). With ``async_write`` a writer
        thread makes it durable (:meth:`drain` waits for it).

        Durable storage gets a numpy tree: the device-to-host copy starts
        here, on the calling thread, behind the work that produced the
        carry (or ``carry`` is a ``device.HostCopy`` the caller started,
        as the pipelined fence does on its main thread). Device-kept
        storage holds the tensors; ``owned=True`` promises nothing else
        will mutate them (``lean_snapshot``'s deep copy), otherwise they
        are cloned here."""
        with self._state_lock:
            ignored = checkpoint_id in self._ignored
            if not ignored:
                self._pending[checkpoint_id] = set(range(self.num_subtasks))
                # clonos: allow(wallclock): trigger->complete latency metric
                self._trigger_wall[checkpoint_id] = time.time()
        if ignored:
            if isinstance(carry, StagedWrite):
                carry.discard()
            return
        self._observe("trigger", cid=checkpoint_id)
        get_tracer().event("checkpoint.trigger", cid=checkpoint_id,
                           subtasks=self.num_subtasks)
        snap_start = time.monotonic()
        if self.storage.wants_host:
            if not isinstance(carry, HostCopy):
                carry = HostCopy(carry)
        elif not isinstance(carry, StagedWrite):
            staged = self.storage.stage(carry, checkpoint_id)
            if staged is not None:
                staged.finish()
                carry = staged
            elif not owned:
                carry = tree_map(_copy_leaf, carry)

        def _write():
            host = carry.wait() if isinstance(carry, HostCopy) else carry
            size = (carry.nbytes if isinstance(carry, StagedWrite)
                    else carry_nbytes(host))
            ckpt = CompletedCheckpoint(
                checkpoint_id=checkpoint_id, carry=host,
                wall_time=snap_start, size_bytes=size)
            with self._writer_lock:
                self.storage.write(ckpt)
            self._maybe_complete(checkpoint_id)

        if async_write:
            t = threading.Thread(target=_write, name="checkpoint-writer",
                                 daemon=True)
            self._async_threads.append(t)
            t.start()
        else:
            _write()

    def ack(self, checkpoint_id: int, subtask: int) -> None:
        with self._state_lock:
            missing = self._pending.get(checkpoint_id)
            if missing is None:
                return
            missing.discard(subtask)
        self._observe("ack", cid=checkpoint_id, subtask=subtask)
        self._maybe_complete(checkpoint_id)

    def ack_all(self, checkpoint_id: int,
                except_subtasks: Tuple[int, ...] = ()) -> None:
        with self._state_lock:
            missing = self._pending.get(checkpoint_id)
            if missing is None:
                return
            acked = missing - set(except_subtasks)
            missing.intersection_update(except_subtasks)
        for subtask in sorted(acked):
            self._observe("ack", cid=checkpoint_id, subtask=subtask)
        self._maybe_complete(checkpoint_id)

    def discard_pending_through(self, checkpoint_id: int) -> List[int]:
        """Abandon every pending checkpoint at or below ``checkpoint_id``
        (superseded fences that must never complete late). Returns the
        abandoned ids."""
        with self._state_lock:
            cids = sorted(c for c in self._pending if c <= checkpoint_id)
            for cid in cids:
                self._ignored.add(cid)
                del self._pending[cid]
        for cid in cids:
            self._observe("discard", cid=cid)
        return cids

    def _maybe_complete(self, checkpoint_id: int) -> None:
        with self._state_lock:
            if self._pending.get(checkpoint_id):
                return
        try:
            with self._writer_lock:
                ckpt = self.storage.read(checkpoint_id)
        except (KeyError, FileNotFoundError):
            return      # not durable yet: the writer completes it
        # The atomic check-and-remove elects exactly one completer.
        with self._state_lock:
            if checkpoint_id not in self._pending:
                return
            del self._pending[checkpoint_id]
            self._completed_ids.append(checkpoint_id)
            trig = self._trigger_wall.pop(checkpoint_id, None)
        self._observe("complete", cid=checkpoint_id)
        # A durable completion marker never outruns the sealed entries it
        # certifies.
        with self._writer_lock:
            self.storage.flush_ledger()
            try:
                self.storage.mark_complete(checkpoint_id)
            except NotImplementedError:
                pass
        tr = get_tracer()
        if trig is not None:
            # clonos: allow(wallclock): completion latency metric
            lat = time.time() - trig
            with self._state_lock:
                self.completion_latency_s[checkpoint_id] = lat
                while len(self.completion_latency_s) > 64:
                    del self.completion_latency_s[
                        min(self.completion_latency_s)]
            tr.complete("checkpoint", lat, cid=checkpoint_id,
                        size_bytes=ckpt.size_bytes)
        # clonos: allow(join-discipline): completion listeners are
        # registered during wiring, before the fence/writer threads
        # start (pre-start publication across functions, which the race
        # pass only models within the spawning function); the list is
        # append-only and never mutated after start.
        for fn in self._complete_listeners:
            fn(checkpoint_id)
        tr.event("checkpoint.truncate", cid=checkpoint_id)
        # clonos: allow(join-discipline): truncation listeners are
        # registered during wiring, before any worker thread exists;
        # append-only, never mutated after start.
        for fn in self._listeners:
            fn(ckpt)
        self._retain()
        # Completion == truncation time: collapse re-sealed ledger
        # duplicates below this fence.
        with self._writer_lock:
            self.storage.compact_ledger(checkpoint_id)

    def _retain(self) -> None:
        with self._state_lock:
            old = []
            while len(self._completed_ids) > self.max_retained:
                old.append(self._completed_ids.pop(0))
        for cid in old:
            with self._writer_lock:
                self.storage.delete(cid)

    def drain(self) -> None:
        """Wait for every asynchronous write started so far."""
        while self._async_threads:
            self._async_threads.pop(0).join()

    # --- epoch audit ledger --------------------------------------------------

    def record_ledger(self, entry: dict) -> None:
        """Persist one sealed epoch digest next to the checkpoints."""
        with self._writer_lock:
            self.storage.write_ledger(entry)

    def read_ledger(self) -> List[dict]:
        """All persisted ledger entries in append order (duplicates
        resolve last-wins at the consumer)."""
        with self._writer_lock:
            return self.storage.read_ledger()

    # --- failure-path hooks --------------------------------------------------

    def mark_ignored(self, checkpoint_ids) -> None:
        """Adopt replayed IGNORE_CHECKPOINT decisions (standby bootstrap):
        these ids never trigger or complete here."""
        with self._state_lock:
            self._ignored.update(checkpoint_ids)

    def ignore_unacked_for(self, failed_subtasks: Set[int]) -> List[int]:
        """A task died: any pending checkpoint still missing one of its
        acks can never complete — mark it ignored. Returns the ignored
        ids (broadcast as IGNORE_CHECKPOINT determinants)."""
        with self._state_lock:
            dead = [cid for cid, missing in self._pending.items()
                    if missing & set(failed_subtasks)]
            for cid in dead:
                self._ignored.add(cid)
                del self._pending[cid]
        for cid in dead:
            self._observe("ignore", cid=cid)
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
        with self._state_lock:
            return self._completed_ids[-1] if self._completed_ids else None

    def latest_completed(self) -> Optional[CompletedCheckpoint]:
        cid = self.latest_completed_id
        if cid is None:
            return None
        with self._writer_lock:
            return self.storage.read(cid)
