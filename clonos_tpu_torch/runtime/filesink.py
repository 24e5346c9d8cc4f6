"""Durable filesystem egress behind the two-phase-commit sink (port of
``clonos_tpu/runtime/filesink.py``): exactly-once part files by
write-pending and atomic rename on commit.

- pre-commit (epoch seal): each subtask shard of the sealed epoch is
  written to ``part-<epoch>-<sub>-t<token>.pending`` before the
  checkpoint can complete;
- commit (checkpoint complete): each pending part is renamed to
  ``.final`` (``os.replace``); only ``.final`` files are output;
- abort: a sink-subtask failure rebuilds its shards from replay and the
  pending part is overwritten with the same bytes; a restart calls
  :meth:`FileSystemSink.sweep_pending`.

``token`` is the writer's incarnation number, baked into every part name:
a sweep only deletes parts at or below its own token, so a stale
incarnation sharing the root cannot delete a newer writer's parts.
Token-less names parse as token 0.

``fencing`` is a leadership handle with ``is_leader()`` (a
``runtime.leader.FileLeaderElection``): when set, every mutating
operation (pending write, commit, :meth:`FileSystemSink.sweep_pending`)
raises ``PermissionError`` unless this incarnation holds the lease, so a
deposed writer sharing the root cannot delete or certify the new
leader's parts.

``subtasks`` names the sink subtasks this writer owns (a rank's lanes
when the job is sharded over a mesh and every rank writes under one
root): its commits and sweeps touch only their parts, so two ranks never
rename or delete each other's. None owns every subtask.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class FileSystemSink:
    """One sink vertex's durable part-file store."""

    def __init__(self, root: str, fencing=None, token: int = 0,
                 subtasks: Optional[Sequence[int]] = None):
        self.root = root
        self.fencing = fencing
        self.token = int(token)
        self.subtasks = None if subtasks is None else set(subtasks)
        os.makedirs(root, exist_ok=True)

    def _mine(self, fn: str) -> bool:
        """True when part file ``fn`` is one of this writer's subtasks'."""
        return self.subtasks is None or (
            fn.startswith("part-") and self._parse(fn)[1] in self.subtasks)

    def _check_fencing(self, what: str) -> None:
        if self.fencing is not None and not self.fencing.is_leader():
            raise PermissionError(
                f"filesink {what} refused: this incarnation does not hold "
                f"the leadership lease for {self.root!r} — a fenced-off "
                f"writer must not mutate a sink root another incarnation "
                f"may be writing")

    def _part(self, epoch: int, sub: int, state: str) -> str:
        return os.path.join(
            self.root, f"part-{epoch}-{sub}-t{self.token}.{state}")

    @staticmethod
    def _parse(fn: str) -> Tuple[int, int, int]:
        """``(epoch, subtask, token)`` of a part filename."""
        fields = fn.split(".", 1)[0].split("-")
        epoch, sub = int(fields[1]), int(fields[2])
        token = 0
        if len(fields) > 3 and fields[3].startswith("t"):
            token = int(fields[3][1:])
        return epoch, sub, token

    def write_pending(self, epoch: int,
                      shards: Dict[int, np.ndarray]) -> None:
        """Pre-commit: persist every subtask shard of the sealed epoch
        (temp file + replace, so a crash never leaves a torn pending)."""
        self._check_fencing("write_pending")
        for sub, rows in shards.items():
            path = self._part(epoch, sub, "pending")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, np.asarray(rows, np.int32))
            os.replace(tmp, path)

    def commit(self, epoch: int, _rows: np.ndarray) -> None:
        """Checkpoint complete: the epoch's pendings at or below this
        writer's token become final, atomically."""
        self._check_fencing("commit")
        for fn in sorted(os.listdir(self.root)):
            if not (fn.startswith(f"part-{epoch}-")
                    and fn.endswith(".pending")) or not self._mine(fn):
                continue
            if self._parse(fn)[2] > self.token:
                continue
            src = os.path.join(self.root, fn)
            os.replace(src, src[:-len(".pending")] + ".final")

    def sweep_pending(self, keep_epochs: Sequence[int] = ()) -> List[str]:
        """Startup recovery: delete pendings whose epoch is not in
        ``keep_epochs`` (their checkpoint will never complete) and temp
        orphans. Parts above this writer's token are a newer
        incarnation's and stay; strictly older tokens always go. Returns
        the removed filenames."""
        self._check_fencing("sweep_pending")
        keep = set(keep_epochs)
        removed = []
        for fn in sorted(os.listdir(self.root)):
            if not self._mine(fn):
                continue
            if fn.endswith(".tmp"):
                if self._parse(fn)[2] <= self.token:
                    os.remove(os.path.join(self.root, fn))
                    removed.append(fn)
                continue
            if not fn.endswith(".pending"):
                continue
            epoch, _sub, token = self._parse(fn)
            if token > self.token:
                continue
            if token < self.token or epoch not in keep:
                os.remove(os.path.join(self.root, fn))
                removed.append(fn)
        return removed

    def committed_epochs(self) -> List[int]:
        return sorted({self._parse(fn)[0] for fn in os.listdir(self.root)
                       if fn.endswith(".final")})

    def read_committed(self) -> np.ndarray:
        """Every committed record in (epoch, subtask) order."""
        parts = sorted(self._parse(fn)[:2] + (fn,)
                       for fn in os.listdir(self.root)
                       if fn.endswith(".final"))
        rows = [np.load(os.path.join(self.root, fn)) for _e, _s, fn in parts]
        rows = [r for r in rows if r.shape[0]]
        return (np.concatenate(rows, axis=0) if rows
                else np.zeros((0, 3), np.int32))
