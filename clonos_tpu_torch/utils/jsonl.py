"""Durable JSONL: one reader rule, one writer discipline (port of
``clonos_tpu/utils/jsonl.py``).

Every append-only log (the checkpoint ledger, the metrics history ring,
flight-recorder traces) shares one crash model: a killed writer leaves
at most one torn final record. The reader rule
(:func:`parse_jsonl_lines`, :func:`read_jsonl`, :func:`iter_jsonl`):

- blank lines are skipped;
- a decode failure on the LAST non-empty line is the expected kill
  artifact and is dropped silently;
- a decode failure on any earlier line is real corruption and raises —
  ``json.JSONDecodeError`` by default, or ``ValueError`` naming
  ``<label>:<lineno>`` when the caller passes ``label``.

The writer discipline (:class:`JsonlAppender`,
:func:`atomic_rewrite_jsonl`):

- one lazily opened append handle per file, every record flushed to the
  OS as it lands (a clean exit loses nothing, a kill at most the line
  being written);
- an explicit fsync policy per log: ``fsync_every=0`` (flush only, the
  observability logs) or a group commit every K appends with
  :meth:`JsonlAppender.sync` at durability points (the ledger's);
- whole-file rewrites (compaction, last wins) go through
  :func:`atomic_rewrite_jsonl`: tmp + fsync + ``os.replace``, so a crash
  mid-rewrite leaves the old file or the new one, never a mix.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterable, Iterator, List, Optional, Sequence


def parse_jsonl_lines(lines: Sequence[str],
                      label: Optional[str] = None) -> List[dict]:
    """Decode JSONL lines under the torn-tail rule above."""
    nonempty = [(i, ln) for i, ln in enumerate(lines) if ln.strip()]
    out: List[dict] = []
    for pos, (i, ln) in enumerate(nonempty):
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            if pos == len(nonempty) - 1:
                break        # torn final append
            if label is not None:
                raise ValueError(
                    f"{label}:{i + 1}: undecodable record "
                    f"(not a truncated tail)")
            raise
    return out


def read_jsonl(path: str, label: Optional[str] = None) -> List[dict]:
    """Read a JSONL file tail-tolerantly; a missing file is an empty log
    (the first append creates it)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().splitlines()
    return parse_jsonl_lines(lines, label=label)


def iter_jsonl(path: str, label: Optional[str] = None) -> Iterator[dict]:
    """Stream a JSONL file record by record under the same torn-tail
    rule, holding O(1) lines in memory."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        lineno = 0
        for ln in f:
            lineno += 1
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                # Torn tail only if nothing non-empty follows.
                if not any(rest.strip() for rest in f):
                    return
                if label is not None:
                    raise ValueError(
                        f"{label}:{lineno}: undecodable record "
                        f"(not a truncated tail)")
                raise
            yield rec


class JsonlAppender:
    """The one durable JSONL append handle.

    Lazily opens ``path`` for append on the first record; every
    :meth:`append` writes one ``json.dumps`` line and flushes it to the
    OS. ``fsync_every=K`` batches the fsync every K appends (the ledger's
    group commit); ``fsync_every=0`` never fsyncs on its own. Either way
    :meth:`sync` forces the tail durable at an explicit durability point.
    Thread-safe; ``sort_keys`` and ``default`` are fixed per log so every
    append of a log encodes the same way."""

    def __init__(self, path: str, *, sort_keys: bool = False,
                 default=None, fsync_every: int = 0):
        self.path = path
        self._sort_keys = bool(sort_keys)
        self._default = default
        self.fsync_every = int(fsync_every)
        self._file = None
        self._unsynced = 0
        self._lock = threading.Lock()
        #: lines appended through this handle (compaction triggers)
        self.appended = 0

    def append(self, rec) -> None:
        line = json.dumps(rec, sort_keys=self._sort_keys,
                          default=self._default) + "\n"
        with self._lock:
            if self._file is None:
                self._file = open(self.path, "a")
            self._file.write(line)
            self._file.flush()
            self.appended += 1
            self._unsynced += 1
            if self.fsync_every and self._unsynced >= self.fsync_every:
                os.fsync(self._file.fileno())
                self._unsynced = 0

    @property
    def unsynced(self) -> int:
        """Appends flushed but not yet fsynced: the group-commit window a
        kill of the host could still lose."""
        return self._unsynced

    def sync(self) -> None:
        """fsync any unsynced tail (a durability point: checkpoint
        completion)."""
        with self._lock:
            if self._file is not None and self._unsynced:
                os.fsync(self._file.fileno())
                self._unsynced = 0

    def close(self, sync: bool = True) -> None:
        """Close the handle (fsyncing the tail unless told not to);
        appending again reopens it. Compaction swaps the inode under the
        handle (:func:`atomic_rewrite_jsonl`), so the handle must drop."""
        with self._lock:
            if self._file is not None:
                if sync and self._unsynced:
                    os.fsync(self._file.fileno())
                self._unsynced = 0
                self._file.close()
                self._file = None


def atomic_rewrite_jsonl(path: str, records: Iterable[dict], *,
                         sort_keys: bool = False, default=None) -> int:
    """Replace ``path`` with exactly ``records``, atomically: write a
    sibling tmp, flush + fsync it, then ``os.replace``. Returns the record
    count. A :class:`JsonlAppender` on ``path`` must be closed first (the
    inode swaps)."""
    tmp = path + ".tmp"
    n = 0
    with open(tmp, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=sort_keys,
                               default=default) + "\n")
            n += 1
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return n
