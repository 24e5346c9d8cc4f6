"""Feed readers: the external-ingestion boundary (port of
``clonos_tpu/api/feeds.py``).

A feed is rewindable, partitioned and of bounded retention, the contract
a Kafka consumer gives its stream processor:

- ``pull(subtask, max_n)``        — live: up to ``max_n`` records from the
                                    partition's cursor;
- ``pull_block(subtask, b, k)``   — live hot path: k steps' worth of pulls
                                    as dense ``[k, b]`` arrays;
- ``read_at(subtask, offset, n)`` — recovery: re-read an exact range (the
                                    offset is checkpointed operator state,
                                    the per-step counts are BUFFER_BUILT
                                    determinants);
- ``notify_checkpoint_complete``  — offsets up to a completed checkpoint
                                    are committed; retention below them
                                    may be released.

Reading below a partition's retention floor raises
:class:`RetentionExpiredError` at the exact offset, never a wrong answer.
Readers return host ints or numpy arrays; timestamps are stamped by the
operator from causal time.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


class RetentionExpiredError(ValueError):
    """A re-read landed below a partition's retention floor: the records
    were dropped before a checkpoint committed past them."""


class FeedReader:
    def pull(self, subtask: int, max_n: int) -> Tuple[List[int], List[int]]:
        raise NotImplementedError

    def read_at(self, subtask: int, offset: int, n: int
                ) -> Tuple[List[int], List[int]]:
        raise NotImplementedError

    def pull_block(self, subtask: int, batch: int, k: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """k consecutive pulls as dense arrays: (keys [k, batch] int32,
        values [k, batch] int32, counts [k] int32). Default: a loop over
        :meth:`pull`; array-backed readers override it with a slice."""
        ks = np.zeros((k, batch), np.int32)
        vs = np.zeros((k, batch), np.int32)
        counts = np.zeros((k,), np.int32)
        for i in range(k):
            kk, vv = self.pull(subtask, batch)
            n = len(kk)
            ks[i, :n], vs[i, :n], counts[i] = kk, vv, n
        return ks, vs, counts

    def notify_checkpoint_complete(self, offsets: Sequence[int]) -> None:
        """``offsets[subtask]`` are durably checkpointed: recovery never
        re-reads below them. Default: no-op (infinite retention)."""


def _floor_check(base: int, subtask: int, offset: int) -> None:
    if offset < base:
        raise RetentionExpiredError(
            f"partition {subtask}: offset {offset} is below the "
            f"retention floor {base} — records expired before a "
            f"checkpoint committed past them")


class _RetainedPartitions:
    """Bounded-retention core: per-partition record lists with a base
    offset; offsets are absolute (monotone across truncation)."""

    def __init__(self, num_parts: int, retention: Optional[int]):
        self._parts: List[List[Tuple[int, int]]] = [
            [] for _ in range(num_parts)]
        self._base = [0] * num_parts
        self._cursor = [0] * num_parts
        self.retention = retention

    def _check_floor(self, subtask: int, offset: int) -> None:
        _floor_check(self._base[subtask], subtask, offset)

    def _slice(self, subtask: int, offset: int, n: int):
        self._check_floor(subtask, offset)
        lo = offset - self._base[subtask]
        chunk = self._parts[subtask][lo: lo + n]
        if len(chunk) != n:
            raise ValueError(
                f"feed partition {subtask} cannot serve [{offset}, "
                f"{offset + n}): only {len(chunk)} records available")
        return chunk

    def truncate_below(self, subtask: int, offset: int) -> None:
        drop = offset - self._base[subtask]
        if drop > 0:
            del self._parts[subtask][:drop]
            self._base[subtask] = offset

    def _enforce_retention(self, subtask: int) -> None:
        # Only the newest ``retention`` records per partition survive.
        if self.retention is None:
            return
        excess = len(self._parts[subtask]) - self.retention
        if excess > 0:
            self.truncate_below(subtask, self._base[subtask] + excess)

    def commit(self, offsets: Sequence[int]) -> None:
        for s, off in enumerate(offsets):
            # The committed offset bounds replays, the cursor bounds live
            # progress: never raise the floor above consumption.
            self.truncate_below(s, min(int(off), self._cursor[s]))


class ListFeedReader(FeedReader):
    """In-memory partitioned feed stored as dense ``[N, 2]`` int32 arrays.
    The list models a stream arriving over time, so a finite
    ``retention`` bounds the records kept behind the cursor, never the
    unconsumed ones; ``retention=None`` keeps everything."""

    def __init__(self, partitions: Sequence[Sequence[Tuple[int, int]]],
                 records_per_pull: int = 1 << 30,
                 retention: Optional[int] = None):
        self._np = [np.asarray(list(p), np.int32).reshape(-1, 2)
                    for p in partitions]
        self._base = [0] * len(self._np)
        self._cursor = [0] * len(self._np)
        self.retention = retention
        self.records_per_pull = records_per_pull
        # notify_checkpoint_complete may arrive on a checkpoint writer's
        # thread while the executor pulls on the main thread.
        self._lock = threading.Lock()

    def _check_floor(self, subtask: int, offset: int) -> None:
        _floor_check(self._base[subtask], subtask, offset)

    def _trim_to(self, subtask: int, floor: int) -> None:
        drop = floor - self._base[subtask]
        if drop > 0:
            self._np[subtask] = self._np[subtask][drop:]
            self._base[subtask] = floor

    def _trim_retention(self, subtask: int) -> None:
        if self.retention is not None:
            self._trim_to(subtask, self._cursor[subtask] - self.retention)

    def _advance(self, subtask: int, n_max: int) -> np.ndarray:
        with self._lock:
            lo = self._cursor[subtask]
            self._check_floor(subtask, lo)
            rel = lo - self._base[subtask]
            chunk = self._np[subtask][rel: rel + n_max]
            self._cursor[subtask] = lo + len(chunk)
            self._trim_retention(subtask)
            return chunk

    def pull(self, subtask: int, max_n: int):
        chunk = self._advance(subtask, min(max_n, self.records_per_pull))
        return chunk[:, 0].tolist(), chunk[:, 1].tolist()

    def pull_block(self, subtask: int, batch: int, k: int):
        per = min(batch, self.records_per_pull)
        flat = self._advance(subtask, k * per)
        take = len(flat)
        ks = np.zeros((k, batch), np.int32)
        vs = np.zeros((k, batch), np.int32)
        counts = np.zeros((k,), np.int32)
        full = take // per
        counts[:full] = per
        if full:
            blk = flat[: full * per].reshape(full, per, 2)
            ks[:full, :per] = blk[:, :, 0]
            vs[:full, :per] = blk[:, :, 1]
        tail = take - full * per
        if tail and full < k:
            counts[full] = tail
            ks[full, :tail] = flat[full * per:, 0]
            vs[full, :tail] = flat[full * per:, 1]
        return ks, vs, counts

    def read_at(self, subtask: int, offset: int, n: int):
        with self._lock:
            self._check_floor(subtask, offset)
            rel = offset - self._base[subtask]
            chunk = self._np[subtask][rel: rel + n]
        if len(chunk) != n:
            raise ValueError(
                f"feed partition {subtask} cannot re-serve [{offset}, "
                f"{offset + n}): retention too short")
        return chunk[:, 0].tolist(), chunk[:, 1].tolist()

    def notify_checkpoint_complete(self, offsets: Sequence[int]) -> None:
        with self._lock:
            for s, off in enumerate(offsets):
                self._trim_to(s, min(int(off), self._cursor[s]))


class SocketFeedReader(FeedReader):
    """Line-based TCP ingestion: the SocketWindowWordCount front door
    (reference flink-examples .../socket/SocketWindowWordCount.java). A
    background thread drains the socket into a bounded retained buffer
    per subtask (``retention`` records a partition; committed offsets
    release earlier ones at every completed checkpoint), so the
    rewindable contract holds for ranges within retention. The thread
    touches host lists only.

    Lines are ``key[:value]`` integer pairs; value defaults to 1; other
    lines are skipped. Line i goes to partition ``i % num_subtasks``.
    """

    def __init__(self, host: str, port: int, num_subtasks: int = 1,
                 retention: Optional[int] = 1 << 20):
        self._r = _RetainedPartitions(num_subtasks, retention)
        #: records dropped by retention before the consumer reached them
        #: (live pulls skip forward past them — Kafka's
        #: auto.offset.reset=earliest — but the loss is counted)
        self.records_lost = [0] * num_subtasks
        self._lock = threading.Lock()
        self._sock = socket.create_connection((host, port))
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        f = self._sock.makefile("r")
        i = 0
        nparts = len(self._r._parts)
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                if ":" in line:
                    k, v = line.split(":", 1)
                    rec = (int(k), int(v))
                else:
                    rec = (int(line), 1)
            except ValueError:
                continue
            s = i % nparts
            with self._lock:
                self._r._parts[s].append(rec)
                self._r._enforce_retention(s)
            i += 1

    def pull(self, subtask: int, max_n: int):
        with self._lock:
            r = self._r
            lo = r._cursor[subtask]
            if lo < r._base[subtask]:
                # Fell behind the retention window: resume at the
                # earliest retained offset and count the gap (recovery
                # re-reads through read_at still fail loudly).
                self.records_lost[subtask] += r._base[subtask] - lo
                lo = r._base[subtask]
            avail = r._base[subtask] + len(r._parts[subtask]) - lo
            n = min(max_n, avail)
            chunk = r._slice(subtask, lo, n)
            r._cursor[subtask] = lo + n
        return [k for k, _ in chunk], [v for _, v in chunk]

    def read_at(self, subtask: int, offset: int, n: int):
        with self._lock:
            chunk = self._r._slice(subtask, offset, n)
        return [k for k, _ in chunk], [v for _, v in chunk]

    def notify_checkpoint_complete(self, offsets: Sequence[int]) -> None:
        with self._lock:
            self._r.commit(offsets)

    def close(self) -> None:
        """Close the socket; the drain thread ends at its next read."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
