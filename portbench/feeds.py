"""The benchmark's partitioned feed: what a Kafka topic hands the job.

Each partition serves a pool of keys drawn once from the seed, in order
and cycled by offset, with value 1. The program receives only what it
pulls; a recovery re-reads exact ranges with ``read_at``; a completed
checkpoint commits offsets, below which a re-read is refused.

:class:`PacedFeed` puts an open-loop schedule in front of it: records
arrive evenly at a fixed rate, and a pull of a block's records returns
when the last of them has arrived, whatever the job is doing.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from clonos_tpu_torch.api.feeds import FeedReader, RetentionExpiredError


def make_pool(rng: np.random.Generator, partitions: int, records: int,
              vocab: int) -> np.ndarray:
    """``[partitions, records]`` int32 keys, uniform over ``[0, vocab)``."""
    return rng.integers(0, vocab, size=(partitions, records),
                        dtype=np.int32)


class SeededPoolFeed(FeedReader):
    """Partition ``p``'s record at offset ``o`` is ``(pool[p, o % N], 1)``;
    every pull is served in full."""

    def __init__(self, pool: np.ndarray):
        self.pool = np.ascontiguousarray(pool, np.int32)
        n_parts, self.n = self.pool.shape
        self.cursor = [0] * n_parts
        self.committed = [0] * n_parts
        self._ones: Optional[np.ndarray] = None
        # A checkpoint may complete on a writer thread while the job pulls.
        self._lock = threading.Lock()

    def _keys(self, part: int, offset: int, n: int) -> np.ndarray:
        lo = offset % self.n
        if lo + n <= self.n:
            return self.pool[part, lo:lo + n]      # a view: no copy
        idx = (offset + np.arange(n, dtype=np.int64)) % self.n
        return self.pool[part, idx]

    def pull(self, subtask: int, max_n: int):
        off = self.cursor[subtask]
        self.cursor[subtask] = off + max_n
        keys = self._keys(subtask, off, max_n)
        return keys.tolist(), [1] * max_n

    def pull_block(self, subtask: int, batch: int, k: int):
        with record_function("portbench.feed"):
            return self._pull_block(subtask, batch, k)

    def _pull_block(self, subtask: int, batch: int, k: int):
        off = self.cursor[subtask]
        self.cursor[subtask] = off + k * batch
        keys = self._keys(subtask, off, k * batch).reshape(k, batch)
        if self._ones is None or self._ones.shape != (k, batch):
            self._ones = np.ones((k, batch), np.int32)
        return keys, self._ones, np.full(k, batch, np.int32)

    def read_at(self, subtask: int, offset: int, n: int):
        with self._lock:
            floor = self.committed[subtask]
        if offset < floor:
            raise RetentionExpiredError(
                f"partition {subtask}: offset {offset} is below the "
                f"committed offset {floor}")
        return self._keys(subtask, offset, n).tolist(), [1] * n

    def notify_checkpoint_complete(self, offsets: Sequence[int]) -> None:
        with self._lock:
            for s, off in enumerate(offsets):
                self.committed[s] = max(self.committed[s],
                                        min(int(off), self.cursor[s]))


class PacedFeed(SeededPoolFeed):
    """A :class:`SeededPoolFeed` whose block pulls wait for their records'
    arrival once :meth:`start` has set a rate: the ``i``-th block pulled
    after the start is due when its last record has arrived, at
    ``t0 + (i + 1) * records_per_block / rate``."""

    def __init__(self, pool: np.ndarray):
        super().__init__(pool)
        self.rate: Optional[float] = None
        self.t0 = 0.0
        #: per block pulled since the start: (due, handed over), host
        #: seconds on ``time.perf_counter``
        self.blocks: List[tuple] = []

    def start(self, rate: float, t0: float) -> None:
        self.rate = rate
        self.t0 = t0
        self.blocks = []

    def stop(self) -> None:
        self.rate = None

    def pull_block(self, subtask: int, batch: int, k: int):
        if self.rate is not None and subtask == 0:
            # Lane 0 is pulled first for every block: the block waits here.
            per_block = k * batch * len(self.cursor)
            due = self.t0 + (len(self.blocks) + 1) * per_block / self.rate
            wait = due - time.perf_counter()
            if wait > 0.002:
                time.sleep(wait - 0.001)
            while time.perf_counter() < due:
                pass
            self.blocks.append((due, time.perf_counter()))
        return super().pull_block(subtask, batch, k)
