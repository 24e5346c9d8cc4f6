"""Bounded metrics history: the time axis ``/metrics.json`` lacks (port
of ``clonos_tpu/obs/history.py``).

One scrape answers "what is the job doing now"; a slow drift (ring
occupancy creeping toward overwrite, the overhead fraction rising) needs
history. :class:`MetricsHistory` keeps a bounded ring of snapshots:

- :meth:`MetricsHistory.sample_once` calls a zero-arg ``sample_fn`` (the
  endpoint's merged view) and appends ``{"ts", "metrics"}`` to (a) an
  in-memory ring (``deque(maxlen=window)``) and (b) optionally a
  JSON-lines file, one flushed append per sample, so a killed process
  loses at most the line being written, and a reader drops that torn
  tail as the checkpoint ledger's does. When the file outgrows
  ``2*window`` lines it is compacted from the ring by an atomic rewrite.
  :meth:`start` runs it on a daemon thread every ``interval_s``.
- :meth:`MetricsHistory.query` serves windowed reads (``since`` a
  timestamp, ``last`` N samples), the payload behind the endpoint's
  ``/metrics/history.json?since=TS&last=N``.

Sampling touches only host data (snapshot dicts), never the card.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from clonos_tpu_torch.utils.jsonl import (JsonlAppender,
                                          atomic_rewrite_jsonl, read_jsonl)


def read_history_file(path: str) -> List[dict]:
    """Read a history JSONL, tolerating a torn final line; a decode
    failure on any earlier line raises."""
    return read_jsonl(path)


class MetricsHistory:
    """Ring-bounded periodic snapshots of a metrics view."""

    def __init__(self, sample_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None, path: Optional[str] = None,
                 interval_s: float = 2.0, window: int = 512,
                 # clonos: allow(wallclock): sample timestamps, obs-only
                 clock=time.time):
        self.sample_fn = sample_fn
        self._path = path
        self.interval_s = float(interval_s)
        self.window = int(window)
        self._clock = clock
        self._ring: Deque[dict] = collections.deque(maxlen=self.window)
        #: sampling slots skipped because a sample overran its interval
        self.missed_slots = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._writer = None
        self._file_lines = 0
        if path is not None:
            self._writer = JsonlAppender(path, default=str)
            # A restarted process resumes its ring from the file's tail.
            for rec in read_history_file(path)[-self.window:]:
                self._ring.append(rec)
            self._file_lines = len(self._ring)

    # --- sampling ------------------------------------------------------------

    def sample_once(self) -> dict:
        """Take one sample now (also what the thread loop calls)."""
        try:
            metrics = self.sample_fn() if self.sample_fn else {}
        except Exception as e:       # the sampler outlives a bad gauge
            metrics = {"history-error": repr(e)}
        rec = {"ts": self._clock(), "metrics": metrics}
        with self._lock:
            self._ring.append(rec)
            if self._writer is not None:
                self._writer.append(rec)
                self._file_lines += 1
                if self._file_lines > 2 * self.window:
                    self._compact_locked()
        return rec

    def _compact_locked(self) -> None:
        self._writer.close()     # os.replace swaps the inode under it
        self._file_lines = atomic_rewrite_jsonl(
            self._path, list(self._ring), default=str)

    def _loop(self) -> None:
        # Absolute-deadline pacing: each deadline is interval_s after the
        # previous deadline, not after the sample finished; a sample that
        # overruns whole intervals skips the missed slots (counted).
        next_due = time.monotonic() + self.interval_s
        while not self._stop.wait(max(next_due - time.monotonic(), 0.0)):
            self.sample_once()
            next_due += self.interval_s
            now = time.monotonic()
            if next_due <= now:
                missed = int((now - next_due) / self.interval_s) + 1
                self.missed_slots += missed
                next_due += missed * self.interval_s

    def start(self) -> "MetricsHistory":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True)
            self._thread.start()
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None

    # --- queries -------------------------------------------------------------

    def query(self, since: Optional[float] = None,
              last: Optional[int] = None) -> List[dict]:
        """Samples with ``ts >= since``, then trimmed to the ``last`` N,
        oldest first."""
        with self._lock:
            out = list(self._ring)
        if since is not None:
            out = [r for r in out if r.get("ts", 0) >= since]
        if last is not None and last >= 0:
            out = out[-last:]
        return out

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if self._writer is not None:
                self._writer.close()
