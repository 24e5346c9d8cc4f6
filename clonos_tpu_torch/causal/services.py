"""Causal services: recorded and replayed nondeterminism for host code
(port of ``clonos_tpu/causal/services.py``).

The per-superstep time and RNG values are step inputs the executor logs
itself. These services cover host-side user and control code (sources
pulling external data, sinks calling external systems, timers): each
call appends one async determinant row to the owning task's log between
blocks (``LocalExecutor.append_async_many``, a device program with no
read), and during replay the recorded value is served back and appended
again, so the rebuilt log is bit-identical.
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional

import numpy as np

from clonos_tpu_torch.causal import determinant as det


class ReplayFeed:
    """Recorded async determinants for one task, served in order during
    replay."""

    def __init__(self, dets: List[det.Determinant]):
        self._dets = list(dets)
        self._pos = 0

    def next_of(self, cls) -> det.Determinant:
        """Next recorded determinant, which must be a ``cls``: recorded
        and replayed nondeterminism line up one to one."""
        if self._pos >= len(self._dets):
            raise RuntimeError(
                f"replay feed exhausted: expected a {cls.__name__}")
        d = self._dets[self._pos]
        if not isinstance(d, cls):
            raise RuntimeError(
                f"replay feed mismatch: expected {cls.__name__}, recorded "
                f"{type(d).__name__} — nondeterministic call order diverged")
        self._pos += 1
        return d

    def exhausted(self) -> bool:
        return self._pos >= len(self._dets)

    @property
    def remaining(self) -> int:
        return len(self._dets) - self._pos


class AbstractCausalService:
    """Shared record/replay plumbing. ``append`` logs one determinant to
    the owning task; it runs on the live path AND during replay, so the
    rebuilt log matches."""

    def __init__(self, append: Callable[[det.Determinant], None],
                 replay_feed: Optional[ReplayFeed] = None):
        self._append = append
        self._feed = replay_feed

    @property
    def recovering(self) -> bool:
        return self._feed is not None and not self._feed.exhausted()

    def _record_or_replay(self, cls, make: Callable[[], det.Determinant]
                          ) -> det.Determinant:
        d = self._feed.next_of(cls) if self.recovering else make()
        self._append(d)
        return d


class CausalTimeService(AbstractCausalService):
    """``current_time_millis`` with record/replay."""

    def __init__(self, append, replay_feed=None, clock=None):
        super().__init__(append, replay_feed)
        # clonos: allow(wallclock) — the causal clock's source; every read
        # is logged as a TimestampDeterminant and replayed.
        self._clock = clock or (lambda: int(_time.time() * 1000))

    def current_time_millis(self) -> int:
        d = self._record_or_replay(
            det.TimestampDeterminant,
            lambda: det.TimestampDeterminant(timestamp=self._clock()))
        return d.timestamp


class PeriodicCausalTimeService(CausalTimeService):
    """Amortised time: the clock is sampled at most once per
    ``period_ms`` (gated by the monotonic clock) and reads in between
    return the cached value; every read still logs its determinant."""

    def __init__(self, append, replay_feed=None, clock=None,
                 period_ms: int = 10):
        super().__init__(append, replay_feed, clock)
        self._period = period_ms
        self._raw_clock = self._clock
        self._cached = None
        self._next_refresh = float("-inf")

        def amortized() -> int:
            now = _time.monotonic() * 1000.0
            if self._cached is None or now >= self._next_refresh:
                self._cached = self._raw_clock()
                self._next_refresh = now + self._period
            return self._cached
        self._clock = amortized


class CausalRandomService(AbstractCausalService):
    """Host random draws with record/replay."""

    def __init__(self, append, replay_feed=None, seed: int = 0):
        super().__init__(append, replay_feed)
        self._rng = np.random.RandomState(seed)

    def next_int(self, bound: int = 1 << 31) -> int:
        d = self._record_or_replay(
            det.RNGDeterminant,
            lambda: det.RNGDeterminant(
                value=int(self._rng.randint(0, bound, dtype=np.int64))))
        return d.value


class CausalSerializableService(AbstractCausalService):
    """Wraps an external call ``fn`` (request bytes -> response bytes) so
    its results replay: live, the response goes to the sidecar store and
    its (key, length, crc) row is logged; replaying, the recorded response
    is read back and ``fn`` is not called again."""

    def __init__(self, append, fn: Callable[[bytes], bytes],
                 sidecar: det.SidecarStore, epoch_of: Callable[[], int],
                 replay_feed: Optional[ReplayFeed] = None):
        super().__init__(append, replay_feed)
        self._fn = fn
        self._sidecar = sidecar
        self._epoch_of = epoch_of

    def apply(self, request: bytes) -> bytes:
        if self.recovering:
            d = self._feed.next_of(det.SerializableDeterminant)
            self._append(d)
            return self._sidecar.get(d)
        response = self._fn(request)
        d = self._sidecar.put(response, self._epoch_of())
        self._append(d)
        return response


class CausalServiceFactory:
    """A task's bundle of causal services."""

    def __init__(self, append, sidecar: det.SidecarStore,
                 epoch_of: Callable[[], int],
                 replay_feed: Optional[ReplayFeed] = None,
                 seed: int = 0, clock=None):
        self._append = append
        self._sidecar = sidecar
        self._epoch_of = epoch_of
        self._feed = replay_feed
        self._seed = seed
        self._clock = clock

    def time_service(self) -> CausalTimeService:
        return CausalTimeService(self._append, self._feed, self._clock)

    def periodic_time_service(self, period_ms: int = 10
                              ) -> PeriodicCausalTimeService:
        return PeriodicCausalTimeService(self._append, self._feed,
                                         self._clock, period_ms)

    def random_service(self) -> CausalRandomService:
        return CausalRandomService(self._append, self._feed, self._seed)

    def serializable_service(self, fn: Callable[[bytes], bytes]
                             ) -> CausalSerializableService:
        return CausalSerializableService(self._append, fn, self._sidecar,
                                         self._epoch_of, self._feed)
