"""Processing-time timers with causal record/replay (port of
``clonos_tpu/runtime/timers.py``).

Timers are host-side control events. The service checks due timers at
block boundaries against causal time (host-known, no device read); each
fired timer logs a TIMER_TRIGGER determinant with the step stamp and the
callback id, and a recovery re-fires exactly the recorded timers.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Tuple

from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal.services import ReplayFeed


class ProcessingTimeService:
    """Per-task timer service. ``advance(now, stamp)`` fires every timer
    due by ``now``, appending its determinant and calling its callback;
    ``force_fire`` re-fires a recorded one during replay.

    ``fires=False`` keeps the timer book and appends the determinants but
    never runs a callback: a rank of a mesh that appends to the task's
    log and replica rows in lockstep while another rank runs the task's
    callbacks, so each fires once in the deployment."""

    def __init__(self, append: Callable[[det.Determinant], None],
                 fires: bool = True):
        self._append = append
        self.fires = fires
        self._heap: List[Tuple[int, int]] = []   # (fire_time, callback_id)
        self._callbacks: Dict[int, Callable[[int], None]] = {}
        self._next_id = 1

    def register_callback(self, fn: Callable[[int], None],
                          callback_id: Optional[int] = None) -> int:
        """Callbacks are re-registered under stable ids after a restore
        (the id is what the determinant records)."""
        cid = callback_id if callback_id is not None else self._next_id
        self._next_id = max(self._next_id, cid + 1)
        self._callbacks[cid] = fn
        return cid

    def register_timer(self, fire_time: int, callback_id: int) -> None:
        if callback_id not in self._callbacks:
            raise ValueError(f"unknown callback id {callback_id}")
        heapq.heappush(self._heap, (fire_time, callback_id))

    def advance(self, now: int, stamp: int) -> int:
        """Fire all due timers; returns how many fired."""
        fired = 0
        while self._heap and self._heap[0][0] <= now:
            ft, cid = heapq.heappop(self._heap)
            d = det.TimerTriggerDeterminant(
                record_count=max(stamp, 1), callback_id=cid, timestamp=ft)
            self._append(d)
            if self.fires:
                self._callbacks[cid](ft)
            fired += 1
        return fired

    def force_fire(self, d: det.TimerTriggerDeterminant) -> None:
        """Replay: fire exactly the recorded timer, appending its
        determinant again."""
        self._append(d)
        self.refire(d)

    def refire(self, d: det.TimerTriggerDeterminant) -> None:
        """Recovery, when the row is already back in the rebuilt log: run
        the callback without appending (a second append would duplicate
        the row), and drop the timer's pending registration."""
        self._heap = [(ft, cid) for ft, cid in self._heap
                      if not (ft == d.timestamp and cid == d.callback_id)]
        heapq.heapify(self._heap)
        if not self.fires:
            return
        cb = self._callbacks.get(d.callback_id)
        if cb is None:
            raise ValueError(
                f"replayed timer references unregistered callback "
                f"{d.callback_id}; re-register callbacks before replay")
        cb(d.timestamp)

    def replay_all(self, feed: ReplayFeed) -> int:
        """Force-fire every recorded TIMER_TRIGGER determinant in order."""
        n = 0
        while not feed.exhausted():
            self.force_fire(feed.next_of(det.TimerTriggerDeterminant))
            n += 1
        return n

    @property
    def pending(self) -> int:
        return len(self._heap)
