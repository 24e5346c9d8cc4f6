"""Windowed SLO engine for open-loop soak runs (port of
``clonos_tpu/soak/slo.py``; numpy only).

Latency discipline: every sample is measured from *intended*-send time
— the instant the token bucket says the chunk was due — not from when
the driver actually got around to sending it. Under a fault the driver
stalls, the backlog grows, and actual-send timestamps would hide the
stall entirely (the classic coordinated-omission blind spot). The
corrected number is what a non-cooperating client would have seen.

:class:`SLOTracker` rolls fixed-width windows over the soak clock and
evaluates the :class:`SLOSpec` per window; each violation is emitted as
a ``soak.slo.breach`` trace instant under the run's trace id so the
flight recorder can correlate breach → injected fault.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def quantile(samples: Sequence[float], q: float) -> float:
    """Empirical quantile (0 for an empty sample set)."""
    if not len(samples):
        return 0.0
    return float(np.quantile(np.asarray(samples, dtype=np.float64), q))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-window service-level objectives. ``None`` disables a bound.

    ``exactly_once`` is not a latency bound: it asserts that the audit
    re-validation after every injected fault found zero ledger
    divergences (checked once, over the whole run).
    """

    max_p99_ms: Optional[float] = None
    min_throughput: Optional[float] = None   # records/sec per window
    max_recovery_ms: Optional[float] = None
    exactly_once: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Window:
    """One SLO evaluation window: corrected + actual latency samples,
    record/chunk counts, recoveries, and the breaches found at close."""

    def __init__(self, index: int, start_s: float, width_s: float):
        self.index = index
        self.start_s = start_s
        self.width_s = width_s
        self.corrected_ms: List[float] = []
        self.actual_ms: List[float] = []
        self.records = 0
        self.chunks = 0
        self.recoveries_ms: List[float] = []
        self.faults: List[str] = []
        self.breaches: List[str] = []

    def observe(self, corrected_ms: float, actual_ms: float,
                records: int) -> None:
        self.corrected_ms.append(corrected_ms)
        self.actual_ms.append(actual_ms)
        self.records += records
        self.chunks += 1

    def stats(self) -> Dict[str, Any]:
        thr = self.records / self.width_s if self.width_s > 0 else 0.0
        return {
            "window": self.index,
            "start_s": round(self.start_s, 3),
            "chunks": self.chunks,
            "records": self.records,
            "throughput": round(thr, 1),
            "p50_ms": round(quantile(self.corrected_ms, 0.50), 3),
            "p99_ms": round(quantile(self.corrected_ms, 0.99), 3),
            "p999_ms": round(quantile(self.corrected_ms, 0.999), 3),
            "actual_p99_ms": round(quantile(self.actual_ms, 0.99), 3),
            "recoveries_ms": [round(r, 1) for r in self.recoveries_ms],
            "faults": list(self.faults),
            "breaches": list(self.breaches),
        }

    def evaluate(self, spec: SLOSpec) -> List[str]:
        """Close the window against the spec; returns breach strings."""
        breaches = []
        p99 = quantile(self.corrected_ms, 0.99)
        if spec.max_p99_ms is not None and p99 > spec.max_p99_ms:
            breaches.append(f"p99 {p99:.1f}ms > {spec.max_p99_ms:g}ms")
        if spec.min_throughput is not None and self.chunks:
            thr = self.records / self.width_s
            if thr < spec.min_throughput:
                breaches.append(
                    f"throughput {thr:.0f}/s < {spec.min_throughput:g}/s")
        if spec.max_recovery_ms is not None:
            for r in self.recoveries_ms:
                if r > spec.max_recovery_ms:
                    breaches.append(
                        f"recovery {r:.0f}ms > {spec.max_recovery_ms:g}ms")
        self.breaches = breaches
        return breaches


class SLOTracker:
    """Rolls :class:`Window` objects over the soak clock and evaluates
    each against the spec as it closes.

    All times are seconds on the *soak clock* (0 = start of the paced
    phase), supplied by the driver — the tracker never reads wallclock
    itself, which keeps it replayable and lint-clean.
    """

    def __init__(self, spec: SLOSpec, window_s: float = 5.0,
                 tracer=None):
        self.spec = spec
        self.window_s = window_s
        self.tracer = tracer
        self.closed: List[Window] = []
        self.current = Window(0, 0.0, window_s)

    def _roll_to(self, now_s: float) -> None:
        while now_s >= self.current.start_s + self.window_s:
            self._close(self.current)
            nxt = self.current.index + 1
            self.current = Window(nxt, nxt * self.window_s,
                                  self.window_s)

    def _close(self, win: Window) -> None:
        breaches = win.evaluate(self.spec)
        if breaches:
            if self.tracer is not None:
                for b in breaches:
                    self.tracer.event("soak.slo.breach",
                                      window=win.index, breach=b)
            from clonos_tpu_torch.obs.timeline import get_timeline
            tl = get_timeline()
            if tl.enabled:
                for b in breaches:
                    tl.record("slo.breach", window=win.index, breach=b)
            # One incident signal per breached window (not per breach
            # line — the window is the fault, the lines are symptoms);
            # no-op when the incident plane is disabled.
            from clonos_tpu_torch.obs.incident import get_incidents
            get_incidents().signal("slo.breach", window=win.index,
                                   breaches=sorted(breaches))
        self.closed.append(win)

    def observe(self, now_s: float, corrected_ms: float,
                actual_ms: float, records: int) -> None:
        self._roll_to(now_s)
        self.current.observe(corrected_ms, actual_ms, records)

    def observe_recovery(self, now_s: float, recovery_ms: float) -> None:
        self._roll_to(now_s)
        self.current.recoveries_ms.append(recovery_ms)

    def observe_fault(self, now_s: float, kind: str) -> None:
        self._roll_to(now_s)
        self.current.faults.append(kind)

    def finish(self) -> List[Window]:
        """Close the in-progress window and return all windows."""
        if self.current.chunks or self.current.recoveries_ms \
                or self.current.faults:
            self._close(self.current)
        return self.closed

    # -- aggregates over all closed windows ---------------------------

    def all_corrected_ms(self) -> List[float]:
        return [s for w in self.closed for s in w.corrected_ms]

    def all_actual_ms(self) -> List[float]:
        return [s for w in self.closed for s in w.actual_ms]

    def breached_windows(self) -> List[Window]:
        return [w for w in self.closed if w.breaches]

    def worst_window(self) -> Optional[Window]:
        if not self.closed:
            return None
        return max(self.closed,
                   key=lambda w: quantile(w.corrected_ms, 0.99))


def corrected_closed_loop(samples: Sequence[Tuple[int, float]],
                          fences: Sequence[Tuple[int, float]],
                          steps_per_epoch: int,
                          records_per_step: int,
                          rate: Optional[float] = None,
                          ) -> Dict[str, float]:
    """Coordinated-omission correction for the closed-loop bench.

    The bench's latency markers measure record-tagged dwell *inside*
    the pipeline, but the bench pushes epochs back-to-back: when one
    fence runs long, every later record is also sent late, and the
    marker number never sees that queueing delay. Reconstruct it: from
    the fence walls ``(global_step, monotonic_s)`` derive the sustained
    step rate (or take ``rate`` in records/sec), lay down the intended
    wall for every fence on that fixed schedule, and charge each marker
    sample the queueing delay ``max(0, actual - intended)`` of the
    fence that closed its epoch.

    ``samples`` are ``(global_step, marker_ms)`` pairs from
    ``LatencyMarkers``; returns corrected p50/p99 plus the schedule
    parameters used, so the JSON output can show both numbers side by
    side.
    """
    if not samples or len(fences) < 2:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "max_queue_ms": 0.0}
    fences = sorted(fences)
    steps0, t0 = fences[0]
    if rate is None:
        span_steps = fences[-1][0] - steps0
        span_s = fences[-1][1] - t0
        per_step_s = span_s / max(span_steps, 1)
    else:
        per_step_s = records_per_step / rate
    # queueing delay of each fence vs its intended wall on the fixed
    # schedule anchored at the first fence
    queue_ms = {}
    for step, t in fences:
        intended = t0 + (step - steps0) * per_step_s
        queue_ms[step] = max(0.0, (t - intended) * 1e3)
    fence_steps = sorted(queue_ms)
    corrected = []
    for step, marker_ms in samples:
        # the fence that closed this sample's epoch: first fence at or
        # after the sample's step
        idx = int(np.searchsorted(fence_steps, step))
        if idx >= len(fence_steps):
            idx = len(fence_steps) - 1
        corrected.append(marker_ms + queue_ms[fence_steps[idx]])
    return {
        "p50_ms": round(quantile(corrected, 0.50), 3),
        "p99_ms": round(quantile(corrected, 0.99), 3),
        "max_queue_ms": round(max(queue_ms.values()), 3),
        "per_step_us": round(per_step_s * 1e6, 3),
    }
