"""A traced stretch of the measured window: ``torch.profiler`` (CUPTI) over
a few steady units of work, reduced to device busy time, the device
operations that took most time, and the longest idle gaps labelled by
what the host was doing.

The stretch starts at the first unit of work after ``start_frac`` of the
window and lasts ``units`` units (epochs or kill cycles); it synchronises
the card at both ends, so its wall time holds its own work only. A
closed-loop window runs on until the stretch is done.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.roofline import HistLaunch


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceStretch:
    """Opened and closed by a driver through :meth:`tick`."""

    def __init__(self, ctx, start_frac: float, units: int):
        self.ctx = ctx
        self.start_frac = start_frac
        self.units = units
        self.prof = None
        self.t0 = 0.0
        self.opened_at = -1
        self.done = False
        self._summary: Optional[Dict] = None
        self._counts: Dict = {}
        self._steps0 = 0
        self._launches0 = 0
        self._restore = None
        #: every keyed-histogram launch of the stretch, as launched
        self.hist_shapes: List[HistLaunch] = []

    @property
    def pending(self) -> bool:
        """True until the stretch has been traced: the window runs on."""
        return not self.done

    @property
    def summary(self) -> Optional[Dict]:
        """The stretch's readings, reduced from the trace at first use,
        after the window (reading the events takes a while)."""
        if self.done and self._summary is None:
            self._summary = summarize(self.prof, self._counts["window_s"])
            self._summary.update(self._counts)
        return self._summary

    def prime(self) -> None:
        """Start and stop the profiler once on a trivial operation, so the
        stretch does not pay CUPTI's first start (set-up of a traced
        run)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=self.ctx.device).add_(1)
            self.ctx.sync()
        prof.events()

    def tick(self, unit: int, elapsed_s: float, final: bool = False) -> None:
        """Called before each unit of work (and once after the last, with
        ``final``) with the units done and the window's elapsed seconds."""
        if self.done:
            return
        if self.prof is None:
            if not final and elapsed_s >= self.start_frac * self.ctx.seconds:
                self._open(unit)
        elif final or unit - self.opened_at >= self.units:
            self._close(unit)

    def _record_hist_shapes(self) -> None:
        """Record the shape of each keyed-histogram launch while the
        stretch is open: the ``[R, B]`` rows, the keys and the form the
        program hands the kernel's launcher (``ops/histogram.py``
        ``keyed_hist_cuda``), whatever its edges hold."""
        from clonos_tpu_torch.ops import histogram
        inner = histogram.keyed_hist_cuda

        def recorded(keys, vals, valid, nk, want_counts=True):
            r, b = keys.shape
            self.hist_shapes.append(HistLaunch(
                rows=r, width=b, keys=nk, counts=bool(want_counts),
                kept=r * b))
            return inner(keys, vals, valid, nk, want_counts)

        histogram.keyed_hist_cuda = recorded

        def restore():
            histogram.keyed_hist_cuda = inner
        self._restore = restore

    def _open(self, unit: int) -> None:
        from torch.profiler import ProfilerActivity, profile
        from clonos_tpu_torch.ops.histogram import keyed_hist
        self.ctx.sync()
        self._record_hist_shapes()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.opened_at = unit
        self._steps0 = self.ctx.steps_executed()
        self._launches0 = keyed_hist.launches
        self.t0 = time.perf_counter()

    def _close(self, unit: int) -> None:
        from clonos_tpu_torch.ops.histogram import keyed_hist
        self.ctx.sync()
        window_s = time.perf_counter() - self.t0
        steps = self.ctx.steps_executed() - self._steps0
        launches = keyed_hist.launches - self._launches0
        self.prof.stop()
        self._restore()
        self.done = True
        self._counts = dict(window_s=window_s, units=unit - self.opened_at,
                            steps=steps, hist_launches=launches)


def summarize(prof, window_s: float) -> Dict:
    """Busy seconds (the union of the device's operations), time by
    device operation, host-to-device copies, keyed-histogram kernels and
    the longest idle gaps of one profiler run."""
    from torch.autograd import DeviceType
    events = prof.events()
    annotations = {e.name for e in events
                   if e.device_type == DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)}
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name in annotations:
                continue      # a range's device span, not work of its own
            dev.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    h2d = [e.time_range.elapsed_us() for e in dev
           if "Memcpy HtoD" in e.name]
    hist = [e.time_range.elapsed_us() for e in dev if "hist_" in e.name]
    gaps = []
    if busy:
        lo = min(e.time_range.start for e in host) if host else busy[0][0]
        edges = [(lo, lo)] + busy
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    labelled = [[_host_label(host, annotations, (a + b) / 2), g / 1e6]
                for g, a, b in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "device_ops": [[name, us / 1e6] for name, us in top],
        "idle_gaps": labelled,
        "h2d_s": sum(h2d) / 1e6,
        "hist_s": sum(hist) / 1e6,
        "hist_kernels": len(hist),
        "device_operations": len(dev),
    }


def _host_label(host, annotations, t: float) -> str:
    """The innermost range (a ``record_function`` of the program or of the
    benchmark) and the innermost operation the host was in at ``t``."""
    inside = [e for e in host
              if e.time_range.start <= t <= e.time_range.end]
    ranges = [e for e in inside if e.name in annotations]
    ops = [e for e in inside if e.name not in annotations]
    pick = lambda es: min(es, key=lambda e: e.time_range.elapsed_us()).name
    parts = ([pick(ranges)] if ranges else []) + ([pick(ops)] if ops else [])
    return " / ".join(parts) if parts else "host: outside any range"


def idle_share(summary: Dict) -> Optional[float]:
    if not summary or summary["window_s"] <= 0 or \
            not summary["device_operations"]:
        return None           # nothing ran on a device: no device reading
    # Not clamped: a busy union longer than the window is a fault of the
    # count or of the clocks, and has to show.
    return 1.0 - summary["busy_s"] / summary["window_s"]

