"""Metrics: registry, metric types and scopes (port of
``clonos_tpu/utils/metrics.py``).

Counter/Gauge/Meter/Histogram under hierarchical scopes, and the
registry's ``snapshot()`` with the reference's names and value shapes.
The reporters, the exposition dump, ``LogOccupancyWatchdog`` and
``MetricsEndpoint`` come with a later slice of the port.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict

import numpy as np


class Counter:
    def __init__(self):
        self._v = 0

    def inc(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Wraps a supplier (evaluated at report time)."""

    def __init__(self, fn: Callable[[], Any]):
        self._fn = fn

    @property
    def value(self):
        return self._fn()


class Meter:
    """Rate of events/sec over a sliding window."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self._events: Deque[tuple] = collections.deque()
        self._window = window_s
        self._clock = clock

    def mark(self, n: int = 1) -> None:
        now = self._clock()
        self._events.append((now, n))
        cut = now - self._window
        while self._events and self._events[0][0] < cut:
            self._events.popleft()

    @property
    def rate(self) -> float:
        now = self._clock()
        cut = now - self._window
        total = sum(n for t, n in self._events if t >= cut)
        return total / self._window


class Histogram:
    def __init__(self, max_samples: int = 1024):
        # deque(maxlen=...) evicts the oldest sample in O(1)
        self._buf: Deque[float] = collections.deque(maxlen=max_samples)

    def update(self, v: float) -> None:
        self._buf.append(v)

    def quantile(self, q: float) -> float:
        if not self._buf:
            return 0.0
        return float(np.quantile(np.asarray(self._buf), q))

    @property
    def count(self) -> int:
        return len(self._buf)

    @property
    def mean(self) -> float:
        return float(np.mean(self._buf)) if self._buf else 0.0


class MetricGroup:
    """Hierarchical scope (job -> task -> operator naming)."""

    def __init__(self, registry: "MetricRegistry", scope: str):
        self._registry = registry
        self.scope = scope

    def counter(self, name: str) -> Counter:
        return self._registry._register(f"{self.scope}.{name}", Counter())

    def gauge(self, name: str, fn: Callable[[], Any]) -> Gauge:
        return self._registry._register(f"{self.scope}.{name}", Gauge(fn))

    def meter(self, name: str, window_s: float = 10.0) -> Meter:
        return self._registry._register(f"{self.scope}.{name}",
                                        Meter(window_s))

    def histogram(self, name: str) -> Histogram:
        return self._registry._register(f"{self.scope}.{name}", Histogram())

    def remove(self, name: str) -> bool:
        return self._registry.unregister(f"{self.scope}.{name}")

    def add_group(self, name: str) -> "MetricGroup":
        return MetricGroup(self._registry, f"{self.scope}.{name}")


class MetricRegistry:
    """Root registry."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def group(self, scope: str) -> MetricGroup:
        return MetricGroup(self, scope)

    def _register(self, full_name: str, metric):
        with self._lock:
            existing = self._metrics.get(full_name)
            if existing is not None:
                return existing
            self._metrics[full_name] = metric
            return metric

    def unregister(self, full_name: str) -> bool:
        """Drop a metric so its name can be re-registered fresh
        (``_register`` returns an existing metric of the same name)."""
        with self._lock:
            return self._metrics.pop(full_name, None) is not None

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                try:
                    out[name] = m.value
                except Exception as e:  # supplier died; report the fact
                    out[name] = f"<gauge error: {e}>"
            elif isinstance(m, Meter):
                out[name] = round(m.rate, 3)
            elif isinstance(m, Histogram):
                out[name] = {"count": m.count, "mean": round(m.mean, 3),
                             "p50": round(m.quantile(0.5), 3),
                             "p99": round(m.quantile(0.99), 3)}
        return out
