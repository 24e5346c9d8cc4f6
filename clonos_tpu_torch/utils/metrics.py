"""Metrics: registry, metric types and scopes (port of
``clonos_tpu/utils/metrics.py``).

Counter/Gauge/Meter/Histogram under hierarchical scopes, the registry's
``snapshot()`` with the reference's names and value shapes, and the
Prometheus exposition dump; two reporters (logging, JSON-lines file) and
their periodic driver; the determinant-log occupancy watchdog
(:class:`LogOccupancyWatchdog`, over the device log sizes); and
:class:`MetricsEndpoint`, the registry over HTTP.
"""

from __future__ import annotations

import collections
import json
import re
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

# Prometheus exposition hygiene: metric names must match
# [a-zA-Z_:][a-zA-Z0-9_:]* and label values escape backslash, quote and
# newline (exposition format v0.0.4).
_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    metric = _PROM_NAME_RE.sub("_", name)
    if metric and metric[0].isdigit():
        metric = "_" + metric
    return metric or "_"


def _prom_label_escape(v: Any) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


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
        self._reporters: List["Reporter"] = []
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

    def add_reporter(self, reporter: "Reporter") -> None:
        self._reporters.append(reporter)

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

    def report(self) -> None:
        snap = self.snapshot()
        for r in self._reporters:
            r.report(snap)

    def _prometheus_type(self, name: str, v: Any) -> str:
        """Exposition TYPE for one snapshot entry: registered metrics
        map by class; merged extras are inferred from the value shape."""
        with self._lock:
            m = self._metrics.get(name)
        if isinstance(m, Counter):
            return "counter"
        if isinstance(m, Histogram):
            return "summary"
        if isinstance(m, (Gauge, Meter)):
            return "gauge"
        if isinstance(v, dict):
            return "summary" if {"count", "mean"} <= set(v) else "gauge"
        return "gauge"

    def prometheus_text(self, snapshot: Optional[Dict[str, Any]] = None
                        ) -> str:
        """Prometheus exposition-format (v0.0.4) dump with ``# HELP`` /
        ``# TYPE`` headers (pass a pre-merged ``snapshot`` to include
        e.g. cluster-wide values). Names are sanitized to the exposition
        charset; histogram snapshots flatten to ``<name>_{count,mean,
        p50,p99}`` sample lines; string values (e.g. gauge-supplier
        errors) render as info-style samples with the text in an escaped
        ``value`` label rather than being dropped."""
        lines = []
        if snapshot is None:
            snapshot = self.snapshot()
        for name, v in sorted(snapshot.items()):
            metric = _prom_name(name)
            lines.append(f"# HELP {metric} source metric {name}")
            lines.append(
                f"# TYPE {metric} {self._prometheus_type(name, v)}")
            if isinstance(v, bool):
                lines.append(f"{metric} {int(v)}")
            elif isinstance(v, (int, float)):
                lines.append(f"{metric} {v}")
            elif isinstance(v, dict):
                for k2, v2 in v.items():
                    if isinstance(v2, bool):
                        v2 = int(v2)
                    if isinstance(v2, (int, float)):
                        lines.append(f"{_prom_name(f'{metric}_{k2}')} {v2}")
                    else:
                        lines.append(
                            f'{_prom_name(f"{metric}_{k2}")}'
                            f'{{value="{_prom_label_escape(v2)}"}} 1')
            else:
                lines.append(
                    f'{metric}{{value="{_prom_label_escape(v)}"}} 1')
        return "\n".join(lines) + "\n"


class Reporter:
    def report(self, snapshot: Dict[str, Any]) -> None:
        raise NotImplementedError


class LoggingReporter(Reporter):
    def __init__(self, log_fn: Callable[[str], None] = print):
        self._log = log_fn

    def report(self, snapshot: Dict[str, Any]) -> None:
        self._log(json.dumps(snapshot, default=str))


class JsonLinesReporter(Reporter):
    """Appends one JSON object per report to a file (the scrape/ship
    boundary for external systems)."""

    # clonos: allow(wallclock): report timestamps for external scrapers
    def __init__(self, path: str, clock=time.time):
        self._path = path
        self._clock = clock
        self._file = None
        self._lock = threading.Lock()

    def report(self, snapshot: Dict[str, Any]) -> None:
        rec = {"ts": self._clock(), **snapshot}
        with self._lock:
            # one append-mode handle for the reporter's lifetime;
            # flush per record so readers (and crashes) see every line
            if self._file is None:
                self._file = open(self._path, "a")
            self._file.write(json.dumps(rec, default=str) + "\n")
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class ReporterThread:
    """Periodic reporting driver (the registry's reporter scheduler)."""

    def __init__(self, registry: MetricRegistry, interval_s: float = 1.0):
        self._registry = registry
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._registry.report()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        for r in self._registry._reporters:
            close = getattr(r, "close", None)
            if close is not None:
                close()


class LogOccupancyWatchdog:
    """The determinant-buffer watchdog: samples causal-log occupancy (one
    device read of the log sizes per sample, never on the hot path) and
    warns as the ring approaches capacity."""

    def __init__(self, executor, group: MetricGroup,
                 warn_fraction: float = 0.8,
                 warn_fn: Callable[[str], None] = print):
        self._executor = executor
        self._warn_fraction = warn_fraction
        self._warn = warn_fn
        group.gauge("causal-log.max-occupancy", self.max_occupancy)
        group.gauge("causal-log.total-rows", self.total_rows)

    def max_occupancy(self) -> float:
        sizes = self._executor.log_sizes()
        cap = self._executor.compiled.log_capacity
        return float(sizes.max()) / cap if sizes.size else 0.0

    def total_rows(self) -> int:
        return int(self._executor.log_sizes().sum())

    def check(self) -> bool:
        occ = self.max_occupancy()
        if occ >= self._warn_fraction:
            self._warn(
                f"causal log occupancy {occ:.0%} >= {self._warn_fraction:.0%}"
                f" — checkpoint soon or determinants will be overwritten")
            return True
        return False


class MetricsEndpoint:
    """Serves the registry over HTTP: ``/metrics`` in Prometheus
    exposition format, ``/metrics.json`` as a JSON snapshot, and
    ``/trace`` as the tracer's flight-recorder ring rendered as Chrome
    trace JSON. Runs on a daemon thread; scrape-only (no job control).
    It binds ``127.0.0.1`` and, by default, a free port (``address``).

    ``extra`` is a zero-arg callable returning additional name→value
    pairs merged into both metric views. ``tracer`` (any object with ``records()``)
    backs ``/trace``; without one the path 404s. ``history`` (an
    ``obs.MetricsHistory``) backs ``/metrics/history.json?since=TS&
    last=N``; a history without a ``sample_fn`` samples this
    endpoint's merged view, and an unstarted one is started (and owned
    — ``close()`` stops it)."""

    def __init__(self, registry: MetricRegistry, host: str = "127.0.0.1",
                 port: int = 0,
                 extra: Optional[Callable[[], Dict[str, Any]]] = None,
                 tracer=None, history=None):
        import http.server
        import urllib.parse as _urlparse

        reg = registry

        def merged():
            snap = reg.snapshot()
            if extra is not None:
                try:
                    snap.update(extra())
                except Exception as e:
                    snap["extra-error"] = repr(e)
            if tracer is not None and getattr(tracer, "enabled", False):
                # ring-overflow visibility: nonzero means the in-memory
                # flight recorder (and /trace) is TRUNCATED
                snap["trace.dropped-records"] = getattr(
                    tracer, "dropped", 0)
            return snap

        self._history = history
        self._owns_history = False
        if history is not None:
            if history.sample_fn is None:
                history.sample_fn = merged
            if not history.started:
                history.start()
                self._owns_history = True

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                url = _urlparse.urlsplit(self.path)
                route = url.path.rstrip("/")
                if route == "/metrics":
                    body = reg.prometheus_text(merged()).encode()
                    ctype = "text/plain; version=0.0.4"
                elif route == "/metrics.json":
                    body = json.dumps(merged(), default=str).encode()
                    ctype = "application/json"
                elif route == "/metrics/history.json" and \
                        history is not None:
                    q = _urlparse.parse_qs(url.query)

                    def _num(key, cast):
                        try:
                            return cast(q[key][0])
                        except (KeyError, IndexError, ValueError):
                            return None

                    body = json.dumps(
                        {"samples": history.query(
                            since=_num("since", float),
                            last=_num("last", int))},
                        default=str).encode()
                    ctype = "application/json"
                elif route == "/trace" and tracer is not None:
                    from clonos_tpu_torch.obs import chrome as _chrome
                    body = json.dumps(
                        _chrome.to_chrome(tracer.records())).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):        # quiet server
                pass

        self._srv = http.server.ThreadingHTTPServer((host, port), H)
        self.address = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._owns_history and self._history is not None:
            self._history.close()
