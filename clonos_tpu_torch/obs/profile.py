"""Overhead attribution profiler: what does fault tolerance cost? (port
of ``clonos_tpu/obs/profile.py``).

Tracing (``obs/trace.py``) shows *when* things happen; this module
answers *what fraction of an epoch the fault-tolerance machinery costs*,
continuously, on a live job:

- :class:`Profiler` hands out **section timers** (context managers) the
  hot paths wrap around their work: the block dispatch itself (user
  compute with the in-program causal-log and ring appends), the epoch
  roll, in-flight truncation, asynchronous determinant appends, the lean
  snapshot, digest sealing, ledger writes, the fence's health read,
  spill (the tiered stores' writer threads report their own
  ``spill-write`` and recovery its ``refill``, ``storage/tiered.py``) and
  timer advancement. Each section feeds an ``overhead.<section>-ms``
  histogram in the bound metric group.
- Sections are tagged ``kind="ft"`` (fault-tolerance overhead) or
  ``kind="compute"`` (user work). :meth:`Profiler.rollup`, called at
  each epoch fence, derives the ``overhead.ft-fraction`` gauge: FT
  seconds / total attributed seconds over the window since the last
  rollup.
- **Device fencing**: wall-clocking an asynchronous CUDA launch measures
  the enqueue. :meth:`Profiler.fence` waits for the card
  (``utils/devsync.device_sync``), but ONLY on an enabled profiler with
  ``fence_device=True``, because the wait serialises the pipeline. The
  disabled :class:`NullProfiler` returns the value untouched, so default
  runs keep their asynchronous dispatch exactly as before.
- **Nothing by default**: the process-global profiler starts as
  :class:`NullProfiler` (every method a no-op returning neutral values);
  enabling is an explicit opt-in (:func:`configure_profile`, or the
  ``observability.profile.enabled`` option through
  ``ClusterRunner.from_config``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict

from clonos_tpu_torch.utils import devsync as _devsync

#: section kinds
FT = "ft"              # fault-tolerance machinery (the overhead)
COMPUTE = "compute"    # user work (the denominator's other half)


class _NullSection:
    """No-op context manager handed out by the disabled profiler."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SECTION = _NullSection()


class NullProfiler:
    """The disabled profiler: every operation is a no-op and ``fence``
    passes values through untouched, so instrumented call sites add no
    host work and no device synchronisation."""

    enabled = False

    def section(self, name: str, kind: str = FT) -> _NullSection:
        return _NULL_SECTION

    def observe(self, name: str, dur_s: float, kind: str = FT) -> None:
        pass

    def fence(self, value):
        return value

    def bind(self, group) -> None:
        pass

    def rollup(self) -> float:
        return 0.0

    def ft_fraction(self) -> float:
        return 0.0

    def lifetime_ft_fraction(self) -> float:
        return 0.0

    def lifetime(self) -> Dict[str, float]:
        return {}

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False, "ft_fraction": 0.0,
                "lifetime_ft_fraction": 0.0, "sections": {}}

    def close(self) -> None:
        pass


class _Section:
    """A live section timer: attributes the wall time of its body to one
    named section. Exceptions propagate; the time is still attributed."""

    __slots__ = ("_profiler", "name", "kind", "_t0")

    def __init__(self, profiler: "Profiler", name: str, kind: str):
        self._profiler = profiler
        self.name = name
        self.kind = kind
        self._t0 = 0.0

    def __enter__(self) -> "_Section":
        self._t0 = self._profiler._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._profiler.observe(
            self.name, self._profiler._clock() - self._t0, self.kind)
        return False


class Profiler:
    """Process profiler: per-section cumulative timers with an epoch
    rollup into the overhead fraction.

    Thread-safe: the tiered stores' writer threads observe concurrently
    with the main loop's epoch sections. A section's histogram goes to
    the bound metric group (``bind``, called by the runner that owns the
    registry); an unbound profiler still accumulates."""

    enabled = True

    def __init__(self, clock=time.monotonic, fence_device: bool = True):
        self._clock = clock
        self._fence_device = fence_device
        self._lock = threading.Lock()
        self._group = None
        self._cum: Dict[str, float] = {}      # window since last rollup
        self._kind: Dict[str, str] = {}
        self._life: Dict[str, float] = {}     # process lifetime
        self._last_fraction = 0.0

    # --- section timing ------------------------------------------------------

    def section(self, name: str, kind: str = FT) -> _Section:
        """Context manager attributing its body's wall time to ``name``.
        Wrap the body's device result in :meth:`fence`, or the timer
        only measures the launch."""
        return _Section(self, name, kind)

    def observe(self, name: str, dur_s: float, kind: str = FT) -> None:
        """Attribute an already-measured duration. Durations derived by
        subtraction can go epsilon-negative; they clamp at zero so the
        windows and histograms never run backwards."""
        if dur_s < 0.0:
            dur_s = 0.0
        group = None
        with self._lock:
            self._cum[name] = self._cum.get(name, 0.0) + dur_s
            self._life[name] = self._life.get(name, 0.0) + dur_s
            self._kind[name] = kind
            group = self._group
        if group is not None:
            group.histogram(f"overhead.{name}-ms").update(dur_s * 1e3)

    def fence(self, value):
        """Wait until the card has run the work behind ``value`` (a tensor
        tree), so the enclosing section measures execution, not the
        launch. Returns the value."""
        if self._fence_device and value is not None:
            _devsync.device_sync(value)
        return value

    # --- metrics binding -----------------------------------------------------

    def bind(self, group) -> None:
        """Attach the metric group that receives the
        ``overhead.<section>-ms`` histograms and the
        ``overhead.ft-fraction`` gauge."""
        with self._lock:
            self._group = group
        group.gauge("overhead.ft-fraction", self.ft_fraction)

    # --- rollup --------------------------------------------------------------

    def rollup(self) -> float:
        """Close the attribution window (at each epoch fence): FT seconds
        / total attributed seconds since the last rollup. An empty window
        keeps the last fraction."""
        with self._lock:
            ft = sum(v for n, v in self._cum.items()
                     if self._kind.get(n, FT) == FT)
            total = sum(self._cum.values())
            self._cum.clear()
            if total > 0.0:
                self._last_fraction = ft / total
        return self._last_fraction

    def ft_fraction(self) -> float:
        """The most recent rollup's overhead fraction."""
        return round(self._last_fraction, 6)

    def lifetime_ft_fraction(self) -> float:
        """FT / total over the profiler's lifetime."""
        with self._lock:
            ft = sum(v for n, v in self._life.items()
                     if self._kind.get(n, FT) == FT)
            total = sum(self._life.values())
        return ft / total if total > 0.0 else 0.0

    def lifetime(self) -> Dict[str, float]:
        """Cumulative seconds per section over the profiler's lifetime."""
        with self._lock:
            return dict(self._life)

    def snapshot(self) -> Dict[str, Any]:
        """The gauge value, the lifetime fraction, and per-section
        lifetime seconds with kinds."""
        with self._lock:
            sections = {n: {"seconds": round(v, 6),
                            "kind": self._kind.get(n, FT)}
                        for n, v in sorted(self._life.items())}
        return {
            "enabled": True,
            "ft_fraction": self.ft_fraction(),
            "lifetime_ft_fraction": round(
                self.lifetime_ft_fraction(), 6),
            "sections": sections,
        }

    def close(self) -> None:
        pass


# --- process-global profiler -------------------------------------------------

_global_profiler: Any = NullProfiler()
_global_lock = threading.Lock()


def get_profiler():
    """The process profiler (NullProfiler unless
    :func:`configure_profile` ran)."""
    return _global_profiler


def configure_profile(**kw) -> Profiler:
    """Install a real process profiler (the opt-in gate for all overhead
    instrumentation)."""
    global _global_profiler
    with _global_lock:
        _global_profiler = Profiler(**kw)
        return _global_profiler


def reset_profile() -> None:
    """Back to the disabled NullProfiler."""
    global _global_profiler
    with _global_lock:
        _global_profiler = NullProfiler()
