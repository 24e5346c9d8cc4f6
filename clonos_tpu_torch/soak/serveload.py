"""Read side of a mixed soak load: routed reads with their own SLO
windows (port of ``clonos_tpu/soak/serveload.py``, over the port's
:class:`~clonos_tpu_torch.runtime.serve.ServeTier`).

The soak driver pumps a :class:`ServeLoad` once per ingest chunk, so
every read burst contends with live ingestion on the same clock — the
read p50/p99 reported here is measured UNDER write load, not against an
idle cluster (the honest-measurement half of the read-path tentpole).
Each pump samples the tier's staleness too, so a ``replica-kill``
mid-run is visible as the spike-then-recovery the acceptance criteria
demand, and the error counter is the zero-client-errors witness: the
router must degrade (re-route to the owner), never throw.
"""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

from .slo import quantile


class ServeLoad:
    """Seeded random point-read load against a ServeTier's router."""

    def __init__(self, tier, vertex_id: int, num_keys: int,
                 reads_per_pump: int = 32, slo_ms: float = 250.0,
                 window_s: float = 5.0, seed: int = 7,
                 state: str = "acc"):
        self.tier = tier
        self.router = tier.router
        self.vertex_id = int(vertex_id)
        self.num_keys = int(num_keys)
        self.reads_per_pump = int(reads_per_pump)
        self.slo_ms = float(slo_ms)
        self.window_s = float(window_s)
        self.state = state
        self.rng = np.random.RandomState(seed)
        self.reads = 0
        self.pumps = 0
        #: client-visible failures — the replica-kill acceptance bar is
        #: that this stays 0 (degradation is reroutes, not errors)
        self.errors = 0
        self.last_error: Optional[str] = None
        self.latencies_ms: List[float] = []
        self.staleness_samples: List[int] = []
        self.staleness_peak = 0
        self.staleness_final = 0
        self.windows: List[Dict[str, Any]] = []
        self._win_start = 0.0
        self._win_lat: List[float] = []
        self._win_reads = 0
        self._win_reroutes0 = 0
        self._win_stal_max = 0
        self._t0: Optional[float] = None

    def pump(self, now_s: float, final: bool = False) -> None:
        """One read burst on the soak clock: a batched routed read of
        ``reads_per_pump`` random keys. ``final`` closes the last
        window and records the post-drain staleness (the recovery
        witness after a replica-kill)."""
        if self._t0 is None:
            self._t0 = now_s
            self._win_start = now_s
            self._win_reroutes0 = self.router.reroutes
        keys = self.rng.randint(0, self.num_keys,
                                size=self.reads_per_pump)
        t0 = _time.monotonic()
        try:
            out = self.router.query_batch(self.vertex_id, keys,
                                          state=self.state)
            stal = max((int(s) for s in out["staleness_epochs"]),
                       default=0)
        except Exception as e:      # noqa: BLE001 — ANY throw is a fail
            self.errors += 1
            self.last_error = repr(e)
            stal = 0
        lat_ms = (_time.monotonic() - t0) * 1e3
        self.pumps += 1
        self.reads += self.reads_per_pump
        self.tier.mark_reads(self.reads_per_pump)
        self.latencies_ms.append(lat_ms)
        self._win_lat.append(lat_ms)
        self._win_reads += self.reads_per_pump
        tier_stal = max([stal] + self.tier.staleness())
        self.staleness_samples.append(tier_stal)
        self.staleness_peak = max(self.staleness_peak, tier_stal)
        self.staleness_final = tier_stal
        self._win_stal_max = max(self._win_stal_max, tier_stal)
        if final or now_s - self._win_start >= self.window_s:
            self._close_window(now_s)

    def _close_window(self, now_s: float) -> None:
        lat = self._win_lat
        self.windows.append({
            "start_s": round(self._win_start, 3),
            "end_s": round(now_s, 3),
            "reads": self._win_reads,
            "p50_ms": round(quantile(lat, 0.50), 3),
            "p99_ms": round(quantile(lat, 0.99), 3),
            "reroutes": self.router.reroutes - self._win_reroutes0,
            "staleness_max": self._win_stal_max,
            "breached": bool(lat) and quantile(lat, 0.99) > self.slo_ms,
        })
        self._win_start = now_s
        self._win_lat = []
        self._win_reads = 0
        self._win_reroutes0 = self.router.reroutes
        self._win_stal_max = 0

    def summary(self) -> Dict[str, Any]:
        r = self.router
        wall = (self.latencies_ms and self._t0 is not None)
        span_s = max((self.windows[-1]["end_s"] - self._t0)
                     if self.windows and self._t0 is not None else 0.0,
                     1e-9)
        breached = [w for w in self.windows if w["breached"]]
        return {
            "reads": self.reads,
            "read_qps": round(self.reads / span_s, 1) if wall else 0.0,
            "errors": self.errors,
            "last_error": self.last_error,
            "p50_read_ms": round(quantile(self.latencies_ms, 0.50), 3),
            "p99_read_ms": round(quantile(self.latencies_ms, 0.99), 3),
            "reroutes": r.reroutes,
            "replica_reads": r.replica_reads,
            "owner_reads": r.owner_reads,
            "staleness_peak": self.staleness_peak,
            "staleness_final": self.staleness_final,
            "slo_ms": self.slo_ms,
            "windows": self.windows,
            "windows_breached": len(breached),
            # the read tier passed iff clients saw zero errors AND every
            # read window met its latency SLO
            "ok": self.errors == 0 and not breached,
        }
