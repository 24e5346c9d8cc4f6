"""Signal plane: one typed snapshot of cluster load per completed fence
(port of ``clonos_tpu/autoscale/signals.py``).

The autoscaler never reads raw device state — it samples the same
metric rollup every other observer uses (the HEARTBEAT piggyback /
``cluster_metrics()`` snapshot, ``top``'s input) and distills
it into a :class:`ScaleSignals` row: offered vs achieved throughput,
in-flight ring occupancy, read-tier staleness and p99, per-shard
health. A rolling window smooths the rate ratio so one noisy fence
cannot trip the policy; everything is quantized to fixed decimals so
the snapshot has ONE canonical byte encoding — its crc32 is what the
logged ``SCALE`` determinant pins, and what replay integrity checks
against (autoscale/controller.py).
"""

from __future__ import annotations

import dataclasses
import json
import zlib
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

#: rolling window length, in completed fences, for the load ratio.
DEFAULT_WINDOW = 4


def _pick(snap: Dict[str, Any], name: str, default: float = 0.0) -> float:
    """Fetch a metric by suffix from a registry snapshot: scopes prefix
    the name (``soak.rate``, ``job.<name>.backpressure...``), so match
    the un-scoped suffix the way the ``top`` verb does. Non-numeric
    values (gauge errors surface as strings) fall back to the default."""
    for key in (name,):
        if key in snap and isinstance(snap[key], (int, float)):
            return float(snap[key])
    suffix = "." + name
    for key, val in snap.items():
        if key.endswith(suffix) and isinstance(val, (int, float)):
            return float(val)
    return default


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """What the policy saw at one completed fence. Pure data, fully
    quantized — equal snapshots encode to equal bytes."""

    epoch: int = 0              # the fence this snapshot describes
    load: float = 0.0           # offered / achieved rate, window-smoothed
    backlog_chunks: int = 0     # token-bucket chunks behind schedule
    ring_occupancy: float = 0.0  # in-flight ring fill fraction [0, 1]
    p99_read_ms: float = 0.0    # serve-tier read latency
    max_staleness: int = 0      # worst replica staleness, epochs
    replicas_alive: int = 0
    replicas_total: int = 0
    workers: int = 0            # current keyed parallelism
    failed_subtasks: int = 0    # per-shard health: nonzero = mid-recovery
    unfenced: bool = False      # epoch tail not yet drained at sampling
    gray_suspects: int = 0      # sustained gray-failure suspects
    #                             (obs/detect.py); nonzero = unhealthy

    def canonical(self) -> bytes:
        """The one byte encoding (sorted-key JSON) the crc covers."""
        return json.dumps(dataclasses.asdict(self),
                          sort_keys=True).encode()

    def crc(self) -> int:
        return zlib.crc32(self.canonical())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScaleSignals":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class SignalAggregator:
    """Rolling-window smoothing over per-fence metric snapshots.

    ``sample_from`` takes the registry snapshot plus the few facts the
    registry does not carry (current parallelism, failed set size,
    fence-drain status) and returns the quantized :class:`ScaleSignals`.
    The load ratio is averaged over the last ``window`` fences; all
    other signals are instantaneous — staleness and health must not be
    smoothed or the policy would rescale on stale facts.
    """

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._ratios: Deque[float] = deque(maxlen=self.window)
        self.last: Optional[ScaleSignals] = None

    def sample_from(self, snap: Dict[str, Any], *, epoch: int,
                    workers: int, failed_subtasks: int = 0,
                    unfenced: bool = False,
                    gray_suspects: int = 0) -> ScaleSignals:
        offered = _pick(snap, "offered-rate",
                        _pick(snap, "target-rate"))
        achieved = _pick(snap, "rate")
        ratio = offered / achieved if achieved > 0.0 else (
            0.0 if offered <= 0.0 else float(self.window))
        self._ratios.append(min(ratio, 100.0))
        load = round(sum(self._ratios) / len(self._ratios), 2)
        staleness = [
            v for k, v in snap.items()
            if k.endswith(".staleness-epochs")
            and isinstance(v, (int, float))]
        sig = ScaleSignals(
            epoch=int(epoch),
            load=load,
            backlog_chunks=int(_pick(snap, "backlog-chunks")),
            ring_occupancy=round(
                _pick(snap, "backpressure.inflight-occupancy"), 3),
            p99_read_ms=round(_pick(snap, "p99-read-ms"), 3),
            max_staleness=int(max(staleness)) if staleness else 0,
            replicas_alive=int(_pick(snap, "replicas-alive")),
            replicas_total=len(staleness),
            workers=int(workers),
            failed_subtasks=int(failed_subtasks),
            unfenced=bool(unfenced),
            gray_suspects=int(gray_suspects),
        )
        self.last = sig
        return sig

    def reset(self) -> None:
        self._ratios.clear()


def signals_for_level(level: int, *, epoch: int, workers: int,
                      failed_subtasks: int = 0,
                      replicas: int = 1) -> ScaleSignals:
    """Synthesize a snapshot for an abstract model load level (0 low,
    1 steady, 2 high) — the bridge between the reference's
    ``ScalePolicyModel`` traces and the real controller. The values are
    chosen to sit squarely past the default hysteresis thresholds."""
    load = {0: 0.4, 1: 1.0, 2: 1.6}[int(level)]
    return ScaleSignals(epoch=int(epoch), load=load,
                        replicas_alive=int(replicas),
                        replicas_total=int(replicas),
                        workers=int(workers),
                        failed_subtasks=int(failed_subtasks))
