"""Gray-failure detection (port of ``clonos_tpu/obs/detect.py``): a
deterministic straggler scorer.

Gray failure — a worker that is alive but slow — has existed in this
repo only as an *injection* hook (``HeartbeatMonitor.lag``, the soak
``gray`` chaos event). Nothing detected it: the death timeout never
fires (the worker beats, late), the audit stays clean (the work is
correct, just slow), and the only witness is the paced load's latency
— by which time the SLO is already breached. This module closes that
gap with the same discipline as the ScalePolicy: a **pure scoring
function over pinnable snapshots**, so detection is deterministic,
unit-testable, and replayable bit-identically from logged inputs.

- :class:`GraySnapshot` — the per-fence evidence, fully quantized:
  peer-relative heartbeat ages (how far each worker's last beat lags
  the freshest peer — the gray signature; absolute age would flag the
  whole cluster between beat rounds), per-worker epoch-duration
  outliers, per-replica staleness, and the fence-stall delta. One
  canonical byte encoding, crc32-pinnable like ScaleSignals.
- :func:`detect_gray` — ``(snapshot, config, state) -> (verdict,
  state')``: score each worker (each threshold crossing is one
  reason), require the score to *sustain* ``sustain_fences``
  consecutive fences (one late beat is not a gray failure), emit the
  suspect set. No clocks, no I/O, no device.
- :class:`GrayFailureDetector` — the stateful facade the soak driver
  calls once per completed fence: runs the pure step, logs every
  (snapshot, verdict) pair for replay, emits ``health.gray-suspect`` /
  ``health.gray-cleared`` timeline events on transitions, and serves
  the ``cluster.health.suspects`` gauge. The suspect count feeds
  ``autoscale/signals.py`` as a new unhealthy-arm input — a policy
  must not re-cut a cluster around a worker it has just diagnosed as
  limping.

Zero overhead off: :class:`NullDetector` is the process default
(``on_fence`` a no-op), matching the NullTracer convention.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _q(pairs, nd=1) -> Tuple[Tuple[str, float], ...]:
    """Quantize + sort (worker, value) pairs into the canonical tuple
    form — equal evidence must encode to equal bytes."""
    return tuple(sorted((str(k), round(float(v), nd))
                        for k, v in dict(pairs).items()))


@dataclasses.dataclass(frozen=True)
class GraySnapshot:
    """One fence's health evidence. Pure data, fully quantized."""

    epoch: int = 0
    #: (worker, ms its last beat lags the freshest peer's), sorted
    hb_age_ms: Tuple[Tuple[str, float], ...] = ()
    #: (worker, its last epoch duration ms), sorted
    epoch_ms: Tuple[Tuple[str, float], ...] = ()
    #: (replica, staleness in epochs), sorted
    staleness: Tuple[Tuple[str, float], ...] = ()
    #: fence-stall delta: ms the last fence tail exceeded the median
    fence_stall_ms: float = 0.0

    def canonical(self) -> bytes:
        """The one byte encoding (sorted-key JSON) the crc covers."""
        return json.dumps(dataclasses.asdict(self),
                          sort_keys=True).encode()

    def crc(self) -> int:
        return zlib.crc32(self.canonical())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GraySnapshot":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for name in ("hb_age_ms", "epoch_ms", "staleness"):
            if name in kw:
                kw[name] = tuple((str(a), float(b)) for a, b in kw[name])
        return cls(**kw)

    @classmethod
    def build(cls, *, epoch: int, hb_age_ms=None, epoch_ms=None,
              staleness=None, fence_stall_ms: float = 0.0
              ) -> "GraySnapshot":
        """Quantizing constructor from plain dicts."""
        return cls(epoch=int(epoch),
                   hb_age_ms=_q(hb_age_ms or {}),
                   epoch_ms=_q(epoch_ms or {}),
                   staleness=_q(staleness or {}),
                   fence_stall_ms=round(float(fence_stall_ms), 1))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    #: a beat lagging the freshest peer by more than this is suspect
    hb_age_high_ms: float = 200.0
    #: an epoch slower than factor x the peer median is suspect
    epoch_outlier_factor: float = 3.0
    #: replica staleness (epochs) past this is suspect
    staleness_high: float = 2.0
    #: a fence stall past this corroborates an already-suspect worker
    fence_stall_high_ms: float = 500.0
    #: consecutive fences a nonzero score must persist
    sustain_fences: int = 2

    def __post_init__(self):
        if self.sustain_fences < 1:
            raise ValueError("sustain_fences must be >= 1")
        if self.epoch_outlier_factor <= 1.0:
            raise ValueError("epoch_outlier_factor must be > 1")


@dataclasses.dataclass(frozen=True)
class DetectorState:
    """Per-worker suspicion streaks, carried between fences
    (reconstructable by replaying the snapshot log — no hidden
    state)."""

    streaks: Tuple[Tuple[str, int], ...] = ()

    def as_dict(self) -> Dict[str, int]:
        return {k: v for k, v in self.streaks}


@dataclasses.dataclass(frozen=True)
class GrayVerdict:
    """What one fence's evidence says: the sustained suspects with
    their scores and reasons, pinned to the snapshot it was scored
    from."""

    epoch: int
    #: (worker, score, "reason+reason"), sorted by worker
    suspects: Tuple[Tuple[str, int, str], ...]
    #: all nonzero raw scores this fence (pre-sustain), sorted
    scores: Tuple[Tuple[str, int], ...]
    snapshot_crc: int

    def suspect_workers(self) -> List[str]:
        return [w for w, _, _ in self.suspects]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def score_gray(snap: GraySnapshot, cfg: DetectorConfig
               ) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
    """The raw per-worker score: one point per threshold crossing.
    Peer-relative everywhere — a gray worker lags its *peers*, while a
    cluster-wide slowdown moves the median and scores nobody."""
    scores: Dict[str, List[str]] = {}

    def hit(worker: str, reason: str) -> None:
        scores.setdefault(str(worker), []).append(reason)

    for worker, age in snap.hb_age_ms:
        if age > cfg.hb_age_high_ms:
            hit(worker, "hb-lag")
    med = _median([v for _, v in snap.epoch_ms])
    if med > 0.0:
        for worker, ms in snap.epoch_ms:
            if ms > cfg.epoch_outlier_factor * med:
                hit(worker, "epoch-outlier")
    for replica, stal in snap.staleness:
        if stal > cfg.staleness_high:
            hit(replica, "replica-stale")
    if snap.fence_stall_ms > cfg.fence_stall_high_ms:
        # corroboration, not accusation: a stalled fence names no
        # worker by itself, it strengthens existing evidence
        for worker in list(scores):
            hit(worker, "fence-stall")
    return {w: (len(r), tuple(r)) for w, r in scores.items()}


def detect_gray(snap: GraySnapshot, cfg: DetectorConfig,
                state: DetectorState
                ) -> Tuple[GrayVerdict, DetectorState]:
    """One pure detection step: fold this fence's scores into the
    suspicion streaks; a worker is a suspect once its streak reaches
    ``sustain_fences``. Same (snapshot, config, state) always yields
    the same (verdict, state') — the replay property."""
    raw = score_gray(snap, cfg)
    prev = state.as_dict()
    streaks = {w: prev.get(w, 0) + 1 for w in raw}
    suspects = tuple(sorted(
        (w, raw[w][0], "+".join(raw[w][1]))
        for w, streak in streaks.items()
        if streak >= cfg.sustain_fences))
    verdict = GrayVerdict(
        epoch=snap.epoch, suspects=suspects,
        scores=tuple(sorted((w, s) for w, (s, _) in raw.items())),
        snapshot_crc=snap.crc())
    return verdict, DetectorState(streaks=tuple(sorted(streaks.items())))


class NullDetector:
    """The disabled detector: no scoring, no events, no gauge."""

    enabled = False

    def on_fence(self, snap) -> None:
        return None

    def register_gauges(self, registry) -> None:
        pass

    def suspects(self) -> List[str]:
        return []


class GrayFailureDetector:
    """Stateful facade over the pure step: one ``on_fence`` call per
    completed fence. Keeps the (snapshot, verdict) log replay needs,
    emits timeline events on suspect-set transitions, serves the
    ``cluster.health.suspects`` gauge."""

    enabled = True

    def __init__(self, config: Optional[DetectorConfig] = None):
        self.cfg = config or DetectorConfig()
        self.state = DetectorState()
        #: the replay log: one {"snapshot":…, "crc":…, "verdict":…}
        #: per fence, in order
        self.log: List[dict] = []
        self._current: Dict[str, Tuple[int, str]] = {}
        self.events_emitted = 0

    def on_fence(self, snap: GraySnapshot) -> GrayVerdict:
        from clonos_tpu_torch.obs.timeline import get_timeline
        verdict, self.state = detect_gray(snap, self.cfg, self.state)
        self.log.append({"snapshot": json.loads(snap.canonical()),
                         "crc": snap.crc(),
                         "verdict": verdict.to_dict()})
        now = {w: (s, r) for w, s, r in verdict.suspects}
        tl = get_timeline()
        for w in sorted(set(now) - set(self._current)):
            self.events_emitted += 1
            if tl.enabled:
                tl.record("health.gray-suspect", worker=w,
                          epoch=snap.epoch, score=now[w][0],
                          reasons=now[w][1],
                          snapshot_crc=snap.crc())
            # A sustained suspect is a confirmed failure signal: hand
            # the flight recorder a bundle trigger (no-op when the
            # incident plane is disabled).
            from clonos_tpu_torch.obs.incident import get_incidents
            get_incidents().signal(
                "health.gray-suspect", epoch=snap.epoch, worker=w,
                score=now[w][0], reasons=now[w][1],
                snapshot_crc=snap.crc())
        for w in sorted(set(self._current) - set(now)):
            self.events_emitted += 1
            if tl.enabled:
                tl.record("health.gray-cleared", worker=w,
                          epoch=snap.epoch)
        self._current = now
        return verdict

    def suspects(self) -> List[str]:
        return sorted(self._current)

    def replay(self) -> List[GrayVerdict]:
        """Re-run the pure step over the logged snapshots and prove
        each verdict reproduces bit-identically (crc pin + verdict
        equality) — the autoscale DecisionLog discipline."""
        st = DetectorState()
        out = []
        for i, rec in enumerate(self.log):
            snap = GraySnapshot.from_dict(rec["snapshot"])
            if snap.crc() != rec["crc"]:
                raise ValueError(
                    f"detector log entry {i}: snapshot fails its crc "
                    f"pin ({snap.crc():#x} != {rec['crc']:#x})")
            v, st = detect_gray(snap, self.cfg, st)
            if v.to_dict() != rec["verdict"]:
                from clonos_tpu_torch.obs.incident import get_incidents
                get_incidents().signal(
                    "conformance.mismatch", epoch=snap.epoch,
                    source="detector-replay", entry=i)
                raise ValueError(
                    f"detector log entry {i} does not replay "
                    f"bit-identically: {v.to_dict()}")
            out.append(v)
        return out

    def register_gauges(self, registry) -> None:
        """``cluster.health.*`` gauges — ride the same rollup every
        other observer reads; ``python -m clonos_tpu_torch top`` renders the health:
        row from them."""
        g = registry.group("cluster.health")
        g.gauge("suspects", lambda: len(self._current))
        g.gauge("gray-events", lambda: self.events_emitted)
        g.gauge("fences-scored", lambda: len(self.log))


# --- process-global detector -------------------------------------------------

_global_detector = NullDetector()
_global_lock = threading.Lock()


def get_detector():
    """The process detector (NullDetector unless configured)."""
    return _global_detector


def configure_detector(config: Optional[DetectorConfig] = None
                       ) -> GrayFailureDetector:
    """Install a real gray-failure detector (the opt-in gate)."""
    global _global_detector
    with _global_lock:
        _global_detector = GrayFailureDetector(config)
        return _global_detector


def reset_detector() -> None:
    """Back to the disabled NullDetector (tests)."""
    global _global_detector
    with _global_lock:
        _global_detector = NullDetector()
