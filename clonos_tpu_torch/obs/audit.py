"""Exactly-once auditing: per-epoch digest seal + process-global switch.

Port of ``clonos_tpu/obs/audit.py`` (the auditor, the digest extraction
and the global switch; mapping ledgers across differently partitioned
runs is not ported yet). A zero-overhead :class:`NullAuditor` is the
default (``enabled`` is a class attribute, so an audit-off fence pays one
attribute load and no device read); :func:`configure_audit` installs a
live :class:`Auditor`.

Digest computation lives in :func:`digest_epoch_window`, fed by
``LocalExecutor.epoch_window`` — the single extraction path shared by the
live seal (``ClusterRunner.run_epoch``) and the recovery-time recompute
(``causal.recovery.AuditValidator``), so both fold identical chunk
boundaries. The bytes folded are the reference's: little-endian int32
rows and records, so a port ledger equals a reference ledger of the same
run.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.obs.digest import EpochDigest

#: accepted divergence policies
DIVERGENCE_POLICIES = ("warn", "abort")


class NullAuditor:
    """Audit disabled: every operation is a no-op. The default."""

    enabled = False
    on_divergence = "warn"

    def seal(self, digest: EpochDigest) -> None:
        pass

    def ledger(self) -> List[dict]:
        return []

    @property
    def last_epoch(self) -> int:
        return -1

    @property
    def epochs_sealed(self) -> int:
        return 0

    def close(self) -> None:
        pass


class Auditor(NullAuditor):
    """Live auditor: records sealed digests and carries the divergence
    policy."""

    enabled = True

    def __init__(self, on_divergence: str = "warn"):
        if on_divergence not in DIVERGENCE_POLICIES:
            raise ValueError(
                f"on_divergence must be one of {DIVERGENCE_POLICIES}, "
                f"got {on_divergence!r}")
        self.on_divergence = on_divergence
        self._sealed: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def seal(self, digest: EpochDigest) -> None:
        with self._lock:
            self._sealed[digest.epoch] = digest.to_entry()

    def ledger(self) -> List[dict]:
        with self._lock:
            return [self._sealed[e] for e in sorted(self._sealed)]

    @property
    def last_epoch(self) -> int:
        with self._lock:
            return max(self._sealed) if self._sealed else -1

    @property
    def epochs_sealed(self) -> int:
        with self._lock:
            return len(self._sealed)


# --- digest extraction -------------------------------------------------------

#: 2^64 wrap for the order-insensitive content sums
_SUM_MASK = (1 << 64) - 1


def _content_sum(keys, values, timestamps) -> int:
    """Order- and lane-layout-insensitive content accumulator: the sum
    mod 2^64 of a 64-bit avalanche hash (splitmix64 finalizer) per
    (key, value, timestamp) record. Host numpy ``uint64``: torch has no
    full unsigned 64-bit arithmetic on the CPU."""
    k = np.ascontiguousarray(keys, np.int32).astype(np.uint64)
    v = np.ascontiguousarray(values, np.int32).astype(np.uint64)
    t = np.ascontiguousarray(timestamps, np.int32).astype(np.uint64)
    x = (k * np.uint64(0x9E3779B97F4A7C15)
         + v * np.uint64(0xC2B2AE3D27D4EB4F)
         + t * np.uint64(0x165667B19E3779F9))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return int(np.sum(x, dtype=np.uint64)) & _SUM_MASK


def digest_epoch_window(epoch: int, window: dict,
                        layout=None) -> EpochDigest:
    """Fold one epoch's causal surface (``LocalExecutor.epoch_window``
    output) into an :class:`EpochDigest`.

    Chunk-boundary contract (chain folds are order-sensitive): each
    ``log/<flat>`` channel is folded as ONE chunk — the epoch's
    determinant-row window in log order; each ``ring/v<vid>`` channel is
    folded ONE chunk PER STEP — the step's valid (key, value, timestamp)
    records flattened in (lane, slot) order. Beside each ring chain, a
    partition-invariant ``ringsum/v<vid>`` channel folds the epoch's
    order-insensitive content sum. ``layout`` stamps the partition shape
    (``((vertex_id, parallelism), ...)``) into the digest."""
    dg = EpochDigest(epoch, layout=layout)
    for flat, rows in sorted(window.get("logs", {}).items()):
        rows = np.ascontiguousarray(rows, np.int32)
        dg.fold(f"log/{flat}", det.to_bytes(rows), count=rows.shape[0])
        if rows.shape[0]:
            counts = np.bincount(rows[:, det.LANE_TAG],
                                 minlength=det.NUM_TAGS)
            for tag in range(det.NUM_TAGS):
                dg.count_det(det.TAG_NAMES[tag], int(counts[tag]))
    for vid, steps in sorted(window.get("rings", {}).items()):
        chan = f"ring/v{vid}"
        total = 0
        csum = 0
        for keys, values, timestamps in steps:
            data = (np.ascontiguousarray(keys, np.int32).tobytes()
                    + np.ascontiguousarray(values, np.int32).tobytes()
                    + np.ascontiguousarray(timestamps, np.int32).tobytes())
            n = int(np.asarray(keys).shape[0])
            dg.fold(chan, data, count=n)
            total += n
            csum = (csum + _content_sum(keys, values, timestamps)) \
                & _SUM_MASK
        if steps:
            dg.fold(f"ringsum/v{vid}", csum.to_bytes(8, "little"),
                    count=total)
    return dg


# --- process-global auditor --------------------------------------------------

_global_auditor: NullAuditor = NullAuditor()
_global_lock = threading.Lock()


def get_auditor() -> NullAuditor:
    return _global_auditor


def configure_audit(on_divergence: str = "warn") -> Auditor:
    """Install a process-global live auditor (the default a ClusterRunner
    built with ``audit=None`` inherits)."""
    global _global_auditor
    with _global_lock:
        old = _global_auditor
        _global_auditor = Auditor(on_divergence=on_divergence)
        old.close()
        return _global_auditor


def reset_audit() -> None:
    global _global_auditor
    with _global_lock:
        old = _global_auditor
        _global_auditor = NullAuditor()
        old.close()
