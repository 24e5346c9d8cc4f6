"""Exactly-once auditing: per-epoch digest seal + process-global switch.

Port of ``clonos_tpu/obs/audit.py``: the auditor, the digest extraction,
the global switch and the ledger diff that maps two differently
partitioned runs onto each other (:func:`diff_ledgers_cross`; the
rescale protocol that seals such ledgers is not ported yet). A zero-overhead :class:`NullAuditor` is the
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

    def adopt(self, entries) -> None:
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

    def adopt(self, entries) -> None:
        """Carry a predecessor incarnation's sealed entries forward (a
        live re-cut: one ledger spans the handoff). Where both sealed an
        epoch, the existing seal wins."""
        with self._lock:
            for e in entries:
                self._sealed.setdefault(int(e["epoch"]), dict(e))

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


# --- cross-partition ledger mapping ------------------------------------------


def key_group_directory(old_parallelism: int, new_parallelism: int,
                        num_key_groups: int
                        ) -> tuple:
    """The old↔new group directory of a re-cut: for every key group,
    ``(kg, old_subtask, new_subtask)`` under the reference range
    assignment (``kg * parallelism // num_key_groups`` —
    parallel/routing.subtask_for_key_group). The reference's
    ``ClusterRunner.rescale_live`` walks it to migrate ownership, and
    :func:`diff_ledgers_cross` uses the same assignment to know two
    differently-cut ledgers describe one job."""
    old_p, new_p, g = (int(old_parallelism), int(new_parallelism),
                       int(num_key_groups))
    if min(old_p, new_p, g) < 1:
        raise ValueError(
            f"key_group_directory: positive sizes required, got "
            f"old={old_p} new={new_p} groups={g}")
    return tuple((kg, (kg * old_p) // g, (kg * new_p) // g)
                 for kg in range(g))


def moved_key_groups(directory) -> tuple:
    """Key groups whose owner changes across the re-cut."""
    return tuple(kg for kg, old_s, new_s in directory if old_s != new_s)


def channel_directory(layout_a, layout_b) -> Dict[int, dict]:
    """Map two partition layouts of the SAME topology onto each other:
    ``{vertex_id: {"parallelism": (pa, pb), "log_flats": (range_a,
    range_b)}}`` where ``log_flats`` are the ``log/<flat>`` channel id
    ranges each side's vertex occupies in the stacked-log layout
    (JobGraph.subtask_base). Raises if the layouts disagree on the
    vertex set — that is a different job, not a re-cut."""
    la = {int(v): int(p) for v, p in layout_a}
    lb = {int(v): int(p) for v, p in layout_b}
    if sorted(la) != sorted(lb):
        raise ValueError(
            f"channel_directory: vertex sets differ "
            f"({sorted(la)} vs {sorted(lb)}) — not two cuts of one job")
    out: Dict[int, dict] = {}
    base_a = base_b = 0
    for vid in sorted(la):
        pa, pb = la[vid], lb[vid]
        out[vid] = {
            "parallelism": (pa, pb),
            "log_flats": (range(base_a, base_a + pa),
                          range(base_b, base_b + pb)),
        }
        base_a += pa
        base_b += pb
    return out


def _diff_entry_mapped(ea: dict, eb: dict) -> List[str]:
    """Layout-invariant comparison of two ledger entries sealed under
    DIFFERENT cuts: per-vertex ring record counts and ``ringsum``
    content fingerprints must match exactly (the record streams are
    partition-independent); ``log/<flat>`` channels are structural
    per-lane surfaces — their flat ids are checked against the stamped
    layouts via the channel directory, their content is not comparable
    across cuts."""
    ep = int(ea["epoch"])
    out: List[str] = []
    dirmap = channel_directory(ea["layout"], eb["layout"])
    ca = ea.get("channels") or {}
    cb = eb.get("channels") or {}
    for side, chans, idx in (("first", ca, 0), ("second", cb, 1)):
        flats = {int(name[len("log/"):]) for name in chans
                 if name.startswith("log/")}
        legal = {f for v in dirmap.values()
                 for f in v["log_flats"][idx]}
        stray = sorted(flats - legal)
        if stray:
            out.append(
                f"epoch {ep}: {side} ledger has log channel(s) for "
                f"flat(s) {stray} outside its stamped layout")
    for name in sorted(set(ca) | set(cb)):
        if not name.startswith(("ring/", "ringsum/")):
            continue
        a, b = ca.get(name), cb.get(name)
        if a is None or b is None:
            missing = "first" if a is None else "second"
            out.append(f"epoch {ep} channel {name}: missing from "
                       f"{missing} ledger")
            continue
        if int(a["count"]) != int(b["count"]):
            out.append(
                f"epoch {ep} channel {name}: record count "
                f"{b['count']} != expected {a['count']}")
        elif name.startswith("ringsum/") and a["fp"] != b["fp"]:
            out.append(
                f"epoch {ep} channel {name}: content sum {b['fp']} != "
                f"expected {a['fp']} (count matches: a record was "
                f"lost AND another duplicated, or content changed)")
    return out


def diff_ledgers_cross(expected: List[dict],
                       actual: List[dict]) -> List[str]:
    """Ledger diff that survives a re-cut: epochs whose entries carry
    the SAME partition layout (or none — pre-layout ledgers) compare
    exactly (obs/digest.diff — every channel, bit for bit); epochs
    sealed under DIFFERENT cuts of the same topology compare through
    the group directory on the layout-invariant channels. The CLI's
    ``audit A --diff B`` surface and the root-cause analyzer's epoch
    bisection (obs/rootcause.py)."""
    from clonos_tpu_torch.obs import digest as _digest

    ea = {int(e["epoch"]): e for e in expected}
    aa = {int(e["epoch"]): e for e in actual}
    out: List[str] = []
    for ep in sorted(set(ea) | set(aa)):
        if ep not in aa:
            out.append(f"epoch {ep}: missing from second ledger")
            continue
        if ep not in ea:
            out.append(f"epoch {ep}: missing from first ledger")
            continue
        la = ea[ep].get("layout")
        lb = aa[ep].get("layout")
        if la == lb:
            d = _digest.diff(_digest.EpochDigest.from_entry(ea[ep]),
                             _digest.EpochDigest.from_entry(aa[ep]))
            if d is not None:
                out.append(f"epoch {ep} channel {d[0]}: {d[1]}")
        elif la is None or lb is None:
            out.append(
                f"epoch {ep}: one ledger is layout-stamped and the "
                f"other is not — cannot choose exact vs mapped diff")
        else:
            try:
                out.extend(_diff_entry_mapped(ea[ep], aa[ep]))
            except ValueError as e:
                out.append(f"epoch {ep}: {e}")
    return out


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
