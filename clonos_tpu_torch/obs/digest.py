"""Per-epoch audit digests: the unit of exactly-once evidence.

The port's own copy of ``clonos_tpu/obs/digest.py`` (that module is
JAX-free, but the port imports nothing of the reference package). The
byte format is the reference's, so a port ledger and a reference ledger
of the same run compare equal under either package's
:func:`diff_ledgers`.

A digest summarizes one closed epoch's causal surface as a set of named
**channels** (``log/<flat>`` for a subtask's determinant-log window,
``ring/v<vid>`` for a vertex's in-flight output ring window) plus a
determinant count per type. Each channel carries an ordered blake2b hash
chain over the bytes folded into it; the epoch's combined fingerprint is
the XOR of the per-channel finals, so channels may be folded in ANY
interleaving (and partial digests from disjoint channel sets merged in
any association) without changing the result — the property the unit
tests pin.

The chain is NOT associative over arbitrary chunk splits of one channel:
the live seal and the recovery-time recompute must fold identical chunk
boundaries, which is why both go through the same extraction helper
(``LocalExecutor.epoch_window`` + :func:`digest_epoch_window` in
``obs/audit.py``).

Only the standard library is used (``hashlib.blake2b``): the audit layer
must not pull optional native deps into the failure path.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

#: fingerprint width; 8 bytes keeps ledger entries and wire frames small
#: while collisions stay irrelevant for divergence *detection* (an audit
#: alarm triggers investigation, not an automated rollback).
DIGEST_BYTES = 8

#: every chain starts from a versioned seed so a format change can never
#: silently compare as equal against an old ledger.
_SEED = b"clonos-audit-v1"


def _init(channel: str) -> bytes:
    """Chain seed for one channel (bound to the channel name, so two
    channels with identical payload bytes still combine distinctly)."""
    return hashlib.blake2b(_SEED + channel.encode(),
                           digest_size=DIGEST_BYTES).digest()


def chain(state: bytes, data: bytes) -> bytes:
    """One fold step of a channel's ordered hash chain."""
    return hashlib.blake2b(state + data, digest_size=DIGEST_BYTES).digest()


class EpochDigest:
    """Digest of one epoch: per-channel (count, chain fingerprint) plus
    determinant counts per tag name. Mutable while folding; sealed form
    is the JSON-able dict from :meth:`to_entry`.

    ``layout`` optionally stamps the partition shape the digest was
    sealed under — ``((vertex_id, parallelism), ...)`` — so a ledger
    diff can tell "same job, different cut" from "different content"
    and fall back to the layout-invariant channels
    (the reference's ``obs/audit.diff_ledgers_cross``). It is metadata, not
    content: equality, :func:`diff` and :meth:`combined` all ignore
    it."""

    __slots__ = ("epoch", "channels", "det_counts", "layout")

    def __init__(self, epoch: int,
                 channels: Optional[Dict[str, Tuple[int, bytes]]] = None,
                 det_counts: Optional[Dict[str, int]] = None,
                 layout: Optional[Tuple[Tuple[int, int], ...]] = None):
        self.epoch = int(epoch)
        #: channel name -> (records folded, current chain state)
        self.channels: Dict[str, Tuple[int, bytes]] = dict(channels or {})
        self.det_counts: Dict[str, int] = dict(det_counts or {})
        self.layout = (tuple((int(v), int(p)) for v, p in layout)
                       if layout else None)

    # --- folding -------------------------------------------------------------

    def fold(self, channel: str, data: bytes, count: int = 1) -> None:
        """Fold one chunk of ``data`` (covering ``count`` records) into
        ``channel``'s ordered chain."""
        cnt, state = self.channels.get(channel, (0, _init(channel)))
        self.channels[channel] = (cnt + int(count), chain(state, data))

    def count_det(self, tag_name: str, n: int = 1) -> None:
        if n:
            self.det_counts[tag_name] = self.det_counts.get(tag_name, 0) + n

    # --- combination ---------------------------------------------------------

    def record_count(self) -> int:
        return sum(c for c, _ in self.channels.values())

    def combined(self) -> str:
        """Order-insensitive epoch fingerprint: XOR over each channel's
        H(name || final || count). Channel-interleaving invariant."""
        acc = 0
        for name, (cnt, state) in self.channels.items():
            h = hashlib.blake2b(
                name.encode() + b"\x00" + state + cnt.to_bytes(8, "little"),
                digest_size=DIGEST_BYTES).digest()
            acc ^= int.from_bytes(h, "little")
        return acc.to_bytes(DIGEST_BYTES, "little").hex()

    def merge(self, other: "EpochDigest") -> "EpochDigest":
        """Combine two partial digests of the SAME epoch over disjoint
        channel sets (e.g. folded by different host threads). Associative
        and commutative; overlapping channels are a caller bug."""
        if other.epoch != self.epoch:
            raise ValueError(
                f"cannot merge digests of epochs {self.epoch} and "
                f"{other.epoch}")
        overlap = set(self.channels) & set(other.channels)
        if overlap:
            raise ValueError(
                f"cannot merge digests sharing channels {sorted(overlap)}: "
                f"a channel's chain is ordered and owned by one folder")
        out = EpochDigest(self.epoch, self.channels, self.det_counts,
                          layout=self.layout or other.layout)
        out.channels.update(other.channels)
        for tag, n in other.det_counts.items():
            out.det_counts[tag] = out.det_counts.get(tag, 0) + n
        return out

    # --- serialization -------------------------------------------------------

    def to_entry(self) -> dict:
        """Ledger-entry form (plain JSON-able dict). ``layout`` is
        emitted only when stamped, so unstamped entries keep the exact
        pre-layout byte format."""
        out = {
            "epoch": self.epoch,
            "combined": self.combined(),
            "records": self.record_count(),
            "channels": {name: {"count": cnt, "fp": state.hex()}
                         for name, (cnt, state)
                         in sorted(self.channels.items())},
            "det_counts": dict(sorted(self.det_counts.items())),
        }
        if self.layout is not None:
            out["layout"] = [[v, p] for v, p in self.layout]
        return out

    @classmethod
    def from_entry(cls, entry: dict) -> "EpochDigest":
        chans = {name: (int(c["count"]), bytes.fromhex(c["fp"]))
                 for name, c in (entry.get("channels") or {}).items()}
        return cls(int(entry["epoch"]), chans,
                   {k: int(v)
                    for k, v in (entry.get("det_counts") or {}).items()},
                   layout=entry.get("layout"))

    def __eq__(self, other) -> bool:
        return (isinstance(other, EpochDigest)
                and self.epoch == other.epoch
                and self.channels == other.channels
                and self.det_counts == other.det_counts)

    def __repr__(self) -> str:
        return (f"EpochDigest(epoch={self.epoch}, "
                f"channels={len(self.channels)}, "
                f"records={self.record_count()}, "
                f"combined={self.combined()})")


def diff(expected: EpochDigest, actual: EpochDigest
         ) -> Optional[Tuple[str, str]]:
    """First divergence between two digests of the same epoch, or None.

    Returns ``(channel, reason)`` naming the first diverging channel in
    sorted order — the audit alarm's blast-radius pointer (which
    subtask's log or which vertex's output stream went off-script).
    Determinant-count skew with identical channels reports as channel
    ``"det_counts"``.
    """
    for name in sorted(set(expected.channels) | set(actual.channels)):
        e = expected.channels.get(name)
        a = actual.channels.get(name)
        if e is None:
            return name, f"unexpected channel (folded {a[0]} records)"
        if a is None:
            return name, f"channel missing (expected {e[0]} records)"
        if e[0] != a[0]:
            return name, f"record count {a[0]} != expected {e[0]}"
        if e[1] != a[1]:
            return (name, f"fingerprint {a[1].hex()} != expected "
                          f"{e[1].hex()} (count {e[0]} matches: "
                          f"content divergence)")
    if expected.det_counts != actual.det_counts:
        return "det_counts", (f"determinant counts {actual.det_counts} "
                              f"!= expected {expected.det_counts}")
    return None


def diff_ledgers(expected: List[dict], actual: List[dict]) -> List[str]:
    """Human-readable first-divergence report between two ledgers (lists
    of ledger entries), one line per diverging/missing epoch — the
    reference CLI's ``audit --diff`` surface."""
    ea = {int(e["epoch"]): e for e in expected}
    aa = {int(e["epoch"]): e for e in actual}
    out = []
    for ep in sorted(set(ea) | set(aa)):
        if ep not in aa:
            out.append(f"epoch {ep}: missing from second ledger")
            continue
        if ep not in ea:
            out.append(f"epoch {ep}: missing from first ledger")
            continue
        d = diff(EpochDigest.from_entry(ea[ep]),
                 EpochDigest.from_entry(aa[ep]))
        if d is not None:
            out.append(f"epoch {ep} channel {d[0]}: {d[1]}")
    return out
