"""Determinant schema: packed fixed-width int32 rows.

The port's own copy of the parts of ``clonos_tpu/causal/determinant.py``
the port uses (that module is numpy-only; the port imports nothing of
the reference package). One determinant is one ``int32[NUM_LANES]`` row:

    lane 0: tag
    lane 1: record_count   (0 for the per-step sync determinants)
    lanes 2..7: payload    (64-bit values split hi/lo across two lanes)

Tag numbering matches the reference (Determinant.java:20-35). The
variable-width SERIALIZABLE payload does not fit a row: its bytes live in
a host-side :class:`SidecarStore` and the row carries ``(sidecar_key,
length, crc32)``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import ClassVar, Dict, List, Sequence, Tuple, Type

import numpy as np

ORDER = 0
TIMESTAMP = 1
RNG = 2
SERIALIZABLE = 3
TIMER_TRIGGER = 4
SOURCE_CHECKPOINT = 5
IGNORE_CHECKPOINT = 6
BUFFER_BUILT = 7
SCALE = 8

NUM_TAGS = 9
TAG_NAMES = (
    "ORDER", "TIMESTAMP", "RNG", "SERIALIZABLE", "TIMER_TRIGGER",
    "SOURCE_CHECKPOINT", "IGNORE_CHECKPOINT", "BUFFER_BUILT", "SCALE",
)

NUM_LANES = 8
LANE_TAG = 0
LANE_RC = 1
LANE_P = 2  # first payload lane
ROW_DTYPE = np.int32
ROW_BYTES = NUM_LANES * 4

_I32_MASK = 0xFFFFFFFF


def split64(v: int) -> Tuple[int, int]:
    """Split a signed 64-bit int into (hi, lo) signed 32-bit lane values."""
    u = v & 0xFFFFFFFFFFFFFFFF
    return _tosigned((u >> 32) & _I32_MASK), _tosigned(u & _I32_MASK)


def join64(hi: int, lo: int) -> int:
    u = ((hi & _I32_MASK) << 32) | (lo & _I32_MASK)
    return u - (1 << 64) if u >= (1 << 63) else u


def _tosigned(u: int) -> int:
    return u - (1 << 32) if u >= (1 << 31) else u


@dataclasses.dataclass(frozen=True)
class Determinant:
    """Base: host-side view of one packed row."""

    TAG: ClassVar[int] = -1

    def pack(self) -> np.ndarray:
        row = np.zeros(NUM_LANES, dtype=ROW_DTYPE)
        row[LANE_TAG] = self.TAG
        row[LANE_RC] = getattr(self, "record_count", 0)
        payload = self._payload()
        for p in payload:
            # A value that does not fit a 32-bit lane would corrupt the log
            # silently; 64-bit fields are split by _payload via split64.
            if not (-(1 << 31) <= p < (1 << 32)):
                raise ValueError(
                    f"{type(self).__name__} payload value {p} does not fit "
                    f"a 32-bit lane")
        row[LANE_P:LANE_P + len(payload)] = np.array(
            [_tosigned(p & _I32_MASK) for p in payload], dtype=np.int64
        ).astype(ROW_DTYPE)
        return row

    def _payload(self) -> Sequence[int]:
        return ()

    @classmethod
    def unpack(cls, row: np.ndarray) -> "Determinant":
        tag = int(row[LANE_TAG])
        sub = _TAG_TO_CLASS.get(tag)
        if sub is None:
            raise ValueError(f"unknown determinant tag {tag}")
        return sub._from_row(row)

    @classmethod
    def _from_row(cls, row: np.ndarray) -> "Determinant":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class OrderDeterminant(Determinant):
    """Which input channel the superstep's consumed batch came from."""

    TAG: ClassVar[int] = ORDER
    channel: int = 0

    def _payload(self):
        return (self.channel,)

    @classmethod
    def _from_row(cls, row):
        return cls(channel=int(row[LANE_P]))


@dataclasses.dataclass(frozen=True)
class TimestampDeterminant(Determinant):
    """A causal-time read."""

    TAG: ClassVar[int] = TIMESTAMP
    timestamp: int = 0

    def _payload(self):
        return split64(self.timestamp)

    @classmethod
    def _from_row(cls, row):
        return cls(timestamp=join64(int(row[LANE_P]), int(row[LANE_P + 1])))


@dataclasses.dataclass(frozen=True)
class RNGDeterminant(Determinant):
    """A host-side random draw."""

    TAG: ClassVar[int] = RNG
    value: int = 0

    def _payload(self):
        return (self.value,)

    @classmethod
    def _from_row(cls, row):
        return cls(value=int(row[LANE_P]))


@dataclasses.dataclass(frozen=True)
class SerializableDeterminant(Determinant):
    """An external-service result; its bytes live in a sidecar store. The
    64-bit sidecar key spans two lanes, the CRC32 is stored unsigned."""

    TAG: ClassVar[int] = SERIALIZABLE
    sidecar_key: int = 0
    length: int = 0
    crc32: int = 0

    def _payload(self):
        khi, klo = split64(self.sidecar_key)
        return (khi, klo, self.length, self.crc32)

    @classmethod
    def _from_row(cls, row):
        return cls(sidecar_key=join64(int(row[LANE_P]), int(row[LANE_P + 1])),
                   length=int(row[LANE_P + 2]),
                   crc32=int(row[LANE_P + 3]) & _I32_MASK)


@dataclasses.dataclass(frozen=True)
class TimerTriggerDeterminant(Determinant):
    """A processing-time timer firing, replayed at record_count."""

    TAG: ClassVar[int] = TIMER_TRIGGER
    record_count: int = 0
    callback_id: int = 0
    timestamp: int = 0

    def _payload(self):
        hi, lo = split64(self.timestamp)
        return (self.callback_id, hi, lo)

    @classmethod
    def _from_row(cls, row):
        return cls(record_count=int(row[LANE_RC]),
                   callback_id=int(row[LANE_P]),
                   timestamp=join64(int(row[LANE_P + 1]),
                                    int(row[LANE_P + 2])))


@dataclasses.dataclass(frozen=True)
class SourceCheckpointDeterminant(Determinant):
    """A checkpoint-trigger arrival at a source, replayed at record_count."""

    TAG: ClassVar[int] = SOURCE_CHECKPOINT
    record_count: int = 0
    checkpoint_id: int = 0
    timestamp: int = 0
    checkpoint_type: int = 0
    storage_ref: int = 0

    def _payload(self):
        chi, clo = split64(self.checkpoint_id)
        thi, tlo = split64(self.timestamp)
        return (chi, clo, thi, tlo, self.checkpoint_type, self.storage_ref)

    @classmethod
    def _from_row(cls, row):
        p = [int(row[LANE_P + i]) for i in range(6)]
        return cls(record_count=int(row[LANE_RC]),
                   checkpoint_id=join64(p[0], p[1]),
                   timestamp=join64(p[2], p[3]),
                   checkpoint_type=p[4], storage_ref=p[5])


@dataclasses.dataclass(frozen=True)
class IgnoreCheckpointDeterminant(Determinant):
    """Skip a checkpoint a failed task never acked."""

    TAG: ClassVar[int] = IGNORE_CHECKPOINT
    record_count: int = 0
    checkpoint_id: int = 0

    def _payload(self):
        return split64(self.checkpoint_id)

    @classmethod
    def _from_row(cls, row):
        return cls(record_count=int(row[LANE_RC]),
                   checkpoint_id=join64(int(row[LANE_P]),
                                        int(row[LANE_P + 1])))


@dataclasses.dataclass(frozen=True)
class BufferBuiltDeterminant(Determinant):
    """Output batch cut: how many records went into an emitted batch."""

    TAG: ClassVar[int] = BUFFER_BUILT
    num_records: int = 0

    def _payload(self):
        return (self.num_records,)

    @classmethod
    def _from_row(cls, row):
        return cls(num_records=int(row[LANE_P]))


@dataclasses.dataclass(frozen=True)
class ScaleDeterminant(Determinant):
    """One autoscaling decision, logged before it acts, so a recovered
    controller replays it instead of deciding again. ``record_count``
    carries the decision's sequence number (nonzero: a SCALE row never
    reads as a per-step sync anchor); ``signal_crc`` pins the signal
    snapshot the policy saw. SCALE rows live in the controller's own
    host-side log, never in a task's determinant stream."""

    TAG: ClassVar[int] = SCALE
    record_count: int = 0      # decision sequence number (1-based)
    epoch: int = 0             # completed fence the decision was made at
    action: int = 0            # 0 hold / 1 scale-workers / 2 scale-replicas
    delta: int = 0             # signed step (bounded by policy max_step)
    target: int = 0            # resulting worker/replica count
    signal_crc: int = 0        # crc32 of the canonical signal snapshot

    def _payload(self):
        ehi, elo = split64(self.epoch)
        return (ehi, elo, self.action, self.delta, self.target,
                self.signal_crc)

    @classmethod
    def _from_row(cls, row):
        return cls(record_count=int(row[LANE_RC]),
                   epoch=join64(int(row[LANE_P]), int(row[LANE_P + 1])),
                   action=int(row[LANE_P + 2]),
                   delta=int(row[LANE_P + 3]),
                   target=int(row[LANE_P + 4]),
                   signal_crc=int(row[LANE_P + 5]) & _I32_MASK)


_TAG_TO_CLASS: Dict[int, Type[Determinant]] = {
    ORDER: OrderDeterminant,
    TIMESTAMP: TimestampDeterminant,
    RNG: RNGDeterminant,
    SERIALIZABLE: SerializableDeterminant,
    TIMER_TRIGGER: TimerTriggerDeterminant,
    SOURCE_CHECKPOINT: SourceCheckpointDeterminant,
    IGNORE_CHECKPOINT: IgnoreCheckpointDeterminant,
    BUFFER_BUILT: BufferBuiltDeterminant,
    SCALE: ScaleDeterminant,
}


def pack_batch(dets: Sequence[Determinant]) -> np.ndarray:
    """Pack determinants into an ``int32[n, NUM_LANES]`` array."""
    if not dets:
        return np.zeros((0, NUM_LANES), dtype=ROW_DTYPE)
    return np.stack([d.pack() for d in dets])


def unpack_batch(rows: np.ndarray) -> List[Determinant]:
    return [Determinant.unpack(rows[i]) for i in range(rows.shape[0])]


def to_bytes(rows: np.ndarray) -> bytes:
    """Wire/digest serialization: contiguous little-endian int32 rows."""
    return np.ascontiguousarray(np.asarray(rows).astype("<i4")).tobytes()


def from_bytes(data: bytes) -> np.ndarray:
    """Inverse of :func:`to_bytes`."""
    arr = np.frombuffer(data, dtype="<i4")
    if arr.size % NUM_LANES:
        raise ValueError(
            f"byte length {len(data)} is not a whole number of rows")
    return arr.reshape(-1, NUM_LANES).astype(ROW_DTYPE)


def sync_anchors(rows: np.ndarray) -> np.ndarray:
    """Indices of per-step sync-block anchors in a packed row stream:
    TIMESTAMP rows with a ZERO record-count stamp (async rows carry a
    nonzero stamp so they can't masquerade as step anchors)."""
    rows = np.asarray(rows)
    return np.where((rows[:, LANE_TAG] == TIMESTAMP)
                    & (rows[:, LANE_RC] == 0))[0]


class SidecarStore:
    """Host-side blob store for SERIALIZABLE payloads, epoch-scoped like
    the log: blobs are tagged with the epoch they were created in and
    dropped when that epoch is truncated.

    Keys are namespaced by the owning task (``owner`` in the bits above
    ``OWNER_SHIFT``), so blobs merged from another store during recovery
    never collide with local ones; sequence numbers are never reused."""

    OWNER_SHIFT = 40

    def __init__(self, owner: int = 0):
        if not (0 <= owner < (1 << (63 - self.OWNER_SHIFT))):
            raise ValueError(f"owner id out of range: {owner}")
        self.owner = owner
        self._blobs: Dict[int, Tuple[int, bytes]] = {}
        self._next_seq = 1

    def put(self, data: bytes, epoch: int) -> SerializableDeterminant:
        if self._next_seq >= (1 << self.OWNER_SHIFT):
            raise RuntimeError("sidecar key space exhausted")
        key = (self.owner << self.OWNER_SHIFT) | self._next_seq
        self._next_seq += 1
        self._blobs[key] = (epoch, data)
        return SerializableDeterminant(
            sidecar_key=key, length=len(data), crc32=zlib.crc32(data))

    def get(self, d: SerializableDeterminant) -> bytes:
        epoch, data = self._blobs[d.sidecar_key]
        if len(data) != d.length or zlib.crc32(data) != d.crc32:
            raise ValueError(
                f"sidecar blob {d.sidecar_key} fails integrity check")
        return data

    def merge_from(self, other: "SidecarStore") -> None:
        """Adopt blobs replicated from another store; the same key with
        different contents (a duplicate owner id) raises."""
        for key, (epoch, data) in other._blobs.items():
            existing = self._blobs.get(key)
            if existing is not None and existing[1] != data:
                raise ValueError(
                    f"sidecar key collision on {key}: divergent contents "
                    f"(duplicate owner id?)")
            self._blobs[key] = (epoch, data)

    def truncate(self, oldest_live_epoch: int) -> None:
        dead = [k for k, (e, _) in self._blobs.items()
                if e < oldest_live_epoch]
        for k in dead:
            del self._blobs[k]

    def __len__(self) -> int:
        return len(self._blobs)
