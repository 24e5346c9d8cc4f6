"""Tiered sealed-epoch storage: device ring → host buffer → disk segments
(port of ``clonos_tpu/storage``).

The paper's in-flight log is "in memory, spillable to disk". This package
is the spill fabric shared by the in-flight rings (``inflight/log.py``)
and the determinant logs: the hot tier stays a device tensor ring;
sealed epochs move to a host staging buffer and persist as immutable
checksummed segment files; recovery refills from whichever tier holds
each epoch.

- :mod:`segment` — the on-disk unit: one sealed epoch, one file, one
  blake2b checksum, atomically replaced into place.
- :mod:`tiered` — :class:`TieredEpochStore`, the host-buffer +
  disk-segment owner with a background writer, tier-occupancy
  accounting, movement counters, and audit digests attached to each
  sealed segment.
"""

from clonos_tpu_torch.storage.segment import (SegmentCorruptError,
                                              read_segment,
                                              segment_checksum,
                                              write_segment)
from clonos_tpu_torch.storage.tiered import StorageError, TieredEpochStore

__all__ = [
    "SegmentCorruptError",
    "StorageError",
    "TieredEpochStore",
    "read_segment",
    "segment_checksum",
    "write_segment",
]
