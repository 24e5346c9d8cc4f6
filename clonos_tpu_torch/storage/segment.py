"""Immutable checksummed disk segments: one sealed epoch, one file (port
of ``clonos_tpu/storage/segment.py``, whose on-disk format it keeps byte
for byte: a segment written by either package reads back in the other).

A segment is a raw tensor container (magic + JSON header + concatenated
C-order array bytes) carrying one sealed epoch of spilled state, written
once and never mutated — truncation deletes the file. The payload
streams through one blake2b pass straight to the file:

- the blake2b is computed over the exact file bytes as they are
  written; the file lands via tmp + ``os.replace`` so a killed writer
  leaves either the whole segment or nothing;
- refill re-hashes the file and compares against the checksum recorded
  in the segment index — a torn/truncated/bit-rotted segment surfaces
  as :class:`SegmentCorruptError` naming the file, never as silently
  wrong replay bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Tuple

import numpy as np

#: bytes of the segment checksum (blake2b-128, the audit plane's digest
#: width — obs/digest.py DIGEST_BYTES).
CHECKSUM_BYTES = 16

#: container magic; the digit moves on any layout change so a reader
#: refuses bytes of another layout loudly instead of misparsing.
MAGIC = b"CLSEG1\n"


class SegmentCorruptError(RuntimeError):
    """A segment file's bytes do not hash to its indexed checksum."""


def segment_checksum(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=CHECKSUM_BYTES).hexdigest()


def write_segment(path: str, start: int,
                  arrays: Dict[str, np.ndarray]) -> Tuple[int, str]:
    """Serialize one sealed epoch and atomically place it at ``path``.
    Returns ``(payload_bytes, checksum)`` for the segment index."""
    entries = []
    mats = []
    for k, v in arrays.items():
        a = np.ascontiguousarray(np.asarray(v))
        entries.append({"name": k, "dtype": a.dtype.str,
                        "shape": list(a.shape)})
        mats.append(a)
    header = json.dumps({"start": int(start), "arrays": entries},
                        separators=(",", ":")).encode("utf-8") + b"\n"
    chunks = [MAGIC, header]
    for m in mats:
        if m.size:                     # 0-size views refuse the cast
            chunks.append(memoryview(m).cast("B"))
    h = hashlib.blake2b(digest_size=CHECKSUM_BYTES)
    nbytes = 0
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        for chunk in chunks:
            h.update(chunk)
            f.write(chunk)
            nbytes += len(chunk)
    os.replace(tmp, path)
    return nbytes, h.hexdigest()


def read_segment(path: str, checksum: str,
                 label: str) -> Tuple[int, Dict[str, np.ndarray]]:
    """Read and verify one segment. ``label`` names the owning store and
    epoch in the corruption error (``<label>: ...``)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SegmentCorruptError(
            f"{label}: segment {path} unreadable ({e})")
    got = segment_checksum(data)
    if got != checksum:
        raise SegmentCorruptError(
            f"{label}: segment {path} checksum mismatch "
            f"(got {got}, index says {checksum}) — torn or corrupt "
            f"segment; refill refused")
    try:
        if not data.startswith(MAGIC):
            raise ValueError("bad magic")
        nl = data.index(b"\n", len(MAGIC))
        meta = json.loads(data[len(MAGIC):nl])
        off = nl + 1
        out: Dict[str, np.ndarray] = {}
        for ent in meta["arrays"]:
            dt = np.dtype(ent["dtype"])
            shape = tuple(int(s) for s in ent["shape"])
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            out[ent["name"]] = np.frombuffer(
                data, dtype=dt, count=count, offset=off).reshape(shape)
            off += count * dt.itemsize
        start = int(meta["start"])
    except (ValueError, KeyError, TypeError) as e:
        # The checksum matched, so the index vouched for these bytes — a
        # parse failure here means the index entry itself is wrong.
        raise SegmentCorruptError(
            f"{label}: segment {path} malformed ({e})")
    return start, out
