"""Determinant-delta wire format: FLAT and GROUPED encodings.

Port of ``clonos_tpu/causal/serde.py``; its frames are byte-identical to
the reference's. This is the cross-host path: a host frames its logs'
fresh suffixes (numpy rows already on the host) into one frame, ships
it over the control transport (``parallel/transport.py``), and the
receiving host merges the rows into its replica logs with the
offset-dedup rule (``log.merge_delta``). Layout (little-endian):

    frame   = MAGIC u32 | encoding u8 | count u32 | entry*
    FLAT    entry = log_id i32 | abs_start i32 | n_rows u32 | rows
    GROUPED entry = vertex i16 | n_subs u16 |
                    (subtask i16 | abs_start i32 | n_rows u32 | rows)*
    rows    = n_rows * NUM_LANES * i32, followed by crc32 u32 of rows

The CRC and the FLAT framing run in host C++ (``ops/csrc/delta_codec.cpp``
through ``ops/native.py``) when it is built, with a bit-identical
pure-Python fallback.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.ops import native

MAGIC = 0xC10_905
FLAT = 0
GROUPED = 1

_HDR = struct.Struct("<IBI")
_FLAT_E = struct.Struct("<iiI")
_GRP_V = struct.Struct("<hH")
_GRP_S = struct.Struct("<hiI")
_CRC = struct.Struct("<I")


def _crc(rows: np.ndarray) -> int:
    return native.crc32(np.ascontiguousarray(rows, dtype=np.int32))


#: one log's delta: (flat log id, absolute start offset, rows [n, lanes])
Delta = Tuple[int, int, np.ndarray]


def encode_delta(deltas: Sequence[Delta], encoding: str = "flat",
                 subtasks_per_vertex: int = 1) -> bytes:
    """Serialize per-log fresh suffixes into one wire frame."""
    if encoding == "flat":
        enc = FLAT
    elif encoding == "grouped":
        enc = GROUPED
    else:
        raise ValueError(f"unknown delta encoding {encoding!r} "
                         f"(expected 'flat' or 'grouped')")
    out = [_HDR.pack(MAGIC, enc, len(deltas))]
    if enc == FLAT:
        if native.available() and deltas:
            # One native pass over all entries: framing and CRC without
            # per-entry Python overhead.
            rows_list = [np.ascontiguousarray(r, np.int32)
                         for _, _, r in deltas]
            out.append(native.encode_flat_entries(
                np.asarray([d[0] for d in deltas], np.int32),
                np.asarray([d[1] for d in deltas], np.int32),
                np.asarray([r.shape[0] for r in rows_list], np.uint32),
                np.concatenate([r.reshape(-1) for r in rows_list]),
                det.NUM_LANES))
            return b"".join(out)
        for log_id, start, rows in deltas:
            rows = np.ascontiguousarray(rows, dtype=np.int32)
            out.append(_FLAT_E.pack(log_id, start, rows.shape[0]))
            out.append(rows.tobytes())
            out.append(_CRC.pack(_crc(rows)))
    else:
        # Consecutive logs grouped by vertex: the vertex id is written
        # once per group.
        groups: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        for log_id, start, rows in deltas:
            v, s = divmod(log_id, subtasks_per_vertex)
            groups.setdefault(v, []).append((s, start, rows))
        out = [_HDR.pack(MAGIC, enc, len(groups))]
        for v in sorted(groups):
            subs = groups[v]
            out.append(_GRP_V.pack(v, len(subs)))
            for s, start, rows in subs:
                rows = np.ascontiguousarray(rows, dtype=np.int32)
                out.append(_GRP_S.pack(s, start, rows.shape[0]))
                out.append(rows.tobytes())
                out.append(_CRC.pack(_crc(rows)))
    return b"".join(out)


def decode_delta(frame: bytes, subtasks_per_vertex: int = 1
                 ) -> List[Delta]:
    """Parse a wire frame back into (log_id, abs_start, rows) deltas,
    verifying each rows block's CRC."""
    magic, enc, count = _HDR.unpack_from(frame, 0)
    if magic != MAGIC:
        raise ValueError(f"bad delta frame magic {magic:#x}")
    pos = _HDR.size
    deltas: List[Delta] = []

    def read_rows(n: int, at: int) -> Tuple[np.ndarray, int]:
        nbytes = n * det.NUM_LANES * 4
        rows = np.frombuffer(frame, np.int32, n * det.NUM_LANES,
                             at).reshape(n, det.NUM_LANES)
        (crc,) = _CRC.unpack_from(frame, at + nbytes)
        if crc != _crc(rows):
            raise ValueError("delta rows CRC mismatch (corrupt frame)")
        return rows, at + nbytes + _CRC.size

    if enc == FLAT:
        for _ in range(count):
            log_id, start, n = _FLAT_E.unpack_from(frame, pos)
            pos += _FLAT_E.size
            rows, pos = read_rows(n, pos)
            deltas.append((log_id, start, rows))
    elif enc == GROUPED:
        for _ in range(count):
            v, n_subs = _GRP_V.unpack_from(frame, pos)
            pos += _GRP_V.size
            for _ in range(n_subs):
                s, start, n = _GRP_S.unpack_from(frame, pos)
                pos += _GRP_S.size
                rows, pos = read_rows(n, pos)
                deltas.append((v * subtasks_per_vertex + s, start, rows))
    else:
        raise ValueError(f"unknown delta encoding {enc}")
    return deltas


# --- lineage tag piggyback ---------------------------------------------------
# Dyed records' compact tags ride ordinary data frames next to the
# determinant deltas; a disabled lineage plane ships zero tag bytes. One
# tag is five i64 lanes:
#
#     tag   = src_offset i64 | epoch i64 | step i64 | worker i64 |
#             vertex i64
#     frame = MAGIC u32 | encoding(=2) u8 | count u32 | tags | crc32 u32

LINEAGE = 2

#: one dyed record's tag: (src_offset, epoch, step, worker, vertex)
LineageTag = Tuple[int, int, int, int, int]

_TAG_LANES = 5


def encode_lineage_tags(tags: Sequence[LineageTag]) -> bytes:
    """Frame dyed-record lineage tags for the cross-host data path."""
    arr = np.asarray(list(tags), np.int64).reshape(-1, _TAG_LANES)
    payload = np.ascontiguousarray(arr).tobytes()
    return (_HDR.pack(MAGIC, LINEAGE, arr.shape[0]) + payload
            + _CRC.pack(zlib.crc32(payload)))


def decode_lineage_tags(frame: bytes) -> List[LineageTag]:
    """Decode a lineage-tag frame (CRC-checked, like delta rows)."""
    magic, enc, count = _HDR.unpack_from(frame, 0)
    if magic != MAGIC:
        raise ValueError(f"bad lineage frame magic {magic:#x}")
    if enc != LINEAGE:
        raise ValueError(f"not a lineage frame (encoding {enc})")
    nbytes = count * _TAG_LANES * 8
    arr = np.frombuffer(frame, np.int64, count * _TAG_LANES,
                        _HDR.size).reshape(count, _TAG_LANES)
    (crc,) = _CRC.unpack_from(frame, _HDR.size + nbytes)
    if crc != zlib.crc32(frame[_HDR.size:_HDR.size + nbytes]):
        raise ValueError("lineage tag CRC mismatch (corrupt frame)")
    return [tuple(int(x) for x in row) for row in arr]
