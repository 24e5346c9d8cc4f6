"""ctypes loader for the port's host C++ runtime code (``csrc/delta_codec.cpp``).

Port of ``clonos_tpu/ops/native.py``. The delta wire codec's CRC and FLAT
framing run in C++ when a host compiler is present, with a bit-identical
pure-Python (``zlib``) fallback otherwise — the reference's own
behaviour, on the host, and no device fallback. The library is built at
first use with ``c++ -O3 -shared -fPIC`` into the kernels' build
directory (``ops/cuda_build.py``: ``build/clonos_tpu_torch/`` at the
repository root unless re-pointed, read at every call), keyed by a hash
of the source and the flags, and published atomically (a private temp
file, then ``os.replace``), so two processes that build it at the same
moment never load a half-written file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import zlib
import numpy as np

from clonos_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "delta_codec.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return cuda_build.build_dir() / f"{SOURCE.stem}_{h.hexdigest()[:16]}.so"


def _build():
    out = library_path()
    if out.exists():
        cuda_build.BUILD_INFO.setdefault(
            SOURCE.name, {"seconds": 0.0, "log": "(cached)", "path": str(out)})
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # clonos: allow(entropy): pid only names a private
    # temp file — never replayed data
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.monotonic()
    try:
        subprocess.run(["c++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    cuda_build.BUILD_INFO[SOURCE.name] = {
        "seconds": time.monotonic() - t0, "log": "", "path": str(out)}
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            # No compiler or no loadable build: serde takes the zlib path.
            return None
        lib.dc_crc32.restype = ctypes.c_uint32
        lib.dc_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dc_encode_flat.restype = ctypes.c_int64
        lib.dc_encode_flat.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def crc32(rows: np.ndarray) -> int:
    """CRC-32 (zlib polynomial) over a contiguous int32 array."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = _load()
    if lib is not None:
        return int(lib.dc_crc32(rows.ctypes.data, rows.nbytes))
    return zlib.crc32(rows.tobytes()) & 0xFFFFFFFF


def encode_flat_entries(log_ids: np.ndarray, starts: np.ndarray,
                        n_rows: np.ndarray, rows_concat: np.ndarray,
                        lanes: int) -> bytes:
    """The FLAT entry stream (everything after the frame header) in one
    native pass; the caller (serde) takes the Python path when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    log_ids = np.ascontiguousarray(log_ids, np.int32)
    starts = np.ascontiguousarray(starts, np.int32)
    n_rows_a = np.ascontiguousarray(n_rows, np.uint32)
    rows_concat = np.ascontiguousarray(rows_concat, np.int32)
    if not (len(log_ids) == len(starts) == len(n_rows_a)) \
            or int(n_rows_a.astype(np.int64).sum()) * lanes \
            != rows_concat.size:
        raise ValueError("encode_flat_entries: entry arrays disagree with "
                         "the concatenated rows")
    cap = (12 + 4) * len(log_ids) + rows_concat.nbytes + 16
    out = (ctypes.c_uint8 * cap)()
    n = lib.dc_encode_flat(
        log_ids.ctypes.data, starts.ctypes.data, n_rows_a.ctypes.data,
        len(log_ids), rows_concat.ctypes.data, lanes,
        ctypes.addressof(out), cap)
    if n < 0:
        raise RuntimeError("native encode buffer overflow")
    return ctypes.string_at(ctypes.addressof(out), n)
