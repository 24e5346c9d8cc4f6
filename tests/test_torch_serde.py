"""PyTorch port, the determinant-delta wire codec (mirror of the
reference's ``tests/test_remote.py`` serde cases): FLAT and GROUPED frames
of the same deltas are byte-equal to the reference's, each package
decodes the other's frames, corruption is detected, the lineage-tag
frames agree, and the port's host C++ codec (built here with ``c++``)
equals its ``zlib`` fallback and the reference's bytes; concurrent
builders publish one library. Tolerance: exact (bytes)."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from clonos_tpu.causal import serde as jserde
from clonos_tpu_torch.causal import serde
from clonos_tpu_torch.ops import native

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deltas(seed):
    rng = np.random.RandomState(seed)
    out = []
    for log_id in sorted(rng.choice(40, 6, replace=False)):
        n = int(rng.randint(0, 9))
        out.append((int(log_id), int(rng.randint(0, 1 << 20)),
                    rng.randint(-(1 << 31), (1 << 31) - 1, (n, 8),
                                dtype=np.int64).astype(np.int32)))
    return out


@pytest.fixture
def pure_python():
    """The codec with the native library unloaded (the zlib path)."""
    keep = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = keep


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("encoding,spv", [("flat", 1), ("grouped", 4),
                                          ("grouped", 7)])
def test_frames_byte_equal_reference_and_cross_decode(seed, encoding, spv):
    deltas = _deltas(seed)
    frame = serde.encode_delta(deltas, encoding=encoding,
                               subtasks_per_vertex=spv)
    assert frame == jserde.encode_delta(deltas, encoding=encoding,
                                        subtasks_per_vertex=spv)
    for dec in (serde.decode_delta, jserde.decode_delta):
        out = dec(frame, subtasks_per_vertex=spv)
        assert [(i, s) for i, s, _ in out] == [(i, s) for i, s, _ in deltas]
        for (_, _, a), (_, _, b) in zip(deltas, out):
            np.testing.assert_array_equal(a, b)


def test_roundtrip_with_empty_entries_and_bad_encoding():
    rng = np.random.RandomState(0)
    deltas = [(5, 100, rng.randint(-9, 9, (7, 8)).astype(np.int32)),
              (6, 40, rng.randint(-9, 9, (3, 8)).astype(np.int32)),
              (9, 0, np.zeros((0, 8), np.int32))]
    for enc in ("flat", "grouped"):
        frame = serde.encode_delta(deltas, encoding=enc,
                                   subtasks_per_vertex=4)
        assert frame == jserde.encode_delta(deltas, encoding=enc,
                                            subtasks_per_vertex=4)
        out = serde.decode_delta(frame, subtasks_per_vertex=4)
        assert [(i, s) for i, s, _ in out] == [(i, s) for i, s, _ in deltas]
    assert serde.encode_delta([]) == jserde.encode_delta([])
    assert serde.decode_delta(serde.encode_delta([])) == []
    with pytest.raises(ValueError, match="unknown delta encoding"):
        serde.encode_delta(deltas, encoding="zip")


@pytest.mark.parametrize("flip", [-8, -3, 24])
def test_corruption_is_detected(flip):
    rows = np.arange(16, dtype=np.int32).reshape(2, 8)
    frame = bytearray(serde.encode_delta([(1, 0, rows)]))
    frame[flip] ^= 0xFF                      # a row byte, the CRC, a row
    for dec in (serde.decode_delta, jserde.decode_delta):
        with pytest.raises(ValueError, match="CRC"):
            dec(bytes(frame))
    bad = bytearray(serde.encode_delta([(1, 0, rows)]))
    bad[0] ^= 0x01
    with pytest.raises(ValueError, match="magic"):
        serde.decode_delta(bytes(bad))


def test_lineage_tag_frames_equal_reference():
    rng = np.random.RandomState(3)
    tags = [tuple(int(x) for x in row)
            for row in rng.randint(-1 << 40, 1 << 40, (5, 5))]
    frame = serde.encode_lineage_tags(tags)
    assert frame == jserde.encode_lineage_tags(tags)
    assert serde.decode_lineage_tags(frame) == tags
    assert jserde.decode_lineage_tags(frame) == tags
    corrupt = bytearray(frame)
    corrupt[12] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        serde.decode_lineage_tags(bytes(corrupt))
    with pytest.raises(ValueError, match="not a lineage frame"):
        serde.decode_lineage_tags(serde.encode_delta([]))


def test_native_codec_matches_zlib_fallback_and_reference(pure_python):
    rng = np.random.RandomState(1)
    rows = rng.randint(-99, 99, (11, 8)).astype(np.int32)
    deltas = [(3, 17, rows), (4, 0, rows[:5]), (8, 2, rows[:0])]
    pure = serde.encode_delta(deltas)
    pure_crc = native.crc32(rows)
    native._lib, native._tried = None, False
    assert native.available(), "c++ is present here: the codec must build"
    assert str(native.library_path()).startswith(
        os.path.join(_REPO, "build", "clonos_tpu_torch"))
    assert native.crc32(rows) == pure_crc \
        == zlib.crc32(rows.tobytes()) & 0xFFFFFFFF
    with_native = serde.encode_delta(deltas)
    assert with_native == pure == jserde.encode_delta(deltas)
    with pytest.raises(ValueError, match="disagree"):
        native.encode_flat_entries(np.zeros(1, np.int32),
                                   np.zeros(1, np.int32),
                                   np.ones(1, np.uint32),
                                   np.zeros(3, np.int32), 8)


_BUILD = r"""
import sys
from pathlib import Path
from clonos_tpu_torch.ops import cuda_build, native
cuda_build.set_build_dir(Path(sys.argv[1]))
assert native.available()
print(native.library_path())
"""


def test_concurrent_builders_publish_one_library(tmp_path):
    """Several processes building the codec at the same moment (a worker
    and its controller) each load a whole library; one file remains."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert len(set(outs)) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(outs[0])]
