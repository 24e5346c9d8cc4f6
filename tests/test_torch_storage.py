"""PyTorch port, tiered storage (``clonos_tpu_torch/storage``): device ring
-> host buffer -> checksummed disk segments (mirrors of the reference's
``tests/test_storage.py``).

Segments are byte-compatible across the two packages; the deep-backlog
recovery refilled from disk seals the same audit ledger as the reference
runner on the same schedule and as a no-spill control whose ring held
the whole span; a torn segment is refused with its label. Sizes:
parallelism 2, 4-step epochs, an 8-step ring. Tolerance: exact."""

import glob
import os

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.obs.digest import diff_ledgers as jax_diff_ledgers
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.storage import read_segment as jax_read_segment
from clonos_tpu.storage import write_segment as jax_write_segment
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal.recovery import RecoveryError
from clonos_tpu_torch.inflight.log import slice_steps_at
from clonos_tpu_torch.obs.digest import diff_ledgers
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.executor import canonical_carry
from clonos_tpu_torch.storage import (SegmentCorruptError, StorageError,
                                      TieredEpochStore, read_segment,
                                      segment_checksum, write_segment)
from clonos_tpu_torch.utils.tree import tree_leaves


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "rows": rng.randint(0, 1 << 30, size=(4, 6, 3)).astype(np.int32),
        "weights": rng.rand(8).astype(np.float32),
        "valid": (rng.rand(5, 2) > 0.5),
        "empty": np.zeros((0, 7), np.int64),
    }


# --- segment container -------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_segment_roundtrip_across_packages(tmp_path, writer):
    """A segment written by either package reads back bit-identical in
    both, and the two writers lay down the same bytes."""
    arrays = _arrays(0)
    write = write_segment if writer == "port" else jax_write_segment
    path = str(tmp_path / "e0.seg")
    nbytes, checksum = write(path, 37, arrays)
    assert nbytes == os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    assert segment_checksum(data) == checksum
    other = str(tmp_path / "other.seg")
    (jax_write_segment if writer == "port" else write_segment)(
        other, 37, arrays)
    with open(other, "rb") as f:
        assert f.read() == data
    for read in (read_segment, jax_read_segment):
        start, out = read(path, checksum, "t:epoch0")
        assert start == 37 and set(out) == set(arrays)
        for k, v in arrays.items():
            assert out[k].dtype == v.dtype and out[k].shape == v.shape
            np.testing.assert_array_equal(out[k], v)


def test_corrupt_or_torn_segment_refused_with_label(tmp_path):
    path = str(tmp_path / "e1.seg")
    _, checksum = write_segment(path, 0, _arrays(1))
    data = open(path, "rb").read()
    rot = bytearray(data)
    rot[len(rot) // 2] ^= 0x40
    open(path, "wb").write(bytes(rot))
    with pytest.raises(SegmentCorruptError,
                       match=r"rotted:epoch1.*checksum mismatch"):
        read_segment(path, checksum, "rotted:epoch1")
    open(path, "wb").write(data[:len(data) - 11])
    with pytest.raises(SegmentCorruptError, match="refill refused"):
        read_segment(path, checksum, "torn:epoch1")
    os.remove(path)
    with pytest.raises(SegmentCorruptError, match="unreadable"):
        read_segment(path, checksum, "gone:epoch1")


# --- tiered store ------------------------------------------------------------


def test_tiered_roundtrip_budget_demotion_and_truncate(tmp_path):
    store = TieredEpochStore(str(tmp_path), "dets", host_budget_epochs=1)
    put = {e: _arrays(e) for e in range(4)}
    for e, arrs in put.items():
        store.put(e, e * 10, arrs)
    store.drain()
    occ = store.occupancy()
    assert occ["host_epochs"] == 1 and occ["disk_epochs"] == 4
    assert occ["disk_bytes"] > occ["host_bytes"] > 0
    start, out = store.load_epoch(0)
    assert start == 0
    np.testing.assert_array_equal(out["rows"], put[0]["rows"])
    start, out = store.load_epoch(3)
    assert start == 30
    np.testing.assert_array_equal(out["weights"], put[3]["weights"])
    stats = store.stats()
    assert stats["disk_hits"] == 1 and stats["host_hits"] == 1
    assert stats["bytes_refilled"] > 0
    assert stats["segments_written"] == 4 and stats["bytes_spilled"] > 0
    assert stats["write_errors"] == 0
    store.truncate(2)
    store.drain()
    assert store.retained_epochs() == [3]
    assert not os.path.exists(store.segment_path(0))
    assert not os.path.exists(store.segment_path(2))
    assert os.path.exists(store.segment_path(3))
    with pytest.raises(StorageError, match="dets:epoch1.*not retained"):
        store.load_epoch(1)
    store.close()


def test_open_index_fresh_process_refill_and_torn_tail(tmp_path):
    store = TieredEpochStore(str(tmp_path), "edge0", host_budget_epochs=0)
    put = {e: _arrays(10 + e) for e in range(3)}
    for e, arrs in put.items():
        store.put(e, e * 4, arrs)
        store.attach_digest(e, f"d{e:016x}")
    store.truncate(0)
    store.drain()
    store.close()
    with open(os.path.join(str(tmp_path), "edge0.index.jsonl"), "a") as f:
        f.write('{"kind":"segm')
    fresh = TieredEpochStore.open_index(str(tmp_path), "edge0")
    assert fresh.retained_epochs() == [1, 2]
    assert fresh.epoch_digest(1) == "d" + format(1, "016x")
    start, out = fresh.load_epoch(2)
    assert start == 8
    np.testing.assert_array_equal(out["rows"], put[2]["rows"])
    assert fresh.stats()["disk_hits"] == 1
    fresh.close()


def test_digest_stamped_on_an_epoch_truncated_before_the_writer_stamps_it(
        tmp_path):
    """Epoch 0's segment record lands before its seal (digest null); the
    seal's digest and the checkpoint's truncate then both reach the store
    while the writer is still busy with epoch 1. The digest rides its
    command, so the index stamps epoch 0 after its null record all the
    same, and an epoch whose write the truncate overtook gets no record
    at all."""
    import json
    import threading
    store = TieredEpochStore(str(tmp_path), "edge0", host_budget_epochs=0)
    store.put(0, 0, _arrays(20))
    store.drain()
    gate, write_one = threading.Event(), store._write_one

    def held(epoch):                     # the writer waits on epoch 1
        if epoch == 1:
            assert gate.wait(60)
        return write_one(epoch)
    store._write_one = held
    store.put(1, 4, _arrays(21))
    store.put(2, 8, _arrays(22))
    store.attach_digest(0, "d0")
    store.attach_digest(2, "d2")
    store.truncate(2)
    gate.set()
    store.drain()
    store.close()
    with open(store.index_path()) as f:
        recs = [json.loads(line) for line in f]
    assert [(r["kind"], r.get("epoch"), r.get("digest")) for r in recs] == [
        ("segment", 0, None), ("digest", 0, "d0"), ("truncate", None, None)]
    assert TieredEpochStore.open_index(str(tmp_path),
                                       "edge0").retained_epochs() == []


# --- cluster integration -----------------------------------------------------


def _build(env_cls):
    env = env_cls(name="tiered", num_key_groups=8)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30)
        .sink())
    return env.build()


def _kw(tmp_path=None, ring_steps=8, budget=0):
    kw = dict(steps_per_epoch=4, log_capacity=1 << 9, max_epochs=16,
              inflight_ring_steps=ring_steps, seed=11,
              logical_time=True, audit=True)
    if tmp_path is not None:
        kw.update(spool_dir=str(tmp_path), spill_host_budget_epochs=budget)
    return kw


def _runner(tmp_path=None, ring_steps=8, budget=0):
    return ClusterRunner(_build(StreamEnvironment), device="cpu",
                         **_kw(tmp_path, ring_steps, budget))


def _mirror_ignore(runner, flats):
    """Recovery's decision for the pending checkpoints, applied to a run
    that never failed: its healthy logs record the same IGNORE_CHECKPOINT
    rows at the same stamp."""
    from clonos_tpu_torch.causal import determinant as det
    ex = runner.executor
    healthy = [f for f in range(runner.job.total_subtasks())
               if f not in flats]
    for cid in runner.coordinator.ignore_unacked_for(set(flats)):
        ex.append_async_many(healthy, det.IgnoreCheckpointDeterminant(
            record_count=ex.global_record_stamp(), checkpoint_id=cid))


def _backlog(runner, pending=3):
    runner.run_epoch(complete_checkpoint=True)     # restore point
    for _ in range(pending):
        runner.run_epoch(complete_checkpoint=False)


def _same_carry(a, b):
    """Equal canonical carries; rings of different sizes are held equal
    on the steps the smaller one retains (and on their offsets)."""
    ca = canonical_carry(a.executor.carry)
    cb = canonical_carry(b.executor.carry)
    la = tree_leaves(ca._replace(out_rings=()))
    lb = tree_leaves(cb._replace(out_rings=()))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and bool((x == y).all())
    for ra, rb in zip(ca.out_rings, cb.out_rings):
        assert int(ra.head) == int(rb.head) and int(ra.tail) == int(rb.tail)
        n = min(ra.ring_steps, rb.ring_steps, int(ra.head - ra.tail))
        for x, y in zip(slice_steps_at(ra, int(ra.head) - n, n),
                        slice_steps_at(rb, int(rb.head) - n, n)):
            assert bool((x == y).all())


def test_deep_backlog_recovery_refills_from_disk_like_the_reference(
        tmp_path):
    """12 backlog steps against an 8-step ring: the leading epoch's ring
    steps exist only on disk (host budget 0). The recovered port seals
    the reference runner's ledger on the same schedule, equals a no-spill
    control's ledger and carry, and refilled from the disk tier."""
    control = _runner(None, ring_steps=32)
    _backlog(control)
    ref = JaxRunner(_build(JaxEnv), **_kw(tmp_path / "ref"))
    _backlog(ref)
    ref.executor.drain_spill()
    ref.inject_failure([3])
    ref.recover()
    r = _runner(tmp_path / "port")
    _backlog(r)
    r.executor.drain_spill()
    r.inject_failure([3])                          # window subtask 1
    report = r.recover()
    assert report.steps_replayed == 12 > 8
    stats = r.executor.spill_stats()
    assert stats["disk_hits"] > 0 and stats["write_errors"] == 0
    hi = r.auditor.last_epoch
    expected = [e for e in control.auditor.ledger() if e["epoch"] <= hi]
    actual = [e for e in r.auditor.ledger() if e["epoch"] <= hi]
    reference = [e for e in ref.auditor.ledger() if e["epoch"] <= hi]
    assert expected and diff_ledgers(expected, actual) == []
    assert actual == reference
    assert jax_diff_ledgers(reference, actual) == []
    assert r.last_audit.stats == {"match": 3, "divergence": 0,
                                  "missing": 0}
    _mirror_ignore(control, [3])
    _same_carry(control, r)
    # The job runs on from the recovered state like the control.
    for x in (control, r):
        x.run_epoch()
    _same_carry(control, r)


def test_torn_segment_tail_surfaces_as_labeled_recovery_error(tmp_path):
    r = _runner(tmp_path, ring_steps=8, budget=0)
    _backlog(r)
    r.executor.drain_spill()
    torn = glob.glob(os.path.join(str(tmp_path), "edge*_epoch1.seg"))
    assert torn, "expected spilled ring segments for epoch 1"
    for p in torn:
        data = open(p, "rb").read()
        open(p, "wb").write(data[:len(data) // 2])
    r.inject_failure([3])
    with pytest.raises(RecoveryError,
                       match=r"tiered refill failed.*epoch1"):
        r.recover()


def test_a_hole_in_the_spilled_span_is_refused(tmp_path):
    """The spill must supply steps [4, 16) (epochs 1-3) past the 8-step
    ring; with epoch 2 gone from every tier, recovery is refused with the
    missing range — the next epoch's steps are never spliced into it."""
    r = _runner(tmp_path, ring_steps=8, budget=0)
    _backlog(r, pending=5)
    r.executor.drain_spill()
    store = r.executor.spill_logs[0].store
    with store._lock:
        del store._epochs[2]
    r.inject_failure([3])
    with pytest.raises(RecoveryError,
                       match=r"spill does not cover steps \[8, 16\)"):
        r.recover()


def test_replay_past_the_ring_without_spill_raises(tmp_path):
    """10 steps since the restore point against an 8-step ring, killed
    before the next fence's overflow check: without spill the recovery
    is refused with its label."""
    r = _runner(None, ring_steps=8)
    _backlog(r, pending=2)
    for _ in range(2):
        r.step()
    r.inject_failure([3])
    with pytest.raises(RecoveryError, match="spill is disabled"):
        r.recover()


def test_det_store_refill_bit_identical_to_seal_window(tmp_path):
    r = _runner(tmp_path, ring_steps=32, budget=0)
    _backlog(r, pending=2)
    r.executor.drain_spill()
    ex = r.executor
    assert sorted(ex.det_store.retained_epochs()) == [1, 2]
    for epoch in (1, 2):
        win = ex.epoch_window(epoch)["logs"]
        for flat, rows in win.items():
            np.testing.assert_array_equal(ex.det_rows_for_epoch(flat, epoch),
                                          np.asarray(rows))
    assert ex.det_store.epoch_digest(2)


def test_spill_occupancy_and_stats_aggregate_across_stores(tmp_path):
    r = _runner(tmp_path, ring_steps=8, budget=1)
    _backlog(r, pending=2)
    r.executor.drain_spill()
    occ = r.executor.spill_occupancy()
    assert occ["disk_epochs"] > 0 and occ["disk_bytes"] > 0
    assert occ["host_epochs"] > 0
    stats = r.executor.spill_stats()
    assert stats["segments_written"] >= occ["disk_epochs"]
    assert stats["bytes_spilled"] >= occ["disk_bytes"]
    snap = r.metrics.snapshot()
    assert snap["job.tiered.spill.disk-epochs"] == occ["disk_epochs"]
    assert snap["job.tiered.spill.bytes-spilled"] == stats["bytes_spilled"]


def test_failover_drill_past_the_ring_is_served_by_spill(tmp_path):
    """The drill's refusal is lifted when spill is on: a drill whose
    replay span outruns the ring leaves the canonical carry unchanged."""
    r = _runner(tmp_path, ring_steps=8, budget=0)
    _backlog(r)
    for _ in range(2):
        r.step()
    r.executor.drain_spill()
    before = [x.clone() for x in
              tree_leaves(canonical_carry(r.executor.carry))]
    r.failover_drill([3])
    after = tree_leaves(canonical_carry(r.executor.carry))
    assert all(bool((a == b).all()) for a, b in zip(before, after))
    with pytest.raises(RecoveryError, match="spill is disabled"):
        plain = _runner(None, ring_steps=8)
        _backlog(plain, pending=2)
        for _ in range(2):
            plain.step()
        plain.failover_drill([3])
