"""PyTorch port, checkpoint coordination and epoch tracking: mirrors of the
reference's ``tests/test_checkpoint.py`` (trigger/ack/complete, retention,
ignore-unacked, backoff, file storage) and ``tests/test_epoch.py``
(listeners, async-determinant targets), each driven through both
packages on the same inputs with the same outcome; plus a port runner
restored from the reference runner's completed checkpoint
(``convert.checkpoint_from_numpy``). Tolerance: exact."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.causal import epoch as jep
from clonos_tpu.causal.determinant import \
    TimerTriggerDeterminant as JaxTimer
from clonos_tpu.runtime import checkpoint as jcp
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import epoch as ep
from clonos_tpu_torch.causal.determinant import TimerTriggerDeterminant
from clonos_tpu_torch.convert import carry_to_numpy, checkpoint_from_numpy
from clonos_tpu_torch.runtime import checkpoint as cp
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves

BOTH = pytest.mark.parametrize("mod", [cp, jcp], ids=["port", "reference"])


def _coord(mod, n=4, **kw):
    return mod.CheckpointCoordinator(mod.InMemoryCheckpointStorage(),
                                     num_subtasks=n, **kw)


@BOTH
def test_complete_requires_all_acks_and_write(mod):
    c = _coord(mod, n=2)
    done, dispatched = [], []
    c.subscribe_completion(done.append)
    c.subscribe_completed_state(lambda ck: dispatched.append(ck.checkpoint_id))
    c.trigger(0, {"x": np.arange(3)}, async_write=False)
    assert done == []
    c.ack(0, 0)
    assert done == []
    c.ack(0, 1)
    assert done == [0] and dispatched == [0]
    assert c.latest_completed_id == 0


@BOTH
def test_retention_deletes_old_checkpoints(mod):
    c = _coord(mod, n=1, max_retained=2)
    for cid in range(4):
        c.trigger(cid, {"v": np.asarray(cid)}, async_write=False)
        c.ack(cid, 0)
    assert c.storage.list_ids() == [2, 3]
    assert int(c.latest_completed().carry["v"]) == 3


@BOTH
def test_ignore_unacked_for_failed_task(mod):
    c = _coord(mod, n=3)
    c.trigger(5, {}, async_write=False)
    c.ack(5, 0)
    assert c.ignore_unacked_for({2}) == [5]
    # Late acks for an ignored checkpoint never complete it.
    c.ack(5, 1)
    c.ack(5, 2)
    assert c.latest_completed_id is None
    # Re-trigger of an ignored id is a no-op.
    c.trigger(5, {}, async_write=False)
    c.ack_all(5)
    assert c.latest_completed_id is None


@BOTH
def test_async_write_completes_after_drain(mod):
    """``trigger`` writes on a writer thread by default; the acks may land
    first, and whichever thread finishes last completes the checkpoint."""
    c = _coord(mod, n=2)
    done = []
    c.subscribe_completion(done.append)
    c.trigger(0, {"x": np.arange(3)})
    c.ack_all(0)
    c.drain()
    assert done == [0] and c.latest_completed_id == 0
    assert c.storage.completed_ids() == [0]
    assert c.completion_latency_s[0] >= 0.0


@BOTH
def test_single_completer_under_racing_acks(mod):
    """Acks from several threads racing the writer: every checkpoint's
    completion listeners fire exactly once."""
    import threading
    c = _coord(mod, n=4, max_retained=100)
    done = []
    c.subscribe_completion(done.append)
    for cid in range(12):
        c.trigger(cid, {"v": np.asarray(cid)})
        ts = [threading.Thread(target=c.ack, args=(cid, s))
              for s in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    c.drain()
    assert sorted(done) == list(range(12))
    assert c.storage.completed_ids() == list(range(12))


def test_transition_observers_match_reference():
    """The protocol transitions both coordinators report, in order, for
    the same script (trigger / ack / complete / ignore / discard, and an
    adopted ignore that blocks a later trigger)."""
    seqs = []
    for mod in (cp, jcp):
        c = _coord(mod, n=2)
        seen = []
        c.transition_observers.append(
            lambda kind, **f: seen.append((kind, sorted(f.items()))))
        c.trigger(0, {}, async_write=False)
        c.ack(0, 0)
        c.ack_all(0)
        c.trigger(1, {}, async_write=False)
        c.ack(1, 1)
        assert c.ignore_unacked_for({0}) == [1]
        c.mark_ignored([5])
        c.trigger(5, {}, async_write=False)
        c.ack_all(5)
        c.trigger(6, {}, async_write=False)
        assert c.discard_pending_through(6) == [6]
        assert c.latest_completed_id == 0
        seqs.append(seen)
    assert seqs[0] == seqs[1]
    assert [k for k, _ in seqs[0]] == [
        "trigger", "ack", "ack", "complete", "trigger", "ack", "ignore",
        "trigger", "discard"]


def test_async_file_write_of_tensors(tmp_path):
    """File storage gets the snapshot as numpy: the copy starts on the
    triggering thread and the writer only waits for it. Completed ids are
    read back from the durable markers."""
    c = cp.CheckpointCoordinator(cp.FileCheckpointStorage(str(tmp_path)),
                                 num_subtasks=1)
    carry = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
             "b": (torch.ones(2, dtype=torch.bool),)}
    c.trigger(0, carry)
    c.trigger(1, carry)
    c.ack(1, 0)
    c.drain()
    assert c.storage.list_ids() == [0, 1]
    assert c.storage.completed_ids() == [1]
    got = c.storage.read(1).carry
    np.testing.assert_array_equal(got["a"], np.arange(6).reshape(2, 3))
    assert got["a"].dtype == np.int32 and got["b"][0].dtype == np.bool_
    assert c.storage.read(1).size_bytes == 6 * 4 + 2


def test_backoff_and_reset():
    seqs = []
    for mod in (cp, jcp):
        c = _coord(mod, n=1, base_interval_steps=16, backoff_multiplier=2.0,
                   max_backoff_steps=100)
        seqs.append([c.interval_steps, c.backoff(), c.backoff(),
                     c.backoff(), c.backoff(), c.reset_interval()])
    assert seqs[0] == seqs[1] == [16, 32, 64, 100, 100, 16]


def test_file_storage_roundtrip(tmp_path):
    st = cp.FileCheckpointStorage(str(tmp_path))
    carry = {"a": torch.arange(5, dtype=torch.int32),
             "b": np.ones((2, 2))}
    st.write(cp.CompletedCheckpoint(3, carry_to_numpy(carry), 0.0))
    got = st.read(3)
    np.testing.assert_array_equal(got.carry["a"], np.arange(5))
    assert got.carry["a"].dtype == np.int32
    assert st.list_ids() == [3]
    st.delete(3)
    assert st.list_ids() == []


def test_file_ledger_is_readable_by_the_reference(tmp_path):
    """The port's ledger.jsonl is in the reference's line format, and the
    torn final line of a killed writer is dropped by both readers."""
    st = cp.FileCheckpointStorage(str(tmp_path))
    entries = [{"epoch": 0, "combined": "aa", "records": 3},
               {"epoch": 1, "combined": "bb", "records": 4}]
    for e in entries:
        st.write_ledger(e)
    st.flush_ledger()
    path = st.ledger_path()
    assert jcp.read_ledger_file(path) == entries == st.read_ledger()
    # Compaction below a fence keeps one entry per epoch, last wins.
    st.write_ledger({"epoch": 0, "combined": "cc", "records": 3})
    want = jcp.compact_ledger_entries(jcp.read_ledger_file(path), 1)
    assert st.compact_ledger(1) == 1
    assert st.read_ledger() == want == jcp.read_ledger_file(path)
    assert [e["combined"] for e in want] == ["cc", "bb"]
    with open(path, "a") as f:
        f.write('{"epoch": 2, "com')
    assert jcp.read_ledger_file(path) == want == cp.read_ledger_file(path)


def test_group_commit_ledger_torn_batched_tail_roundtrip(tmp_path):
    """Mirror of ``tests/test_pipelined_fence.py``'s group-commit case on
    the port's storage: appends are flushed per line but fsynced every K;
    the tolerant reader drops only a torn last line, and ``flush_ledger``
    (the completion path) zeroes the unsynced window."""
    st = cp.FileCheckpointStorage(str(tmp_path / "ck"))
    assert st.ledger_group_commit == 8
    for i in range(11):
        st.write_ledger({"epoch": i, "records": 10 * i})
    assert st._ledger_unsynced == 3
    assert [e["epoch"] for e in st.read_ledger()] == list(range(11))
    st.flush_ledger()
    assert st._ledger_unsynced == 0
    st._close_ledger()
    path = st.ledger_path()
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.splitlines(keepends=True)
    torn = b"".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2]
    with open(path, "wb") as f:
        f.write(torn)
    assert [e["epoch"] for e in cp.read_ledger_file(path)] \
        == list(range(10)), "only the torn LAST line is dropped"
    cp.CheckpointStorage().flush_ledger()


@pytest.mark.parametrize("appends,fsyncs,unsynced", [(8, 1, 0), (11, 1, 3)])
def test_group_commit_fsyncs_and_bytes_match_reference(tmp_path, monkeypatch,
                                                       appends, fsyncs,
                                                       unsynced):
    """The same ``write_ledger`` calls on a fresh storage of each package:
    equal ``os.fsync`` counts, equal unsynced windows, equal bytes; the
    completion's ``flush_ledger`` zeroes both windows."""
    import os as _os
    calls = []
    real = _os.fsync
    monkeypatch.setattr(_os, "fsync", lambda fd: (calls.append(fd),
                                                  real(fd))[1])
    got = {}
    for tag, mod in (("port", cp), ("reference", jcp)):
        st = mod.FileCheckpointStorage(str(tmp_path / tag))
        del calls[:]
        for i in range(appends):
            st.write_ledger({"epoch": i, "records": 3 * i,
                             "combined": f"{i:04x}"})
        got[tag] = (len(calls), st._ledger_unsynced)
        st.flush_ledger()
        assert st._ledger_unsynced == 0
        st._close_ledger()
        with open(st.ledger_path(), "rb") as f:
            got[tag] += (f.read(),)
    assert got["port"] == got["reference"]
    assert got["port"][:2] == (fsyncs, unsynced)


# --- epoch tracking ----------------------------------------------------------


def test_device_epoch_state():
    if not torch.cuda.is_available():   # the default is the card
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            ep.EpochState.initial()
    s = ep.EpochState.initial(device="cpu")
    s = ep.inc_record_count(s, 5)
    s = ep.inc_record_count(s, torch.tensor(3, dtype=torch.int32))
    s = ep.start_new_epoch(s, 1)
    s = ep.inc_record_count(s, 2)
    j = jep.EpochState.initial()
    for f, a in ((jep.inc_record_count, 5), (jep.inc_record_count, 3),
                 (jep.start_new_epoch, 1), (jep.inc_record_count, 2)):
        j = f(j, a)
    got = [int(x) for x in s]
    assert got == [int(x) for x in j] == [1, 2, 10]
    assert all(x.dtype == torch.int32 for x in s)
    assert not bool(ep.total_records_near_wrap(s))
    assert int(ep.rebase_total_records(s, 4).total_records) == 6


TRACKERS = pytest.mark.parametrize(
    "mod,timer", [(ep, TimerTriggerDeterminant), (jep, JaxTimer)],
    ids=["port", "reference"])


@TRACKERS
def test_host_tracker_listeners(mod, timer):
    t = mod.EpochTracker()
    seen = []
    t.subscribe_epoch_start(seen.append)
    t.subscribe_checkpoint_complete(lambda c: seen.append(("ckpt", c)))
    t.start_new_epoch(1)
    t.notify_checkpoint_complete(0)
    assert seen == [1, ("ckpt", 0)]
    assert t.record_count == 0


@TRACKERS
def test_async_determinant_fires_at_target(mod, timer):
    t = mod.EpochTracker()
    fired = []
    d5 = timer(record_count=5, callback_id=1)
    d2 = timer(record_count=2, callback_id=2)
    t.set_record_count_target(5, d5, fired.append)
    t.set_record_count_target(2, d2, fired.append)
    t.inc_record_count(1)
    assert fired == []
    t.inc_record_count(1)
    assert fired == [d2]
    t.inc_record_count(4)
    assert fired == [d2, d5]
    assert t.pending_targets == 0


@TRACKERS
def test_same_target_fifo_order(mod, timer):
    t = mod.EpochTracker()
    fired = []
    a = timer(record_count=3, callback_id=1)
    b = timer(record_count=3, callback_id=2)
    t.set_record_count_target(3, a, fired.append)
    t.set_record_count_target(3, b, fired.append)
    t.inc_record_count(3)
    assert fired == [a, b]


@TRACKERS
def test_target_in_past_rejected(mod, timer):
    t = mod.EpochTracker()
    t.inc_record_count(10)
    with pytest.raises(ValueError):
        t.set_record_count_target(5, timer(record_count=5), lambda d: None)


@TRACKERS
def test_target_at_current_count_fires_immediately(mod, timer):
    t = mod.EpochTracker()
    t.inc_record_count(5)
    fired = []
    d = timer(record_count=5, callback_id=9)
    t.set_record_count_target(5, d, fired.append)
    assert fired == [d]


@TRACKERS
def test_target_zero_fires_on_epoch_start(mod, timer):
    t = mod.EpochTracker()
    t.inc_record_count(3)
    fired = []
    t.start_new_epoch(1)
    d = timer(record_count=0, callback_id=1)
    t.set_record_count_target(0, d, fired.append)
    assert fired == [d]


def test_timer_determinant_packs_like_the_reference():
    d = TimerTriggerDeterminant(record_count=7, callback_id=3,
                                timestamp=(1 << 40) + 5)
    j = JaxTimer(record_count=7, callback_id=3, timestamp=(1 << 40) + 5)
    np.testing.assert_array_equal(d.pack(), j.pack())
    assert det.Determinant.unpack(d.pack()) == d
    from clonos_tpu.causal import determinant as jdet
    rows = np.stack([d.pack(), det.BufferBuiltDeterminant(9).pack()])
    assert det.to_bytes(rows) == jdet.to_bytes(rows)
    assert det.TAG_NAMES == jdet.TAG_NAMES and det.NUM_TAGS == jdet.NUM_TAGS


# --- a port runner from the reference's checkpoint ---------------------------


def _job(env_cls):
    env = env_cls(name="ckpt", num_key_groups=8)
    (env.synthetic_source(vocab=7, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=7, window_size=4).sink())
    return env.build()


def test_port_runner_recovers_from_the_reference_checkpoint():
    """The reference runner's completed checkpoint (a LeanSnapshot) comes
    over as numpy, equals the port's own checkpoint of the same schedule
    leaf for leaf, and serves as the restore point of a port recovery
    that lands bit-identical to a port run that never failed."""
    kw = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=4, logical_time=True)
    ref = JaxRunner(_job(JaxEnv), heartbeat_timeout_s=600.0, **kw)
    golden = ClusterRunner(_job(StreamEnvironment), device="cpu", **kw)
    port = ClusterRunner(_job(StreamEnvironment), device="cpu", **kw)
    for r in (ref, golden, port):
        r.run_epoch()
        r.run_epoch()
    jck = ref.standbys.latest
    converted = checkpoint_from_numpy(dataclasses.replace(
        jck, carry=jax.tree_util.tree_map(np.asarray, jck.carry)), "cpu")
    own = port.standbys.latest
    assert converted.checkpoint_id == own.checkpoint_id == 1
    la, lb = tree_leaves(converted.carry), tree_leaves(own.carry)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # Restore-cost accounting agrees too: one subtask's row vs the whole.
    assert cp.carry_nbytes(own.carry) == jcp.carry_nbytes(jck.carry)
    assert cp.snapshot_subtask_nbytes(own.carry, 1, 1) \
        == jcp.snapshot_subtask_nbytes(jck.carry, 1, 1)
    port.standbys.latest = converted
    for r in (golden, port):
        r.step()
        r.step()
    port.inject_failure([3])
    port.recover()
    got = tree_leaves(tex.canonical_carry(port.executor.carry))
    want = tree_leaves(tex.canonical_carry(golden.executor.carry))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
