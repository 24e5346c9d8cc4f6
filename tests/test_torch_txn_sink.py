"""PyTorch port, exactly-once egress: the transactional sink's committed
stream and its durable part files equal the reference runner's (file
bytes included), commit only on checkpoint completion, survive a sink
failure with sealed but uncommitted transactions (bit-identical to a
never-failed run), and come out the same through the pipelined fence;
the file sink's token-fenced sweep behaves as the reference's.
Tolerance: exact."""

import os

import numpy as np
import jax
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves
from clonos_tpu_torch.runtime.filesink import FileSystemSink


def _job(env_cls, kind="window"):
    env = env_cls(name="txn", num_key_groups=16)
    s = env.synthetic_source(vocab=13, batch_size=4, parallelism=2).key_by()
    if kind == "window":
        s = s.window_count(num_keys=13, window_size=40)
    else:
        s = s.window_event_time(num_keys=13, window_size=40,
                                out_of_orderness=8)
    s.sink(transactional=True)
    return env.build()


def _port(kind="window", **kw):
    r = ClusterRunner(_job(StreamEnvironment, kind), steps_per_epoch=3,
                      seed=3, device="cpu", **kw)
    r.executor.time_source.now = lambda it=iter(range(0, 4000, 17)): next(it)
    return r


def _ref(kind="window"):
    r = JaxRunner(_job(JaxEnv, kind), steps_per_epoch=3, seed=3,
                  heartbeat_timeout_s=600.0)
    r.executor.time_source.now = lambda it=iter(range(0, 4000, 17)): next(it)
    return r


def _leaves(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _tl(r):
    return r.txn_logs[next(iter(r.txn_logs))]


def test_commit_only_on_checkpoint_complete():
    r = _port()
    r.run_epoch(complete_checkpoint=False)
    tl = _tl(r)
    assert tl.pending_epochs() == [0]
    assert tl.committed_stream().shape[0] == 0
    r.coordinator.ack_all(0)
    assert tl.pending_epochs() == [] and len(tl.committed) == 1
    seen = []
    tl.committer = lambda e, recs: seen.append((e, recs.shape[0]))
    r.run_epoch()
    r.run_epoch()
    assert [e for e, _ in seen] == [1, 2]


@pytest.mark.parametrize("kind", ["window", "event-time"])
def test_committed_stream_equals_reference(kind):
    port, ref = _port(kind), _ref(kind)
    for r in (port, ref):
        for complete in (True, False, True, True):
            r.run_epoch(complete_checkpoint=complete)
    got, want = _tl(port).committed_stream(), _tl(ref).committed_stream()
    assert got.shape[0] > 0 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert [e for e, _ in _tl(port).committed] == \
        [e for e, _ in _tl(ref).committed]


@pytest.mark.parametrize("kill", ["sink", "window"])
def test_failure_leaves_committed_stream_exactly_once(kill):
    """Kill with sealed-but-uncommitted transactions pending; after
    recovery the committed stream equals a never-failed run's and the
    reference's faulted run's."""
    golden, port, ref = _port(), _port(), _ref()
    for r in (golden, port, ref):
        r.run_epoch()
        r.run_epoch(complete_checkpoint=False)
        r.run_epoch(complete_checkpoint=False)
    flat = (port.job.subtask_base(next(iter(port.txn_logs))) + 1
            if kill == "sink" else 3)
    for r in (port, ref):
        r.inject_failure([flat])
    rep, jrep = port.recover(), ref.recover()
    assert rep.steps_replayed == jrep.steps_replayed == 6
    for a, b in zip(_leaves(port), _leaves(ref, True)):
        np.testing.assert_array_equal(a, b)
    # The never-failed run logs the same IGNORE_CHECKPOINT decision.
    healthy = [f for f in range(golden.job.total_subtasks()) if f != flat]
    for cid in golden.coordinator.ignore_unacked_for({flat}):
        golden.executor.append_async_many(
            healthy, det.IgnoreCheckpointDeterminant(
                record_count=golden.executor.global_record_stamp(),
                checkpoint_id=cid))
    for r in (golden, port, ref):
        r.run_epoch()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)
    g = _tl(golden).committed_stream()
    np.testing.assert_array_equal(_tl(port).committed_stream(), g)
    np.testing.assert_array_equal(_tl(ref).committed_stream(), g)
    assert g.shape[0] > 0


def _files(root):
    return {fn: open(os.path.join(root, fn), "rb").read()
            for fn in sorted(os.listdir(root))}


def test_file_sink_bytes_equal_reference_across_failure(tmp_path):
    runs = {"golden": _port(), "port": _port(), "ref": _ref()}
    sinks = {k: r.attach_file_sink(next(iter(r.txn_logs)),
                                   str(tmp_path / k))
             for k, r in runs.items()}
    for r in runs.values():
        r.run_epoch()
        r.run_epoch(complete_checkpoint=False)
        r.run_epoch(complete_checkpoint=False)
    assert any(f.endswith(".pending") for f in os.listdir(tmp_path / "port"))
    assert sinks["port"].committed_epochs() == [0]
    flat = runs["port"].job.subtask_base(next(iter(runs["port"].txn_logs)))
    for k in ("port", "ref"):
        runs[k].inject_failure([flat + 1])
        runs[k].recover()
    for r in runs.values():
        r.run_epoch(complete_checkpoint=True)
    assert sinks["port"].committed_epochs() == [0, 1, 2, 3]
    files = {k: _files(tmp_path / k) for k in runs}
    assert files["port"] == files["golden"] == files["ref"]
    assert not any(f.endswith(".pending") for f in files["port"])
    np.testing.assert_array_equal(sinks["port"].read_committed(),
                                  sinks["ref"].read_committed())
    assert sinks["port"].sweep_pending() == []


def test_file_sink_sweeps_stale_pendings_on_restart(tmp_path):
    root = str(tmp_path / "sink")
    r = _port()
    fs = r.attach_file_sink(next(iter(r.txn_logs)), root)
    r.run_epoch()
    r.run_epoch(complete_checkpoint=False)
    assert any(f.endswith(".pending") for f in os.listdir(root))
    before = fs.read_committed()
    r2 = _port()
    fs2 = r2.attach_file_sink(next(iter(r2.txn_logs)), root)
    assert not any(f.endswith(".pending") for f in os.listdir(root))
    np.testing.assert_array_equal(fs2.read_committed(), before)


def test_file_sink_sweep_is_token_fenced(tmp_path):
    root = str(tmp_path / "shared")
    old, new = FileSystemSink(root, token=0), FileSystemSink(root, token=1)
    old.write_pending(3, {0: np.arange(6).reshape(2, 3)})
    new.write_pending(4, {0: np.arange(9).reshape(3, 3)})
    open(os.path.join(root, "part-5-0-t1.pending.tmp"), "wb").close()
    assert old.sweep_pending() == ["part-3-0-t0.pending"]
    assert sorted(os.listdir(root)) == ["part-4-0-t1.pending",
                                       "part-5-0-t1.pending.tmp"]
    old.commit(4, None)
    assert new.committed_epochs() == []
    old.write_pending(4, {1: np.arange(3).reshape(1, 3)})
    assert new.sweep_pending(keep_epochs=[4]) == [
        "part-4-1-t0.pending", "part-5-0-t1.pending.tmp"]
    new.commit(4, None)
    assert new.committed_epochs() == [4]


def test_pipelined_fence_commits_the_same_stream(tmp_path):
    seq = _port()
    ovl = _port(overlap_epoch=True, inflight_ring_steps=64)
    fs = {k: r.attach_file_sink(next(iter(r.txn_logs)), str(tmp_path / k))
          for k, r in (("seq", seq), ("ovl", ovl))}
    for r in (seq, ovl):
        for complete in (True, False, True, True):
            r.run_epoch(complete_checkpoint=complete)
    ovl.drain_fence()
    np.testing.assert_array_equal(_tl(ovl).committed_stream(),
                                  _tl(seq).committed_stream())
    assert _files(tmp_path / "ovl") == _files(tmp_path / "seq")
    assert fs["ovl"].committed_epochs() == [0, 1, 2, 3]
