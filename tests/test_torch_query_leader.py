"""PyTorch port, queryable state and leader leases
(``clonos_tpu_torch/runtime/query.py``, ``runtime/leader.py`` and the file
sink's ``fencing=`` handle): mirrors of the reference's
``tests/test_query_leader.py``, each held against the reference on the
same seeded job or the same injected clock, and one case with a
reference contender and a port contender on one lease path."""

import json
import os

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.leader import FileLeaderElection as JaxElection
from clonos_tpu.runtime.query import QueryableStateClient as JaxClient
from clonos_tpu.runtime.query import QueryableStateEndpoint as JaxEndpoint
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.filesink import FileSystemSink
from clonos_tpu_torch.runtime.leader import (FileLeaderElection,
                                             job_lease_path)
from clonos_tpu_torch.runtime.query import (QueryableStateClient,
                                            QueryableStateEndpoint)

NUM_KEYS = 11
KW = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
          inflight_ring_steps=16, seed=3, logical_time=True)


def _job(env_cls):
    env = env_cls(name="qs", num_key_groups=16, default_edge_capacity=64)
    (env.synthetic_source(vocab=NUM_KEYS, batch_size=8, parallelism=2)
        .key_by().reduce(num_keys=NUM_KEYS, name="r").sink())
    return env.build()


def test_queryable_state_point_lookup():
    """The client resolves (vertex, key) to the owning subtask's table
    entry, fence-consistent and advancing with epochs; every point and
    batch answer (value, subtask, key group, epoch, staleness) equals
    the reference endpoint's over the same seeded job."""
    r = ClusterRunner(_job(StreamEnvironment), device="cpu", **KW)
    jr = JaxRunner(_job(JaxEnv), **KW)
    for runner in (r, jr):
        runner.run_epoch(complete_checkpoint=True)
    ep, jep = QueryableStateEndpoint(r), JaxEndpoint(jr)
    c = jc = None
    try:
        c, jc = QueryableStateClient(ep.address), JaxClient(jep.address)
        acc = r.executor.vertex_state(1)["acc"]
        for key in range(NUM_KEYS):
            out = c.query(vertex=1, key=key)
            assert out["value"] == int(acc[out["subtask"], key])
            assert int(acc[:, key].sum()) == out["value"], \
                "key owned by exactly one subtask"
            assert out == jc.query(vertex=1, key=key)
        e0 = out["epoch"]
        # State advances with the next fence refresh.
        for runner, endpoint in ((r, ep), (jr, jep)):
            runner.run_epoch(complete_checkpoint=False)
            endpoint.refresh()
        out2 = c.query(vertex=1, key=3)
        assert out2 == jc.query(vertex=1, key=3)
        assert out2["epoch"] > e0
        acc2 = r.executor.vertex_state(1)["acc"]
        assert out2["value"] == int(acc2[out2["subtask"], 3])
        keys = list(range(NUM_KEYS)) * 2
        assert c.query_batch(1, keys) == jc.query_batch(1, keys)
        assert c.status() == jc.status()
        with pytest.raises(KeyError):
            c.query(vertex=1, key=999)
        with pytest.raises(KeyError):
            c.query_batch(1, [0, NUM_KEYS])
    finally:
        for client in (c, jc):
            if client is not None:
                client.close()
        ep.close()
        jep.close()


def _takeover(cls, path):
    """The reference test's takeover schedule; returns the handles."""
    t = [0.0]
    clock = lambda: t[0]
    a = cls(path, "jm-a", lease_ttl_s=2.0, clock=clock)
    b = cls(path, "jm-b", lease_ttl_s=2.0, clock=clock)

    assert a.try_acquire() and a.is_leader() and a.epoch == 1
    assert not b.try_acquire() and not b.is_leader()
    assert a.leader() == "jm-a"
    # Healthy renewal keeps the same fencing token.
    t[0] = 1.0
    assert a.renew() and a.epoch == 1
    # Leader stalls past the TTL; standby takes over with epoch 2.
    t[0] = 3.5
    assert b.try_acquire() and b.epoch == 2
    assert b.leader() == "jm-b"
    # The deposed leader cannot renew, and its renew never clobbers the
    # takeover (it rewrites only its own epoch's claim).
    assert not a.renew() and not a.is_leader()
    assert b.leader() == "jm-b"
    assert not b.fencing_valid(1)
    assert b.fencing_valid(2)
    # A token nobody won through O_EXCL is rejected too.
    assert not b.fencing_valid(3)
    with open(b._claim_path(2)) as f:
        rec = json.load(f)
    assert rec["leader_id"] == "jm-b" and "deadline_wall" in rec
    # The old leader re-acquires only after the new lease lapses, with a
    # fresh higher epoch; superseded claims are deleted.
    t[0] = 4.0
    assert not a.try_acquire()
    t[0] = 6.0
    assert a.try_acquire() and a.epoch == 3
    assert a._claims() == [2, 3]
    return a, b


def test_leader_election_takeover_and_fencing(tmp_path):
    """Exactly one leader; a lapsed lease is taken over with a higher
    fencing epoch; the deposed leader's renew fails and its stale epoch
    is rejected. The same schedule through the reference leaves the same
    claim files, byte for byte."""
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    a, b = _takeover(FileLeaderElection, str(tmp_path / "port" / "jm.lease"))
    _takeover(JaxElection, str(tmp_path / "ref" / "jm.lease"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == [
        "jm.lease.epoch2.claim", "jm.lease.epoch3.claim"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "ref" / n).read_bytes()

    # The race arbiter: an epoch is claimable exactly once (O_EXCL), and
    # a just-created, still-empty claim counts as live (mid-write grace).
    fd = os.open(b._claim_path(9), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.close(fd)
    assert not a.try_acquire() and not b.try_acquire()
    with pytest.raises(FileExistsError):
        os.close(os.open(b._claim_path(9),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    assert job_lease_path("/l/jm", "") == "/l/jm"
    assert job_lease_path("/l/jm", "job-1") == "/l/jm.job-1"
    with pytest.raises(ValueError):
        job_lease_path("/l/jm", "a/b")


def test_file_sink_gated_on_leadership_fencing(tmp_path):
    """A sink owned by a deposed incarnation must not write, commit or
    sweep; the new leader's sink over the same root works, and the part
    files are the reference sink's under the same schedule."""
    def run(cls, sink_cls, root):
        path = str(root / "jm.lease")
        t = [0.0]
        a = cls(path, "jm-a", lease_ttl_s=2.0, clock=lambda: t[0])
        assert a.try_acquire()
        rows = np.asarray([[1, 2, 3]], np.int32)
        sink = sink_cls(str(root / "out"), fencing=a)
        sink.write_pending(1, {0: rows})          # leader: allowed
        sink.commit(1, rows)
        assert sink.sweep_pending() == []
        # Depose jm-a; its sink refuses every mutation.
        t[0] = 3.5
        b = cls(path, "jm-b", lease_ttl_s=2.0, clock=lambda: t[0])
        assert b.try_acquire()
        assert not a.renew()
        for op in (lambda: sink.write_pending(2, {0: rows}),
                   lambda: sink.commit(2, rows),
                   lambda: sink.sweep_pending()):
            with pytest.raises(PermissionError):
                op()
        sink_b = sink_cls(str(root / "out"), fencing=b)
        sink_b.write_pending(2, {0: rows})
        sink_b.commit(2, rows)
        assert sink_b.committed_epochs() == [1, 2]
        return sorted(os.listdir(root / "out")), sink_b.read_committed()

    from clonos_tpu.runtime.filesink import FileSystemSink as JaxSink
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    names, rows = run(FileLeaderElection, FileSystemSink, tmp_path / "port")
    jnames, jrows = run(JaxElection, JaxSink, tmp_path / "ref")
    assert names == jnames
    np.testing.assert_array_equal(rows, jrows)
    # Without a handle the sink is unfenced, as before.
    FileSystemSink(str(tmp_path / "free")).sweep_pending()


@pytest.mark.parametrize("first", ["reference", "port"])
def test_reference_and_port_contenders_share_one_lease(tmp_path, first):
    """A reference contender and a port contender on one lease path see
    each other's claims: the holder blocks the other, a lapsed lease is
    taken over with the next epoch, the deposed side's renew fails and
    its token is refused, and the takeover goes back the other way."""
    path = str(tmp_path / "jm.lease")
    t = [0.0]
    clock = lambda: t[0]
    ref = JaxElection(path, "jm-ref", lease_ttl_s=2.0, clock=clock)
    port = FileLeaderElection(path, "jm-port", lease_ttl_s=2.0, clock=clock)
    x, y = (ref, port) if first == "reference" else (port, ref)

    assert x.try_acquire() and x.epoch == 1
    assert not y.try_acquire()
    assert y.leader() == x.contender_id == x.leader()
    t[0] = 1.0
    assert x.renew()
    assert not y.try_acquire()
    t[0] = 3.5                                  # x's lease lapsed
    assert y.try_acquire() and y.epoch == 2
    assert not x.renew() and not x.is_leader()
    assert x.leader() == y.contender_id
    assert x.fencing_valid(2) and not x.fencing_valid(1)
    assert y.fencing_valid(2) and not y.fencing_valid(1)
    # A sink fenced by the deposed side refuses; the leader's works.
    rows = np.asarray([[4, 5, 6]], np.int32)
    deposed_sink = FileSystemSink(str(tmp_path / "out"), fencing=x)
    with pytest.raises(PermissionError):
        deposed_sink.write_pending(2, {0: rows})
    t[0] = 6.0                                  # y's lease lapsed
    assert x.try_acquire() and x.epoch == 3
    assert not y.renew()
    assert y.leader() == x.contender_id
    assert ref._claims() == port._claims() == [2, 3]
    with open(port._claim_path(3)) as f:
        assert json.load(f) == {"leader_id": x.contender_id,
                                "deadline_wall": 8.0}
