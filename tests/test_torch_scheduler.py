"""PyTorch port, the slot-pool scheduler (mirror of the reference's
``tests/test_scheduler.py``): placement, slicing, the slot pool, the
fenced deployment gateway, the ring-less bootstrap fence, the
cross-worker edge wire, and one job spanning two ``python -m
clonos_tpu_torch slotworker --device cpu`` processes with per-task
recovery. Beside each mirrored test, the port is held against the
reference on the same inputs (made from a seed with numpy where they are
random): partitions and slices, pool verdicts, EDGE_DATA bytes, digests
across the wire in both directions, DEPLOY headers key for key, and
fencing against a lease directory written by either package.
Tolerance: exact."""

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.api.feeds import ListFeedReader as JaxListFeedReader
from clonos_tpu.parallel import transport as jtp
from clonos_tpu.runtime import remote as jremote
from clonos_tpu.runtime import scheduler as jsch
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.leader import FileLeaderElection as JaxElection
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.api.feeds import ListFeedReader
from clonos_tpu_torch.examples import spanning as tsp
from clonos_tpu_torch.examples import wordcount as twc
from clonos_tpu_torch.graph.job_graph import PartitionType
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.parallel.distributed import standby_worker_order
from clonos_tpu_torch.runtime import remote
from clonos_tpu_torch.runtime import scheduler as sch
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.leader import FileLeaderElection
from clonos_tpu_torch.runtime.remote import JobMasterServer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "clonos_tpu_torch.examples.spanning:build_job"
JAX_SPEC = "examples.spanning:build_job"
#: logical_time: digests are a pure function of (job, seed, records)
KW = dict(steps_per_epoch=4, log_capacity=512, max_epochs=16,
          inflight_ring_steps=32, seed=7, logical_time=True)
LINES = [((i * 37) % 997, 1 + i % 5) for i in range(128)]


def _jax_spanning():
    import examples.spanning as sp
    return sp.build_job()


def _jax_wordcount():
    import examples.wordcount as wc
    return wc.build_job()


def _headline(env_cls, par=3):
    """The headline job's shape (source -> keyBy -> window -> keyBy ->
    reduce -> sink) at a small width."""
    env = env_cls(name="bench-allround", num_key_groups=8,
                  default_edge_capacity=16)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=par)
        .key_by()
        .window_count(num_keys=13, window_size=8, name="window")
        .key_by()
        .reduce(num_keys=13, name="reduce")
        .sink())
    return env.build()


_JOBS = {
    "spanning": (tsp.build_job, _jax_spanning),
    "wordcount": (twc.build_job, _jax_wordcount),
    "headline": (lambda: _headline(StreamEnvironment),
                 lambda: _headline(JaxEnv)),
}


# --- placement ---------------------------------------------------------------


def test_partition_vertices_cuts_on_exchange_edges():
    job = tsp.build_job()       # lines -> tag -> (HASH) window -> sink
    parts = sch.partition_vertices(job, 2)
    assert parts == [[0, 1], [2, 3]]
    for part in parts:
        ins, outs = sch.cut_edges(job, part)
        for eidx in ins + outs:
            assert job.edges[eidx].partition != PartitionType.FORWARD
    assert sch.partition_vertices(job, 1) == [[0, 1, 2, 3]]

    wc = twc.build_job()        # source -(HASH)- window -(FWD)- sink
    assert sch.partition_vertices(wc, 2) == [[0], [1, 2]]
    with pytest.raises(ValueError, match="cut points"):
        sch.partition_vertices(wc, 3)
    with pytest.raises(ValueError, match="cannot cut"):
        sch.partition_vertices(wc, 0)
    with pytest.raises(ValueError, match="cannot cut"):
        sch.partition_vertices(wc, 9)

    head = _headline(StreamEnvironment)
    # The headline's two-worker cut lands on the window -> reduce HASH.
    assert sch.partition_vertices(head, 2) == [[0, 1], [2, 3]]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


@pytest.mark.parametrize("name", sorted(_JOBS))
def test_partitions_and_cuts_equal_reference(name):
    port_job, ref_job = (f() for f in _JOBS[name])
    n = len(port_job.vertices)
    for k in range(0, n + 2):
        got = _outcome(lambda: sch.partition_vertices(port_job, k))
        want = _outcome(lambda: jsch.partition_vertices(ref_job, k))
        assert got == want, (name, k)
        if got[0] == "ok":
            for part in got[1]:
                assert sch.cut_edges(port_job, part) == \
                    jsch.cut_edges(ref_job, part)


def test_subgraph_boundaries_feeds_exports_and_forward_rejection():
    job = tsp.build_job()
    sub0, vmap0, feeds0, exports0 = job.subgraph([0, 1], feed_batch_size=4)
    assert vmap0 == {0: 0, 1: 1} and feeds0 == {}
    assert exports0 == {1: 1}            # cut out-edge 1 served by "tag"
    assert [v.name for v in sub0.vertices] == ["lines", "tag", "export-1"]
    assert sub0.edges[-1].partition == PartitionType.FORWARD

    sub1, vmap1, feeds1, exports1 = job.subgraph([2, 3], feed_batch_size=4)
    assert vmap1 == {2: 0, 3: 1} and exports1 == {}
    assert feeds1 == {1: 2}              # cut in-edge 1 -> boundary feed
    fv = sub1.vertices[feeds1[1]]
    assert fv.name == "feed-in-1" and fv.parallelism == 1
    assert fv.operator.batch_size == 4
    (feed_edge,) = [e for e in sub1.edges if e.src == feeds1[1]]
    assert feed_edge.partition == PartitionType.HASH
    assert feed_edge.dst == vmap1[2]

    with pytest.raises(ValueError, match="FORWARD"):
        twc.build_job().subgraph([2])


def _shape(job):
    return ([(v.vertex_id, v.name, type(v.operator).__name__,
              v.parallelism, getattr(v.operator, "batch_size", None))
             for v in job.vertices],
            [(e.src, e.dst, e.partition.value, e.capacity)
             for e in job.edges],
            (job.name, job.num_key_groups, job.sharing_depth))


@pytest.mark.parametrize("name", sorted(_JOBS))
def test_subgraph_equals_reference(name):
    port_job, ref_job = (f() for f in _JOBS[name])
    n = len(port_job.vertices)
    for k in range(1, n + 1):
        try:
            parts = jsch.partition_vertices(ref_job, k)
        except ValueError:
            continue
        for part in parts:
            got = port_job.subgraph(part, feed_batch_size=3)
            want = ref_job.subgraph(part, feed_batch_size=3)
            assert _shape(got[0]) == _shape(want[0])
            assert got[1:] == want[1:]
    # Every single-vertex slice, FORWARD rejections included.
    for v in range(n):
        got = _outcome(lambda: port_job.subgraph([v])[1:])
        want = _outcome(lambda: ref_job.subgraph([v])[1:])
        assert got == want


# --- the slot pool -----------------------------------------------------------


def test_slot_pool_allocation_standby_and_worker_loss():
    pool = sch.SlotPool()
    pool.sync_offers({"a": 2, "b": 1})
    assert pool.workers() == ["a", "b"]
    assert len(pool.free_slots()) == 3

    s0 = pool.allocate(0, prefer="a")
    s1 = pool.allocate(1, prefer="b")
    assert (s0.worker_id, s1.worker_id) == ("a", "b")
    assert pool.placements() == {0: "a", 1: "b"}
    s2 = pool.allocate(2, prefer="b", avoid=("b",))
    assert s2.worker_id == "a"
    with pytest.raises(RuntimeError, match="no free slot"):
        pool.allocate(3, avoid=("a", "b"))

    assert pool.drop_worker("b") == [1]
    assert pool.workers() == ["a"]
    pool.release_group(2)
    assert pool.allocate(1).worker_id == "a"

    assert list(standby_worker_order(3)) == [1, 2, 0]
    assert list(standby_worker_order(1)) == [0]
    with pytest.raises(ValueError):
        standby_worker_order(0)


def _pool_ops(seed, n=400):
    """A seeded random sequence of pool operations."""
    rng = np.random.RandomState(seed)
    workers = ["a", "b", "c", "d"]
    ops = []
    for _ in range(n):
        kind = rng.choice(["offer", "alloc", "alloc", "release", "drop"],
                          p=[0.15, 0.25, 0.25, 0.25, 0.1])
        if kind == "offer":
            ops.append(("offer", {w: int(rng.randint(0, 4))
                                  for w in workers if rng.rand() < 0.6}))
        elif kind == "alloc":
            job = f"j{rng.randint(0, 3)}"
            group = (job, int(rng.randint(0, 4)))
            prefer = (workers[rng.randint(0, 4)] if rng.rand() < 0.7
                      else None)
            avoid = tuple(w for w in workers if rng.rand() < 0.2)
            ops.append(("alloc", group, prefer, avoid))
        elif kind == "release":
            ops.append(("release", (f"j{rng.randint(0, 3)}",
                                    int(rng.randint(0, 4)))))
        else:
            ops.append(("drop", workers[rng.randint(0, 4)]))
    return ops


def _run_pool(mod, ops):
    pool = mod.SlotPool()
    trace = []
    for op in ops:
        if op[0] == "offer":
            pool.sync_offers(op[1])
            trace.append(("offer", pool.workers(), len(pool.free_slots())))
        elif op[0] == "alloc":
            try:
                s = pool.allocate(op[1], prefer=op[2], avoid=op[3])
                trace.append(("alloc", s.worker_id, s.index))
            except RuntimeError as e:
                trace.append(("alloc-refused", str(e)))
        elif op[0] == "release":
            pool.release_group(op[1])
            trace.append(("release", sorted(pool.placements().items())))
        else:
            trace.append(("drop", pool.drop_worker(op[1])))
        trace.append(sorted(pool.placements().items()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_pool_verdicts_equal_reference(seed):
    ops = _pool_ops(seed)
    assert _run_pool(sch, ops) == _run_pool(jsch, ops)


# --- fenced deployment gateway ----------------------------------------------


def _deploy_frame(tdd, frame=b""):
    hdr = tp.pack_json(tdd)
    return len(hdr).to_bytes(4, "little") + hdr + frame


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_endpoint_rejects_stale_and_forged_fencing_tokens(tmp_path, writer):
    """The lease directory is written by either package's election
    (their claim files are byte-compatible)."""
    election = FileLeaderElection if writer == "port" else JaxElection
    lease = str(tmp_path / "jm.lease")
    t = [0.0]
    a = election(lease, "jm-a", lease_ttl_s=2.0, clock=lambda: t[0])
    b = election(lease, "jm-b", lease_ttl_s=2.0, clock=lambda: t[0])
    assert a.try_acquire() and a.epoch == 1
    t[0] = 3.5                            # jm-a's lease lapses
    assert b.try_acquire() and b.epoch == 2

    ep = sch.TaskExecutorEndpoint(lease_path=lease)
    seen = []
    ep.transition_observers.append(
        lambda kind, **f: seen.append((kind, f.get("why"))))
    cl = tp.ControlClient(ep.address)
    try:
        rt, resp = cl.call(tp.DEPLOY, _deploy_frame({"group": 0}))
        assert rt == tp.ERROR and "no fencing" in tp.unpack_json(resp)["error"]
        rt, resp = cl.call(tp.DEPLOY,
                           _deploy_frame({"group": 0, "fencing_epoch": 1}))
        assert rt == tp.ERROR
        assert "lease claim" in tp.unpack_json(resp)["error"]
        rt, resp = cl.call(tp.DEPLOY,
                           _deploy_frame({"group": 0, "fencing_epoch": 9}))
        assert rt == tp.ERROR
        rt, resp = cl.call(tp.DEPLOY,
                           _deploy_frame({"group": 7, "fencing_epoch": 2}))
        assert rt == tp.OK and tp.unpack_json(resp)["accepted"]
        assert ep.queue.get_nowait()["group"] == 7
        assert ep.queue.empty()
        # Now a stale token fails the monotone check first.
        rt, resp = cl.call(tp.DEPLOY,
                           _deploy_frame({"group": 0, "fencing_epoch": 1}))
        assert "stale fencing" in tp.unpack_json(resp)["error"]
    finally:
        cl.close()
        ep.close()
    assert seen == [("fence-reject", "missing"),
                    ("fence-reject", "not-current-claim"),
                    ("fence-reject", "not-current-claim"),
                    ("fence-accept", None), ("fence-reject", "stale")]

    ep2 = sch.TaskExecutorEndpoint()
    cl2 = tp.ControlClient(ep2.address)
    try:
        rt, _ = cl2.call(tp.DEPLOY,
                         _deploy_frame({"group": 0, "fencing_epoch": 5}))
        assert rt == tp.OK
        rt, resp = cl2.call(tp.DEPLOY,
                            _deploy_frame({"group": 0, "fencing_epoch": 4}))
        assert rt == tp.ERROR
        assert "stale fencing" in tp.unpack_json(resp)["error"]
    finally:
        cl2.close()
        ep2.close()


def test_endpoint_decodes_mirror_rows_like_reference():
    """A recovery DEPLOY's frame (mirror rows) decodes to the same rows
    on both endpoints."""
    rng = np.random.RandomState(11)
    from clonos_tpu_torch.causal import serde
    deltas = [(f, int(rng.randint(0, 50)),
               rng.randint(-9, 9, (int(rng.randint(0, 6)), 8))
               .astype(np.int32)) for f in range(3)]
    frame = serde.encode_delta(deltas)
    got = {}
    for name, mod, tmod in (("port", sch, tp), ("ref", jsch, jtp)):
        ep = mod.TaskExecutorEndpoint()
        cl = tmod.ControlClient(ep.address)
        try:
            rt, _ = cl.call(tmod.DEPLOY, _deploy_frame(
                {"group": 1, "fencing_epoch": 3}, frame))
            assert rt == tmod.OK
            got[name] = ep.queue.get_nowait()["_mirror_rows"]
        finally:
            cl.close()
            ep.close()
    assert sorted(got["port"]) == sorted(got["ref"]) == [0, 1, 2]
    for f in range(3):
        assert got["port"][f][1] == got["ref"][f][1]
        assert np.array_equal(got["port"][f][0], got["ref"][f][0])


# --- ring-less bootstrap fence -----------------------------------------------


def test_bootstrap_standby_derives_ringless_fence_from_cadence(tmp_path):
    env = StreamEnvironment(name="ringless", num_key_groups=8)
    env.synthetic_source(vocab=7, batch_size=4, parallelism=1)
    job = env.build()
    ck = str(tmp_path / "ck")
    kw = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8, seed=2,
              device="cpu")
    r = ClusterRunner(job, checkpoint_dir=ck, **kw)
    for _ in range(3):
        r.run_epoch(complete_checkpoint=True)
    logs = r.executor.carry.logs
    head = int(logs.head[0])
    tail = int(logs.tail[0])
    rows = logs.rows.numpy()
    cap = rows.shape[1]
    pos = np.arange(tail, head) & (cap - 1)
    mirror_rows = {0: (rows[0][pos], tail)}
    rebuilt, report = ClusterRunner.bootstrap_standby(job, ck, mirror_rows,
                                                      **kw)
    assert rebuilt.global_step == 12 + report.steps_replayed
    assert rebuilt.executor.epoch_id == 3 + report.steps_replayed // 4


# --- cross-worker edge wire, in-process --------------------------------------


def _epochs(runner, n, complete_every=2):
    out = {}
    for _ in range(n):
        closed = runner.executor.epoch_id
        runner.run_epoch(complete_checkpoint=(closed % complete_every == 0))
        out[runner.global_step] = runner.state_digest()
    return out


def _fetch_all(address, tmod=tp):
    cl = tmod.ControlClient(address)
    try:
        rt, resp = cl.call(tmod.FETCH_EDGE, tmod.pack_json(
            {"edge": 1, "start": 0, "count": 1 << 20}))
    finally:
        cl.close()
    assert rt == tmod.EDGE_DATA
    hlen = int.from_bytes(resp[:4], "little")
    return tmod.unpack_json(resp[4: 4 + hlen]), resp


def _port_upstream(overlap_epoch=False):
    sub0, vmap0, _f, exports0 = tsp.build_job().subgraph(
        [0, 1], feed_batch_size=8)
    up = ClusterRunner(sub0, device="cpu", overlap_epoch=overlap_epoch,
                       **KW)
    up.executor.register_feed(vmap0[0], ListFeedReader([LINES]))
    export = sch.EdgeExportServer(up, exports0)
    # 4 epochs drain the feed + 1 flush epoch (the source -> tag hop is
    # one superstep deep).
    _epochs(up, 5)
    if overlap_epoch:
        up.drain_fence()
    export.mark_final()
    return up, export


@pytest.fixture(scope="module")
def ref_export():
    """The reference's upstream slice over the same lines, exported."""
    sub0, vmap0, _f, exports0 = _jax_spanning().subgraph(
        [0, 1], feed_batch_size=8)
    up = JaxRunner(sub0, **KW)
    up.executor.register_feed(vmap0[0], JaxListFeedReader([LINES]))
    export = jsch.EdgeExportServer(up, exports0)
    _epochs(up, 5)
    export.mark_final()
    yield export
    export.close()


@pytest.mark.parametrize("overlap_epoch", [False, True])
def test_edge_export_wire_is_deterministic_and_rewindable(overlap_epoch):
    """The downstream half of a cut edge consumed over the wire gives the
    digests of the same slice fed the same records from memory; the
    upstream publishes inside the fence window in both the sequential
    and the pipelined fence; read_at re-serves exact ranges; reading past
    a finished stream fails loudly."""
    up, export = _port_upstream(overlap_epoch)
    try:
        assert export.publishes >= 4
        sub1, _v, feeds1, _e = tsp.build_job().subgraph(
            [2, 3], feed_batch_size=8)
        down = ClusterRunner(sub1, device="cpu", **KW)
        reader = sch.RemoteEdgeFeedReader(export.address, edge=1)
        down.executor.register_feed(feeds1[1], reader)
        wire_digests = _epochs(down, 4)

        k0, v0 = reader.read_at(0, 0, 16)
        k1, v1 = reader.read_at(0, 8, 8)
        assert k0[8:] == k1 and v0[8:] == v1
        with pytest.raises(RuntimeError, match="finished"):
            reader.read_at(0, 0, 10_000)

        hdr, resp = _fetch_all(export.address)
        assert hdr["final"] and hdr["count"] == hdr["avail"] == 128
        hlen = int.from_bytes(resp[:4], "little")
        recs = np.frombuffer(resp[4 + hlen:], np.int32).reshape(-1, 2)

        ctrl = ClusterRunner(sub1, device="cpu", **KW)
        ctrl.executor.register_feed(feeds1[1],
                                    ListFeedReader([recs.tolist()]))
        assert wire_digests == _epochs(ctrl, 4)
        reader.close()
    finally:
        export.close()


@pytest.mark.parametrize("overlap_epoch", [False, True])
def test_edge_data_bytes_equal_reference(ref_export, overlap_epoch):
    """FETCH_EDGE's EDGE_DATA frame from a port upstream slice is the
    reference's, byte for byte, for the same ListFeedReader lines —
    whole, and in windows across the stream's end."""
    _up, export = _port_upstream(overlap_epoch)
    try:
        for start, count in ((0, 1 << 20), (0, 16), (37, 50), (120, 30),
                             (500, 4)):
            frames = []
            for addr, tmod in ((export.address, tp),
                               (ref_export.address, jtp)):
                cl = tmod.ControlClient(addr)
                try:
                    frames.append(cl.call(tmod.FETCH_EDGE, tmod.pack_json(
                        {"edge": 1, "start": start, "count": count})))
                finally:
                    cl.close()
            assert frames[0] == frames[1], (start, count)
    finally:
        export.close()


@pytest.mark.parametrize("direction", ["port-reads-reference",
                                       "reference-reads-port"])
def test_wire_digests_cross_packages(ref_export, direction):
    """A downstream slice reading the other package's export over the
    wire gives the reference's digests (port state digests equal the
    reference's)."""
    if direction == "port-reads-reference":
        sub1, _v, feeds1, _e = tsp.build_job().subgraph(
            [2, 3], feed_batch_size=8)
        down = ClusterRunner(sub1, device="cpu", **KW)
        reader = sch.RemoteEdgeFeedReader(ref_export.address, edge=1)
        export = None
    else:
        _up, export = _port_upstream()
        sub1, _v, feeds1, _e = _jax_spanning().subgraph(
            [2, 3], feed_batch_size=8)
        down = JaxRunner(sub1, **KW)
        reader = jsch.RemoteEdgeFeedReader(export.address, edge=1)
    try:
        down.executor.register_feed(feeds1[1], reader)
        got = _epochs(down, 4)
        jsub, _v, jfeeds, _e = _jax_spanning().subgraph(
            [2, 3], feed_batch_size=8)
        ctrl = JaxRunner(jsub, **KW)
        ctrl.executor.register_feed(
            jfeeds[1], jsch.RemoteEdgeFeedReader(ref_export.address,
                                                 edge=1))
        assert got == _epochs(ctrl, 4)
    finally:
        reader.close()
        if export is not None:
            export.close()


# --- the DEPLOY header -------------------------------------------------------


class _StubJM:
    """JobMasterServer stand-in: two slot workers, every deploy RUNNING."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ignored = [3, 1]

    def slots(self):
        return {"a": 2, "b": 2}

    def info(self, wid):
        return {"slots": 2, "deploy_host": "127.0.0.1", "deploy_port": 1}

    def expired(self):
        return []


class _StubMirror:
    def __init__(self, address, flats, **_kw):
        self.flats = list(flats)

    def rows_with_start(self, flat):
        return np.full((flat + 1, 8), flat, np.int32), 4 * flat

    def close(self):
        pass


def _record_deploys(mod, rmod, job_spec, tmp_path, monkeypatch, **kw):
    monkeypatch.setattr(rmod, "RemoteReplicaMirror", _StubMirror)
    el_cls = (FileLeaderElection if mod is sch else JaxElection)
    election = el_cls(str(tmp_path / f"{mod.__name__}.lease"), "jm-0")
    assert election.try_acquire()
    s = mod.SlotPoolScheduler(_StubJM(), election, job_spec,
                              runner_kw=dict(KW), feed_batch=4,
                              target_epochs=8, complete_every=2,
                              checkpoint_root="/ck", **kw)
    sent = []

    def send(worker, tdd, frame=b""):
        sent.append((worker, tdd, frame))
        return {"accepted": True}

    def wait(worker, group, attempt):
        return {"state": "RUNNING", "attempt": attempt,
                "export_ports": {"1": 7000 + group}, "log_port": 1,
                "num_subtasks": 2}
    s._send_deploy = send
    s._wait_running = wait
    s.deploy(external_feeds={0: {"kind": "socket", "host": "h",
                                 "port": 9, "num_subtasks": 1}})
    s.recover_worker("b")
    return s, sent


@pytest.mark.parametrize("job_id", ["", "red-001"])
def test_deploy_headers_equal_reference(tmp_path, monkeypatch, job_id):
    """``_descriptor`` / ``_place`` headers (first deploys and the
    recovery redeploy) equal the reference's key for key but the job
    spec; the recovery frames (mirror rows) are byte-identical."""
    kw = {"job_id": job_id, "tenant": "red"} if job_id else {}
    ps, psent = _record_deploys(sch, remote, SPEC, tmp_path, monkeypatch,
                                device="cpu", **kw)
    rs, rsent = _record_deploys(jsch, jremote, JAX_SPEC, tmp_path,
                                monkeypatch, **kw)
    assert len(psent) == len(rsent) == 3
    for (pw, ptdd, pframe), (rw, rtdd, rframe) in zip(psent, rsent):
        assert pw == rw
        assert ptdd["job"] == SPEC and rtdd["job"] == JAX_SPEC
        assert {k: v for k, v in ptdd.items() if k != "job"} == \
            {k: v for k, v in rtdd.items() if k != "job"}
        assert pframe == rframe
    assert psent[-1][1]["recover"] and psent[-1][1]["ignored"] == [1, 3]
    assert ps.placements == rs.placements == {0: "a", 1: "a"}
    assert ps.standby == rs.standby == {0: "b", 1: "a"}
    assert ps.pool.placements() == rs.pool.placements()


# --- THE spanned job: 2 worker processes, SIGKILL, fenced recovery ----------


def _line_server(lines):
    """Minimal TCP line feed: accepts clients, sends every line at once,
    keeps the connection open."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    conns = []

    def serve():
        try:
            while True:
                conn, _ = srv.accept()
                conns.append(conn)
                conn.sendall("".join(f"{k}:{v}\n"
                                     for k, v in lines).encode())
        except OSError:
            return

    threading.Thread(target=serve, daemon=True).start()
    return srv, srv.getsockname()[1], conns


def _mirror_covers(mirror, ckdir, step, spe):
    """A rebuild from ``mirror`` and the checkpoints in ``ckdir`` lands
    on global step ``step`` only when the mirror's rows run from the
    newest completed checkpoint's fence (its log head) to ``step``."""
    from clonos_tpu_torch.causal import determinant as det
    from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    storage = FileCheckpointStorage(ckdir)
    done = storage.completed_ids()
    if not done:
        return False
    heads = np.asarray(storage.read(max(done)).carry.log_heads)
    rows, start = mirror.rows_with_start(0)
    fence = (max(done) + 1) * spe
    return (start == int(heads[0]) and fence + len(
        det.sync_anchors(np.asarray(rows, np.int32))) == step)


def _reader(stream, out):
    for line in iter(stream.readline, ""):
        out.put(line)
    out.put(None)


def _read_status(lines, want, deadline_s=90.0):
    """Read a worker's JSON lines until ``want(st)``; returns (matching
    record, digests of every group record seen by global step)."""
    seen = {}
    deadline = time.monotonic() + deadline_s
    while True:
        left = deadline - time.monotonic()
        assert left > 0, "worker status timeout"
        line = lines.get(timeout=left)
        assert line is not None, "worker stdout closed before the status"
        st = json.loads(line)
        if "group" in st and "digest" in st:
            seen[st["global_step"]] = st["digest"]
        if want(st):
            return st, seen


def test_job_spans_two_workers_with_fenced_per_task_recovery(tmp_path):
    """Vertices of ONE job deployed across 2 slot-worker OS processes on
    the CPU (neither holds the full graph); the downstream worker is
    SIGKILLed; the JobMaster redeploys only ITS vertices onto the
    survivor with causal replay; the rebuilt digests equal the dead
    worker's reported fences and a no-failure control over the same
    exported stream; a deposed fencing token's DEPLOY is rejected; every
    worker registers its device."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    lease = str(tmp_path / "jm.lease")
    lines = [((i * 37) % 997, 1 + i % 5) for i in range(600)]
    srv, lport, _conns = _line_server(lines)

    jm = JobMasterServer(heartbeat_timeout_s=2.0)
    election = FileLeaderElection(lease, "jm-0", lease_ttl_s=30.0)
    assert election.try_acquire()
    runner_kw = dict(steps_per_epoch=4, log_capacity=512, max_epochs=64,
                     inflight_ring_steps=64, seed=7, logical_time=True)
    # feed_batch 4 < the source batch 8: the downstream slice demands
    # records at half the rate the upstream produces them, so the
    # blocking reader never starves at the end of the stream.
    scheduler = sch.SlotPoolScheduler(
        jm, election, SPEC, runner_kw=runner_kw, feed_batch=4,
        target_epochs=8, complete_every=2,
        checkpoint_root=str(tmp_path / "ck"), deploy_timeout_s=90.0,
        device="cpu")

    def spawn(eid):
        proc = subprocess.Popen(
            [sys.executable, "-m", "clonos_tpu_torch", "slotworker",
             "--jm", f"127.0.0.1:{jm.address[1]}",
             "--executor-id", eid, "--slots", "2", "--lease", lease,
             "--heartbeat-interval", "0.3", "--max-seconds", "110",
             "--epoch-sleep", "0.25", "--device", "cpu"],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        q: "queue.Queue" = queue.Queue()
        threading.Thread(target=_reader, args=(proc.stdout, q),
                         daemon=True).start()
        return proc, q

    (pa, qa), (pb, qb) = spawn("a"), spawn("b")
    try:
        ra, _ = _read_status(qa, lambda st: "registered" in st)
        rb, _ = _read_status(qb, lambda st: "registered" in st)
        assert (ra["registered"], rb["registered"]) == ("a", "b")
        deadline = time.monotonic() + 30
        while {"a", "b"} - set(jm.registered()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert jm.info("a")["device"] == jm.info("b")["device"] == "cpu"

        placements = scheduler.deploy(external_feeds={
            0: {"kind": "socket", "host": "127.0.0.1", "port": lport,
                "num_subtasks": 1}})
        assert placements == {0: "a", 1: "b"}
        assert scheduler.standby == {0: "b", 1: "a"}

        da, _ = _read_status(qa, lambda st: st.get("deployed") == 0)
        db, _ = _read_status(qb, lambda st: st.get("deployed") == 1)
        assert da["vertices"] == [0, 1] and db["vertices"] == [2, 3]
        assert not da["recovered"] and not db["recovered"]

        fin_a, _ = _read_status(qa, lambda st: st.get("finished") == 0)

        def at_fence(st):
            if "group" in st and "digest" in st:
                scheduler.sync()
            return st.get("epoch", -1) >= 5 or "finished" in st

        # Kill b only where its rebuild reproduces a reported fence: sync
        # the mirror (b's endpoint refreshes just after its status line),
        # stop b, read what it printed, and kill it if the mirror runs
        # from the newest completed checkpoint to b's last reported step;
        # else resume it and try at its next line. (The reference test
        # kills on sight.)
        digests_b = {}
        while True:
            last, seen = _read_status(qb, at_fence)
            digests_b.update(seen)
            assert "finished" not in last
            assert last["blocked_ms"] >= 0.0
            time.sleep(0.05)
            scheduler.sync()
            pb.send_signal(signal.SIGSTOP)
            time.sleep(0.2)
            while not qb.empty():
                st = json.loads(qb.get_nowait())
                if "group" in st and "digest" in st:
                    digests_b[st["global_step"]] = st["digest"]
            if _mirror_covers(scheduler.mirrors[1],
                              str(tmp_path / "ck" / "g1"),
                              max(digests_b), runner_kw["steps_per_epoch"]):
                break
            pb.send_signal(signal.SIGCONT)
        kill_step = max(digests_b)
        pb.send_signal(signal.SIGKILL)
        pb.wait(timeout=15)
        while True:                       # nothing printed after the stop
            line = qb.get(timeout=15)
            if line is None:
                break
            st = json.loads(line)
            assert not ("group" in st and "digest" in st), st

        deadline = time.monotonic() + 20
        while "b" not in scheduler.failed_workers():
            assert time.monotonic() < deadline, "heartbeat expiry not seen"
            time.sleep(0.1)

        with pytest.raises(RuntimeError,
                           match="stale fencing|lease claim"):
            scheduler._send_deploy(
                "a", {"group": 1, "fencing_epoch": election.epoch - 1})

        moved = scheduler.recover_worker("b")
        assert moved == {1: "a"}
        assert scheduler.placements == {0: "a", 1: "a"}

        dep, _ = _read_status(qa, lambda st: st.get("deployed") == 1)
        assert dep["recovered"] and dep["vertices"] == [2, 3]
        assert dep["global_step"] == kill_step > 0
        assert dep["global_step"] in digests_b, \
            "recovery fence was never reported by the dead worker"
        assert dep["digest"] == digests_b[dep["global_step"]]

        fin, digests_a = _read_status(qa, lambda st:
                                      st.get("finished") == 1)
        assert fin["global_step"] == 8 * runner_kw["steps_per_epoch"]

        hdr, resp = _fetch_all(scheduler._export_addr[1])
        assert hdr["final"], "upstream export should be finished"
        hlen = int.from_bytes(resp[:4], "little")
        recs = np.frombuffer(resp[4 + hlen:], np.int32).reshape(-1, 2)
        # The upstream exported at least the downstream's whole demand.
        assert fin_a["global_step"] == 8 * runner_kw["steps_per_epoch"]
        assert recs.shape[0] >= 8 * runner_kw["steps_per_epoch"] * 4

        sub1, _v, feeds1, _e = tsp.build_job().subgraph(
            [2, 3], feed_batch_size=4)
        ctrl = ClusterRunner(sub1, device="cpu", **runner_kw)
        ctrl.executor.register_feed(feeds1[1],
                                    ListFeedReader([recs.tolist()]))
        ctrl_digests = _epochs(ctrl, 8)
        assert dep["digest"] == ctrl_digests[dep["global_step"]]
        for step, d in digests_b.items():
            assert d == ctrl_digests[step], \
                f"dead worker's fence {step} diverges from no-failure run"
        for step, d in digests_a.items():
            assert d == ctrl_digests[step], \
                f"rebuilt fence {step} diverges from no-failure run"
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=15)
        scheduler.close()
        jm.close()
        srv.close()
