"""PyTorch port, the cross-host control plane (mirror of the reference's
``tests/test_remote.py``): the JobMaster's RPCs, the heartbeat monitor's
gray-failure views, the remote mirror's rebase, release and undersize
checks, the in-flight wire request, wire checks across the two packages
(a port mirror pulling from a reference endpoint and the other way
round), ``state_digest`` against the reference's on the wordcount job,
and the two-process host-loss rebuild through ``python -m
clonos_tpu_torch worker``. Tolerance: exact."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.causal import serde as jserde
from clonos_tpu.parallel import transport as jtp
from clonos_tpu.runtime import remote as jremote
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.cluster import HeartbeatMonitor as JaxMonitor
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import serde
from clonos_tpu_torch.causal.recovery import RecoveryError
from clonos_tpu_torch.examples import wordcount as twc
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.runtime import remote
from clonos_tpu_torch.runtime.cluster import ClusterRunner, HeartbeatMonitor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8, seed=3,
          logical_time=True)


def _small_job(env_cls, name="remote-job", edge=None):
    kw = {} if edge is None else {"default_edge_capacity": edge}
    env = env_cls(name=name, num_key_groups=8, **kw)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30).sink())
    return env.build()


def _poll(cond, deadline_s, what):
    """Wait for ``cond()`` until a deadline (no sleep orders events)."""
    end = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < end, what
        time.sleep(0.05)


# --- JobMaster RPCs ----------------------------------------------------------


@pytest.mark.parametrize("client", ["port", "reference"])
def test_jobmaster_register_heartbeat_ignore_and_expiry(client):
    """Registration, heartbeats, the ignore-checkpoint RPC and expiry; the
    reference's executor client speaks to the port's JobMaster."""
    jm = remote.JobMasterServer(heartbeat_timeout_s=3.0)
    mod = remote if client == "port" else jremote
    tx = mod.TaskExecutorClient("w0", jm.address, interval_s=0.1,
                                info={"slots": 2, "log_port": 1},
                                payload_fn=lambda: {"metrics": {
                                    "overhead.ft-fraction": 0.25}})
    raw = tp.ControlClient(jm.address)
    try:
        assert jm.registered() == ["w0"]
        assert jm.info("w0")["log_port"] == 1 and jm.slots() == {"w0": 2}
        _poll(lambda: "worker.w0.overhead.ft-fraction"
              in jm.cluster_metrics(), 12.0, "no heartbeat metrics")
        m = jm.cluster_metrics()
        assert m["cluster.overhead.ft-fraction-max"] == 0.25
        assert m["worker.w0.slots"] == 2
        raw.call_json(tp.IGNORE_CHECKPOINT, {"checkpoint_id": 4})
        raw.call_json(tp.IGNORE_CHECKPOINT, {"checkpoint_id": 2})
        raw.call_json(tp.IGNORE_CHECKPOINT, {"checkpoint_id": 4})
        ctl = remote.JobMasterController(jm, device="cpu")
        assert ctl.ignored_checkpoints() == [2, 4]
        assert raw.call_json(tp.SLOT_OFFER, {"executor_id": "w0",
                                             "slots": 1}) == {"slots": 3}
        raw.call_json(tp.TASK_STATE, {"executor_id": "w0", "group": 1,
                                      "state": "RUNNING"})
        assert jm.task_state("w0", 1)["state"] == "RUNNING"
        with pytest.raises(RuntimeError, match="bad mtype"):
            raw.call_json(tp.QUERY_STATE, {})
        assert jm.expired() == []
        # A registrant that never beats expires after the deadline.
        raw.call_json(tp.REGISTER, {"executor_id": "silent"})
        _poll(lambda: "silent" in jm.expired(), 12.0, "no expiry")
        assert "w0" not in jm.expired()
    finally:
        tx.close()
        raw.close()
        jm.close()


def test_cluster_metrics_rollups_equal_reference():
    """The JobMaster's cluster view over the same piggybacked snapshots
    (audit, overhead and per-job rollups) equals the reference's."""
    snaps = {
        "a": {"audit.epochs-sealed": 3, "audit.epochs-validated": 2,
              "audit.divergences": 0, "overhead.ft-fraction": 0.1,
              "job.j1.group.0.audit.epochs-sealed": 2,
              "job.j1.group.1.audit.divergences": 1},
        "b": {"audit.epochs-sealed": 1, "audit.divergences": 1,
              "overhead.ft-fraction": 0.3, "job.j2.group.0.x": 5}}
    views = []
    for mod in (remote, jremote):
        jm = mod.JobMasterServer()
        try:
            jm._hb_metrics = {k: dict(v) for k, v in snaps.items()}
            jm._slots = {"a": 2, "b": 0}
            views.append(jm.cluster_metrics())
        finally:
            jm.close()
    assert views[0] == views[1]


def test_heartbeat_monitor_degraded_and_ages_equal_reference():
    """Gray-failure views under one injected clock, step for step."""
    now = [0.0]
    mons = [cls([0, 1, 2], timeout_s=2.0, clock=lambda: now[0])
            for cls in (HeartbeatMonitor, JaxMonitor)]
    script = [(0.5, "beat_all", ()), (0.6, "beat", (0,)),
              (0.7, "lag", (1, 0.4)), (1.0, "beat_all", ()),
              (1.9, "beat", (2,)), (2.5, "dead", (0,)),
              (3.5, "revive", (0,)), (4.0, "beat_all", ()),
              (5.5, "beat", (1,))]
    for t, op, args in script:
        now[0] = t
        for m in mons:
            if op == "beat_all":
                m.beat_all_except(set())
            elif op == "beat":
                m.beat(*args)
            elif op == "lag":
                m.lag[args[0]] = args[1]
            elif op == "dead":
                m.mark_dead(*args)
            else:
                m.revive(*args)
        for grace in (0.0, 0.3):
            assert mons[0].degraded(grace) == mons[1].degraded(grace)
        assert mons[0].ages_ms() == mons[1].ages_ms()
        assert mons[0].expired() == mons[1].expired()
    assert mons[0].degraded() == [0, 2]     # behind 1's late beat, alive
    assert HeartbeatMonitor([], clock=lambda: 0.0).ages_ms() == {}


# --- mirror rebase, release and undersize ------------------------------------


class _FakeEndpoint:
    """Serves scripted (floor, start, rows) deltas of log 1."""

    def __init__(self):
        self.script = []
        self.server = tp.ControlServer(self._handle)
        self.address = self.server.address

    def _handle(self, mtype, payload):
        floor, start, rows = self.script.pop(0)
        hdr = tp.pack_json({"floors": {"1": floor}})
        return tp.DETERMINANT_RESPONSE, (
            len(hdr).to_bytes(4, "little") + hdr
            + serde.encode_delta([(1, start, rows)]))


def test_mirror_rebases_across_owner_truncation():
    ep = _FakeEndpoint()
    rows1 = np.arange(24, dtype=np.int32).reshape(3, 8)
    rows2 = np.arange(16, dtype=np.int32).reshape(2, 8) + 100
    ep.script = [(0, 0, rows1), (10, 10, rows2)]   # owner truncated [3, 10)
    m = remote.RemoteReplicaMirror(ep.address, flats=[1], capacity=64,
                                   max_epochs=8, device="cpu")
    try:
        assert m.sync() == 3 and m.head(1) == 3
        assert m.sync() == 2                 # gap -> rebase to 10, absorb
        assert m.head(1) == 12
        np.testing.assert_array_equal(m.rows(1), rows2)
        log = m._replicas[1]
        for t in (log.state.head, log.state.tail):
            assert t.dtype == torch.int32 and t.device == log.device
        assert m.rows_with_start(1)[1] == 10
        assert m.last_rows == 2 and m.last_frame_bytes > 2 * 32
    finally:
        ep.server.close()
        m.close()


def test_mirror_releases_history_at_floor_and_fails_loud_when_undersized():
    ep = _FakeEndpoint()
    mk = lambda n, off: (np.arange(n * 8, dtype=np.int32).reshape(n, 8)
                         + off)
    ep.script = [(0, 0, mk(6, 0)), (6, 6, mk(6, 100))]
    m = remote.RemoteReplicaMirror(ep.address, flats=[1], capacity=8,
                                   max_epochs=8, device="cpu")
    try:
        assert m.sync() == 6 and m.sync() == 6
        assert m.head(1) == 12
        np.testing.assert_array_equal(m.rows(1), mk(6, 100))
        # The floor stays at 6 and 6 more rows arrive: 12 live > 8.
        ep.script = [(6, 12, mk(6, 200))]
        with pytest.raises(RuntimeError, match="exceed capacity"):
            m.sync()
        # A single delta larger than the mirror is refused before merge.
        ep.script = [(20, 20, mk(9, 0))]
        with pytest.raises(RuntimeError, match="exceeds mirror capacity"):
            m.sync()
        # A floor past the merged head rebases to an empty window there.
        ep.script = [(40, 40, mk(0, 0))]
        m2 = remote.RemoteReplicaMirror(ep.address, flats=[1], capacity=8,
                                        max_epochs=8, device="cpu")
        assert m2.sync() == 0 and (m2.head(1), len(m2.rows(1))) == (40, 0)
        m2.close()
    finally:
        ep.server.close()
        m.close()


# --- the in-flight wire request ----------------------------------------------


def test_inflight_log_wire_request_equals_ring_and_reference():
    """A remote peer pulls a window of an upstream's in-flight ring and
    gets the ring's steps; the port's response bytes equal the reference
    endpoint's for the same job, seed and steps."""
    runs = {}
    for name, env_cls, runner_cls, kw in (
            ("port", StreamEnvironment, ClusterRunner, {"device": "cpu"}),
            ("reference", JaxEnv, JaxRunner, {})):
        r = runner_cls(_small_job(env_cls, "ifl-wire", edge=32),
                       inflight_ring_steps=16, **dict(KW, steps_per_epoch=6),
                       **kw)
        r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=False)
        runs[name] = r
    ep = remote.HostLogEndpoint(runs["port"].executor)
    jep = jremote.HostLogEndpoint(runs["reference"].executor)
    ep.refresh_inflight(max_steps=8)
    jep.refresh_inflight(max_steps=8)
    try:
        m = remote.RemoteReplicaMirror(ep.address, flats=[0], capacity=256,
                                       max_epochs=8, device="cpu")
        start, fields = m.fetch_inflight(ring=0, start=0, count=64)
        assert fields is not None
        el = runs["port"].executor.carry.out_rings[0]
        n = fields["keys"].shape[0]
        want, _, _ = ifl.slice_steps(el, start, n)
        np.testing.assert_array_equal(fields["keys"], want.keys.numpy())
        np.testing.assert_array_equal(fields["valid"], want.valid.numpy())
        floor, none = m.fetch_inflight(ring=0, start=-100, count=2)
        assert none is None and floor >= 0
        with pytest.raises(RuntimeError, match="no in-flight snapshot"):
            m.fetch_inflight(ring=7, start=0, count=1)
        m.close()
        for req in ({"ring": 0, "start": 0, "count": 64},
                    {"ring": 1, "start": 5, "count": 3},
                    {"ring": 0, "start": -100, "count": 2}):
            body = tp.pack_json(req)
            assert ep._handle(tp.INFLIGHT_REQUEST, body) \
                == jep._handle(jtp.INFLIGHT_REQUEST, body)
    finally:
        ep.close()
        jep.close()


# --- wire checks across the two packages -------------------------------------


def _both_runners():
    port = ClusterRunner(_small_job(StreamEnvironment), device="cpu", **KW)
    ref = JaxRunner(_small_job(JaxEnv), **KW)
    return port, ref


def test_mirrors_pull_equal_rows_across_packages():
    """A port mirror pulling from a reference endpoint gets the rows a
    reference mirror gets, and the other way round, across epochs and a
    truncating checkpoint; the endpoints' response bytes are equal."""
    port, ref = _both_runners()
    for r in (port, ref):
        r.run_epoch(complete_checkpoint=False)
    eps = {"port": remote.HostLogEndpoint(port.executor),
           "reference": jremote.HostLogEndpoint(ref.executor)}
    flats = list(range(port.job.total_subtasks()))
    mirrors = {}
    for src, ep in eps.items():
        mirrors[(src, "port")] = remote.RemoteReplicaMirror(
            ep.address, flats, capacity=256, max_epochs=8, device="cpu")
        mirrors[(src, "reference")] = jremote.RemoteReplicaMirror(
            ep.address, flats, capacity=256, max_epochs=8)
    try:
        for complete in (None, False, True, False):
            if complete is not None:
                for r in (port, ref):
                    r.run_epoch(complete_checkpoint=complete)
                for ep in eps.values():
                    ep.refresh()
            absorbed = {k: m.sync() for k, m in mirrors.items()}
            assert len(set(absorbed.values())) == 1, absorbed
            for f in flats:
                want = mirrors[("reference", "reference")]
                for k, m in mirrors.items():
                    assert m.head(f) == want.head(f), (k, f)
                    rows, start = m.rows_with_start(f)
                    wrows, wstart = want.rows_with_start(f)
                    assert start == wstart, (k, f)
                    np.testing.assert_array_equal(rows, wrows)
            for enc in ("flat", "grouped"):
                req = tp.pack_json({"flats": flats, "encoding": enc,
                                    "known_heads": {"1": 2, "3": -1}})
                assert eps["port"]._handle(tp.DETERMINANT_REQUEST, req) \
                    == eps["reference"]._handle(jtp.DETERMINANT_REQUEST,
                                                req)
        assert mirrors[("port", "port")].rows(1).shape[0] > 0
        # The frame the port serves decodes with the reference's codec.
        _, resp = eps["port"]._handle(tp.DETERMINANT_REQUEST, tp.pack_json(
            {"flats": flats, "known_heads": {}}))
        hlen = int.from_bytes(resp[:4], "little")
        got = jserde.decode_delta(resp[4 + hlen:])
        assert [d[0] for d in got] == flats
    finally:
        for m in mirrors.values():
            m.close()
        for ep in eps.values():
            ep.close()


def test_state_digest_equals_reference_on_wordcount():
    """The wordcount job at its published widths (4 x 64 records a step,
    1,000 keys, 64 key groups): the port's digest equals the reference's
    after the same epochs, seed and logical time, and moves with the
    state."""
    import examples.wordcount as jwc
    kw = dict(steps_per_epoch=8, seed=5, logical_time=True)
    port = ClusterRunner(twc.build_job(), device="cpu", **kw)
    ref = JaxRunner(jwc.build_job(), **kw)
    seen = set()
    for complete in (True, False, True):
        for r in (port, ref):
            r.run_epoch(complete_checkpoint=complete)
        d = port.state_digest()
        assert d == ref.state_digest()
        seen.add(d)
    for r in (port, ref):
        for _ in range(3):
            r.step()
    assert port.state_digest() == ref.state_digest()
    assert len(seen) == 3
    for vid in range(len(port.job.vertices)):
        a, b = port.executor.vertex_state(vid), ref.executor.vertex_state(vid)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


# --- the two-process host-loss rebuild ----------------------------------------

#: sized as the worker CLI's defaults hold it: 16-step epochs, every third
#: checkpoint completed (at most 48 un-truncated steps in the 64-step ring
#: and the 1<<14-row logs), killed after 27 epochs — 9 completed
#: checkpoints, 20 epochs after the third
SPE = 16
COMPLETE_EVERY = 3
KILL_AT = 26


def _reader(stream, q):
    for line in iter(stream.readline, ""):
        q.put(line)
    q.put(None)


def test_host_loss_rebuild_from_mirror_and_checkpoint(tmp_path):
    """A worker process (``python -m clonos_tpu_torch worker``) runs the
    wordcount job under this process's JobMaster; this process mirrors
    its logs; the worker is SIGKILLed; heartbeat expiry flags it; the
    controller rebuilds the whole job here from checkpoint and mirror,
    with the digest the dead worker reported at that global step; the
    rebuilt job runs on and survives an ordinary task kill.

    The kill is ordered by the status lines: line ``i`` is printed after
    the refresh of fence ``i - 1``, so a sync after reading it holds a
    fence at or past run ``i - 1``. The kill follows line ``i`` with
    ``i % 3 == 2`` and no later line printed: the mirror then holds a
    fence past the last completed checkpoint (run ``i - 2``), and the
    next one (run ``i + 1``) is an epoch and a sleep away."""
    jm = remote.JobMasterServer(heartbeat_timeout_s=3.0)
    ctl = remote.JobMasterController(jm, device="cpu")
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "clonos_tpu_torch", "worker",
         "clonos_tpu_torch.examples.wordcount:build_job",
         "--jm", f"127.0.0.1:{jm.address[1]}", "--checkpoint-dir", ckdir,
         "--executor-id", "worker-0", "--epochs", "64",
         "--steps-per-epoch", str(SPE),
         "--complete-every", str(COMPLETE_EVERY), "--seed", "5",
         "--heartbeat-interval", "0.2", "--epoch-sleep", "0.5",
         "--device", "cpu"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_reader, args=(proc.stdout, lines),
                     daemon=True).start()

    def next_line():
        line = lines.get(timeout=120)
        assert line is not None, "worker exited early"
        return json.loads(line)

    digests = {}
    try:
        assert next_line()["registered"] == "worker-0"
        assert ctl.attach() == ["worker-0"]
        info = jm.info("worker-0")
        assert (info["device"], info["codec"]) == ("cpu", "native")
        i = 0
        while True:
            st = next_line()
            digests[st["global_step"]] = st["digest"]
            assert ctl.sync()["worker-0"] >= 0
            if i >= KILL_AT and i % COMPLETE_EVERY == 2 and lines.empty():
                break
            i += 1
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        # Lines the worker printed before it died: the mirror may hold
        # the fence after the last line read before the kill.
        while (line := lines.get(timeout=30)) is not None:
            st = json.loads(line)
            digests[st["global_step"]] = st["digest"]
        _poll(lambda: "worker-0" in ctl.failed(), 4 * 3.0 + 6.0,
              "missed heartbeats not seen")

        runner, report = ctl.rebuild("worker-0", twc.build_job(),
                                     steps_per_epoch=SPE, seed=5)
        assert runner.device.type == "cpu"
        assert runner.global_step in digests
        assert runner.global_step >= KILL_AT * SPE
        assert report.steps_replayed >= SPE
        assert runner.state_digest() == digests[runner.global_step], (
            "rebuilt state diverges from the dead worker's digest")
        assert report.steps_replayed == runner.global_step - \
            runner._fence_step[report.from_epoch]
        assert report.determinants_replayed > 0
        # The rebuilt job is live: it runs on, checkpoints, and survives
        # ordinary task kills — across a pending checkpoint, and mid-epoch
        # after a completed one, where the recovered state is the killed
        # one to the byte.
        runner.run_epoch(complete_checkpoint=True)
        runner.run_epoch(complete_checkpoint=False)
        runner.inject_failure([5])           # window subtask 1
        runner.recover()
        runner.run_epoch(complete_checkpoint=True)
        for _ in range(5):
            runner.step()
        before = runner.state_digest()
        runner.inject_failure([5])
        assert runner.recover().steps_replayed == 5
        assert runner.state_digest() == before
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        ctl.close()
        jm.close()


# --- the standby's restore choice -------------------------------------------


def _stale_mirror_run(tmp_path, sync_first_at, build=twc.build_job,
                      sink_root=None, **kw):
    """The wordcount job with 8-step epochs, seed 5, checkpoints completed
    at ``i % 3 == 0``, and its endpoint and mirror in this process. After
    each run the endpoint refreshes and the mirror syncs, except after run
    ``sync_first_at``, where the mirror syncs first (the watcher's sync
    racing the worker's refresh). ``build`` swaps the job, ``sink_root``
    backs its transactional sink with part files and ``kw`` extends the
    runner's options. Returns the dead runner's digests by global step and
    the mirror's rows."""
    ck = str(tmp_path / "ck")
    job = build()
    runner = ClusterRunner(job, steps_per_epoch=8, checkpoint_dir=ck,
                           seed=5, device="cpu", **kw)
    if sink_root is not None:
        runner.attach_file_sink(_sink_vertex(job), sink_root)
    ep = remote.HostLogEndpoint(runner.executor)
    L = job.total_subtasks()
    m = remote.RemoteReplicaMirror(ep.address, list(range(L)),
                                   device="cpu")
    digests = {}
    try:
        for i in range(7):
            runner.run_epoch(complete_checkpoint=(i % 3 == 0))
            digests[runner.global_step] = runner.state_digest()
            if i == sync_first_at:
                m.sync()
                ep.refresh()
            else:
                ep.refresh()
                m.sync()
        rows = {f: m.rows_with_start(f) for f in range(L)}
    finally:
        m.close()
        ep.close()
        runner.coordinator.storage._close_ledger()
    return ck, digests, rows


def test_bootstrap_restores_the_checkpoint_the_mirror_starts_at(tmp_path):
    """The mirror synced after run 6 but before its refresh still starts
    at checkpoint 3's log heads (fence 32) while checkpoint 6 (fence 56)
    is the newest completed one. The reference restores checkpoint 6 and
    replays the 16 mirrored steps onto it (global step 72, a state no run
    reported). The port restores checkpoint 3 and lands on step 48 with
    the dead runner's digest there."""
    ck, digests, rows = _stale_mirror_run(tmp_path, sync_first_at=6)
    assert sorted(digests)[-1] == 56
    rebuilt, report = ClusterRunner.bootstrap_standby(
        twc.build_job(), ck, rows, steps_per_epoch=8, seed=5,
        device="cpu")
    assert report.from_epoch == 4 and report.steps_replayed == 16
    assert rebuilt.global_step == 48
    assert rebuilt.state_digest() == digests[48]
    rebuilt.coordinator.storage._close_ledger()


def test_bootstrap_refresh_then_sync_restores_the_newest(tmp_path):
    """The other order: the mirror holds run 6's fence and starts at
    checkpoint 6's heads, so the newest checkpoint is restored and the
    rebuild lands on step 56 with the dead runner's digest."""
    ck, digests, rows = _stale_mirror_run(tmp_path, sync_first_at=None)
    rebuilt, report = ClusterRunner.bootstrap_standby(
        twc.build_job(), ck, rows, steps_per_epoch=8, seed=5,
        device="cpu")
    assert report.from_epoch == 7
    assert rebuilt.global_step == 56
    assert rebuilt.state_digest() == digests[56]
    rebuilt.coordinator.storage._close_ledger()


def test_bootstrap_raises_when_no_checkpoint_matches_the_mirror(tmp_path):
    """A mirror that starts at no retained checkpoint's log heads is
    refused, naming the starts and each candidate's heads: with
    checkpoint 3 ignored only checkpoint 6 remains, and the stale mirror
    starts at checkpoint 3's heads."""
    ck, _digests, rows = _stale_mirror_run(tmp_path, sync_first_at=6)
    with pytest.raises(RecoveryError,
                       match="no completed checkpoint's log heads") as ei:
        ClusterRunner.bootstrap_standby(
            twc.build_job(), ck, rows, ignored_checkpoints=[3],
            steps_per_epoch=8, seed=5, device="cpu")
    assert "mirror starts" in str(ei.value) and "6: [" in str(ei.value)


def test_host_loss_rebuild_kill_on_sight(tmp_path):
    """The reference test's own schedule against the port's worker: sync
    after every status line and SIGKILL as soon as the epoch-7 line is
    read, with no wait for a covering mirror. Whichever side of the
    worker's refresh the last sync lands on, the rebuild restores the
    checkpoint the mirror starts at and reproduces a digest the worker
    reported."""
    jm = remote.JobMasterServer(heartbeat_timeout_s=1.5)
    ctl = remote.JobMasterController(jm, device="cpu")
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "clonos_tpu_torch", "worker",
         "clonos_tpu_torch.examples.wordcount:build_job",
         "--jm", f"127.0.0.1:{jm.address[1]}", "--checkpoint-dir", ckdir,
         "--executor-id", "worker-0", "--epochs", "64",
         "--steps-per-epoch", "8", "--complete-every", "3", "--seed", "5",
         "--heartbeat-interval", "0.3", "--epoch-sleep", "0.05",
         "--device", "cpu"],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, text=True)
    digests = {}
    try:
        assert json.loads(proc.stdout.readline())["registered"] == \
            "worker-0"
        assert ctl.attach() == ["worker-0"]
        for line in iter(proc.stdout.readline, ""):
            st = json.loads(line)
            ctl.sync()
            digests[st["global_step"]] = st["digest"]
            if st["epoch"] >= 7:
                break
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        for line in proc.stdout:
            try:
                st = json.loads(line)
            except ValueError:
                break
            digests[st["global_step"]] = st["digest"]
        _poll(lambda: "worker-0" in ctl.failed(), 4 * 1.5 + 6.0,
              "missed heartbeats not seen")
        runner, report = ctl.rebuild("worker-0", twc.build_job(),
                                     steps_per_epoch=8, seed=5)
        assert runner.global_step in digests
        assert runner.state_digest() == digests[runner.global_step], (
            "rebuilt state diverges from the dead worker's digest")
        assert report.steps_replayed == runner.global_step - \
            runner._fence_step[report.from_epoch]
        runner.run_epoch(complete_checkpoint=True)
        runner.inject_failure([5])
        runner.recover()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        ctl.close()
        jm.close()


def _txn_wordcount():
    from clonos_tpu_torch.examples import wordcount as wc
    return wc.build_txn_job()


def _sink_vertex(job):
    (sink,) = [v.vertex_id for v in job.vertices
               if type(v.operator).__name__ == "TransactionalSinkOperator"]
    return sink


def _finals_per_part(root):
    """(epoch, subtask) -> how many ``.final`` part files hold it."""
    from clonos_tpu_torch.runtime.filesink import FileSystemSink
    n = {}
    for fn in os.listdir(root):
        if fn.endswith(".final"):
            key = FileSystemSink._parse(fn)[:2]
            n[key] = n.get(key, 0) + 1
    return n


def test_bootstrap_commits_the_replayed_sealed_epochs(tmp_path):
    """A transactional sink across a standby rebuild: the dead runner
    sealed epoch 7 (its pendings on disk) but its checkpoint never
    completed. The rebuild seals the replayed epoch again, the standby's
    file sink (a new token) persists its pendings, and the next completed
    checkpoint commits it: the committed part files hold every epoch, and
    their records equal a never-failed runner's."""
    from clonos_tpu_torch.runtime.filesink import FileSystemSink
    kw = dict(steps_per_epoch=16, seed=5, logical_time=True, device="cpu")
    job = _txn_wordcount()
    (sink,) = [v.vertex_id for v in job.vertices
               if type(v.operator).__name__ == "TransactionalSinkOperator"]
    dead = ClusterRunner(job, checkpoint_dir=str(tmp_path / "ck"), **kw)
    dead.attach_file_sink(sink, str(tmp_path / "sink"))
    ep = remote.HostLogEndpoint(dead.executor)
    L = job.total_subtasks()
    m = remote.RemoteReplicaMirror(ep.address, list(range(L)), device="cpu")
    try:
        for i in range(8):
            dead.run_epoch(complete_checkpoint=(i % 3 == 0))
            ep.refresh()
            m.sync()
        rows = {f: m.rows_with_start(f) for f in range(L)}
    finally:
        m.close()
        ep.close()
        dead.coordinator.storage._close_ledger()
    assert FileSystemSink(str(tmp_path / "sink")).committed_epochs() == \
        list(range(7))
    rebuilt, report = ClusterRunner.bootstrap_standby(
        _txn_wordcount(), str(tmp_path / "ck"), rows, **kw)
    assert (report.from_epoch, rebuilt.global_step) == (7, 128)
    rebuilt.attach_file_sink(sink, str(tmp_path / "sink"), token=1)
    for _ in range(3):
        rebuilt.run_epoch(complete_checkpoint=True)
    rebuilt.coordinator.storage._close_ledger()

    control = ClusterRunner(_txn_wordcount(),
                            checkpoint_dir=str(tmp_path / "ck2"), **kw)
    control.attach_file_sink(sink, str(tmp_path / "sink2"))
    for i in range(11):
        control.run_epoch(complete_checkpoint=(i % 3 == 0 or i >= 8))
    control.coordinator.storage._close_ledger()
    got = FileSystemSink(str(tmp_path / "sink"))
    want = FileSystemSink(str(tmp_path / "sink2"))
    assert got.committed_epochs() == want.committed_epochs() == \
        list(range(11))
    assert want.read_committed().shape[0] > 0
    assert np.array_equal(got.read_committed(), want.read_committed())


def test_bootstrap_from_an_older_checkpoint_commits_each_epoch_once(
        tmp_path):
    """The stale-mirror rebuild with a file-backed transactional sink. The
    dead runner completed checkpoint 6, which committed epochs 0-6; the
    standby restores checkpoint 3, replays epochs 4-5 and reruns epoch 6
    live. None of those commits again under the standby's token: every
    (epoch, subtask) part is final exactly once, and the committed records
    equal a never-failed runner's over the same epochs."""
    from clonos_tpu_torch.runtime.filesink import FileSystemSink
    kw = dict(logical_time=True)
    sink_root = str(tmp_path / "sink")
    ck, _digests, rows = _stale_mirror_run(
        tmp_path, sync_first_at=6, build=_txn_wordcount,
        sink_root=sink_root, **kw)
    job = _txn_wordcount()
    rebuilt, report = ClusterRunner.bootstrap_standby(
        job, ck, rows, steps_per_epoch=8, seed=5, device="cpu", **kw)
    assert (report.from_epoch, rebuilt.global_step) == (4, 48)
    rebuilt.attach_file_sink(_sink_vertex(job), sink_root, token=1)
    for _ in range(4):
        rebuilt.run_epoch(complete_checkpoint=True)
    rebuilt.coordinator.storage._close_ledger()

    control = ClusterRunner(_txn_wordcount(), steps_per_epoch=8, seed=5,
                            checkpoint_dir=str(tmp_path / "ck2"),
                            device="cpu", **kw)
    control.attach_file_sink(_sink_vertex(job), str(tmp_path / "sink2"))
    for i in range(10):
        control.run_epoch(complete_checkpoint=(i % 3 == 0 or i >= 6))
    control.coordinator.storage._close_ledger()
    finals = _finals_per_part(sink_root)
    assert finals == _finals_per_part(str(tmp_path / "sink2"))
    assert set(finals.values()) == {1}, (
        "an (epoch, subtask) part was committed twice")
    got = FileSystemSink(sink_root)
    want = FileSystemSink(str(tmp_path / "sink2"))
    assert got.committed_epochs() == list(range(10))
    assert want.read_committed().shape[0] > 0
    assert np.array_equal(got.read_committed(), want.read_committed())
