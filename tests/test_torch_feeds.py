"""PyTorch port, host feeds: ``ListFeedReader`` equals the reference's
reader call for call (``pull_block`` across parameters, ``read_at``,
retention, commits); a host-fed job commits its checkpointed offsets on
completion, fails loudly past expired offsets, and recovers a feed
source (alone, and cascading with a window and a reduce, config #4's
shape) equal to a golden port run and to the reference's faulted run; a
recovered timer re-fires exactly once. Tolerance: exact."""

import numpy as np
import jax
import pytest

from clonos_tpu.api import feeds as jf
from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api import feeds as tf
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves


def _mk(n=64, parts=2, seed=0):
    rng = np.random.RandomState(seed)
    return [[(int(k), int(v)) for k, v in
             zip(rng.randint(0, 100, n), rng.randint(0, 100, n))]
            for _ in range(parts)]


class _LoopReader(tf.FeedReader):
    """The base class's pull_block loop over pull."""

    def __init__(self, parts, rpp):
        self._inner = tf.ListFeedReader(parts, records_per_pull=rpp)

    def pull(self, subtask, max_n):
        return self._inner.pull(subtask, max_n)


@pytest.mark.parametrize("rpp,b,k", [(1 << 30, 8, 4), (3, 8, 4),
                                     (8, 8, 16), (5, 7, 9)])
def test_pull_block_equals_reference_and_pull_loop(rpp, b, k):
    parts = _mk(n=50)
    port = tf.ListFeedReader(parts, records_per_pull=rpp)
    ref = jf.ListFeedReader(parts, records_per_pull=rpp)
    loop = _LoopReader(parts, rpp)
    for _ in range(3):                       # across partition exhaustion
        for s in range(2):
            got = port.pull_block(s, b, k)
            for want in (ref.pull_block(s, b, k), loop.pull_block(s, b, k)):
                for x, y in zip(got, want):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)


def test_read_at_retention_and_commit_equal_reference():
    for cls in (tf, jf):
        r = cls.ListFeedReader(_mk(n=20))
        ks, vs = r.pull(0, 12)
        assert r.read_at(0, 3, 6) == (ks[3:9], vs[3:9])
        with pytest.raises(ValueError):
            r.read_at(0, 15, 10)
    port = tf.ListFeedReader(_mk(n=40), retention=8)
    ref = jf.ListFeedReader(_mk(n=40), retention=8)
    for r in (port, ref):
        r.pull(0, 30)
    assert port.read_at(0, 25, 5) == ref.read_at(0, 25, 5)
    with pytest.raises(tf.RetentionExpiredError):
        port.read_at(0, 10, 5)
    assert port.pull(0, 10) == ref.pull(0, 10)   # future records kept
    port = tf.ListFeedReader(_mk(n=40))
    port.pull(0, 10)
    port.pull(1, 4)
    port.notify_checkpoint_complete([8, 20])     # part 1 capped at 4
    with pytest.raises(tf.RetentionExpiredError):
        port.read_at(0, 7, 2)
    assert len(port.read_at(0, 8, 2)[0]) == 2
    assert len(port.read_at(1, 4, 3)[0]) == 3


def test_retained_partitions_bound_history():
    r = tf._RetainedPartitions(2, retention=4)
    r._parts[0].extend((i, i) for i in range(10))
    r._enforce_retention(0)
    assert r._base[0] == 6 and r._slice(0, 7, 2) == [(7, 7), (8, 8)]
    with pytest.raises(tf.RetentionExpiredError):
        r._slice(0, 5, 1)
    r._cursor[0] = 8
    r.commit([9, 0])                             # floor capped at cursor
    assert r._base == [8, 0]


P, B, SPE = 2, 4, 4


def _reduce_job(env_cls):
    env = env_cls(name="feeds", num_key_groups=8, default_edge_capacity=64)
    (env.host_source(batch_size=B, parallelism=P)
        .key_by().reduce(num_keys=13, parallelism=P).sink(parallelism=P))
    return env.build()


def test_runner_commits_offsets_on_checkpoint_complete():
    reader = tf.ListFeedReader(_mk(n=4 * SPE * B, parts=P, seed=3),
                               retention=1 << 20)
    runner = ClusterRunner(_reduce_job(StreamEnvironment),
                           steps_per_epoch=SPE, log_capacity=256,
                           max_epochs=8, inflight_ring_steps=16, seed=11,
                           device="cpu")
    runner.executor.register_feed(0, reader)
    runner.run_epoch(complete_checkpoint=True)
    assert reader._base == [SPE * B] * P
    runner.run_epoch(complete_checkpoint=False)
    runner.inject_failure([1])
    assert runner.recover().records_replayed > 0


def test_recovery_past_expired_offsets_fails_loudly():
    reader = tf.ListFeedReader(_mk(n=4 * SPE * B, parts=P, seed=4),
                               retention=2)
    runner = ClusterRunner(_reduce_job(StreamEnvironment),
                           steps_per_epoch=SPE, log_capacity=256,
                           max_epochs=8, inflight_ring_steps=16, seed=12,
                           device="cpu")
    runner.executor.register_feed(0, reader)
    runner.run_epoch(complete_checkpoint=True)
    runner.run_epoch(complete_checkpoint=False)
    runner.inject_failure([0])
    with pytest.raises(tf.RetentionExpiredError):
        runner.recover()


def _cascade_job(env_cls):
    """Config #4's shape at test scale: feed -> window -> reduce -> sink."""
    env = env_cls(name="c4-mini", num_key_groups=16,
                  default_edge_capacity=32)
    (env.host_source(batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=9, window_size=40, parallelism=2)
        .key_by().reduce(num_keys=9, parallelism=2)
        .sink(parallelism=2))
    return env.build()


def _parts():
    return [[(k % 9, k) for k in range(s, 400, 2)] for s in range(2)]


TIMES = list(range(0, 800, 10))


def _drive(r, reader_mod, pending=False):
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    reader = reader_mod.ListFeedReader(_parts(), records_per_pull=3)
    r.executor.register_feed(0, reader)
    r.run_epoch()
    if pending:
        r.run_epoch(complete_checkpoint=False)
    r.step()
    r.step()
    return r, reader


def _leaves(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _mirror_ignore(runner, failed):
    healthy = [f for f in range(runner.job.total_subtasks())
               if f not in failed]
    for cid in runner.coordinator.ignore_unacked_for(set(failed)):
        runner.executor.append_async_many(
            healthy, det.IgnoreCheckpointDeterminant(
                record_count=runner.executor.global_record_stamp(),
                checkpoint_id=cid))


@pytest.mark.parametrize("kill,pending", [([0], False), ([1], True),
                                          ([1, 3, 5], True)],
                         ids=["feed", "feed-pending", "cascade"])
def test_feed_job_recovers_like_golden_and_reference(kill, pending):
    kw = dict(steps_per_epoch=3, seed=5, inflight_ring_steps=16)
    golden, _ = _drive(ClusterRunner(_cascade_job(StreamEnvironment),
                                     device="cpu", **kw), tf, pending)
    port, reader = _drive(ClusterRunner(_cascade_job(StreamEnvironment),
                                        device="cpu", **kw), tf, pending)
    ref, _ = _drive(JaxRunner(_cascade_job(JaxEnv),
                              heartbeat_timeout_s=600.0, **kw), jf, pending)
    port.inject_failure(kill)
    ref.inject_failure(kill)
    rep, jrep = port.recover(), ref.recover()
    if pending:
        _mirror_ignore(golden, kill)
    for f in ("steps_replayed", "records_replayed", "determinants_replayed",
              "ignored_checkpoints"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.steps_replayed == (5 if pending else 2)
    for i, (a, b, c) in enumerate(zip(_leaves(golden), _leaves(port),
                                      _leaves(ref, True))):
        np.testing.assert_array_equal(b, a, err_msg=f"golden leaf {i}")
        np.testing.assert_array_equal(b, c, err_msg=f"reference leaf {i}")
    for r in (golden, port):
        r.run_epoch()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)
    assert reader._base == golden.executor.feed_readers[0]._base


def test_recovered_timer_fires_again_exactly_once():
    """Timers on a window subtask fire inside the replayed span; the
    recovery re-runs each recorded callback once, and the faulted log
    (with its TIMER_TRIGGER rows) equals the golden run's and the
    reference's."""
    kw = dict(steps_per_epoch=3, seed=5, inflight_ring_steps=16)
    runners = {"golden": ClusterRunner(_cascade_job(StreamEnvironment),
                                       device="cpu", **kw),
               "port": ClusterRunner(_cascade_job(StreamEnvironment),
                                     device="cpu", **kw),
               "ref": JaxRunner(_cascade_job(JaxEnv),
                                heartbeat_timeout_s=600.0, **kw)}
    fired = {k: [] for k in runners}
    for name, r in runners.items():
        svc = r.timer_service(3)
        svc.register_callback(fired[name].append, callback_id=7)
        for t in (35, 45, 60, 95):
            svc.register_timer(t, 7)
        _drive(r, jf if name == "ref" else tf, pending=True)
    assert fired["golden"] == fired["port"] == fired["ref"] == [35, 45, 60]
    runners["port"].inject_failure([3])
    runners["ref"].inject_failure([3])
    rep = runners["port"].recover()
    runners["ref"].recover()
    _mirror_ignore(runners["golden"], [3])
    timers = [d for _s, d in rep.managers[0].result.async_events
              if isinstance(d, det.TimerTriggerDeterminant)]
    assert [d.timestamp for d in timers] == [35, 45, 60]
    assert fired["port"] == [35, 45, 60, 35, 45, 60] == fired["ref"]
    assert runners["port"].timer_services[3].pending == 1
    for a, b, c in zip(_leaves(runners["golden"]), _leaves(runners["port"]),
                       _leaves(runners["ref"], True)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)


def test_failover_drill_of_feed_window_and_reduce_leaves_the_carry():
    """The drill config #4 runs: a feed source, a window and a reduce
    subtask failed together and recovered mid-epoch leave the canonical
    carry as it was, and the run goes on equal to a golden run."""
    kw = dict(steps_per_epoch=3, seed=5, inflight_ring_steps=16)
    golden, _ = _drive(ClusterRunner(_cascade_job(StreamEnvironment),
                                     device="cpu", **kw), tf)
    port, _ = _drive(ClusterRunner(_cascade_job(StreamEnvironment),
                                   device="cpu", **kw), tf)
    before = _leaves(port)
    port.failover_drill([1, 2, 5])
    for a, b in zip(before, _leaves(port)):
        np.testing.assert_array_equal(b, a)
    for r in (golden, port):
        r.run_epoch()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)


# --- staging a fed block -----------------------------------------------------

SK, SP, SB = 5, 3, 8        # a [k, P, B] block: 5 steps, 3 lanes, batch 8

#: reader kinds, each made twice alike: one the executor pulls, one the
#: old packing pulls beside it
STAGE_READERS = {
    # records_per_pull below B: every step ragged
    "ragged": lambda: tf.ListFeedReader(_mk(n=200, parts=SP, seed=21),
                                        records_per_pull=3),
    # lane 1 runs dry in the first block, lane 2 in the second
    "dry": lambda: tf.ListFeedReader(
        [p[:n] for p, n in zip(_mk(n=200, parts=SP, seed=22), (200, 23, 60))],
        records_per_pull=SB),
    # the base class's pull_block loop over pull
    "pull-loop": lambda: _LoopReader(_mk(n=90, parts=SP, seed=23), 5),
    # whole steps until the partitions run dry in the third block
    "full": lambda: tf.ListFeedReader(_mk(n=90, parts=SP, seed=24)),
}


def _stage_executor(reader):
    env = StreamEnvironment(name="stage", num_key_groups=8,
                            default_edge_capacity=SP * SB)
    (env.host_source(batch_size=SB, parallelism=SP)
        .key_by().reduce(num_keys=13, parallelism=SP).sink(parallelism=SP))
    r = ClusterRunner(env.build(), steps_per_epoch=SK, log_capacity=256,
                      max_epochs=8, inflight_ring_steps=16, seed=6,
                      device="cpu")
    r.executor.register_feed(0, reader)
    return r.executor


def _old_packing(twin):
    """A block as ``_pull_feeds`` staged it before it packed counts: a
    zeroed ``[3, k, P, B]`` int32 array of keys, values and the valid
    plane, pulled lane by lane from ``twin``."""
    host = np.zeros((3, SK, SP, SB), np.int32)
    for i in range(SP):
        ks, vs, cnt = twin.pull_block(i, SB, SK)
        host[0, :, i], host[1, :, i] = ks, vs
        host[2, :, i] = np.arange(SB)[None, :] < cnt[:, None]
    return host


def _assert_block_is(batch, host):
    keys, values, ts, valid = (x.cpu().numpy() for x in batch)
    assert keys.dtype == values.dtype == ts.dtype == np.int32
    assert valid.dtype == np.bool_
    np.testing.assert_array_equal(keys, host[0])
    np.testing.assert_array_equal(values, host[1])
    np.testing.assert_array_equal(ts, np.zeros_like(host[0]))
    np.testing.assert_array_equal(valid, host[2] != 0)


@pytest.fixture
def feed_tracer():
    from clonos_tpu_torch import obs
    yield obs.configure("feeds")
    obs.reset()


@pytest.mark.parametrize("kind", list(STAGE_READERS))
def test_pulled_blocks_equal_the_old_three_plane_packing(kind, feed_tracer):
    """``_pull_feeds``' batches (keys, values, zero timestamps, valid)
    equal the zeroed three-plane packing element for element, block after
    block, as readers run ragged and dry; on the CPU ``feed.pack`` packs
    into no pinned memory."""
    ex = _stage_executor(STAGE_READERS[kind]())
    twin = STAGE_READERS[kind]()
    for _ in range(3):
        (batch,) = ex._pull_feeds(SK)
        _assert_block_is(batch, _old_packing(twin))
    packs = [x for x in feed_tracer.records() if x["name"] == "feed.pack"]
    assert [x["args"]["pinned"] for x in packs] == [0, 0, 0]


def test_a_pulled_block_keeps_its_records_after_later_pulls():
    """Three blocks pulled in a row: each block's tensors still hold its
    own records after the third pull (no buffer reused under them)."""
    ex = _stage_executor(STAGE_READERS["ragged"]())
    twin = STAGE_READERS["ragged"]()
    got = [ex._pull_feeds(SK)[0] for _ in range(3)]
    for batch in got:
        _assert_block_is(batch, _old_packing(twin))


def _line_server(lines, n_clients):
    """A TCP server on 127.0.0.1 that sends ``lines`` to each of
    ``n_clients`` connections and closes them."""
    import socket
    import threading
    srv = socket.create_server(("127.0.0.1", 0))
    payload = "".join(f"{x}\n" for x in lines).encode()

    def serve():
        for _ in range(n_clients):
            conn, _ = srv.accept()
            with conn:
                conn.sendall(payload)
        srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return srv.getsockname()[1], t


@pytest.mark.parametrize("parts,retention", [(1, None), (3, 16), (2, 5)])
def test_socket_reader_equals_reference(parts, retention):
    """Seeded ``key[:value]`` lines (with blanks and junk) over TCP: the
    port's reader and the reference's return the same records call for
    call — pulls past retention with ``records_lost``, pull_block,
    read_at, commits and the expired-offset error."""
    rng = np.random.RandomState(parts * 10 + (retention or 0))
    lines = []
    for _ in range(90):
        kind = rng.randint(0, 6)
        k, v = int(rng.randint(-50, 1000)), int(rng.randint(-9, 9))
        lines.append({0: f"{k}:{v}", 1: str(k), 2: "", 3: "x:1",
                      4: f"  {k}:{v}  ", 5: f"{k}:{v}"}[kind])
    port, server = _line_server(lines, 2)
    readers = [mod.SocketFeedReader("127.0.0.1", port, num_subtasks=parts,
                                    retention=retention)
               for mod in (tf, jf)]
    try:
        for r in readers:
            r._thread.join(timeout=60)
            assert not r._thread.is_alive()
        server.join(timeout=60)
        got, want = readers
        script = [("pull", 0, 4), ("pull", parts - 1, 7),
                  ("block", 0, 3, 2), ("commit",), ("pull", 0, 100),
                  ("read", parts - 1, 0, 1), ("read", 0, 200, 1)]
        for step in script:
            out = []
            for r in readers:
                try:
                    if step[0] == "pull":
                        out.append(r.pull(step[1], step[2]))
                    elif step[0] == "block":
                        out.append(tuple(a.tolist() for a in
                                         r.pull_block(*step[1:])))
                    elif step[0] == "commit":
                        r.notify_checkpoint_complete(
                            [3 + s for s in range(parts)])
                        out.append(None)
                    else:
                        out.append(r.read_at(*step[1:]))
                except ValueError as e:          # expired or unavailable
                    out.append((type(e).__name__, str(e)))
            assert out[0] == out[1], step
            assert got.records_lost == want.records_lost, step
            assert (got._r._base, got._r._cursor) \
                == (want._r._base, want._r._cursor), step
        if retention is not None and retention < 16:
            assert sum(got.records_lost) > 0
    finally:
        readers[0].close()
