"""PyTorch port, causal services: SERIALIZABLE determinant rows and
sidecar keys equal the reference's byte for byte and decode through the
port's tag table; the time, random, periodic and serializable services
record and replay as the reference's do (the external function is not
called again); and a job whose task logs async service rows between
steps recovers on the CPU equal to a golden port run and to the
reference's faulted run, the recovered SERIALIZABLE rows serving the
recorded bytes. Tolerance: exact."""

import zlib

import numpy as np
import jax
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.causal import determinant as jdet
from clonos_tpu.causal import services as jsvc
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import services as svc
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves


def test_serializable_rows_and_sidecar_keys_equal_reference():
    rng = np.random.RandomState(0)
    blobs = [rng.bytes(int(n)) for n in rng.randint(0, 300, 12)]
    for owner in (0, 1, 5, (1 << 23) - 1):
        ps, js = det.SidecarStore(owner), jdet.SidecarStore(owner)
        for epoch, blob in enumerate(blobs):
            dp, dj = ps.put(blob, epoch), js.put(blob, epoch)
            assert (dp.sidecar_key, dp.length, dp.crc32) == (
                dj.sidecar_key, dj.length, dj.crc32)
            assert dp.crc32 == zlib.crc32(blob) and dp.crc32 >= 0
            assert dp.pack().tobytes() == dj.pack().tobytes()
            assert det.Determinant.unpack(dj.pack()) == dp
            assert ps.get(dp) == js.get(dj) == blob
        assert dp.sidecar_key >> det.SidecarStore.OWNER_SHIFT == owner
    with pytest.raises(ValueError):
        det.SidecarStore(1 << 23)


def test_every_tag_decodes_like_the_reference():
    rows = jdet.pack_batch([
        jdet.OrderDeterminant(channel=3),
        jdet.TimestampDeterminant(timestamp=-(1 << 40) + 7),
        jdet.RNGDeterminant(value=-5),
        jdet.SerializableDeterminant(sidecar_key=(9 << 40) | 77, length=12,
                                     crc32=0xFFFFFFF0),
        jdet.TimerTriggerDeterminant(record_count=4, callback_id=2,
                                     timestamp=1 << 33),
        jdet.SourceCheckpointDeterminant(record_count=1, checkpoint_id=5,
                                         timestamp=9, checkpoint_type=1,
                                         storage_ref=2),
        jdet.IgnoreCheckpointDeterminant(record_count=3, checkpoint_id=8),
        jdet.BufferBuiltDeterminant(num_records=11)])
    port = det.unpack_batch(rows)
    assert [type(d).__name__ for d in port] == [
        type(d).__name__ for d in jdet.unpack_batch(rows)]
    assert det.pack_batch(port).tobytes() == rows.tobytes()
    assert port[3].crc32 == 0xFFFFFFF0


def test_sidecar_integrity_merge_and_truncation():
    store = det.SidecarStore(owner=2)
    d = store.put(b"payload", epoch=3)
    other = det.SidecarStore(owner=4)
    d2 = other.put(b"remote", epoch=5)
    store.merge_from(other)
    assert store.get(d2) == b"remote" and len(store) == 2
    clash = det.SidecarStore(owner=2)
    clash.put(b"different", epoch=3)
    with pytest.raises(ValueError):
        store.merge_from(clash)
    with pytest.raises(ValueError):
        store.get(det.SerializableDeterminant(d.sidecar_key, d.length,
                                              d.crc32 ^ 1))
    store.truncate(oldest_live_epoch=4)
    with pytest.raises(KeyError):
        store.get(d)


def test_time_and_random_services_replay_like_reference():
    logged = []
    clock = iter([100, 200])
    t = svc.CausalTimeService(logged.append, clock=lambda: next(clock))
    assert [t.current_time_millis() for _ in range(2)] == [100, 200]
    jlogged = []
    jclock = iter([100, 200])
    jt = jsvc.CausalTimeService(jlogged.append, clock=lambda: next(jclock))
    [jt.current_time_millis() for _ in range(2)]
    assert det.pack_batch(logged).tobytes() == \
        jdet.pack_batch(jlogged).tobytes()
    logged2 = []
    t2 = svc.CausalTimeService(logged2.append,
                               replay_feed=svc.ReplayFeed(list(logged)),
                               clock=lambda: 1 / 0)
    assert [t2.current_time_millis() for _ in range(2)] == [100, 200]
    assert logged2 == logged                 # appended during replay too
    t2._clock = lambda: 300
    assert t2.current_time_millis() == 300   # past the feed: live again
    rl, jl = [], []
    r = svc.CausalRandomService(rl.append, seed=5)
    jr = jsvc.CausalRandomService(jl.append, seed=5)
    assert [r.next_int() for _ in range(3)] == [jr.next_int()
                                                for _ in range(3)]
    r2 = svc.CausalRandomService(lambda d: None,
                                 replay_feed=svc.ReplayFeed(list(rl)),
                                 seed=99)
    assert [r2.next_int() for _ in range(3)] == [d.value for d in rl]
    with pytest.raises(RuntimeError):
        svc.CausalTimeService(lambda d: None, replay_feed=svc.ReplayFeed(
            list(rl))).current_time_millis()


def test_periodic_time_service_amortizes_and_replays():
    wall = iter([100, 150, 260])
    samples = []

    def clock():
        samples.append(next(wall))
        return samples[-1]

    logged = []
    p = svc.PeriodicCausalTimeService(logged.append, clock=clock,
                                      period_ms=1 << 30)
    assert [p.current_time_millis() for _ in range(4)] == [100] * 4
    assert len(samples) == 1 and len(logged) == 4
    p0 = svc.PeriodicCausalTimeService(logged.append, clock=clock,
                                       period_ms=0)
    assert [p0.current_time_millis() for _ in range(2)] == [150, 260]
    p2 = svc.PeriodicCausalTimeService(
        lambda d: None, replay_feed=svc.ReplayFeed(list(logged[:4])),
        clock=lambda: 1 / 0)
    assert [p2.current_time_millis() for _ in range(4)] == [100] * 4


def test_serializable_service_replays_without_external_call():
    logged = []
    store = det.SidecarStore(owner=1)
    calls = []

    def external(req: bytes) -> bytes:
        calls.append(req)
        return b"resp:" + req

    s = svc.CausalSerializableService(logged.append, external, store,
                                      epoch_of=lambda: 0)
    assert [s.apply(b"a"), s.apply(b"b")] == [b"resp:a", b"resp:b"]
    s2 = svc.CausalSerializableService(
        lambda d: None, external, store, epoch_of=lambda: 0,
        replay_feed=svc.ReplayFeed(list(logged)))
    assert [s2.apply(b"a"), s2.apply(b"b")] == [b"resp:a", b"resp:b"]
    assert len(calls) == 2


def _join_job(env_cls):
    env = env_cls(name="c5-mini", num_key_groups=16,
                  default_edge_capacity=32)
    left = env.synthetic_source(vocab=7, batch_size=4, parallelism=2)
    right = env.synthetic_source(vocab=7, batch_size=4, parallelism=2,
                                 name="source-r")
    left.key_by().join(right.key_by(), num_keys=7, window=4,
                       interval=1 << 30).sink()
    return env.build()


TIMES = list(range(0, 400, 20))


def _leaves(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def test_service_rows_recover_like_golden_and_reference():
    """Config #5's service calls at test scale: three external calls, a
    time read and a random draw on join subtask 1 (flat 5), logged
    between steps, then a kill of that subtask."""
    calls = {"golden": [], "port": [], "ref": []}

    def drive(name, r, det_mod):
        r.executor.time_source.now = lambda it=iter(TIMES): next(it)
        sidecar = det_mod.SidecarStore(owner=5)
        fac = r.executor.service_factory(5, sidecar, seed=3,
                                         clock=lambda: 777)
        ext = fac.serializable_service(
            lambda q: calls[name].append(q) or b"answer:" + q)
        r.run_epoch()
        r.step()
        got = [ext.apply(b"q%d" % i) for i in range(3)]
        fac.time_service().current_time_millis()
        fac.random_service().next_int()
        r.step()
        return got, sidecar, fac

    kw = dict(steps_per_epoch=3, seed=9, replication_factor=2)
    golden = ClusterRunner(_join_job(StreamEnvironment), device="cpu", **kw)
    port = ClusterRunner(_join_job(StreamEnvironment), device="cpu", **kw)
    ref = JaxRunner(_join_job(JaxEnv), heartbeat_timeout_s=600.0, **kw)
    drive("golden", golden, det)
    answers, sidecar, _ = drive("port", port, det)
    drive("ref", ref, jdet)
    port.inject_failure([5])
    ref.inject_failure([5])
    rep, jrep = port.recover(), ref.recover()
    evs = rep.managers[0].result.async_events
    jevs = jref = jrep.managers[0].result.async_events
    assert [(s, type(d).__name__) for s, d in evs] == [
        (s, type(d).__name__) for s, d in jref]
    assert [type(d).__name__ for _s, d in evs] == [
        "SerializableDeterminant"] * 3 + ["TimestampDeterminant",
                                          "RNGDeterminant"]
    assert det.pack_batch([d for _s, d in evs]).tobytes() == \
        jdet.pack_batch([d for _s, d in jevs]).tobytes()
    for a, b, c in zip(_leaves(golden), _leaves(port), _leaves(ref, True)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    # A service rebuilt over the recovered rows serves the recorded bytes,
    # appends the same rows again and never calls the external function
    # (its rows are already back in the log, so they go to a list here).
    replayed = []
    fac = svc.CausalServiceFactory(
        replayed.append, sidecar, epoch_of=lambda: 0,
        replay_feed=svc.ReplayFeed([d for _s, d in evs]),
        clock=lambda: 1 / 0)
    ext = fac.serializable_service(lambda q: calls["port"].append(q))
    assert [ext.apply(b"q%d" % i) for i in range(3)] == answers
    assert fac.time_service().current_time_millis() == 777
    fac.random_service().next_int()
    assert replayed == [d for _s, d in evs]
    assert len(calls["port"]) == 3
    for r in (golden, port):
        r.step()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)
