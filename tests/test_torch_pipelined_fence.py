"""PyTorch port, the pipelined fence (``ClusterRunner(overlap_epoch=True)``):
mirrors of the reference's ``tests/test_pipelined_fence.py`` on its small
job (two sources -> keyBy -> two windows -> sink, 8-step epochs), each
schedule driven through the port's pipelined runner, the port's
sequential control and the reference's pipelined runner on the same seed.
Ledgers, canonical carries, latency-marker samples and metric counters
are compared exactly. Wall-clock attributions are held to their key sets
and to inequalities that hold by construction, never to a tolerance."""

import os

import jax
import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.obs.digest import diff_ledgers
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves

COMPLETES = (True, False, True, False)


def _window_job(env_cls, name):
    env = env_cls(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


def _kw(**kw):
    return dict(dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
                     seed=3, audit=True, logical_time=True,
                     inflight_ring_steps=32), **kw)


def _port(name, ck_dir, overlap, **kw):
    return ClusterRunner(_window_job(StreamEnvironment, name),
                         checkpoint_dir=ck_dir, overlap_epoch=overlap,
                         device="cpu", **_kw(**kw))


def _ref(name, ck_dir, overlap, **kw):
    return JaxRunner(_window_job(JaxEnv, name), checkpoint_dir=ck_dir,
                     overlap_epoch=overlap, heartbeat_timeout_s=600.0,
                     **_kw(**kw))


def _canon(runner):
    if isinstance(runner, JaxRunner):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _assert_leaves_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} {i}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _fence_keys(phases):
    return {k for k in phases if k.startswith("fence")}


@pytest.fixture(scope="module")
def schedule_runs(tmp_path_factory):
    """The headline schedule through the port's pipelined runner, its
    sequential control and the reference's pipelined and sequential
    runners, each ending in ``drain_fence``."""
    root = tmp_path_factory.mktemp("pf")
    out = {}
    for tag, make, overlap in (("port_ovl", _port, True),
                               ("port_seq", _port, False),
                               ("ref_ovl", _ref, True),
                               ("ref_seq", _ref, False)):
        r = make("pf", str(root / tag), overlap, latency_marker_every=3)
        phases = []
        for c in COMPLETES:
            r.run_epoch(complete_checkpoint=c)
            phases.append(dict(r.last_fence_phases))
        r.drain_fence()
        phases.append(dict(r.last_fence_phases))
        out[tag] = dict(runner=r, phases=phases,
                        ledger=r.coordinator.read_ledger(),
                        canon=_canon(r))
    return out


def test_pipelined_ledger_equals_reference_and_sequential(schedule_runs):
    ovl = schedule_runs["port_ovl"]["ledger"]
    assert [e["epoch"] for e in ovl] == [0, 1, 2, 3]
    assert diff_ledgers(schedule_runs["ref_ovl"]["ledger"], ovl) == []
    assert diff_ledgers(schedule_runs["port_seq"]["ledger"], ovl) == []


def test_carries_leaf_equal_after_drain(schedule_runs):
    got = schedule_runs["port_ovl"]["canon"]
    _assert_leaves_equal(got, schedule_runs["port_seq"]["canon"],
                         "pipelined vs sequential")
    _assert_leaves_equal(got, schedule_runs["ref_ovl"]["canon"],
                         "port vs reference")
    r = schedule_runs["port_ovl"]["runner"]
    assert not r.fence_tail_in_flight()
    assert r.last_sealed_epoch == 3
    # Checkpoints 0 and 2 completed; 1 and 3 stay pending, as in the
    # sequential run.
    assert r.coordinator.latest_completed_id == 2
    assert r.coordinator.storage.completed_ids() \
        == schedule_runs["port_seq"]["runner"].coordinator.storage \
        .completed_ids() == [0, 2]


def test_fence_phase_keys_and_attribution(schedule_runs):
    """Both modes carry the reference's key sets; only the pipelined run
    writes ``fence.overlap-saved``. The identities hold by construction:
    sequential sub-spans are disjoint intervals inside ``fence-tail``;
    pipelined, ``fence-tail`` is capture + join and the saved credit is
    what the sub-spans exceed it by."""
    for mode in ("ovl", "seq"):
        mine = schedule_runs[f"port_{mode}"]["phases"]
        ref = schedule_runs[f"ref_{mode}"]["phases"]
        assert [_fence_keys(p) for p in mine] \
            == [_fence_keys(p) for p in ref]
    for pm in schedule_runs["port_seq"]["phases"]:
        assert "fence.overlap-saved" not in pm
        subs = sum(v for k, v in pm.items() if k.startswith("fence."))
        assert subs <= pm["fence-tail"] + 1e-6
    joined = schedule_runs["port_ovl"]["phases"][1:]
    for pm in joined:
        spans = sum(v for k, v in pm.items() if k.startswith("fence.")
                    and k != "fence.overlap-saved")
        assert pm["fence.overlap-saved"] >= 0.0
        assert pm["fence-tail"] >= pm["fence.capture"]
        assert spans - pm["fence.overlap-saved"] <= pm["fence-tail"] + 1e-6
    r = schedule_runs["port_ovl"]["runner"]
    assert r.fence_overlap_saved_total_ms == pytest.approx(
        sum(pm["fence.overlap-saved"] for pm in joined))


def test_latency_markers_match_reference(schedule_runs):
    """Marker steps come from recorded RNG draws and latencies from
    logical causal time, so both packages see the same samples."""
    mine = schedule_runs["port_ovl"]["runner"].latency
    ref = schedule_runs["ref_ovl"]["runner"].latency
    assert mine.depth == ref.depth == 2
    assert mine.samples == ref.samples and len(mine.samples) > 0
    assert mine.schedule([3, 4, 6, 7], 3) == ref.schedule([3, 4, 6, 7], 3)
    key = "job.pf.latency-ms"
    assert schedule_runs["port_ovl"]["runner"].metrics.snapshot()[key] \
        == schedule_runs["ref_ovl"]["runner"].metrics.snapshot()[key]


def test_metric_snapshot_matches_reference(schedule_runs):
    """Every metric the port registers exists in the reference's registry
    under the same name; counters and integer gauges agree."""
    for mode in ("ovl", "seq"):
        mine = schedule_runs[f"port_{mode}"]["runner"].metrics.snapshot()
        ref = schedule_runs[f"ref_{mode}"]["runner"].metrics.snapshot()
        assert set(mine) <= set(ref)
        ints = {k: v for k, v in mine.items() if isinstance(v, int)}
        assert ints["job.pf.supersteps"] == 32
        assert ints["job.pf.audit.epochs-sealed"] == 4
        assert ints == {k: ref[k] for k in ints}
        for k, v in mine.items():
            if isinstance(v, dict):
                assert v["count"] == ref[k]["count"], k


def test_capture_equals_epoch_window():
    """The pipelined capture, sliced by host-known bounds, drains to the
    exact ``epoch_window`` of the same fence — async rows included (the
    source fence rows land in the next epoch's roll gap)."""
    r = _port("cap", None, False)
    ex = r.executor
    for _ in range(3):
        r.run_epoch()
    ex.run_epoch()
    closed = ex.epoch_id - 1
    handles = ex.capture_fence(with_window=True)
    want = ex.epoch_window(closed)
    got = handles.window()
    assert sorted(got["logs"]) == sorted(want["logs"])
    for f in want["logs"]:
        np.testing.assert_array_equal(got["logs"][f], want["logs"][f])
    assert sorted(got["rings"]) == sorted(want["rings"])
    for vid, steps in want["rings"].items():
        assert len(got["rings"][vid]) == len(steps) == 8
        for a, b in zip(got["rings"][vid], steps):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(handles.health(), ex.health_vector())


def test_kill_mid_tail_recovers_equal_to_control(tmp_path):
    """A kill while the fence tail is in flight joins it first (seal and
    ack land), recovers, and the run ends equal to a fault-free
    sequential control: ledgers diff clean, carries leaf-equal, and equal
    to the reference's run of the same schedule."""
    runs = {}
    for tag, make in (("port", _port), ("ref", _ref)):
        r = make("pfk", str(tmp_path / tag), True)
        r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=True)
        assert r.fence_tail_in_flight()
        r.inject_failure([2 + 1])              # window vertex, subtask 1
        assert not r.fence_tail_in_flight()
        report = r.recover()
        assert report.ignored_checkpoints == ()
        r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=False)
        r.drain_fence()
        runs[tag] = r
    c = _port("pfk", str(tmp_path / "ctrl"), False)
    for comp in (True, True, True, False):
        c.run_epoch(complete_checkpoint=comp)
    r = runs["port"]
    assert diff_ledgers(c.coordinator.read_ledger(),
                        r.coordinator.read_ledger()) == []
    assert diff_ledgers(runs["ref"].coordinator.read_ledger(),
                        r.coordinator.read_ledger()) == []
    _assert_leaves_equal(_canon(r), _canon(c), "faulted vs control")
    _assert_leaves_equal(_canon(r), _canon(runs["ref"]), "port vs reference")
    assert r.metrics.snapshot()["job.pfk.audit.divergences"] == 0


def test_zero_step_replay_after_joined_tail(tmp_path):
    """An owner + holder kill right after a completed fence whose tail
    just joined replays zero steps, and the ledger stays equal to the
    control's."""
    r = _port("pfz", str(tmp_path / "zs"), True, replication_factor=1)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=True)
    owner = 2 + 1
    holder = next(h for (o, h) in r.executor.compiled.plan.pairs
                  if o == owner)
    r.inject_failure([owner, holder])
    report = r.recover()
    assert report.steps_replayed == 0 and report.determinants_replayed == 0
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.drain_fence()
    c = _port("pfz", str(tmp_path / "zsc"), False, replication_factor=1)
    for comp in (True, True, True, False):
        c.run_epoch(complete_checkpoint=comp)
    assert diff_ledgers(c.coordinator.read_ledger(),
                        r.coordinator.read_ledger()) == []
    _assert_leaves_equal(_canon(r), _canon(c), "zero-step vs control")


def test_overlap_needs_one_epoch_of_ring_headroom(tmp_path):
    r = _port("pfh", str(tmp_path / "hr"), True, inflight_ring_steps=8)
    with pytest.raises(ValueError, match="ring headroom"):
        r.run_epoch(complete_checkpoint=True)
    # The same shape stays valid under the sequential fence.
    r2 = _port("pfh", str(tmp_path / "hr2"), False, inflight_ring_steps=8)
    r2.run_epoch(complete_checkpoint=True)


def test_worker_error_is_raised_at_the_join(tmp_path):
    """No silent fallback: a failure on the fence worker surfaces at the
    next join, and nothing else completes the checkpoint."""
    r = _port("pfe", str(tmp_path / "err"), True)

    def broken(*a, **k):
        raise OSError("disk full")

    r.coordinator.storage.write_ledger = broken
    r.run_epoch(complete_checkpoint=True)
    with pytest.raises(OSError, match="disk full"):
        r.drain_fence()
    assert r.coordinator.latest_completed_id is None
    assert os.listdir(str(tmp_path / "err")) == []
