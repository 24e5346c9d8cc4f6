"""PyTorch port, the full local-recovery protocol: mirrors of the
reference's ``tests/test_recovery.py`` on the same seeded inputs. Each
schedule runs through the port's ``ClusterRunner`` twice (a golden run
that never fails, and a faulted one) and through the reference
``ClusterRunner`` with the same kill. The faulted port carry equals the
golden port carry, and equals the reference's faulted carry, leaf for
leaf on the canonical (logically live) state; the recovery reports agree
field for field. Tolerance: exact (int32/bool)."""

import numpy as np
import jax
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.causal import recovery as jrec
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner, HeartbeatMonitor
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map

VOCAB, BATCH, NKEYS = 11, 8, 11
TIMES = list(range(0, 2000, 20))    # deterministic causal-time sequence


def _wc(env_cls, parallelism=2):
    env = env_cls(name="wc", num_key_groups=16)
    (env.synthetic_source(vocab=VOCAB, batch_size=BATCH,
                          parallelism=parallelism)
        .key_by()
        .window_count(num_keys=NKEYS, window_size=50)
        .sink())
    return env.build()


def _bench(env_cls, parallelism=2):
    """The bench topology at test scale: source -> keyed window -> keyed
    reduce -> sink (4 vertex classes)."""
    env = env_cls(name="bench-mini", num_key_groups=16,
                  default_edge_capacity=32)
    (env.synthetic_source(vocab=VOCAB, batch_size=4, parallelism=parallelism)
        .key_by()
        .window_count(num_keys=VOCAB, window_size=1 << 30, name="window")
        .key_by()
        .reduce(num_keys=VOCAB, name="reduce")
        .sink())
    return env.build()


def _port(job=_wc, **kw):
    kw = dict(dict(steps_per_epoch=3, seed=3), **kw)
    r = ClusterRunner(job(StreamEnvironment), device="cpu", **kw)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    return r


def _ref(job=_wc, **kw):
    kw = dict(dict(steps_per_epoch=3, seed=3), **kw)
    r = JaxRunner(job(JaxEnv), heartbeat_timeout_s=600.0, **kw)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    return r


def _advance(runner, steps, epochs=1):
    for _ in range(epochs):
        runner.run_epoch()
    for _ in range(steps):
        runner.step()
    return runner


def _canon(runner):
    return tree_map(lambda x: x.clone(),
                    tex.canonical_carry(runner.executor.carry))


def _assert_port_equal(a, b, what=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} leaf {i}"


def _assert_matches_reference(ref_runner, port_runner):
    la = jax.tree_util.tree_leaves(jax.device_get(
        jex.canonical_carry(ref_runner.executor.carry)))
    lb = tree_leaves(carry_to_numpy(
        tex.canonical_carry(port_runner.executor.carry)))
    assert len(la) == len(lb)
    for i, (a, b) in enumerate(zip(la, lb)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def _assert_same_report(jr, tr):
    for f in ("failed_subtasks", "from_epoch", "steps_replayed",
              "determinants_replayed", "records_replayed",
              "ignored_checkpoints"):
        assert getattr(tr, f) == getattr(jr, f), f


def _numpy_canon(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _mirror_ignore(runner, failed):
    """The control-plane decision recovery takes for a pending checkpoint,
    applied to a run that never failed: its healthy logs record the same
    IGNORE_CHECKPOINT rows at the same stamp."""
    healthy = [f for f in range(runner.job.total_subtasks())
               if f not in failed]
    for cid in runner.coordinator.ignore_unacked_for(set(failed)):
        runner.executor.append_async_many(
            healthy, det.IgnoreCheckpointDeterminant(
                record_count=runner.executor.global_record_stamp(),
                checkpoint_id=cid))


def _run_schedule(job, schedule, **kw):
    """One golden port run, one faulted port run and one faulted
    reference run through ``schedule`` — ``(name, advance, kill)``
    triples. After each kill and recovery, the canonical carries of all
    three are kept (numpy), with both reports."""
    golden, port, ref = _port(job, **kw), _port(job, **kw), _ref(job, **kw)
    out = {}
    for name, advance, kill in schedule:
        for r in (golden, port, ref):
            advance(r)
        port.inject_failure(kill)
        ref.inject_failure(kill)
        report = port.recover()
        jreport = ref.recover()
        if report.ignored_checkpoints:
            _mirror_ignore(golden, kill)
        out[name] = dict(report=report, jreport=jreport,
                         golden=_numpy_canon(golden),
                         port=_numpy_canon(port),
                         ref=_numpy_canon(ref, ref=True))
    for r in (golden, port, ref):
        r.run_epoch()
        r.step()
    out["end"] = dict(golden=_numpy_canon(golden), port=_numpy_canon(port),
                      ref=_numpy_canon(ref, ref=True))
    return out


def _assert_leaves_equal(got, want, what):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what} {i}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _check(run):
    """The faulted port carry equals the golden one and the reference's
    faulted one; the reports agree."""
    _assert_leaves_equal(run["port"], run["golden"], "port vs golden")
    _assert_leaves_equal(run["port"], run["ref"], "port vs reference")
    if "report" in run:
        _assert_same_report(run["jreport"], run["report"])
    return run.get("report")


def _steps(n, epochs=0, complete=True):
    def advance(r):
        for _ in range(epochs):
            r.run_epoch(complete_checkpoint=complete)
        for _ in range(n):
            r.step()
    return advance


#: the reference's wc-job scenarios, one after another on one run: a kill
#: right at a fence, a source, a sink, a connected window+sink pair and
#: both subtasks of one vertex.
WC_SCHEDULE = [
    ("zero_step", _steps(0, epochs=1), [3]),
    ("source", _steps(1), [0]),
    ("sink", _steps(1), [5]),
    ("connected", _steps(2, epochs=1), [3, 4]),
    ("same_vertex_pair", _steps(1), [2, 3]),
]

#: the bench topology: one failure per vertex class, a connected window
#: + the reduce it feeds, then recoveries across an open epoch whose
#: checkpoint stays pending (ignored by recovery).
BENCH_SCHEDULE = [
    ("source", _steps(2, epochs=1), [0]),
    ("window", _steps(2, epochs=1), [3]),
    ("reduce", _steps(2, epochs=1), [4]),
    ("sink", _steps(2, epochs=1), [7]),
    ("window_reduce", _steps(2, epochs=1), [3, 5]),
    ("pending_window", lambda r: (r.run_epoch(),
                                  _steps(2, 1, complete=False)(r)), [3]),
    ("pending_connected", lambda r: (r.run_epoch(),
                                     _steps(2, 1, complete=False)(r)),
     [2, 5]),
]


@pytest.fixture(scope="module")
def wc_runs():
    return _run_schedule(_wc, WC_SCHEDULE)


@pytest.fixture(scope="module")
def bench_runs():
    return _run_schedule(_bench, BENCH_SCHEDULE, seed=11,
                         inflight_ring_steps=16)


# --- FSM ---------------------------------------------------------------------


def _fsm_events(mod):
    mgr = mod.RecoveryManager(1, 0, 2, replayer=None)
    seen = []
    mgr.notify_start_recovery(in_edges=[0], out_edges=[1])
    seen.append(mgr.state.name)
    mgr.notify_new_input_channel(0)
    seen.append(mgr.state.name)
    mgr.notify_new_output_channel(1)
    seen.append(mgr.state.name)              # state restoration missing
    mgr.notify_state_restoration_complete()
    seen.append(mgr.state.name)
    mgr.expect_determinant_responses(2)
    mgr.notify_determinant_response(np.zeros((0, 8), np.int32), 0)
    seen.append(mgr.state.name)
    mgr.notify_determinant_response(np.zeros((0, 8), np.int32), 0)
    seen.append(mgr.state.name)
    return mgr, seen


def test_fsm_gates_on_connections_and_state():
    mgr, seen = _fsm_events(rec)
    jmgr, jseen = _fsm_events(jrec)
    assert seen == jseen == [
        "WAITING_CONNECTIONS", "WAITING_CONNECTIONS", "WAITING_CONNECTIONS",
        "WAITING_DETERMINANTS", "WAITING_DETERMINANTS", "REPLAYING"]
    assert [s.name for s in mgr.transitions] \
        == [s.name for s in jmgr.transitions] \
        == ["STANDBY", "WAITING_CONNECTIONS", "WAITING_DETERMINANTS",
            "REPLAYING"]


@pytest.mark.parametrize("mod", [rec, jrec], ids=["port", "reference"])
def test_fsm_rejects_out_of_order_events(mod):
    mgr = mod.RecoveryManager(1, 0, 2, replayer=None)
    with pytest.raises(mod.RecoveryError):
        mgr.notify_determinant_response(np.zeros((0, 8), np.int32), 0)
    mgr.notify_start_recovery([0], [])
    with pytest.raises(mod.RecoveryError, match="start_recovery"):
        mgr.notify_start_recovery([0], [])


# --- end-to-end recovery -----------------------------------------------------


def test_zero_step_recovery_right_after_checkpoint(wc_runs):
    report = _check(wc_runs["zero_step"])
    assert report.steps_replayed == 0


def test_source_failure_recovery_bit_identical(wc_runs):
    report = _check(wc_runs["source"])
    assert report.steps_replayed == 1
    # The source log holds SOURCE_CHECKPOINT rows: host rows, not the
    # device stream, and the rebuilt stream splices them back.
    mgr = report.managers[0]
    assert mgr.plan.det_device is None and mgr.plan.det_rows.shape[0] > 0
    assert any(isinstance(d, det.SourceCheckpointDeterminant)
               for _, d in mgr.result.async_events)


def test_sink_failure_recovery_bit_identical(wc_runs):
    report = _check(wc_runs["sink"])
    # No downstream holds a sink's log: its rows are synthesized.
    assert report.managers[0].plan.verify_outputs is False


def test_concurrent_connected_failures(wc_runs):
    """A window subtask and a sink subtask fail together: the window's
    determinants come from the surviving sink replica, the sink is
    rebuilt via synthesis."""
    report = _check(wc_runs["connected"])
    assert report.failed_subtasks == (3, 4)


def test_same_vertex_pair_failure(wc_runs):
    """Both window subtasks fail together: the second consumer's windows
    come from the routed-window cache the first one filled."""
    report = _check(wc_runs["same_vertex_pair"])
    assert report.failed_subtasks == (2, 3)
    _check(wc_runs["end"])


@pytest.mark.parametrize("name", ["source", "window", "reduce", "sink"])
def test_bench_topology_recovery_per_vertex_class(bench_runs, name):
    report = _check(bench_runs[name])
    assert report.steps_replayed == 2
    assert report.managers[0].transitions[-1] == rec.RecoveryState.RUNNING


def test_connected_window_and_reduce_it_feeds(bench_runs):
    """The window's rebuilt ring lane feeds the reduce's replay in the
    same recover() call (topological order)."""
    report = _check(bench_runs["window_reduce"])
    assert report.failed_subtasks == (3, 5)
    assert report.records_replayed > 0


@pytest.mark.parametrize("name", ["pending_window", "pending_connected"])
def test_pending_checkpoint_recovery_across_open_epoch(bench_runs, name):
    """One checkpoint completes, the next stays pending, the kill lands
    two steps into the epoch after it: recovery ignores the pending one
    and replays from the older fence, across the open epoch."""
    report = _check(bench_runs[name])
    assert report.steps_replayed == 5
    assert report.ignored_checkpoints == (report.from_epoch,)
    _check(bench_runs["end"])


def test_failure_with_pending_checkpoint_ignores_it():
    r = _port(steps_per_epoch=2)
    r.run_epoch()                      # ckpt 0 completes
    # A checkpoint the soon-to-die subtask never acks.
    r.coordinator.trigger(99, r.executor.carry, async_write=False)
    r.step()
    r.inject_failure([2])
    report = r.recover()
    assert report.ignored_checkpoints == (99,)
    # Interval was backed off, then reset once recovery completed.
    assert r.coordinator.interval_steps == r.coordinator.base_interval_steps
    # Healthy logs recorded the ignore decision; the revived one did not.
    rows = r.executor.carry.logs.rows
    tags = rows[:, :, det.LANE_TAG]
    ignored = (tags == det.IGNORE_CHECKPOINT).sum(dim=1)
    assert ignored[2] == 0 and int(ignored.sum()) == \
        r.job.total_subtasks() - 1


def test_recovery_without_checkpoint_fails_cleanly():
    r = _port()
    r.step()
    r.inject_failure([2])
    with pytest.raises(rec.RecoveryError, match="no completed checkpoint"):
        r.recover()


def test_heartbeat_detection():
    r = _port(steps_per_epoch=2, heartbeat_timeout_s=600.0)
    assert r.heartbeats.timeout_s == 600.0
    r.run_epoch()
    r.inject_failure([1])
    r.heartbeats.beat_all_except({1})
    assert r.detect_failures() == []   # dead ones are marked, not expired
    # A subtask that silently stops beating (not marked dead) is detected.
    now = [0.0]
    clock = lambda: now[0]
    hb = HeartbeatMonitor(range(3), timeout_s=0.01, clock=clock)
    now[0] += 0.05
    hb.beat(1)
    assert hb.expired() == [0, 2]
    hb.revive(0)
    assert hb.expired() == [2]
    hb.mark_dead(2)
    now[0] += 0.05
    assert hb.expired() == [0, 1]


def _drill_job(env_cls):
    env = env_cls(name="drill", num_key_groups=8, default_edge_capacity=64)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30,
                               parallelism=2)
        .key_by().reduce(num_keys=13, parallelism=2).sink(parallelism=2))
    return env.build()


def test_failover_drill_leaves_state_identical():
    kw = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=21, logical_time=True)
    runner = ClusterRunner(_drill_job(StreamEnvironment), device="cpu", **kw)
    ref = JaxRunner(_drill_job(JaxEnv), heartbeat_timeout_s=600.0, **kw)
    for r in (runner, ref):
        r.run_epoch(complete_checkpoint=True)
        r.run_epoch(complete_checkpoint=False)   # mid-data: replay work
    before = _canon(runner)
    assert runner.failover_drill() > 0
    _assert_port_equal(_canon(runner), before, "after the drill")
    assert runner.reports == [] and not runner.failed
    # The job keeps running and recovers a real failure afterwards, as
    # the reference does after its own drill.
    ref.failover_drill()
    for r in (runner, ref):
        r.inject_failure([3])
    report = runner.recover()
    _assert_same_report(ref.recover(), report)
    _assert_matches_reference(ref, runner)


def test_clean_recovery_uses_device_resident_stream():
    """A window failure with a consistent replica and a pure-sync stream
    takes the device-parse fast path (no log body on the host)."""
    r = _advance(_port(), 2)
    r.inject_failure([3])
    report = r.recover()
    mgr = report.managers[0]
    assert mgr.plan.det_device is not None        # device stream used
    assert mgr.plan.det_rows.shape[0] == 0        # no host rows pulled
    assert mgr.result.deferred and report.determinants_replayed == 8
    assert report.records_replayed > 0
