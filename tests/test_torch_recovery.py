"""PyTorch port, local recovery: a window subtask and a reduce subtask of
the flagship job are killed mid-epoch and recovered by the port's
``ClusterRunner`` (checkpoint row + replica determinants + re-routed
upstream ring + ``LogReplayer``). The recovered carry is bit-identical to
a port run that never failed, and the port's final carry equals the
reference ``ClusterRunner``'s golden carry on the same schedule.
Tolerance: exact (int32/bool)."""

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as graft
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxClusterRunner
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal.recovery import RecoveryError
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map

KW = dict(steps_per_epoch=24, log_capacity=1 << 9, max_epochs=8,
          inflight_ring_steps=32, block_steps=16, logical_time=True, seed=5)
#: steps into epoch 2 before the kill: past the window fire at step 64,
#: so the replayed range holds a fire and the reduce receives records.
STEPS_BEFORE_KILL = 20


def _port_flagship(parallelism=2):
    env = StreamEnvironment(name="flagship-wordcount", num_key_groups=64,
                            default_edge_capacity=128)
    (env.synthetic_source(vocab=211, batch_size=32, parallelism=parallelism)
        .key_by()
        .window_count(num_keys=211, window_size=64, name="window")
        .key_by()
        .reduce(num_keys=211, name="reduce")
        .sink())
    return env.build()


def _canonical(runner):
    # A copy: later blocks update the live in-flight rings in place.
    return tree_map(lambda x: x.clone(),
                    tex.canonical_carry(runner.executor.carry))


def _schedule(runner, kill=None, snapshot=_canonical):
    """Two checkpointed epochs, a partial epoch, an optional kill and
    recovery, then one more epoch and a few steps. Returns the runner, the
    recovery report and the canonical carry right after the kill point
    (before the next fence truncates the replayed steps' ring slots)."""
    for _ in range(2):
        runner.run_epoch()
    for _ in range(STEPS_BEFORE_KILL):
        runner.step()
    report = None
    if kill is not None:
        runner.inject_failure([kill])
        report = runner.recover()
    at_kill = snapshot(runner)
    runner.run_epoch()
    for _ in range(3):
        runner.step()
    return runner, report, at_kill


@pytest.fixture(scope="module")
def port_golden():
    runner, _, at_kill = _schedule(
        ClusterRunner(_port_flagship(), device="cpu", **KW))
    return at_kill, _canonical(runner)


def _flat(runner, vid, sub):
    return runner.job.subtask_base(vid) + sub


@pytest.mark.parametrize("vid,sub", [(1, 1), (2, 0)],
                         ids=["window", "reduce"])
def test_recovered_subtask_is_bit_identical_to_golden(port_golden, vid,
                                                      sub):
    runner = ClusterRunner(_port_flagship(), device="cpu", **KW)
    flat = _flat(runner, vid, sub)
    runner, report, at_kill = _schedule(runner, kill=flat)
    assert report.failed_subtasks == (flat,)
    assert report.steps_replayed == STEPS_BEFORE_KILL
    assert report.records_replayed > 0
    result = report.results[0]
    result.verify()
    assert int(result.emit_counts.sum()) > 0      # the replay emitted
    for when, got, want in (("after recovery", at_kill, port_golden[0]),
                            ("at the end", _canonical(runner),
                             port_golden[1])):
        got, want = tree_leaves(got), tree_leaves(want)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), \
                f"{when}: leaf {i}"


def test_port_golden_equals_reference_cluster_golden(port_golden):
    ref, _, _ = _schedule(JaxClusterRunner(graft._flagship_job(2),
                                           heartbeat_timeout_s=600.0, **KW),
                          snapshot=lambda r: None)
    la = jax.tree_util.tree_leaves(jax.device_get(
        jex.canonical_carry(ref.executor.carry)))
    lb = tree_leaves(carry_to_numpy(port_golden[1]))
    assert len(la) == len(lb)
    for i, (a, b) in enumerate(zip(la, lb)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def test_corrupted_output_cut_fails_verification():
    # A replica whose recorded BUFFER_BUILT cut disagrees with what the
    # replay emits must stop the recovery, not graft a divergent subtask.
    runner = ClusterRunner(_port_flagship(), device="cpu", **KW)
    for _ in range(2):
        runner.run_epoch()
    for _ in range(STEPS_BEFORE_KILL):
        runner.step()
    flat = _flat(runner, 2, 1)
    reps = runner.executor.carry.replicas
    rows = reps.rows.clone()
    for r, (owner, _) in enumerate(runner.plan.pairs):
        if owner == flat:
            built = rows[r, :, det.LANE_TAG] == det.BUFFER_BUILT
            rows[r, :, det.LANE_P] += built.to(torch.int32)
    runner.executor.carry = runner.executor.carry._replace(
        replicas=reps._replace(rows=rows))
    runner.inject_failure([flat])
    with pytest.raises(RecoveryError, match="output batch cuts differ"):
        runner.recover()


def _chain(parallelism=1):
    env = StreamEnvironment(name="drill-bad", num_key_groups=4,
                            default_edge_capacity=16)
    (env.synthetic_source(vocab=7, batch_size=2, parallelism=parallelism)
        .key_by().window_count(num_keys=7, window_size=1 << 30,
                               parallelism=parallelism)
        .sink(parallelism=parallelism))
    return env.build()


def test_recover_refuses_a_log_without_surviving_holder():
    # The reference's one refusal (tests/test_recovery.py:314): a failure
    # set that leaves some log with no surviving replica holder. A drill
    # of such a set is refused before any state is zeroed.
    kw = dict(steps_per_epoch=4, log_capacity=128, max_epochs=8,
              inflight_ring_steps=16, seed=3)
    runner = ClusterRunner(_chain(), device="cpu", **kw)
    runner.run_epoch(complete_checkpoint=True)
    runner.run_epoch(complete_checkpoint=False)
    before = [x.clone() for x in tree_leaves(runner.executor.carry)]
    with pytest.raises(RecoveryError, match="no surviving determinant"):
        runner.failover_drill()        # default set = every vertex class
    after = tree_leaves(runner.executor.carry)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)       # raw bytes untouched
    assert not runner.failed and runner.reports == []
    # A real failure of the window and the one sink holding its log.
    runner.inject_failure([1, 2])
    with pytest.raises(RecoveryError, match="no surviving replica"):
        runner.recover()
    assert runner.failed == {1, 2}
