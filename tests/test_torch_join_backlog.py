"""PyTorch port, config #5's deployment at test scale, built by the
benchmark's own topology (``portbench/topologies/interval_join.py``,
with its join services): two synthetic sources ->
keyBy on both -> interval join -> sink, parallelism 2, batch 4, 13 keys,
``replication_factor=2``; one completed 64-step epoch, then a 3-epoch
backlog with one external call, one time read and one random draw on
every join subtask before each pending epoch; then two kills, back to
back, with no step between.

Each recovery leaves the state and the join's output ring equal to the
plain reference (``portbench/reference/interval_join.py``); a join
subtask's determinant rows are fetched to the host and parsed there
because of its service rows, and without them they stay on the device;
the counters on ``recovery.fetch_determinants`` and ``recovery.replay``
equal the rows the failed subtask's log holds; the rows recovered hold
every recorded external answer, time read and random draw, served from
them without an external call. Exact."""

from collections import Counter

import numpy as np
import pytest
import torch

from clonos_tpu_torch import obs
from clonos_tpu_torch.runtime import cluster
from clonos_tpu_torch.runtime.executor import DETS_PER_STEP
from portbench import harness

CELL = "nexmark_join.recover"
P, SPE, PENDING = 2, 64, 3
#: the cell's configuration at test scale: parallelism 2, batch 4, 13
#: keys, 64-step epochs, a 3-epoch backlog
SMALL = dict(parallelism=P, batch=4, vocab=13, num_key_groups=8,
             edge_capacity=64, steps_per_epoch=SPE, pending_epochs=PENDING,
             block_steps=32, inflight_ring_steps=256, log_capacity=1024)
VERTICES = ("source", "source-r", "join", "sink")


@pytest.fixture(autouse=True)
def _null_tracer_after():
    yield
    obs.reset()


def _backlog(seed: int, calls: bool = True):
    """The job after its fill, built by the cell's own topology: one
    completed epoch, then the pending ones, each after the join's
    external calls (none where ``calls`` is False)."""
    ctx = harness.Ctx(CELL, seed, 0.0, False, "cpu", SMALL)
    ctx.topology.build(ctx)
    r = ctx.runner
    r.run_epoch(complete_checkpoint=True)
    for e in range(PENDING):
        if calls:
            ctx.services.call_all(e)
        r.run_epoch(complete_checkpoint=False)
    return ctx


def _join_ring(r, ref, steps):
    """Mismatches of the join's output ring over the backlog's steps
    against the reference, per-subtask multisets."""
    ex = r.executor
    ring = ex.carry.out_rings[ex.compiled.ring_index[2]]
    n = ring.keys.shape[0]
    bad = 0
    for s in range(steps - SPE * PENDING, steps):
        k, v, t, m = (x[s & (n - 1)].numpy() for x in (
            ring.keys, ring.values, ring.timestamps, ring.valid))
        want = ref.join_records(s)
        for q in range(P):
            got = Counter(zip(k[q][m[q]].tolist(), v[q][m[q]].tolist(),
                              t[q][m[q]].tolist()))
            exp = Counter(want[q])
            bad += sum(((got - exp) + (exp - got)).values())
    return bad


def _counted(tracer, name):
    return [x["args"] for x in tracer.records()
            if x["name"] == f"recovery.{name}" and "rows" in x.get("args", {})]


@pytest.mark.parametrize("kill,calls", [
    (["join"], True), (["join", "sink"], True), (["source-r", "join"], True),
    (["join"], False)],
    ids=["join", "join+sink", "source-r+join", "join-without-calls"])
def test_backlog_recovery_equals_the_reference(kill, calls):
    """Two kills of ``kill``, back to back: after each, the state and the
    join's output ring equal the reference's; each failed subtask's fetch
    and replay counters equal its log's rows and its steps; a join's
    rows were parsed on the host where it made service calls, and stayed
    on the device where it made none (until the first recovery's
    ignore-checkpoint rows); a synthetic source, which cannot be padded,
    is parsed on the host too; the join's recorded answers come back
    without an external call."""
    ctx = _backlog(2 ** 31 + len(kill) * 10 + len(kill[0]), calls=calls)
    r, job, services = ctx.runner, ctx.runner.job, ctx.services
    steps = r.executor._steps_executed
    ref = ctx.topology.reference(ctx, steps, "cpu")
    want = ref.state_at(steps)
    rs = np.random.RandomState(7)
    for cycle in range(2):
        flats = [job.subtask_base(VERTICES.index(name)) + rs.randint(P)
                 for name in kill]
        sizes = r.executor.log_sizes()
        tracer = obs.configure("test")
        r.inject_failure(flats)
        rep = r.recover()
        obs.reset()
        assert rep.steps_replayed == SPE * PENDING
        got = ctx.topology.snapshot_state(ctx)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert _join_ring(r, ref, steps) == 0
        fetched = _counted(tracer, "fetch_determinants")
        replayed = _counted(tracer, "replay")
        assert len(fetched) == len(replayed) == len(flats)
        for f, fa, ra in zip(rep.failed_subtasks, fetched, replayed):
            name = VERTICES[[v for v in range(4)
                             if job.subtask_base(v) <= f][-1]]
            assert ra["steps"] == SPE * PENDING
            assert ra["inputs"] == {"source-r": 0, "join": 2, "sink": 1}[name]
            if name != "sink":
                # A sink's rows are re-synthesised: it has no replica.
                assert fa["rows"] == ra["rows"] == sizes[f], name
            if name == "join" and calls:
                assert ra["async"] >= 3 * PENDING
                assert fa["host_rows"] == fa["rows"] > 0
            elif name == "join" and cycle == 0:
                assert fa["host_rows"] == ra["async"] == 0
                assert fa["rows"] == DETS_PER_STEP * SPE * PENDING
            elif name == "source-r":
                assert fa["host_rows"] == fa["rows"] > 0
        assert services.mismatches(rep) == 0
        assert services.calls == (P * PENDING if calls else 0)
        r.reports.clear()


def test_counts_add_to_the_open_phase_only_while_tracing():
    """``_RecoverySpans.count`` sums into the open phase's span args, and
    does nothing with the tracer off or no phase open."""
    with cluster._RecoverySpans(False, torch.device("cpu")) as ph:
        ph.begin()
        ph.count({"rows": 3})
        ph.close()
    tr = obs.configure("test")
    with cluster._RecoverySpans(False, torch.device("cpu")) as ph:
        ph.begin()
        ph.enter("replay")
        ph.count({"rows": 3, "async": 1})
        ph.count({"rows": 4})
        ph.stop()
        ph.count({"rows": 5})
        ph.close()
    (rec,) = [x for x in tr.records() if x["name"] == "recovery.replay"]
    assert rec["args"] == {"drill": False, "rows": 7, "async": 1}
