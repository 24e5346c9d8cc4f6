"""PyTorch port, logs: the causal log's bulk append equals its masked
append across ring wraps and equals the reference's; the in-flight ring's
``append_block`` / ``slice_steps_at`` / ``truncate`` and the replica plan
match the reference. Tolerance: exact (int32/bool)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JEnv
from clonos_tpu.api.records import RecordBatch as JRB
from clonos_tpu.causal import log as jlog
from clonos_tpu.causal import replication as jrep
from clonos_tpu.inflight import log as jifl
from clonos_tpu_torch.api.environment import StreamEnvironment as TEnv
from clonos_tpu_torch.api.records import RecordBatch as TRB
from clonos_tpu_torch.causal import log as tlog
from clonos_tpu_torch.causal import replication as trep
from clonos_tpu_torch.inflight import log as tifl
from clonos_tpu_torch.utils.tree import tree_leaves


def _eq(a, b):
    la, lb = jax.tree_util.tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("cap,sizes", [
    (64, (4, 16, 28)),
    (512, (4, 6, 3)),
    (512, (4, 200, 3, 380)),
])
def test_bulk_append_full_matches_masked_append_and_reference(cap, sizes):
    rng = np.random.RandomState(3)
    L = 4
    a = tlog.v_create(L, cap, 8, "cpu")
    b = tlog.v_create(L, cap, 8, "cpu")
    j = jax.vmap(lambda _: jlog.create(cap, 8))(jnp.arange(L))
    for n in sizes:
        rows = rng.randint(-9, 9, (L, n, 8)).astype(np.int32)
        a = tlog.v_append_full(a, torch.from_numpy(rows))
        b = tlog.v_append(b, torch.from_numpy(rows),
                          torch.full((L,), n, dtype=torch.int32))
        j = jlog.v_append_full(j, jnp.asarray(rows))
    assert torch.equal(a.rows, b.rows) and torch.equal(a.head, b.head)
    _eq(j, a)


def test_single_log_append_full_matches_append_and_reference():
    # The single-log forms over a 32-row ring: 7 appends wrap it twice.
    rng = np.random.RandomState(8)
    a = tlog.create(32, 4, "cpu")
    b = tlog.create(32, 4, "cpu")
    j = jlog.create(32, 4)
    for n in (5, 11, 3, 17, 9, 13, 2):
        rows = rng.randint(-9, 9, (n, 8)).astype(np.int32)
        a = tlog.append_full(a, torch.from_numpy(rows))
        b = tlog.append(b, torch.from_numpy(rows), n)
        j = jlog.append_full(j, jnp.asarray(rows))
    assert int(a.head) == 60
    assert torch.equal(a.rows, b.rows) and torch.equal(a.head, b.head)
    _eq(j, a)


def test_log_lifecycle_matches_reference():
    rng = np.random.RandomState(5)
    t = tlog.create(32, 4, "cpu")
    j = jlog.create(32, 4)
    for e in range(6):
        t, j = tlog.start_epoch(t, e), jlog.start_epoch(j, e)
        n = int(rng.randint(1, 9))
        rows = rng.randint(-5, 5, (10, 8)).astype(np.int32)
        t = tlog.append(t, torch.from_numpy(rows), n)
        j = jlog.append(j, jnp.asarray(rows), n)
        if e >= 2:
            t, j = tlog.truncate(t, e - 2), jlog.truncate(j, e - 2)
        _eq(j, t)
        for frm in (0, e):
            tb, tc, ts = tlog.get_determinants(t, frm, 16)
            jb, jc, js = jlog.get_determinants(j, frm, 16)
            _eq((jb, jc, js), (tb, tc, ts))
        assert bool(tlog.overflowed(t)) == bool(jlog.overflowed(j))


def test_inflight_ring_matches_reference():
    rng = np.random.RandomState(7)
    S, P, cap = 8, 2, 5
    t = tifl.create(S, P, cap, 4, "cpu")
    j = jifl.create(S, P, cap, 4)
    for e in range(5):
        t, j = tifl.start_epoch(t, e), jifl.start_epoch(j, e)
        K = int(rng.randint(1, 5))
        shape = (K, P, cap)
        arrs = (rng.randint(-9, 9, shape).astype(np.int32),
                rng.randint(-9, 9, shape).astype(np.int32),
                rng.randint(0, 9, shape).astype(np.int32),
                rng.rand(*shape) < 0.6)
        t = tifl.append_block(t, TRB(*(torch.from_numpy(x) for x in arrs)))
        j = jifl.append_block(j, JRB(*(jnp.asarray(x) for x in arrs)))
        if e >= 1:
            t, j = tifl.truncate(t, e - 1), jifl.truncate(j, e - 1)
        _eq(j, t)
        assert bool(tifl.overflowed(t)) == bool(jifl.overflowed(j))
        for start in (int(j.head) - 6, int(j.tail) - 1, int(j.head) - 1):
            _eq(jifl.slice_steps_at(j, start, 4),
                tifl.slice_steps_at(t, start, 4))
            _eq(jifl.slice_steps(j, start, 4),
                tifl.slice_steps(t, start, 4))


@pytest.mark.parametrize("depth,factor", [(-1, -1), (1, -1), (-1, 1)])
def test_replication_plan_and_replicas_match_reference(depth, factor):
    def build(env_cls):
        env = env_cls(num_key_groups=16, sharing_depth=depth)
        (env.synthetic_source(vocab=9, batch_size=4, parallelism=2)
            .key_by().window_count(num_keys=9, window_size=5,
                                   parallelism=3)
            .key_by().reduce(num_keys=9).sink())
        return env.build()
    pj = jrep.ReplicationPlan.from_job(build(JEnv), depth, factor)
    pt = trep.ReplicationPlan.from_job(build(TEnv), depth, factor)
    assert pt.pairs == pj.pairs and pt.num_subtasks == pj.num_subtasks
    for f in range(pt.num_subtasks):
        assert pt.replicas_held_by(f) == pj.replicas_held_by(f)
        assert pt.replicas_of(f) == pj.replicas_of(f)
    np.testing.assert_array_equal(pt.owner_index("cpu").numpy(),
                                  np.asarray(pj.owner_index()))
    rt = trep.sync_replica_epochs(trep.create_replicas(pt, 64, 4, "cpu"), 2)
    rj = jrep.sync_replica_epochs(jrep.create_replicas(pj, 64, 4), 2)
    _eq(rj, rt)
    rows = [(np.arange(16, dtype=np.int32).reshape(2, 8), 4),
            (np.arange(8, 40, dtype=np.int32).reshape(4, 8), 5)]
    mt = trep.merge_determinant_responses(rows)
    mj = jrep.merge_determinant_responses(rows)
    np.testing.assert_array_equal(mt[0], mj[0])
    assert mt[1] == mj[1]
