"""PyTorch port, the API tail: ``graph/vertex_info.py`` (every case of
``tests/test_graph_info.py``, on the port's copy and against the
reference's), ``api/records.to_numpy``, ``inflight/log.append_step``,
``causal/log.stack_logs``/``unstack_logs`` and
``LocalExecutor.plan_replicas_overflowed``, each held to the reference on
seeded inputs. Tolerance: exact (int32/bool)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clonos_tpu.api import records as jrec
from clonos_tpu.causal import log as jlog
from clonos_tpu.graph import vertex_info as jvi
from clonos_tpu.inflight import log as jifl
from clonos_tpu_torch.api import records as trec
from clonos_tpu_torch.causal import log as tlog
from clonos_tpu_torch.graph.vertex_info import (
    UNREACHABLE, CausalLogID, VertexGraphInformation, compute_distances)
from clonos_tpu_torch.inflight import log as tifl
from clonos_tpu_torch.utils.tree import tree_leaves


def _eq(ref, port):
    la, lb = jax.tree_util.tree_leaves(ref), tree_leaves(port)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def diamond():
    # 0 -> 1 -> 3, 0 -> 2 -> 3
    return 4, [(0, 1), (0, 2), (1, 3), (2, 3)]


def test_distances_diamond():
    n, edges = diamond()
    d = compute_distances(n, edges)
    assert d[0, 3] == 2 and d[0, 1] == 1 and d[1, 3] == 1
    assert d[3, 0] == UNREACHABLE  # directed
    assert d[1, 2] == UNREACHABLE
    assert (np.diag(d) == 0).all()
    info = VertexGraphInformation(0, n, tuple(edges), (1, 1, 1, 1))
    ref = jvi.VertexGraphInformation(0, n, tuple(edges), (1, 1, 1, 1))
    np.testing.assert_array_equal(info.distances(), ref.distances())
    np.testing.assert_array_equal(d, jvi.compute_distances(n, edges))


def test_upstream_downstream():
    n, edges = diamond()
    info = VertexGraphInformation(vertex=3, num_vertices=n,
                                  edges=tuple(edges), parallelism=(1, 2, 2, 1))
    assert info.upstream == (1, 2)
    assert info.downstream == ()
    for v in range(n):
        port = VertexGraphInformation(v, n, tuple(edges), (1, 2, 2, 1))
        ref = jvi.VertexGraphInformation(v, n, tuple(edges), (1, 2, 2, 1))
        assert (port.upstream, port.downstream) == (ref.upstream,
                                                    ref.downstream)


def test_logs_to_replicate_depth():
    n, edges = diamond()
    v3 = VertexGraphInformation(3, n, tuple(edges), (1, 1, 1, 1))
    assert v3.logs_to_replicate(sharing_depth=1) == frozenset({1, 2})
    assert v3.logs_to_replicate(sharing_depth=2) == frozenset({0, 1, 2})
    assert v3.logs_to_replicate(sharing_depth=-1) == frozenset({0, 1, 2})
    v1 = VertexGraphInformation(1, n, tuple(edges), (1, 1, 1, 1))
    assert v1.logs_to_replicate(sharing_depth=1) == frozenset({0})
    for v in range(n):
        for depth in (-1, 0, 1, 2, 3):
            assert VertexGraphInformation(
                v, n, tuple(edges), (1,) * n).logs_to_replicate(depth) == \
                jvi.VertexGraphInformation(
                    v, n, tuple(edges), (1,) * n).logs_to_replicate(depth)


def test_sharing_mask():
    n, edges = diamond()
    info = VertexGraphInformation(0, n, tuple(edges), (1, 1, 1, 1))
    m1 = info.sharing_mask(sharing_depth=1)
    # owner 0 replicated at holders 1,2 (distance 1) but not 3 (distance 2)
    assert m1[0, 1] and m1[0, 2] and not m1[0, 3]
    assert m1[0, 0] and m1[3, 3]  # self always
    mfull = info.sharing_mask(sharing_depth=-1)
    assert mfull[0, 3]
    assert not mfull[3, 0]  # never replicate upstream


def test_chain_depth_cut():
    # 0 -> 1 -> 2 -> 3 -> 4
    n, edges = 5, [(i, i + 1) for i in range(4)]
    info = VertexGraphInformation(4, n, tuple(edges), (1,) * 5)
    assert info.logs_to_replicate(2) == frozenset({2, 3})
    assert info.logs_to_replicate(-1) == frozenset({0, 1, 2, 3})


def test_causal_log_id():
    main = CausalLogID(vertex=2, subtask=1)
    assert main.is_main_thread()
    sp = main.for_subpartition(3)
    assert not sp.is_main_thread() and sp.subpartition == 3
    assert sorted([sp, main]) == [main, sp]
    ref = jvi.CausalLogID(vertex=2, subtask=1).for_subpartition(3)
    assert (sp.vertex, sp.subtask, sp.subpartition) == (
        ref.vertex, ref.subtask, ref.subpartition)


def _batch(rng, shape, p=0.6):
    keys = rng.randint(-50, 50, shape).astype(np.int32)
    vals = rng.randint(0, 1000, shape).astype(np.int32)
    ts = rng.randint(0, 99, shape).astype(np.int32)
    valid = rng.rand(*shape) < p
    return (jrec.RecordBatch(*(jnp.asarray(x) for x in (keys, vals, ts,
                                                         valid))),
            trec.RecordBatch(*(torch.from_numpy(x) for x in (keys, vals, ts,
                                                             valid))))


@pytest.mark.parametrize("shape", [(16,), (3, 8), (2, 3, 4)])
def test_to_numpy_equals_reference(shape):
    """The valid rows of a batch as (key, value, ts) tuples, flattened."""
    jb, tb = _batch(np.random.RandomState(sum(shape)), shape)
    assert trec.to_numpy(tb) == jrec.to_numpy(jb)


def test_append_step_equals_reference_across_a_wrap():
    """Six steps into a 4-step ring of 3 lanes, each step its own routed
    batch: every leaf after each append equals the reference's."""
    rng = np.random.RandomState(5)
    j = jifl.create(4, 3, 8, 8)
    t = tifl.create(4, 3, 8, 8, "cpu")
    for _ in range(6):
        jb, tb = _batch(rng, (3, 8))
        j = jifl.append_step(j, jb)
        t = tifl.append_step(t, tb)
        _eq(j, t)


def test_stack_and_unstack_logs_equal_reference():
    """Three logs filled with seeded rows, stacked and unstacked again."""
    rng = np.random.RandomState(9)
    js, ts = [], []
    for n in (3, 7, 1):
        rows = rng.randint(-9, 9, (n, 8)).astype(np.int32)
        js.append(jlog.append(jlog.create(16, 4), jnp.asarray(rows), n))
        ts.append(tlog.append(tlog.create(16, 4, "cpu"),
                              torch.from_numpy(rows), n))
    jst, tst = jlog.stack_logs(js), tlog.stack_logs(ts)
    _eq(jst, tst)
    for a, b in zip(jlog.unstack_logs(jst), tlog.unstack_logs(tst)):
        _eq(a, b)


def _job(env_cls):
    env = env_cls(name="replicas", num_key_groups=8,
                  default_edge_capacity=16)
    (env.synthetic_source(vocab=7, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=7, window_size=1 << 30)
        .sink())
    return env.build()


@pytest.mark.parametrize("epochs", [1, 6])
def test_plan_replicas_overflowed_equals_reference(epochs):
    """A 64-row log capacity: one epoch's rows fit, six un-truncated
    epochs' overflow the replica logs; the port reads what the reference
    reads."""
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.executor import LocalExecutor as JEx

    from clonos_tpu_torch.api.environment import StreamEnvironment as TEnv
    from clonos_tpu_torch.runtime.executor import LocalExecutor as TEx
    kw = dict(steps_per_epoch=4, log_capacity=64, max_epochs=16,
              inflight_ring_steps=32, seed=3)
    j, t = JEx(_job(JEnv), **kw), TEx(_job(TEnv), device="cpu", **kw)
    for _ in range(epochs):
        j.run_epoch()
        t.run_epoch()
    assert t.plan_replicas_overflowed() == j.plan_replicas_overflowed() \
        == (epochs > 1)
