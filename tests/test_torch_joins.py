"""PyTorch port, two-input operators: the union's and the interval join's
``process2`` and ``process_block`` (the join's grouped block form, and its
step-loop fallback) are bit-identical to the reference's on the same
seeded inputs and to the port's own ``process2`` loop; a join job, a
union job and a connected join + source failure each recover on the CPU
equal to a golden port run and to the reference's faulted run.
Tolerance: exact (int32/bool)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.api import operators as jo
from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.api.records import RecordBatch as JRB
from clonos_tpu.runtime import executor as jex
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch.api import operators as to
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.api.records import RecordBatch as TRB
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves


def _side(rng, K, P, B, nk, fill=0.7):
    keys = rng.randint(-1, nk + 1, (K, P, B)).astype(np.int32)
    vals = rng.randint(-50, 50, (K, P, B)).astype(np.int32)
    ts = (np.arange(K)[:, None, None] * 3
          + rng.randint(-4, 5, (K, P, B))).astype(np.int32)
    valid = rng.rand(K, P, B) < fill
    keys, vals, ts = (np.where(valid, x, 0) for x in (keys, vals, ts))
    return keys, vals, ts, valid


def _ctxs(K, P):
    jc = jo.BlockContext(times=jnp.arange(K, dtype=jnp.int32),
                         rng_bits=jnp.zeros((K,), jnp.int32),
                         epoch=jnp.zeros((), jnp.int32),
                         step0=jnp.zeros((), jnp.int32),
                         subtask=jnp.arange(P, dtype=jnp.int32))
    tc = to.BlockContext(times=torch.arange(K, dtype=torch.int32),
                         rng_bits=torch.zeros((K,), dtype=torch.int32),
                         epoch=torch.zeros((), dtype=torch.int32),
                         step0=torch.zeros((), dtype=torch.int32),
                         subtask=torch.arange(P, dtype=torch.int32))
    return jc, tc


def _eq(a, b, what):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and b.shape == a.shape, what
        np.testing.assert_array_equal(b.numpy(), a, err_msg=what)


def _j(arrs):
    return JRB(*(jnp.asarray(x) for x in arrs))


def _t(arrs):
    return TRB(*(torch.from_numpy(np.ascontiguousarray(x)) for x in arrs))


JOINS = [dict(num_keys=7, window=4, interval=5, capacity=16),
         dict(num_keys=7, window=3, interval=1 << 30, capacity=8),
         dict(num_keys=5, window=2, interval=2, capacity=40)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", JOINS, ids=["w4", "w3-wide", "w2-cap40"])
def test_join_process2_equals_reference(kw, seed):
    rng = np.random.RandomState(seed)
    K, P, B = 6, 2, 8
    left, right = _side(rng, K, P, B, kw["num_keys"]), \
        _side(rng, K, P, B + 2, kw["num_keys"])
    jop, top = jo.IntervalJoinOperator(**kw), to.IntervalJoinOperator(**kw)
    jc, tc = _ctxs(K, P)
    js, ts_ = jop.init_state(P), top.init_state(P, "cpu")
    for k in range(K):
        js, jout = jop.process2(js, _j(x[k] for x in left),
                                _j(x[k] for x in right), jc.at_step(k))
        ts_, tout = top.process2(ts_, _t(x[k] for x in left),
                                 _t(x[k] for x in right), tc.at_step(k))
        _eq(js, ts_, f"step {k} state")
        _eq(tuple(jout), tuple(tout), f"step {k} out")


@pytest.mark.parametrize("K", [1, 6, 7, 12])
@pytest.mark.parametrize("kw", JOINS, ids=["w4", "w3-wide", "w2-cap40"])
def test_join_grouped_block_equals_reference_and_step_loop(kw, K):
    rng = np.random.RandomState(K)
    P, B = 2, 8
    left, right = _side(rng, K, P, B, kw["num_keys"]), \
        _side(rng, K, P, B, kw["num_keys"])
    jop, top = jo.IntervalJoinOperator(**kw), to.IntervalJoinOperator(**kw)
    jc, tc = _ctxs(K, P)
    # Warm state: a block first, so the carried rings are non-trivial.
    js, _ = jop.process_block(jop.init_state(P), (_j(left), _j(right)), jc)
    ts_, _ = top.process_block(top.init_state(P, "cpu"),
                               (_t(left), _t(right)), tc)
    _eq(js, ts_, "warm state")
    left2, right2 = _side(rng, K, P, B, kw["num_keys"]), \
        _side(rng, K, P, B, kw["num_keys"])
    jst, jout = jop.process_block(js, (_j(left2), _j(right2)), jc)
    tst, tout = top.process_block(ts_, (_t(left2), _t(right2)), tc)
    _eq(jst, tst, "block state")
    _eq(tuple(jout), tuple(tout), "block out")
    assert top.group_size(K, P, B) == (K if K < 64 else None)
    lst, lout = to.TwoInputOperator.process_block(
        top, ts_, (_t(left2), _t(right2)), tc)
    _eq(tuple(x.numpy() for x in tree_leaves(tst)), tree_leaves(lst),
        "grouped vs loop state")
    _eq(tuple(x.numpy() for x in tout), tuple(lout), "grouped vs loop out")


def test_join_several_groups_equals_reference():
    """A block longer than the 64-step group cap: G = 64 < K, so the
    block runs as two groups."""
    kw = JOINS[0]
    rng = np.random.RandomState(3)
    K, P, B = 128, 2, 8
    left, right = _side(rng, K, P, B, 7), _side(rng, K, P, B, 7)
    top = to.IntervalJoinOperator(**kw)
    assert top.group_size(K, P, B) == 64
    jop = jo.IntervalJoinOperator(**kw)
    jc, tc = _ctxs(K, P)
    jst, jout = jop.process_block(jop.init_state(P), (_j(left), _j(right)),
                                  jc)
    tst, tout = top.process_block(top.init_state(P, "cpu"),
                                  (_t(left), _t(right)), tc)
    _eq(jst, tst, "state")
    _eq(tuple(jout), tuple(tout), "out")


@pytest.mark.parametrize("cap", [3, 8, 30])
def test_union_equals_reference(cap):
    rng = np.random.RandomState(cap)
    K, P = 5, 3
    left, right = _side(rng, K, P, 6, 9), _side(rng, K, P, 10, 9, fill=0.5)
    jop, top = jo.UnionOperator(capacity=cap), to.UnionOperator(capacity=cap)
    jc, tc = _ctxs(K, P)
    _, jout = jop.process_block((), (_j(left), _j(right)), jc)
    _, tout = top.process_block((), (_t(left), _t(right)), tc)
    _eq(tuple(jout), tuple(tout), "block")
    for k in range(K):
        _, jo2 = jop.process2((), _j(x[k] for x in left),
                              _j(x[k] for x in right), jc.at_step(k))
        _, to2 = top.process2((), _t(x[k] for x in left),
                              _t(x[k] for x in right), tc.at_step(k))
        _eq(tuple(jo2), tuple(to2), f"step {k}")


def _join_job(env_cls, parallelism=2):
    env = env_cls(name="nexmark-ish", num_key_groups=16,
                  default_edge_capacity=32)
    auctions = env.synthetic_source(vocab=7, batch_size=4,
                                    parallelism=parallelism, name="auctions")
    bids = env.synthetic_source(vocab=7, batch_size=4,
                                parallelism=parallelism, name="bids")
    auctions.key_by().join(bids.key_by(), num_keys=7, window=8,
                           interval=1 << 30, name="join").sink()
    return env.build()


def _union_job(env_cls):
    env = env_cls(name="union", num_key_groups=16, default_edge_capacity=16)
    a = env.synthetic_source(vocab=9, batch_size=4, parallelism=2, name="a")
    b = env.synthetic_source(vocab=9, batch_size=3, parallelism=2, name="b")
    (a.union(b, capacity=12).key_by()
        .window_count(num_keys=9, window_size=40).sink())
    return env.build()


TIMES = list(range(0, 400, 10))


def _drive(r, epochs=1, steps=2):
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    for _ in range(epochs):
        r.run_epoch()
    for _ in range(steps):
        r.step()
    return r


def _leaves(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


def _three(job, kill, **kw):
    kw = dict(dict(steps_per_epoch=3, seed=5), **kw)
    golden = _drive(ClusterRunner(job(StreamEnvironment), device="cpu", **kw))
    port = _drive(ClusterRunner(job(StreamEnvironment), device="cpu", **kw))
    ref = _drive(JaxRunner(job(JaxEnv), heartbeat_timeout_s=600.0, **kw))
    port.inject_failure(kill)
    ref.inject_failure(kill)
    rep, jrep = port.recover(), ref.recover()
    for f in ("steps_replayed", "records_replayed", "determinants_replayed"):
        assert getattr(rep, f) == getattr(jrep, f), f
    for i, (a, b, c) in enumerate(zip(_leaves(golden), _leaves(port),
                                      _leaves(ref, True))):
        np.testing.assert_array_equal(b, a, err_msg=f"golden leaf {i}")
        np.testing.assert_array_equal(b, c, err_msg=f"reference leaf {i}")
    golden.step()
    port.step()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)
    return rep


@pytest.mark.parametrize("kill", [[5], [4, 5], [1, 4], [2, 5, 7]],
                         ids=["join", "join-pair", "source+join",
                              "right-source+join+sink"])
def test_join_job_recovers_like_golden_and_reference(kill):
    rep = _three(_join_job, kill)
    assert rep.steps_replayed == 2


@pytest.mark.parametrize("kill", [[4], [5, 7], [0, 4]],
                         ids=["union", "union+window", "source+union"])
def test_union_job_recovers_like_golden_and_reference(kill):
    rep = _three(_union_job, kill)
    assert rep.steps_replayed == 2


def test_join_recovers_across_a_pending_checkpoint():
    """Two rings' worth of replay (1 completed + 1 pending epoch + 2
    steps) through both input edges, the grouped block form on replay."""
    kw = dict(steps_per_epoch=3, seed=5, inflight_ring_steps=16)
    golden, port = (ClusterRunner(_join_job(StreamEnvironment),
                                  device="cpu", **kw) for _ in range(2))
    ref = JaxRunner(_join_job(JaxEnv), heartbeat_timeout_s=600.0, **kw)
    for r in (golden, port, ref):
        r.executor.time_source.now = lambda it=iter(TIMES): next(it)
        r.run_epoch()
        r.run_epoch(complete_checkpoint=False)
        r.step()
    port.inject_failure([4])
    ref.inject_failure([4])
    rep, jrep = port.recover(), ref.recover()
    assert rep.steps_replayed == jrep.steps_replayed == 4
    assert rep.ignored_checkpoints == jrep.ignored_checkpoints == (1,)
    for a, b in zip(_leaves(port), _leaves(ref, True)):
        np.testing.assert_array_equal(a, b)
