"""PyTorch port, event-time windows: the tumbling, sliding and session
operators' ``process`` and ``process_block`` are bit-identical to the
reference's on the same seeded inputs (negative timestamps, late records,
int32 sentinels included), the reference's oracle cases hold on the port,
and an event-time window job recovers on the CPU equal to a golden port
run and to the reference's faulted run. Tolerance: exact (int32)."""

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


def _pairs():
    return [
        ("tumbling", dict(num_keys=5, window_size=8, out_of_orderness=6),
         jo.EventTimeTumblingWindowOperator,
         to.EventTimeTumblingWindowOperator),
        ("tumbling-tight", dict(num_keys=5, window_size=10,
                                out_of_orderness=0),
         jo.EventTimeTumblingWindowOperator,
         to.EventTimeTumblingWindowOperator),
        ("sliding", dict(num_keys=5, window_size=8, slide=4,
                         out_of_orderness=6),
         jo.SlidingEventTimeWindowOperator, to.SlidingEventTimeWindowOperator),
        ("sliding-wide", dict(num_keys=5, window_size=12, slide=3,
                              out_of_orderness=2),
         jo.SlidingEventTimeWindowOperator, to.SlidingEventTimeWindowOperator),
        ("session", dict(num_keys=5, gap=6, out_of_orderness=4),
         jo.SessionWindowOperator, to.SessionWindowOperator),
        ("session-tight", dict(num_keys=5, gap=3, out_of_orderness=0),
         jo.SessionWindowOperator, to.SessionWindowOperator),
    ]


def _inputs(seed, K=9, P=2, B=8, nk=5, lo=-40):
    """Mostly increasing event times with bounded disorder, negative ones
    among them, a few stragglers far behind, and an all-invalid step."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(-1, nk + 1, (K, P, B)).astype(np.int32)
    vals = rng.randint(-3, 5, (K, P, B)).astype(np.int32)
    ts = (np.sort(rng.randint(lo, 80, (K, P, B)), axis=0)
          + rng.randint(-5, 5, (K, P, B))).astype(np.int32)
    ts[rng.rand(K, P, B) < 0.1] -= 60
    valid = rng.rand(K, P, B) < 0.8
    valid[2] = False
    keys, vals, ts = (np.where(valid, x, 0) for x in (keys, vals, ts))
    return keys, vals, ts, valid


def _eq(a, b, what):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _eq(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert b.numpy().dtype == np.asarray(a).dtype, what
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=what)


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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,kw,jcls,tcls", _pairs(),
                         ids=[p[0] for p in _pairs()])
def test_process_steps_equal_reference(name, kw, jcls, tcls, seed):
    arrs = _inputs(seed)
    K, P = arrs[0].shape[:2]
    jop, top = jcls(**kw), tcls(**kw)
    jc, tc = _ctxs(K, P)
    js, ts_ = jop.init_state(P), top.init_state(P, "cpu")
    _eq(js, ts_, f"{name} init")
    for k in range(K):
        js, jout = jop.process(js, JRB(*(jnp.asarray(x[k]) for x in arrs)),
                               jc.at_step(k))
        ts_, tout = top.process(ts_, TRB(*(torch.from_numpy(x[k])
                                           for x in arrs)), tc.at_step(k))
        _eq(js, ts_, f"{name} step {k} state")
        _eq(tuple(jout), tuple(tout), f"{name} step {k} out")


@pytest.mark.parametrize("name,kw,jcls,tcls", _pairs(),
                         ids=[p[0] for p in _pairs()])
def test_process_block_equals_reference(name, kw, jcls, tcls):
    arrs = _inputs(7, K=6, P=3, B=6)
    K, P = arrs[0].shape[:2]
    jop, top = jcls(**kw), tcls(**kw)
    jc, tc = _ctxs(K, P)
    jst, jout = jop.process_block(jop.init_state(P),
                                  JRB(*(jnp.asarray(x) for x in arrs)), jc)
    tst, tout = top.process_block(top.init_state(P, "cpu"),
                                  TRB(*(torch.from_numpy(x) for x in arrs)),
                                  tc)
    _eq(jst, tst, f"{name} block state")
    _eq(tuple(jout), tuple(tout), f"{name} block out")


def _run_steps(op, steps):
    state = op.init_state(1, "cpu")
    fired = []
    _, tc = _ctxs(1, 1)
    for recs in steps:
        keys = np.zeros((1, 8), np.int32)
        vals, ts = keys.copy(), keys.copy()
        valid = np.zeros((1, 8), bool)
        for j, (k, v, t) in enumerate(recs):
            keys[0, j], vals[0, j], ts[0, j], valid[0, j] = k, v, t, True
        state, out = op.process(state, TRB(*(torch.from_numpy(x) for x in
                                             (keys, vals, ts, valid))),
                                tc.at_step(0))
        m = out.valid[0]
        fired += [tuple(int(x) for x in r) for r in zip(
            out.keys[0][m], out.values[0][m], out.timestamps[0][m])]
    return state, fired


def test_oracle_cases_hold_on_the_port():
    """The reference's semantics cases (tests/test_event_time.py)."""
    op = to.EventTimeTumblingWindowOperator(num_keys=4, window_size=10,
                                            out_of_orderness=5)
    state, fired = _run_steps(op, [[(1, 2, 3), (2, 1, 7)], [(1, 1, 12)],
                                   [(1, 1, 9)], [(2, 5, 21)], [(3, 1, 40)]])
    assert {(1, 3, 10), (2, 1, 10), (1, 1, 20), (2, 5, 30)} <= set(fired)
    assert int(state["late"][0]) == 0
    op = to.EventTimeTumblingWindowOperator(num_keys=4, window_size=10)
    state, fired = _run_steps(op, [[(1, 1, 5)], [(1, 1, 25)], [(1, 9, 3)]])
    assert int(state["late"][0]) == 1 and (1, 1, 10) in fired
    state, fired = _run_steps(op, [[(1, 7, -10)], [(2, 1, 50)]])
    assert (1, 7, 0) in fired                      # floor of negatives
    op = to.SlidingEventTimeWindowOperator(num_keys=4, window_size=20,
                                           slide=10)
    _, fired = _run_steps(op, [[(1, 1, 5)], [(1, 2, 15)], [(1, 4, 42)]])
    assert {(1, 1, 10), (1, 3, 20), (1, 2, 30)} <= set(fired)
    op = to.SessionWindowOperator(num_keys=4, gap=10)
    _, fired = _run_steps(op, [[(1, 1, 0), (1, 2, 5)], [(1, 3, 12)],
                               [(2, 1, 40)]])
    assert (1, 6, 22) in fired
    state, fired = _run_steps(op, [[(1, 1, 50)], [(1, 2, 95)],
                                   [(2, 1, 200)]])
    assert (1, 1, 60) in fired and (1, 2, 105) in fired
    state, fired = _run_steps(op, [[(1, 0, 0)], [(2, 1, 100)],
                                   [(1, 5, 200)], [(2, 1, 300)]])
    assert (1, 5, 210) in fired and int(state["late"][0]) == 0


def _job(env_cls, kind):
    env = env_cls(name="evt", num_key_groups=16)
    s = env.synthetic_source(vocab=19, batch_size=6, parallelism=2).key_by()
    if kind == "tumbling":
        s = s.window_event_time(num_keys=19, window_size=64,
                                out_of_orderness=16)
    elif kind == "sliding":
        s = s.window_slide_event_time(num_keys=19, window_size=64, slide=16,
                                      out_of_orderness=16)
    else:
        s = s.window_session(num_keys=19, gap=16)
    s.sink()
    return env.build()


def _leaves(runner, ref=False):
    if ref:
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(jex.canonical_carry(runner.executor.carry)))]
    return tree_leaves(carry_to_numpy(
        tex.canonical_carry(runner.executor.carry)))


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "session"])
def test_event_time_job_recovers_like_golden_and_reference(kind):
    def drive(r):
        r.executor.time_source.now = \
            lambda it=iter(range(0, 4000, 20)): next(it)
        r.run_epoch()
        r.step()
        r.step()
        return r

    golden = drive(ClusterRunner(_job(StreamEnvironment, kind),
                                 steps_per_epoch=3, seed=3, device="cpu"))
    port = drive(ClusterRunner(_job(StreamEnvironment, kind),
                               steps_per_epoch=3, seed=3, device="cpu"))
    ref = drive(JaxRunner(_job(JaxEnv, kind), steps_per_epoch=3, seed=3,
                          heartbeat_timeout_s=600.0))
    port.inject_failure([3])                   # window subtask 1
    ref.inject_failure([3])
    rep = port.recover()
    jrep = ref.recover()
    assert rep.steps_replayed == jrep.steps_replayed == 2
    assert rep.records_replayed == jrep.records_replayed
    for a, b, c in zip(_leaves(golden), _leaves(port), _leaves(ref, True)):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    golden.step()
    port.step()
    for a, b in zip(_leaves(golden), _leaves(port)):
        np.testing.assert_array_equal(b, a)
