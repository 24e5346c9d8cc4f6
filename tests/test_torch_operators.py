"""PyTorch port, operators: the five main-path operators' ``process_block``
(and per-step ``process``) are bit-identical to the reference's on the
same seeded inputs, with window fires inside the block; the reduce's
static-keys fast path equals its dynamic form. Tolerance: exact (int32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.api import operators as jo
from clonos_tpu.api.records import RecordBatch as JRB
from clonos_tpu.parallel import routing as jr
from clonos_tpu_torch.api import operators as to
from clonos_tpu_torch.api.records import RecordBatch as TRB
from clonos_tpu_torch.parallel import routing as tr

K, P, B, NK = 12, 3, 16, 13


def _inputs(seed, shape=(K, P, B), nk=NK):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, nk, shape).astype(np.int32)
    vals = rng.randint(-20, 60, shape).astype(np.int32)
    ts = rng.randint(0, 99, shape).astype(np.int32)
    valid = rng.rand(*shape) < 0.75
    keys, vals, ts = (np.where(valid, x, 0) for x in (keys, vals, ts))
    times = np.cumsum(rng.randint(0, 9, shape[0])).astype(np.int32) + 3
    rngs = rng.randint(0, 2 ** 31, shape[0]).astype(np.int32)
    return (keys, vals, ts, valid), times, rngs


def _jax_args(arrs, times, rngs, p):
    b = JRB(*(jnp.asarray(x) for x in arrs))
    ctx = jo.BlockContext(times=jnp.asarray(times), rng_bits=jnp.asarray(rngs),
                          epoch=jnp.asarray(0, jnp.int32),
                          step0=jnp.asarray(0, jnp.int32),
                          subtask=jnp.arange(p, dtype=jnp.int32))
    return b, ctx


def _torch_args(arrs, times, rngs, p):
    b = TRB(*(torch.from_numpy(x) for x in arrs))
    ctx = to.BlockContext(times=torch.from_numpy(times),
                          rng_bits=torch.from_numpy(rngs),
                          epoch=torch.tensor(0, dtype=torch.int32),
                          step0=torch.tensor(0, dtype=torch.int32),
                          subtask=torch.arange(p, dtype=torch.int32))
    return b, ctx


def _eq(a, b):
    if isinstance(b, torch.Tensor):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _eq(a[k], b[k])
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)


def _state_from(jstate):
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


def _pairs():
    return [
        ("window", jo.TumblingWindowCountOperator(num_keys=NK,
                                                  window_size=10),
         to.TumblingWindowCountOperator(num_keys=NK, window_size=10)),
        ("reduce", jo.KeyedReduceOperator(num_keys=NK),
         to.KeyedReduceOperator(num_keys=NK)),
        ("source", jo.SyntheticSource(vocab=NK, batch_size=B),
         to.SyntheticSource(vocab=NK, batch_size=B)),
        ("source-rate", jo.SyntheticSource(vocab=NK, batch_size=B,
                                           rate_limit=5),
         to.SyntheticSource(vocab=NK, batch_size=B, rate_limit=5)),
        ("sink", jo.SinkOperator(), to.SinkOperator()),
        ("map", jo.MapOperator(lambda k, v, t: (k, v * 3 + 1, t)),
         to.MapOperator(lambda k, v, t: (k, v * 3 + 1, t))),
        ("filter", jo.FilterOperator(lambda k, v, t: v > 10),
         to.FilterOperator(lambda k, v, t: v > 10)),
    ]


@pytest.mark.parametrize("name", [n for n, _, _ in _pairs()])
def test_process_block_matches_reference(name):
    _, jop, top = next(p for p in _pairs() if p[0] == name)
    arrs, times, rngs = _inputs(11)
    jst = jop.init_state(P)
    if name == "window":
        jst = {"acc": jnp.asarray(np.random.RandomState(1).randint(
            0, 5, (P, NK)), jnp.int32), "window": jnp.zeros((P,), jnp.int32)}
    if name == "reduce":
        jst = {"acc": jnp.asarray(np.random.RandomState(2).randint(
            -9, 9, (P, NK)), jnp.int32)}
    tst = _state_from(jst) if jst else top.init_state(P, "cpu")
    jb, jctx = _jax_args(arrs, times, rngs, P)
    tb, tctx = _torch_args(arrs, times, rngs, P)
    js, jout = jop.process_block(jst, jb, jctx)
    ts, tout = top.process_block(tst, tb, tctx)
    _eq(js, ts)
    _eq(jout, tout)
    if name == "window":
        assert bool(tout.valid.any())          # a window fired in-block
    # per-step form, one step
    js1, jout1 = jop.process(jst, JRB(*(x[0] for x in jb)), jctx.at_step(0))
    ts1, tout1 = top.process(tst, TRB(*(x[0] for x in tb)), tctx.at_step(0))
    _eq(js1, ts1)
    _eq(jout1, tout1)


def test_block_equals_stepwise_in_port():
    for _, _, top in _pairs():
        arrs, times, rngs = _inputs(21)
        tb, tctx = _torch_args(arrs, times, rngs, P)
        st0 = top.init_state(P, "cpu")
        sb, ob = top.process_block(st0, tb, tctx)
        ss, os_ = to.Operator.process_block(top, st0, tb, tctx)
        _eq(tuple(x.numpy() for x in os_), ob)
        _eq({k: v.numpy() for k, v in dict(ss).items()}, dict(sb))


def test_reduce_static_keys_equals_dynamic_and_reference():
    slot_keys = np.arange(37, dtype=np.int32)
    plan = tr.plan_static_hash(slot_keys, 3, 2, 16,
                               tr.static_hash_capacity(slot_keys, 3, 2, 16))
    arrs, times, rngs = _inputs(31, (K, 3, 37), nk=37)
    # A statically keyed producer: slot i carries key i.
    arrs = (np.where(arrs[3], slot_keys[None, None, :], 0).astype(np.int32),
            ) + arrs[1:]
    tb, tctx = _torch_args(arrs, times, rngs, 3)
    routed, _ = plan.apply(tb)
    _, tctx2 = _torch_args(arrs, times, rngs, 2)
    op = to.KeyedReduceOperator(num_keys=37)
    st = op.init_state(2, "cpu")
    s1, o1 = op.process_block_static_keys(st, routed, tctx2, plan.slot_keys)
    s2, o2 = op.process_block(st, routed, tctx2)
    _eq({k: v.numpy() for k, v in s2.items()}, s1)
    _eq(tuple(x.numpy() for x in o2), o1)
    jplan = jr.plan_static_hash(slot_keys, 3, 2, 16, plan.src_p.shape[1])
    jb, _ = _jax_args(arrs, times, rngs, 3)
    jrouted, _ = jplan.apply(jb)
    _, jctx2 = _jax_args(arrs, times, rngs, 2)
    jop = jo.KeyedReduceOperator(num_keys=37)
    js, jout = jop.process_block_static_keys(jop.init_state(2), jrouted,
                                             jctx2, jplan.slot_keys)
    _eq(js, s1)
    _eq(jout, o1)


def test_source_keys_past_int32_wrap_match_reference():
    # seq * SUBTASK_STRIDE overflows int32 once seq passes 2**31 / 1024.
    arrs, times, rngs = _inputs(41, (4, P, B))
    seq0 = np.array([2 ** 21 + 5, 2 ** 30, 2 ** 31 - 40], np.int32)
    jop = jo.SyntheticSource(vocab=997, batch_size=B)
    top = to.SyntheticSource(vocab=997, batch_size=B)
    jb, jctx = _jax_args(arrs, times, rngs, P)
    tb, tctx = _torch_args(arrs, times, rngs, P)
    js, jout = jop.process_block({"seq": jnp.asarray(seq0)}, jb, jctx)
    ts, tout = top.process_block({"seq": torch.from_numpy(seq0)}, tb, tctx)
    _eq(js, ts)
    _eq(jout, tout)


def test_negative_window_ids_floor_like_reference():
    # Floor division of negative causal times (torch // floors, as jnp).
    arrs, _, rngs = _inputs(51)
    times = np.linspace(-95, 40, K).astype(np.int32)
    jop = jo.TumblingWindowCountOperator(num_keys=NK, window_size=7)
    top = to.TumblingWindowCountOperator(num_keys=NK, window_size=7)
    w0 = np.array([-20, -14, -3], np.int32)
    jst = {"acc": jnp.zeros((P, NK), jnp.int32), "window": jnp.asarray(w0)}
    jb, jctx = _jax_args(arrs, times, rngs, P)
    tb, tctx = _torch_args(arrs, times, rngs, P)
    js, jout = jop.process_block(jst, jb, jctx)
    ts, tout = top.process_block(_state_from(jst), tb, tctx)
    _eq(js, ts)
    _eq(jout, tout)


@pytest.mark.parametrize("capacity", [None, 9])
def test_records_helpers_match_reference(capacity):
    from clonos_tpu.api import records as jrec
    from clonos_tpu_torch.api import records as trec
    rng = np.random.RandomState(21)
    keys = rng.randint(-5, 50, (3, 7)).astype(np.int32)
    vals = rng.randint(-9, 9, (3, 7)).astype(np.int32)
    j = jrec.make(keys, vals, capacity=capacity)
    t = trec.make(keys, vals, capacity=capacity, device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t.count().numpy(), np.asarray(j.count()))
    # zero_invalid on a batch with garbage under its invalid slots
    masked = t._replace(valid=t.valid & torch.from_numpy(
        rng.rand(*t.valid.shape) < 0.5))
    jm = JRB(*(jnp.asarray(x.numpy()) for x in masked))
    for a, b in zip(jrec.zero_invalid(jm), trec.zero_invalid(masked)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    je, te = jrec.empty((2, 4)), trec.empty((2, 4), "cpu")
    for a, b in zip(je, te):
        assert str(b.dtype) == f"torch.{np.asarray(a).dtype}"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        trec.make(keys, capacity=3, device="cpu")
