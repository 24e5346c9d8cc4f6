"""PyTorch port, the host-side causal log and replication rounds (mirrors
of the reference's ``tests/test_causal_log.py`` and
``tests/test_replication.py``): ``ThreadCausalLog`` driven step for step
beside the reference's — append, start_epoch, truncate,
delta_for_consumer, determinants_from_epoch, merge_delta's dedup and gap,
rebase — with every state leaf equal after every operation;
``v_merge_delta``, ``replicate_step`` and ``collect_determinant_response``
against the reference's on the same stacked logs. Tolerance: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clonos_tpu.causal import determinant as jdet
from clonos_tpu.causal import log as jlog
from clonos_tpu.causal import replication as jrep
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.causal import replication as rep


def _rows(rng, n):
    return rng.randint(-50, 50, (n, det.NUM_LANES)).astype(np.int32)


def _assert_state(tl, jl, what):
    for name in clog.ThreadLogState._fields:
        a = getattr(tl.state, name)
        b = np.asarray(getattr(jl.state, name))
        assert a.dtype == torch.int32, (what, name)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{what}: {name}")


def _apply(log, op, args):
    if op == "append":
        return log.append_rows(args[0])
    if op == "start":
        return log.start_epoch(args[0])
    if op == "truncate":
        return log.notify_checkpoint_complete(args[0])
    if op == "merge":
        return log.merge_delta(args[0], args[1])
    if op == "delta":
        return log.delta_for_consumer(*args)
    if op == "from_epoch":
        return log.determinants_from_epoch(*args)
    raise ValueError(op)


def _random_script(seed, n_ops=60):
    rng = np.random.RandomState(seed)
    ops, epoch, head = [], 0, 0
    ops.append(("start", (0,)))
    for _ in range(n_ops):
        kind = rng.choice(["append", "start", "truncate", "merge", "delta",
                           "from_epoch"], p=[.3, .15, .1, .25, .1, .1])
        if kind == "append":
            n = int(rng.randint(0, 6))
            ops.append(("append", (_rows(rng, n),)))
            head += n
        elif kind == "start":
            epoch += 1
            ops.append(("start", (epoch,)))
        elif kind == "truncate":
            ops.append(("truncate", (int(rng.randint(0, epoch + 1)),)))
        elif kind == "merge":
            # overlapping, exact, stale and gapped starts
            start = int(head + rng.randint(-4, 3))
            n = int(rng.randint(0, 7))
            ops.append(("merge", (_rows(rng, n), max(start, 0))))
        elif kind == "delta":
            ops.append(("delta", (int(rng.randint(-2, head + 2)),
                                  int(rng.randint(0, 12)))))
        else:
            ops.append(("from_epoch", (int(rng.randint(0, epoch + 1)),
                                       int(rng.randint(1, 16)))))
    return ops


@pytest.mark.parametrize("seed,capacity,max_epochs",
                         [(0, 64, 8), (1, 16, 4), (2, 8, 4), (3, 32, 16)])
def test_thread_log_equals_reference_step_for_step(seed, capacity,
                                                   max_epochs):
    tl = clog.ThreadCausalLog(capacity, max_epochs, device="cpu")
    jl = jlog.ThreadCausalLog(capacity, max_epochs)
    for i, (op, args) in enumerate(_random_script(seed)):
        got = _apply(tl, op, args)
        want = _apply(jl, op, args)
        what = f"op {i} {op}"
        if op == "merge":
            assert got is want, what
        elif op == "delta":
            np.testing.assert_array_equal(got[0], want[0], err_msg=what)
            assert got[1] == want[1], what
        elif op == "from_epoch":
            np.testing.assert_array_equal(got, want, err_msg=what)
        _assert_state(tl, jl, what)
        assert (tl.head, tl.tail, len(tl)) == (jl.head, jl.tail, len(jl))
        assert bool(clog.overflowed(tl.state)) \
            == bool(jlog.overflowed(jl.state))
        assert bool(clog.epoch_index_overflowed(tl.state)) \
            == bool(jlog.epoch_index_overflowed(jl.state))


def _values(rows):
    return [d.value for d in det.unpack_batch(rows)]


def _rng_rows(values):
    return det.pack_batch([det.RNGDeterminant(value=v) for v in values])


def test_merge_delta_dedup_and_gap_equal_reference():
    tl = clog.ThreadCausalLog(64, 8, device="cpu")
    jl = jlog.ThreadCausalLog(64, 8)
    steps = [([1, 2, 3], 0, True), ([2, 3, 9], 1, True),
             ([1, 2], 0, True), ([9, 10], 5, False),
             ([3, 4, 5, 9, 10], 2, True)]
    for values, start, ok in steps:
        rows = _rng_rows(values)
        assert tl.merge_delta(rows, start) is ok
        assert jl.merge_delta(jdet.pack_batch(
            [jdet.RNGDeterminant(value=v) for v in values]), start) is ok
        _assert_state(tl, jl, f"merge {values}@{start}")
    assert tl.head == 7
    # the re-send from offset 2 appends only its rows past head 4
    assert _values(tl.determinants_from_epoch(0, 16)) == [1, 2, 3, 9, 5, 9,
                                                          10]


def test_rebase_and_append_one_equal_reference():
    tl = clog.ThreadCausalLog(8, 8, device="cpu")
    jl = jlog.ThreadCausalLog(8, 8)
    for log in (tl, jl):
        log.start_epoch(0)
        log.append_rows(_rng_rows([0, 1, 2, 3, 4]))
        log.start_epoch(1)
        log.notify_checkpoint_complete(0)
        log.append_rows(_rng_rows([10, 11, 12, 13]))
        log.start_epoch(2)
        log.append_rows(_rng_rows([20, 21]))
        log.notify_checkpoint_complete(1)
    before = _values(tl.determinants_from_epoch(2, 8))
    tl.state = clog.rebase(tl.state, 8)
    jl.state = jlog.rebase(jl.state, 8)
    _assert_state(tl, jl, "rebase")
    assert (tl.tail, tl.head) == (1, 3)
    assert _values(tl.determinants_from_epoch(2, 8)) == before == [20, 21]
    assert not bool(clog.near_offset_wrap(tl.state))
    row = _rng_rows([77])[0]
    tl.state = clog.append_one(tl.state, torch.from_numpy(row))
    jl.state = jlog.append_one(jl.state, jnp.asarray(row))
    _assert_state(tl, jl, "append_one")


def _stacked(n, capacity, max_epochs, rng, counts):
    """The same stacked logs in both packages: ``counts[l]`` seeded rows
    appended to log l, across two epochs."""
    t = clog.v_create(n, capacity, max_epochs, "cpu")
    j = jax.vmap(lambda _: jlog.create(capacity, max_epochs))(jnp.arange(n))
    t, j = clog.v_start_epoch(t, 0), jlog.v_start_epoch(j, 0)
    for e, part in enumerate((counts, counts[::-1])):
        m = max(part)
        rows = _rows(rng, n * m).reshape(n, m, det.NUM_LANES)
        cnt = np.asarray(part, np.int32)
        t = clog.v_append(t, torch.from_numpy(rows), torch.from_numpy(cnt))
        j = jlog.v_append(j, jnp.asarray(rows), jnp.asarray(cnt))
        t, j = clog.v_start_epoch(t, e + 1), jlog.v_start_epoch(j, e + 1)
    return t, j


def _assert_stacked(t, j, what):
    for name in clog.ThreadLogState._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=f"{what}: {name}")


def test_v_merge_delta_equals_reference_vmap():
    rng = np.random.RandomState(7)
    t, j = _stacked(4, 32, 8, rng, [3, 0, 5, 2])
    rows = _rows(rng, 4 * 6).reshape(4, 6, det.NUM_LANES)
    count = np.asarray([6, 2, 0, 4], np.int32)
    start = np.asarray([3, 0, 12, 9], np.int32)   # overlap, stale, gap, gap
    t2, tgap = clog.v_merge_delta(t, torch.from_numpy(rows),
                                  torch.from_numpy(count),
                                  torch.from_numpy(start))
    j2, jgap = jlog.v_merge_delta(j, jnp.asarray(rows), jnp.asarray(count),
                                  jnp.asarray(start))
    np.testing.assert_array_equal(tgap.numpy(), np.asarray(jgap))
    _assert_stacked(t2, j2, "v_merge_delta")


@pytest.mark.parametrize("max_delta", [16, 4, 1])
def test_replicate_step_equals_reference(max_delta):
    rng = np.random.RandomState(11)
    owners_t, owners_j = _stacked(3, 64, 8, rng, [5, 3, 0])
    reps_t = clog.v_create(4, 64, 8, "cpu")
    reps_j = jax.vmap(lambda _: jlog.create(64, 8))(jnp.arange(4))
    idx = np.asarray([0, 0, 1, 2], np.int32)
    for rnd in range(4):
        reps_t, lag_t = rep.replicate_step(reps_t, owners_t,
                                           torch.from_numpy(idx).long(),
                                           max_delta)
        reps_j, lag_j = jrep.replicate_step(reps_j, owners_j,
                                            jnp.asarray(idx), max_delta)
        np.testing.assert_array_equal(lag_t.numpy(), np.asarray(lag_j))
        _assert_stacked(reps_t, reps_j, f"round {rnd}")
        if rnd == 1:                       # checkpoint 0 completes
            owners_t, owners_j = (clog.v_truncate(owners_t, 0),
                                  jlog.v_truncate(owners_j, 0))
            reps_t, reps_j = (clog.v_truncate(reps_t, 0),
                              jlog.v_truncate(reps_j, 0))
    # a small max_delta leaves the replicas behind, by the same lag
    assert (int(lag_t.max()) == 0) == (max_delta >= 4)


def test_collect_determinant_response_equals_reference():
    rng = np.random.RandomState(13)
    t, j = _stacked(3, 16, 4, rng, [4, 6, 1])
    t, j = clog.v_truncate(t, 0), jlog.v_truncate(j, 0)
    jhost = jax.device_get(j)
    for from_epoch in (0, 1, 2):
        for max_out in (16, 3):
            got = rep.collect_determinant_response(t, [2, 0], from_epoch,
                                                   max_out)
            want = jrep.collect_determinant_response(jhost, [2, 0],
                                                     from_epoch, max_out)
            assert sorted(got) == sorted(want)
            for r in want:
                np.testing.assert_array_equal(got[r][0], want[r][0])
                assert got[r][1] == want[r][1]
