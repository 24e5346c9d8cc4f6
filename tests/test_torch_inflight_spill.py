"""PyTorch port, the in-flight log's spill half (``inflight/log.py``):
per-epoch spill segments truncated as files, the prefetching replay
iterator, and the AVAILABILITY policy's retroactive spill before a ring
wrap (mirrors of the reference's ``tests/test_inflight.py``). Segments
the port spills read back in the reference's ``SpillingInFlightLog``.
Sizes: parallelism 2, 4-slot batches, 4-step epochs, an 8-step ring.
Tolerance: exact."""

import os

import jax
import numpy as np
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.inflight import log as jifl
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.executor import canonical_carry as jax_canonical
from clonos_tpu.storage import TieredEpochStore as JaxStore
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.api.records import RecordBatch
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.executor import canonical_carry
from clonos_tpu_torch.utils.tree import tree_leaves

P, CAP = 2, 4


def _steps(lo, hi):
    """Steps ``[lo, hi)`` stacked ``[n, P, CAP]``: key = step, value a
    per-step pattern, a seeded valid mask."""
    rng = np.random.RandomState(lo)
    n = hi - lo
    k = np.repeat(np.arange(lo, hi, dtype=np.int32), P * CAP).reshape(
        n, P, CAP)
    v = (np.arange(P * CAP, dtype=np.int32).reshape(1, P, CAP)
         + 100 * np.arange(lo, hi, dtype=np.int32)[:, None, None])
    valid = rng.rand(n, P, CAP) < 0.8
    return RecordBatch(torch.from_numpy(k), torch.from_numpy(v),
                       torch.zeros((n, P, CAP), dtype=torch.int32),
                       torch.from_numpy(valid))


def test_spill_roundtrip_file_truncation_and_reference_reads(tmp_path):
    log = ifl.SpillingInFlightLog(str(tmp_path), edge_id=0)
    steps0, steps1 = _steps(0, 3), _steps(3, 5)
    log.spill_epoch(0, 0, steps0)
    log.spill_epoch(1, 3, steps1)
    log.drain()
    assert all(os.path.exists(log.store.segment_path(e)) for e in (0, 1))
    start, got = log.load_epoch(0)
    assert start == 0
    for a, b in zip(got, steps0):
        np.testing.assert_array_equal(a, b.numpy())
    # The reference opens the port's segment index and reads the same
    # epoch back (disk tier, checksum-gated).
    ref = JaxStore.open_index(str(tmp_path), "edge0")
    start, arrs = ref.load_epoch(1)
    assert start == 3
    for name, b in zip(("keys", "values", "timestamps", "valid"), steps1):
        np.testing.assert_array_equal(arrs[name], b.numpy())
    ref.close()
    log.truncate(0)
    assert log.retained_epochs() == [1]
    assert not os.path.exists(log.store.segment_path(0))
    log.close()


def test_replay_iterator_order_and_skip(tmp_path):
    log = ifl.SpillingInFlightLog(str(tmp_path), edge_id=1)
    log.spill_epoch(0, 0, _steps(0, 3))
    log.spill_epoch(1, 3, _steps(3, 5))
    log.drain()
    got = [(s, int(b.keys[0, 0]))
           for s, b in ifl.ReplayIterator(log, 0, 1, skip_steps=1)]
    assert got == [(1, 1), (2, 2), (3, 3), (4, 4)]
    # The reference's iterator over the reference's own spill of the same
    # steps yields the same sequence.
    jlog = jifl.SpillingInFlightLog(str(tmp_path / "ref"), edge_id=1)
    for e, (lo, hi) in enumerate(((0, 3), (3, 5))):
        jlog.spill_epoch(e, lo, jifl.RecordBatch(
            *(x.numpy() for x in _steps(lo, hi))))
    jlog.drain()
    assert [(s, int(np.asarray(b.keys)[0, 0])) for s, b in
            jifl.ReplayIterator(jlog, 0, 1, skip_steps=1)] == got
    jlog.close()
    log.close()


def _build(env_cls):
    env = env_cls(name="avail", num_key_groups=8)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30)
        .sink())
    return env.build()


def _kw(d):
    return dict(steps_per_epoch=4, log_capacity=1 << 9, max_epochs=16,
                inflight_ring_steps=8, spool_dir=str(d),
                spill_policy="availability", seed=11, logical_time=True)


def _schedule(runner):
    runner.run_epoch(complete_checkpoint=True)        # restore point
    # A trigger no epoch reaches: every epoch is deferred, and only the
    # retroactive flush spills them before the wrap.
    for sl in runner.executor.spill_logs:
        sl.availability_trigger = 0.9
    for _ in range(3):
        runner.run_epoch(complete_checkpoint=False)


def test_availability_policy_spills_before_wrap(tmp_path):
    """12 un-truncated steps > an 8-step ring: the deferred epochs were
    spilled before the wrap destroyed them, and recovery across the
    wrapped gap rebuilds the data path of a never-failed run and of the
    reference runner recovering the same failure."""
    golden = ClusterRunner(_build(StreamEnvironment), device="cpu",
                           **_kw(tmp_path / "g"))
    r = ClusterRunner(_build(StreamEnvironment), device="cpu",
                      **_kw(tmp_path / "r"))
    ref = JaxRunner(_build(JaxEnv), **_kw(tmp_path / "ref"))
    for x in (golden, r, ref):
        _schedule(x)
    assert any(sl.retained_epochs() for sl in r.executor.spill_logs)
    assert ([sl.retained_epochs() for sl in r.executor.spill_logs]
            == [sl.retained_epochs() for sl in ref.executor.spill_logs])
    for x in (r, ref):
        x.inject_failure([3])                          # window subtask 1
        assert x.recover().steps_replayed == 12
    # The data path (operator state, edge buffers, rings, record counts);
    # the causal logs differ by the IGNORE_CHECKPOINT rows recovery logs.
    fields = ("op_states", "edge_bufs", "rr_offsets", "record_counts",
              "out_rings")
    ca = canonical_carry(r.executor.carry)
    cg = canonical_carry(golden.executor.carry)
    cj = jax_canonical(ref.executor.carry)
    for field in fields:
        la = tree_leaves(getattr(ca, field))
        lg = tree_leaves(getattr(cg, field))
        lj = jax.tree_util.tree_leaves(getattr(cj, field))
        assert len(la) == len(lg) == len(lj)
        for xa, xg, xj in zip(la, lg, lj):
            np.testing.assert_array_equal(xa.numpy(), xg.numpy())
            np.testing.assert_array_equal(xa.numpy(), np.asarray(xj))


def test_clobbered_before_spilling_is_refused(tmp_path):
    """Steps run past an epoch's length let a wrap reach a deferred epoch
    before the roll that would flush it: the roll raises instead of
    silently losing the epoch's only copy."""
    r = ClusterRunner(_build(StreamEnvironment), device="cpu",
                      **_kw(tmp_path))
    r.run_epoch(complete_checkpoint=True)
    for sl in r.executor.spill_logs:
        sl.availability_trigger = 2.0
    r.run_epoch(complete_checkpoint=False)     # epoch 1 deferred
    for _ in range(8):                         # epoch 2 wraps the ring
        r.step()
    with pytest.raises(RuntimeError, match="clobbered before spilling"):
        r.run_epoch(complete_checkpoint=False)
