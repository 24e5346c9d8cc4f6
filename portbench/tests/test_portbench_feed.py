"""The seeded partitioned feed: the same seed gives the same records,
pulls advance a cursor, ``read_at`` re-reads exact ranges and refuses
to go below a committed offset, and the paced feed waits for arrivals."""

import time

import numpy as np
import pytest

from clonos_tpu_torch.api.feeds import RetentionExpiredError
from portbench.feeds import PacedFeed, SeededPoolFeed, make_pool


def pool(seed=3):
    return make_pool(np.random.default_rng(seed), 4, 64, 11)


def test_pool_is_seeded():
    assert np.array_equal(pool(3), pool(3))
    assert not np.array_equal(pool(3), pool(4))
    assert pool().min() >= 0 and pool().max() < 11


def test_pull_block_cycles_and_read_at_replays():
    p = pool()
    f = SeededPoolFeed(p)
    ks, vs, cnt = f.pull_block(1, 8, 5)            # 40 records
    assert ks.shape == (5, 8) and (vs == 1).all() and (cnt == 8).all()
    assert np.array_equal(ks.reshape(-1), p[1, :40])
    ks2, _, _ = f.pull_block(1, 8, 5)               # wraps past 64
    assert np.array_equal(ks2.reshape(-1), p[1, np.arange(40, 80) % 64])
    got, vals = f.read_at(1, 36, 10)
    assert got == p[1, np.arange(36, 46) % 64].tolist() and vals == [1] * 10
    assert f.cursor == [0, 80, 0, 0]


def test_committed_offsets_bound_re_reads():
    f = SeededPoolFeed(pool())
    f.pull_block(0, 8, 4)
    f.notify_checkpoint_complete([20, 0, 0, 0])
    f.read_at(0, 20, 4)
    with pytest.raises(RetentionExpiredError):
        f.read_at(0, 19, 4)
    # Never above what was consumed.
    f.notify_checkpoint_complete([100, 0, 0, 0])
    assert f.committed[0] == 32


def test_paced_feed_waits_for_its_records():
    f = PacedFeed(pool())
    rate = 4 * 8 * 2 / 0.05                  # a 2-step block every 50 ms
    t0 = time.perf_counter()
    f.start(rate, t0)
    for _ in range(3):
        for part in range(4):
            f.pull_block(part, 8, 2)
    f.stop()
    dues = [d for d, _ in f.blocks]
    assert np.allclose(np.diff([t0] + dues), 0.05)
    assert all(got >= due for due, got in f.blocks)
    assert time.perf_counter() - t0 >= 0.15
