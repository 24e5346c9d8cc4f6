"""PyTorch port, the interval join's keyed arrival rank: the plain version
(what the CPU runs, and what the Hopper kernel is held against on the
card) equals the join's one-hot ``cumsum`` formula and a record-by-record
count, and the wrapper sends CPU tensors to it without a launch.
Tolerance: exact equality (int64 ranks, int32 counts)."""

import numpy as np
import pytest
import torch

from clonos_tpu_torch.ops import histogram, keyrank


def _one_hot_formula(keys, valid, G, B, nk):
    """The grouped join's rank as ``IntervalJoinOperator.process_block``
    wrote it inline before the rank had a module of its own."""
    P, n = keys.shape
    lk = keys.to(torch.int64)
    ks = torch.arange(nk)
    oh = valid[..., None] & (lk[..., None] == ks)
    cum = torch.cumsum(oh.to(torch.int32), dim=1, dtype=torch.int32)
    rank = torch.gather(cum, 2, lk[..., None])[..., 0] - 1
    rank = torch.where(valid, rank, n).to(torch.int64)
    return rank, cum.reshape(P, G, B, nk)[:, :, -1]


def _counted(keys, valid, G, B, nk):
    """Record by record: a running count per key, read at each record and
    at the end of each step."""
    P, n = keys.shape
    rank = np.full((P, n), n, np.int64)
    through = np.zeros((P, G, nk), np.int32)
    for p in range(P):
        seen = np.zeros(nk, np.int64)
        for i in range(n):
            if valid[p, i]:
                rank[p, i] = seen[keys[p, i]]
                seen[keys[p, i]] += 1
            if i % B == B - 1:
                through[p, i // B] = seen
    return rank, through


def _inputs(seed, P, G, B, nk, kind):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, nk, (P, G * B)).astype(np.int32)
    valid = rng.rand(P, G * B) < 0.7
    if kind == "one-key":
        keys[:] = nk - 1
    elif kind == "all-invalid":
        valid[:] = False
    return keys, valid


@pytest.mark.parametrize("kind", ["mixed", "one-key", "all-invalid"])
@pytest.mark.parametrize("nk", [1, 211, 4096])
@pytest.mark.parametrize("G,B", [(1, 40), (4, 16), (64, 8)])
def test_plain_equals_the_one_hot_formula_and_a_running_count(G, B, nk,
                                                              kind):
    P = 3
    keys, valid = _inputs(G * 1000 + nk, P, G, B, nk, kind)
    rank, through = keyrank.keyed_rank_plain(
        torch.from_numpy(keys), torch.from_numpy(valid), G, B, nk)
    assert rank.dtype == torch.int64 and rank.shape == (P, G * B)
    assert through.dtype == torch.int32 and through.shape == (P, G, nk)
    want_rank, want_through = _one_hot_formula(
        torch.from_numpy(keys), torch.from_numpy(valid), G, B, nk)
    assert torch.equal(rank, want_rank)
    assert torch.equal(through, want_through)
    counted_rank, counted_through = _counted(keys, valid, G, B, nk)
    np.testing.assert_array_equal(rank.numpy(), counted_rank)
    np.testing.assert_array_equal(through.numpy(), counted_through)
    if kind == "all-invalid":
        assert (rank == G * B).all() and (through == 0).all()


def test_cpu_tensors_take_the_plain_version_without_launching():
    keys, valid = _inputs(5, 2, 4, 32, 211, "mixed")
    k, v = torch.from_numpy(keys), torch.from_numpy(valid)
    before = (keyrank.keyed_rank.launches, keyrank.keyed_rank.warm_launches)
    rank, through = keyrank.keyed_rank(k, v, 4, 32, 211)
    with histogram.counting_as_warm():
        keyrank.keyed_rank(k, v, 4, 32, 211)
    assert (keyrank.keyed_rank.launches,
            keyrank.keyed_rank.warm_launches) == before
    want = keyrank.keyed_rank_plain(k, v, 4, 32, 211)
    assert torch.equal(rank, want[0]) and torch.equal(through, want[1])


@pytest.mark.parametrize("case", ["cpu", "int64-keys", "shape"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case):
    keys = torch.zeros((2, 64), dtype=torch.int32)
    valid = torch.ones((2, 64), dtype=torch.bool)
    G, B, nk = 4, 16, 211
    if case == "int64-keys":
        keys = keys.to(torch.int64)
    elif case == "shape":
        valid = valid[:, :32]
    before = keyrank.keyed_rank.launches
    with pytest.raises(ValueError):
        keyrank.keyed_rank_cuda(keys, valid, G, B, nk)
    assert keyrank.keyed_rank.launches == before


@pytest.mark.parametrize("B,nk,threads,smem", [
    (256, 211, 256, 844),        # config #5's edges
    (100, 1, 128, 4),            # ragged
    (8, 12288, 32, 49152),       # the widest table in shared memory
    (4096, 12289, 1024, 0),      # global table; four tiles of a step
])
def test_launch_plan(B, nk, threads, smem):
    assert keyrank.plan(B, nk) == (threads, smem)


def test_the_rank_counter_is_registered_for_the_replay_span():
    """The replay span reads ``keyed_rank.launches`` through the ops
    registry, under the name ``rank_launches``."""
    from clonos_tpu_torch import ops
    before = keyrank.keyed_rank.launches
    try:
        assert ops.launch_counts()["rank_launches"] == before
        keyrank.keyed_rank.launches = before + 3
        assert ops.launch_counts()["rank_launches"] == before + 3
    finally:
        keyrank.keyed_rank.launches = before
