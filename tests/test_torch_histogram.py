"""PyTorch port, keyed histogram: the plain version (what the CPU runs,
and what the Hopper kernel is held against on the card) is bit-identical
to the reference's Pallas kernel in interpret mode and to its XLA
fallback — both forms, ragged record axes, out-of-range keys, any number
of leading dims. Tolerance: exact equality (int32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.ops.histogram import keyed_hist as jax_keyed_hist
from clonos_tpu_torch.ops import histogram as th

LEADS = [(6,), (2, 3), (2, 1, 3)]


def _inputs(seed, lead, b, nk):
    rng = np.random.RandomState(seed)
    shape = lead + (b,)
    keys = rng.randint(-3, nk + 4, shape).astype(np.int32)
    vals = rng.randint(-50, 50, shape).astype(np.int32)
    valid = rng.rand(*shape) < 0.7
    return keys, vals, valid


@pytest.mark.parametrize("want_counts", [True, False])
@pytest.mark.parametrize("nk", [13, 997, 8192])
@pytest.mark.parametrize("b", [100, 128, 300])
def test_plain_matches_pallas_interpret_and_xla(b, nk, want_counts):
    lead = LEADS[(b + nk) % len(LEADS)]
    keys, vals, valid = _inputs(b * 7 + nk, lead, b, nk)
    s_t, c_t = th.keyed_hist(torch.from_numpy(keys), torch.from_numpy(vals),
                             torch.from_numpy(valid), nk,
                             want_counts=want_counts)
    assert s_t.dtype == torch.int32 and s_t.shape == lead + (nk,)
    for force in ("interpret", "xla"):
        s_j, c_j = jax_keyed_hist(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(valid), nk, force=force,
                                  want_counts=want_counts)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        if want_counts:
            np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        else:
            assert c_t is None and c_j is None


def test_cpu_tensors_take_the_plain_version_without_launching():
    keys, vals, valid = _inputs(5, (4,), 64, 16)
    before = th.keyed_hist.launches
    s, c = th.keyed_hist(torch.from_numpy(keys), torch.from_numpy(vals),
                         torch.from_numpy(valid), 16)
    s2, c2 = th.keyed_hist_plain(torch.from_numpy(keys),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(valid), 16)
    assert th.keyed_hist.launches == before
    assert torch.equal(s, s2) and torch.equal(c, c2)


def test_plain_version_wraps_int32_like_the_reference():
    # Sums past 2**31 wrap (int32 add is associative mod 2**32, which is
    # what makes the kernel's atomic order irrelevant).
    keys = np.zeros((1, 4), np.int32)
    vals = np.full((1, 4), 2 ** 30, np.int32)
    valid = np.ones((1, 4), bool)
    s_t, _ = th.keyed_hist(torch.from_numpy(keys), torch.from_numpy(vals),
                           torch.from_numpy(valid), 3)
    s_j, _ = jax_keyed_hist(jnp.asarray(keys), jnp.asarray(vals),
                            jnp.asarray(valid), 3, force="xla")
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert int(s_t[0, 0]) == 0


# --- the kernel's launch plan, and inputs that stress the contract ---------

import chip_smoke  # noqa: E402  (its shape tables; it imports no JAX)
from clonos_tpu_torch.ops import cuda_build  # noqa: E402

#: H100 SXM: shared bytes a block may opt into, and SMs
H100_SMEM_OPTIN = 232448
H100_SMS = 132
PLAN_SHAPES = sorted({s[1:] for s in chip_smoke.MAIN_SHAPES
                      + chip_smoke.C45_SHAPES + chip_smoke.WC_SHAPES
                      + chip_smoke.EDGE_SHAPES + chip_smoke.FLOOR_SHAPES
                      + chip_smoke.SOAK_SHAPES}
                     | {(512, 1024, 16384, True)})


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,b,nk,counts", PLAN_SHAPES)
def test_launch_plan_fits_the_card(r, b, nk, counts, aligned):
    plan = th._plan(r, b, nk, counts, aligned, H100_SMEM_OPTIN, H100_SMS)
    table = nk * 4 * (2 if counts else 1)
    ring = th._STAGES * (9 * min(b, th._CHUNK) + 8)
    if table > H100_SMEM_OPTIN:
        assert plan.branch == th.GLOBAL and plan.smem == 0
    elif aligned and b % 16 == 0 and table + ring <= H100_SMEM_OPTIN \
            and th._branch_plan(th.DIRECT, r, b, nk, counts, H100_SMEM_OPTIN,
                                H100_SMS).resident < th._BULK_BELOW_RESIDENT:
        assert plan.branch == th.BULK
        assert plan.chunk % 16 == 0 and 0 < plan.chunk <= b
        assert plan.smem >= table + ring
    else:
        assert plan.branch == th.DIRECT and plan.smem >= table
    assert plan.smem <= H100_SMEM_OPTIN
    assert 1 <= plan.grid <= r
    if plan.branch != th.GLOBAL:
        # Persistent: the grid is at most what is resident at once, and
        # the resident blocks fit an SM's shared memory and threads.
        assert plan.grid <= H100_SMS * plan.resident
        assert plan.resident * (plan.smem + th._RESERVED_SMEM) \
            <= H100_SMEM_OPTIN + th._RESERVED_SMEM
        assert plan.resident * plan.threads <= th._THREADS_PER_SM
    if nk == 8192 and counts:
        assert plan.resident >= 2


@pytest.mark.parametrize("r,b,nk,counts,aligned,branch", [
    (512, 1024, 8192, True, True, "BULK"),       # the route's counts
    (512, 512, 8192, True, True, "BULK"),        # configs #4/#5's
    (512, 1024, 16384, True, True, "BULK"),      # routing's widest table
    (512, 1024, 8192, True, False, "DIRECT"),    # a view off alignment
    (512, 1000, 8192, True, True, "DIRECT"),     # rows not 16-byte sized
    (512, 1024, 8192, False, True, "DIRECT"),    # 4 blocks fit an SM
    (4096, 1024, 997, False, True, "DIRECT"),    # the window
    (37, 100, 70000, True, True, "GLOBAL"),      # past the budget
])
def test_launch_plan_takes_the_ring_only_where_few_blocks_fit(
        r, b, nk, counts, aligned, branch):
    plan = th._plan(r, b, nk, counts, aligned, H100_SMEM_OPTIN, H100_SMS)
    assert plan.branch == getattr(th, branch)


def _hard_inputs(case, want_counts):
    """Seeded inputs for one stress case: (keys, vals, valid, nk)."""
    rng = np.random.RandomState(len(case) * 31 + want_counts)
    r, b, nk = 5, 256, 97
    keys = rng.randint(-3, nk + 4, (r, b))
    vals = rng.randint(-50, 50, (r, b))
    valid = rng.rand(r, b) < 0.7
    if case == "zipf":
        p = np.arange(1, nk + 1, dtype=np.float64) ** -1.2
        keys = rng.choice(nk, (r, b), p=p / p.sum())
    elif case == "hot-key":
        keys = np.where(rng.rand(r, b) < 0.9, rng.randint(nk), keys)
    elif case == "all-invalid":
        valid = np.zeros((r, b), bool)
    elif case == "empty-rows":
        keys, vals, valid = (a[:, :0] for a in (keys, vals, valid))
    elif case == "wrap":
        # ~65 records a key at up to 2**31 - 1 each: sums wrap many times.
        keys = rng.randint(0, 4, (r, b))
        vals = rng.randint(2 ** 30, 2 ** 31 - 1, (r, b))
    return keys.astype(np.int32), vals.astype(np.int32), valid, nk


@pytest.mark.parametrize("want_counts", [True, False])
@pytest.mark.parametrize("case", ["zipf", "hot-key", "all-invalid",
                                  "empty-rows", "wrap"])
def test_plain_matches_reference_on_hard_inputs(case, want_counts):
    keys, vals, valid, nk = _hard_inputs(case, want_counts)
    s_t, c_t = th.keyed_hist(torch.from_numpy(keys), torch.from_numpy(vals),
                             torch.from_numpy(valid), nk,
                             want_counts=want_counts)
    # The Pallas kernel cuts records in (8, 128) tiles and refuses an empty
    # record axis; there only the XLA fallback is a reference.
    forces = ("xla",) if keys.shape[1] == 0 else ("interpret", "xla")
    for force in forces:
        s_j, c_j = jax_keyed_hist(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(valid), nk, force=force,
                                  want_counts=want_counts)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        if want_counts:
            np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        else:
            assert c_t is None and c_j is None
    if case == "wrap":
        exact = np.zeros((keys.shape[0], nk), np.int64)
        np.add.at(exact, (np.arange(keys.shape[0])[:, None], keys),
                  np.where(valid, vals, 0))
        assert (exact > 2 ** 31).any()
        np.testing.assert_array_equal(s_t.numpy(), exact.astype(np.int32))


@pytest.mark.parametrize("case", ["cpu", "int64-keys", "uint8-valid",
                                  "float-vals"])
def test_cuda_wrapper_refuses_cpu_tensors_and_wrong_dtypes(case):
    keys, vals, valid = (torch.from_numpy(a)
                         for a in _inputs(3, (4,), 64, 16))
    if case == "int64-keys":
        keys = keys.long()
    elif case == "uint8-valid":
        valid = valid.to(torch.uint8)
    elif case == "float-vals":
        vals = vals.float()
    before = (th.keyed_hist.launches, th.keyed_hist.launches_counts,
              dict(cuda_build._libs))
    with pytest.raises(ValueError if case == "cpu" else TypeError):
        th.keyed_hist_cuda(keys, vals, valid, 16)
    assert (th.keyed_hist.launches, th.keyed_hist.launches_counts,
            dict(cuda_build._libs)) == before
