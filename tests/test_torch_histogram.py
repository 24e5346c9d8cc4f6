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
