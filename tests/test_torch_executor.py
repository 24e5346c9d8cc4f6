"""PyTorch port, executor: the flagship job (``__graft_entry__._flagship_job``
shape, parallelism 2) run for several epochs under logical time from one
seed gives the same carry and the same sink batches in both packages;
block == stepwise in the port; and a carry handed over from the reference
(``carry_from_numpy``) advances one block to the reference's next carry.
Tolerance: exact (int32/bool)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from clonos_tpu.runtime import executor as jex
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from clonos_tpu_torch.runtime import executor as tex
from clonos_tpu_torch.utils.tree import tree_leaves

KW = dict(steps_per_epoch=24, log_capacity=1 << 9, max_epochs=8,
          inflight_ring_steps=32, block_steps=16, logical_time=True, seed=5)


def _port_flagship(parallelism=2, num_key_groups=64):
    env = StreamEnvironment(name="flagship-wordcount",
                            num_key_groups=num_key_groups,
                            default_edge_capacity=128)
    (env.synthetic_source(vocab=211, batch_size=32, parallelism=parallelism)
        .key_by()
        .window_count(num_keys=211, window_size=64, name="window")
        .key_by()
        .reduce(num_keys=211, name="reduce")
        .sink())
    return env.build()


def _assert_carries_equal(jax_carry, port_carry):
    la = jax.tree_util.tree_leaves(jax.device_get(jax_carry))
    lb = tree_leaves(carry_to_numpy(port_carry))
    assert len(la) == len(lb)
    for i, (a, b) in enumerate(zip(la, lb)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def _sinks_equal(jouts, touts):
    assert sorted(jouts.sinks) == sorted(touts.sinks)
    for vid in touts.sinks:
        for a, b in zip(jouts.sinks[vid], touts.sinks[vid]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_flagship_epochs_match_reference_carry_and_sinks():
    jx = jex.LocalExecutor(graft._flagship_job(2), **KW)
    tx = tex.LocalExecutor(_port_flagship(2), device="cpu", **KW)
    fired = 0
    for epoch in range(4):
        jo = jx.run_epoch()
        to = tx.run_epoch()
        _sinks_equal(jo, to)
        fired += int(to.sinks[3].valid.sum())
        _assert_carries_equal(jx.carry, tx.carry)
        assert tx.check_overflow() == [] == jx.check_overflow()
        np.testing.assert_array_equal(tx.health_vector(),
                                      jx.health_vector())
        jx.notify_checkpoint_complete(epoch)
        tx.notify_checkpoint_complete(epoch)
        _assert_carries_equal(jx.carry, tx.carry)
    assert fired > 0          # windows fired and reached the sink
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(
            jx.lean_snapshot())), tree_leaves(carry_to_numpy(
                tx.lean_snapshot()))):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_block_equals_stepwise_in_port():
    kw = dict(KW, steps_per_epoch=8, block_steps=8)
    ex1 = tex.LocalExecutor(_port_flagship(2), device="cpu", **kw)
    ex2 = tex.LocalExecutor(_port_flagship(2), device="cpu", **kw)
    for _ in range(8):
        ex1.step()
    ex1.run_epoch()           # no steps left; just rolls the epoch marker
    ex2.run_epoch()
    for a, b in zip(tree_leaves(ex1.carry), tree_leaves(ex2.carry)):
        assert torch.equal(a, b)


def test_carry_from_reference_advances_to_reference_next_block():
    jc = jex.CompiledJob(graft._flagship_job(2), log_capacity=1 << 9,
                         max_epochs=8, inflight_ring_steps=32)
    tc = tex.CompiledJob(_port_flagship(2), log_capacity=1 << 9,
                         max_epochs=8, inflight_ring_steps=32)
    rng = np.random.RandomState(9)
    run_block = jax.jit(jc.run_block)
    carry = jc.init_carry()
    for blk in range(3):
        times = (np.arange(blk * 16, blk * 16 + 16) * 5).astype(np.int32)
        rngs = rng.randint(0, 2 ** 31, 16).astype(np.int32)
        start = carry_from_numpy(jax.tree_util.tree_map(np.asarray, carry),
                                 "cpu")
        jbi = jex.BlockInputs(jnp.asarray(times), jnp.asarray(rngs),
                              jnp.asarray(blk, jnp.int32),
                              jnp.asarray(blk * 16, jnp.int32))
        tbi = tex.BlockInputs(torch.from_numpy(times),
                              torch.from_numpy(rngs),
                              torch.tensor(blk, dtype=torch.int32),
                              torch.tensor(blk * 16, dtype=torch.int32))
        carry, jouts = run_block(carry, jbi)
        tcarry, touts = tc.run_block(start, tbi)
        _assert_carries_equal(carry, tcarry)
        _sinks_equal(jouts, touts)
        for e in jouts.dropped:
            np.testing.assert_array_equal(touts.dropped[e].numpy(),
                                          np.asarray(jouts.dropped[e]))
        np.testing.assert_array_equal(touts.consumed.numpy(),
                                      np.asarray(jouts.consumed))
    _assert_carries_equal(jex.canonical_carry(carry),
                          tex.canonical_carry(tcarry))
