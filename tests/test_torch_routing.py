"""PyTorch port, routing: every exchange of the port is bit-identical to
the reference's on the same inputs — hash32 at int32 extremes, all three
``_block_to_targets`` branches with overflow drops, every ``route_*_block``
form and its ``_lane`` form, and ``StaticRoutePlan.apply``. Tolerance:
exact equality (int32/bool)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.api.records import RecordBatch as JRB
from clonos_tpu.parallel import routing as jr
from clonos_tpu_torch.api.records import RecordBatch as TRB
from clonos_tpu_torch.parallel import routing as tr


def _batch(seed, shape, key_lo=-40, key_hi=40, p_valid=0.8):
    rng = np.random.RandomState(seed)
    keys = rng.randint(key_lo, key_hi, shape).astype(np.int32)
    vals = rng.randint(-1000, 1000, shape).astype(np.int32)
    ts = rng.randint(0, 500, shape).astype(np.int32)
    valid = rng.rand(*shape) < p_valid
    keys, vals, ts = (np.where(valid, x, 0) for x in (keys, vals, ts))
    return (JRB(*(jnp.asarray(x) for x in (keys, vals, ts, valid))),
            TRB(*(torch.from_numpy(x) for x in (keys, vals, ts, valid))))


def _eq(jax_tree, torch_tree):
    if isinstance(torch_tree, torch.Tensor):
        np.testing.assert_array_equal(torch_tree.numpy(),
                                      np.asarray(jax_tree))
        return
    assert len(jax_tree) == len(torch_tree)
    for a, b in zip(jax_tree, torch_tree):
        _eq(a, b)


def test_hash32_and_key_groups_at_int32_extremes():
    x = np.array([0, 1, -1, 2 ** 31 - 1, -(2 ** 31), 12345, -987654321,
                  0x7FEB352D, -0x7FEB352D], np.int32)
    np.testing.assert_array_equal(
        tr.hash32(torch.from_numpy(x)).numpy(),
        np.asarray(jr.hash32(jnp.asarray(x))).astype(np.int64))
    np.testing.assert_array_equal(tr.hash32_np(x), jr.hash32_np(x))
    for nkg in (7, 64, 128):
        kg_t = tr.key_group(torch.from_numpy(x), nkg)
        np.testing.assert_array_equal(
            kg_t.numpy(), np.asarray(jr.key_group(jnp.asarray(x), nkg)))
        np.testing.assert_array_equal(
            tr.subtask_for_key_group(kg_t, 3, nkg).numpy(),
            np.asarray(jr.subtask_for_key_group(
                jr.key_group(jnp.asarray(x), nkg), 3, nkg)))
    for s in range(5):
        assert tr.key_group_range(s, 5, 64) == jr.key_group_range(s, 5, 64)


@pytest.mark.parametrize("cap", [5, 40])
def test_scatter_to_targets_per_step(cap):
    jb, tb = _batch(1, (3, 30))
    rng = np.random.RandomState(2)
    tgt = rng.randint(0, 4, (3, 30)).astype(np.int32)
    _eq(jr._scatter_to_targets(jb, jnp.asarray(tgt), 4, cap),
        tr._scatter_to_targets(tb, torch.from_numpy(tgt), 4, cap))
    _eq(jr.route_hash(jb, 4, 16, cap), tr.route_hash(tb, 4, 16, cap))
    _eq(jr.route_rebalance(jb, 4, cap, 3), tr.route_rebalance(tb, 4, cap, 3))
    _eq(jr.route_broadcast(jb, 4, cap), tr.route_broadcast(tb, 4, cap))
    for out_cap in (10, 30, 45):
        _eq(jr.route_forward(jb, out_cap), tr.route_forward(tb, out_cap))


@pytest.mark.parametrize("branch,T,cap", [
    ("histogram", 3, 6),        # T*cap <= 2**14, overflow drops
    ("histogram", 4, 64),       # no drops
    ("scatter", 2, 8200),       # T*cap > 2**14: element scatter placement
    ("sort", 3, 6),             # scratch past the budget: flat sort
])
def test_block_to_targets_branches(monkeypatch, branch, T, cap):
    if branch == "sort":
        monkeypatch.setattr(jr, "_COUNT_ROUTE_MAX_BYTES", 1)
        monkeypatch.setattr(tr, "_budget_for", lambda dev: 1)
    jb, tb = _batch(3, (5, 2, 12))
    tgt = np.random.RandomState(4).randint(0, T, (5, 2, 12)).astype(np.int32)
    (jr_out, jd), (tr_out, td) = (
        jr._block_to_targets(jb, jnp.asarray(tgt), T, cap),
        tr._block_to_targets(tb, torch.from_numpy(tgt), T, cap))
    _eq(jr_out, tr_out)
    _eq(jd, td)
    if cap == 6:
        assert int(td.sum()) > 0      # the overflow path is exercised
    for lane in range(T):
        _eq(jr._block_to_target_lane(jb, jnp.asarray(tgt), lane, cap),
            tr._block_to_target_lane(tb, torch.from_numpy(tgt), lane, cap))


@pytest.mark.parametrize("cap", [4, 24])
def test_route_block_forms_and_lanes(cap):
    K, P, B, dst = 6, 3, 10, 4
    jb, tb = _batch(7, (K, P, B))
    offs = np.random.RandomState(8).randint(0, 50, (K,)).astype(np.int32)
    jo, to = jnp.asarray(offs), torch.from_numpy(offs)
    _eq(jr.route_hash_block(jb, dst, 16, cap),
        tr.route_hash_block(tb, dst, 16, cap))
    _eq(jr.route_rebalance_block(jb, dst, cap, jo),
        tr.route_rebalance_block(tb, dst, cap, to))
    _eq(jr.route_broadcast_block(jb, dst, cap),
        tr.route_broadcast_block(tb, dst, cap))
    for out_cap in (6, 10, 14):
        _eq(jr.route_forward_block(jb, out_cap),
            tr.route_forward_block(tb, out_cap))
    for lane in range(dst):
        _eq(jr.route_hash_block_lane(jb, lane, dst, 16, cap),
            tr.route_hash_block_lane(tb, lane, dst, 16, cap))
        _eq(jr.route_rebalance_block_lane(jb, lane, dst, cap, jo),
            tr.route_rebalance_block_lane(tb, lane, dst, cap, to))
        _eq(jr.route_broadcast_block_lane(jb, lane, cap),
            tr.route_broadcast_block_lane(tb, lane, cap))
    for lane in range(P):
        _eq(jr.route_forward_block_lane(jb, lane, 7),
            tr.route_forward_block_lane(tb, lane, 7))


@pytest.mark.parametrize("cap_scale", [1.0, 0.5])
def test_static_route_plan_matches(cap_scale):
    slot_keys = np.arange(37, dtype=np.int32)
    need = tr.static_hash_capacity(slot_keys, 3, 4, 16)
    assert need == jr.static_hash_capacity(slot_keys, 3, 4, 16)
    cap = max(1, int(need * cap_scale))
    pj = jr.plan_static_hash(slot_keys, 3, 4, 16, cap)
    pt = tr.plan_static_hash(slot_keys, 3, 4, 16, cap)
    for f in ("src_p", "src_slot", "ok", "slot_keys", "drop_p", "drop_slot",
              "drop_t"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    if cap_scale < 1:
        assert len(pt.drop_p) > 0
    jb, tb = _batch(9, (5, 3, 37), key_lo=0, key_hi=37)
    _eq(pj.apply(jb), pt.apply(tb))
