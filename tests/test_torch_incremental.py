"""PyTorch port, incremental checkpoints (``runtime/incremental.py``):
device-diffed chunk deltas equal to the reference's, delta-chain reads,
base-liveness GC, the index and tombstones across a restart, and a runner
recovering from an incremental store bit-identical to the reference
runner (mirrors of the reference's ``tests/test_incremental.py``). Sizes:
leaves of a few hundred to 4096 int32s, parallelism 2, 4-step epochs.
Tolerance: exact."""

import os

import jax
import numpy as np
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.executor import canonical_carry as jax_canonical
from clonos_tpu.runtime.incremental import (
    DeviceDiffSnapshotter as JaxSnapshotter)
from clonos_tpu.runtime.incremental import LeafDelta as JaxLeafDelta
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.runtime.checkpoint import CompletedCheckpoint
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.executor import canonical_carry
from clonos_tpu_torch.runtime.incremental import (
    DeviceDiffSnapshotter, IncrementalCheckpointStorage, LeafDelta)
from clonos_tpu_torch.utils.tree import tree_leaves


def _tree(rng, shapes=((64,), (7, 33), (128, 4))):
    return {f"leaf{i}": rng.randint(-99, 99, s).astype(np.int32)
            for i, s in enumerate(shapes)}


def _mutate(tree, rng, frac=0.02):
    out = {}
    for k, v in tree.items():
        v = v.copy()
        n = max(1, int(v.size * frac))
        idx = rng.choice(v.size, n, replace=False)
        v.reshape(-1)[idx] = rng.randint(-99, 99, n)
        out[k] = v
    return out


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_diff_equals_the_reference_sparse_dense_and_unchanged():
    """Same leaves, same chunk ids and chunks as the reference's
    snapshotter, delta after delta; a dense delta ships whole leaves;
    an unchanged snapshot ships nothing."""
    rng = np.random.RandomState(0)
    snap = DeviceDiffSnapshotter(chunk_elems=16, budget_frac=0.5)
    ref = JaxSnapshotter(chunk_elems=16, budget_frac=0.5)
    t0 = _tree(rng)
    kind, payload = snap.snapshot(t0)
    assert kind == "full" and ref.snapshot(t0)[0] == "full"
    _trees_equal(payload, t0)
    cur = t0
    for frac in (0.01, 0.05, 0.9):
        nxt = _mutate(cur, rng, frac)
        kind, entries = snap.snapshot(nxt)
        rkind, rentries = ref.snapshot(nxt)
        assert kind == rkind == "delta" and len(entries) == len(rentries)
        for e, r in zip(entries, rentries):
            if r is None:
                assert e is None
            elif isinstance(r, JaxLeafDelta):
                assert isinstance(e, LeafDelta)
                assert e.chunk_ids.dtype == np.int32
                np.testing.assert_array_equal(e.chunk_ids, r.chunk_ids)
                np.testing.assert_array_equal(e.chunks, r.chunks)
            else:
                np.testing.assert_array_equal(e, np.asarray(r))
        _trees_equal(DeviceDiffSnapshotter.apply(cur, entries, 16), nxt)
        cur = nxt
    kind, entries = snap.snapshot(cur)
    assert kind == "delta" and all(e is None for e in entries)


def test_storage_chain_read_and_delta_files_smaller(tmp_path):
    rng = np.random.RandomState(1)
    st = IncrementalCheckpointStorage(str(tmp_path), base_every=4,
                                      chunk_elems=32)
    trees = [_tree(rng, shapes=((4096,),))]
    for _ in range(6):
        trees.append(_mutate(trees[-1], rng, 0.01))
    for i, t in enumerate(trees):
        st.write(CompletedCheckpoint(checkpoint_id=i, carry=t,
                                     wall_time=0.0))
    for i, t in enumerate(trees):
        _trees_equal(st.read(i).carry, t)
    sizes = st.delta_bytes_on_disk()
    kinds = {c: st._index[c][0] for c in sorted(st._index)}
    assert kinds[0] == "full" and kinds[4] == "full"
    assert kinds[1] == kinds[2] == kinds[3] == kinds[5] == "delta"
    assert sizes[1] < sizes[0] / 2
    assert sizes[5] < sizes[4] / 2
    assert st.list_ids() == list(range(7))
    # Each delta read the device's change counts once.
    assert st.packed_reads == 5


def test_delete_keeps_base_alive_until_chain_dies(tmp_path):
    rng = np.random.RandomState(2)
    st = IncrementalCheckpointStorage(str(tmp_path), base_every=10,
                                      chunk_elems=32)
    trees = [_tree(rng, shapes=((512,),))]
    for _ in range(3):
        trees.append(_mutate(trees[-1], rng))
    for i, t in enumerate(trees):
        st.write(CompletedCheckpoint(checkpoint_id=i, carry=t,
                                     wall_time=0.0))
    st.delete(0)
    assert st.list_ids() == [1, 2, 3]
    with pytest.raises(KeyError):
        st.read(0)
    _trees_equal(st.read(3).carry, trees[3])
    assert os.path.exists(st._path(0))
    for cid in (1, 2, 3):
        st.delete(cid)
    assert not os.path.exists(st._path(0))


def _build(env_cls):
    env = env_cls(name="inc", num_key_groups=8, default_edge_capacity=64)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30,
                               parallelism=2).sink(parallelism=2))
    return env.build()


def _kw(d):
    return dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
                inflight_ring_steps=16, seed=17, logical_time=True,
                checkpoint_dir=str(d), incremental_checkpoints=True,
                incremental_base_every=2)


@pytest.mark.parametrize("overlap", [False, True])
def test_runner_recovers_from_incremental_store_like_the_reference(
        tmp_path, overlap):
    """Three completed epochs (full, delta, full), one pending, a window
    kill: the port recovers from the delta chain to the reference
    runner's carry, sequential or pipelined fence."""
    runner = ClusterRunner(_build(StreamEnvironment), device="cpu",
                           overlap_epoch=overlap, **_kw(tmp_path / "port"))
    ref = JaxRunner(_build(JaxEnv), **_kw(tmp_path / "ref"))
    for x in (runner, ref):
        for _ in range(3):
            x.run_epoch(complete_checkpoint=True)
        x.run_epoch(complete_checkpoint=False)
        if x is runner:
            x.drain_fence()
        x.inject_failure([3])
        assert x.recover().records_replayed > 0
    st = runner.coordinator.storage
    assert isinstance(st, IncrementalCheckpointStorage)
    kinds = [st._index[c][0] for c in sorted(st._index)]
    assert "delta" in kinds and "full" in kinds
    assert kinds == [ref.coordinator.storage._index[c][0]
                     for c in sorted(ref.coordinator.storage._index)]
    la = tree_leaves(canonical_carry(runner.executor.carry))
    lj = jax.tree_util.tree_leaves(jax_canonical(ref.executor.carry))
    assert len(la) == len(lj)
    for a, b in zip(la, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_restore_point_is_a_delta_with_a_chain_behind_it(tmp_path):
    """base_every=3: checkpoints 0 (full), 1, 2 (deltas); the restore
    point 2 reads back through its chain equal to the snapshot taken at
    its fence, and a recovery from it equals a never-failed run."""
    kw = dict(_kw(tmp_path / "r"), incremental_base_every=3)
    r = ClusterRunner(_build(StreamEnvironment), device="cpu", **kw)
    del kw["checkpoint_dir"], kw["incremental_checkpoints"]
    golden = ClusterRunner(_build(StreamEnvironment), device="cpu", **kw)
    for _ in range(3):
        for x in (golden, r):
            x.run_epoch(complete_checkpoint=True)
    st = r.coordinator.storage
    assert st._chain(2) == [0, 1, 2]
    assert [st._index[c][0] for c in (0, 1, 2)] == ["full", "delta",
                                                     "delta"]
    # The never-failed run keeps its snapshots on the device.
    _trees_equal(st.read(2).carry,
                 golden.coordinator.storage.read(2).carry)
    for x in (golden, r):
        for _ in range(2):
            x.step()
    r.inject_failure([2, 4])                  # a window and a sink
    r.recover()
    la = tree_leaves(canonical_carry(golden.executor.carry))
    lb = tree_leaves(canonical_carry(r.executor.carry))
    for a, b in zip(la, lb):
        assert bool((a == b).all())


def test_index_survives_restart_and_orphans_are_gcd(tmp_path):
    rng = np.random.RandomState(3)
    st = IncrementalCheckpointStorage(str(tmp_path), base_every=3,
                                      chunk_elems=32)
    trees = [_tree(rng, shapes=((256,),))]
    for _ in range(4):
        trees.append(_mutate(trees[-1], rng))
    for i, t in enumerate(trees):
        st.write(CompletedCheckpoint(checkpoint_id=i, carry=t,
                                     wall_time=0.0))
    st2 = IncrementalCheckpointStorage(str(tmp_path), base_every=3,
                                       chunk_elems=32)
    assert st2.list_ids() == st.list_ids() == [0, 1, 2, 3, 4]
    for i, t in enumerate(trees):
        _trees_equal(st2.read(i).carry, t)
    assert st._index[3][0] == "full"
    os.remove(st._path(3))
    st3 = IncrementalCheckpointStorage(str(tmp_path), base_every=3,
                                       chunk_elems=32)
    assert st3.list_ids() == [0, 1, 2]
    assert not os.path.exists(st._path(4))
    st3.write(CompletedCheckpoint(checkpoint_id=9, carry=trees[0],
                                  wall_time=0.0))
    _trees_equal(st3.read(9).carry, trees[0])


def test_tombstones_survive_restart(tmp_path):
    rng = np.random.RandomState(5)
    st = IncrementalCheckpointStorage(str(tmp_path), base_every=10,
                                      chunk_elems=32)
    trees = [_tree(rng, shapes=((128,),))]
    for _ in range(3):
        trees.append(_mutate(trees[-1], rng))
    for i, t in enumerate(trees):
        st.write(CompletedCheckpoint(checkpoint_id=i, carry=t,
                                     wall_time=0.0))
    st.delete(0)
    st.delete(1)
    assert st.list_ids() == [2, 3]
    st2 = IncrementalCheckpointStorage(str(tmp_path), base_every=10,
                                       chunk_elems=32)
    assert st2.list_ids() == [2, 3]
    with pytest.raises(KeyError):
        st2.read(0)
    _trees_equal(st2.read(3).carry, trees[3])
    st2.delete(2)
    st2.delete(3)
    st3 = IncrementalCheckpointStorage(str(tmp_path), base_every=10,
                                       chunk_elems=32)
    assert st3.list_ids() == []
    assert [f for f in os.listdir(tmp_path) if f.startswith("inc_")] == []


def test_an_ignored_staged_write_forces_the_next_full(tmp_path):
    """A staged snapshot whose checkpoint is ignored before its write
    never becomes a delta base."""
    st = IncrementalCheckpointStorage(str(tmp_path), base_every=10,
                                      chunk_elems=32)
    rng = np.random.RandomState(7)
    t0 = _tree(rng, shapes=((256,),))
    st.write(CompletedCheckpoint(checkpoint_id=0, carry=t0, wall_time=0.0))
    staged = st.stage({k: torch.from_numpy(v) for k, v in
                       _mutate(t0, rng).items()}, 1)
    assert staged.kind == "delta" and staged.base == 0
    staged.discard()
    t2 = _mutate(t0, rng)
    st.write(CompletedCheckpoint(checkpoint_id=2, carry=t2, wall_time=0.0))
    assert st._index[2] == ("full", None)
    _trees_equal(st.read(2).carry, t2)
