"""PyTorch port, rule-driven carry partitioning (``tests/
test_distributed.py``): the rule families and the divisibility guard,
``named_shardings``, the mesh and placement fingerprints (a CPU mesh of
1 and of 2 ranks keys as the reference's), ``snapshot_subtask_slice`` and
``snapshot_subtask_nbytes``, and the placement of every leaf of the
headline job's real carry against the reference's ``infer_partition_spec``
on its JAX carry; and what a mesh refuses. The compile-cache and lint
cases stay with the tooling, which is not ported. Tolerance: exact."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from clonos_tpu.parallel import distributed as jdist
from clonos_tpu_torch.parallel import distributed as dist
from clonos_tpu_torch.utils.tree import tree_flatten_with_path

RANK_TIMEOUT_S = 240
P = jax.sharding.PartitionSpec


def _tree(n=8, lib=torch):
    """A fake carry with one leaf per partition-rule family."""
    z = (lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)) \
        if lib is torch else (lambda *s, dtype=jnp.float32:
                              jnp.zeros(s, dtype))
    i32 = torch.int32 if lib is torch else jnp.int32
    return {
        "op_states": [{"acc": z(n, 4)}],
        "out_rings": [{"keys": z(3, n, 16), "head": z(3, dtype=i32)}],
        "logs": {"rows": z(3 * n, 5)},
        "rr_offsets": {"window": z(n, dtype=i32)},
        "record_counts": z(3 * n, dtype=i32),
        "epoch": z(dtype=i32),
    }


def _dims_of_reference(spec_tree):
    """The reference's PartitionSpec tree as (path, shard dim | None)."""
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(
            spec_tree, is_leaf=lambda x: isinstance(x, P))[0]:
        d = next((i for i, a in enumerate(s) if a == "tasks"), None)
        out.append((jdist._path_str(path), d))
    return out


def _dims_of_port(spec_tree):
    return [(dist._path_str(p), dist.shard_dim(s))
            for p, s in tree_flatten_with_path(spec_tree)]


def test_partition_rules_per_leaf_family(eight_devices):
    spec = dist.infer_partition_spec(_tree(8), 2)
    assert spec["op_states"][0]["acc"] == Shard(0)
    assert spec["out_rings"][0]["keys"] == Shard(1), \
        "ring tensors shard the subtask axis (axis 1 of [S, P, cap])"
    assert spec["out_rings"][0]["head"] == Replicate(), \
        "ring scalars replicate"
    assert spec["logs"]["rows"] == Shard(0)
    assert spec["rr_offsets"]["window"] == Replicate(), \
        "rr offsets replicate"
    assert spec["record_counts"] == Shard(0)
    assert spec["epoch"] == Replicate(), "unmatched scalars replicate"
    ref = jdist.infer_partition_spec(_tree(8, jnp),
                                     jdist.task_mesh(max_devices=2))
    assert _dims_of_port(spec) == _dims_of_reference(ref)


def test_partition_rules_divisibility_guard(eight_devices):
    tree = {"op_states": [{"odd": torch.zeros(7, 4)}],
            "logs": {"rows": torch.zeros(0, 5)}}
    spec = dist.infer_partition_spec(tree, 2)
    assert spec["op_states"][0]["odd"] == Replicate(), \
        "a dim not divisible by the mesh replicates instead of failing"
    assert spec["logs"]["rows"] == Replicate(), "zero-size dims never shard"
    ref = jdist.infer_partition_spec(
        {"op_states": [{"odd": jnp.zeros((7, 4))}],
         "logs": {"rows": jnp.zeros((0, 5))}},
        jdist.task_mesh(max_devices=2))
    assert _dims_of_port(spec) == _dims_of_reference(ref)


def test_named_shardings_wrap_the_specs():
    ns = dist.named_shardings(_tree(8), 2)
    leaf = ns["op_states"][0]["acc"]
    assert isinstance(leaf, dist.NamedPlacement)
    assert leaf.placements == (Shard(0),)
    assert dist.mesh_size(leaf.mesh, "tasks") == 2


def rank_fingerprints(ctx):
    """A rank of a 2-rank group: its mesh's fingerprint and two placement
    fingerprints."""
    mesh = dist.task_mesh()
    sa = dist.infer_partition_spec(_tree(8), mesh)
    sb = dist.infer_partition_spec({"epoch": torch.zeros(())}, mesh)
    return (dist.mesh_fingerprint(mesh), dist.spec_fingerprint(sa),
            dist.spec_fingerprint(sb), dist.standby_device_order(mesh))


def test_mesh_and_spec_fingerprints(eight_devices):
    """``mesh_fingerprint`` is the reference's on a CPU mesh of 1 (this
    process, a one-rank group) and of 2 (two gloo ranks)."""
    assert dist.mesh_fingerprint(None) == "nomesh"
    try:
        m1 = dist.task_mesh(max_devices=1, device="cpu")
        f1 = dist.mesh_fingerprint(m1)
        assert f1 != "nomesh" and f1 == dist.mesh_fingerprint(m1), \
            "fingerprint is deterministic"
    finally:
        dist.shutdown()
    assert f1 == jdist.mesh_fingerprint(jdist.task_mesh(max_devices=1))
    ranks = dist.spawn("tests.test_torch_distributed:rank_fingerprints", 2,
                       device="cpu", timeout_s=RANK_TIMEOUT_S)
    f2, sa, sb, order = ranks[0]
    assert all(r == ranks[0] for r in ranks), "every rank keys alike"
    assert f2 != f1
    assert f2 == jdist.mesh_fingerprint(jdist.task_mesh(max_devices=2))
    assert sa != sb
    assert list(order) == list(jdist.standby_device_order(
        jdist.task_mesh(max_devices=2)))


def rank_hierarchical(ctx):
    """A rank of a 2-rank group: the two-axis meshes of one host of 2
    and of 2 hosts of 1."""
    out = []
    for per_host in (2, 1):
        m = dist.hierarchical_mesh(per_host=per_host)
        out.append((tuple(m.mesh_dim_names), tuple(m.mesh.shape),
                    dist.mesh_size(m, "tasks"), dist.mesh_size(m, "hosts"),
                    dist.mesh_rank(m, "tasks"), dist.mesh_rank(m, "hosts")))
    return out


def test_hierarchical_mesh_splits_ranks_into_hosts():
    """``hierarchical_mesh`` is ``[hosts, tasks-per-host]`` over the
    group's ranks in order; a host size that does not divide the group
    is refused."""
    try:
        m = dist.hierarchical_mesh(device="cpu")
        assert tuple(m.mesh_dim_names) == ("hosts", "tasks")
        assert tuple(m.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="do not split"):
            dist.hierarchical_mesh(per_host=2, device="cpu")
    finally:
        dist.shutdown()
    r0, r1 = dist.spawn("tests.test_torch_distributed:rank_hierarchical", 2,
                        device="cpu", timeout_s=RANK_TIMEOUT_S)
    names = ("hosts", "tasks")
    assert r0 == [(names, (1, 2), 2, 1, 0, 0), (names, (2, 1), 1, 2, 0, 0)]
    assert r1 == [(names, (1, 2), 2, 1, 1, 0), (names, (2, 1), 1, 2, 0, 1)]


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, every entry point of the sharded deployment raises
    unless the caller asks for the CPU: nothing falls back to it."""
    from clonos_tpu_torch.parallel.dryrun import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rdv = "file://" + str(tmp_path / "rdv")
    calls = [lambda: dist.initialize(rdv, 1, 0),
             lambda: dist.task_mesh(),
             lambda: dist.hierarchical_mesh(),
             lambda: dist.spawn("tests.test_torch_distributed:rank_blocks",
                                2, timeout_s=8),
             lambda: dryrun_multichip(2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert not torch.distributed.is_initialized()
    assert dist.initialize(None).num_processes == 1


def test_snapshot_subtask_slice_and_nbytes():
    from clonos_tpu.runtime import checkpoint as jcp
    from clonos_tpu_torch.runtime import checkpoint as cp

    snap = types.SimpleNamespace(op_states={
        1: {"a": np.arange(12, dtype=np.float32).reshape(4, 3),
            "s": np.float32(0.0)}})
    sl = cp.snapshot_subtask_slice(snap, 1, 2)
    assert sl["a"].shape == (1, 3), "one [P, ...] row, batch dim kept"
    ref = jcp.snapshot_subtask_slice(snap, 1, 2)
    np.testing.assert_array_equal(sl["a"], np.asarray(ref["a"]))
    # One row of `a` (3 floats) + the scalar: 12 + 4 bytes.
    assert cp.snapshot_subtask_nbytes(snap, 1, 2) == 16 \
        == jcp.snapshot_subtask_nbytes(snap, 1, 2)
    full = sum(x.nbytes for x in (snap.op_states[1]["a"],
                                  snap.op_states[1]["s"]))
    assert cp.snapshot_subtask_nbytes(snap, 1, 2) < full
    tsnap = types.SimpleNamespace(op_states={
        1: {"a": torch.from_numpy(snap.op_states[1]["a"])}})
    assert torch.equal(cp.snapshot_subtask_slice(tsnap, 1, 2)["a"],
                       torch.from_numpy(sl["a"]))


def _headline(env_cls, parallelism):
    """The headline job's topology at a small width: sources -> keyBy ->
    windows -> keyBy (static route) -> reduces -> sinks."""
    env = env_cls(name="bench-allround", num_key_groups=16,
                  default_edge_capacity=64)
    (env.synthetic_source(vocab=37, batch_size=8, parallelism=parallelism)
        .key_by().window_count(num_keys=37, window_size=4, name="window")
        .key_by().reduce(num_keys=37, name="reduce").sink())
    return env.build()


@pytest.mark.parametrize("parallelism,n", [(2, 2), (4, 2), (4, 4)])
def test_headline_carry_placements_equal_reference(parallelism, n,
                                                   eight_devices):
    """Every leaf of the headline job's real carry (small log and ring)
    gets the reference's placement on its JAX carry, path for path."""
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.executor import CompiledJob as JCompiled

    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.executor import CompiledJob

    kw = dict(log_capacity=1 << 8, max_epochs=8, inflight_ring_steps=16)
    cj = CompiledJob(_headline(StreamEnvironment, parallelism), **kw)
    port = _dims_of_port(dist.infer_partition_spec(
        cj.global_carry_shapes(), n))
    jc = JCompiled(_headline(JEnv, parallelism), **kw)
    ref = _dims_of_reference(jdist.infer_partition_spec(
        jc.init_carry(), jdist.task_mesh(max_devices=n)))
    assert port == ref
    assert any(d == 1 for _, d in port) and any(d == 0 for _, d in port)


def test_mesh_refuses_what_it_does_not_run(tmp_path):
    """On a mesh (here one rank over an in-memory store), what the
    sharded path does not run is refused, each with its message: a live
    re-cut onto another mesh (a live group cannot take in new ranks) and
    a standby bootstrap of a job with a rebalance edge (its round-robin
    cursors are not in the fence snapshot, as unsharded). A re-cut
    restore, a live re-cut on the runner's own mesh and a bootstrap run
    on a mesh: ``tests/test_torch_mesh_rebuild.py``."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.causal import recovery as rec
    from clonos_tpu_torch.runtime.cluster import ClusterRunner

    def job():
        env = StreamEnvironment(num_key_groups=8, default_edge_capacity=16)
        (env.synthetic_source(vocab=5, batch_size=4, parallelism=2)
            .key_by().window_count(num_keys=5, window_size=4)
            .sink())
        return env.build()

    def rebalanced():
        env = StreamEnvironment(num_key_groups=8, default_edge_capacity=16)
        env.synthetic_source(vocab=5, batch_size=4, parallelism=2) \
            .rebalance().sink(parallelism=2)
        return env.build()

    kw = dict(steps_per_epoch=4, log_capacity=64, max_epochs=8,
              inflight_ring_steps=8, device="cpu")
    try:
        mesh = dist.task_mesh(device="cpu")
        r = ClusterRunner(job(), mesh=mesh, **kw)
        r.run_epoch(complete_checkpoint=True)
        with pytest.raises(ValueError, match="rescale_live: the new runner "
                           "keeps this runner's mesh"):
            r.rescale_live(job(), mesh=object(), **kw)
        assert not r.failed
        with pytest.raises(rec.RecoveryError, match="rebalance edges not "
                           "supported"):
            ClusterRunner.bootstrap_standby(rebalanced(), str(tmp_path), {},
                                            mesh=mesh, **kw)
    finally:
        dist.shutdown()


def rank_blocks(ctx):
    """A rank that never returns (a collective whose peer never comes)."""
    import threading
    threading.Event().wait()


def test_a_hung_rank_fails_within_its_limit():
    """``spawn`` kills every rank of a group that outlives its limit and
    raises, with each rank's output, instead of waiting on it."""
    with pytest.raises(RuntimeError, match="exceeded their 8 s limit"):
        dist.spawn("tests.test_torch_distributed:rank_blocks", 2,
                   device="cpu", timeout_s=8)
