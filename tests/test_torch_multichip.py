"""PyTorch port, the sharded deployment (``tests/test_multichip.py``):
the job split by subtask over ``torch.distributed`` gloo ranks on the
CPU, each rank a fresh process holding only its shards, computes what the
unsharded port and the reference's mesh compute, bit for bit — the carry
after 3 supersteps on 2 and 4 ranks, the sealed ledgers and
``per_shard_health`` on 1 and 2 ranks, a window subtask recovered on the
rank that owns it, connected failures on both ranks, a vertex whose
parallelism does not split (it replicates), a REBALANCE edge out of a
sharded producer, and the pipelined fence. ``dryrun`` on 2 ranks prints
the reference's keys. Every rank runs under its own timeout. Tolerance:
exact.

The rank functions live here and import only the port: the ranks import
this module as ``tests.test_torch_multichip``."""

import os

import numpy as np
import pytest
import torch

from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.parallel import distributed as dist_
from clonos_tpu_torch.utils.tree import (tree_flatten_with_path, tree_leaves,
                                         tree_unflatten)

#: seconds each spawned rank may run
RANK_TIMEOUT_S = 240
_HERE = "tests.test_torch_multichip"
_KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
           inflight_ring_steps=32, seed=3, logical_time=True)


def _port_job(parallelism, window=None, sink=None, window_size=1 << 30):
    env = StreamEnvironment(num_key_groups=32, default_edge_capacity=64)
    s = env.synthetic_source(vocab=17, batch_size=8, parallelism=parallelism)
    s = s.key_by().window_count(num_keys=17, window_size=window_size,
                                parallelism=window or parallelism)
    s.sink(parallelism=sink) if sink else s.sink()
    return env.build()


def _headline_job(parallelism, window_size=4):
    """The headline's topology at a small width: sources -> keyBy ->
    windows -> keyBy (static route) -> reduces -> sinks."""
    env = StreamEnvironment(num_key_groups=16, default_edge_capacity=64)
    (env.synthetic_source(vocab=37, batch_size=8, parallelism=parallelism)
        .key_by().window_count(num_keys=37, window_size=window_size)
        .key_by().reduce(num_keys=37).sink())
    return env.build()


def _ref_job(parallelism):
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    env = JEnv(num_key_groups=32, default_edge_capacity=64)
    (env.synthetic_source(vocab=17, batch_size=8, parallelism=parallelism)
        .key_by().window_count(num_keys=17, window_size=1 << 30).sink())
    return env.build()


# --- rank functions (run in the spawned rank processes) --------------------

def rank_steps(ctx, parallelism, steps):
    """Sharded supersteps: this rank's shards as numpy, in leaf order."""
    from clonos_tpu_torch.runtime.executor import CompiledJob, StepInputs
    mesh = dist_.task_mesh()
    cj = CompiledJob(_port_job(parallelism), log_capacity=1 << 9,
                     max_epochs=8, inflight_ring_steps=8, mesh=mesh)
    carry = cj.init_carry("cpu")
    inputs = StepInputs(torch.tensor(3, dtype=torch.int32),
                        torch.tensor(7, dtype=torch.int32))
    for _ in range(steps):
        carry, _ = cj.superstep(carry, inputs)
    cj.constrain_carry(carry)
    named = tree_leaves(cj.carry_shardings(cj.global_carry_shapes()))
    if [s.spec for s in named] != tree_leaves(cj.placements()):
        raise AssertionError("carry_shardings disagrees with placements")
    return [x.numpy() for x in tree_leaves(carry)]


def _job(parallelism, window, sink, window_size, headline):
    return (_headline_job(parallelism) if headline else
            _port_job(parallelism, window, sink, window_size))


def rank_runner(ctx, root, parallelism=8, window=None, sink=None,
                kill=None, audit=True, window_size=1 << 30, headline=False,
                overlap=False):
    """A sharded ClusterRunner: 3 epochs (the last pending when a kill
    follows), then the kill (a flat subtask or a list of them), its
    recovery and one more epoch."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    r = ClusterRunner(_job(parallelism, window, sink, window_size, headline),
                      device="cpu", checkpoint_dir=os.path.join(root, "mesh"),
                      audit=audit, mesh=mesh, overlap_epoch=overlap, **_KW)
    out = {}
    for complete in (True, True, kill is None):
        r.run_epoch(complete_checkpoint=complete)
    r.drain_fence()
    out["pipelined"] = "fence.overlap-saved" in r.last_fence_phases
    out["health"] = r.per_shard_health()
    if kill is not None:
        before = [x.numpy().copy() for x in tree_leaves(r.executor.carry)]
        r.inject_failure(kill if isinstance(kill, list) else [kill])
        rep = r.recover()
        out["after"] = [x.numpy().copy()
                        for x in tree_leaves(r.executor.carry)]
        out["before"] = before
        out["report"] = (rep.restore_bytes, rep.checkpoint_bytes,
                         rep.records_replayed, len(rep.managers))
        r.run_epoch(complete_checkpoint=True)
        r.drain_fence()
    out["full"] = [x.numpy() for x in tree_leaves(r.executor.full_carry())]
    out["blocks"] = (r.executor.compiled.vblock, r.executor.compiled.lblock)
    out["ledger"] = r.coordinator.read_ledger() if ctx.process_id == 0 \
        else None
    out["storage"] = type(r.coordinator.storage).__name__
    return out


def _control(root, parallelism=8, window=None, sink=None, kill=None,
             window_size=1 << 30, headline=False):
    """The unsharded port on the same schedule."""
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(_job(parallelism, window, sink, window_size, headline),
                      device="cpu",
                      checkpoint_dir=os.path.join(root, "control"),
                      audit=True, **_KW)
    for complete in (True, True, kill is None):
        r.run_epoch(complete_checkpoint=complete)
    if kill is not None:
        r.inject_failure(kill if isinstance(kill, list) else [kill])
        r.recover()
        r.run_epoch(complete_checkpoint=True)
    return r


def _spawn(fn, n, **kw):
    return dist_.spawn(f"{_HERE}:{fn}", n, kw, device="cpu",
                       timeout_s=RANK_TIMEOUT_S)


# --- the tests -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_mesh_execution_matches_single_device(n, eight_devices):
    """3 supersteps on n gloo ranks: each rank holds 8/n of every split
    leaf, and the unsharded carry equals the port's one-rank carry and
    the reference's on ``task_mesh(max_devices=n)``, leaf for leaf."""
    import jax
    import jax.numpy as jnp
    from clonos_tpu.parallel import distributed as jdist
    from clonos_tpu.runtime.executor import CompiledJob as JCompiled
    from clonos_tpu.runtime.executor import StepInputs as JInputs

    from clonos_tpu_torch.convert import shard_carry, unshard_carry
    from clonos_tpu_torch.runtime.executor import CompiledJob, StepInputs

    shards = _spawn("rank_steps", n, parallelism=8, steps=3)
    cj = CompiledJob(_port_job(8), log_capacity=1 << 9, max_epochs=8,
                     inflight_ring_steps=8)
    template = cj.global_carry_shapes()
    placements = dist_.infer_partition_spec(template, n)
    acc_i = [i for i, x in enumerate(tree_leaves(template))
             if tuple(x.shape) == (8, 17)][0]
    assert all(s[acc_i].shape == (8 // n, 17) for s in shards), \
        "window state is split over the ranks"
    full = tree_leaves(unshard_carry(
        [tree_unflatten(template, s) for s in shards], placements))

    carry = cj.init_carry("cpu")
    inputs = StepInputs(torch.tensor(3, dtype=torch.int32),
                        torch.tensor(7, dtype=torch.int32))
    for _ in range(3):
        carry, _ = cj.superstep(carry, inputs)
    one = [x.numpy() for x in tree_leaves(carry)]

    mesh = jdist.task_mesh(max_devices=n)
    jc = JCompiled(_ref_job(8), log_capacity=1 << 9, max_epochs=8,
                   inflight_ring_steps=8, mesh=mesh)
    with mesh:
        jcarry = jax.jit(jc.init_carry)()
        step = jax.jit(jc.superstep)
        for _ in range(3):
            jcarry, _ = step(jcarry, JInputs(jnp.asarray(3, jnp.int32),
                                             jnp.asarray(7, jnp.int32)))
    ref = [np.asarray(x) for x in
           jax.tree_util.tree_leaves(jax.device_get(jcarry))]
    assert len(full) == len(one) == len(ref)
    for i, (a, b, c) in enumerate(zip(full, one, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i} vs one rank")
        np.testing.assert_array_equal(a, c, err_msg=f"leaf {i} vs reference")
    # The reference's whole carry, cut to each rank's shards, is what that
    # rank holds.
    ref_tree = tree_unflatten(template, ref)
    for r, held in enumerate(shards):
        cut = tree_leaves(shard_carry(ref_tree, placements, n, r))
        for i, (a, b) in enumerate(zip(held, cut)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} leaf {i}")


def test_graft_dryrun_multichip():
    """``dryrun`` on 2 gloo ranks: the reference's keys, a per-shard rate
    for each rank, record counts equal to the one-rank run's."""
    from clonos_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2, device="cpu", timeout_s=RANK_TIMEOUT_S)
    for key in ("ok", "n_devices", "subtasks", "log_rows_per_subtask",
                "records_per_sec_sharded", "records_per_sec_1dev",
                "per_shard_records_per_sec", "speedup",
                "scaling_efficiency", "timed_supersteps"):
        assert key in out, key
    assert out["ok"] and out["n_devices"] == 2
    assert (out["backend"], out["device"]) == ("gloo", "cpu")
    assert out["records_per_sec_sharded"] > 0
    assert len(out["per_shard_records_per_sec"]) == 2
    assert out["scaling_efficiency"] > 0


def test_sharded_vs_unsharded_digest_equality(tmp_path, eight_devices):
    """The sealed ledgers on 1 and 2 ranks equal each other and the
    reference's on a 2-device mesh (``diff_ledgers`` empty), and
    ``per_shard_health`` equals the reference's on the same n; only rank
    0 writes checkpoint files and the ledger."""
    from clonos_tpu.parallel import distributed as jdist
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner

    from clonos_tpu_torch.obs.digest import diff_ledgers

    port = {}
    for n in (1, 2):
        res = _spawn("rank_runner", n, root=str(tmp_path / f"p{n}"))
        port[n] = res
        assert [r["storage"] for r in res] == (
            ["FileCheckpointStorage"] + ["InMemoryCheckpointStorage"]
            * (n - 1)), "only rank 0 writes checkpoint files"
        assert all(np.array_equal(r["health"], res[0]["health"])
                   for r in res)
    ledgers = {n: port[n][0]["ledger"] for n in port}
    assert [e["epoch"] for e in ledgers[1]] == [0, 1, 2]
    assert diff_ledgers(ledgers[1], ledgers[2]) == []
    for a, b in zip(port[1][0]["full"], port[2][0]["full"]):
        np.testing.assert_array_equal(a, b)

    for n in (1, 2):
        r = JRunner(_ref_job(8), steps_per_epoch=8, log_capacity=512,
                    max_epochs=8, inflight_ring_steps=32, seed=3,
                    checkpoint_dir=str(tmp_path / f"ref{n}"), audit=True,
                    logical_time=True,
                    mesh=jdist.task_mesh(max_devices=n))
        for _ in range(3):
            r.run_epoch(complete_checkpoint=True)
        health = r.per_shard_health()
        assert health.shape == (n, 3)
        np.testing.assert_array_equal(port[n][0]["health"],
                                      np.asarray(health))
        assert diff_ledgers(r.coordinator.read_ledger(), ledgers[n]) == []


def test_shard_local_recovery(tmp_path):
    """A window subtask on rank 1 fails and recovers on rank 1: rank 0's
    shards and every healthy subtask's state and record count stay
    bit-identical, the restore moves fewer bytes than the checkpoint, one
    manager replays, and the ledger equals the unsharded control's on
    the same kill."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.executor import CompiledJob

    kill = 8 + 6                 # window subtask 6: rank 1's block (4-7)
    res = _spawn("rank_runner", 2, root=str(tmp_path / "mesh"), kill=kill)
    control = _control(str(tmp_path), kill=kill)
    restore, ckpt, replayed, managers = res[1]["report"]
    assert res[0]["report"][:3] == (restore, ckpt, replayed)
    assert 0 < restore < ckpt, "the restore moves less than the checkpoint"
    assert (res[0]["report"][3], managers) == (0, 1), \
        "only the owning rank replays"
    cj = CompiledJob(_port_job(8), log_capacity=512, max_epochs=8,
                     inflight_ring_steps=32)
    paths = [p for p, _ in tree_flatten_with_path(cj.global_carry_shapes())]
    # Rank 0 keeps every live shard: operator states, edge buffers,
    # rings and record counts bit-identical (its logs took the healthy
    # tasks' IGNORE_CHECKPOINT rows for the pending checkpoint).
    for i, (a, b) in enumerate(zip(res[0]["before"], res[0]["after"])):
        if paths[i][0] not in ("logs", "replicas"):
            np.testing.assert_array_equal(a, b, err_msg=f"rank 0 {paths[i]}")
    # Rank 1: the healthy windows' rows unchanged, every record count
    # back to its value before the kill.
    acc = paths.index(("op_states", 1, "acc"))
    rc = paths.index(("record_counts",))
    b, a = res[1]["before"], res[1]["after"]
    for lane in (0, 1, 3):       # windows 4, 5, 7 on rank 1
        np.testing.assert_array_equal(a[acc][lane], b[acc][lane])
    np.testing.assert_array_equal(a[rc], b[rc])
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    for x, y in zip(res[0]["full"], tree_leaves(
            control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())


def test_indivisible_vertex_replicates(tmp_path):
    """Windows (firing every 4 steps) at parallelism 3 and sinks at 2
    over 2 ranks: the window vertex (and the 9-row logs) do not split, so
    every rank runs all of them and feeds its sink lane over the
    REBALANCE edge; the carry and the ledger still equal the unsharded
    port's, and a window subtask recovers on every rank alike."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    kill = 4 + 1
    res = _spawn("rank_runner", 2, root=str(tmp_path / "mesh"),
                 parallelism=4, window=3, sink=2, kill=kill, window_size=4)
    vblock, lblock = res[1]["blocks"]
    assert vblock[1] == (0, 3) and vblock[0] == (2, 4) and lblock == (0, 9)
    control = _control(str(tmp_path), parallelism=4, window=3, sink=2,
                       kill=kill, window_size=4)
    assert res[0]["report"][3] == res[1]["report"][3] == 1, \
        "a window that does not split replays on every rank"
    for x, y in zip(res[1]["full"], tree_leaves(control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []


def test_rebalance_edge_from_a_sharded_producer(tmp_path):
    """Windows (firing every 4 steps) at 4 lanes (2 a rank) into sinks at
    2 over a REBALANCE edge: the round-robin cursor advances by the gathered block's global
    count on every rank, so each rank's sink lane, the carry and the
    ledger equal the unsharded port's, through a sink kill on rank 1."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    kill = 4 + 4 + 1             # sink subtask 1: rank 1's lane
    res = _spawn("rank_runner", 2, root=str(tmp_path / "mesh"),
                 parallelism=4, window=4, sink=2, kill=kill, window_size=4)
    vblock, lblock = res[1]["blocks"]
    assert vblock[1] == (2, 4) and vblock[2] == (1, 2) and lblock == (5, 10)
    control = _control(str(tmp_path), parallelism=4, window=4, sink=2,
                       kill=kill, window_size=4)
    sink_emitted = [y.numpy() for p, y in tree_flatten_with_path(
        control.executor.carry) if p == ("op_states", 2, "emitted")][0]
    assert (sink_emitted > 0).all(), "records crossed the rebalance edge"
    assert [r["report"][3] for r in res] == [0, 1]
    for x, y in zip(res[0]["full"], tree_leaves(control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []


def test_connected_failures_recover_on_their_ranks(tmp_path):
    """The headline's topology (static-routed reduces) on 2 ranks: a
    source and a sink subtask of rank 1 and a reduce subtask of rank 0
    fail together; each replays on its own rank in topological order,
    the downstream ones from rings rebuilt by the upstream ones, and the
    carry and the ledger equal the unsharded port's on the same kill."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    kill = [3, 4 + 4 + 1, 4 + 4 + 4 + 3]   # source 3, reduce 1, sink 3
    res = _spawn("rank_runner", 2, root=str(tmp_path / "mesh"),
                 parallelism=4, kill=kill, headline=True)
    control = _control(str(tmp_path), parallelism=4, kill=kill,
                       headline=True)
    assert [r["report"][3] for r in res] == [1, 2]
    assert res[0]["report"][2] == res[1]["report"][2] > 0
    for x, y in zip(res[1]["full"], tree_leaves(control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []


def test_pipelined_fence_on_a_mesh(tmp_path):
    """The pipelined fence on 2 ranks: each rank captures its shards
    without a collective and its fence worker gathers the health, the
    window and the snapshot to rank 0 over the fence group while the next
    epoch runs. Through a window kill on rank 1, the ledger and the carry
    equal the unsharded sequential control's, and rank 0's checkpoint
    equals the control's byte for byte."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    kill = 8 + 6
    res = _spawn("rank_runner", 2, root=str(tmp_path / "mesh"), kill=kill,
                 overlap=True)
    control = _control(str(tmp_path), kill=kill)
    assert all(r["pipelined"] for r in res)
    assert [r["report"][3] for r in res] == [0, 1]
    for x, y in zip(res[0]["full"], tree_leaves(control.executor.carry)):
        np.testing.assert_array_equal(x, y.numpy())
    assert diff_ledgers(control.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    mine = FileCheckpointStorage(str(tmp_path / "mesh" / "mesh"))
    theirs = control.coordinator.storage
    assert mine.list_ids() == theirs.list_ids() != []
    for cid in mine.list_ids():
        a, b = mine.read(cid).carry, theirs.read(cid).carry
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
