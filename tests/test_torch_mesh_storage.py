"""PyTorch port, the sharded deployment's storage (``tests/
test_storage.py``, ``tests/test_incremental.py``): tiered spill and
incremental checkpoints on a ``torch.distributed`` task mesh of two gloo
ranks on the CPU, each rank a fresh process (one pair for every case,
each case on its own runners). Each rank spills its own
ring lanes and log block under ``spool_dir/rank<r>`` and a deep-backlog
recovery refills from the owning rank's disk tier; rank 0 alone writes
the delta chain, from the snapshot gathered to it. Held against the
reference (unsharded, the same seeded jobs) and the unsharded port.
Tolerance: exact (sealed ledgers, carries, checkpoint contents).

The rank functions live here and import only the port: the ranks import
this module as ``tests.test_torch_mesh_storage``."""

import glob
import os

import numpy as np
import pytest

from clonos_tpu_torch.parallel import distributed as dist_

#: seconds each spawned rank may run
RANK_TIMEOUT_S = 240
_HERE = "tests.test_torch_mesh_storage"
#: ``test_storage.py``'s tiered runner
_SPILL_KW = dict(steps_per_epoch=4, log_capacity=1 << 9, max_epochs=16,
                 seed=11, logical_time=True, audit=True)
#: ``test_incremental.py:100``'s runner (with logical time and the audit)
_INC_KW = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
               inflight_ring_steps=16, seed=17, logical_time=True,
               audit=True, incremental_checkpoints=True,
               incremental_base_every=2)


def _spill_job(env_cls, parallelism=2):
    env = env_cls(name="tiered", num_key_groups=8)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=parallelism)
        .key_by().window_count(num_keys=13, window_size=1 << 30)
        .sink())
    return env.build()


def _inc_job(env_cls):
    env = env_cls(name="inc", num_key_groups=8, default_edge_capacity=64)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30,
                               parallelism=2).sink(parallelism=2))
    return env.build()


def _backlog(runner, pending=3):
    runner.run_epoch(complete_checkpoint=True)     # restore point
    for _ in range(pending):
        runner.run_epoch(complete_checkpoint=False)


def _leaves(tree):
    from clonos_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


# --- rank functions (run in the spawned rank processes) --------------------

def rank_spill(ctx, root):
    """``test_storage.py:169`` and ``:190`` on a mesh. (a) 12 backlog
    steps against an 8-step ring, host budget 0, through
    ``from_config`` (``inflight.type: spillable``): the window subtask on
    rank 1 recovers from its rank's disk tier. (b) The same backlog with
    rank 1's epoch-1 ring segments torn: the refill fails on rank 1 and
    the labelled error is raised on both ranks at the same point."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.config import defaults as D
    from clonos_tpu_torch.config.options import Configuration
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    me = ctx.process_id
    cfg = Configuration()
    cfg.set(D.INFLIGHT_TYPE, "spillable")
    cfg.set(D.CHECKPOINT_DIR, os.path.join(root, "a"))
    cfg.set(D.INFLIGHT_HOST_BUDGET_EPOCHS, 0)
    cfg.set(D.CHECKPOINT_INTERVAL_STEPS, 4)
    cfg.set(D.DETERMINANT_LOG_CAPACITY, 1 << 9)
    cfg.set(D.DETERMINANT_MAX_EPOCHS, 16)
    cfg.set(D.INFLIGHT_CAPACITY_BATCHES, 8)
    r = ClusterRunner.from_config(
        _spill_job(StreamEnvironment), cfg, device="cpu", mesh=mesh,
        seed=11, logical_time=True, audit=True)
    _backlog(r)
    r.executor.drain_spill()
    out = {"digests": _index_digests(os.path.join(root, "a", "spill",
                                                  f"rank{me}")),
           "spool": sorted(os.listdir(os.path.join(root, "a", "spill"))),
           "own_segments": sorted(os.listdir(os.path.join(
               root, "a", "spill", f"rank{me}")))}
    r.inject_failure([3])                          # window subtask 1
    rep = r.recover()
    out["steps_replayed"] = rep.steps_replayed
    out["managers"] = len(rep.managers)
    out["disk_hits"] = r.executor.spill_stats().get("disk_hits", 0)
    out["by_rank"] = r.spill_by_rank()
    out["gauges"] = _spill_gauges(r)
    out["ledger"] = r.coordinator.read_ledger() if me == 0 else None
    out["full"] = [x.numpy() for x in _leaves(r.executor.full_carry())]
    r.executor.close_spill()

    spool = os.path.join(root, "b")
    r = ClusterRunner(_spill_job(StreamEnvironment), device="cpu",
                      mesh=mesh, inflight_ring_steps=8, spool_dir=spool,
                      spill_host_budget_epochs=0, **_SPILL_KW)
    _backlog(r)
    r.executor.drain_spill()
    dist_.barrier(mesh)
    if me == 1:
        for p in glob.glob(os.path.join(spool, "rank1", "edge*_epoch1.seg")):
            data = open(p, "rb").read()
            open(p, "wb").write(data[:len(data) // 2])
    dist_.barrier(mesh)
    r.inject_failure([3])
    try:
        r.recover()
        out["torn"] = None
    except Exception as e:
        out["torn"] = (type(e).__name__, str(e),
                       list(getattr(e, "__notes__", [])))
    dist_.barrier(mesh)
    r.executor.close_spill()

    # (c) Parallelism 3 does not split over 2 ranks: rank 0 alone spills
    # the rings and logs, and sends the spliced window to the others.
    spool = os.path.join(root, "c")
    r = ClusterRunner(_spill_job(StreamEnvironment, 3), device="cpu",
                      mesh=mesh, inflight_ring_steps=8, spool_dir=spool,
                      spill_host_budget_epochs=0, **_SPILL_KW)
    _backlog(r)
    r.executor.drain_spill()
    r.inject_failure([3 + 1])                      # window subtask 1
    rep = r.recover()
    mine = os.path.join(spool, f"rank{me}")
    out["replicated"] = dict(
        spooled=sorted(os.listdir(mine)) if os.path.isdir(mine) else [],
        managers=len(rep.managers),
        disk_hits=r.executor.spill_stats().get("disk_hits", 0),
        ledger=r.coordinator.read_ledger() if me == 0 else None,
        full=[x.numpy() for x in _leaves(r.executor.full_carry())])
    r.executor.close_spill()
    return out


def _index_digests(spool):
    """Every segment index under ``spool``: store name -> epoch -> the
    digests its index records carry for that epoch, in file order
    (truncated epochs included: their stamps outlive the truncation)."""
    import json
    out = {}
    for path in sorted(glob.glob(os.path.join(spool, "*.index.jsonl"))):
        name = os.path.basename(path)[:-len(".index.jsonl")]
        eps = {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") in ("segment", "digest"):
                    eps.setdefault(rec["epoch"], []).append(
                        rec.get("digest"))
        out[name] = eps
    return out


def _spill_gauges(r):
    """The runner's ``spill.*`` gauges, by name under its job group."""
    scope = f"job.{r.job.name}."
    return {k[len(scope):]: v for k, v in r.metrics.snapshot().items()
            if k.startswith(scope + "spill.")}


def rank_storage(ctx, root):
    """Both storage cases in one pair of rank processes, each on its own
    root and runners."""
    return {"spill": rank_spill(ctx, os.path.join(root, "spill")),
            "inc": rank_incremental(ctx, os.path.join(root, "inc"))}


def rank_incremental(ctx, root):
    """``test_incremental.py:100`` and ``:129`` on a mesh, with the
    pipelined fence: 3 completed epochs and a pending one (the chain:
    full, delta, full, delta), a window kill on rank 1 recovered from it;
    then a restarted mesh finds the same index on rank 0, and after the
    base of the newest chain with a delta goes, a restart collects its
    orphan."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.incremental import (
        IncrementalCheckpointStorage)
    mesh = dist_.task_mesh()
    me = ctx.process_id
    ck = os.path.join(root, "ck")
    r = ClusterRunner(_inc_job(StreamEnvironment), device="cpu", mesh=mesh,
                      checkpoint_dir=ck, overlap_epoch=True, **_INC_KW)
    for _ in range(3):
        r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.drain_fence()
    st = r.coordinator.storage
    out = {"storage": type(st).__name__}
    if me == 0:
        out["kinds"] = {c: st._index[c][0] for c in sorted(st._index)}
        out["bytes"] = st.delta_bytes_on_disk()
        out["chains"] = {c: st._chain(c) for c in st.list_ids()}
    r.inject_failure([3])
    rep = r.recover()
    out["records_replayed"] = rep.records_replayed
    out["managers"] = len(rep.managers)
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    out["full"] = [x.numpy() for x in _leaves(r.executor.full_carry())]
    out["ledger"] = r.coordinator.read_ledger() if me == 0 else None
    if me == 0:
        st = r.coordinator.storage
        out["ids"] = st.list_ids()
        out["contents"] = {c: [np.asarray(x) for x in
                               _leaves(st.read(c).carry)]
                           for c in st.list_ids()}
    dist_.barrier(mesh)
    # A restarted mesh over the same directory: rank 0 finds the index.
    r2 = ClusterRunner(_inc_job(StreamEnvironment), device="cpu", mesh=mesh,
                       checkpoint_dir=ck, **_INC_KW)
    if me == 0:
        st2 = r2.coordinator.storage
        out["restart_ids"] = st2.list_ids()
        out["restart_equal"] = all(
            all(np.array_equal(a, np.asarray(b)) for a, b in
                zip(out["contents"][c], _leaves(st2.read(c).carry)))
            for c in st2.list_ids())
        full = [c for c in sorted(st2._index)
                if ("delta", c) in st2._index.values()][-1]
        orphan = [c for c in st2._index if st2._index[c] == ("delta", full)]
        os.remove(st2._path(full))
        st3 = IncrementalCheckpointStorage(ck, base_every=2)
        out["after_loss"] = (full, orphan, st3.list_ids(),
                             [os.path.exists(st2._path(c)) for c in orphan])
    dist_.barrier(mesh)
    return out


# --- the tests -------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks for every case (:func:`rank_storage`)."""
    root = tmp_path_factory.mktemp("mesh_storage")
    res = _spawn("rank_storage", 2, root=str(root))
    return {k: [r[k] for r in res] for k in res[0]}


def _spawn(fn, n, **kw):
    return dist_.spawn(f"{_HERE}:{fn}", n, kw, device="cpu",
                       timeout_s=RANK_TIMEOUT_S)


def test_mesh_deep_backlog_refills_from_the_owning_ranks_disk(
        runs, tmp_path):
    """``test_storage.py:169`` on 2 ranks: each rank spills its own lanes
    and log block under ``spill/rank<r>``; the window subtask on rank 1
    replays 12 steps against an 8-step ring, its upstream ring's lanes
    refilled from each lane holder's disk tier (disk hits on both
    ranks), and the sealed ledger and the whole carry equal the
    reference's no-spill control (unsharded, a 32-step ring) and the
    unsharded port's spilled run. The ``spill.*`` gauges are a rank's
    own, ``spill.total.*`` their sums."""
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner

    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    res = runs["spill"]
    assert res[0]["spool"] == ["rank0", "rank1"]
    for me, x in enumerate(res):
        assert any(f.startswith("edge") and f.endswith(".seg")
                   for f in x["own_segments"]), f"rank {me} spilled"
        assert any(f.startswith("dets") for f in x["own_segments"])
        assert x["steps_replayed"] == 12 > 8
        assert x["disk_hits"] > 0, f"rank {me} refilled from its disk"
    assert [x["managers"] for x in res] == [0, 1]
    by_rank = res[0]["by_rank"]
    assert by_rank == res[1]["by_rank"] and len(by_rank) == 2
    for me, x in enumerate(res):
        g = x["gauges"]
        assert g["spill.disk-epochs"] == by_rank[me]["disk_epochs"]
        assert g["spill.total.disk-bytes"] == sum(
            b["disk_bytes"] for b in by_rank) > 0

    control = JRunner(_spill_job(JEnv), inflight_ring_steps=32, **_SPILL_KW)
    _backlog(control)
    control.inject_failure([3])
    control.recover()
    hi = max(e["epoch"] for e in res[0]["ledger"])
    expected = [e for e in control.auditor.ledger() if e["epoch"] <= hi]
    assert expected and diff_ledgers(expected, res[0]["ledger"]) == []
    port = ClusterRunner(_spill_job(StreamEnvironment), device="cpu",
                         inflight_ring_steps=8,
                         spool_dir=str(tmp_path / "spool"),
                         spill_host_budget_epochs=0, **_SPILL_KW)
    _backlog(port)
    port.executor.drain_spill()
    port.inject_failure([3])
    port.recover()
    for i, (a, b) in enumerate(zip(res[1]["full"],
                                   _leaves(port.executor.carry))):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"leaf {i}")
    port.executor.close_spill()


def test_mesh_replicated_rings_spill_on_rank0(runs):
    """A job whose parallelism (3) does not split over 2 ranks: rank 0
    alone writes spill segments, both ranks replay the window kill from
    rank 0's refilled window, and the ledger and the whole carry equal the
    reference's no-spill control (unsharded, a 32-step ring)."""
    import jax
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner

    from clonos_tpu_torch.obs.digest import diff_ledgers
    res = [x["replicated"] for x in runs["spill"]]
    assert any(f.endswith(".seg") for f in res[0]["spooled"])
    assert res[1]["spooled"] == []
    assert [x["managers"] for x in res] == [1, 1]
    assert res[0]["disk_hits"] > 0 and res[1]["disk_hits"] == 0
    control = JRunner(_spill_job(JEnv, 3), inflight_ring_steps=32,
                      **_SPILL_KW)
    _backlog(control)
    control.inject_failure([3 + 1])
    control.recover()
    hi = max(e["epoch"] for e in res[0]["ledger"])
    expected = [e for e in control.auditor.ledger() if e["epoch"] <= hi]
    assert expected and diff_ledgers(expected, res[0]["ledger"]) == []
    ref = jax.tree_util.tree_leaves(jax.device_get(control.executor.carry))
    for i, (a, b) in enumerate(zip(res[1]["full"], ref)):
        if a.shape == np.asarray(b).shape:     # the rings differ in size
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"leaf {i}")


def test_mesh_torn_segment_fails_labelled_on_every_rank(runs):
    """``test_storage.py:190`` on 2 ranks: only rank 1's epoch-1 ring
    segments are torn; its refill raises the labelled RecoveryError and
    rank 0, whose own refill succeeded, raises the same error at the
    same point (noted as rank 1's) instead of waiting in the next
    transfer."""
    for me, x in enumerate(runs["spill"]):
        kind, msg, notes = x["torn"]
        assert kind == "RecoveryError"
        assert "tiered refill failed" in msg and "epoch1" in msg
        assert notes == ([] if me == 1 else ["raised on rank 1 of 2"])


def test_mesh_incremental_chain_recovers_and_restarts(runs, tmp_path):
    """``test_incremental.py:100`` and ``:129`` on 2 ranks with the
    pipelined fence: rank 0 alone writes the chain (the others keep
    their checkpoints in memory), full and delta files alternate, and a
    recovery from a delta equals the reference's incremental run
    (unsharded): the sealed ledger and the whole carry. A restarted mesh
    reads the same ids and contents, and after the base of the newest
    chain with a delta is lost a restart drops it, collects its delta
    orphan, and keeps the rest."""
    import jax
    from clonos_tpu.api.environment import StreamEnvironment as JEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JRunner

    from clonos_tpu_torch.obs.digest import diff_ledgers
    res = runs["inc"]
    assert [x["storage"] for x in res] == ["IncrementalCheckpointStorage",
                                           "InMemoryCheckpointStorage"]
    kinds = res[0]["kinds"]
    assert set(kinds.values()) == {"full", "delta"}
    assert [x["managers"] for x in res] == [0, 1]
    assert res[0]["records_replayed"] == res[1]["records_replayed"] > 0
    b = res[0]["bytes"]
    assert max(b[c] for c in b if kinds[c] == "delta") < \
        min(b[c] for c in b if kinds[c] == "full")

    ref = JRunner(_inc_job(JEnv), checkpoint_dir=str(tmp_path / "ref"),
                  **_INC_KW)
    for _ in range(3):
        ref.run_epoch(complete_checkpoint=True)
    ref.run_epoch(complete_checkpoint=False)
    ref.inject_failure([3])
    ref.recover()
    ref.run_epoch(complete_checkpoint=True)
    assert diff_ledgers(ref.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(ref.executor.carry))]
    for i, (a, b_) in enumerate(zip(res[0]["full"], ref_leaves)):
        np.testing.assert_array_equal(a, b_, err_msg=f"leaf {i}")
    assert ref.coordinator.storage.list_ids() == res[0]["ids"]

    assert res[0]["restart_ids"] == res[0]["ids"]
    assert res[0]["restart_equal"]
    full, orphan, ids, exist = res[0]["after_loss"]
    assert orphan and not any(exist)
    assert ids == [c for c in res[0]["ids"] if c != full and c not in orphan]
    assert ids, "the first chain survives"


def test_mesh_spill_index_records_carry_the_ledger_digest(runs, tmp_path):
    """The deep-backlog run on 2 ranks: rank 0 hands each sealed epoch's
    channels to rank 1, so the last index record of every epoch under
    ``rank1/``, truncated or live (each ring segment carries its vertex's
    ``ring/v<vid>`` chain), carries the digest that rank 0 and the
    unsharded run record for that store and epoch, and none stays null.
    (An epoch whose write a truncate overtook has no record on one run
    and may have one on another.)"""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    port = ClusterRunner(_spill_job(StreamEnvironment), device="cpu",
                         inflight_ring_steps=8,
                         spool_dir=str(tmp_path / "spool"),
                         spill_host_budget_epochs=0, **_SPILL_KW)
    _backlog(port)
    port.executor.drain_spill()
    want = _index_digests(str(tmp_path / "spool"))
    port.executor.close_spill()
    r0, r1 = (x["digests"] for x in runs["spill"])
    assert any(r1.values()), "rank 1 spilled its own lanes"
    for me, got in enumerate((r0, r1)):
        for name, epochs in got.items():
            for epoch, digests in epochs.items():
                last = digests[-1]
                assert last is not None, (me, name, epoch, digests)
                if epoch in want.get(name, {}):
                    assert last == want[name][epoch][-1], (me, name, epoch)
                if me == 1 and epoch in r0.get(name, {}):
                    assert last == r0[name][epoch][-1], (name, epoch)
