"""PyTorch port, the sharded deployment's host boundaries
(``tests/test_feeds.py``, ``tests/test_txn_sink.py``): host-fed sources
and transactional sinks with the file sink on a ``torch.distributed``
task mesh of gloo ranks on the CPU, each rank a fresh process holding
only its shards, its own feed reader and the part files of its own sink
subtasks, against the reference (unsharded: its mesh is one GSPMD
program whose results equal its unsharded run's, and the JAX compiles
of a mesh cost more than these cases) on the same seeded
``np.random.RandomState`` inputs. The 2-rank cases share one pair of
rank processes, each case on its own runners. Tolerance: exact (sealed
ledgers, committed feed offsets, committed streams and part-file
bytes).

The rank functions live here and import only the port: the ranks import
this module as ``tests.test_torch_mesh_feeds_txn``."""

import os

import numpy as np
import pytest

from clonos_tpu_torch.parallel import distributed as dist_

#: seconds each spawned rank may run
RANK_TIMEOUT_S = 240
_HERE = "tests.test_torch_mesh_feeds_txn"
#: the feed job's widths (``tests/test_feeds.py:80``)
P, B, SPE = 2, 4, 4


def _spawn(fn, n, **kw):
    return dist_.spawn(f"{_HERE}:{fn}", n, kw, device="cpu",
                       timeout_s=RANK_TIMEOUT_S)


def _parts(n, parts, seed):
    rng = np.random.RandomState(seed)
    return [[(int(k), int(v)) for k, v in
             zip(rng.randint(0, 100, n), rng.randint(0, 100, n))]
            for _ in range(parts)]


def _feed_job(env_cls, parallelism=P, transactional=False):
    """host_source -> keyBy -> reduce -> sink, as ``test_feeds.py``; a
    transactional sink on request."""
    env = env_cls(name="feeds-mesh", num_key_groups=8,
                  default_edge_capacity=64)
    (env.host_source(batch_size=B, parallelism=parallelism)
        .key_by().reduce(num_keys=13, parallelism=parallelism)
        .sink(parallelism=parallelism, transactional=transactional))
    return env.build()


def _txn_job(env_cls):
    """``test_txn_sink.py``'s job: synthetic -> keyBy -> window (40) ->
    transactional sink, two subtasks each."""
    env = env_cls(name="txn", num_key_groups=16)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=40)
        .sink(transactional=True))
    return env.build()


#: the feed runner's settings (logical time and the audit make the
#: sealed ledgers comparable across the packages)
_FEED_KW = dict(steps_per_epoch=SPE, log_capacity=256, max_epochs=8,
                inflight_ring_steps=16, logical_time=True, audit=True)


def _ticks(runner):
    """``test_txn_sink.py``'s causal clock: 0, 17, 34, ... ms."""
    runner.executor.time_source.now = \
        lambda it=iter(range(0, 4000, 17)): next(it)


def _files(root):
    """Every ``.final`` part file's bytes, by name."""
    out = {}
    for fn in sorted(os.listdir(root)):
        if fn.endswith(".final"):
            with open(os.path.join(root, fn), "rb") as f:
                out[fn] = f.read()
    return out


def _pending(root):
    return sorted(fn for fn in os.listdir(root) if fn.endswith(".pending"))


def _merged_commits(per_rank):
    """Every rank's committed ``(epoch, records)`` list as one stream:
    per epoch, the ranks' records in rank order (their subtasks are
    contiguous blocks, so this is the unsharded subtask-major order)."""
    by_epoch = {}
    for commits in per_rank:
        for e, recs in commits:
            by_epoch.setdefault(e, []).append(recs)
    parts = [np.concatenate(by_epoch[e], axis=0) for e in sorted(by_epoch)]
    parts = [p for p in parts if p.shape[0]]
    return (np.concatenate(parts, axis=0) if parts
            else np.zeros((0, 3), np.int32))


def _owned_bases(per_rank, parallelism):
    """The committed feed offsets (each reader's retention floor) of the
    lanes each rank owns, in lane order."""
    n = len(per_rank)
    g = parallelism // n
    return [per_rank[s // g]["bases"][s] for s in range(parallelism)]


# --- rank functions (run in the spawned rank processes) --------------------

def rank_feeds(ctx, root, parallelism=P, kill=(1, 2), file_sink=False,
               seed=3):
    """``test_feeds.py:80`` on a mesh: one completed epoch (every rank
    commits the offsets of the lanes it pulls), one pending, the kill (a
    feed source and a reduce subtask, on different ranks) recovered, one
    completed epoch; with ``file_sink`` the sink is transactional and
    backed by part files under ``root/sink``."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.api.feeds import ListFeedReader
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    job = _feed_job(StreamEnvironment, parallelism, file_sink)
    r = ClusterRunner(job, device="cpu", seed=11, mesh=mesh,
                      checkpoint_dir=os.path.join(root, "ck"), **_FEED_KW)
    reader = ListFeedReader(_parts(6 * SPE * B, parallelism, seed),
                            retention=1 << 20)
    r.executor.register_feed(0, reader)
    if file_sink:
        r.attach_file_sink(2, os.path.join(root, "sink"))
    out = {}
    from clonos_tpu_torch.api.feeds import SocketFeedReader
    try:       # an unconnected instance on every rank: the one reader
        # for every rank is registered on rank 0 alone
        r.executor.register_feed(0, SocketFeedReader.__new__(
            SocketFeedReader))
        out["socket"] = None
    except ValueError as e:
        out["socket"] = str(e)
    r.run_epoch(complete_checkpoint=True)
    out["bases_after_commit"] = list(reader._base)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure(list(kill))
    rep = r.recover()
    out["managers"] = len(rep.managers)
    out["records_replayed"] = rep.records_replayed
    r.run_epoch(complete_checkpoint=True)
    out["bases"] = list(reader._base)
    out["cursors"] = list(reader._cursor)
    out["full"] = [x.numpy() for x in _leaves(r.executor.full_carry())]
    out["ledger"] = r.coordinator.read_ledger() if ctx.process_id == 0 \
        else None
    if file_sink:
        out["commits"] = list(r.txn_logs[2].committed)
    return out


def rank_expired(ctx, root):
    """``test_feeds.py:107`` on a mesh: retention far below an epoch, the
    feed source on rank 0 killed in a pending epoch; its re-read raises,
    and every rank raises the same error at the same point (no rank left
    waiting in a collective)."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.api.feeds import (ListFeedReader,
                                            RetentionExpiredError)
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    r = ClusterRunner(_feed_job(StreamEnvironment), device="cpu", seed=12,
                      mesh=mesh, **_FEED_KW)
    r.executor.register_feed(0, ListFeedReader(
        _parts(4 * SPE * B, P, 4), retention=2))
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([0])
    try:
        r.recover()
    except RetentionExpiredError as e:
        # The group is still usable: a collective after the failure.
        dist_.barrier(mesh)
        return {"raised": type(e).__name__, "notes":
                list(getattr(e, "__notes__", []))}
    return {"raised": None}


def rank_pull_fails(ctx, root):
    """A reader that fails on rank 1 alone, at its second pull: both ranks
    raise its error at that block, and both still meet at a barrier."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.api.feeds import ListFeedReader
    from clonos_tpu_torch.runtime.cluster import ClusterRunner

    class Failing(ListFeedReader):
        def pull_block(self, subtask, batch, k):
            self.pulls = getattr(self, "pulls", 0) + 1
            if ctx.process_id == 1 and self.pulls == 2:
                raise ConnectionError("feed partition 1: broker gone")
            return super().pull_block(subtask, batch, k)
    mesh = dist_.task_mesh()
    r = ClusterRunner(_feed_job(StreamEnvironment), device="cpu", seed=12,
                      mesh=mesh, block_steps=2, **_FEED_KW)
    r.executor.register_feed(0, Failing(_parts(4 * SPE * B, P, 4)))
    try:
        r.run_epoch()
    except ConnectionError as e:
        dist_.barrier(mesh)
        return {"raised": str(e), "step": r.executor.step_in_epoch,
                "notes": list(getattr(e, "__notes__", []))}
    return {"raised": None}


def rank_txn(ctx, root, kill):
    """``test_txn_sink.py:51``, ``:77`` and ``:92`` on a mesh, the file
    sink attached under ``root/sink``: epoch 0 commits, epochs 1-2 stay
    pending (1 for the window kill), the kill recovered, one completed
    epoch. Each rank writes, commits and sweeps its own sink subtask's
    part files."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    r = ClusterRunner(_txn_job(StreamEnvironment), steps_per_epoch=3, seed=3,
                      device="cpu", mesh=mesh)
    _ticks(r)
    sink = os.path.join(root, "sink")
    fs = r.attach_file_sink(2, sink)
    r.run_epoch()
    pending = 2 if kill == "sink" else 1
    for _ in range(pending):
        r.run_epoch(complete_checkpoint=False)
    dist_.barrier(mesh)
    out = {"pending_before": _pending(sink),
           "committed_before": fs.committed_epochs()}
    base = r.job.subtask_base(2 if kill == "sink" else 1)
    r.inject_failure([base + 1])
    rep = r.recover()
    out["steps_replayed"] = rep.steps_replayed
    out["managers"] = len(rep.managers)
    r.run_epoch(complete_checkpoint=True)
    dist_.barrier(mesh)
    out["commits"] = list(r.txn_logs[2].committed)
    out["pending_after"] = _pending(sink)
    out["sweep"] = fs.sweep_pending()
    return out


def rank_commit_order(ctx, root):
    """The exactly-once commit order: rank 0 writes checkpoint 1 half a
    second late, and every rank's committer records whether rank 0's
    completion marker of the epoch it commits already exists. Then the
    restart: a second incarnation (token 1) on each rank attaches to the
    shared sink root, rank 1 first, and sweeps only its own subtask's
    stale pendings."""
    import time

    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mesh = dist_.task_mesh()
    me = ctx.process_id
    ck = os.path.join(root, "ck")
    sink = os.path.join(root, "sink")

    def runner():
        r = ClusterRunner(_txn_job(StreamEnvironment), steps_per_epoch=3,
                          seed=3, device="cpu", mesh=mesh,
                          checkpoint_dir=ck)
        _ticks(r)
        return r

    r = runner()
    fs = r.attach_file_sink(2, sink)
    if me == 0:
        st = r.coordinator.storage
        write = st.write

        def late_write(ckpt):
            if ckpt.checkpoint_id == 1:
                time.sleep(0.5)
            write(ckpt)
        st.write = late_write
    seen = []
    commit = fs.commit

    def observed(epoch, rows):
        seen.append((epoch, os.path.exists(
            os.path.join(ck, f"chk_{epoch}.pkl.done"))))
        commit(epoch, rows)
    r.txn_logs[2].committer = observed
    r.run_epoch()
    r.run_epoch()
    r.run_epoch(complete_checkpoint=False)
    dist_.barrier(mesh)
    out = {"seen": seen, "pending": _pending(sink),
           "committed": fs.committed_epochs()}
    # The restart (every rank builds its runner: a collective), then
    # each attaches in turn, rank 1 first: its sweep leaves rank 0's
    # pending.
    r2 = runner()
    for turn in (1, 0):
        if me == turn:
            fs2 = r2.attach_file_sink(2, sink, token=1)
            out["after_own_sweep"] = _pending(sink)
            out["owned"] = sorted(fs2.subtasks)
        dist_.barrier(mesh)
    out["pending_end"] = _pending(sink)
    return out


def rank_two(ctx, root):
    """Every 2-rank case in one pair of rank processes, each on its own
    root and its own runners: the feed cases, then the sink and window
    kills of the transactional sink, then the commit order and restart."""
    return {
        "feeds": rank_feeds(ctx, os.path.join(root, "feeds")),
        "expired": rank_expired(ctx, os.path.join(root, "expired")),
        "pull_fails": rank_pull_fails(ctx, os.path.join(root, "pull")),
        "txn": {kill: rank_txn(ctx, os.path.join(root, f"txn-{kill}"), kill)
                for kill in ("sink", "window")},
        "order": rank_commit_order(ctx, os.path.join(root, "order")),
        # Parallelism 3 does not split over 2 ranks: every vertex runs
        # whole on both, the feed pulled on both, the sink's transactions
        # and part files on rank 0 alone.
        "replicated": rank_feeds(ctx, os.path.join(root, "replicated"),
                                 parallelism=3, kill=(1, 6 + 2),
                                 file_sink=True, seed=8),
    }


def _leaves(tree):
    from clonos_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


# --- the reference ---------------------------------------------------------

def _ref_feeds(root, parallelism=P, kill=(1, 2), file_sink=False, seed=3):
    """:func:`rank_feeds`'s schedule on the reference, unsharded."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.api.feeds import ListFeedReader
    from clonos_tpu.runtime.cluster import ClusterRunner
    r = ClusterRunner(_feed_job(StreamEnvironment, parallelism, file_sink),
                      seed=11, checkpoint_dir=os.path.join(root, "ck"),
                      **_FEED_KW)
    reader = ListFeedReader(_parts(6 * SPE * B, parallelism, seed),
                            retention=1 << 20)
    r.executor.register_feed(0, reader)
    fs = r.attach_file_sink(2, os.path.join(root, "sink")) \
        if file_sink else None
    r.run_epoch(complete_checkpoint=True)
    bases0 = list(reader._base)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure(list(kill))
    r.recover()
    r.run_epoch(complete_checkpoint=True)
    return r, reader, bases0, fs


def _ref_txn(root, epochs_pending, schedule_kill=None):
    """``test_txn_sink.py``'s runner on the reference, unsharded, its file
    sink under ``root``: one completed epoch, ``epochs_pending`` pending,
    the optional kill recovered, one completed epoch."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.runtime.cluster import ClusterRunner
    r = ClusterRunner(_txn_job(StreamEnvironment), steps_per_epoch=3, seed=3)
    _ticks(r)
    fs = r.attach_file_sink(next(iter(r.txn_logs)), root)
    r.run_epoch()
    for _ in range(epochs_pending):
        r.run_epoch(complete_checkpoint=False)
    if schedule_kill is not None:
        r.inject_failure([schedule_kill])
        r.recover()
    r.run_epoch(complete_checkpoint=True)
    return r, fs


# --- the tests -------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks for every 2-rank case (:func:`rank_two`) and
    one of 4 ranks."""
    root = tmp_path_factory.mktemp("mesh_feeds_txn")
    two = _spawn("rank_two", 2, root=str(root / "two"))
    return {
        "two": {k: [r[k] for r in two] for k in two[0]},
        "four": _spawn("rank_feeds", 4, root=str(root / "four"),
                       parallelism=4, kill=(1, 4 + 2, 8 + 3),
                       file_sink=True, seed=6),
        "root": root,
    }


def test_mesh_commits_each_ranks_feed_offsets(runs, tmp_path):
    """``test_feeds.py:80`` on 2 ranks: at the first completion each rank
    commits the offset of the lane it pulls (its reader's floor rises to
    SPE*B there and stays 0 on the lane it never pulls, and a
    ``SocketFeedReader`` registered on every rank is refused: its one
    reader goes on rank 0 and None on the others); after the feed
    source on rank 1 and the reduce on rank 0 recover, the committed
    offsets, the sealed ledger and the whole carry equal the reference's
    (unsharded)."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    res = runs["two"]["feeds"]
    assert [x["socket"] for x in res] == [
        "vertex 0: the ranks disagree on its reader — a SocketFeedReader "
        "(one for every rank) is registered on rank 0 and None on every "
        "other rank"] * 2
    assert [x["bases_after_commit"] for x in res] == \
        [[SPE * B, 0], [0, SPE * B]]
    assert [x["managers"] for x in res] == [1, 1], \
        "each kill replays on its own rank"
    assert res[0]["records_replayed"] == res[1]["records_replayed"] > 0
    ref, reader, bases0, _ = _ref_feeds(str(tmp_path))
    assert bases0 == [SPE * B] * P
    assert _owned_bases(res, P) == list(reader._base)
    assert [res[s]["cursors"][s] for s in range(P)] == list(reader._cursor)
    assert diff_ledgers(ref.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    import jax
    ref_leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(jax.device_get(ref.executor.carry))]
    assert len(ref_leaves) == len(res[0]["full"])
    for i, (a, b) in enumerate(zip(res[0]["full"], ref_leaves)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_mesh_recovery_past_expired_offsets_fails_on_every_rank(runs):
    """``test_feeds.py:107`` on 2 ranks: the re-read below retention
    raises ``RetentionExpiredError`` on the owning rank, and the other
    rank raises it too at the same point (noted as rank 0's) instead of
    waiting for a peer that left; both ranks then still meet at a
    barrier. The reference (unsharded) raises the same error."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.api.feeds import ListFeedReader, RetentionExpiredError
    from clonos_tpu.runtime.cluster import ClusterRunner
    res = runs["two"]["expired"]
    assert [x["raised"] for x in res] == ["RetentionExpiredError"] * 2
    assert res[0]["notes"] == [] and res[1]["notes"] == [
        "raised on rank 0 of 2"]
    r = ClusterRunner(_feed_job(StreamEnvironment), seed=12, **_FEED_KW)
    r.executor.register_feed(0, ListFeedReader(_parts(4 * SPE * B, P, 4),
                                               retention=2))
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([0])
    with pytest.raises(RetentionExpiredError):
        r.recover()


def test_mesh_failed_pull_raises_on_every_rank(runs):
    """A feed pull that fails on rank 1 alone (its second block) is
    settled before the block's first collective: both ranks raise the
    same error after the first block (rank 0's noted as rank 1's) and
    still meet at a barrier."""
    res = runs["two"]["pull_fails"]
    assert [x["raised"] for x in res] == [
        "feed partition 1: broker gone"] * 2
    assert [x["step"] for x in res] == [2, 2]
    assert [x["notes"] for x in res] == [["raised on rank 1 of 2"], []]


def test_four_ranks_feeds_and_file_sink(runs, tmp_path):
    """4 ranks, one lane a vertex each: a feed source on rank 1, a reduce
    on rank 2 and a transactional sink on rank 3 killed together and
    recovered on their ranks; the committed feed offsets, the sealed
    ledger, the committed stream and the part files equal the
    reference's (unsharded) byte for byte."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    res = runs["four"]
    assert [x["managers"] for x in res] == [0, 1, 1, 1]
    ref, reader, _, fs = _ref_feeds(str(tmp_path), parallelism=4,
                                    kill=(1, 4 + 2, 8 + 3),
                                    file_sink=True, seed=6)
    assert _owned_bases(res, 4) == list(reader._base)
    assert diff_ledgers(ref.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    np.testing.assert_array_equal(
        _merged_commits([x["commits"] for x in res]),
        ref.txn_logs[2].committed_stream())
    mine = _files(str(runs["root"] / "four" / "sink"))
    assert mine and mine == _files(os.path.join(str(tmp_path), "sink"))


def test_mesh_replicated_feed_and_sink(runs, tmp_path):
    """A job whose parallelism (3) does not split over 2 ranks: every rank
    pulls the whole feed from its own reader and commits every lane's
    offset, a killed feed source and sink subtask replay on both ranks,
    and only rank 0 absorbs, commits and writes the sink's part files,
    so nothing is emitted twice: the committed feed offsets, the sealed
    ledger, the committed stream and the part files equal the
    reference's (unsharded)."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    res = runs["two"]["replicated"]
    assert [x["managers"] for x in res] == [2, 2]
    ref, reader, _, _ = _ref_feeds(str(tmp_path), parallelism=3,
                                   kill=(1, 6 + 2), file_sink=True, seed=8)
    assert [x["bases"] for x in res] == [list(reader._base)] * 2
    assert diff_ledgers(ref.coordinator.read_ledger(),
                        res[0]["ledger"]) == []
    assert sum(recs.shape[0] for _, recs in res[1]["commits"]) == 0
    want = ref.txn_logs[2].committed_stream()
    assert want.shape[0] > 0
    np.testing.assert_array_equal(_merged_commits([res[0]["commits"]]), want)
    mine = _files(str(runs["root"] / "two" / "replicated" / "sink"))
    assert mine and mine == _files(os.path.join(str(tmp_path), "sink"))


@pytest.mark.parametrize("kill", ["sink", "window"])
def test_mesh_txn_sink_exactly_once_across_failure(kill, runs, tmp_path):
    """``test_txn_sink.py:51`` (a sink subtask on rank 1 killed with
    epochs 1-2 pending: its pendings rebuilt exactly once on rank 1),
    ``:77`` (a window subtask on rank 1 killed: the sinks' transactions
    intact) and ``:92`` (the part files) on 2 ranks: the committed stream
    and every committed part file equal a never-failed reference run's
    (unsharded) byte for byte, nothing stays pending, and each rank's
    restart sweep finds nothing of its own."""
    res = runs["two"]["txn"]
    res = [r[kill] for r in res]
    pending = 2 if kill == "sink" else 1
    golden, gfs = _ref_txn(str(tmp_path / "golden"), pending)
    assert [x["managers"] for x in res] == [0, 1]
    if kill == "sink":
        assert res[1]["steps_replayed"] == 6
        assert res[0]["pending_before"] == [
            f"part-{e}-{s}-t0.pending" for e in (1, 2) for s in (0, 1)]
    assert res[0]["committed_before"] == [0]
    got = _merged_commits([x["commits"] for x in res])
    want = golden.txn_logs[next(iter(golden.txn_logs))].committed_stream()
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    mine = _files(str(runs["root"] / "two" / f"txn-{kill}" / "sink"))
    assert sorted({int(f.split("-")[1]) for f in mine}) == gfs \
        .committed_epochs() == list(range(pending + 2))
    assert mine == _files(str(tmp_path / "golden"))
    assert [x["pending_after"] for x in res] == [[], []]
    assert [x["sweep"] for x in res] == [[], []]


def test_mesh_commit_waits_for_rank0_checkpoint_and_restart_sweeps_own(
        runs, tmp_path):
    """The commit order on 2 ranks: no rank renames an epoch's part file
    before rank 0's checkpoint of that epoch is complete on disk, though
    rank 0 writes checkpoint 1 half a second late. The restart (token 1,
    ``test_txn_sink.py:148``'s fencing): rank 1's sweep removes only its
    own subtask's stale pending and leaves rank 0's; after both, none is
    left; together they remove what the reference's one sweeper at token
    1 removes from the same files (unsharded), and the committed files
    equal its byte for byte."""
    from clonos_tpu.runtime.filesink import FileSystemSink as JSink
    res = runs["two"]["order"]
    for x in res:
        assert [e for e, _ in x["seen"]] == [0, 1]
        assert all(done for _, done in x["seen"]), \
            f"committed before rank 0's checkpoint completed: {x['seen']}"
    assert res[0]["pending"] == ["part-2-0-t0.pending", "part-2-1-t0.pending"]
    assert res[1]["after_own_sweep"] == ["part-2-0-t0.pending"]
    assert res[0]["after_own_sweep"] == []
    assert (res[0]["owned"], res[1]["owned"]) == ([0], [1])
    assert res[0]["pending_end"] == res[1]["pending_end"] == []
    golden, _ = _ref_txn(str(tmp_path / "golden"), 0)
    golden.run_epoch(complete_checkpoint=False)
    assert _pending(str(tmp_path / "golden")) == res[0]["pending"]
    assert JSink(str(tmp_path / "golden"), token=1).sweep_pending() == \
        res[0]["pending"]
    assert _files(str(runs["root"] / "two" / "order" / "sink")) == \
        _files(str(tmp_path / "golden"))
