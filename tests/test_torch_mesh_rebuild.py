"""PyTorch port, rebuilding and re-cutting a job on a ``torch.distributed``
task mesh of gloo ranks on the CPU, each rank a fresh process holding only
its shards (one pair of rank processes runs every 2-rank case, each case
on its own runners): recovered timers on a mesh, lineage termini from
every rank, then ``restore_rescaled`` onto a mesh (1 -> 2, 2 -> 1, 2 -> 2
at a new parallelism, and a parallelism that does not split),
``rescale_live`` 8 -> 16 -> 8 driven by the autoscaler,
``bootstrap_standby`` from mirror rows, and one socket reader for every
rank. Each case is held against the port's unsharded run of the same
schedule (sealed ledgers, the gathered carry, sink output, committed
offsets) and against the reference's unsharded run of it (one SPMD
process: its mesh computes what it computes unsharded), with only the
reference's documented faults allowed for (ROADMAP Queue 3 item 6: its
re-cut leaves the fence's SOURCE_CHECKPOINT rows out of the sources'
logs). The causal-time case has no reference counterpart: one process
has one clock. Tolerance: exact.

The rank functions live here and import only the port: the ranks import
this module as ``tests.test_torch_mesh_rebuild``. The reference runs in
the test process alone."""

import os

import numpy as np
import pytest

from clonos_tpu_torch.parallel import distributed as dist_

#: seconds each spawned rank may run
RANK_TIMEOUT_S = 240
_HERE = "tests.test_torch_mesh_rebuild"


def _spawn(fn, n, **kw):
    return dist_.spawn(f"{_HERE}:{fn}", n, kw, device="cpu",
                       timeout_s=RANK_TIMEOUT_S)


def _leaves(tree):
    from clonos_tpu_torch.utils.tree import tree_leaves
    return [x.numpy().copy() for x in tree_leaves(tree)]


def _assert_leaves(got, want, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{what} leaf {i}")


# --- timers (``tests/test_torch_feeds.py``'s cascade) -----------------------

#: ``test_torch_feeds.py``'s causal clock
TIMES = list(range(0, 800, 10))
_CASCADE_KW = dict(steps_per_epoch=3, seed=5, inflight_ring_steps=16)


def _cascade_job(env_cls):
    """Config #4's shape at test scale: feed -> window -> reduce -> sink."""
    env = env_cls(name="c4-mini", num_key_groups=16,
                  default_edge_capacity=32)
    (env.host_source(batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=9, window_size=40, parallelism=2)
        .key_by().reduce(num_keys=9, parallelism=2)
        .sink(parallelism=2))
    return env.build()


def _cascade_parts():
    return [[(k % 9, k) for k in range(s, 400, 2)] for s in range(2)]


def _timer_run(mesh=None):
    """``test_torch_feeds.py::test_recovered_timer_fires_again_exactly_
    once``'s schedule: timers at 35, 45, 60 and 95 on window subtask 1
    (flat 3), one completed and one pending epoch and two steps, the
    window killed and recovered. Returns the callback's log before and
    after the recovery, the timers still pending and the whole carry."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.api.feeds import ListFeedReader
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(_cascade_job(StreamEnvironment), device="cpu",
                      mesh=mesh, **_CASCADE_KW)
    fired = []
    svc = r.timer_service(3)
    svc.register_callback(fired.append, callback_id=7)
    for t in (35, 45, 60, 95):
        svc.register_timer(t, 7)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    r.executor.register_feed(0, ListFeedReader(_cascade_parts(),
                                               records_per_pull=3))
    r.run_epoch()
    r.run_epoch(complete_checkpoint=False)
    r.step()
    r.step()
    live = list(fired)
    r.inject_failure([3])
    r.recover()
    return {"live": live, "fired": fired, "pending": svc.pending,
            "full": _leaves(r.executor.full_carry()), "canon": _canonical(r)}


# --- lineage (``tests/test_torch_lineage.py``'s headline) -------------------

_LINEAGE_KW = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
                   inflight_ring_steps=16, seed=3, logical_time=True)


def _lineage_job(env_cls):
    """``test_torch_lineage.py``'s ``_headline(transactional=True)`` at
    parallelism 4."""
    env = env_cls(name="bench-allround", num_key_groups=8,
                  default_edge_capacity=16)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=4)
        .key_by()
        .window_count(num_keys=13, window_size=8, name="window",
                      parallelism=4)
        .key_by()
        .reduce(num_keys=13, name="reduce", parallelism=4)
        .sink(transactional=True, parallelism=4))
    return env.build()


def _lineage_run(root, mesh=None, **kw):
    """Three completed epochs under ``LineagePlane(k=3)``; the bytes of
    the observation file (on a mesh, rank 0's: it alone writes)."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.obs import lineage as tlin
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    plane = tlin.LineagePlane(root, service="run", k=3)
    r = ClusterRunner(_lineage_job(StreamEnvironment), lineage=plane,
                      device="cpu", mesh=mesh, **_LINEAGE_KW, **kw)
    for _ in range(3):
        r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    plane.close()
    path = os.path.join(root, "lineage-run.jsonl")
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


# --- restore_rescaled (``tests/test_torch_rescale.py``'s job) --------------

VOCAB = 23
SINK_VID = 3
_RS_KW = dict(steps_per_epoch=6, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=11)


class TickTime:
    """``test_torch_rescale.py``'s deterministic causal time."""

    def __init__(self, t0: int = 0, step: int = 3):
        self.t = t0
        self.step = step

    def now(self) -> int:
        self.t += self.step
        return self.t


def _rescale_job(env_cls, window_p, reduce_p):
    env = env_cls(name=f"rescale-{window_p}-{reduce_p}",
                  num_key_groups=16, default_edge_capacity=96)
    (env.synthetic_source(vocab=VOCAB, batch_size=8, parallelism=2)
        .key_by()
        .window_count(num_keys=VOCAB, window_size=7, parallelism=window_p,
                      name="w")
        .key_by()
        .reduce(num_keys=VOCAB, parallelism=reduce_p, name="r")
        .key_by()
        .sink(parallelism=2))
    return env.build()


def _collect_sink(runner, epochs, complete=False):
    """Run epochs; the sorted multiset of the sink records this process
    saw (on a mesh, the sink lanes its rank runs; the reference's too)."""
    got = []

    def absorb(outs, _epoch):
        b = outs.sinks.get(SINK_VID)
        if b is None:
            return
        k, v, t, m = (np.asarray(x) for x in b)
        got.extend(zip(k[m].tolist(), v[m].tolist(), t[m].tolist()))

    runner.executor.on_block_outputs = absorb
    for _ in range(epochs):
        runner.run_epoch(complete_checkpoint=complete)
    runner.executor.on_block_outputs = None
    return sorted(got)


def _checkpoint(ck, mesh=None):
    """The restore point: one completed epoch at parallelism 2 written to
    ``ck`` (on a mesh by rank 0), and the causal time at its fence."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(_rescale_job(StreamEnvironment, 2, 2), device="cpu",
                      mesh=mesh, checkpoint_dir=ck, **_RS_KW)
    r.executor.time_source = TickTime()
    r.run_epoch(complete_checkpoint=True)
    return r.executor.time_source.t


def _read_checkpoint(ck):
    from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
    st = FileCheckpointStorage(ck)
    return st.read(max(st.completed_ids()))


def _restored_run(ck, p_new, fence_t, mesh=None, me=0):
    """``restore_rescaled`` of ``ck``'s checkpoint at ``p_new`` (rank 0
    alone reads it on a mesh), then two audited epochs: the restored
    whole carry, the sink multiset this process saw and the ledger."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    res = ClusterRunner.restore_rescaled(
        _rescale_job(StreamEnvironment, p_new, p_new),
        _rescale_job(StreamEnvironment, 2, 2),
        _read_checkpoint(ck) if me == 0 else None, device="cpu",
        mesh=mesh, audit=True, **_RS_KW)
    restored = _leaves(res.executor.full_carry())
    restored_canon = _canonical(res)
    res.executor.time_source = TickTime(t0=fence_t)
    sink = _collect_sink(res, 2)
    return {"restored": restored, "restored_canon": restored_canon,
            "sink": sink,
            "ledger": res.auditor.ledger() if me == 0 else None,
            "full": _leaves(res.executor.full_carry()),
            "canon": _canonical(res)}


def _rank_restore(root, mesh, me):
    """The restore cases on 2 ranks: a checkpoint the 2-rank mesh wrote
    and one an unsharded runner (on rank 0) wrote, restored onto the
    mesh at parallelism 4 (both) and 3 (which does not split)."""
    t_mesh = _checkpoint(os.path.join(root, "ck-mesh"), mesh)
    if me == 0:
        _checkpoint(os.path.join(root, "ck-one"))
    dist_.barrier(mesh)
    return {"fence_t": t_mesh,
            "1to2": _restored_run(os.path.join(root, "ck-one"), 4, t_mesh,
                                  mesh, me),
            "2to2": _restored_run(os.path.join(root, "ck-mesh"), 4, t_mesh,
                                  mesh, me),
            "2to2-p3": _restored_run(os.path.join(root, "ck-mesh"), 3,
                                     t_mesh, mesh, me)}


# --- rescale_live 8 -> 16 -> 8, driven by the autoscaler -------------------

#: the load the autoscaler sees at each fence: up, cooldown, down, hold
LOADS = (2.0, 2.0, 0.3, 0.8)


def _process_groups():
    """The process groups this process holds (the world's included)."""
    import torch.distributed as dist
    return len(dist.distributed_c10d._world.pg_map)


def _live_run(root, mesh=None):
    """The rescale job at parallelism 8, audited, one completed epoch a
    fence, the autoscaler deciding at each drained fence on ``LOADS``:
    it re-cuts 8 -> 16, holds through its cooldown, and re-cuts 16 -> 8;
    one more epoch. Returns the sink multiset this process saw, the
    ledger (rank 0), the whole carry, each executed re-cut's target and
    stats, what ``on_fence`` returned at each fence, and the process
    groups held before the controller was made and after it closed."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            PolicyConfig, ScalePolicy,
                                            ScaleSignals)
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    ck = os.path.join(root, "ck")
    kw = dict(device="cpu", checkpoint_dir=ck, audit=True, **_RS_KW)
    state = {"r": ClusterRunner(_rescale_job(StreamEnvironment, 8, 8),
                                mesh=mesh, **kw)}
    state["r"].executor.time_source = TickTime()
    executed = []

    def execute(target):
        new, stats = state["r"].rescale_live(
            _rescale_job(StreamEnvironment, target, target), **kw)
        state["r"] = new
        executed.append((target, {k: v for k, v in stats.items()
                                  if k != "migrate_ms"}))
    groups0 = _process_groups() if mesh is not None else 0
    ctl = AutoscaleController(
        ScalePolicy(PolicyConfig(sustain_fences=1, cooldown_fences=1,
                                 max_step=8, min_workers=8,
                                 max_workers=16)),
        execute_workers=execute, healthy=lambda: not state["r"].failed,
        mesh=mesh)
    returned = []
    sink = []
    for load in LOADS:
        live = state["r"]
        sink += _collect_sink(live, 1, complete=True)
        live.drain_fence()
        epoch = live.executor.epoch_id - 1
        decision, recut = ctl.on_fence(epoch, ScaleSignals(
            epoch=epoch, load=load,
            workers=live.job.vertices[1].parallelism))
        returned.append((decision.action, decision.target_workers,
                         None if recut is None else recut.target_workers))
    live = state["r"]
    sink += _collect_sink(live, 1, complete=True)
    live.drain_fence()
    ctl.close()
    me = 0 if mesh is None else dist_.mesh_rank(mesh)
    return {"sink": sorted(sink), "executed": executed,
            "returned": returned,
            "ledger": live.auditor.ledger() if me == 0 else None,
            "decisions": len(ctl.log),
            "full": _leaves(live.executor.full_carry()),
            "canon": _canonical(live), "paths": _canonical_paths(live),
            "owners": [o for o, _ in live.executor.compiled.plan.pairs],
            "groups": (groups0, _process_groups() if mesh is not None
                       else 0)}


# --- bootstrap_standby (``tests/test_torch_recovery_phases.py``) -----------

_BOOT_KW = dict(steps_per_epoch=4, log_capacity=512, max_epochs=8,
                inflight_ring_steps=32, seed=3, logical_time=True)
#: (source, window, sink) parallelisms: every vertex split over 2 ranks,
#: and one with a source and a sink that do not split
BOOT_SHAPES = {"split": (2, 4, 2), "mixed": (3, 2, 1)}


def _boot_job(env_cls, shape):
    src, win, sink = BOOT_SHAPES[shape]
    env = env_cls(name=f"boot-{shape}", num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=src)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30, parallelism=win)
        .key_by()
        .sink(parallelism=sink))
    return env.build()


def _mirror_rows(logs):
    """Every log's live rows ``[tail, head)`` and its tail: what a standby
    host's mirror holds at the dead runner's last fence."""
    from clonos_tpu_torch import device as _device
    rows, heads, tails = _device.HostCopy(
        (logs.rows, logs.head, logs.tail)).wait()
    cap = rows.shape[1]
    return {f: (rows[f][np.arange(int(tails[f]), int(heads[f])) & (cap - 1)],
                int(tails[f])) for f in range(rows.shape[0])}


def _canonical(runner):
    from clonos_tpu_torch.runtime.executor import canonical_carry
    return _leaves(canonical_carry(runner.executor.full_carry()))


def _canonical_paths(runner):
    """The leaf paths of :func:`_canonical`'s leaves, in order."""
    from clonos_tpu_torch.runtime.executor import canonical_carry
    from clonos_tpu_torch.utils.tree import tree_flatten_with_path
    return [p for p, _ in tree_flatten_with_path(
        canonical_carry(runner.executor.full_carry()))]


def _boot_run(root, shape, mesh=None):
    """A runner (the dead one) with 3 completed epochs and a pending one,
    its checkpoints under ``root/ck``; the whole job rebuilt by
    ``bootstrap_standby`` from its mirror rows, then one more epoch on
    both. Returns both canonical carries before and after, the report's
    counts and the rebuilt runner's ledgers."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    ck = os.path.join(root, "ck")
    dead = ClusterRunner(_boot_job(StreamEnvironment, shape), device="cpu",
                         mesh=mesh, checkpoint_dir=ck, **_BOOT_KW)
    for _ in range(3):
        dead.run_epoch(complete_checkpoint=True)
    dead.run_epoch(complete_checkpoint=False)
    mirror = _mirror_rows(dead.executor.full_carry().logs)
    boot, rep = ClusterRunner.bootstrap_standby(
        _boot_job(StreamEnvironment, shape), ck, mirror, device="cpu",
        mesh=mesh, **_BOOT_KW)
    out = {"steps_replayed": rep.steps_replayed,
           "from_epoch": rep.from_epoch, "global_step": boot.global_step,
           "rebuilt": _canonical(boot), "dead": _canonical(dead),
           "roll_gap": sorted(boot.executor.roll_gap_async.items()),
           "reattach": "finalize.listener-reattach" in rep.phase_ms}
    for r in (boot, dead):
        r.run_epoch(complete_checkpoint=True)
    out["next"] = _canonical(boot)
    out["next_dead"] = _canonical(dead)
    return out


# --- one socket reader for every rank ---------------------------------------

SOCKET_B, SOCKET_SPE, SOCKET_LINES = 4, 4, 150
_SOCKET_KW = dict(steps_per_epoch=SOCKET_SPE, log_capacity=256,
                  max_epochs=8, inflight_ring_steps=16, logical_time=True,
                  audit=True, seed=11)
#: the feed's parallelism: split over 2 ranks, and not
SOCKET_SHAPES = (2, 3)


def _socket_job(env_cls, parallelism):
    """host_source -> keyBy -> reduce -> sink, as ``test_feeds.py``."""
    env = env_cls(name="socket-mesh", num_key_groups=8,
                  default_edge_capacity=64)
    (env.host_source(batch_size=SOCKET_B, parallelism=parallelism)
        .key_by().reduce(num_keys=13, parallelism=parallelism)
        .sink(parallelism=parallelism))
    return env.build()


def _socket_lines(parallelism):
    rng = np.random.RandomState(parallelism)
    return [f"{k}:{v}" for k, v in zip(rng.randint(0, 13, SOCKET_LINES),
                                       rng.randint(1, 10, SOCKET_LINES))]


def _line_server(lines):
    """A TCP server on 127.0.0.1 that sends ``lines`` to one connection
    and closes it."""
    import socket
    import threading
    srv = socket.create_server(("127.0.0.1", 0))
    payload = "".join(f"{x}\n" for x in lines).encode()

    def serve():
        conn, _ = srv.accept()
        with conn:
            conn.sendall(payload)
        srv.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv.getsockname()[1]


def _socket_run(root, port, parallelism, mesh=None):
    """The feed job fed by one ``SocketFeedReader`` (on a mesh, rank 0's;
    the others register None), drained before the run: one completed
    epoch, one pending, the feed source's subtask 1 and the reduce's
    subtask 0 killed and recovered (the re-read served from the one
    reader's retention), one completed epoch. Returns the reader's
    committed offsets and cursors (rank 0), the report's counts, the
    whole carry and the ledger."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.api.feeds import SocketFeedReader
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    me = 0 if mesh is None else dist_.mesh_rank(mesh)
    reader = None
    if me == 0:
        reader = SocketFeedReader("127.0.0.1", port,
                                  num_subtasks=parallelism)
        reader._thread.join(timeout=60)
    r = ClusterRunner(_socket_job(StreamEnvironment, parallelism),
                      device="cpu", mesh=mesh,
                      checkpoint_dir=os.path.join(root, "ck"), **_SOCKET_KW)
    r.executor.register_feed(0, reader)
    r.run_epoch(complete_checkpoint=True)
    out = {"bases_after_commit": None if reader is None
           else list(reader._r._base)}
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([1, parallelism])
    rep = r.recover()
    r.run_epoch(complete_checkpoint=True)
    out.update(managers=len(rep.managers),
               records_replayed=rep.records_replayed,
               full=_leaves(r.executor.full_carry()), canon=_canonical(r),
               ledger=r.auditor.ledger() if me == 0 else None)
    if reader is not None:
        out.update(bases=list(reader._r._base),
                   cursors=list(reader._r._cursor),
                   lost=list(reader.records_lost))
        reader.close()
    return out


# --- one causal time for the mesh -----------------------------------------

class RankClock:
    """A causal clock that reads differently on each rank, as each
    rank's wall clock does: ``step`` ms a reading from 0."""

    def __init__(self, step: int):
        self.t, self.step = 0, step

    def now(self) -> int:
        self.t += self.step
        return self.t


def _clock_run(mesh=None):
    """The rescale job at parallelism 2 on ``RankClock(5 + rank)``: one
    completed epoch, one pending, window subtask 1 killed and recovered.
    Returns the step-input history and the state digest before the kill
    and after the recovery."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(_rescale_job(StreamEnvironment, 2, 2), device="cpu",
                      mesh=mesh, **_RS_KW)
    me = 0 if mesh is None else dist_.mesh_rank(mesh)
    r.executor.time_source = RankClock(5 + me)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    before = r.state_digest()
    r.inject_failure([r.job.subtask_base(1) + 1])
    r.recover()
    return {"history": list(r.executor.step_input_history),
            "before": before, "after": r.state_digest()}


# --- the reference (the test process alone) ---------------------------------

def _ref_runner(job_fn, *args, **kw):
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.runtime.cluster import ClusterRunner
    return ClusterRunner(job_fn(StreamEnvironment, *args),
                         heartbeat_timeout_s=600.0, **kw)


def _ref_canonical(runner):
    import jax
    from clonos_tpu.runtime.executor import canonical_carry
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(canonical_carry(runner.executor.carry)))]


def _ref_timer():
    """:func:`_timer_run`'s schedule on the reference."""
    from clonos_tpu.api.feeds import ListFeedReader
    r = _ref_runner(_cascade_job, **_CASCADE_KW)
    fired = []
    svc = r.timer_service(3)
    svc.register_callback(fired.append, callback_id=7)
    for t in (35, 45, 60, 95):
        svc.register_timer(t, 7)
    r.executor.time_source.now = lambda it=iter(TIMES): next(it)
    r.executor.register_feed(0, ListFeedReader(_cascade_parts(),
                                               records_per_pull=3))
    r.run_epoch()
    r.run_epoch(complete_checkpoint=False)
    r.step()
    r.step()
    r.inject_failure([3])
    r.recover()
    return {"fired": fired, "pending": svc.pending,
            "canon": _ref_canonical(r)}


def _ref_lineage(root, overlap):
    """:func:`_lineage_run`'s bytes on the reference."""
    from clonos_tpu.obs import lineage as jlin
    plane = jlin.LineagePlane(root, service="run", k=3)
    r = _ref_runner(_lineage_job, lineage=plane, overlap_epoch=overlap,
                    **_LINEAGE_KW)
    for _ in range(3):
        r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    plane.close()
    with open(os.path.join(root, "lineage-run.jsonl"), "rb") as f:
        return f.read()


def _ref_restores(root, parallelisms):
    """The reference's restore point (:func:`_checkpoint`'s schedule) and
    its ``restore_rescaled`` at each new parallelism, then two audited
    epochs (:func:`_restored_run`'s readings)."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.runtime.cluster import ClusterRunner
    r = _ref_runner(_rescale_job, 2, 2, checkpoint_dir=root, **_RS_KW)
    r.executor.time_source = TickTime()
    r.run_epoch(complete_checkpoint=True)
    fence_t, ckpt = r.executor.time_source.t, r.standbys.latest
    out = {}
    for p in parallelisms:
        res = ClusterRunner.restore_rescaled(
            _rescale_job(StreamEnvironment, p, p),
            _rescale_job(StreamEnvironment, 2, 2), ckpt, audit=True,
            heartbeat_timeout_s=600.0, **_RS_KW)
        restored = _ref_canonical(res)
        res.executor.time_source = TickTime(t0=fence_t)
        out[p] = {"restored": restored, "sink": _collect_sink(res, 2),
                  "ledger": res.auditor.ledger(),
                  "canon": _ref_canonical(res)}
    return out


def _ref_live(root):
    """:func:`_live_run`'s schedule on the reference, its own autoscaler
    deciding on the same loads."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.autoscale import (AutoscaleController, PolicyConfig,
                                      ScalePolicy, ScaleSignals)
    kw = dict(checkpoint_dir=os.path.join(root, "ck"), audit=True,
              **_RS_KW)
    state = {"r": _ref_runner(_rescale_job, 8, 8, **kw)}
    state["r"].executor.time_source = TickTime()
    executed = []

    def execute(target):
        new, stats = state["r"].rescale_live(
            _rescale_job(StreamEnvironment, target, target),
            heartbeat_timeout_s=600.0, **kw)
        state["r"] = new
        executed.append((target, stats))
    ctl = AutoscaleController(
        ScalePolicy(PolicyConfig(sustain_fences=1, cooldown_fences=1,
                                 max_step=8, min_workers=8,
                                 max_workers=16)),
        execute_workers=execute, healthy=lambda: not state["r"].failed)
    sink = []
    for load in LOADS:
        live = state["r"]
        sink += _collect_sink(live, 1, complete=True)
        live.drain_fence()
        epoch = live.executor.epoch_id - 1
        ctl.on_fence(epoch, ScaleSignals(
            epoch=epoch, load=load,
            workers=live.job.vertices[1].parallelism))
    live = state["r"]
    sink += _collect_sink(live, 1, complete=True)
    live.drain_fence()
    return {"sink": sorted(sink), "executed": executed,
            "ledger": live.auditor.ledger(), "decisions": len(ctl.log),
            "canon": _ref_canonical(live)}


def _ref_boot(root, shape):
    """:func:`_boot_run`'s schedule on the reference: its dead runner's
    checkpoints and mirror rows, its own ``bootstrap_standby``."""
    from clonos_tpu.api.environment import StreamEnvironment
    from clonos_tpu.runtime.cluster import ClusterRunner
    ck = os.path.join(root, "ck")
    dead = _ref_runner(_boot_job, shape, checkpoint_dir=ck, **_BOOT_KW)
    for _ in range(3):
        dead.run_epoch(complete_checkpoint=True)
    dead.run_epoch(complete_checkpoint=False)
    logs = dead.executor.carry.logs
    rows, heads, tails = (np.asarray(x) for x in
                          (logs.rows, logs.head, logs.tail))
    cap = rows.shape[1]
    mirror = {f: (rows[f][np.arange(int(tails[f]), int(heads[f]))
                          & (cap - 1)], int(tails[f]))
              for f in range(rows.shape[0])}
    boot, rep = ClusterRunner.bootstrap_standby(
        _boot_job(StreamEnvironment, shape), ck, mirror,
        heartbeat_timeout_s=600.0, **_BOOT_KW)
    out = {"steps_replayed": rep.steps_replayed,
           "from_epoch": rep.from_epoch, "global_step": boot.global_step,
           "rebuilt": _ref_canonical(boot),
           "roll_gap": sorted(boot.executor.roll_gap_async.items())}
    boot.run_epoch(complete_checkpoint=True)
    out["next"] = _ref_canonical(boot)
    return out


def _ref_socket(root, parallelism):
    """:func:`_socket_run`'s schedule on the reference, its own
    ``SocketFeedReader`` on its own connection to the same lines."""
    from clonos_tpu.api.feeds import SocketFeedReader
    reader = SocketFeedReader("127.0.0.1", _line_server(
        _socket_lines(parallelism)), num_subtasks=parallelism)
    reader._thread.join(timeout=60)
    r = _ref_runner(_socket_job, parallelism,
                    checkpoint_dir=os.path.join(root, "ck"), **_SOCKET_KW)
    r.executor.register_feed(0, reader)
    r.run_epoch(complete_checkpoint=True)
    out = {"bases_after_commit": list(reader._r._base)}
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([1, parallelism])
    rep = r.recover()
    r.run_epoch(complete_checkpoint=True)
    out.update(records_replayed=rep.records_replayed,
               canon=_ref_canonical(r), ledger=r.auditor.ledger(),
               bases=list(reader._r._base), cursors=list(reader._r._cursor),
               lost=list(reader.records_lost))
    return out


# --- rank functions (run in the spawned rank processes) --------------------

def rank_all(ctx, root, socket_ports):
    """Every 2-rank case in one pair of rank processes, each on its own
    root and its own runners."""
    mesh = dist_.task_mesh()
    me = ctx.process_id
    out = {"timer": _timer_run(mesh)}
    out["lineage"] = {
        mode: _lineage_run(os.path.join(root, f"lineage-{mode}", f"r{me}"),
                           mesh, overlap_epoch=mode == "pipelined")
        for mode in ("sequential", "pipelined")}
    out["restore"] = _rank_restore(os.path.join(root, "restore"), mesh, me)
    out["live"] = _live_run(os.path.join(root, "live"), mesh)
    out["boot"] = {shape: _boot_run(os.path.join(root, f"boot-{shape}"),
                                    shape, mesh) for shape in BOOT_SHAPES}
    out["clock"] = _clock_run(mesh)
    out["socket"] = {
        p: _socket_run(os.path.join(root, f"socket-{p}"), socket_ports[i],
                       p, mesh) for i, p in enumerate(SOCKET_SHAPES)}
    return out


# --- the tests -------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks for every 2-rank case (:func:`rank_all`)."""
    root = tmp_path_factory.mktemp("mesh_rebuild")
    ports = [_line_server(_socket_lines(p)) for p in SOCKET_SHAPES]
    res = _spawn("rank_all", 2, root=str(root), socket_ports=ports)
    out = {k: [r[k] for r in res] for k in res[0]}
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def unsharded_timer():
    return _timer_run()


@pytest.fixture(scope="module")
def reference_timer():
    return _ref_timer()


def test_recovered_timer_fires_again_on_one_rank(unsharded_timer,
                                                 reference_timer):
    """The cascade's window subtask recovered on a one-rank mesh (a
    process group of one, here in-process): its recorded timers re-run
    their callback once, as unsharded and as the reference's, and the
    carry equals the unsharded run's and the reference's."""
    try:
        got = _timer_run(dist_.task_mesh(device="cpu"))
    finally:
        dist_.shutdown()
    assert unsharded_timer["fired"] == [35, 45, 60, 35, 45, 60]
    assert got["fired"] == unsharded_timer["fired"] == \
        reference_timer["fired"]
    assert got["pending"] == unsharded_timer["pending"] == \
        reference_timer["pending"] == 1
    _assert_leaves(got["full"], unsharded_timer["full"])
    _assert_leaves(got["canon"], reference_timer["canon"], "reference")


def test_recovered_timer_fires_again_on_the_owning_rank(runs,
                                                        unsharded_timer,
                                                        reference_timer):
    """On 2 ranks the window subtask (flat 3) runs on rank 1, which alone
    runs its callbacks, live and again when the recovery re-fires them:
    ``[35, 45, 60, 35, 45, 60]`` there, as the reference's, and nothing
    on rank 0, whose service still appends the determinants to the log
    and replica rows it holds. The gathered carry equals the unsharded
    run's and the reference's."""
    res = runs["timer"]
    assert [x["live"] for x in res] == [[], [35, 45, 60]]
    assert [x["fired"] for x in res] == [[], reference_timer["fired"]]
    assert reference_timer["fired"] == [35, 45, 60, 35, 45, 60]
    assert [x["pending"] for x in res] == [reference_timer["pending"]] * 2
    for x in res:
        _assert_leaves(x["full"], unsharded_timer["full"])
        _assert_leaves(x["canon"], reference_timer["canon"], "reference")


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_lineage_termini_from_every_rank(runs, tmp_path, mode):
    """The headline job at parallelism 4 with a transactional sink, on 2
    ranks: rank 0 observes the sink shards every rank sealed (gathered
    once a fence, on the fence worker's group when the fence is
    pipelined), so its observation file is byte-equal to the unsharded
    run's and the reference's, sink termini on rank 1's subtasks
    included."""
    want = _lineage_run(str(tmp_path / "unsharded"),
                        overlap_epoch=mode == "pipelined")
    assert _ref_lineage(str(tmp_path / "ref"), mode == "pipelined") == want
    got = [x[mode] for x in runs["lineage"]]
    import json
    sinks = [d for d in map(json.loads, want.splitlines())
             if d["kind"] == "sink"]
    assert any(d["subtask"] >= 2 for d in sinks), "a terminus on rank 1"
    assert got[0] == want
    assert got[1] == b""


@pytest.fixture(scope="module")
def reference_restores(tmp_path_factory):
    return _ref_restores(str(tmp_path_factory.mktemp("ref_restore")), (4, 3))


@pytest.mark.parametrize("case,p_new", [("1to2", 4), ("2to2", 4),
                                        ("2to2-p3", 3), ("2to1", 4)])
def test_restore_rescaled_onto_a_mesh(runs, reference_restores, case,
                                      p_new):
    """A checkpoint at parallelism 2 (written by an unsharded runner, or
    by rank 0 of a 2-rank mesh) restored at a new parallelism onto a
    2-rank mesh (4, and 3, which does not split and so is whole on both
    ranks) and onto a one-rank mesh (here in-process): rank 0 builds the
    whole state and each rank receives its shards. The restored carry,
    the sink multiset of the next two epochs (both ranks' lanes together)
    and the sealed ledger equal the port's unsharded restore of the same
    checkpoint and the reference's restore of its own."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    root = str(runs["root"] / "restore")
    per_rank = runs["restore"]
    fence_t = per_rank[0]["fence_t"]
    ck = os.path.join(root, "ck-one" if case == "1to2" else "ck-mesh")
    want = _restored_run(ck, p_new, fence_t)
    if case == "2to1":
        try:
            one = _restored_run(ck, p_new, fence_t,
                                dist_.task_mesh(device="cpu"))
        finally:
            dist_.shutdown()
        got = [one]
    else:
        got = [x[case] for x in per_rank]
    assert want["sink"], "records reach the sink after the restore"
    assert sorted(s for x in got for s in x["sink"]) == want["sink"]
    for x in got:
        _assert_leaves(x["restored"], want["restored"], "restored")
        _assert_leaves(x["full"], want["full"], "after two epochs")
    assert diff_ledgers(want["ledger"], got[0]["ledger"]) == []
    ref = reference_restores[p_new]
    assert ref["sink"] == want["sink"]
    assert diff_ledgers(ref["ledger"], got[0]["ledger"]) == []
    for x in got:
        _assert_leaves(x["restored_canon"], ref["restored"], "reference")
        _assert_leaves(x["canon"], ref["canon"], "reference, two epochs")


def test_rescale_live_round_trip_on_a_mesh_by_the_autoscaler(runs,
                                                             tmp_path):
    """8 -> 16 -> 8 under traffic on 2 ranks, the autoscaler deciding on
    rank 0 and every rank re-cutting at the same fence: both ranks
    execute the same two re-cuts with rank 0's stats, rank 1 logs no
    decision, the new runners' gloo groups replace the fenced-off ones'
    (none leaks), and the sink multiset, the sealed ledger and the
    gathered carry equal the port's unsharded run of the schedule; that
    ledger equals a never-rescaled control's through the group
    directory."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.obs import audit as audit_mod
    from clonos_tpu_torch.obs.digest import diff_ledgers
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    want = _live_run(str(tmp_path / "unsharded"))
    got = runs["live"]
    assert [t for t, _ in want["executed"]] == [16, 8]
    for x in got:
        assert x["executed"] == want["executed"]
        assert x["returned"] == want["returned"]
        assert x["groups"][0] == x["groups"][1]
        _assert_leaves(x["full"], want["full"])
    assert [x["decisions"] for x in got] == [want["decisions"], 0]
    assert sorted(s for x in got for s in x["sink"]) == want["sink"]
    assert want["sink"]
    assert diff_ledgers(want["ledger"], got[0]["ledger"]) == []
    # The reference's own autoscaler on the same loads: the same re-cuts
    # at the same fences with the same stats, the same sink output, and
    # the same ledger but for what its fault (ROADMAP Queue 3 item 6)
    # leaves out of the sources' logs in each re-cut's first epoch.
    ref = _ref_live(str(tmp_path / "ref"))
    assert ref["decisions"] == want["decisions"]
    assert ref["sink"] == want["sink"]
    assert [t for t, _ in ref["executed"]] == [16, 8]
    for (t, st), (rt, rst) in zip(got[0]["executed"], ref["executed"]):
        for key in ("fence_checkpoint", "from_epoch", "groups",
                    "drained_records", "moved_key_groups", "transitions"):
            assert st[key] == rst[key], (t, key)
    recut_epochs = [st["from_epoch"] for _, st in ref["executed"]]
    assert _without_source_logs(got[0]["ledger"], recut_epochs) == \
        _without_source_logs(ref["ledger"], recut_epochs)
    for x in got:
        _assert_but_source_logs(x["canon"], ref["canon"], want["paths"],
                                want["owners"])
    ctl = ClusterRunner(_rescale_job(StreamEnvironment, 8, 8), device="cpu",
                        checkpoint_dir=str(tmp_path / "ctl"), audit=True,
                        **_RS_KW)
    ctl.executor.time_source = TickTime()
    for _ in range(len(LOADS) + 1):
        ctl.run_epoch(complete_checkpoint=True)
    assert audit_mod.diff_ledgers_cross(ctl.auditor.ledger(),
                                        got[0]["ledger"]) == []


def _without_source_logs(ledger, epochs, sources=(0, 1)):
    """``test_torch_rescale.py``'s ledger view: in each of ``epochs`` the
    sources' log channels and what they fold into (the row and record
    totals, the combined digest) dropped."""
    out = []
    for e in ledger:
        e = dict(e)
        if e["epoch"] in epochs:
            for k in ("combined", "records", "det_counts"):
                e.pop(k)
            e["channels"] = {k: v for k, v in e["channels"].items()
                             if k not in {f"log/{f}" for f in sources}}
        out.append(e)
    return out


def _assert_but_source_logs(got, want, paths, owners, sources=(0, 1)):
    """Canonical carries equal leaf for leaf, but for the sources' logs
    and the replicas of them (ROADMAP Queue 3 item 6: the reference's
    re-cut leaves their fence row out, so their later rows sit one
    place earlier): those leaves are held equal on every other row."""
    assert len(got) == len(want) == len(paths)
    for p, a, b in zip(paths, got, want):
        if a.ndim == 0:
            keep = ()
        elif p[0] == "logs":
            keep = [f for f in range(a.shape[0]) if f not in sources]
        elif p[0] == "replicas":
            keep = [r for r, o in enumerate(owners) if o not in sources]
        else:
            keep = slice(None)
        np.testing.assert_array_equal(a[keep], np.asarray(b)[keep],
                                      err_msg=f"reference {p}")


def test_rescale_live_refuses_another_mesh():
    """A live group cannot take in new ranks: an unsharded runner asked
    to re-cut onto a mesh is refused by name before anything moves."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    r = ClusterRunner(_rescale_job(StreamEnvironment, 2, 2), device="cpu",
                      **_RS_KW)
    r.run_epoch(complete_checkpoint=True)
    with pytest.raises(ValueError, match="cannot take in new ranks"):
        r.rescale_live(_rescale_job(StreamEnvironment, 4, 4), mesh=object(),
                       device="cpu", **_RS_KW)
    assert not r.failed


@pytest.mark.parametrize("shape", sorted(BOOT_SHAPES))
def test_bootstrap_standby_onto_a_mesh(runs, tmp_path, shape):
    """The whole job rebuilt by a fresh pair of ranks from the 2-rank
    mesh's checkpoint directory (read by rank 0 alone) and its mirror
    rows (on both ranks, in place of the replica transfer): the rebuilt
    canonical carry equals the dead mesh runner's at its last fence and
    the port's unsharded bootstrap of the same schedule and the
    reference's bootstrap from its own dead runner, the ranks together
    derived the roll-gap ledger the reference derives, each over its own
    subtasks on the pre-patch worker, and the next epoch stays equal."""
    want = _boot_run(str(tmp_path / "unsharded"), shape)
    ref = _ref_boot(str(tmp_path / "ref"), shape)
    assert want["steps_replayed"] == 4 and want["from_epoch"] == 3
    for k in ("steps_replayed", "from_epoch", "global_step", "roll_gap"):
        assert ref[k] == want[k], k
    got = [x[shape] for x in runs["boot"]]
    for x in got:
        for k in ("steps_replayed", "from_epoch", "global_step"):
            assert x[k] == want[k], k
        assert x["reattach"]
        _assert_leaves(x["rebuilt"], x["dead"], "rebuilt vs dead")
        _assert_leaves(x["rebuilt"], want["rebuilt"], "vs unsharded")
        _assert_leaves(x["rebuilt"], ref["rebuilt"], "vs reference")
        _assert_leaves(x["next"], x["next_dead"], "next vs dead")
        _assert_leaves(x["next"], want["next"], "next vs unsharded")
        _assert_leaves(x["next"], ref["next"], "next vs reference")
    assert sorted({kv for x in got for kv in x["roll_gap"]}) == \
        ref["roll_gap"]


def test_bootstrap_standby_refuses_rebalance_on_a_mesh(tmp_path):
    """Rebalance edges stay refused on a mesh (here one rank,
    in-process), as unsharded: their round-robin cursors are not in the
    fence snapshot."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.causal import recovery as rec
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    env = StreamEnvironment(name="rb", num_key_groups=8)
    env.synthetic_source(vocab=7, batch_size=4, parallelism=2) \
        .rebalance().sink(parallelism=2)
    try:
        with pytest.raises(rec.RecoveryError, match="rebalance"):
            ClusterRunner.bootstrap_standby(
                env.build(), str(tmp_path), {}, device="cpu",
                mesh=dist_.task_mesh(device="cpu"))
    finally:
        dist_.shutdown()


@pytest.mark.parametrize("parallelism", SOCKET_SHAPES)
def test_one_socket_reader_serves_every_rank(runs, tmp_path, parallelism):
    """One ``SocketFeedReader`` on rank 0 (one connection) feeds both
    ranks: rank 0 pulls every lane and sends each rank its lanes (the
    whole batch at parallelism 3, which does not split), the recovered
    feed source re-reads from rank 0's retention, and rank 0 commits
    every lane's offset. Committed offsets, cursors, the sealed ledger
    and the gathered carry equal the unsharded run's and the
    reference's, each on its own connection to the same lines."""
    from clonos_tpu_torch.obs.digest import diff_ledgers
    want = _socket_run(str(tmp_path / "unsharded"), _line_server(
        _socket_lines(parallelism)), parallelism)
    ref = _ref_socket(str(tmp_path / "ref"), parallelism)
    for k in ("bases_after_commit", "bases", "cursors", "lost",
              "records_replayed"):
        assert ref[k] == want[k], k
    assert diff_ledgers(ref["ledger"], want["ledger"]) == []
    _assert_leaves(want["canon"], ref["canon"], "unsharded vs reference")
    got = [x[parallelism] for x in runs["socket"]]
    assert want["records_replayed"] > 0 and want["lost"] == \
        [0] * parallelism
    assert got[1]["bases_after_commit"] is None
    for k in ("bases_after_commit", "bases", "cursors", "lost"):
        assert got[0][k] == want[k], k
    assert want["bases_after_commit"] == [SOCKET_SPE * SOCKET_B] \
        * parallelism
    assert [x["records_replayed"] for x in got] == \
        [want["records_replayed"]] * 2
    assert [x["managers"] for x in got] == ([1, 1] if parallelism == 2
                                           else [2, 2])
    for x in got:
        _assert_leaves(x["full"], want["full"])
    assert diff_ledgers(want["ledger"], got[0]["ledger"]) == []


def test_the_mesh_runs_on_rank_0s_causal_time(runs):
    """A causal clock that reads differently on each rank (as wall
    clocks do): every rank takes rank 0's readings at each block, so a
    replica's determinant rows equal its owner's on the other rank, the
    window subtask on rank 1 recovers, and the state before the kill and
    after the recovery equals the unsharded run's on rank 0's clock."""
    want = _clock_run()
    got = runs["clock"]
    assert got[0]["history"] == got[1]["history"] == want["history"]
    for x in got:
        assert (x["before"], x["after"]) == (want["before"], want["after"])
