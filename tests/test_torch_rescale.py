"""PyTorch port, rescaling (``rescale_dense_table``, the operators'
``rescale_keyed_state``, ``ClusterRunner.restore_rescaled`` and
``rescale_live``, ``RescaleCoordinator``): mirrors of the reference's
``tests/test_rescale.py``, each run through the port and the reference on
the same seeded job and held to it exactly — rescaled tables, re-cut
edge buffers, sink multisets, refusals (error class and message prefix),
ledgers and the re-cut's ``stats`` — plus seeded call sequences through
both coordinators."""

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.api.operators import rescale_dense_table as jax_rescale
from clonos_tpu.causal import recovery as jax_rec
from clonos_tpu.graph.job_graph import PartitionType as JaxPartition
from clonos_tpu.parallel.routing import (key_group as jax_key_group,
                                         subtask_for_key_group as jax_owner)
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime import scheduler as jax_sched
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.api.operators import rescale_dense_table
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.convert import carry_to_numpy
from clonos_tpu_torch.graph.job_graph import PartitionType
from clonos_tpu_torch.obs import audit as audit_mod
from clonos_tpu_torch.obs.digest import diff_ledgers
from clonos_tpu_torch.parallel.routing import key_group, subtask_for_key_group
from clonos_tpu_torch.runtime import scheduler as sched
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils.tree import tree_leaves

VOCAB = 23
SINK_VID = 3
#: the window -> reduce edge, statically routed
STATIC_EDGE = 1


class TickTime:
    """Deterministic causal-time source: both incarnations (and both
    packages) see the same times, or windows fire at different steps."""

    def __init__(self, t0: int = 0, step: int = 3):
        self.t = t0
        self.step = step

    def now(self) -> int:
        self.t += self.step
        return self.t


def _job(env_cls, window_p, reduce_p):
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


def _cap_job(env_cls, window_p, cap):
    env = env_cls(name=f"cap-{window_p}-{cap}", num_key_groups=16,
                  default_edge_capacity=cap)
    (env.synthetic_source(vocab=VOCAB, batch_size=8, parallelism=2)
        .key_by()
        .window_count(num_keys=VOCAB, window_size=7, parallelism=window_p,
                      name="w")
        .key_by()
        .sink(parallelism=2))
    return env.build()


def _port(job, **kw):
    return ClusterRunner(job, device="cpu", **kw)


def _ref(job, **kw):
    return JaxRunner(job, heartbeat_timeout_s=600.0, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _collect_sink(runner, epochs, complete=False):
    """Run epochs, returning the sorted multiset of sink records."""
    got = []

    def absorb(outs, _epoch):
        b = outs.sinks.get(SINK_VID)
        if b is None:
            return
        k, v, t, m = (_np(x) for x in b)
        got.extend(zip(k[m].tolist(), v[m].tolist(), t[m].tolist()))

    runner.executor.on_block_outputs = absorb
    for _ in range(epochs):
        runner.run_epoch(complete_checkpoint=complete)
    runner.executor.on_block_outputs = None
    return sorted(got)


def _assert_tree_equal(port_tree, ref_tree):
    a = [np.asarray(x) for x in tree_leaves(carry_to_numpy(port_tree))]
    b = [np.asarray(x) for x in tree_leaves(
        jax.tree_util.tree_map(np.asarray, ref_tree))]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# --- restore_rescaled --------------------------------------------------------


@pytest.mark.parametrize("p_old,p_new", [(2, 4), (4, 2), (2, 3)])
def test_rescale_restore_identical_sink_output(p_old, p_new, tmp_path):
    """A checkpoint at ``p_old`` restores at ``p_new``: the port's tables
    and re-cut edge buffers equal the reference's, and its sink multiset
    over the next two epochs equals the reference's and the port's own
    never-rescaled run's. (2, 3) is the uneven cut the port adds."""
    spe = 6
    kw = dict(steps_per_epoch=spe, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=11)
    port = _port(_job(StreamEnvironment, p_old, p_old),
                 checkpoint_dir=str(tmp_path / "p"), **kw)
    ref = _ref(_job(JaxEnv, p_old, p_old),
               checkpoint_dir=str(tmp_path / "r"), **kw)
    for r in (port, ref):
        r.executor.time_source = TickTime()
        r.run_epoch(complete_checkpoint=True)
    fence_t = port.executor.time_source.t
    ckpt, jckpt = port.standbys.latest, ref.standbys.latest
    want = _collect_sink(port, 2)
    assert want == _collect_sink(ref, 2)

    res = ClusterRunner.restore_rescaled(
        _job(StreamEnvironment, p_new, p_new),
        _job(StreamEnvironment, p_old, p_old), ckpt, device="cpu", **kw)
    jres = JaxRunner.restore_rescaled(
        _job(JaxEnv, p_new, p_new), _job(JaxEnv, p_old, p_old), jckpt, **kw)
    c, jc = res.executor.carry, jres.executor.carry
    _assert_tree_equal(c.op_states, jc.op_states)
    _assert_tree_equal(c.edge_bufs, jc.edge_bufs)
    _assert_tree_equal(c.record_counts, jc.record_counts)
    for r in (res, jres):
        r.executor.time_source = TickTime(t0=fence_t)
    got = _collect_sink(res, 2)
    assert got == want and len(got) > 0
    assert got == _collect_sink(jres, 2)

    # The rescaled keyed tables respect the new ownership exactly.
    acc = np.asarray(res.executor.vertex_state(2)["acc"])
    kg = key_group(torch.arange(VOCAB, dtype=torch.int32), 16)
    owner = subtask_for_key_group(kg, p_new, 16).numpy()
    for s in range(p_new):
        assert not np.any(acc[s][owner != s])


def test_rescale_dense_table_conserves_and_partitions():
    """The port's ``rescale_dense_table`` equals the reference's on
    disjoint tables (content conserved, partitioned by the new owner)
    and on tables near ±2**31, where the int32 sums wrap, with a fill."""
    rng = np.random.RandomState(0)
    G, K = 16, VOCAB
    kg = np.asarray(jax_key_group(jnp.arange(K), G))
    np.testing.assert_array_equal(
        kg, key_group(torch.arange(K, dtype=torch.int32), G).numpy())
    for p_old, p_new in ((2, 4), (4, 2), (3, 5), (2, 3)):
        owner_old = np.asarray(jax_owner(jnp.asarray(kg), p_old, G))
        table = np.zeros((p_old, K), np.int32)
        for k in range(K):
            table[owner_old[k], k] = rng.randint(1, 100)
        out = rescale_dense_table(torch.from_numpy(table), p_new, G)
        assert out.dtype == torch.int32 and out.shape == (p_new, K)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jax_rescale(jnp.asarray(table), p_new,
                                                G)))
        np.testing.assert_array_equal(out.numpy().sum(axis=0),
                                      table.sum(axis=0))
        owner_new = np.asarray(jax_owner(jnp.asarray(kg), p_new, G))
        for s in range(p_new):
            assert not np.any(out.numpy()[s][owner_new != s])
        # Values near the int32 edges in every row: the sum wraps.
        big = rng.randint(2 ** 31 - 50, 2 ** 31, (p_old, 2, K),
                          dtype=np.int64)
        sign = np.where(rng.rand(p_old, 2, K) < 0.5, -1, 1)
        edge = (big * sign).astype(np.int32)
        for fill in (0, -7, 2 ** 31 - 1):
            got = rescale_dense_table(torch.from_numpy(edge), p_new, G,
                                      fill=fill)
            want = np.asarray(jax_rescale(jnp.asarray(edge), p_new, G,
                                          fill=fill))
            assert got.dtype == torch.int32 and want.dtype == np.int32
            np.testing.assert_array_equal(got.numpy(), want)


def _refusal(fn, jfn):
    """Both packages raise RecoveryError with the same message up to the
    first shape or number."""
    with pytest.raises(rec.RecoveryError) as ei:
        fn()
    with pytest.raises(jax_rec.RecoveryError) as ej:
        jfn()
    a, b = str(ei.value), str(ej.value)
    n = min(len(a), len(b), 40)
    assert a[:n] == b[:n], (a, b)
    return a


def test_rescale_rejects_non_hash_edges():
    def make(env_cls, reduce_p):
        env = env_cls(name="fwd", num_key_groups=8,
                      default_edge_capacity=16)
        (env.synthetic_source(vocab=5, batch_size=4, parallelism=2)
            .key_by().reduce(num_keys=5, parallelism=reduce_p)
            .sink(parallelism=2))
        return env.build()

    kw = dict(steps_per_epoch=4, log_capacity=128, max_epochs=8,
              inflight_ring_steps=8, seed=1)
    r = _port(make(StreamEnvironment, 2), **kw)
    jr = _ref(make(JaxEnv, 2), **kw)
    r.run_epoch(complete_checkpoint=True)
    jr.run_epoch(complete_checkpoint=True)
    jobs = [make(StreamEnvironment, 4), make(StreamEnvironment, 2)]
    jjobs = [make(JaxEnv, 4), make(JaxEnv, 2)]
    for j in jobs:
        j.edges[0].partition = PartitionType.FORWARD
    for j in jjobs:
        j.edges[0].partition = JaxPartition.FORWARD
    msg = _refusal(
        lambda: ClusterRunner.restore_rescaled(
            *jobs, r.standbys.latest, device="cpu", **kw),
        lambda: JaxRunner.restore_rescaled(*jjobs, jr.standbys.latest,
                                           **kw))
    assert "is not HASH-partitioned" in msg


def test_restore_rescaled_topology_mismatch():
    def short(env_cls):
        env = env_cls(name="topo", num_key_groups=16,
                      default_edge_capacity=96)
        (env.synthetic_source(vocab=VOCAB, batch_size=8, parallelism=2)
            .key_by().reduce(num_keys=VOCAB, parallelism=2, name="r")
            .key_by().sink(parallelism=2))
        return env.build()

    kw = dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=1)
    r = _port(_job(StreamEnvironment, 2, 2), **kw)
    jr = _ref(_job(JaxEnv, 2, 2), **kw)
    r.run_epoch(complete_checkpoint=True)
    jr.run_epoch(complete_checkpoint=True)
    msg = _refusal(
        lambda: ClusterRunner.restore_rescaled(
            short(StreamEnvironment), r.job, r.standbys.latest,
            device="cpu", **kw),
        lambda: JaxRunner.restore_rescaled(short(JaxEnv), jr.job,
                                           jr.standbys.latest, **kw))
    assert "topology mismatch" in msg


def test_restore_rescaled_edge_buffer_overflow_fails_loud():
    kw = dict(steps_per_epoch=5, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=2)
    r = _port(_cap_job(StreamEnvironment, 4, 96), **kw)
    jr = _ref(_cap_job(JaxEnv, 4, 96), **kw)
    r.run_epoch(complete_checkpoint=True)
    jr.run_epoch(complete_checkpoint=True)
    buf = r.standbys.latest.carry.edge_bufs[0]
    assert int(buf.valid.sum()) > 8, \
        "fixture must capture enough in-flight records to overflow"
    msg = _refusal(
        lambda: ClusterRunner.restore_rescaled(
            _cap_job(StreamEnvironment, 1, 8),
            _cap_job(StreamEnvironment, 4, 8), r.standbys.latest,
            device="cpu", **kw),
        lambda: JaxRunner.restore_rescaled(
            _cap_job(JaxEnv, 1, 8), _cap_job(JaxEnv, 4, 8),
            jr.standbys.latest, **kw))
    assert "overflows capacity" in msg


def test_rescale_keyed_state_roundtrip_up_down():
    """Up then back down is the identity on a real run's keyed operator
    states; both overrides equal the reference's at every step, the
    window's carried window id a fresh tensor."""
    kw = dict(steps_per_epoch=6, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=7)
    r = _port(_job(StreamEnvironment, 2, 2), **kw)
    jr = _ref(_job(JaxEnv, 2, 2), **kw)
    for x in (r, jr):
        x.executor.time_source = TickTime()
        x.run_epoch(complete_checkpoint=True)
    G = r.job.num_key_groups
    for vid in (1, 2):                          # window, reduce
        op = r.job.vertices[vid].operator
        jop = jr.job.vertices[vid].operator
        st = r.executor.carry.op_states[vid]
        jst = jr.executor.carry.op_states[vid]
        _assert_tree_equal(st, jst)
        for p in (4, 3):
            up = op.rescale_keyed_state(st, p, G)
            _assert_tree_equal(up, jop.rescale_keyed_state(jst, p, G))
            for x in up.values():
                assert x.is_contiguous() and x.dtype == torch.int32
            back = op.rescale_keyed_state(up, 2, G)
            _assert_tree_equal(back, jst)
        if "window" in st:
            up = op.rescale_keyed_state(st, 4, G)
            up["window"][0] += 1               # no alias between lanes
            assert int(up["window"][1]) == int(st["window"].max())
    with pytest.raises(NotImplementedError, match="does not support"):
        r.job.vertices[0].operator.rescale_keyed_state({}, 4, G)


# --- the live re-cut ---------------------------------------------------------


def _live_kw():
    return dict(steps_per_epoch=6, log_capacity=256, max_epochs=8,
                inflight_ring_steps=16, seed=11)


def test_rescale_live_handoff_exactly_once(tmp_path):
    """A 2->4 re-cut at a completed fence, through both packages: the
    port's sink output equals a never-rescaled control's and the
    reference's, the transitions come fence -> drain -> migrate ->
    redirect, the old incarnation is fenced off, the cross-layout diff
    is clean and the exact diff is not, the port's ledger and ``stats``
    equal the reference's, and a failure after the re-cut recovers at
    the new parallelism."""
    kw = _live_kw()
    ctl = _port(_job(StreamEnvironment, 2, 2),
                checkpoint_dir=str(tmp_path / "a"), audit=True, **kw)
    ctl.executor.time_source = TickTime()
    want = _collect_sink(ctl, 4, complete=True)

    runs = {}
    for name, mk, env_cls, kw_dev in (
            ("port", _port, StreamEnvironment, {"device": "cpu"}),
            ("ref", _ref, JaxEnv, {})):
        d = str(tmp_path / name)
        r = mk(_job(env_cls, 2, 2), checkpoint_dir=d, audit=True, **kw)
        r.executor.time_source = TickTime()
        got = _collect_sink(r, 1, complete=True)
        seen = []
        r2, stats = r.rescale_live(
            _job(env_cls, 4, 4),
            observers=[lambda kind, **f: seen.append(kind)],
            checkpoint_dir=d, audit=True, **kw_dev, **kw)
        got += _collect_sink(r2, 3, complete=True)
        runs[name] = (r, r2, stats, sorted(got), seen)
    r, r2, stats, got, seen = runs["port"]
    jr, jr2, jstats, jgot, jseen = runs["ref"]
    assert got == want == jgot and len(want) > 0
    assert r2.device.type == "cpu"

    kinds = [k for k, _ in stats["transitions"]]
    assert kinds == seen == jseen
    assert kinds[0] == "fence" and kinds[-1] == "redirect"
    assert kinds.count("migrate") == stats["groups"]
    assert stats["drained_records"] > 0
    assert stats["moved_key_groups"] and all(
        m > 0 for m in stats["moved_key_groups"].values())
    for key in ("fence_checkpoint", "from_epoch", "groups",
                "drained_records", "moved_key_groups", "transitions"):
        assert stats[key] == jstats[key], key

    with pytest.raises(rec.RecoveryError):
        r.run_epoch()                    # stale writer: fenced off
    with pytest.raises(rec.RecoveryError):
        r.step()

    led = r2.auditor.ledger()
    assert _without_source_logs(led, stats["from_epoch"]) == \
        _without_source_logs(jr2.auditor.ledger(), stats["from_epoch"])
    # The port re-appends the fence's SOURCE_CHECKPOINT rows in the new
    # incarnation (the reference does not): its sources' first epoch
    # after the re-cut seals as the control's.
    e = stats["from_epoch"]
    for f in (0, 1):
        assert led[e]["channels"][f"log/{f}"] == \
            ctl.auditor.ledger()[e]["channels"][f"log/{f}"]
    assert audit_mod.diff_ledgers_cross(ctl.auditor.ledger(), led) == []
    assert diff_ledgers(ctl.auditor.ledger(), led), \
        "exact diff must refuse across layouts (mapped path engaged)"
    assert r2.last_sealed_epoch == jr2.last_sealed_epoch

    # a failure AFTER the re-cut recovers at the new parallelism
    r2.inject_failure([2])
    assert r2.recover() is not None
    jr2.inject_failure([2])
    jr2.recover()
    _assert_tree_equal(r2.executor.carry.op_states,
                       jr2.executor.carry.op_states)


def test_rescale_live_recovers_in_first_epoch_after_recut(tmp_path):
    """A window subtask killed in the first epoch after the re-cut
    recovers from the new-shape restore point: its carry and the
    ledger equal a re-cut run that never failed, on the port, and the
    reference's faulted run."""
    kw = _live_kw()
    out = {}
    for name, mk, env_cls, kw_dev, kill in (
            ("golden", _port, StreamEnvironment, {"device": "cpu"}, False),
            ("faulted", _port, StreamEnvironment, {"device": "cpu"}, True),
            ("ref", _ref, JaxEnv, {}, True)):
        d = str(tmp_path / name)
        r = mk(_job(env_cls, 2, 2), checkpoint_dir=d, audit=True, **kw)
        r.executor.time_source = TickTime()
        r.run_epoch(complete_checkpoint=True)
        r2, _ = r.rescale_live(_job(env_cls, 4, 4), checkpoint_dir=d,
                               audit=True, **kw_dev, **kw)
        for _ in range(3):
            r2.step()
        if kill:
            r2.inject_failure([2 + 3])      # window subtask 3 at P=4
            r2.recover()
        r2.run_epoch(complete_checkpoint=True)
        r2.run_epoch(complete_checkpoint=True)
        out[name] = r2
    g, f, j = out["golden"], out["faulted"], out["ref"]
    _assert_tree_equal(f.executor.carry.op_states,
                       j.executor.carry.op_states)
    for a, b in zip(tree_leaves(g.executor.carry.op_states),
                    tree_leaves(f.executor.carry.op_states)):
        assert torch.equal(a, b)
    assert f.auditor.ledger() == g.auditor.ledger()
    assert _without_source_logs(f.auditor.ledger(), 1) == \
        _without_source_logs(j.auditor.ledger(), 1)


def _without_source_logs(ledger, epoch, sources=(0, 1)):
    """The ledger with what the sources' log channels of ``epoch`` fold
    into (the channels, the row and record totals, the combined digest)
    dropped."""
    out = []
    for e in ledger:
        e = dict(e)
        if e["epoch"] == epoch:
            for k in ("combined", "records", "det_counts"):
                e.pop(k)
            e["channels"] = {k: v for k, v in e["channels"].items()
                             if k not in {f"log/{f}" for f in sources}}
        out.append(e)
    return out


def _round_trip(tmp_path, cuts, epochs):
    """A never-rescaled control over ``epochs`` epochs, and per package a
    run re-cut 2 -> 4 -> 2 at the fences after ``cuts`` epochs: their
    ``diff_ledgers_cross`` against the control."""
    kw = _live_kw()
    ctl = _port(_job(StreamEnvironment, 2, 2),
                checkpoint_dir=str(tmp_path / "c"), audit=True, **kw)
    ctl.executor.time_source = TickTime()
    for _ in range(epochs):
        ctl.run_epoch(complete_checkpoint=True)
    diffs = {}
    for name, mk, env_cls, kw_dev in (
            ("port", _port, StreamEnvironment, {"device": "cpu"}),
            ("ref", _ref, JaxEnv, {})):
        d = str(tmp_path / name)
        r = mk(_job(env_cls, 2, 2), checkpoint_dir=d, audit=True, **kw)
        r.executor.time_source = TickTime()
        done = 0
        for p, at in zip((4, 2), cuts):
            while done < at:
                r.run_epoch(complete_checkpoint=True)
                done += 1
            r, _ = r.rescale_live(_job(env_cls, p, p), checkpoint_dir=d,
                                  audit=True, **kw_dev, **kw)
        while done < epochs:
            r.run_epoch(complete_checkpoint=True)
            done += 1
        diffs[name] = audit_mod.diff_ledgers_cross(ctl.auditor.ledger(),
                                                   r.auditor.ledger())
    return diffs


def test_rescale_live_round_trip_seals_as_never_rescaled(tmp_path):
    """A 2 -> 4 -> 2 round trip (cuts at fences 0 and 2, where the
    window -> reduce buffer is empty): back in the control's layout, the
    port's ledger equals a never-rescaled control's epoch for epoch. The
    reference's does not: its re-cut leaves out the fence's
    SOURCE_CHECKPOINT rows, so the first epoch after the return seals
    each source log one row short (a fault of the reference, held here
    as found)."""
    diffs = _round_trip(tmp_path, cuts=(1, 3), epochs=5)
    assert diffs["port"] == []
    assert diffs["ref"] == [
        "epoch 3 channel log/0: record count 24 != expected 25"]


def test_recut_over_an_in_flight_static_route_buffer_as_the_reference(
        tmp_path):
    """A re-cut at a fence whose window -> reduce buffer holds records
    (the window fired on the epoch's last step). The port places that
    statically routed buffer by the new job's static plan, and its
    ledger equals a never-rescaled control's epoch for epoch. The
    reference re-routes it through the hash exchange, placing records at
    arrival ranks where the reduce reads static key slots, and its
    reduce's output diverges (a fault of the reference, ROADMAP Queue 3
    item 5, held here as found)."""
    diffs = _round_trip(tmp_path, cuts=(2,), epochs=4)
    assert diffs["port"] == []
    assert diffs["ref"][0].startswith(
        "epoch 2 channel ringsum/v2: content sum")


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("start,cuts,epochs", [
    (2, ((4, 2),), 4),
    (4, ((2, 2),), 4),
    (2, ((4, 2), (2, 4)), 6),
], ids=["2to4", "4to2", "2to4to2"])
def test_recut_places_a_fired_static_route_buffer_by_the_new_plan(
        tmp_path, start, cuts, epochs, overlap):
    """The port's re-cuts over a window -> reduce buffer that holds
    records (the window fires on the last step of epochs 2 and 4): 2 ->
    4, 4 -> 2 and the round trip 2 -> 4 -> 2, with the sequential and the
    pipelined fence, each seal every epoch equal to a never-rescaled
    control's (``diff_ledgers_cross``)."""
    kw = dict(_live_kw(), overlap_epoch=overlap)
    ctl = _port(_job(StreamEnvironment, start, start),
                checkpoint_dir=str(tmp_path / "c"), audit=True, **kw)
    ctl.executor.time_source = TickTime()
    for _ in range(epochs):
        ctl.run_epoch(complete_checkpoint=True)
    ctl.drain_fence()
    d = str(tmp_path / "r")
    r = _port(_job(StreamEnvironment, start, start), checkpoint_dir=d,
              audit=True, **kw)
    r.executor.time_source = TickTime()
    done = 0
    for p, at in cuts:
        while done < at:
            r.run_epoch(complete_checkpoint=True)
            done += 1
        r.drain_fence()
        held = int(r.executor.carry.edge_bufs[STATIC_EDGE].valid.sum())
        assert STATIC_EDGE in r.executor.compiled.static_route
        assert held > 0, f"the static buffer at fence {at} is empty"
        r, stats = r.rescale_live(_job(StreamEnvironment, p, p),
                                  checkpoint_dir=d, audit=True,
                                  device="cpu", **kw)
        assert stats["drained_records"] >= held
    while done < epochs:
        r.run_epoch(complete_checkpoint=True)
        done += 1
    r.drain_fence()
    assert audit_mod.diff_ledgers_cross(ctl.auditor.ledger(),
                                        r.auditor.ledger()) == []


def test_restore_rescaled_refuses_a_static_record_without_a_slot(
        tmp_path):
    """A valid record in a statically routed buffer whose key the new
    plan carries in no slot cannot be placed: ``restore_rescaled``
    raises rather than drop it."""
    kw = _live_kw()
    r = _port(_job(StreamEnvironment, 2, 2),
              checkpoint_dir=str(tmp_path / "r"), **kw)
    r.executor.time_source = TickTime()
    for _ in range(2):
        r.run_epoch(complete_checkpoint=True)
    ckpt = r.standbys.latest
    buf = ckpt.carry.edge_bufs[STATIC_EDGE]
    assert _np(buf.valid).any()
    bad = buf._replace(keys=np.where(_np(buf.valid), VOCAB + 5,
                                     _np(buf.keys)).astype(np.int32))
    bufs = list(ckpt.carry.edge_bufs)
    bufs[STATIC_EDGE] = bad
    ckpt = dataclasses.replace(
        ckpt, carry=ckpt.carry._replace(edge_bufs=tuple(bufs)))
    with pytest.raises(rec.RecoveryError, match="no slot of their own"):
        ClusterRunner.restore_rescaled(
            _job(StreamEnvironment, 4, 4), r.job, ckpt, device="cpu",
            **kw)


def test_rescale_live_guards_refuse_bad_fences(tmp_path):
    """No completed checkpoint, a mid-epoch caller, failed subtasks, or a
    completed checkpoint that is not the current fence cannot start a
    re-cut, on either package, with the same refusal."""
    kw = dict(steps_per_epoch=6, log_capacity=256, max_epochs=8,
              inflight_ring_steps=16, seed=3)
    pd, jd = str(tmp_path / "p"), str(tmp_path / "r")
    r = _port(_job(StreamEnvironment, 2, 2), checkpoint_dir=pd, **kw)
    jr = _ref(_job(JaxEnv, 2, 2), checkpoint_dir=jd, **kw)
    new = lambda: _job(StreamEnvironment, 4, 4)
    jnew = lambda: _job(JaxEnv, 4, 4)
    msg = _refusal(lambda: r.rescale_live(new(), checkpoint_dir=pd, **kw),
                   lambda: jr.rescale_live(jnew(), checkpoint_dir=jd, **kw))
    assert "no completed" in msg
    for x in (r, jr):
        x.run_epoch(complete_checkpoint=True)
        x.step()                             # mid-epoch now
    msg = _refusal(lambda: r.rescale_live(new(), checkpoint_dir=pd, **kw),
                   lambda: jr.rescale_live(jnew(), checkpoint_dir=jd, **kw))
    assert "mid-epoch" in msg
    for x in (r, jr):
        x.run_epoch(complete_checkpoint=False)   # fence 1, pending
    msg = _refusal(lambda: r.rescale_live(new(), checkpoint_dir=pd, **kw),
                   lambda: jr.rescale_live(jnew(), checkpoint_dir=jd, **kw))
    assert "is not the current fence" in msg
    for x in (r, jr):
        x.inject_failure([2])
    msg = _refusal(lambda: r.rescale_live(new(), checkpoint_dir=pd, **kw),
                   lambda: jr.rescale_live(jnew(), checkpoint_dir=jd, **kw))
    assert "failed subtasks" in msg


# --- the coordinator ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_rescale_coordinator_streams_equal_reference(seed):
    """Seeded random call sequences (legal and illegal) through both
    coordinators: the same observed stream, the same error types at the
    same calls, and the same final phase."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 5))
    coords = []
    for mod in (sched, jax_sched):
        c = mod.RescaleCoordinator(n)
        seen = []
        c.transition_observers.append(
            lambda kind, seen=seen, **f: seen.append(
                (kind, tuple(sorted(f.items())))))
        coords.append((mod, c, seen))
    ops = ("note", "fence", "drain", "migrate", "redirect")
    for _ in range(60):
        op = ops[rng.randint(len(ops))]
        g = int(rng.randint(-1, n + 1))
        k = int(rng.randint(-2, 4))
        outcomes = []
        for mod, c, _seen in coords:
            try:
                if op == "note":
                    c.note_inflight(g, k)
                elif op == "fence":
                    c.fence(k)
                elif op == "drain":
                    c.drain(g, k)
                elif op == "migrate":
                    c.migrate(g)
                else:
                    c.redirect()
                outcomes.append(None)
            except mod.RescaleProtocolError as e:
                outcomes.append(("protocol", str(e)))
            except ValueError as e:
                outcomes.append(("value", str(e)))
        assert outcomes[0] == outcomes[1], (op, g, k)
    (_, a, sa), (_, b, sb) = coords
    assert sa == sb
    assert (a.phase, a.inflight, a.migrated, a.fence_checkpoint) == \
        (b.phase, b.inflight, b.migrated, b.fence_checkpoint)
    with pytest.raises(ValueError):
        sched.RescaleCoordinator(0)
