"""PyTorch port, the read tier (``clonos_tpu_torch/runtime/serve.py``):
mirrors of the reference's ``tests/test_serve_replica.py``. Replicas
tail sealed-epoch windows and serve fence-consistent batched reads, and
degrade, never error, under replica loss. Each case runs the same
seeded job through the port and the reference and compares served
values, subtasks, key groups, epoch stamps, staleness and replica tables
exactly; the ``fence.*`` key sets with a tier attached and the sealed
ledger with and without one are held to the reference's."""

import threading
import time

import numpy as np
import pytest

from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu.runtime.serve import build_serve_tier as jax_tier
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.obs.digest import EpochDigest, diff_ledgers
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.query import QueryRejectedError
from clonos_tpu_torch.runtime.serve import (ReplicaStateClient,
                                            build_serve_tier)

VID = 1          # the reduce vertex in the job below
NUM_KEYS = 11
KEYS = list(range(NUM_KEYS))


def _job(env_cls):
    env = env_cls(name="serve", num_key_groups=16, default_edge_capacity=64)
    (env.synthetic_source(vocab=NUM_KEYS, batch_size=8, parallelism=2)
        .key_by().reduce(num_keys=NUM_KEYS, name="r").sink())
    return env.build()


def _kw(**kw):
    return dict(dict(steps_per_epoch=4, log_capacity=256, max_epochs=8,
                     inflight_ring_steps=16, seed=3, logical_time=True),
                **kw)


def make_runner(**kw):
    return ClusterRunner(_job(StreamEnvironment), device="cpu", **_kw(**kw))


def make_ref(**kw):
    return JaxRunner(_job(JaxEnv), heartbeat_timeout_s=600.0, **_kw(**kw))


def served_entry(epoch, values):
    """A ledger entry from one epoch's served values."""
    d = EpochDigest(int(epoch))
    d.fold("acc", np.asarray(values, np.int64).tobytes(), len(values))
    return d.to_entry()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "pipelined"])
def test_replica_serves_bit_identical_fence_state(overlap):
    """At every fence the replica serves byte for byte what the owner
    serves at the same epoch stamp, including across epochs whose
    checkpoint never completes (the tail, not the restore, keeps it
    fresh); its table equals the owner's ``vertex_state``, and every
    answer and table equals the reference replica's."""
    r, jr = make_runner(overlap_epoch=overlap), make_ref(overlap_epoch=overlap)
    tier, jtier = build_serve_tier(r, VID, n_replicas=1), None
    try:
        jtier = jax_tier(jr, VID, n_replicas=1)
        rep_c = tier.clients[0]
        owner_led, replica_led, epochs = [], [], []
        for e in range(4):
            # Odd epochs leave the checkpoint pending.
            for runner in (r, jr):
                runner.run_epoch(complete_checkpoint=(e % 2 == 0))
                runner.drain_fence()
            ro = tier.owner_client.query_batch(VID, KEYS)
            rr = rep_c.query_batch(VID, KEYS)
            assert rr["epoch"] == ro["epoch"]
            assert rr["staleness_epochs"] == 0
            assert rr["served_by"] == "replica-0"
            assert rr["subtasks"] == ro["subtasks"]
            assert rr["key_groups"] == ro["key_groups"]
            assert rr == jtier.clients[0].query_batch(VID, KEYS)
            assert ro == jtier.owner_client.query_batch(VID, KEYS)
            table, stamp = tier.replicas[0].host_view()
            jtable, jstamp = jtier.replicas[0].host_view()
            assert stamp == jstamp == rr["epoch"]
            np.testing.assert_array_equal(
                table, r.executor.vertex_state(VID)["acc"])
            assert table.dtype == jtable.dtype
            np.testing.assert_array_equal(table, jtable)
            epochs.append(rr["epoch"])
            owner_led.append(served_entry(ro["epoch"], ro["values"]))
            replica_led.append(served_entry(rr["epoch"], rr["values"]))
        assert epochs == sorted(set(epochs)), "fences advance, never tear"
        assert diff_ledgers(owner_led, replica_led) == []
        # Point reads go through the same gather: same values.
        for k in (0, 5, NUM_KEYS - 1):
            out = rep_c.query(VID, k)
            assert out["value"] == rr["values"][k]
            assert out["epoch"] == rr["epoch"]
            assert out == jtier.clients[0].query(VID, k)
        rep = tier.replicas[0]
        assert rep.tailable
        assert rep.applied_epochs >= 2, "odd epochs arrived via the tail"
        assert rep.status() == jtier.replicas[0].status()
    finally:
        tier.close()
        if jtier is not None:
            jtier.close()


def test_reads_rejected_before_first_seal():
    """No fence, no consistency point: the owner and the replica
    endpoint refuse reads (a typed, routable rejection) until the first
    epoch seals, then serve. An out-of-range key is a ``KeyError`` on
    both, not a rejection."""
    r = make_runner()
    tier = build_serve_tier(r, VID, n_replicas=1)
    try:
        with pytest.raises(QueryRejectedError):
            tier.owner_client.query(VID, 0)
        with pytest.raises(QueryRejectedError):
            tier.clients[0].query(VID, 0)
        r.run_epoch(complete_checkpoint=True)
        r.drain_fence()
        assert tier.owner_client.query(VID, 0)["epoch"] >= 0
        assert tier.clients[0].query(VID, 0)["epoch"] >= 0
        with pytest.raises(KeyError):
            tier.owner_client.query(VID, NUM_KEYS + 500)
        with pytest.raises(KeyError):
            tier.clients[0].query(VID, NUM_KEYS + 500)
        with pytest.raises(KeyError):
            tier.clients[0].query_batch(VID, [0, -1])
    finally:
        tier.close()


def _kill_cycle(runner, tier):
    """The reference test's chaos cycle; returns what it observed."""
    seen = {}
    for _ in range(2):
        runner.run_epoch(complete_checkpoint=True)
        runner.drain_fence()
    router = tier.router
    # a key whose group routes to replica 0
    k0 = next(k for k in KEYS
              if router.replica_for_group(router.key_group(k)) == 0)
    assert router.query(VID, k0)["served_by"] == "replica-0"
    owner_vals = tier.owner_client.query_batch(VID, KEYS)["values"]

    tier.kill_replica(0)
    seen["dead_staleness"] = tier.staleness()
    assert seen["dead_staleness"][0] >= 1, "dead replica is behind every seal"
    time.sleep(0.06)            # let the router's status cache expire
    reroutes0 = router.reroutes
    out = router.query(VID, k0)  # no exception: degradation, not error
    assert out.get("served_by", "owner") == "owner"
    assert out["value"] == owner_vals[k0] and out["rerouted"]
    assert router.reroutes > reroutes0
    batch = router.query_batch(VID, KEYS)
    assert batch["values"] == owner_vals
    seen["batch"] = batch

    runner.run_epoch(complete_checkpoint=True)   # next fence: revival
    runner.drain_fence()
    rep = tier.replicas[0]
    assert rep.alive and rep.revivals == 1
    assert tier.staleness()[0] == 0, "staleness recovered"
    time.sleep(0.06)
    seen["revived"] = router.query(VID, k0)
    assert seen["revived"]["served_by"] == "replica-0"
    seen["counts"] = (router.reads, router.reroutes, router.replica_reads,
                      router.owner_reads, router.errors)
    seen["status"] = [rep.status() for rep in tier.replicas]
    return seen


def test_replica_kill_reroutes_then_revives():
    """Kill a replica mid-run: every read still answers (rerouted to the
    owner, counted); staleness spikes while dead; the next fence revives
    it from the latest restore point and staleness recovers to zero —
    with the reference tier's observations on the same schedule."""
    r, jr = make_runner(), make_ref()
    tier = build_serve_tier(r, VID, n_replicas=2, staleness_bound=2)
    jtier = None
    try:
        jtier = jax_tier(jr, VID, n_replicas=2, staleness_bound=2)
        seen = _kill_cycle(r, tier)
        assert seen == _kill_cycle(jr, jtier)
        snap = r.metrics.snapshot()
        assert snap["serve.reroutes"] == seen["counts"][1] > 0
        assert snap["serve.replicas-alive"] == 2
        assert snap["serve.replica.0.staleness-epochs"] == 0
        jsnap = jr.metrics.snapshot()
        assert sorted(k for k in snap if k.startswith("serve.")) \
            == sorted(k for k in jsnap if k.startswith("serve."))
    finally:
        tier.close()
        if jtier is not None:
            jtier.close()


def test_endpoint_coalesces_reads_into_single_dispatches():
    """A wire batch of N keys costs one gather, and concurrent point
    lookups (one connection each) never out-dispatch their requests."""
    r = make_runner()
    tier = build_serve_tier(r, VID, n_replicas=1)
    try:
        r.run_epoch(complete_checkpoint=True)
        r.drain_fence()
        ep = tier.endpoints[0]
        rep_c = tier.clients[0]
        rep_c.query(VID, 0)
        d0, k0 = ep.dispatches, ep.keys_served
        keys = [k % NUM_KEYS for k in range(100)]
        out = rep_c.query_batch(VID, keys)
        assert ep.dispatches == d0 + 1, "one fused gather for the batch"
        assert ep.keys_served == k0 + len(keys)
        acc = r.executor.vertex_state(VID)["acc"]
        for k, v, s in zip(keys, out["values"], out["subtasks"]):
            assert v == int(acc[s, k])
        d1 = ep.dispatches
        results = {}

        def read(k):
            c = ReplicaStateClient(ep.address, timeout_s=10.0)
            try:
                results[k] = c.query(VID, k)["value"]
            finally:
                c.close()

        threads = [threading.Thread(target=read, args=(k,))
                   for k in range(NUM_KEYS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        assert results == {k: int(acc[:, k].sum()) for k in KEYS}
        assert ep.dispatches - d1 <= NUM_KEYS
    finally:
        tier.close()


def _fence_keys(phases):
    return {k for k in phases if k.startswith("fence")}


@pytest.mark.parametrize("overlap,audit", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_fence_key_sets_with_a_tier_equal_the_references(overlap, audit):
    """With a tier attached, every fence's ``fence.*`` key set (the serve
    feed's span among them) equals the reference runner's, in both fence
    modes, with the audit off and on."""
    kw = dict(overlap_epoch=overlap, audit=audit)
    r, jr = make_runner(**kw), make_ref(**kw)
    tier = build_serve_tier(r, VID, n_replicas=1)
    jtier = None
    try:
        jtier = jax_tier(jr, VID, n_replicas=1)
        mine, ref = [], []
        for e in range(3):
            for runner, out in ((r, mine), (jr, ref)):
                runner.run_epoch(complete_checkpoint=(e != 1))
                runner.drain_fence()
                out.append(_fence_keys(runner.last_fence_phases))
        assert mine == ref
        assert all("fence.serve-feed" in keys for keys in mine)
    finally:
        tier.close()
        if jtier is not None:
            jtier.close()


def test_serving_leaves_the_sealed_ledger_unchanged(tmp_path):
    """Attaching a tier (and reading through it at every fence) changes
    nothing the job seals: the pipelined, audited runner's ledger and
    canonical state equal the same runner's without a tier, and the
    reference's with one."""
    def run(make, tier_fn, root, with_tier):
        runner = make(overlap_epoch=True, audit=True,
                      checkpoint_dir=str(root))
        tier = tier_fn(runner, VID, n_replicas=2) if with_tier else None
        try:
            for e in range(4):
                runner.run_epoch(complete_checkpoint=(e != 2))
                if tier is not None:
                    tier.router.query_batch(VID, KEYS)
            runner.drain_fence()
            return runner.coordinator.read_ledger()
        finally:
            if tier is not None:
                tier.close()

    with_tier = run(make_runner, build_serve_tier, tmp_path / "a", True)
    without = run(make_runner, build_serve_tier, tmp_path / "b", False)
    ref = run(make_ref, jax_tier, tmp_path / "c", True)
    assert len(with_tier) == 4
    assert diff_ledgers(without, with_tier) == []
    assert diff_ledgers(ref, with_tier) == []


def test_serve_tier_rehomes_across_live_recut(tmp_path):
    """A live 2->4 re-cut under a read tier: reads in the handoff window
    answer the last fence (never an error); after ``tier.rehome(new)``
    the replica re-adopts in the new shape and serves the next fences
    with the owner's exact values, subtasks and epoch stamps, each
    answer equal to the reference tier's at the same point."""
    def recut_job(env_cls, keyed_par):
        env = env_cls(name=f"serve-recut-{keyed_par}", num_key_groups=16,
                      default_edge_capacity=64)
        (env.synthetic_source(vocab=NUM_KEYS, batch_size=8, parallelism=2)
            .key_by().reduce(num_keys=NUM_KEYS, parallelism=keyed_par,
                             name="r")
            .key_by().sink(parallelism=2))
        return env.build()

    kw = _kw()
    answers = {}
    for name, cls, env_cls, tier_fn, dev in (
            ("port", ClusterRunner, StreamEnvironment, build_serve_tier,
             {"device": "cpu"}),
            ("ref", JaxRunner, JaxEnv, jax_tier, {})):
        d = str(tmp_path / name)
        r = cls(recut_job(env_cls, 2), checkpoint_dir=d, **dev, **kw)
        tier = tier_fn(r, VID, n_replicas=1)
        try:
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
            before = tier.clients[0].query_batch(VID, KEYS)
            r2, stats = r.rescale_live(recut_job(env_cls, 4),
                                       checkpoint_dir=d, **dev, **kw)
            assert stats["transitions"][-1][0] == "redirect"
            mid = tier.clients[0].query_batch(VID, KEYS)
            assert mid["epoch"] == before["epoch"]
            assert mid["values"] == before["values"]
            tier.rehome(r2)
            again = tier.clients[0].query_batch(VID, KEYS)
            assert again["epoch"] == before["epoch"]
            assert again["values"] == before["values"]
            routed = tier.router.query_batch(VID, KEYS)
            assert routed["values"] == before["values"]
            r2.run_epoch(complete_checkpoint=True)
            r2.drain_fence()
            after = tier.clients[0].query_batch(VID, KEYS)
            owner = tier.owner_client.query_batch(VID, KEYS)
            assert after["epoch"] > before["epoch"]
            assert after["epoch"] == owner["epoch"]
            assert after["values"] == owner["values"]
            assert after["subtasks"] == owner["subtasks"]
            assert max(owner["subtasks"]) > 1, "4-wide ownership visible"
            assert after["staleness_epochs"] == 0
            assert tier.router.errors == 0
            answers[name] = (before, mid, again, after, owner,
                             tier.replicas[0].status())
        finally:
            tier.close()
    assert answers["port"] == answers["ref"]
