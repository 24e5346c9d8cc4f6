"""PyTorch port, the read tier's key-group routing
(``clonos_tpu_torch/runtime/serve.py``): mirrors of the reference's
``tests/test_serve_router.py``. The router is duck-typed, so its policy
(key -> key group -> replica, staleness bound, reroute on a liveness
failure) is tested against fake endpoints, without a cluster. The
serve gather is held against the reference's jitted ``_gather_fn`` on
the same table and padded keys, and against the host routing every
other read path uses."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from clonos_tpu.runtime import serve as jserve
from clonos_tpu.runtime.query import owner_subtask_np as jowner_subtask_np
from clonos_tpu_torch.runtime.query import (QueryRejectedError,
                                            QueryTimeoutError,
                                            QueryableStateClient,
                                            owner_subtask_np)
from clonos_tpu_torch.runtime.serve import ServeRouter, _bucket, _gather_fn

G = 64  # key groups


class FakeEndpoint:
    """Duck-typed endpoint: records traffic, serves value = key * 10,
    and fails on demand — status liveness and query liveness are
    separate knobs because a replica can probe healthy yet time out on
    the read itself."""

    def __init__(self, name, epoch=5, staleness=0, alive=True,
                 status_exc=None, query_exc=None):
        self.name = name
        self.epoch = epoch
        self.staleness = staleness
        self.alive = alive
        self.status_exc = status_exc
        self.query_exc = query_exc
        self.queried = []

    def status(self):
        if self.status_exc is not None:
            raise self.status_exc
        return {"epoch": self.epoch,
                "staleness_epochs": self.staleness, "alive": self.alive}

    def query(self, vertex, key, state="acc"):
        if self.query_exc is not None:
            raise self.query_exc
        self.queried.append(key)
        return {"value": key * 10, "epoch": self.epoch,
                "staleness_epochs": self.staleness,
                "served_by": self.name}

    def query_batch(self, vertex, keys, state="acc"):
        if self.query_exc is not None:
            raise self.query_exc
        self.queried.extend(keys)
        return {"values": [k * 10 for k in keys], "epoch": self.epoch,
                "staleness_epochs": self.staleness,
                "served_by": self.name}


def make_router(replicas, staleness_bound=2):
    owner = FakeEndpoint("owner", epoch=5, staleness=0)
    # ttl=0 => every routing decision re-probes; no cache staleness in
    # the tests themselves.
    return owner, ServeRouter(owner, replicas, num_key_groups=G,
                              staleness_bound=staleness_bound,
                              status_ttl_s=0.0)


# --- owner assignment --------------------------------------------------


def test_every_key_exactly_one_owner():
    """The host key->owner map is total, deterministic, in range, and
    equal to the reference's: each key lands on exactly one subtask."""
    keys = np.arange(997)
    kg1, sub1 = owner_subtask_np(keys, 8, G)
    kg2, sub2 = owner_subtask_np(keys, 8, G)
    assert np.array_equal(kg1, kg2) and np.array_equal(sub1, sub2)
    assert kg1.shape == sub1.shape == keys.shape
    assert kg1.min() >= 0 and kg1.max() < G
    assert sub1.min() >= 0 and sub1.max() < 8
    # ownership is a pure function of the key group
    owners_per_group = {}
    for kg, sub in zip(kg1.tolist(), sub1.tolist()):
        assert owners_per_group.setdefault(kg, sub) == sub
    jkg, jsub = jowner_subtask_np(keys, 8, G)
    assert kg1.dtype == jkg.dtype and sub1.dtype == jsub.dtype
    np.testing.assert_array_equal(kg1, jkg)
    np.testing.assert_array_equal(sub1, jsub)


@pytest.mark.parametrize("P,K,n", [(4, 101, 101), (8, 997, 200)])
def test_device_gather_agrees_with_host_routing(P, K, n):
    """The serve gather's (value, subtask, key_group) equal the
    reference's jitted gather on the same table and padded keys, and
    the host twin's byte for byte."""
    rng = np.random.RandomState(P * 1000 + K)
    acc = rng.randint(-2 ** 31, 2 ** 31 - 1, (P, K)).astype(np.int32)
    keys = np.zeros(_bucket(n), np.int32)
    keys[:n] = rng.randint(0, K, n)
    vals_t, subs_t, kgs_t = _gather_fn(P, G)(torch.from_numpy(acc),
                                             torch.from_numpy(keys))
    vals_j, subs_j, kgs_j = jserve._gather_fn(P, G)(acc, keys)
    for mine, ref in ((vals_t, vals_j), (subs_t, subs_j), (kgs_t, kgs_j)):
        ref = np.asarray(ref)
        assert mine.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(mine.numpy(), ref)
    kg_h, sub_h = owner_subtask_np(keys, P, G)
    np.testing.assert_array_equal(kgs_t.numpy().astype(np.int64), kg_h)
    np.testing.assert_array_equal(subs_t.numpy().astype(np.int64), sub_h)
    np.testing.assert_array_equal(vals_t.numpy(), acc[sub_h, keys])


def test_bucket_padding_is_pow2_bounded():
    for n in (1, 63, 64, 65, 300, 4096, 5000):
        assert _bucket(n) == jserve._bucket(n)
    assert _bucket(1) == 64 and _bucket(64) == 64
    assert _bucket(65) == 128 and _bucket(4096) == 4096


# --- routing policy ----------------------------------------------------


def test_router_prefers_fresh_replica():
    reps = [FakeEndpoint("replica-0"), FakeEndpoint("replica-1")]
    owner, router = make_router(reps)
    for key in range(40):
        out = router.query(0, key)
        assert out["value"] == key * 10
        i = router.key_group(key) % 2
        assert out["served_by"] == f"replica-{i}"
    assert router.replica_reads == 40 and router.owner_reads == 0
    assert router.reroutes == 0 and not owner.queried


def test_router_skips_stale_replica_for_owner():
    """A replica past the staleness bound is skipped: the read lands on
    the owner and is counted as a reroute, not an error."""
    stale = FakeEndpoint("replica-0", staleness=5)
    owner, router = make_router([stale], staleness_bound=2)
    out = router.query(0, 7)
    assert out["served_by"] == "owner" and out["value"] == 70
    assert router.reroutes == 1 and router.owner_reads == 1
    assert not stale.queried
    # at the bound is still usable — the bound is inclusive.
    stale.staleness = 2
    assert router.query(0, 7)["served_by"] == "replica-0"


def test_router_reroutes_on_dead_or_failing_replica():
    """Liveness failures (dead status, rejection, timeout, transport)
    reroute to the owner with zero client-visible exceptions."""
    for bad in (
        FakeEndpoint("r", alive=False),
        FakeEndpoint("r", status_exc=QueryTimeoutError(("h", 1), 3, 0.1)),
        FakeEndpoint("r", query_exc=QueryRejectedError("replica dead")),
        FakeEndpoint("r", query_exc=OSError("connection reset")),
    ):
        owner, router = make_router([bad])
        out = router.query(0, 3)
        assert out["served_by"] == "owner" and out["value"] == 30
        assert router.reroutes == 1 and router.owner_reads == 1
        assert router.reads == 1


def test_router_with_no_replicas_serves_from_owner():
    owner, router = make_router([])
    out = router.query(0, 11)
    assert out["served_by"] == "owner"
    # owner-only is the configured topology, not a degradation.
    assert router.reroutes == 0


def test_batch_routing_preserves_order_and_provenance():
    """query_batch groups keys per destination, one wire request per
    group, and reassembles results in input order with per-key
    provenance."""
    stale = FakeEndpoint("replica-0", staleness=9)
    fresh = FakeEndpoint("replica-1")
    owner, router = make_router([stale, fresh], staleness_bound=2)
    keys = list(range(50))
    out = router.query_batch(0, keys)
    assert out["values"] == [k * 10 for k in keys]
    for pos, k in enumerate(keys):
        want = ("replica-1" if router.key_group(k) % 2 == 1
                else "owner")
        assert out["served_by"][pos] == want
    n_stale = sum(1 for k in keys if router.key_group(k) % 2 == 0)
    assert 0 < n_stale < len(keys)  # both destinations exercised
    assert router.reroutes == n_stale
    assert router.owner_reads == n_stale
    assert router.replica_reads == len(keys) - n_stale
    assert not stale.queried
    assert sorted(owner.queried + fresh.queried) == keys
    # The reference router over the same fakes: same answer, same counts.
    jrouter = jserve.ServeRouter(
        FakeEndpoint("owner"), [FakeEndpoint("replica-0", staleness=9),
                                FakeEndpoint("replica-1")],
        num_key_groups=G, staleness_bound=2, status_ttl_s=0.0)
    assert jrouter.query_batch(0, keys) == out
    assert [(jrouter.reroutes, jrouter.owner_reads, jrouter.replica_reads)
            ] == [(router.reroutes, router.owner_reads,
                   router.replica_reads)]


def test_batch_reroutes_midflight_failure():
    """A replica that probes healthy but fails the read itself: its
    whole group falls back to the owner, counted per key."""
    flaky = FakeEndpoint("replica-0",
                         query_exc=QueryTimeoutError(("h", 1), 3, 0.1))
    owner, router = make_router([flaky])
    keys = list(range(16))
    out = router.query_batch(0, keys)
    assert out["values"] == [k * 10 for k in keys]
    assert set(out["served_by"]) == {"owner"}
    assert router.reroutes == len(keys)


def test_status_probe_cache_ttl():
    """Within the TTL the router reuses the cached probe instead of
    doubling every read's round trips."""
    rep = FakeEndpoint("replica-0")
    probes = {"n": 0}
    real = rep.status

    def counting_status():
        probes["n"] += 1
        return real()

    rep.status = counting_status
    owner = FakeEndpoint("owner")
    router = ServeRouter(owner, [rep], num_key_groups=G,
                         staleness_bound=2, status_ttl_s=60.0)
    for key in range(10):
        router.query(0, key)
    assert probes["n"] == 1


# --- client timeout discipline (satellite: typed QueryTimeoutError) ----


def test_query_timeout_typed_and_bounded():
    """Against an endpoint that accepts but never replies, the client
    burns exactly its (timeout x retries) budget and raises the typed
    error — never an indefinite block."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    srv.settimeout(0.1)
    addr = srv.getsockname()
    stop = threading.Event()
    conns = []

    def accept_forever():
        while not stop.is_set():
            try:
                c, _ = srv.accept()
                conns.append(c)
            except socket.timeout:
                continue

    th = threading.Thread(target=accept_forever, daemon=True)
    th.start()
    cli = QueryableStateClient(addr, timeout_s=0.15, retries=1,
                               backoff_s=0.01)
    t0 = time.monotonic()
    with pytest.raises(QueryTimeoutError) as ei:
        cli.query(0, 1)
    elapsed = time.monotonic() - t0
    assert ei.value.attempts == 2          # initial + 1 retry
    assert ei.value.address == tuple(addr)
    assert elapsed < 2.0                   # bounded, not wedged
    assert isinstance(ei.value, TimeoutError)  # typed for except-clauses
    cli.close()
    stop.set()
    th.join(timeout=2.0)
    for c in conns:
        c.close()
    srv.close()
