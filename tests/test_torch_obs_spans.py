"""PyTorch port, the program's spans at its layer boundaries: a block's
``block.*`` spans with the feed's ``feed.pull`` / ``feed.pack`` /
``feed.upload`` inside ``block.inputs``; a recovery's ``recovery`` span
with one ``recovery.<phase>`` child per phase, opened when the phase
starts, whose durations are ``phase_ms`` (and ``recovery.patch.log`` /
``.lane`` under ``recovery.patch``); ``device.wait``; the ``cuda_allocs``
counter; and the mirroring of spans into ``torch.profiler`` ranges. On
the CPU at small sizes; the card's counters are faked."""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clonos_tpu_torch import device as _device
from clonos_tpu_torch import obs
from clonos_tpu_torch.api import feeds as tf
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.obs import trace as _trace
from clonos_tpu_torch.runtime import cluster
from clonos_tpu_torch.runtime.cluster import ClusterRunner

KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)
EPS = 1e-6          # seconds: spans of one tracer share its clock


@pytest.fixture(autouse=True)
def _null_tracer_after():
    yield
    obs.reset()


def _fed_runner(block_steps=4):
    """Config #4's shape at test scale: feed -> window -> reduce -> sink."""
    env = StreamEnvironment(name="spans", num_key_groups=16,
                            default_edge_capacity=32)
    (env.host_source(batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=9, window_size=40, parallelism=2)
        .key_by().reduce(num_keys=9, parallelism=2)
        .sink(parallelism=2))
    r = ClusterRunner(env.build(), device="cpu", **KW)
    r.executor.block_steps = block_steps
    rng = np.random.RandomState(7)
    parts = [[(int(k), int(v)) for k, v in zip(rng.randint(0, 9, 400),
                                              rng.randint(0, 100, 400))]
             for _ in range(2)]
    r.executor.register_feed(0, tf.ListFeedReader(parts, records_per_pull=3))
    return r


def _window_runner(**kw):
    env = StreamEnvironment(name="spans-w", num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return ClusterRunner(env.build(), device="cpu", **dict(KW, **kw))


def _end(rec):
    return rec["ts"] + rec["dur"]


def _inside(child, parent):
    return (parent["ts"] - EPS <= child["ts"]
            and _end(child) <= _end(parent) + EPS)


# --- a block -----------------------------------------------------------------


def test_fed_block_spans_nest_the_feed_spans():
    """Each block: ``block.inputs`` holds ``feed.pull``, ``feed.pack`` and
    ``feed.upload`` in that order; ``block.run`` carries its steps,
    ``feed.upload`` its bytes, ``feed.pack`` whether it packed into
    pinned memory; ``block.listeners`` follows the run. Off a card no
    ``cuda_allocs`` is read and nothing is pinned."""
    tr = obs.configure("runner")
    r = _fed_runner(block_steps=4)
    r.run_epoch()
    recs = tr.records()
    by_id = {x["span"]: x for x in recs}
    named = lambda n: [x for x in recs if x["name"] == n]
    inputs = named("block.inputs")
    assert len(inputs) == 2                          # 8 steps, 4 a block
    feed = {n: named(n) for n in ("feed.pull", "feed.pack", "feed.upload")}
    for i, block in enumerate(inputs):
        pull, pack, up = (feed[n][i] for n in feed)
        for x in (pull, pack, up):
            assert by_id[x["parent"]] is block
            assert _inside(x, block)
            assert x["args"]["vertex"] == 0
        assert _end(pull) <= pack["ts"] + EPS
        assert _end(pack) <= up["ts"] + EPS
        # [keys, values] x 4 steps x 2 lanes x batch 4, then the
        # [4 steps, 2 lanes] counts, int32
        assert up["args"]["bytes"] == (2 * 4 * 2 * 4 + 4 * 2) * 4
        assert pack["args"]["pinned"] == 0              # the CPU's own
        assert "cuda_allocs" not in up["args"]
        assert "cuda_allocs" not in pack["args"]
    runs = named("block.run")
    assert [x["args"]["steps"] for x in runs] == [4, 4]
    listeners = named("block.listeners")
    assert len(listeners) == 2
    for block, run, lis in zip(inputs, runs, listeners):
        assert _end(block) <= run["ts"] + EPS
        assert _end(run) <= lis["ts"] + EPS


def test_feed_upload_counts_cuda_allocs_only_when_tracing(monkeypatch):
    """``feed.upload`` carries the change of :func:`device.cuda_allocs`
    over the upload; with the tracer off the counters are never read."""
    reads = itertools.count(0, 3)
    calls = []

    def fake(dev):
        calls.append(dev)
        return next(reads)
    monkeypatch.setattr(_device, "cuda_allocs", fake)
    _fed_runner().run_epoch()
    assert calls == []                      # NullTracer: nothing read
    tr = obs.configure("runner")
    _fed_runner().run_epoch()
    ups = [x for x in tr.records() if x["name"] == "feed.upload"]
    assert len(ups) == 2 and len(calls) == 4
    assert [x["args"]["cuda_allocs"] for x in ups] == [3, 3]


# --- a recovery --------------------------------------------------------------


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlapped-finalize", "sequential-finalize"])
def test_recovery_phases_are_children_opened_in_sequence(overlap):
    """One ``recovery`` span; every ``recovery.<phase>`` record is its
    child and inside it, the worker's barrier read included; the phases
    of the main sequence follow one another without overlap; the patch's
    ``recovery.patch.log`` and ``.lane`` lie under ``recovery.patch``;
    ``phase_ms`` is the sum of each phase's span durations."""
    tr = obs.configure("runner")
    r = _window_runner(audit=True)
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([2 + 1])
    report = r.recover(overlap_finalize=overlap)
    recs = tr.records()
    by_id = {x["span"]: x for x in recs}
    (recovery,) = [x for x in recs if x["name"] == "recovery"]
    assert recovery["args"]["failed"] == [3]
    assert "cuda_allocs" not in recovery["args"]
    pm = report.phase_ms
    assert {"restore", "fetch_determinants", "inputs", "replay", "patch",
            "replica_rebuild", "finalize", "finalize.barrier-read",
            "finalize.state-verify", "audit"} <= set(pm)
    for name, ms in pm.items():
        if name == "finalize.overlap-saved":
            continue
        spans = [x for x in recs if x["name"] == f"recovery.{name}"]
        assert spans, name
        for x in spans:
            assert x["parent"] == recovery["span"], name
            assert _inside(x, recovery), name
        assert sum(x["dur"] for x in spans) * 1e3 == pytest.approx(
            ms, abs=1e-6), name
    seq = sorted((x for x in recs if x["name"] in {
        f"recovery.{p}" for p in ("restore", "fetch_determinants", "inputs",
                                  "replay", "patch", "replica_rebuild")}),
        key=lambda x: x["ts"])
    assert [x["name"] for x in seq] == [
        "recovery.restore", "recovery.fetch_determinants",
        "recovery.fetch_determinants", "recovery.inputs", "recovery.replay",
        "recovery.patch", "recovery.replica_rebuild"]
    for a, b in zip(seq, seq[1:]):
        assert _end(a) <= b["ts"] + EPS
    for child in ("recovery.patch.log", "recovery.patch.lane"):
        (x,) = [y for y in recs if y["name"] == child]
        assert by_id[x["parent"]]["name"] == "recovery.patch"
        assert _inside(x, by_id[x["parent"]])
    assert tr.current_span() is None


def test_a_recovery_that_raises_closes_its_spans(monkeypatch):
    """A recovery failing in its patch closes ``recovery.patch`` and
    ``recovery`` with the error, and leaves the thread's span stack
    empty."""
    tr = obs.configure("runner")
    r = _window_runner()
    r.run_epoch(complete_checkpoint=True)
    r.inject_failure([3])

    def broken(*a, **k):
        raise RuntimeError("patch failed")
    monkeypatch.setattr(ClusterRunner, "_patch", broken)
    with pytest.raises(RuntimeError, match="patch failed"):
        r.recover()
    recs = {x["name"]: x for x in tr.records()}
    for name in ("recovery", "recovery.patch"):
        assert "patch failed" in recs[name]["args"]["error"]
    assert recs["recovery.patch"]["parent"] == recs["recovery"]["span"]
    assert tr.current_span() is None


def test_recovery_span_counts_cuda_allocs(monkeypatch):
    """On a card the ``recovery`` span carries the allocators' trips to
    CUDA over it; with the tracer off nothing is read."""
    reads = iter([10, 17])
    calls = []

    def fake(dev):
        calls.append(str(dev))
        return next(reads)
    monkeypatch.setattr(_device, "cuda_allocs", fake)
    dev = torch.device("cuda")
    with cluster._RecoverySpans(False, dev) as ph:
        ph.begin()
        ph.close()
    assert calls == []
    tr = obs.configure("runner")
    with cluster._RecoverySpans(False, dev) as ph:
        ph.begin()
        ph.enter("replay")
        ph.close(steps_replayed=8)
    (rec,) = [x for x in tr.records() if x["name"] == "recovery"]
    assert rec["args"] == {"drill": False, "steps_replayed": 8,
                           "cuda_allocs": 7}
    assert calls == ["cuda", "cuda"]
    assert set(ph.phases) == {"restore", "replay"}


# --- device reads and the allocator counter ----------------------------------


def test_host_copy_wait_records_device_wait_only_with_an_event():
    """``HostCopy.wait`` is a ``device.wait`` span where it waits on an
    event; host sources (no event) and a CPU ``to_numpy`` record
    nothing."""
    tr = obs.configure("t")
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, 9, (4, 3)).astype(np.int32))
    got = _device.HostCopy({"a": x, "b": rng.randint(0, 9, 5)}).wait()
    np.testing.assert_array_equal(got["a"], x.numpy())
    np.testing.assert_array_equal(_device.to_numpy(x), x.numpy())
    assert tr.records() == []

    class Event:
        waits = 0

        def synchronize(self):
            Event.waits += 1
    hc = _device.HostCopy(x)
    hc._event = Event()
    np.testing.assert_array_equal(hc.wait(), x.numpy())
    assert Event.waits == 1
    assert [r["name"] for r in tr.records()] == ["device.wait"]


def test_cuda_allocs_sums_the_allocators_trips(monkeypatch):
    """Segments allocated and freed, allocation retries and new pinned
    host blocks; None off a card."""
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {
        "segment.all.allocated": 5, "segment.all.freed": 2,
        "num_alloc_retries": 1, "allocated_bytes.all.current": 999})
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {
        "num_host_alloc": 4, "num_host_free": 7})
    assert _device.cuda_allocs("cuda") == 12
    assert _device.cuda_allocs("cpu") is None


# --- the profiler ------------------------------------------------------------


def _annotations(prof):
    return [e.name for e in prof.events()
            if getattr(e, "is_user_annotation", False)]


def test_spans_are_profiler_ranges_while_it_records(monkeypatch):
    """Under ``torch.profiler`` an enabled tracer's spans are user
    annotations of the same names; outside it no range is opened; the
    NullTracer opens none and records nothing."""
    opened = []
    real = _trace.record_function

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(_trace, "record_function", counting)
    tr = obs.configure("t")
    with tr.span("outside.profiler"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer.a"):
            with tr.span("inner.b"):
                torch.ones(4).add_(1)
    assert opened == ["outer.a", "inner.b"]
    assert {"outer.a", "inner.b"} <= set(_annotations(prof))
    assert [x["name"] for x in tr.records()] == [
        "outside.profiler", "inner.b", "outer.a"]

    obs.reset()
    opened.clear()
    r = _fed_runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.run_epoch()
    assert opened == []
    assert not {n for n in _annotations(prof)
                if n.startswith(("block.", "feed.", "recovery", "device."))}
    assert obs.get_tracer().records() == []


def test_block_spans_are_profiler_ranges_in_a_run():
    """A traced fed epoch under the profiler: every ``block.*`` and
    ``feed.*`` span is an annotation, as often as it was recorded."""
    tr = obs.configure("runner")
    r = _fed_runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.run_epoch()
    ann = _annotations(prof)
    for name in ("block.inputs", "block.run", "block.listeners",
                 "feed.pull", "feed.pack", "feed.upload"):
        n = sum(x["name"] == name for x in tr.records())
        assert n == 2 and ann.count(name) == n, name
