"""PyTorch port, the overhead attribution profiler, the metrics history
and ledger compaction: mirrors of the reference's ``tests/test_profile.py``
(all but its deploy-header and CLI cases) on the same small job, plus
parity of the per-section observation counts with the reference runner's
after the same profiled epochs. Counts and fractions built on injected
clocks are exact; wall-clock attributions are held to key sets and
inequalities only."""

import json
import tempfile
import threading
import urllib.request

import pytest

from clonos_tpu import obs as jobs
from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch import obs
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.obs import profile as prof_mod
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils import devsync
from clonos_tpu_torch.utils import metrics as met

KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)


@pytest.fixture(autouse=True)
def _null_obs_after():
    """Every test leaves both packages' process-global tracer, auditor
    and profiler off."""
    yield
    for mod in (obs, jobs):
        mod.reset()
        mod.reset_audit()
        mod.reset_profile()


def _small_job(name, env_cls=StreamEnvironment):
    env = env_cls(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


def _runner(name, **kw):
    return ClusterRunner(_small_job(name), device="cpu", **dict(KW, **kw))


# --- profiler unit behavior --------------------------------------------------


def test_null_profiler_default_zero_overhead(monkeypatch):
    """The default process profiler is the Null one: sections are one
    shared no-op context manager, ``fence`` passes values through
    untouched (no device sync) and every aggregate reads zero."""
    fences = []
    monkeypatch.setattr(devsync, "device_sync", fences.append)
    p = obs.get_profiler()
    assert isinstance(p, obs.NullProfiler) and not p.enabled
    assert p.section("roll") is p.section("truncate")
    with p.section("anything"):
        pass
    sentinel = object()
    assert p.fence(sentinel) is sentinel
    p.observe("roll", 1.0)
    assert p.rollup() == 0.0 and p.ft_fraction() == 0.0
    assert p.lifetime() == {} and p.lifetime_ft_fraction() == 0.0
    assert fences == []


def test_profiler_attribution_rollup_and_binding():
    """FT fraction = ft seconds / total attributed seconds per rollup
    window; histograms and the gauge land in the bound metric group."""
    t = [0.0]
    p = prof_mod.Profiler(clock=lambda: t[0], fence_device=False)
    reg = met.MetricRegistry()
    g = reg.group("job.t")
    p.bind(g)

    with p.section("compute", kind=prof_mod.COMPUTE):
        t[0] += 3.0
    with p.section("roll"):
        t[0] += 0.5
    with p.section("digest-seal"):
        t[0] += 0.5
    assert p.rollup() == 0.25
    assert p.ft_fraction() == 0.25

    # Only FT work -> 1.0; an empty window keeps the last fraction.
    with p.section("truncate"):
        t[0] += 1.0
    assert p.rollup() == 1.0
    assert p.rollup() == 1.0, "empty window keeps last"

    snap = reg.snapshot()
    assert snap["job.t.overhead.ft-fraction"] == 1.0
    assert snap["job.t.overhead.roll-ms"]["count"] == 1
    assert snap["job.t.overhead.roll-ms"]["mean"] == 500.0
    assert snap["job.t.overhead.compute-ms"]["count"] == 1
    # Lifetime spans both windows: 2 s FT of 5 s total.
    assert p.lifetime_ft_fraction() == 0.4
    assert p.lifetime()["compute"] == 3.0
    assert p.snapshot()["sections"]["roll"] == {"seconds": 0.5,
                                                "kind": "ft"}


def test_profiler_fence_waits_only_when_enabled(monkeypatch):
    """``fence`` hands its value to ``device_sync`` on an enabled profiler
    with ``fence_device=True``, and nowhere else; ``device_sync`` of a CPU
    tree is a no-op."""
    fences = []
    monkeypatch.setattr(devsync, "device_sync", fences.append)
    tree = {"a": [1, 2]}
    assert prof_mod.Profiler(fence_device=False).fence(tree) is tree
    assert prof_mod.NullProfiler().fence(tree) is tree
    assert fences == []
    assert prof_mod.Profiler().fence(tree) is tree
    assert prof_mod.Profiler().fence(None) is None
    assert fences == [tree]
    monkeypatch.undo()
    import torch
    devsync.device_sync({"x": torch.zeros(3), "y": (torch.ones(2), None)})


def test_profiled_run_exposes_ft_fraction(tmp_path):
    """A profiled runner attributes real epochs: the per-epoch rollup
    lands in the registry as ``overhead.ft-fraction`` with the per-section
    histograms beside it."""
    obs.configure_profile()
    r = _runner("prof", checkpoint_dir=str(tmp_path / "ck"), audit=True)
    assert r.profiler.enabled
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    snap = r.metrics.snapshot()
    frac = snap["job.prof.overhead.ft-fraction"]
    assert 0.0 < frac < 1.0
    assert snap["job.prof.overhead.compute-ms"]["count"] == 2
    assert snap["job.prof.overhead.roll-ms"]["count"] == 2
    assert snap["job.prof.overhead.snapshot-ms"]["count"] >= 1
    assert snap["job.prof.overhead.digest-seal-ms"]["count"] >= 1
    life = r.profiler.lifetime()
    assert life["compute"] > 0 and life["roll"] > 0


def test_disabled_run_adds_no_overhead_keys(tmp_path):
    """Profiling off (the default): no overhead.* metric exists."""
    r = _runner("noprof", checkpoint_dir=str(tmp_path / "ck"))
    assert not r.profiler.enabled
    r.run_epoch(complete_checkpoint=True)
    snap = r.metrics.snapshot()
    assert not [k for k in snap if ".overhead." in k]


def test_profile_config_option_enables_via_from_config(tmp_path):
    """``observability.profile.enabled`` is the configuration gate."""
    from clonos_tpu_torch.config.options import Configuration
    cfg = Configuration()
    cfg.set_raw("observability.profile.enabled", True)
    r = ClusterRunner.from_config(_small_job("cfgprof"), cfg, device="cpu",
                                  **KW)
    assert r.profiler.enabled


def _profiled_counts(mod, make, overlap):
    mod.configure_profile()
    try:
        r = make(tempfile.mkdtemp())
        for complete in (True, False, True, True):
            r.run_epoch(complete_checkpoint=complete, overlap_fence=overlap)
        r.drain_fence()
        if r.executor.spill_logs is not None:
            r.executor.drain_spill()
        snap = r.metrics.snapshot()
        return {k.split(".overhead.")[1]: v["count"]
                for k, v in snap.items()
                if ".overhead." in k and isinstance(v, dict)}
    finally:
        mod.reset_profile()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("spill", [False, True], ids=["ring", "spill"])
def test_section_counts_match_reference(overlap, spill):
    """After the same four profiled epochs (audit on, checkpoints on
    disk; spill to a spool directory or not), the port's runner has
    observed exactly the reference runner's sections, each as often."""
    def kw(root):
        out = dict(KW, audit=True, checkpoint_dir=root + "/ck")
        if spill:
            out["spool_dir"] = root + "/spool"
        return out
    port = _profiled_counts(obs, lambda root: ClusterRunner(
        _small_job("pf"), device="cpu", **kw(root)), overlap)
    ref = _profiled_counts(jobs, lambda root: JaxRunner(
        _small_job("pf", JaxEnv), heartbeat_timeout_s=600.0, **kw(root)),
        overlap)
    assert port == ref
    assert {"compute-ms", "roll-ms", "truncate-ms", "snapshot-ms",
            "health-read-ms", "digest-seal-ms", "ledger-write-ms",
            "source-append-ms", "async-append-ms"} <= set(port)
    assert ("spill-ms" in port) == spill
    assert ("spill-write-ms" in port) == spill


# --- finalize attribution ----------------------------------------------------


def test_recover_finalize_subspans_partition_finalize(tmp_path):
    """``recover()`` splits its finalize phase into named sub-spans in
    ``phase_ms``, each also a span under the recovery's trace id; with
    the overlapped tail sum(sub-spans) - overlap-saved <= finalize holds
    by construction, and the sequential control never writes the
    overlap key. Every ``recovery.<phase>`` span sums to its
    ``phase_ms`` entry."""
    tr = obs.configure("runner")
    r = _runner("fin", checkpoint_dir=str(tmp_path / "ck"))
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([2 + 1])
    report = r.recover()
    pm = report.phase_ms
    subs = {k: v for k, v in pm.items() if k.startswith("finalize.")}
    saved = subs.pop("finalize.overlap-saved")
    assert set(subs) == {"finalize.barrier-read", "finalize.state-verify"}
    assert saved >= 0.0
    assert sum(subs.values()) - saved <= pm["finalize"] + 1e-6
    recs = tr.records()
    recovery = next(x for x in recs if x["name"] == "recovery")
    for name, ms in pm.items():
        if name == "finalize.overlap-saved":
            continue
        spans = [x for x in recs if x["name"] == f"recovery.{name}"]
        assert spans and all(x["trace"] == recovery["trace"]
                             for x in spans), name
        assert sum(x["dur"] for x in spans) * 1e3 == pytest.approx(
            ms, abs=1e-6), name

    r.inject_failure([2 + 1])
    ctrl = r.recover(overlap_finalize=False)
    cm = ctrl.phase_ms
    csubs = {k: v for k, v in cm.items() if k.startswith("finalize.")}
    assert set(csubs) == {"finalize.barrier-read", "finalize.state-verify"}
    assert sum(csubs.values()) <= cm["finalize"] + 1e-6


# --- ledger compaction -------------------------------------------------------


def test_compact_ledger_entries_last_wins_below_fence():
    from clonos_tpu.runtime.checkpoint import \
        compact_ledger_entries as ref_compact
    from clonos_tpu_torch.runtime.checkpoint import compact_ledger_entries

    e = lambda ep, tag: {"epoch": ep, "combined": tag}
    entries = [e(0, "a"), e(1, "b"), e(0, "a2"),
               e(2, "c"), {"weird": True}, e(1, "b2"), e(2, "c2")]
    out = compact_ledger_entries(entries, below_epoch=2)
    assert out == [e(0, "a2"), e(1, "b2"),
                   e(2, "c"), {"weird": True}, e(2, "c2")]
    assert out == ref_compact(entries, below_epoch=2)
    assert compact_ledger_entries(entries, below_epoch=0) == entries


def test_checkpoint_completion_compacts_ledger(tmp_path):
    """Completion-driven compaction: duplicates below the completed fence
    collapse to one line per epoch in ledger.jsonl, last wins."""
    r = _runner("cmp", checkpoint_dir=str(tmp_path / "ck"), audit=True)
    r.run_epoch(complete_checkpoint=True)
    dup = dict(r.coordinator.read_ledger()[0])
    dup["combined"] = "resealed-last"
    for _ in range(3):
        r.coordinator.storage.write_ledger(dup)
    assert len(r.coordinator.read_ledger()) == 4
    r.run_epoch(complete_checkpoint=True)
    entries = r.coordinator.read_ledger()
    by_epoch = [e["epoch"] for e in entries]
    assert by_epoch.count(0) == 1
    assert next(e for e in entries
                if e["epoch"] == 0)["combined"] == "resealed-last"
    with open(str(tmp_path / "ck" / "ledger.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(entries)


# --- metrics history ---------------------------------------------------------


def test_metrics_history_ring_torn_tail_and_resume(tmp_path):
    """Samples ring-buffer in memory and append to a JSONL a torn final
    line cannot corrupt; a restarted history resumes from the file tail;
    the file compacts once it outgrows 2*window."""
    path = str(tmp_path / "history.jsonl")
    t = [100.0]
    h = obs.MetricsHistory(sample_fn=lambda: {"x": t[0]}, path=path,
                           interval_s=60.0, window=4,
                           clock=lambda: t[0])
    for _ in range(6):
        h.sample_once()
        t[0] += 1.0
    assert [r["ts"] for r in h.query()] == [102.0, 103.0, 104.0, 105.0]
    assert [r["ts"] for r in h.query(since=104.0)] == [104.0, 105.0]
    assert [r["ts"] for r in h.query(last=2)] == [104.0, 105.0]
    h.close()

    with open(path, "a") as f:
        f.write('{"ts": 999, "metr')
    assert obs.read_history_file(path)[-1]["ts"] == 105.0
    h2 = obs.MetricsHistory(sample_fn=lambda: {}, path=path,
                            interval_s=60.0, window=4,
                            clock=lambda: t[0])
    assert [r["ts"] for r in h2.query()] == [102.0, 103.0, 104.0, 105.0]
    for _ in range(6):
        h2.sample_once()
        t[0] += 1.0
    h2.close()
    with open(path) as f:
        assert len(f.read().splitlines()) <= 2 * 4
    ts = [r["ts"] for r in obs.read_history_file(path)]
    assert ts == sorted(ts) and ts[-1] == 111.0


def test_history_endpoint_serves_samples_under_concurrent_scrapes():
    """/metrics/history.json grows while /metrics is scraped from another
    thread; the exposition keeps # HELP/# TYPE; history timestamps are
    monotone and ?last= windows the payload. Samples are taken with
    ``sample_once`` on an injected clock (the sampler thread's interval
    is never reached), and the endpoint stops the history it started."""
    reg = met.MetricRegistry()
    reg.group("job.t").counter("things").inc(5)
    t = [10.0]
    hist = obs.MetricsHistory(interval_s=3600.0, window=64,
                              clock=lambda: t[0])
    ep = met.MetricsEndpoint(reg, port=0, history=hist)
    base = "http://%s:%d" % ep.address
    errors = []

    def scrape_loop():
        try:
            for _ in range(20):
                txt = urllib.request.urlopen(base + "/metrics").read()
                assert b"# HELP" in txt and b"# TYPE" in txt
                assert b"job_t_things 5" in txt
        except Exception as e:           # surfaced on the main thread
            errors.append(e)

    scraper = threading.Thread(target=scrape_loop)
    scraper.start()
    try:
        assert hist.started
        for _ in range(3):
            hist.sample_once()
            t[0] += 2.0
        js = json.loads(urllib.request.urlopen(
            base + "/metrics/history.json").read())
        ts = [s["ts"] for s in js["samples"]]
        assert ts == [10.0, 12.0, 14.0]
        assert all(s["metrics"]["job.t.things"] == 5
                   for s in js["samples"])
        js = json.loads(urllib.request.urlopen(
            base + "/metrics/history.json?last=1&since=11").read())
        assert [s["ts"] for s in js["samples"]] == [14.0]
    finally:
        scraper.join(timeout=60)
        ep.close()
    assert not scraper.is_alive()
    assert not errors
    assert hist._thread is None, "close() stopped the owned history"
