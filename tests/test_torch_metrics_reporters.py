"""PyTorch port, the metrics plane's reporters, watchdog and HTTP
endpoint: mirrors of the reference's ``tests/test_metrics_cli.py``
(JSON-lines reporter, cluster metrics with the occupancy watchdog, the
endpoint) and the metrics cases of ``tests/test_obs.py`` (bounded
deques, one reporter handle, the endpoint's cluster view and ``/trace``),
plus byte parity of ``/metrics`` and ``/metrics.json`` with the
reference's endpoint over identically filled registries. Endpoints bind
``127.0.0.1`` on a free port and are closed in ``finally``; time comes
from injected clocks. Tolerance: exact."""

import collections
import json
import os
import urllib.error
import urllib.request

import pytest

from clonos_tpu import obs as jobs
from clonos_tpu.utils import metrics as jmet
from clonos_tpu_torch import obs
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.utils import metrics as met


def _get(ep, route):
    return urllib.request.urlopen(
        "http://%s:%d%s" % (ep.address[0], ep.address[1], route)).read()


def test_meter_and_histogram_use_bounded_deques():
    t = [0.0]
    m = met.Meter(window_s=10.0, clock=lambda: t[0])
    assert isinstance(m._events, collections.deque)
    for _ in range(5):
        m.mark(2)
        t[0] += 1.0
    assert m.rate == 1.0
    t[0] = 100.0
    m.mark(1)
    assert len(m._events) == 1
    assert m.rate == 0.1

    h = met.Histogram(max_samples=4)
    assert isinstance(h._buf, collections.deque)
    for v in (1, 2, 3, 4, 5, 6):
        h.update(v)
    assert h.count == 4
    assert h.mean == 4.5
    assert h.quantile(0.5) == 4.5
    assert h.quantile(0.99) == pytest.approx(5.97, abs=1e-12)


def test_jsonlines_reporter(tmp_path):
    reg = met.MetricRegistry()
    reg.group("a").counter("x").inc()
    path = str(tmp_path / "metrics.jsonl")
    reg.add_reporter(met.JsonLinesReporter(path, clock=lambda: 123.0))
    reg.report()
    reg.report()
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == 2 and lines[0]["a.x"] == 1
    assert lines[0]["ts"] == 123.0


def test_jsonlines_reporter_single_handle_flush_and_close(tmp_path):
    path = str(tmp_path / "m.jsonl")
    r = met.JsonLinesReporter(path, clock=lambda: 1.0)
    r.report({"a": 1})
    handle = r._file
    r.report({"a": 2})
    assert r._file is handle, "one append-mode handle for the lifetime"
    with open(path) as f:
        assert [json.loads(ln)["a"] for ln in f] == [1, 2]
    r.close()
    assert r._file is None
    r.report({"a": 3})                        # reopens, appends
    r.close()
    with open(path) as f:
        assert [json.loads(ln)["a"] for ln in f] == [1, 2, 3]

    # ReporterThread.stop() closes closeable reporters; the interval is
    # never reached, the report comes from the registry directly.
    reg = met.MetricRegistry()
    reg.group("g").counter("c").inc()
    r2 = met.JsonLinesReporter(str(tmp_path / "n.jsonl"),
                               clock=lambda: 2.0)
    reg.add_reporter(r2)
    th = met.ReporterThread(reg, interval_s=3600.0)
    th.start()
    reg.report()
    assert os.path.getsize(r2._path) > 0
    th.stop()
    assert not th._thread.is_alive()
    assert r2._file is None

    logged = []
    met.LoggingReporter(logged.append).report({"k": 1})
    assert [json.loads(x) for x in logged] == [{"k": 1}]


def _job(par=1):
    env = StreamEnvironment(num_key_groups=8)
    (env.synthetic_source(vocab=5, batch_size=4, parallelism=par)
        .key_by().window_count(num_keys=5, window_size=1 << 30).sink())
    return env


def test_cluster_metrics_and_watchdog():
    env = _job()
    r = ClusterRunner(env.build(), steps_per_epoch=2, log_capacity=1 << 6,
                      logical_time=True, device="cpu")
    r.run_epoch()
    snap = r.metrics.snapshot()
    name = env.graph.name
    assert snap[f"job.{name}.supersteps"] == 2
    assert snap[f"job.{name}.epochs"] == 1
    assert snap[f"job.{name}.checkpoint.latest-bytes"] > 0
    # The completed checkpoint truncated every log back to the fence;
    # only the source's post-fence SOURCE_CHECKPOINT row survives.
    assert snap[f"job.{name}.causal-log.total-rows"] == 1
    r.run_epoch(complete_checkpoint=False)
    assert 0 < r.metrics.snapshot()[f"job.{name}.causal-log.total-rows"]
    warnings = []
    r.watchdog._warn = warnings.append
    # 2 retained steps * 4 rows = 8 rows of 64 -> no warning yet.
    assert not r.watchdog.check()
    for _ in range(11):               # 8 + 44 = 52 rows >= 80% of 64
        r.executor.step()
    assert r.watchdog.check()
    assert warnings and "occupancy" in warnings[0]


def test_metrics_http_endpoint_serves_prometheus_and_json():
    reg = met.MetricRegistry()
    reg.group("job.test").counter("things").inc(5)
    ep = met.MetricsEndpoint(reg)
    try:
        assert ep.address[0] == "127.0.0.1"
        assert "job_test_things 5" in _get(ep, "/metrics").decode()
        assert json.loads(_get(ep, "/metrics.json"))["job.test.things"] == 5
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(ep, "/nope")
        assert err.value.code == 404
    finally:
        ep.close()


def test_metrics_endpoint_serves_cluster_view_and_trace():
    reg = met.MetricRegistry()
    reg.group("scheduler").counter("deploys").inc(3)
    tr = obs.Tracer("jm", clock=lambda: 5.0)
    tr.event("recovery.detect", worker="b")
    extra = lambda: {"worker.a.group.1.supersteps": 12}
    ep = met.MetricsEndpoint(reg, port=0, extra=extra, tracer=tr)
    try:
        txt = _get(ep, "/metrics").decode()
        assert "scheduler_deploys 3" in txt
        assert "worker_a_group_1_supersteps 12" in txt
        js = json.loads(_get(ep, "/metrics.json"))
        assert js["scheduler.deploys"] == 3
        assert js["worker.a.group.1.supersteps"] == 12
        assert js["trace.dropped-records"] == 0
        doc = json.loads(_get(ep, "/trace"))
        assert obs.validate_chrome(doc) > 0
        assert "recovery.detect" in [e["name"] for e in doc["traceEvents"]]
    finally:
        ep.close()

    ep2 = met.MetricsEndpoint(met.MetricRegistry(), port=0)
    try:
        with pytest.raises(urllib.error.HTTPError):
            _get(ep2, "/trace")
    finally:
        ep2.close()


def _fill(mod, reg):
    """The same metrics into a registry of either package: every value
    shape the exposition renders (counter, gauges of each type, a failing
    gauge, a histogram, a meter on an injected clock)."""
    g = reg.group("job.parity")
    g.counter("events").inc(7)
    g.gauge("ratio", lambda: 0.125)
    g.gauge("flag", lambda: True)
    g.gauge("label", lambda: 'a "quoted"\nvalue')
    g.gauge("broken", lambda: 1 // 0)
    g.gauge("nested", lambda: {"x": 1, "y": "z", "ok": False})
    h = g.histogram("latency-ms")
    for v in (1.0, 2.5, 4.0, 8.0, 0.5):
        h.update(v)
    m = mod.Meter(window_s=10.0, clock=lambda: 4.0)
    reg._register("job.parity.rate", m)
    m.mark(20)
    reg.group("9lives").counter("c").inc()


def test_exposition_bodies_match_reference():
    """``/metrics`` and ``/metrics.json`` over registries filled
    identically: the port's bodies equal the reference endpoint's byte
    for byte, merged extras included."""
    bodies = {}
    for tag, mod in (("port", met), ("reference", jmet)):
        reg = mod.MetricRegistry()
        _fill(mod, reg)
        ep = mod.MetricsEndpoint(reg, port=0,
                                 extra=lambda: {"worker.w.x": {
                                     "count": 2, "mean": 1.0}})
        try:
            bodies[tag] = (_get(ep, "/metrics"), _get(ep, "/metrics.json"))
        finally:
            ep.close()
    assert bodies["port"] == bodies["reference"]
    assert b"# TYPE job_parity_latency_ms summary" in bodies["port"][0]
    assert b"_9lives_c 1" in bodies["port"][0]


def test_history_and_trace_routes_match_reference():
    """``/metrics/history.json`` and ``/trace`` over the same samples and
    records: equal bodies in both packages."""
    bodies = {}
    for tag, mod, omod in (("port", met, obs), ("reference", jmet, jobs)):
        reg = mod.MetricRegistry()
        reg.group("h").counter("n").inc(2)
        t = [1.0]
        hist = omod.MetricsHistory(interval_s=3600.0, window=8,
                                   clock=lambda: t[0])
        tr = omod.Tracer("svc", clock=lambda: 3.0, trace_id="ab" * 8)
        ep = mod.MetricsEndpoint(reg, port=0, history=hist, tracer=tr)
        try:
            for _ in range(3):
                hist.sample_once()
                t[0] += 1.0
            doc = json.loads(_get(ep, "/trace"))
            bodies[tag] = (_get(ep, "/metrics/history.json?last=2"),
                           [e["name"] for e in doc["traceEvents"]])
        finally:
            ep.close()
    assert bodies["port"] == bodies["reference"]
    assert [s["ts"] for s in json.loads(bodies["port"][0])["samples"]] \
        == [2.0, 3.0]


def test_logging_reporter_and_watchdog_match_reference():
    """The watchdog's gauges and warning text, and a registry report,
    equal the reference's on the same job and steps."""
    from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
    from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
    out = {}
    for tag, env_cls, make in (
            ("port", StreamEnvironment,
             lambda j: ClusterRunner(j, steps_per_epoch=2,
                                     log_capacity=1 << 6,
                                     logical_time=True, device="cpu")),
            ("reference", JaxEnv,
             lambda j: JaxRunner(j, steps_per_epoch=2, log_capacity=1 << 6,
                                 logical_time=True,
                                 heartbeat_timeout_s=600.0))):
        env = env_cls(name="wd", num_key_groups=8)
        (env.synthetic_source(vocab=5, batch_size=4, parallelism=2)
            .key_by().window_count(num_keys=5, window_size=1 << 30)
            .sink())
        r = make(env.build())
        r.run_epoch(complete_checkpoint=False)
        for _ in range(11):
            r.executor.step()
        warned = []
        r.watchdog._warn = warned.append
        out[tag] = (r.watchdog.max_occupancy(), r.watchdog.total_rows(),
                    r.watchdog.check(), warned)
    assert out["port"] == out["reference"]
    assert out["port"][2] is True
