"""PyTorch port, the soak harness's pure code (``soak/chaos.py``,
``soak/slo.py``) and the runner surfaces its driver leans on, held to the
reference on the same inputs: DSL parses, ``to_text()`` and refusals,
seeded schedules byte for byte, SLO windows, trackers and the
coordinated-omission correction on seeded samples.

Mirrors of ``tests/test_soak.py`` (the reference's counterpart of each
test named in its docstring), run through the port:
``test_dsl_parse_all_kinds_and_roundtrip``,
``test_dsl_sorts_events_by_fire_time``,
``test_dsl_rejects_malformed_events``,
``test_dsl_rescale_parses_and_roundtrips``,
``test_seeded_schedule_can_draw_rescales``,
``test_seeded_schedule_is_replayable``,
``test_seeded_schedule_covers_kinds_inside_the_paced_band``,
``test_seeded_schedule_rejects_unknown_kind_and_missing_targets``,
``test_quantile_empty_is_zero``, ``test_window_evaluate_breaches_each_bound``,
``test_window_throughput_breach``,
``test_slo_tracker_rolls_windows_on_the_soak_clock``, the three
``test_corrected_closed_loop_*``,
``test_heartbeat_monitor_gray_degrades_without_killing``,
``test_standby_pool_completion_is_monotonic``, the three
``test_history_*`` (on an injected clock: the sampler loop runs on the
test's thread and its waits advance the clock),
``test_top_table_renders_soak_row``,
``test_latency_markers_keep_raw_samples`` and
``test_discard_pending_through_abandons_skipped_fences``. The reference's
four driver runs are mirrored in ``tests/test_torch_soak_driver.py``. From
``tests/test_autoscale.py``: ``test_load_spike_parse_and_round_trip``,
``test_load_spike_rejects_bad_factor_or_missing_duration`` and
``test_seeded_schedule_covers_load_spike_and_round_trips``."""

import dataclasses

import numpy as np
import pytest

from clonos_tpu.soak import chaos as jax_chaos
from clonos_tpu.soak import slo as jax_slo
from clonos_tpu_torch.soak import (ChaosEvent, ChaosSchedule, SLOSpec,
                                   SLOTracker, Window, corrected_closed_loop,
                                   parse_schedule, quantile)
from clonos_tpu_torch.soak import chaos, slo

#: every DSL line of the reference's tests (tests/test_soak.py:33-140,
#: tests/test_autoscale.py:284-301) that parses
GOOD_LINES = [
    """
    # warm-in stays quiet
    at 5s kill 1,9,17
    at 12s gray 2 delay=50ms for 3s
    at 20s leader-loss hold=1s ; at 30s stall delay=200ms for 2s
    at 40s nondet
    """,
    "at 30s nondet\nat 5s kill 1",
    "at 1.5s rescale 4",
    "at 1.2s load-spike 4x for 2s",
    "at 500ms load-spike 2.5 for 1s",
    "at 45s replica-kill 1",
    "at 45s replica-kill",
    "at 35s backlog for 4s",
    "at 0.25s leader-loss",
    "at 1.2s kill 1,3\nat 2.2s gray 3 delay=30ms for 1.5s",
]
#: every malformed line of the same tests
BAD_LINES = [
    "kill 1",
    "at 5s explode 1",
    "at 5s kill",
    "at 5s kill a,b",
    "at 5s gray 2,3 delay=50ms for 3s",
    "at 5s gray 2",
    "at 5s stall delay=200ms",
    "at 5s stall delay=200ms for",
    "at 5m kill 1",
    "at 5s kill 1 bogus=1",
    "at 5s rescale",
    "at 5s rescale 0",
    "at 5s rescale 2 4",
    "at 1s load-spike 0x for 2s",
    "at 1s load-spike 4x",
]


def _events(sched):
    return [dataclasses.astuple(e) for e in sched]


def _refusal(fn, line):
    with pytest.raises(ValueError) as e:
        fn(line)
    return str(e.value)


# --- the DSL against the reference -------------------------------------------


@pytest.mark.parametrize("text", GOOD_LINES)
def test_dsl_parse_and_text_equal_reference(text):
    mine, ref = parse_schedule(text), jax_chaos.parse_schedule(text)
    assert _events(mine) == _events(ref)
    assert mine.to_text() == ref.to_text()
    assert parse_schedule(mine.to_text()) == mine


@pytest.mark.parametrize("line", BAD_LINES)
def test_dsl_refusals_equal_reference(line):
    assert _refusal(parse_schedule, line) == _refusal(
        jax_chaos.parse_schedule, line)


def test_fault_kinds_equal_reference():
    assert chaos.FAULT_KINDS == jax_chaos.FAULT_KINDS


@pytest.mark.parametrize("seed", [0, 5, 7, 11, 23])
@pytest.mark.parametrize("kw", [
    {},
    {"kinds": jax_chaos.FAULT_KINDS, "n_events": 14, "cascade": 2},
    {"kinds": ("kill", "gray", "leader-loss", "stall", "nondet"),
     "n_events": 8, "cascade": 3},
    {"kinds": ("rescale",), "n_events": 3},
    {"kinds": ("load-spike", "backlog", "replica-kill"), "n_events": 5},
], ids=["default", "every-kind", "operator", "rescale", "load"])
def test_seeded_schedule_text_equals_reference(seed, kw):
    targets = [1, 3, 5, 7]
    mine = ChaosSchedule.seeded(seed, 60.0, targets, **kw)
    ref = jax_chaos.ChaosSchedule.seeded(seed, 60.0, targets, **kw)
    assert mine.to_text() == ref.to_text()
    assert _events(mine) == _events(ref)


def test_event_from_dict_and_trace_schedule_equal_reference(tmp_path):
    recs = [{"step": 0}, {"chaos": {"kind": "kill", "at_s": 1.5,
                                    "targets": [1, 3]}},
            {"chaos": {"kind": "load-spike", "at_s": 2.0, "factor": 4.0,
                       "duration_s": 1.5}},
            {"chaos": None}]
    path = tmp_path / "trace.jsonl"
    import json
    path.write_text("".join(json.dumps(r) + "\n" for r in recs)
                    + '{"chaos": {"ki')
    mine = chaos.read_trace_schedule(str(path))
    ref = jax_chaos.read_trace_schedule(str(path))
    assert mine.to_text() == ref.to_text() and len(mine) == 2
    bad = {"kind": "explode"}
    assert _refusal(chaos.event_from_dict, bad) == _refusal(
        jax_chaos.event_from_dict, bad)


# --- SLO windows against the reference ---------------------------------------


def _samples(seed, n):
    rng = np.random.RandomState(seed)
    lat = rng.gamma(2.0, 20.0, n) + np.where(rng.rand(n) < 0.05, 900.0, 0.0)
    return lat.tolist(), rng.randint(1, 64, n).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_window_stats_and_evaluate_equal_reference(seed):
    lat, recs = _samples(seed, 200)
    spec_kw = dict(max_p99_ms=100.0, min_throughput=2000.0,
                   max_recovery_ms=500.0)
    mine, ref = Window(3, 15.0, 5.0), jax_slo.Window(3, 15.0, 5.0)
    for w in (mine, ref):
        for a, r in zip(lat, recs):
            w.observe(corrected_ms=a, actual_ms=a / 2, records=r)
        w.recoveries_ms.extend([120.0, 800.0 + seed])
        w.faults.append("kill")
    assert mine.evaluate(SLOSpec(**spec_kw)) == ref.evaluate(
        jax_slo.SLOSpec(**spec_kw))
    assert mine.stats() == ref.stats()
    assert SLOSpec(**spec_kw).to_dict() == jax_slo.SLOSpec(
        **spec_kw).to_dict()


@pytest.mark.parametrize("seed", range(3))
def test_slo_tracker_equals_reference(seed):
    rng = np.random.RandomState(seed)
    mine = SLOTracker(SLOSpec(max_p99_ms=80.0), window_s=2.0)
    ref = jax_slo.SLOTracker(jax_slo.SLOSpec(max_p99_ms=80.0), window_s=2.0)
    now = 0.0
    for _ in range(300):
        now += float(rng.exponential(0.05))
        what = rng.randint(10)
        for t in (mine, ref):
            if what == 0:
                t.observe_fault(now, "gray")
            elif what == 1:
                t.observe_recovery(now, float(now * 10))
            else:
                t.observe(now, corrected_ms=float(now * 7 % 150),
                          actual_ms=1.0, records=8)
    a, b = mine.finish(), ref.finish()
    assert [w.stats() for w in a] == [w.stats() for w in b]
    assert [w.index for w in mine.breached_windows()] == [
        w.index for w in ref.breached_windows()]
    assert mine.worst_window().index == ref.worst_window().index
    assert mine.all_corrected_ms() == ref.all_corrected_ms()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rate", [None, 20000.0])
def test_corrected_closed_loop_equals_reference(seed, rate):
    rng = np.random.RandomState(seed)
    steps = np.cumsum(rng.randint(50, 150, 12)).tolist()
    walls = np.cumsum(rng.exponential(0.1, 12)).tolist()
    fences = list(zip(steps, walls))
    samples = [(int(s), float(m)) for s, m in zip(
        rng.randint(0, steps[-1] + 50, 40), rng.gamma(2.0, 3.0, 40))]
    args = (samples, fences, 100, 16)
    assert corrected_closed_loop(*args, rate=rate) == \
        jax_slo.corrected_closed_loop(*args, rate=rate)


def test_quantile_equals_reference():
    lat, _ = _samples(9, 101)
    for q in (0.0, 0.5, 0.99, 0.999, 1.0):
        assert quantile(lat, q) == jax_slo.quantile(lat, q)
    assert quantile([], 0.5) == jax_slo.quantile([], 0.5) == 0.0


# --- mirrors of tests/test_soak.py -------------------------------------------


def test_dsl_parse_all_kinds_and_roundtrip():
    sched = parse_schedule(GOOD_LINES[0])
    assert sched.kinds() == ["kill", "gray", "leader-loss", "stall",
                             "nondet"]
    kill, gray, ll, stall, nondet = list(sched)
    assert kill.targets == (1, 9, 17)
    assert gray.targets == (2,) and gray.delay_s == 0.05 \
        and gray.duration_s == 3.0
    assert ll.hold_s == 1.0
    assert stall.delay_s == 0.2 and stall.duration_s == 2.0
    assert nondet.at_s == 40.0
    assert parse_schedule(sched.to_text()) == sched


def test_dsl_sorts_events_by_fire_time():
    sched = parse_schedule("at 30s nondet\nat 5s kill 1")
    assert [e.at_s for e in sched] == [5.0, 30.0]


@pytest.mark.parametrize("line", BAD_LINES[:13])
def test_dsl_rejects_malformed_events(line):
    with pytest.raises(ValueError):
        parse_schedule(line)


def test_dsl_rescale_parses_and_roundtrips():
    text = "at 1.5s rescale 4"
    sched = parse_schedule(text)
    (ev,) = list(sched)
    assert ev.kind == "rescale" and ev.targets == (4,)
    assert sched.to_text() == text
    assert parse_schedule(sched.to_text()) == sched


def test_seeded_schedule_can_draw_rescales():
    sched = ChaosSchedule.seeded(7, 60.0, [0, 1], kinds=("rescale",),
                                 n_events=3)
    assert len(sched) == 3
    assert all(e.kind == "rescale" and e.targets[0] in (2, 4)
               for e in sched)
    assert parse_schedule(sched.to_text()) == sched
    assert ChaosSchedule.seeded(7, 60.0, [0, 1], kinds=("rescale",),
                                n_events=3) == sched


def test_seeded_schedule_is_replayable():
    a = ChaosSchedule.seeded(5, 60.0, [1, 3, 5])
    b = ChaosSchedule.seeded(5, 60.0, [1, 3, 5])
    assert a == b and a.to_text() == b.to_text()
    assert a != ChaosSchedule.seeded(6, 60.0, [1, 3, 5])


def test_seeded_schedule_covers_kinds_inside_the_paced_band():
    kinds = ("kill", "gray", "leader-loss", "stall", "nondet")
    sched = ChaosSchedule.seeded(11, 100.0, [1, 3, 5, 7], kinds=kinds,
                                 n_events=8, cascade=3)
    assert len(sched) == 8
    assert set(sched.kinds()) == set(kinds)
    for ev in sched:
        assert 20.0 <= ev.at_s <= 85.0
        if ev.kind == "kill":
            assert len(ev.targets) == 3 and len(set(ev.targets)) == 3
        if ev.kind == "gray":
            assert len(ev.targets) == 1
            assert ev.delay_s > 0 and ev.duration_s > 0
    assert parse_schedule(sched.to_text()) == sched


def test_seeded_schedule_rejects_unknown_kind_and_missing_targets():
    with pytest.raises(ValueError):
        ChaosSchedule.seeded(1, 60.0, [1], kinds=("explode",))
    with pytest.raises(ValueError):
        ChaosSchedule.seeded(1, 60.0, [], kinds=("kill",))


def test_quantile_empty_is_zero():
    assert quantile([], 0.99) == 0.0


def test_window_evaluate_breaches_each_bound():
    spec = SLOSpec(max_p99_ms=100.0, min_throughput=50.0,
                   max_recovery_ms=500.0)
    w = Window(0, 0.0, 2.0)
    for _ in range(95):
        w.observe(corrected_ms=10.0, actual_ms=10.0, records=1)
    for _ in range(5):
        w.observe(corrected_ms=900.0, actual_ms=900.0, records=1)
    w.recoveries_ms.append(800.0)
    breaches = w.evaluate(spec)
    assert len(breaches) == 2
    assert any("p99" in b for b in breaches)
    assert any("recovery" in b for b in breaches)
    assert w.stats()["breaches"] == breaches


def test_window_throughput_breach():
    w = Window(0, 0.0, 2.0)
    w.observe(corrected_ms=1.0, actual_ms=1.0, records=60)
    assert w.evaluate(SLOSpec(min_throughput=100.0)) == [
        "throughput 30/s < 100/s"]


class _FakeTracer:
    def __init__(self):
        self.events = []

    def event(self, name, **kw):
        self.events.append((name, kw))


def test_slo_tracker_rolls_windows_on_the_soak_clock():
    tr = _FakeTracer()
    t = SLOTracker(SLOSpec(max_p99_ms=50.0), window_s=5.0, tracer=tr)
    t.observe(1.0, corrected_ms=10.0, actual_ms=10.0, records=8)
    t.observe(6.0, corrected_ms=500.0, actual_ms=20.0, records=8)
    t.observe_fault(6.5, "kill")
    t.observe_recovery(7.0, 321.0)
    windows = t.finish()
    assert [w.index for w in windows] == [0, 1]
    assert windows[0].breaches == []
    assert windows[1].breaches and "p99" in windows[1].breaches[0]
    assert windows[1].faults == ["kill"]
    assert windows[1].recoveries_ms == [321.0]
    assert any(n == "soak.slo.breach" and kw["window"] == 1
               for n, kw in tr.events)
    assert t.breached_windows() == [windows[1]]
    assert t.worst_window() is windows[1]


def test_corrected_closed_loop_charges_late_fences_only():
    fences = [(100, 0.1), (200, 0.2), (300, 0.8), (400, 0.9)]
    samples = [(50, 1.0), (250, 2.0), (350, 3.0)]
    out = corrected_closed_loop(samples, fences, steps_per_epoch=100,
                                records_per_step=10, rate=10_000.0)
    assert out["max_queue_ms"] == pytest.approx(500.0)
    assert out["per_step_us"] == pytest.approx(1000.0)
    assert out["p99_ms"] == pytest.approx(
        quantile([1.0, 502.0, 503.0], 0.99))
    assert out["p50_ms"] == pytest.approx(502.0)


def test_corrected_closed_loop_derives_rate_from_fence_span():
    fences = [(0, 0.0), (100, 0.1), (200, 0.2)]
    out = corrected_closed_loop([(10, 7.0), (110, 9.0)], fences,
                                steps_per_epoch=100, records_per_step=10)
    assert out["per_step_us"] == pytest.approx(1000.0)
    assert out["max_queue_ms"] == pytest.approx(0.0)
    assert out["p99_ms"] == pytest.approx(quantile([7.0, 9.0], 0.99))


def test_corrected_closed_loop_empty_inputs():
    assert corrected_closed_loop([], [(0, 0.0), (8, 1.0)], 8, 4) == {
        "p50_ms": 0.0, "p99_ms": 0.0, "max_queue_ms": 0.0}
    assert corrected_closed_loop([(1, 2.0)], [(0, 0.0)], 8, 4)[
        "p99_ms"] == 0.0


def test_heartbeat_monitor_gray_degrades_without_killing():
    from clonos_tpu_torch.runtime.cluster import HeartbeatMonitor

    t = [0.0]
    mon = HeartbeatMonitor([0, 1, 2], timeout_s=5.0, clock=lambda: t[0])
    mon.beat_all_except(set())
    assert mon.degraded(0.01) == []
    mon.lag[1] = 0.5
    t[0] = 1.0
    mon.beat_all_except(set())
    assert mon.degraded(0.01) == [1]
    assert mon.expired() == []
    t[0] = 4.0
    assert mon.degraded(0.01) == [1]
    assert mon.expired() == []
    t[0] = 7.0
    assert 1 not in mon.degraded(0.01)
    assert mon.expired() == [0, 1, 2]
    mon.revive(1)
    assert 1 not in mon.lag


def test_standby_pool_completion_is_monotonic():
    from clonos_tpu_torch.runtime.cluster import StandbyPool

    class _Ckpt:
        def __init__(self, cid):
            self.checkpoint_id = cid

    pool = StandbyPool()
    pool.on_completed_checkpoint(_Ckpt(5))
    pool.on_completed_checkpoint(_Ckpt(3))
    assert pool.latest.checkpoint_id == 5
    pool.on_completed_checkpoint(_Ckpt(7))
    assert pool.latest.checkpoint_id == 7


class _Clock:
    """An injected clock for the history sampler's loop: ``monotonic`` and
    ``time`` read it, a sample advances it by its own duration, and the
    loop's stop-event waits advance it by their timeout."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


class _Stop:
    """Stands in for the loop's stop event: ``wait`` advances the clock
    and reports the stop once the clock passes ``until``."""

    def __init__(self, clock, until):
        self.clock = clock
        self.until = until

    def wait(self, timeout):
        self.clock.t += timeout
        return self.clock.t >= self.until

    def set(self):
        self.until = self.clock.t


def _run_history(monkeypatch, sample_s, until, **kw):
    from clonos_tpu_torch.obs import history
    clock = _Clock()
    monkeypatch.setattr(history, "time", clock)

    def sample():
        clock.t += sample_s
        return {"x": 1}

    h = history.MetricsHistory(sample_fn=sample, clock=clock.time, **kw)
    h._stop = _Stop(clock, until)
    h._loop()
    return h


def test_history_interval_holds_under_slow_sampler(monkeypatch):
    h = _run_history(monkeypatch, 0.03, 0.53, interval_s=0.05, window=64)
    assert len(h.query()) >= 8
    assert h.missed_slots == 0


def test_history_counts_missed_slots_instead_of_bursting(monkeypatch):
    h = _run_history(monkeypatch, 0.12, 0.5, interval_s=0.05, window=64)
    assert h.missed_slots >= 2
    ts = [r["ts"] for r in h.query()]
    assert all(b - a >= 0.1 for a, b in zip(ts, ts[1:]))


def test_history_file_torn_tail_readable_mid_run(tmp_path):
    from clonos_tpu_torch.obs.history import MetricsHistory, read_history_file

    path = str(tmp_path / "hist.jsonl")
    h = MetricsHistory(sample_fn=lambda: {"ok": 1}, path=path,
                       interval_s=0.02, window=64, clock=lambda: 1.0)
    reads = 0
    for _ in range(20):
        h.sample_once()
        for r in read_history_file(path):      # between appends
            assert "ts" in r
        reads += 1
    h.close()
    assert reads > 0 and len(read_history_file(path)) > 0
    with open(path, "a") as f:
        f.write('{"ts": 1, "metr')
    assert all("metrics" in r for r in read_history_file(path))


def test_top_table_renders_soak_row():
    from clonos_tpu_torch.cli import _top_table

    snap = {"soak.target-rate": 2000.0, "soak.rate": 1874.2,
            "soak.faults-injected": 4, "soak.audit-ok": 1,
            "worker.w0.slots": 2}
    soak_lines = [ln for ln in _top_table(snap).splitlines()
                  if ln.startswith("soak:")]
    assert len(soak_lines) == 1
    assert "audit-ok=1" in soak_lines[0]
    assert "target-rate=2000.0" in soak_lines[0]
    assert any(ln.startswith("soak: rate=9.0") for ln in _top_table(
        {"worker.w1.soak.rate": 9.0}).splitlines())
    assert "soak:" not in _top_table({"worker.w0.slots": 1})


def _small_job(name):
    from clonos_tpu_torch.api.environment import StreamEnvironment
    env = StreamEnvironment(name=name, num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


def test_latency_markers_keep_raw_samples():
    from clonos_tpu_torch.runtime.cluster import ClusterRunner

    r = ClusterRunner(_small_job("lat"), steps_per_epoch=8,
                      log_capacity=512, max_epochs=8,
                      inflight_ring_steps=32, seed=3,
                      latency_marker_every=2, device="cpu")
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    samples = r.latency.samples
    assert samples and len(samples) == r.latency.hist.count
    steps = [s for s, _ in samples]
    assert steps == sorted(steps)
    assert all(isinstance(ms, float) for _, ms in samples)
    r.latency.max_samples = 4
    r.run_epoch(complete_checkpoint=False)
    assert len(r.latency.samples) <= 4
    assert r.latency.samples[-1][0] == max(steps + [
        s for s, _ in r.latency.samples])


def test_discard_pending_through_abandons_skipped_fences(tmp_path):
    from clonos_tpu_torch.runtime.cluster import ClusterRunner

    r = ClusterRunner(_small_job("dp"), steps_per_epoch=8,
                      log_capacity=512, max_epochs=8,
                      inflight_ring_steps=64, seed=3,
                      checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=False)
    r.run_epoch(complete_checkpoint=False)
    r.run_epoch(complete_checkpoint=True)
    co = r.coordinator
    latest_before = r.standbys.latest.checkpoint_id
    pending = sorted(co._pending)
    assert pending
    assert co.discard_pending_through(max(pending)) == pending
    assert not co._pending
    assert r.standbys.latest.checkpoint_id == latest_before
    assert co.discard_pending_through(10**6) == []


# --- mirrors of tests/test_autoscale.py's DSL cases --------------------------


def test_load_spike_parse_and_round_trip():
    s = parse_schedule("at 1.2s load-spike 4x for 2s")
    (ev,) = list(s)
    assert ev.kind == "load-spike" and ev.factor == 4.0
    assert ev.at_s == 1.2 and ev.duration_s == 2.0
    assert parse_schedule(s.to_text()).to_text() == s.to_text()
    (ev2,) = list(parse_schedule("at 500ms load-spike 2.5 for 1s"))
    assert ev2.factor == 2.5


def test_load_spike_rejects_bad_factor_or_missing_duration():
    with pytest.raises(ValueError):
        parse_schedule("at 1s load-spike 0x for 2s")
    with pytest.raises(ValueError):
        parse_schedule("at 1s load-spike 4x")


def test_seeded_schedule_covers_load_spike_and_round_trips():
    s = ChaosSchedule.seeded(seed=7, duration_s=30.0, targets=[1, 2],
                             kinds=("load-spike",), n_events=3)
    evs = list(s)
    assert len(evs) == 3
    assert all(ev.factor in (2.0, 4.0) for ev in evs)
    assert all(ev.duration_s > 0 for ev in evs)
    assert parse_schedule(s.to_text()).to_text() == s.to_text()
    assert isinstance(evs[0], ChaosEvent)


def test_slo_module_is_the_serve_quantile():
    """The read tier's p99 gauge reads ``soak.slo.quantile``; the serve
    module keeps no private copy."""
    from clonos_tpu_torch.runtime import serve
    assert not hasattr(serve, "_quantile")
    assert slo.quantile is quantile
