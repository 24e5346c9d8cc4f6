"""PyTorch port, the autoscaler (``clonos_tpu_torch/autoscale``): mirrors
of the reference's ``tests/test_autoscale.py`` cases — policy discipline
under adversarial traces, byte-identical SCALE determinant logs,
replay-not-re-decide recovery, the read tier's replica knob, the signal
plane and the ``top`` row, the scale-policy model's three minimal
counterexamples, the real controller's conformance and the ``load-spike``
bridge (through the port's ``verify/``) — each held to the reference on
the same inputs, plus seeded signal traces through both policies, the
decision logs' bytes across the packages, SCALE rows, and the
controller's timeline and incident signals."""

import dataclasses
import json

import numpy as np
import pytest

from clonos_tpu import autoscale as jas
from clonos_tpu.causal import determinant as jdet
from clonos_tpu_torch import autoscale as pas
from clonos_tpu_torch import obs
from clonos_tpu_torch.autoscale import (HOLD, SCALE_REPLICAS, SCALE_WORKERS,
                                        AutoscaleController, DecisionLog,
                                        PolicyConfig, PolicyState,
                                        ScalePolicy, ScaleSignals,
                                        SignalAggregator, decision_row,
                                        signals_for_level)
from clonos_tpu_torch.causal import determinant as det


def sig(epoch, load, workers=2, failed=0, unfenced=False, staleness=0,
        p99=0.0, replicas=1, gray=0, mod=None):
    cls = ScaleSignals if mod is None else mod.ScaleSignals
    return cls(epoch=epoch, load=load, workers=workers,
               failed_subtasks=failed, unfenced=unfenced,
               max_staleness=staleness, p99_read_ms=p99,
               replicas_alive=replicas, replicas_total=replicas,
               gray_suspects=gray)


def drive(policy, signals, st=None):
    st = st or PolicyState()
    out = []
    for s in signals:
        d, st = policy.decide(s, st)
        out.append(d)
    return out, st


def drive_both(cfg: dict, trace):
    """The same trace through both policies: equal decisions and final
    states (as dicts), returning the port's."""
    decs, st = drive(ScalePolicy(PolicyConfig(**cfg)),
                     [sig(*a, **k) for a, k in trace])
    jdecs, jst = drive(jas.ScalePolicy(jas.PolicyConfig(**cfg)),
                       [sig(*a, mod=jas, **k) for a, k in trace],
                       jas.PolicyState())
    assert [d.to_dict() for d in decs] == [d.to_dict() for d in jdecs]
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    return decs, st


def T(*loads, **k):
    return [((e, load), dict(k)) for e, load in enumerate(loads)]


# --- the pure policy ------------------------------------------------------

def test_hysteresis_dead_band_never_scales():
    decs, st = drive_both({}, T(*([1.2, 0.6, 1.24, 0.56] * 4)))
    assert all(d.action == HOLD for d in decs)
    assert st.over_streak == 0 and st.under_streak == 0


def test_sustained_high_load_scales_up_one_bounded_step():
    decs, _ = drive_both(dict(sustain_fences=2, cooldown_fences=3,
                              max_step=1, max_workers=4), T(2.0, 2.0))
    assert decs[0].action == HOLD
    d = decs[1]
    assert d.action == SCALE_WORKERS and d.delta == 1
    assert d.target_workers == 3 and d.reason == "sustained-high-load"


def test_step_bound_and_worker_ceiling():
    trace = [((e, 50.0), dict(workers=w)) for e, w in enumerate([2, 3, 3])]
    decs, _ = drive_both(dict(sustain_fences=1, cooldown_fences=2,
                              max_step=1, max_workers=3), trace)
    assert [d.action for d in decs] == [SCALE_WORKERS, HOLD, HOLD]
    assert decs[0].target_workers == 3
    assert decs[1].reason == "cooldown"
    assert decs[2].reason == "steady"


def test_cooldown_blocks_thrash_on_adversarial_flip():
    cfg = dict(sustain_fences=2, cooldown_fences=3)
    trace = T(2.0, 2.0) + [((e, 0.1), dict(workers=3)) for e in range(2, 8)]
    decs, _ = drive_both(cfg, trace)
    assert decs[1].action == SCALE_WORKERS
    assert [d.reason for d in decs[2:4]] == ["cooldown", "cooldown"]
    down = [d for d in decs if d.action == SCALE_WORKERS and d.delta < 0]
    assert down and down[0].seq - decs[1].seq >= cfg["cooldown_fences"]


def test_unhealthy_or_unfenced_always_holds():
    d1, _ = drive_both(dict(sustain_fences=1), T(9.0, failed=1))
    d2, _ = drive_both(dict(sustain_fences=1), T(9.0, unfenced=True))
    d3, _ = drive_both(dict(sustain_fences=1), T(9.0, gray=1))
    assert d1[0].action == HOLD and d1[0].reason == "unhealthy"
    assert d2[0].action == HOLD and d2[0].reason == "unhealthy"
    assert d3[0].action == HOLD and d3[0].reason == "gray-suspect"


def test_replica_arms_lag_adds_idle_drops():
    cfg = dict(sustain_fences=2, cooldown_fences=1, staleness_high=2,
               min_workers=2, max_replicas=2)
    decs, _ = drive_both(cfg, T(1.0, 1.0, staleness=5, replicas=1))
    d = decs[1]
    assert d.action == SCALE_REPLICAS and d.delta == 1
    assert d.target_replicas == 2 and d.reason == "read-tier-lagging"
    decs, _ = drive_both(cfg, T(0.1, 0.1, workers=2, replicas=2))
    d = decs[1]
    assert d.action == SCALE_REPLICAS and d.delta == -1
    assert d.reason == "read-tier-idle"


def test_worker_recut_outranks_replica_add():
    decs, _ = drive_both(dict(sustain_fences=1, max_replicas=4),
                         T(9.0, staleness=9, replicas=1))
    assert decs[0].action == SCALE_WORKERS


@pytest.mark.parametrize("seed", range(3))
def test_seeded_signal_traces_decide_as_the_reference(seed):
    """Seeded random traces (load around both thresholds, failures,
    unfenced fences, gray suspects, read-tier lag, moving counts)
    through both policies under seeded configs: equal decisions and
    states at every fence."""
    rng = np.random.RandomState(seed)
    lo = float(np.round(rng.uniform(0.3, 0.8), 2))
    cfg = dict(high_load=float(np.round(lo + rng.uniform(0.2, 1.0), 2)),
               low_load=lo, sustain_fences=int(rng.randint(1, 4)),
               cooldown_fences=int(rng.randint(0, 4)),
               max_step=int(rng.randint(1, 3)), min_workers=1,
               max_workers=int(rng.randint(2, 17)),
               staleness_high=int(rng.randint(1, 4)),
               read_p99_high_ms=float(rng.choice([5.0, 50.0])),
               min_replicas=1, max_replicas=int(rng.randint(1, 5)))
    trace = []
    for e in range(80):
        trace.append(((e, float(np.round(rng.uniform(0.0, 3.0), 2))), dict(
            workers=int(rng.randint(1, 17)),
            failed=int(rng.rand() < 0.1), unfenced=bool(rng.rand() < 0.05),
            staleness=int(rng.randint(0, 5)),
            p99=float(np.round(rng.uniform(0, 80), 3)),
            replicas=int(rng.randint(1, 5)), gray=int(rng.rand() < 0.05))))
    decs, _ = drive_both(cfg, trace)
    assert len({d.action for d in decs}) >= 2


# --- determinant log: byte identity + replay ------------------------------

TRACE = [1.0, 2.0, 2.0, 1.0, 0.2, 0.2, 0.2, 2.0, 2.0]


def _controller(path=None, mod=None, **cfg):
    cfg.setdefault("sustain_fences", 2)
    cfg.setdefault("cooldown_fences", 2)
    m = mod or pas
    executed = []
    c = m.AutoscaleController(
        m.ScalePolicy(m.PolicyConfig(**cfg)),
        log=m.DecisionLog(path),
        execute_workers=lambda t: executed.append(("workers", t)),
        add_replica=lambda: executed.append(("add", None)),
        drop_replica=lambda: executed.append(("drop", None)))
    return c, executed


def _run_trace(c, loads, workers=2, start=0, mod=None):
    for i, load in enumerate(loads):
        c.on_fence(start + i, sig(start + i, load, workers=workers, mod=mod))


def test_same_signal_trace_byte_identical_log(tmp_path):
    ca, _ = _controller(str(tmp_path / "a.det"))
    cb, _ = _controller(str(tmp_path / "b.det"))
    cj, _ = _controller(str(tmp_path / "j.det"), mod=jas)
    _run_trace(ca, TRACE)
    _run_trace(cb, TRACE)
    _run_trace(cj, TRACE, mod=jas)
    assert len(ca.log) == len(TRACE)
    assert ca.log.to_bytes() == cb.log.to_bytes() == cj.log.to_bytes()
    assert ca.log.digest() == cb.log.digest() == cj.log.digest()
    with open(ca.log.path, "rb") as f:
        assert f.read() == ca.log.to_bytes()
    with open(ca.log.sidecar_path, "rb") as f, \
            open(cj.log.sidecar_path, "rb") as g:
        assert f.read() == g.read()
    for row in ca.log.determinants():
        assert isinstance(row, det.ScaleDeterminant)
        assert row.record_count >= 1


def test_recovered_controller_replays_never_re_executes(tmp_path):
    path = str(tmp_path / "scale.det")
    c1, exec1 = _controller(path)
    _run_trace(c1, TRACE[:4])
    assert exec1, "the trace must have executed a scale action"
    n_logged = len(c1.log)

    c2, exec2 = _controller(path)
    assert len(c2.log) == n_logged
    assert c2.state == c1.state
    for i, load in enumerate(TRACE[:4]):
        d, executed = c2.on_fence(i, sig(i, load))
        assert executed is None
    assert exec2 == []
    assert c2.replayed_decisions == n_logged
    assert len(c2.log) == n_logged
    c2.on_fence(4, sig(4, TRACE[4]))
    assert len(c2.log) == n_logged + 1
    assert c2.log.records[-1]["decision"]["seq"] == n_logged + 1
    # a reference controller over the port's log replays it too
    cj, execj = _controller(path, mod=jas)
    assert dataclasses.asdict(cj.state) == dataclasses.asdict(c2.state)
    assert execj == [] and cj.log.digest() == c2.log.digest()


def test_tampered_sidecar_refuses_replay(tmp_path):
    path = str(tmp_path / "scale.det")
    c1, _ = _controller(path)
    _run_trace(c1, TRACE[:3])
    lines = open(path + ".signals.jsonl").read().splitlines()
    rec = json.loads(lines[1])
    rec["signals"]["load"] = 77.0
    lines[1] = json.dumps(rec, sort_keys=True)
    with open(path + ".signals.jsonl", "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="crc pin"):
        _controller(path)
    with pytest.raises(ValueError, match="crc pin"):
        _controller(path, mod=jas)


def test_torn_log_tail_truncates_to_agreed_prefix(tmp_path):
    path = str(tmp_path / "scale.det")
    c1, _ = _controller(path)
    _run_trace(c1, TRACE[:3])
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")
    log = DecisionLog(path)
    assert len(log) == 3
    with open(path + ".signals.jsonl", "a") as f:
        f.write('{"broken')
    c2, _ = _controller(path)
    assert len(c2.log) == 3
    assert c2.log.to_bytes() == jas.DecisionLog(path).to_bytes()


def test_scale_determinant_rows_equal_the_references():
    """SCALE rows pack and unpack as the reference's, 64-bit epochs,
    negative deltas and crcs above 2**31 included."""
    rng = np.random.RandomState(5)
    for _ in range(50):
        f = dict(record_count=int(rng.randint(1, 2 ** 31 - 1)),
                 epoch=int(rng.choice([0, 7, 2 ** 40 + 3, -5])),
                 action=int(rng.randint(0, 3)),
                 delta=int(rng.randint(-4, 5)),
                 target=int(rng.randint(0, 64)),
                 signal_crc=int(rng.randint(0, 2 ** 32, dtype=np.int64)))
        row = det.ScaleDeterminant(**f).pack()
        jrow = jdet.ScaleDeterminant(**f).pack()
        np.testing.assert_array_equal(row, jrow)
        assert det.Determinant.unpack(row) == det.ScaleDeterminant(**f)
        assert det.from_bytes(det.to_bytes(row[None])).tolist() == [
            row.tolist()]
    np.testing.assert_array_equal(decision_row(_decision(pas)).pack(),
                                  jas.decision_row(_decision(jas)).pack())


def _decision(mod):
    return mod.ScaleDecision(epoch=3, seq=4, action=SCALE_REPLICAS, delta=-1,
               target_workers=8, target_replicas=2, reason="read-tier-idle",
               signal_crc=0xFEEDBEEF)


def test_controller_signals_timeline_and_incident(tmp_path):
    """Every fresh decision lands a ``scale.decision`` timeline record;
    a replay that fails its crc pin fires ``conformance.mismatch`` into
    the incident plane before raising."""
    obs.reset_timeline()
    obs.reset_incidents()
    obs.reset_hlc()
    try:
        tl = obs.configure_timeline("ctl")
        c, _ = _controller(str(tmp_path / "scale.det"))
        _run_trace(c, TRACE[:3])
        recs = [r for r in tl.records() if r["kind"] == "scale.decision"]
        assert [r["seq"] for r in recs] == [1, 2, 3]
        assert [r["action"] for r in recs] == [HOLD, HOLD, SCALE_WORKERS]
        inc = obs.configure_incidents(str(tmp_path / "inc"))
        lines = open(c.log.sidecar_path).read().splitlines()
        rec = json.loads(lines[0])
        rec["signals"]["load"] = 9.0
        lines[0] = json.dumps(rec, sort_keys=True)
        with open(c.log.sidecar_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match="crc pin"):
            _controller(c.log.path)
        assert inc.signals == 1 and inc.captured == 1
    finally:
        obs.reset_timeline()
        obs.reset_incidents()
        obs.reset_hlc()


def test_failure_holds_until_recovered_and_execute_rechecks_health():
    """A failed subtask makes every decision HOLD; a failure landing
    between decide and execute refuses the pending action."""
    healthy = {"ok": True}
    executed = []
    c = AutoscaleController(
        ScalePolicy(PolicyConfig(sustain_fences=1, cooldown_fences=1,
                                 max_workers=16)),
        execute_workers=executed.append, healthy=lambda: healthy["ok"])
    for e in range(3):
        d, ex = c.on_fence(e, sig(e, 9.0, failed=1))
        assert d.action == HOLD and ex is None
    c.observe(sig(3, 9.0))
    c.note_fence(3)
    assert c.decide().action == SCALE_WORKERS
    healthy["ok"] = False
    assert c.execute() is None and c.refusals == 1 and executed == []


# --- runtime replica knob (the replica arm's executor) --------------------

VID = 1
NUM_KEYS = 11


def _serve_runner(port=True, seed=3):
    if port:
        from clonos_tpu_torch.api.environment import StreamEnvironment
        from clonos_tpu_torch.runtime.cluster import ClusterRunner
        kw = {"device": "cpu"}
    else:
        from clonos_tpu.api.environment import StreamEnvironment
        from clonos_tpu.runtime.cluster import ClusterRunner
        kw = {"heartbeat_timeout_s": 600.0}
    env = StreamEnvironment(name="serve", num_key_groups=16,
                            default_edge_capacity=64)
    (env.synthetic_source(vocab=NUM_KEYS, batch_size=8, parallelism=2)
        .key_by().reduce(num_keys=NUM_KEYS, name="r").sink())
    return ClusterRunner(env.build(), steps_per_epoch=4, log_capacity=256,
                         max_epochs=8, inflight_ring_steps=16, seed=seed,
                         logical_time=True, **kw)


def _tiers():
    from clonos_tpu.runtime.serve import build_serve_tier as jax_tier
    from clonos_tpu_torch.runtime.serve import build_serve_tier
    return ((_serve_runner(True), build_serve_tier),
            (_serve_runner(False), jax_tier))


def test_add_replica_serves_at_next_seal_and_drop_contracts():
    keys = list(range(NUM_KEYS))
    seen = []
    for r, mk in _tiers():
        tier = mk(r, VID, n_replicas=1)
        try:
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
            owner_vals = tier.owner_client.query_batch(VID, keys)["values"]
            i = tier.add_replica()
            assert i == 1 and len(tier.router.replicas) == 2
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
            assert tier.staleness()[1] == 0
            out = tier.router.query_batch(VID, keys)
            assert out["values"] == tier.owner_client.query_batch(
                VID, keys)["values"]
            groups = {tier.router.replica_for_group(g) for g in range(16)}
            assert groups == {0, 1}
            assert "serve.replica.1.staleness-epochs" in r.metrics.snapshot()
            assert tier.replicas[1].name == "replica-1"
            dropped = tier.drop_replica()
            assert dropped == 1 and len(tier.router.replicas) == 1
            assert "serve.replica.1.staleness-epochs" not in \
                r.metrics.snapshot()
            out2 = tier.router.query_batch(VID, keys)
            assert out2["values"] == tier.owner_client.query_batch(
                VID, keys)["values"]
            with pytest.raises(ValueError):
                tier.drop_replica()
            assert tier.router.errors == 0
            tier.add_replica()
            assert tier.replicas[1].name == "replica-2", "names not reused"
            seen.append((owner_vals, out, out2))
        finally:
            tier.close()
    assert seen[0] == seen[1]


def test_controller_replica_arm_drives_the_tier():
    counts = []
    for r, mk in _tiers():
        tier = mk(r, VID, n_replicas=1)
        try:
            r.run_epoch(complete_checkpoint=True)
            r.drain_fence()
            c = AutoscaleController(
                ScalePolicy(PolicyConfig(sustain_fences=2,
                                         cooldown_fences=1, min_workers=2,
                                         max_replicas=2)),
                add_replica=tier.add_replica,
                drop_replica=tier.drop_replica)
            for e in range(2):
                c.on_fence(e, sig(e, 1.0, staleness=9,
                                  replicas=len(tier.replicas)))
            assert len(tier.replicas) == 2 and c.replicas_added == 1
            for e in range(2, 5):
                c.on_fence(e, sig(e, 0.1, workers=2,
                                  replicas=len(tier.replicas)))
            assert len(tier.replicas) == 1 and c.replicas_dropped == 1
            counts.append(c.log.to_bytes())
        finally:
            tier.close()
    assert counts[0] == counts[1]


# --- signal plane off a real registry snapshot ----------------------------

def test_signal_aggregator_samples_registry_rollup():
    from clonos_tpu.utils.metrics import MetricRegistry as JaxRegistry
    from clonos_tpu_torch.utils.metrics import MetricRegistry
    out = []
    for reg_cls, agg_cls in ((MetricRegistry, SignalAggregator),
                             (JaxRegistry, jas.SignalAggregator)):
        reg = reg_cls()
        g = reg.group("soak")
        g.gauge("offered-rate", lambda: 4000.0)
        g.gauge("rate", lambda: 2000.0)
        g.gauge("backlog-chunks", lambda: 3)
        sg = reg.group("serve")
        sg.gauge("replica.0.staleness-epochs", lambda: 1)
        sg.gauge("replica.1.staleness-epochs", lambda: 4)
        sg.gauge("p99-read-ms", lambda: 12.5)
        agg = agg_cls(window=2)
        s = agg.sample_from(reg.snapshot(), epoch=7, workers=2)
        assert s.load == 2.0
        assert s.backlog_chunks == 3
        assert s.max_staleness == 4 and s.replicas_total == 2
        assert s.p99_read_ms == 12.5
        g.remove("offered-rate")
        g.gauge("offered-rate", lambda: 2000.0)
        s2 = agg.sample_from(reg.snapshot(), epoch=8, workers=2,
                             gray_suspects=1)
        assert s2.load == 1.5
        assert type(s2).from_dict(
            json.loads(s2.canonical())).crc() == s2.crc()
        out.append((s.canonical(), s2.canonical(), s2.crc()))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        SignalAggregator(window=0)


# --- seeded bugs: exact minimal counterexamples (the port's verify/) ------

def _ce(bug):
    from clonos_tpu.verify.runner import run_verify as jrun
    from clonos_tpu_torch.verify.runner import run_verify
    r = run_verify(models=["scalepolicy"], quick=True,
                   bugs={"scalepolicy": bug})
    assert not r.ok and r.exit_code() == 1
    jr = jrun(models=["scalepolicy"], quick=True,
              bugs={"scalepolicy": bug})
    assert [a.label() for a in r.violations[0].trace] == \
        [a.label() for a in jr.violations[0].trace]
    return r.violations[0]


def test_no_cooldown_bug_minimal_thrash():
    """Without the cooldown clock, one spike-then-idle flip thrashes:
    up at one fence, straight back down at the next."""
    v = _ce("no-cooldown")
    assert v.invariant == "no-thrash"
    assert [a.label() for a in v.trace] == [
        "signal(2)", "fence", "decide", "execute",
        "signal(0)", "fence", "decide", "execute"]


def test_unlogged_decision_bug_minimal_ce():
    """An executed scale action whose decision never hit the SCALE
    log: recovery would re-decide instead of replaying."""
    v = _ce("unlogged-decision")
    assert v.invariant == "decision-logged"
    assert [a.label() for a in v.trace] == [
        "signal(2)", "fence", "decide", "execute"]


def test_rescale_mid_recovery_bug_minimal_ce():
    """A kill lands between decide and execute; skipping the execute-
    time health re-check re-cuts over an in-progress recovery."""
    v = _ce("rescale-mid-recovery")
    assert v.invariant == "no-rescale-mid-recovery"
    assert [a.label() for a in v.trace] == [
        "signal(2)", "fence", "decide", "kill", "execute"]


def test_conformance_real_controller_matches_model():
    from clonos_tpu_torch.verify.conformance import conform_scalepolicy
    rep = conform_scalepolicy()
    assert rep.ok, rep.divergences
    assert rep.steps > 0 and rep.traces > 0


def test_model_ce_compiles_to_load_spike_chaos_event():
    """The verify -> chaos bridge: a scalepolicy counterexample's
    signal(2) step carries a load-spike hint that compiles to a
    parseable DSL event, the reference's text."""
    from clonos_tpu.verify.bridge import compile_trace as jcompile
    from clonos_tpu.verify.runner import run_verify as jrun
    from clonos_tpu_torch.soak.chaos import parse_schedule
    from clonos_tpu_torch.verify.bridge import compile_trace
    v = _ce("no-cooldown")
    sched = compile_trace(v)
    spikes = [ev for ev in sched if ev.kind == "load-spike"]
    assert spikes and spikes[0].factor == 4.0
    assert parse_schedule(sched.to_text()).to_text() == sched.to_text()
    jv = jrun(models=["scalepolicy"], quick=True,
              bugs={"scalepolicy": "no-cooldown"}).violations[0]
    assert sched.to_text() == jcompile(jv).to_text()


def test_signals_for_level_matches_conformance_loads():
    for level in (0, 1, 2):
        a = signals_for_level(level, epoch=3, workers=2, replicas=2)
        b = jas.signals_for_level(level, epoch=3, workers=2, replicas=2)
        assert a.canonical() == b.canonical()
    lo = signals_for_level(0, epoch=0, workers=2)
    hi = signals_for_level(2, epoch=0, workers=2)
    p = ScalePolicy(PolicyConfig(sustain_fences=1))
    d, _ = p.decide(hi, PolicyState())
    assert d.action == SCALE_WORKERS
    d, _ = p.decide(lo, PolicyState())
    assert d.action == HOLD or d.delta <= 0


def test_top_table_renders_autoscale_row():
    from clonos_tpu.cli import _top_table as jax_top
    from clonos_tpu_torch.cli import _top_table
    from clonos_tpu_torch.utils.metrics import MetricRegistry
    snap = {"autoscale.decisions-total": 5,
            "autoscale.rescales-executed": 1,
            "autoscale.cooldown-active": 2,
            "autoscale.target-workers": 3,
            "autoscale.actual-workers": 3}
    table = _top_table(snap)
    assert table == jax_top(snap)
    line = next(ln for ln in table.splitlines()
                if ln.startswith("autoscale:"))
    assert "decisions-total=5" in line and "target-workers=3" in line
    assert "autoscale:" in _top_table(
        {"worker.w1.autoscale.decisions-total": 2})
    assert "autoscale:" not in _top_table({"worker.w0.slots": 1})
    # the controller's own gauges render the row
    reg = MetricRegistry()
    c, _ = _controller()
    _run_trace(c, TRACE[:3])
    c.register_gauges(reg, actual_workers=lambda: 3)
    snap = reg.snapshot()
    assert snap["autoscale.decisions-total"] == 3
    assert snap["autoscale.target-workers"] == 3
    assert "autoscale:" in _top_table(snap)
