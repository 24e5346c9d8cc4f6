"""PyTorch port, the soak driver (``soak/driver.py``, ``soak/serveload.py``
and the CLI's ``soak``), held to the reference without a wall clock:

- the harness, fault by fault: both packages' soak fixtures (parallelism
  2, batch 8, 16-step epochs) take the same fault through
  ``SoakHarness.apply`` at the same step, then ``audit_check``; their
  sealed ledgers, divergence lists and harness tallies are equal, and
  the ``nondet`` fault's salted ring values are bit-equal. After a
  ``rescale`` each package's ledger equals its own control twin's (the
  two packages' ledgers differ there by design: the port writes the
  fence's SOURCE_CHECKPOINT rows into the new runner, ROADMAP Queue 3
  item 6);
- the paced driver on an injected clock (the driver module's ``_time``
  replaced in both packages; ``sleep`` advances it): the same schedule
  gives equal ledgers, faults by kind, ``epochs_checked``, ``pass`` and
  ``exactly_once``, and the same ``soak.*`` gauge keys;
- the CLI's ``soak --report json``: its line's keys equal the
  reference's, and it exits 0 on a clean schedule and 1 on ``nondet``;
- the verdict's ``census_fingerprint``: the port's own census, equal to
  the pin ``clonos_tpu_torch/.clonos-census`` from any working
  directory, and not the reference's.

Mirrors, run through the port on the injected clock: ``tests/test_soak.py``'s
``test_soak_smoke_kill_and_gray_hold_slo_and_audit``,
``test_soak_injected_nondet_fails_the_run``,
``test_soak_mid_run_rescale_holds_exactly_once`` and
``test_soak_cli_report_json_exit_codes`` (a subprocess, on the wall
clock of its own process); ``tests/test_autoscale.py``'s
``test_closed_loop_soak_recuts_itself_under_load_spike`` (the port
alone: the autoscaler's signals come from the runner's rate meters)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from clonos_tpu.soak import driver as jax_driver
from clonos_tpu.soak import SoakHarness as JaxHarness
from clonos_tpu.soak import parse_schedule as jax_parse
from clonos_tpu_torch.analysis import census_fingerprint
from clonos_tpu_torch.analysis.census import CENSUS_PIN, read_pin
from clonos_tpu_torch.obs import audit as audit_mod
from clonos_tpu_torch.soak import (SLOSpec, SoakConfig, SoakDriver,
                                   SoakHarness, ServeLoad,
                                   build_soak_fixture, default_kill_targets,
                                   parse_schedule)
from clonos_tpu_torch.soak import driver as port_driver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: 8-step chunks of 16 records a step: one chunk every 0.1 s of soak clock
RATE = 1280.0
RPS = 16


class FakeTime:
    """The driver module's clock: ``sleep`` advances ``monotonic``."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, float(s))


@pytest.fixture
def fake_time(monkeypatch):
    clocks = []

    def install():
        for mod in (jax_driver, port_driver):
            c = FakeTime()
            monkeypatch.setattr(mod, "_time", c)
            clocks.append(c)
    return install


def _fixtures(tmp_path, duration_s=3.0, **kw):
    base = dict(rate=RATE, duration_s=duration_s, steps_per_epoch=16,
                par=2, batch=8, seed=11)
    base.update(kw)
    return (build_soak_fixture(str(tmp_path / "port"), device="cpu",
                               **base),
            jax_driver.build_soak_fixture(str(tmp_path / "ref"), **base))


def _ring_values(runner):
    return [np.array(el.values) for el in runner.executor.carry.out_rings]


def _harness_run(runner, control, election, harness_cls, text):
    """Two completed epochs, then the fault: mid-epoch (8 steps in) or,
    for ``rescale``, at the drained completed fence; one more epoch
    (left pending under ``backlog``, as the driver leaves it), the
    fault's expiry, a completed epoch and the audit."""
    (ev,) = list(parse_schedule(text))
    h = harness_cls(runner, control=control, election=election)
    for _ in range(2):
        runner.run_epoch(complete_checkpoint=True)
    runner.drain_fence()
    if ev.kind != "rescale":
        for _ in range(8):
            runner.step()
    h.apply(ev, 0.0)
    salted = _ring_values(h.runner) if ev.kind == "nondet" else None
    r = h.runner
    if h.backlog_active(0.5):
        r.run_epoch(complete_checkpoint=False)
        r.drain_fence()
        r.coordinator.discard_pending_through(r.executor.epoch_id - 1)
    else:
        r.run_epoch(complete_checkpoint=True)
    state = dict(lag=dict(r.heartbeats.lag), rate=h.rate_factor(0.5),
                 renewed=election.renew() if ev.kind == "leader-loss"
                 else None)
    h.tick(10.0)
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    return h, h.audit_check(), salted, state


@pytest.mark.parametrize("text", [
    "at 0s kill 1,3,5",
    "at 0s gray 3 delay=30ms for 1s",
    "at 0s leader-loss hold=100ms",
    "at 0s stall delay=1ms for 1s",
    "at 0s backlog for 1s",
    "at 0s nondet",
    "at 0s load-spike 4x for 1s",
    "at 0s rescale 4",
], ids=lambda t: t.split()[2])
def test_harness_fault_by_fault_equals_reference(tmp_path, text):
    (pr, pc, pe), (jr, jc, je) = _fixtures(tmp_path)
    assert default_kill_targets(pr.job) == \
        jax_driver.default_kill_targets(jr.job) == [1, 3, 5]
    ph, p_problems, p_salted, p_state = _harness_run(pr, pc, pe,
                                                     SoakHarness, text)
    jh, j_problems, j_salted, j_state = _harness_run(jr, jc, je,
                                                     JaxHarness, text)
    kind = text.split()[2]
    assert p_problems == ph.divergences
    assert p_state == j_state
    for attr in ("faults_injected", "faults_survived", "by_kind",
                 "rescales", "spike_factor", "kill_rediff_problems"):
        assert getattr(ph, attr) == getattr(jh, attr), attr
    assert len(ph.recoveries_ms) == len(jh.recoveries_ms)
    if kind == "rescale":
        # Each package against its own control twin (the port's re-cut
        # seals the fence's source rows, the reference's does not).
        assert p_problems == [] and j_problems == []
        assert ph.rescale_stats[0]["drained_records"] == \
            jh.rescale_stats[0]["drained_records"]
        assert ph.runner is not pr and ph.control is not pc
        return
    assert ph.runner.auditor.ledger() == jh.runner.auditor.ledger()
    assert p_problems == j_problems
    if kind == "nondet":
        assert p_problems and any("ring" in p for p in p_problems)
        for a, b in zip(p_salted, j_salted):
            np.testing.assert_array_equal(a, b)
    else:
        assert p_problems == []
    assert ph.epochs_checked == jh.epochs_checked > 0


def test_nondet_salt_wraps_and_floor_mods_as_the_reference():
    """The ``nondet`` salt on int32 values across the whole range (the
    product and the sum wrap at 32 bits, ``%`` is the floor modulo), bit
    for bit against the reference's ``jnp`` expression."""
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(3)
    v = np.concatenate([
        rng.randint(-2 ** 31, 2 ** 31 - 1, 4096, dtype=np.int64),
        [-2 ** 31, 2 ** 31 - 1, -1, 0, 1, 69273665, -69273667],
    ]).astype(np.int32)
    ref = np.asarray((jnp.asarray(v) * jax_driver._NONDET_MULT
                      + jax_driver._NONDET_ADD) % jax_driver._NONDET_MOD)
    mine = port_driver._salted(torch.from_numpy(v)).numpy()
    assert mine.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(mine, ref)


def _driver_run(runner, control, election, driver_cls, schedule,
                duration_s=3.0):
    d = driver_cls(runner, SoakConfig(rate=RATE, duration_s=duration_s,
                                      window_s=1.0, chunk_steps=8),
                   schedule=schedule, spec=SLOSpec(exactly_once=True),
                   control=control, election=election,
                   records_per_step=RPS)
    return d, d.run()


@pytest.mark.parametrize("text,passes", [
    ("at 0.45s kill 1,3\nat 0.85s gray 3 delay=20ms for 0.5s\n"
     "at 1.25s stall delay=1ms for 0.4s\nat 1.65s backlog for 0.15s\n"
     "at 2.05s load-spike 2x for 0.3s\nat 2.25s leader-loss hold=50ms",
     True),
    ("at 1.05s nondet", False),
], ids=["every-operator-fault", "nondet"])
def test_driver_on_an_injected_clock_equals_reference(tmp_path, fake_time,
                                                      text, passes):
    fake_time()
    (pr, pc, pe), (jr, jc, je) = _fixtures(tmp_path)
    pd, pv = _driver_run(pr, pc, pe, SoakDriver, parse_schedule(text))
    jd, jv = _driver_run(jr, jc, je, jax_driver.SoakDriver,
                         jax_parse(text))
    assert pd.runner.auditor.ledger() == jd.runner.auditor.ledger()
    assert pv["faults"]["by_kind"] == jv["faults"]["by_kind"]
    assert sum(pv["faults"]["by_kind"].values()) == len(
        parse_schedule(text))
    assert pv["audit"] == jv["audit"]
    assert (pv["pass"], pv["audit"]["exactly_once"]) == (passes, passes)
    assert (jv["pass"], jv["records"], jv["events_fired"]) == (
        pv["pass"], pv["records"], pv["events_fired"])
    soak_keys = lambda r: sorted(k for k in r.metrics.snapshot()
                                 if k.startswith("soak."))
    assert soak_keys(pd.runner) == soak_keys(jd.runner)
    assert set(pv) == set(jv)
    # each verdict names its own package's FT call-site census
    assert pv["census_fingerprint"] == read_pin(CENSUS_PIN)
    assert pv["census_fingerprint"] != jv["census_fingerprint"]


# --- mirrors of the reference's driver runs ----------------------------------


def _port_fixture(tmp_path, duration_s, rate=1200.0, **kw):
    return build_soak_fixture(str(tmp_path), rate=rate,
                              duration_s=duration_s, steps_per_epoch=32,
                              seed=11, device="cpu", **kw)


def test_soak_smoke_kill_and_gray_hold_slo_and_audit(tmp_path, fake_time):
    fake_time()
    runner, control, election = _port_fixture(tmp_path, 5.0)
    driver = SoakDriver(
        runner, SoakConfig(rate=1200.0, duration_s=5.0, window_s=2.0,
                           chunk_steps=8),
        schedule=parse_schedule(
            "at 1.2s kill 1,3\nat 2.2s gray 3 delay=30ms for 1.5s"),
        spec=SLOSpec(exactly_once=True, max_recovery_ms=30000.0),
        control=control, election=election, records_per_step=16)
    v = driver.run()
    assert v["pass"] is True
    assert v["audit"]["exactly_once"] is True
    assert v["audit"]["divergences"] == []
    assert v["audit"]["epochs_checked"] > 0
    assert v["faults"]["injected"] == 2
    assert v["faults"]["survived"] == 2
    assert v["faults"]["by_kind"] == {"gray": 1, "kill": 1}
    assert v["faults"]["recoveries_ms"]
    assert v["slo"]["max_recovery_ms"] == 30000.0
    assert len(v["faults"]["kill_overlap_saved_ms"]) == 1
    assert v["faults"]["kill_overlap_saved_ms"][0] >= 0.0
    assert v["faults"]["kill_rediff_problems"] == 0
    assert v["windows"] and all(
        "p99_ms" in w and "p50_ms" in w for w in v["windows"])
    assert "corrected" in v["latency"]["basis"]
    assert v["events_fired"] == 2
    snap = runner.metrics.snapshot()
    assert snap["soak.faults-injected"] == 2
    assert snap["soak.audit-ok"] == 1
    assert snap["soak.target-rate"] == 1200.0


def test_verdict_carries_the_ports_census_fingerprint(tmp_path, fake_time):
    """The verdict's ``census_fingerprint`` is the port's census, the
    value ``clonos_tpu_torch/.clonos-census`` pins — not None, and not
    the reference's pin at the repository root."""
    fake_time()
    runner, control, election = _port_fixture(tmp_path, 1.0)
    v = SoakDriver(
        runner, SoakConfig(rate=1200.0, duration_s=1.0, window_s=1.0),
        schedule=parse_schedule(""), spec=SLOSpec(exactly_once=True),
        control=control, election=election, records_per_step=16).run()
    assert v["pass"] is True
    assert v["census_fingerprint"] == read_pin(CENSUS_PIN)
    assert v["census_fingerprint"] == census_fingerprint()
    with open(os.path.join(REPO, ".clonos-census")) as f:
        assert v["census_fingerprint"] != f.read().split()[0]


def test_soak_injected_nondet_fails_the_run(tmp_path, fake_time):
    fake_time()
    runner, control, election = _port_fixture(tmp_path, 4.0)
    driver = SoakDriver(
        runner, SoakConfig(rate=1200.0, duration_s=4.0, window_s=2.0),
        schedule=parse_schedule("at 1.5s nondet"),
        spec=SLOSpec(exactly_once=True),
        control=control, election=election, records_per_step=16)
    v = driver.run()
    assert v["pass"] is False
    assert v["audit"]["exactly_once"] is False
    assert any("ring" in d for d in v["audit"]["divergences"])
    assert runner.metrics.snapshot()["soak.audit-ok"] == 0


def test_soak_mid_run_rescale_holds_exactly_once(tmp_path, fake_time):
    fake_time()
    runner, control, election = _port_fixture(tmp_path, 4.0, rate=4000.0)
    driver = SoakDriver(
        runner, SoakConfig(rate=4000.0, duration_s=4.0, window_s=1.0,
                           chunk_steps=8, complete_every=2),
        schedule=parse_schedule("at 1.2s rescale 4"),
        spec=SLOSpec(exactly_once=True),
        control=control, election=election, records_per_step=16)
    v = driver.run()
    assert v["pass"] is True
    assert v["audit"]["exactly_once"] is True
    assert v["audit"]["divergences"] == []
    assert v["audit"]["epochs_checked"] > 0
    assert v["faults"]["rescales"] == 1
    (stats,) = v["faults"]["rescale_stats"]
    assert stats["target"] == 4
    assert stats["drained_records"] >= 0
    assert sum(stats["moved_key_groups"].values()) > 0
    assert stats["fence_stall_ms"] >= 0.0
    assert driver.runner is not runner
    assert any(vx.parallelism == 4 for vx in driver.runner.job.vertices)
    assert driver.runner.metrics.snapshot()["soak.rescales"] == 1


def test_soak_with_a_read_tier_reroutes_a_killed_replica(tmp_path,
                                                        fake_time):
    """``serve_probe`` part 3 in small: a 2-replica tier on the reduce with
    a ``ServeLoad`` pumped every chunk; a replica killed mid-run reroutes
    its reads to the owner with no client-visible error."""
    from clonos_tpu_torch.runtime.serve import build_serve_tier
    fake_time()
    runner, control, election = _port_fixture(tmp_path, 3.0,
                                              serve_vertex=True)
    reduce_vid = next(v.vertex_id for v in runner.job.vertices
                      if v.name == "reduce")
    tier = build_serve_tier(runner, reduce_vid, n_replicas=2)
    try:
        load = ServeLoad(tier, reduce_vid, num_keys=101, reads_per_pump=8)
        driver = SoakDriver(
            runner, SoakConfig(rate=1200.0, duration_s=3.0, window_s=1.0),
            schedule=parse_schedule("at 1.1s replica-kill 0"),
            control=control, election=election, records_per_step=16,
            read_load=load)
        v = driver.run()
    finally:
        tier.close()
    s = v["serve"]
    assert v["pass"] is True and s["errors"] == 0
    assert s["replica_kills"] == 1 and s["reroutes"] > 0
    assert s["reads"] == load.reads > 0


def test_closed_loop_soak_recuts_itself_under_load_spike(tmp_path):
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            DecisionLog, PolicyConfig,
                                            ScalePolicy)

    runner, control, election = _port_fixture(tmp_path, 4.0, rate=4000.0)
    policy = lambda: ScalePolicy(PolicyConfig(
        sustain_fences=2, cooldown_fences=3, min_workers=1, max_workers=4))
    ctl = AutoscaleController(policy(),
                              log=DecisionLog(str(tmp_path / "scale.det")))
    driver = SoakDriver(
        runner, SoakConfig(rate=4000.0, duration_s=4.0, window_s=1.0,
                           chunk_steps=8, complete_every=2),
        schedule=parse_schedule("at 1.2s load-spike 4x for 1.5s"),
        spec=SLOSpec(exactly_once=True),
        control=control, election=election, records_per_step=16,
        autoscaler=ctl)
    v = driver.run()
    assert v["pass"] is True
    assert v["audit"]["exactly_once"] is True
    assert v["audit"]["divergences"] == []
    a = v["autoscale"]
    assert a["operator_rescale_events"] == 0
    assert a["autoscale_rescales"] >= 1
    assert a["rescales_executed"] == a["autoscale_rescales"]
    assert a["max_actions_per_cooldown"] <= 1
    assert a["decisions"] == len(ctl.log)
    for st in a["rescale_stats"]:
        assert sum(st["moved_key_groups"].values()) > 0
    assert driver.runner is not runner
    snap = driver.runner.metrics.snapshot()
    assert snap["autoscale.rescales-executed"] == a["autoscale_rescales"]
    assert snap["soak.offered-rate"] == 4000.0
    assert audit_mod.diff_ledgers_cross(
        driver.harness.control.auditor.ledger(),
        driver.runner.auditor.ledger()) == []
    c2 = AutoscaleController(policy(),
                             log=DecisionLog(str(tmp_path / "scale.det")))
    assert len(c2.log) == len(ctl.log)
    assert c2.log.digest() == ctl.log.digest()


# --- the CLI -----------------------------------------------------------------

CLI_ARGS = ["soak", "--rate", "1280", "--duration", "2", "--window", "1",
            "--steps-per-epoch", "16", "--report", "json"]


def test_soak_cli_json_line_keys_equal_reference(tmp_path, fake_time,
                                                 capsys):
    from clonos_tpu import cli as jax_cli
    from clonos_tpu_torch import cli
    fake_time()
    lines = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("ref", jax_cli.main, [])):
        rc = main(CLI_ARGS + extra + [
            "--schedule", "at 0.55s kill 1,3",
            "--workdir", str(tmp_path / name),
            "--out", str(tmp_path / f"{name}.json")])
        assert rc == 0
        lines.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    port, ref = lines
    assert set(port) == set(ref)
    for k in ("pass", "faults", "survived", "exactly_once", "divergences"):
        assert port[k] == ref[k], k
    art = [json.load(open(tmp_path / f"{n}.json")) for n in ("port", "ref")]
    assert set(art[0]) == set(art[1])


def test_soak_cli_report_json_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "clonos_tpu_torch"] + CLI_ARGS + [
        "--device", "cpu"]
    ok = subprocess.run(
        base + ["--schedule", "at 0.55s kill 1,3",
                "--workdir", str(tmp_path / "ok"),
                "--out", str(tmp_path / "ok.json")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert ok.returncode == 0, ok.stderr[-2000:]
    line = json.loads(ok.stdout.strip().splitlines()[-1])
    assert line["pass"] is True and line["exactly_once"] is True
    art = json.load(open(tmp_path / "ok.json"))
    assert art["metric"] == "soak_slo_verdict" and art["windows"]
    # run from another directory, the artifact still names the port's
    # census
    assert art["census_fingerprint"] == read_pin(CENSUS_PIN)

    bad = subprocess.run(
        base + ["--schedule", "at 0.75s nondet",
                "--workdir", str(tmp_path / "bad"),
                "--out", str(tmp_path / "bad.json")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert bad.returncode == 1, bad.stderr[-2000:]
    line = json.loads(bad.stdout.strip().splitlines()[-1])
    assert line["pass"] is False and line["divergences"] >= 1
