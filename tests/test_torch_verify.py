"""PyTorch port, the protocol model checker (``clonos_tpu_torch/verify/``):
every case of ``tests/test_verify.py`` run against the port (the three CLI
cases are in ``tests/test_torch_cli.py``), then parity with the reference
package, tolerance exact:

- for each of the six models, clean and with each seeded bug, at
  ``QUICK_BOUND`` and at the default bound: ``explore``'s states, depth,
  truncation flag and each violation's invariant and trace labels,
  ``traces(model, n=5)``'s labels, ``format_json(run_verify(...))``, the
  compiled schedule's DSL text and the bytes of both files
  ``write_counterexample`` writes;
- conformance: the same model traces replayed through the reference's
  adapter over the reference component and the port's adapter over the
  port's component give equal observation lists, step for step. No port
  component differs here from the reference's (the port-only repairs
  touch ``bootstrap_standby``, ``rescale_live`` and the file sink, none of
  the six components), so no difference is allowed.
"""

import json
import os

import numpy as np
import pytest

from clonos_tpu import verify as jv
from clonos_tpu.verify import conformance as jconf
from clonos_tpu_torch import verify as pv
from clonos_tpu_torch.verify import (BUGS, MODELS, Action, Model,
                                     compile_trace, explore, run_verify,
                                     traces, write_counterexample)
from clonos_tpu_torch.verify import conformance as pconf


# --- explorer -------------------------------------------------------------

class _Counter(Model):
    """Toy model: two counters that may each step to 3; invariant
    forbids both reaching 2+, liveness demands both leave 0."""

    name = "counter"

    def __init__(self, bound=3, bad_pair=True):
        self.bound = bound
        self.bad_pair = bad_pair

    def initial_state(self):
        return (0, 0)

    def enabled(self, state):
        return [Action("inc", (i,)) for i in (0, 1)
                if state[i] < self.bound]

    def apply(self, state, action):
        i = action.args[0]
        return tuple(v + 1 if j == i else v
                     for j, v in enumerate(state))

    def invariants(self):
        if not self.bad_pair:
            return []
        return [("not-both-2", lambda s:
                 "both counters >= 2" if min(s) >= 2 else None)]

    def canon(self, state):
        return tuple(sorted(state))      # counters are symmetric

    def settled(self, state):
        return "a counter never moved" if 0 in state else None


def test_explorer_finds_minimal_counterexample_bfs():
    r = explore(_Counter())
    assert not r.ok
    v = r.violations[0]
    # BFS: the first violating state found is at minimal depth (2+2).
    assert v.depth == 4
    assert [a.kind for a in v.trace] == ["inc"] * 4
    assert v.invariant == "not-both-2"


def test_explorer_symmetry_canon_dedups_states():
    r = explore(_Counter(bad_pair=False))
    # Without canon: (bound+1)^2 = 16 states; with sorted-pair canon
    # only the triangle remains.
    assert r.states == 10
    assert r.ok


def test_explorer_liveness_flags_wedged_terminal_states():
    class Wedge(_Counter):
        def enabled(self, state):
            return []                    # initial state is terminal

    r = explore(Wedge(bad_pair=False))
    assert [v.invariant for v in r.violations] == ["liveness"]
    assert "never moved" in r.violations[0].detail


def test_explorer_truncation_is_reported_not_judged():
    r = explore(_Counter(bound=50, bad_pair=False), depth=3)
    assert r.truncated
    # cut-off states are not deadlocks: no liveness violations
    assert r.ok


def test_traces_prefers_full_protocol_rounds():
    ts = traces(_Counter(bound=2, bad_pair=False), n=3)
    assert len(ts) == 3
    # deepest-first: the first trace reaches the (2, 2) terminal state
    assert len(ts[0]) == 4
    sigs = {tuple(a.label() for a in t) for t in ts}
    assert len(sigs) == 3                # distinct by construction


# --- the six models -------------------------------------------------------

def test_all_models_clean_at_default_bound():
    r = run_verify()
    assert r.ok and r.exit_code() == 0
    assert {rep.model for rep in r.reports} == set(MODELS)
    for rep in r.reports:
        assert rep.states > 0 and not rep.truncated, rep.model


@pytest.mark.parametrize("model,bug", [(m, b) for m in sorted(BUGS)
                                       for b in sorted(BUGS[m])])
def test_every_seeded_bug_yields_a_counterexample(model, bug):
    r = run_verify(models=[model], quick=True, bugs={model: bug})
    assert not r.ok and r.exit_code() == 1, f"{model}:{bug} not caught"
    assert r.violations[0].trace          # with a concrete trace


def test_lease_bug_counterexample_is_the_minimal_three_steps():
    r = run_verify(models=["lease"], quick=True,
                   bugs={"lease": "no-fencing-check"})
    v = r.violations[0]
    assert v.invariant == "single-fenced-writer"
    # The classic split-brain: A acquires, the lease lapses, B acquires
    # — and with no receiver-side check both tokens stay accepted.
    assert [a.label() for a in v.trace] == ["acquire(0)", "expire",
                                            "acquire(1)"]


def test_checkpoint_late_ack_regresses_the_truncation_fence():
    r = run_verify(models=["checkpoint"], quick=True,
                   bugs={"checkpoint": "late-ack"})
    v = r.violations[0]
    assert v.invariant == "truncate-monotone"
    labels = [a.label() for a in v.trace]
    # the late completion lands after a newer fence truncated higher
    assert labels[-1].startswith("ack(1")


def test_unknown_model_and_bug_are_rejected():
    with pytest.raises(ValueError):
        run_verify(models=["nope"])
    with pytest.raises(ValueError):
        run_verify(bugs={"lease": "nope"})


@pytest.mark.slow
def test_full_depth_sweep_is_clean():
    """The big bound: 3 workers, 3 epochs, 2 faults — tens of
    thousands of states per model, still violation-free."""
    r = run_verify(workers=3, epochs=3, faults=2, depth=64,
                   max_states=500_000)
    assert r.ok, "\n".join(str(v.to_dict()) for v in r.violations)
    ckpt = next(rep for rep in r.reports if rep.model == "checkpoint")
    assert ckpt.states > 5_000           # genuinely exhaustive
    for model, bugs in BUGS.items():
        for bug in bugs:
            rb = run_verify(models=[model], workers=3, epochs=3,
                            faults=2, depth=64, max_states=500_000,
                            bugs={model: bug})
            assert not rb.ok, f"{model}:{bug} escaped the big bound"


# --- counterexample -> chaos bridge ---------------------------------------

def test_bridge_round_trips_through_the_chaos_dsl(tmp_path):
    from clonos_tpu_torch.soak.chaos import (parse_schedule,
                                             read_trace_schedule)

    r = run_verify(models=["lease"], quick=True,
                   bugs={"lease": "no-fencing-check"})
    v = r.violations[0]
    sched = compile_trace(v)
    assert sched.kinds() == ["leader-loss"]
    assert parse_schedule(sched.to_text()) == sched

    out = write_counterexample(str(tmp_path), v)
    assert os.path.exists(out["chaos"]) and os.path.exists(out["trace"])
    # the .chaos file is valid DSL and equal to the compiled schedule
    with open(out["chaos"]) as f:
        assert parse_schedule(f.read()) == sched
    # the .jsonl trace imports back as the same schedule, and records
    # every model step (including the ones with no live-fault analog)
    assert read_trace_schedule(out["trace"]) == sched
    with open(out["trace"]) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert [rec["action"] for rec in recs] == ["acquire(0)", "expire",
                                              "acquire(1)"]
    assert sum(1 for rec in recs if rec["chaos"]) == 1


def test_trace_import_tolerates_a_torn_tail(tmp_path):
    from clonos_tpu_torch.soak.chaos import read_trace_schedule

    r = run_verify(models=["checkpoint"], quick=True,
                   bugs={"checkpoint": "unlogged-write"})
    out = write_counterexample(str(tmp_path), r.violations[0])
    with open(out["trace"], "a") as f:
        f.write('{"model": "checkpoint", "truncated-mid-wri')
    sched = read_trace_schedule(out["trace"])
    assert sched.kinds() == ["nondet"]   # torn tail dropped, not fatal


def test_shared_jsonl_reader_contract(tmp_path):
    from clonos_tpu_torch.utils.jsonl import read_jsonl

    p = tmp_path / "log.jsonl"
    assert read_jsonl(str(p)) == []      # missing file: empty log
    p.write_text('{"a": 1}\n\n{"b": 2}\n{"torn": ')
    assert read_jsonl(str(p)) == [{"a": 1}, {"b": 2}]
    # mid-file corruption is NOT a torn tail: it must raise, and with
    # a label the error names the file and line
    p.write_text('{"a": 1}\njunk\n{"b": 2}\n')
    with pytest.raises(json.JSONDecodeError):
        read_jsonl(str(p))
    with pytest.raises(ValueError, match=r"log\.jsonl:2"):
        read_jsonl(str(p), label=str(p))


# --- conformance: models vs the port's components -------------------------

def test_conformance_all_components_match_bit_for_bit(tmp_path):
    from clonos_tpu_torch.verify.conformance import run_conformance

    reports = run_conformance(n_traces=3, workdir=str(tmp_path))
    assert set(reports) == {"checkpoint", "recovery", "lease",
                            "admission", "repartition", "scalepolicy"}
    for name, rep in sorted(reports.items()):
        assert rep.traces >= 3, f"{name}: only {rep.traces} trace(s)"
        assert rep.steps >= rep.traces   # every trace drove real code
        assert rep.ok, (f"{name} diverged: "
                        f"{[d.to_dict() for d in rep.divergences]}")


def test_conformance_catches_an_implementation_divergence(tmp_path):
    """Negative control: sabotage one observable transition and the
    conformance layer must flag it (divergence fails CI, not silently
    passes)."""
    from clonos_tpu_torch.runtime.dispatcher import AdmissionController
    from clonos_tpu_torch.verify.conformance import conform_admission

    orig = AdmissionController.request
    def sabotaged(self, job_id, tenant, slots, free_slots):
        verdict = orig(self, job_id, tenant, slots, free_slots)
        if verdict == "admitted":        # leak a phantom reservation
            self._pending[job_id + "-ghost"] = (tenant, 1)
        return verdict
    AdmissionController.request = sabotaged
    try:
        rep = conform_admission(n_traces=3)
    finally:
        AdmissionController.request = orig
    assert not rep.ok
    assert any("projection" in str(d.expected) for d in rep.divergences)


def test_recovery_fsm_reports_every_transition_to_its_observers():
    """The port's ``RecoveryManager`` calls its ``transition_observers``
    with the entered state's name at every FSM step, as the reference's
    does; conformance reads the recovery protocol through them."""
    from clonos_tpu_torch.causal.recovery import RecoveryManager

    mgr = RecoveryManager(vertex_id=0, subtask=0, flat_subtask=3,
                          replayer=None)
    seen = []
    mgr.transition_observers.append(
        lambda kind, **f: seen.append((kind, f["flat"])))
    mgr.notify_start_recovery(in_edges=[0], out_edges=[])
    mgr.notify_state_restoration_complete()
    mgr.notify_new_input_channel(0)
    mgr.expect_determinant_responses(0)
    assert seen == [("WAITING_CONNECTIONS", 3),
                    ("WAITING_DETERMINANTS", 3), ("REPLAYING", 3)]
    assert [s.name for s in mgr.transitions[1:]] == [k for k, _ in seen]


# --- the live acceptance chain --------------------------------------------

@pytest.mark.slow
def test_counterexample_reproduces_audit_divergence_live(tmp_path):
    """The full bridge, end to end: the checkpoint model with the
    seeded ``unlogged-write`` bug produces a counterexample whose
    ``perturb`` step compiles to a ``nondet`` chaos event; importing
    that schedule from the written trace file and driving a LIVE soak
    cluster of the port with it (on the CPU here) must trip the
    epoch-digest audit."""
    from clonos_tpu_torch.soak import (SLOSpec, SoakConfig, SoakDriver,
                                       build_soak_fixture)
    from clonos_tpu_torch.soak.chaos import read_trace_schedule

    r = run_verify(models=["checkpoint"], quick=True,
                   bugs={"checkpoint": "unlogged-write"})
    v = r.violations[0]
    assert v.invariant == "exactly-once-logged"
    out = write_counterexample(str(tmp_path), v, start_s=1.5)
    sched = read_trace_schedule(out["trace"])
    assert sched.kinds() == ["nondet"]

    runner, control, election = build_soak_fixture(
        str(tmp_path / "soak"), rate=1200.0, duration_s=4.0,
        steps_per_epoch=32, seed=11, device="cpu")
    driver = SoakDriver(
        runner, SoakConfig(rate=1200.0, duration_s=4.0, window_s=2.0),
        schedule=sched, spec=SLOSpec(exactly_once=True),
        control=control, election=election, records_per_step=16)
    verdict = driver.run()

    assert verdict["pass"] is False
    assert verdict["audit"]["exactly_once"] is False
    assert verdict["audit"]["divergences"]


# --- parity with the reference package ------------------------------------

_CASES = [(m, None) for m in sorted(MODELS)] + [
    (m, b) for m in sorted(BUGS) for b in sorted(BUGS[m])]
_BOUNDS = {
    "quick": dict(pv.QUICK_BOUND),
    "default": dict(workers=2, epochs=2, faults=1, depth=48,
                    max_states=200_000),
}


def _explore_view(r):
    return (r.model, r.states, r.transitions, r.depth, r.truncated,
            [(v.invariant, v.detail, v.depth,
              [a.label() for a in v.trace]) for v in r.violations])


def test_reference_and_port_share_the_registries():
    assert sorted(pv.MODELS) == sorted(jv.MODELS)
    assert {m: sorted(b.items()) for m, b in pv.BUGS.items()} == \
        {m: sorted(b.items()) for m, b in jv.BUGS.items()}
    assert pv.QUICK_BOUND == jv.QUICK_BOUND
    assert sorted(pv.__all__) == sorted(jv.__all__)


@pytest.mark.parametrize("bound", sorted(_BOUNDS))
@pytest.mark.parametrize("model,bug", _CASES)
def test_explore_traces_and_report_equal_the_reference(model, bug, bound,
                                                       tmp_path):
    b = _BOUNDS[bound]
    shape = dict(workers=b["workers"], epochs=b["epochs"],
                 faults=b["faults"], bug=bug)
    jm, pm = jv.MODELS[model](**shape), pv.MODELS[model](**shape)
    jr = jv.explore(jm, depth=b["depth"], max_states=b["max_states"])
    pr = pv.explore(pm, depth=b["depth"], max_states=b["max_states"])
    assert _explore_view(pr) == _explore_view(jr)
    assert pr.ok == (bug is None)
    assert [[a.label() for a in t] for t in pv.traces(pm, n=5)] == \
        [[a.label() for a in t] for t in jv.traces(jm, n=5)]
    bugs = {model: bug} if bug else None
    run = dict(models=[model], workers=b["workers"], epochs=b["epochs"],
               faults=b["faults"], depth=b["depth"],
               max_states=b["max_states"], quick=bound == "quick",
               bugs=bugs)
    jres, pres = jv.run_verify(**run), pv.run_verify(**run)
    assert pv.format_json(pres) == jv.format_json(jres)
    assert pv.format_text(pres) == jv.format_text(jres)
    assert pres.exit_code() == jres.exit_code() == (1 if bug else 0)
    for jviol, pviol in zip(jr.violations, pr.violations):
        for start_s, spacing_s in ((0.5, 1.0), (1.5, 0.25)):
            assert pv.compile_trace(pviol, start_s, spacing_s).to_text() \
                == jv.compile_trace(jviol, start_s, spacing_s).to_text()
            assert pv.trace_records(pviol, start_s, spacing_s) == \
                jv.trace_records(jviol, start_s, spacing_s)
            jout = jv.write_counterexample(str(tmp_path / "ref"), jviol,
                                           start_s, spacing_s)
            pout = pv.write_counterexample(str(tmp_path / "port"), pviol,
                                           start_s, spacing_s)
            for key in ("chaos", "trace"):
                assert os.path.basename(pout[key]) == \
                    os.path.basename(jout[key])
                with open(pout[key], "rb") as pf, \
                        open(jout[key], "rb") as jf:
                    assert pf.read() == jf.read()


def test_whole_sweep_equals_the_reference_at_both_bounds():
    for quick in (True, False):
        assert pv.format_json(pv.run_verify(quick=quick)) == \
            jv.format_json(jv.run_verify(quick=quick))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_for_equals_the_reference_on_seeded_hints(seed):
    """``event_for`` on seeded chaos hints (every fault kind the models
    name, seeded targets and overrides) gives the reference's event."""
    rng = np.random.RandomState(seed)
    kinds = ["kill", "leader-loss", "nondet", "stall", "load-spike"]
    for i in range(20):
        kind = kinds[int(rng.randint(len(kinds)))]
        overrides = []
        if rng.randint(2):
            overrides.append(("targets", tuple(
                int(t) for t in rng.randint(0, 8, size=rng.randint(1, 4)))))
        if kind == "load-spike":
            overrides += [("factor", float(rng.choice([2.0, 4.0]))),
                          ("duration_s", float(rng.randint(1, 5)))]
        if kind == "stall":
            overrides += [("delay_s", round(float(rng.uniform(0, 1)), 3)),
                          ("duration_s", 2.0)]
        if kind == "leader-loss":
            overrides.append(("hold_s", 0.5))
        at = round(float(rng.uniform(0, 30)), 4)
        ja = jv.Action("x", (i,), chaos=(kind, tuple(overrides)))
        pa = pv.Action("x", (i,), chaos=(kind, tuple(overrides)))
        assert pa.label() == ja.label()
        je, pe = jv.event_for(ja, at), pv.event_for(pa, at)
        assert (pe.at_s, pe.kind, pe.targets, pe.delay_s, pe.duration_s,
                pe.hold_s, pe.factor) == \
            (je.at_s, je.kind, je.targets, je.delay_s, je.duration_s,
             je.hold_s, je.factor)
        assert pe.to_text() == je.to_text()
    assert pv.event_for(pv.Action("ack"), 1.0) is None


def _recorded(conf_mod, monkeypatch):
    """Wrap ``conf_mod._replay`` so every adapter's per-step observation
    list is recorded as (trace, step, action label, observations)."""
    rec = []
    orig = conf_mod._replay

    def replay(component, model, model_traces, make_adapter):
        state = {"trace": -1}

        def make():
            state["trace"] += 1
            ti = state["trace"]
            a = make_adapter()
            apply = a.apply

            def recording(st, action):
                obs = apply(st, action)
                rec.append((ti, action.label(),
                            [tuple(o) for o in obs]))
                return obs
            a.apply = recording
            return a
        return orig(component, model, model_traces, make)
    monkeypatch.setattr(conf_mod, "_replay", replay)
    return rec


_COMPONENTS = ["admission", "checkpoint", "lease", "recovery",
               "repartition", "scalepolicy"]


@pytest.mark.parametrize("bound", [dict(workers=2, epochs=2, faults=1),
                                   dict(workers=3, epochs=2, faults=2)],
                         ids=["2w2e1f", "3w2e2f"])
@pytest.mark.parametrize("component", _COMPONENTS)
def test_conformance_observations_equal_the_reference(component, bound,
                                                      tmp_path,
                                                      monkeypatch):
    """The same model traces through the reference's adapter over the
    reference component and through the port's adapter over the port's
    component: equal reports and equal observation lists, step for
    step (no port-only repair touches these six components)."""
    jrec = _recorded(jconf, monkeypatch)
    prec = _recorded(pconf, monkeypatch)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    jrep = jconf.run_conformance([component], n_traces=20,
                                 workdir=str(tmp_path / "ref"),
                                 **bound)[component]
    prep = pconf.run_conformance([component], n_traces=20,
                                 workdir=str(tmp_path / "port"),
                                 **bound)[component]
    assert prep.to_dict() == jrep.to_dict()
    assert prep.ok and prep.steps > prep.traces >= 10
    assert prec == jrec
    assert len(prec) == prep.steps
