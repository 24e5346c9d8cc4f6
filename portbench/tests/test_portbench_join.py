"""The ``nexmark_join.recover`` cell at a tiny size on the CPU: a sound
run is correct with every compared number 0; the comparison fails when
it should, for faults planted here (a join that keeps 3 of its 4 left
slots, a replay that calls the external service again, a second
replica holder left a row behind, a holder dropped from every owner)
and for the controls of ``faults.py`` that reach this job (``half_batch``,
``drop_overflow``, ``rollback``); a traced run reads both new metrics
from the program's span counters, and a program without them reads
None and still runs; an untraced run never installs the tracer; a run
loads no JAX."""

import json
import subprocess
import sys

import pytest

from clonos_tpu_torch import obs
from clonos_tpu_torch.api import operators as ops
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import replication as rep
from clonos_tpu_torch.causal import services as svc
from clonos_tpu_torch.runtime import cluster
from clonos_tpu_torch.runtime.executor import LocalExecutor
from portbench import controls, harness

CELL = "nexmark_join.recover"
#: parallelism 2, batch 4, 13 keys, 64-step epochs, a 3-epoch backlog
TINY = dict(parallelism=2, batch=4, vocab=13, num_key_groups=8,
            edge_capacity=64, steps_per_epoch=64, pending_epochs=3,
            block_steps=32, inflight_ring_steps=256, log_capacity=1024,
            min_determinants=0)
METRICS = ("join_replay_mrows_per_s.recover",
           "join_fetch_host_share.recover")
#: the recovery phases' metrics this cell shares with ``allround.recover``
PHASES = ("recovery_replay_ms.recover", "recovery_fetch_ms.recover",
          "recovery_patch_ms.recover")
SEED = 2 ** 31 + 23


def _run(seconds=0.6, trace=False, seed=SEED, **overrides):
    return harness.run_cell(CELL, seed, seconds, trace, "cpu",
                            overrides={**TINY, **overrides})


def test_cell_is_correct_on_the_cpu():
    out = _run()
    line = out["line"]
    assert line["correct"], out["compared"]
    assert set(out["compared"]) == {"draws", "routing", "join_state",
                                    "sink", "replicas", "recovered",
                                    "services"}
    assert all(v == 0 for v in out["compared"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"recovery_ms_p90", "setup_s"}
    ctx = out["ctx"]
    assert len(ctx.results["recovered"]) == line["attempted"]
    assert {s for s, _ in ctx.results["recovered"]} == {
        out["captured"]["steps"]}
    assert set(ctx.results["recovery_kinds"]) <= {
        "+".join(k) for k in ctx.cell["kills"]}
    # Every recovery replayed the whole backlog; the samples hold work.
    cap = out["captured"]
    assert cap["steps"] == 4 * 64
    assert cap["sink"] and any(m.any() for _, (_, _, _, m) in cap["sink"])
    assert ctx.services.calls == 2 * 3


def _three_slots(monkeypatch):
    inner = ops.IntervalJoinOperator.process_block

    def block(self, state, batches, bctx):
        state, out = inner(self, state, batches, bctx)
        lm = state["lm"].clone()
        lm[..., -1] = False
        return dict(state, lm=lm), out
    monkeypatch.setattr(ops.IntervalJoinOperator, "process_block", block)


def _calls_again(monkeypatch):
    inner = svc.CausalSerializableService.apply

    def apply(self, request):
        if not self.recovering:
            return inner(self, request)
        self._append(self._feed.next_of(det.SerializableDeterminant))
        return self._fn(request)
    monkeypatch.setattr(svc.CausalSerializableService, "apply", apply)


def _stale_second_holder(monkeypatch):
    """Each surviving holder of a killed owner's log but the first holds
    a stale last row under the owner's head; the recovery, which reads
    the first one's body when the holders' heads agree, still restores
    the state. Only the join is killed, so that its holders, two sinks,
    both survive: the first is read, the stale one never."""
    inner = cluster.ClusterRunner.inject_failure

    def inject(self, flats, *a, **k):
        reps = self.executor.carry.replicas
        rows = reps.rows.clone()
        for f in flats:
            for x in [x for x in self.plan.replicas_of(f)
                      if self.plan.pairs[x][1] not in flats][1:]:
                rows[x, (int(reps.head[x]) - 1) % rows.shape[1]] += 1
        self.executor.carry = self.executor.carry._replace(
            replicas=reps._replace(rows=rows))
        return inner(self, flats, *a, **k)
    monkeypatch.setattr(cluster.ClusterRunner, "inject_failure", inject)
    return {"kills": [["join"]]}


def _one_holder(monkeypatch):
    """Every owner's log kept by one holder a downstream vertex; kills
    of a join with its only holder, a sink, are left out."""
    inner = rep.ReplicationPlan.from_job.__func__

    def from_job(cls, job, sharing_depth=-1, replication_factor=-1):
        return inner(cls, job, sharing_depth, replication_factor - 1)
    monkeypatch.setattr(rep.ReplicationPlan, "from_job",
                        classmethod(from_job))
    return {"kills": [["join"], ["source-r", "join"]]}


@pytest.mark.parametrize("plant,reads,clean", [
    (_three_slots, ("join_state", "sink", "recovered"), ()),
    (_calls_again, ("services",), ()),
    (_stale_second_holder, ("replicas",),
     ("draws", "routing", "join_state", "sink", "recovered", "services")),
    (_one_holder, ("replicas",),
     ("draws", "routing", "join_state", "sink", "recovered", "services"))],
    ids=["join-keeps-3-of-4", "calls-again", "stale-second-holder",
         "one-holder"])
def test_planted_fault_fails_the_comparison(plant, reads, clean,
                                            monkeypatch):
    """``clean``: what the fault leaves sound, so that only the compared
    ``reads`` catch it."""
    out = _run(**(plant(monkeypatch) or {}))
    assert not out["line"]["correct"]
    for k in reads:
        assert out["compared"][k] > 0, (k, out["compared"])
    for k in clean:
        assert out["compared"][k] == 0, (k, out["compared"])


@pytest.mark.parametrize("fault", ["half_batch", "drop_overflow",
                                   "rollback"])
def test_control_fails_the_comparison(fault):
    r = controls.read(CELL, SEED, 0.5, fault, "cpu", TINY)
    assert not r["correct"], r["compared"]
    assert any(v > 0 for v in r["compared"].values())
    if fault == "rollback":
        assert r["compared"]["recovered"] > 0


def test_traced_run_reads_the_span_counters():
    line = _run(trace=True)["line"]
    assert line["correct"]
    got = line["metrics"]
    # The card's idle share is read from device operations: none here.
    assert set(got) == set(METRICS + PHASES)
    assert all(got[m]["value"] > 0 for m in PHASES)
    assert got["join_replay_mrows_per_s.recover"]["value"] > 0
    assert 0 < got["join_fetch_host_share.recover"]["value"] <= 100
    assert isinstance(obs.get_tracer(), obs.NullTracer)


def test_program_without_counters_reads_none(monkeypatch):
    """The parent program's recovery spans carry no counters: the new
    metrics are left out and the run completes."""
    monkeypatch.setattr(cluster._RecoverySpans, "count",
                        lambda self, counts: None)
    line = _run(trace=True)["line"]
    assert line["correct"]
    assert not set(METRICS) & set(line["metrics"])
    assert set(PHASES) <= set(line["metrics"])


def test_untraced_run_installs_no_program_tracer(monkeypatch):
    seen = []
    inner = cluster.ClusterRunner.recover

    def recorded(self, *a, **k):
        seen.append(obs.get_tracer())
        return inner(self, *a, **k)
    monkeypatch.setattr(cluster.ClusterRunner, "recover", recorded)
    blocks = []
    inner_block = LocalExecutor._run_block

    def block(self, k):
        blocks.append(obs.get_tracer())
        return inner_block(self, k)
    monkeypatch.setattr(LocalExecutor, "_run_block", block)
    assert _run()["line"]["correct"]
    assert seen and blocks
    assert all(isinstance(t, obs.NullTracer) for t in seen + blocks)


PROBE = """
import json, sys
from portbench import harness
from portbench.tests.test_portbench_join import CELL, TINY
out = harness.run_cell(CELL, 5, 0.3, True, "cpu", overrides=TINY)
print(json.dumps({"bad": harness.forbidden_modules(),
                  "correct": out["line"]["correct"]}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, cwd=harness.CHECKOUT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True}
