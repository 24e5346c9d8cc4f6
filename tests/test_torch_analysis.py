"""PyTorch port, the whole-program analysis (``clonos_tpu_torch/analysis/``):
call graph, nondet reachability, lock-order cycles, census + cost model,
the no-FT ablation twin, the ``analyze`` verb (mirror of the reference's
``tests/test_analysis.py``).

Parity with the reference, in one process and on the same inputs: the
census sync lanes, ``dets_per_step`` and encoding are equal across the
two packages' own sources, ``static_cost_model`` gives equal numbers for
equal shapes, and the ablation transform strips nine sites in each
executor with the same callees once the package prefix is set aside.
The port's own sources analyze clean with every exemption an inline
waiver, its census and thread fingerprints equal the port's pins
(``clonos_tpu_torch/.clonos-census``, ``.clonos-threads``), and the twin
on the CPU is bit-identical to the port's executor while its logs stay
empty. Tolerance: exact.

NOTE: bait code lives only in strings written to ``tmp_path`` (the
configure-time gate in ``tests/conftest.py`` lints ``tests/`` with the
reference's lint).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from clonos_tpu import analysis as janalysis
from clonos_tpu.analysis import ablate as jablate
from clonos_tpu_torch.analysis import (ANALYSIS_RULES, AblationRefused,
                                       CallGraph, LOCK_ORDER, NONDET_REACH,
                                       ablated_executor, build_census,
                                       census_fingerprint, check_ablatable,
                                       fingerprint, format_json,
                                       format_text, run_analysis,
                                       static_cost_model)
from clonos_tpu_torch.analysis.ablate import transform_source
from clonos_tpu_torch.analysis.census import (CENSUS_PIN, THREADS_PIN,
                                              read_pin)
from clonos_tpu_torch.lint import FileContext

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's pinned census (the repository root's .clonos-census)
REFERENCE_CENSUS_PIN = "9fff29f189c04820"


def _ctx(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return FileContext(name, textwrap.dedent(src))


def _analyze_src(tmp_path, monkeypatch, files, use_waivers=True):
    monkeypatch.chdir(tmp_path)
    for name, src in files.items():
        (tmp_path / name).write_text(textwrap.dedent(src))
    return run_analysis(sorted(files), use_waivers=use_waivers)


def _hits(result, rule):
    return [f for f in result.findings if f.rule == rule]


@pytest.fixture(scope="module")
def port_analysis():
    """One analysis of the port's sources from the repo root, with
    waivers and without."""
    cwd = os.getcwd()
    os.chdir(_REPO)
    try:
        return run_analysis(), run_analysis(use_waivers=False)
    finally:
        os.chdir(cwd)


@pytest.fixture
def memo_analysis(monkeypatch, port_analysis):
    """The CLI's ``run_analysis`` answered from the module's runs when
    its arguments are the defaults (the same call, made once)."""
    from clonos_tpu_torch import analysis as pkg
    real = pkg.run_analysis

    def run(paths=("clonos_tpu_torch",), waiver_file=None,
            use_waivers=True):
        if list(paths) == ["clonos_tpu_torch"] and waiver_file is None:
            return port_analysis[0 if use_waivers else 1]
        return real(paths, waiver_file=waiver_file,
                    use_waivers=use_waivers)

    monkeypatch.setattr(pkg, "run_analysis", run)
    monkeypatch.chdir(_REPO)


# --- call graph ----------------------------------------------------------

def test_callgraph_resolves_methods_and_attr_chains(tmp_path):
    ctx = _ctx(tmp_path, "m.py", """\
        class Helper:
            def leaf(self):
                return 1

        class Op:
            def __init__(self):
                self.h = Helper()

            def process_block(self, state, ins):
                return self._step(state)

            def _step(self, state):
                return self.h.leaf()
        """)
    g = CallGraph([ctx])
    assert [e.qname for e in g.step_entries()] == ["m.Op.process_block"]
    assert g.chain("m.Op.process_block", {"m.Helper.leaf"}) == [
        "m.Op.process_block", "m.Op._step", "m.Helper.leaf"]


def test_callgraph_resolves_import_aliases(tmp_path):
    a = _ctx(tmp_path, "util.py", """\
        def helper():
            return 2
        """)
    b = _ctx(tmp_path, "op.py", """\
        import util as u

        class Op:
            def process_block(self, state, ins):
                return u.helper()
        """)
    g = CallGraph([a, b])
    assert g.chain("op.Op.process_block", {"util.helper"}) == [
        "op.Op.process_block", "util.helper"]


def test_callgraph_enclosing_and_nested_defs(tmp_path):
    ctx = _ctx(tmp_path, "n.py", """\
        def outer():
            x = 1
            def inner():
                return 2
            return inner

        class C:
            def method(self):
                return 3
        """)
    g = CallGraph([ctx])
    fi = g.enclosing("n.py", 4)
    assert fi is not None and fi.name == "outer"
    fi2 = g.enclosing("n.py", 9)
    assert fi2 is not None and fi2.qname == "n.C.method"


# --- nondet-reach --------------------------------------------------------

def test_nondet_reach_through_helper_chain(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        import time

        class Op:
            def process_block(self, state, ins):
                return self._helper(state)

            def _helper(self, state):
                return deep_helper(state)

        def deep_helper(state):
            return state + time.time()
        """}, use_waivers=False)
    (f,) = _hits(res, NONDET_REACH)
    assert f.line == 11
    assert "process_block" in f.message
    assert "_helper" in f.message and "deep_helper" in f.message
    assert res.exit_code() == 1


def test_nondet_reach_torch_global_draw(tmp_path, monkeypatch):
    # torch's process-global generator escapes the log the same way.
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        import torch

        class Op:
            def process_block(self, state, ins):
                return state + noise(state)

        def noise(state):
            return torch.rand(state.shape)
        """}, use_waivers=False)
    (f,) = _hits(res, NONDET_REACH)
    assert f.line == 8 and "[rng]" in f.message


def test_nondet_reach_waived_source_is_quiet(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        import time

        class Op:
            def process_block(self, state, ins):
                # clonos: allow(wallclock): test fixture, never replayed
                return state + time.time()
        """})
    assert _hits(res, NONDET_REACH) == []
    assert res.ok


def test_nondet_unreachable_helper_not_escalated(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        import time

        def orphan_helper():
            return time.time()

        class Op:
            def process_block(self, state, ins):
                return state
        """}, use_waivers=False)
    assert _hits(res, NONDET_REACH) == []


# --- lock-order ----------------------------------------------------------

LOCK_CYCLE_SRC = """\
    import threading

    class Dispatcher:
        def __init__(self):
            self._admission_lock = threading.Lock()
            self.jm = JobMaster()

        def submit(self, job):
            with self._admission_lock:
                self.jm.seal(job)

    class JobMaster:
        def __init__(self):
            self._lock = threading.Lock()

        def seal(self, job):
            with self._lock:
                return job

        def heartbeat(self, d: "Dispatcher"):
            with self._lock:
                with d._admission_lock:
                    return 1
    """


def test_lock_order_cycle_detected(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch,
                       {"locks.py": LOCK_CYCLE_SRC}, use_waivers=False)
    (cyc,) = _hits(res, LOCK_ORDER)
    msg = cyc.message
    assert "Dispatcher._admission_lock" in msg
    assert "JobMaster._lock" in msg
    assert "submit" in msg and "heartbeat" in msg
    assert res.exit_code() == 1


def test_lock_order_consistent_order_is_quiet(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"locks.py": """\
        import threading

        class Dispatcher:
            def __init__(self):
                self._admission_lock = threading.Lock()
                self.jm = JobMaster()

            def submit(self, job):
                with self._admission_lock:
                    self.jm.seal(job)

            def cancel(self, job):
                with self._admission_lock:
                    with self.jm._lock:
                        return job

        class JobMaster:
            def __init__(self):
                self._lock = threading.Lock()

            def seal(self, job):
                with self._lock:
                    return job
        """}, use_waivers=False)
    assert _hits(res, LOCK_ORDER) == []


def test_lock_order_reentrant_not_flagged(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"locks.py": """\
        import threading

        class Log:
            def __init__(self):
                self._lock = threading.RLock()

            def append(self, row):
                with self._lock:
                    self._extend(row)

            def _extend(self, row):
                with self._lock:
                    return row
        """}, use_waivers=False)
    assert _hits(res, LOCK_ORDER) == []


def test_lock_balance_bare_acquire_without_release_warns(
        tmp_path, monkeypatch):
    from clonos_tpu_torch.analysis import LOCK_BALANCE
    from clonos_tpu_torch.lint.core import WARNING

    res = _analyze_src(tmp_path, monkeypatch, {"locks.py": """\
        import threading

        class Ledger:
            def __init__(self):
                self._lock = threading.Lock()

            def seal(self, row):
                self._lock.acquire()
                return row
        """}, use_waivers=False)
    (w,) = _hits(res, LOCK_BALANCE)
    assert w.severity == WARNING
    assert "release()" in w.message and "with" in w.message
    assert res.exit_code() == 0


def test_lock_balance_matched_pair_is_quiet(tmp_path, monkeypatch):
    from clonos_tpu_torch.analysis import LOCK_BALANCE

    res = _analyze_src(tmp_path, monkeypatch, {"locks.py": """\
        import threading

        class Ledger:
            def __init__(self):
                self._lock = threading.Lock()

            def seal(self, row):
                self._lock.acquire()
                try:
                    return row
                finally:
                    self._lock.release()
        """}, use_waivers=False)
    assert _hits(res, LOCK_BALANCE) == []


def test_lock_order_sees_bare_acquire_release_pairs(
        tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"locks.py": """\
        import threading

        class Dispatcher:
            def __init__(self):
                self._admission_lock = threading.Lock()
                self.jm = JobMaster()

            def submit(self, job):
                self._admission_lock.acquire()
                try:
                    self.jm.seal(job)
                finally:
                    self._admission_lock.release()

        class JobMaster:
            def __init__(self):
                self._lock = threading.Lock()

            def seal(self, job):
                with self._lock:
                    return job

            def heartbeat(self, d):
                with self._lock:
                    with d._admission_lock:
                        return 1
        """}, use_waivers=False)
    (cyc,) = _hits(res, LOCK_ORDER)
    assert "Dispatcher._admission_lock" in cyc.message
    assert "JobMaster._lock" in cyc.message


def test_lock_order_findings_equal_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "locks.py").write_text(textwrap.dedent(LOCK_CYCLE_SRC))
    port = run_analysis(["locks.py"], use_waivers=False)
    ref = janalysis.run_analysis(["locks.py"], use_waivers=False)
    assert [(f.rule, f.line, f.severity, f.message)
            for f in port.findings] == [
        (f.rule, f.line, f.severity, f.message) for f in ref.findings]


# --- census + cost model -------------------------------------------------

def test_port_census_sync_lanes_and_fingerprint_stable(port_analysis):
    fp1 = census_fingerprint()
    fp2 = census_fingerprint()
    assert fp1 == fp2 and len(fp1) == 16
    res, _raw = port_analysis
    assert res.census_fingerprint == fp1
    assert res.census["sync_lanes"] == [
        "TIMESTAMP", "RNG", "ORDER", "BUFFER_BUILT"]
    assert res.census["dets_per_step"] == 4
    assert res.census["encoding"]["row_bytes"] == 32
    assert len(res.census["step_functions"]) > 0
    assert all(s["path"].startswith("clonos_tpu_torch/")
               for s in res.census["service_call_sites"])
    assert {s["callee"] for s in res.census["service_call_sites"]} == {
        "append_async_determinant", "append_scale_determinant"}


def test_census_fingerprint_is_cwd_independent(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert census_fingerprint() == read_pin(CENSUS_PIN)


def test_census_fingerprint_tracks_source_changes(tmp_path):
    c1 = build_census([_ctx(tmp_path, "a.py", """\
        class Op:
            def process_block(self, state, ins, ctx):
                return state + ctx.times
        """)])
    c2 = build_census([_ctx(tmp_path, "b.py", """\
        class Op:
            def process_block(self, state, ins, ctx):
                return state + ctx.times + ctx.rng_bits
        """)])
    assert fingerprint(c1) != fingerprint(c2)


def test_static_cost_model_scales_linearly(port_analysis):
    census = port_analysis[0].census
    m1 = static_cost_model(census, steps_per_epoch=100, subtasks=8,
                           records_per_step=64)
    m2 = static_cost_model(census, steps_per_epoch=200, subtasks=8,
                           records_per_step=64)
    assert m1["calls_per_step"] == census["dets_per_step"] * 8
    assert m2["determinant_bytes_per_epoch"] == \
        2 * m1["determinant_bytes_per_epoch"]
    assert 0.0 < m1["ft_fraction_static"] < 1.0
    assert m1["ring_bytes_per_epoch"] == 0
    assert m1["replica_bytes_per_epoch"] == 0


def test_static_cost_model_spill_lanes(port_analysis):
    census = port_analysis[0].census
    base = static_cost_model(census, steps_per_epoch=100, subtasks=8,
                             records_per_step=64, ring_vertices=2)
    on = static_cost_model(census, steps_per_epoch=100, subtasks=8,
                           records_per_step=64, ring_vertices=2,
                           spill=True)
    assert base["spill_d2h_bytes_per_epoch"] == 0
    assert base["spill_disk_bytes_per_epoch"] == 0
    assert on["spill_d2h_bytes_per_epoch"] > 0
    assert on["spill_disk_bytes_per_epoch"] == \
        on["spill_d2h_bytes_per_epoch"]
    assert on["ft_fraction_static"] > base["ft_fraction_static"]


def test_census_and_cost_model_equal_reference(port_analysis, monkeypatch):
    """(iv) The two packages' censuses over their own sources agree on
    the sync lanes, ``dets_per_step`` and the encoding, and the cost
    model gives equal numbers for equal shapes."""
    monkeypatch.chdir(_REPO)
    port = port_analysis[0].census
    ref = janalysis.build_census(
        janalysis.census._repo_contexts(("clonos_tpu",)))
    for key in ("sync_lanes", "dets_per_step", "encoding", "schema"):
        assert port[key] == ref[key], key
    shapes = [dict(steps_per_epoch=512, subtasks=32, records_per_step=1024,
                   ring_vertices=3, record_touches=4),
              dict(steps_per_epoch=100, subtasks=8, records_per_step=64,
                   replica_logs=8, ring_vertices=2, spill=True),
              dict(steps_per_epoch=16, subtasks=2, records_per_step=8)]
    for shape in shapes:
        assert static_cost_model(port, **shape) == \
            janalysis.static_cost_model(ref, **shape)


# --- the port itself -----------------------------------------------------

def test_port_analyzes_clean(port_analysis):
    res, _raw = port_analysis
    assert res.errors == [], format_text(res)
    assert res.exit_code() == 0
    assert not res.warnings
    assert any(f.startswith("clonos_tpu_torch/ops/") for f in res.files)


def test_no_waivers_shows_the_thirteen_findings(port_analysis):
    """Without waivers the analysis reports what this slice answered:
    seven join-discipline findings on the epoch tracker's and the
    checkpoint coordinator's listener lists and seven nondet-reach chains
    from step functions to the nvcc temp name's ``os.getpid`` (six
    through the keyed histogram, one through the join's keyed rank)."""
    _res, raw = port_analysis
    got = sorted((f.rule, f.path) for f in raw.errors)
    assert got == sorted(
        [("join-discipline", "clonos_tpu_torch/causal/epoch.py")] * 3
        + [("join-discipline", "clonos_tpu_torch/runtime/checkpoint.py")]
        * 4 + [("nondet-reach", "clonos_tpu_torch/ops/cuda_build.py")] * 7)
    reach = [f for f in raw.errors if f.rule == NONDET_REACH]
    assert any("KeyedReduceOperator.process" in f.message
               and "keyed_hist_cuda" in f.message for f in reach)
    assert any("IntervalJoinOperator.process_block" in f.message
               and "keyed_rank_cuda" in f.message for f in reach)


def test_port_fingerprints_equal_the_port_pins(port_analysis):
    res, _raw = port_analysis
    assert res.census_fingerprint == read_pin(CENSUS_PIN)
    assert res.threads_fingerprint == read_pin(THREADS_PIN)
    assert read_pin(CENSUS_PIN) != REFERENCE_CENSUS_PIN
    assert os.path.dirname(CENSUS_PIN) == os.path.join(
        _REPO, "clonos_tpu_torch")


def test_format_json_one_line_contract(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        import time

        class Op:
            def process_block(self, state, ins):
                return time.time()
        """}, use_waivers=False)
    line = format_json(res)
    assert "\n" not in line
    doc = json.loads(line)
    assert doc["ok"] is False and doc["errors"] >= 1
    assert doc["census_fingerprint"] == res.census_fingerprint
    assert "census" in doc
    slim = json.loads(format_json(res, with_census=False))
    assert "census" not in slim


def test_stale_analysis_waiver_warns_not_fails(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        # clonos: allow(nondet-reach): nothing here any more
        X = 1
        """})
    assert res.ok
    assert any(f.rule == "stale-waiver" for f in res.warnings)


def test_analysis_rules_registered_for_waiver_validation():
    from clonos_tpu_torch.lint import rule_names
    assert ANALYSIS_RULES <= set(rule_names())


# --- ablation ------------------------------------------------------------

def test_transform_strips_ft_lanes():
    src = textwrap.dedent("""\
        from clonos_tpu_torch.causal import log as clog
        from clonos_tpu_torch.inflight import log as ifl

        def run(logs, ring, rows, out):
            logs = clog.v_append_full(logs, rows)
            ring = ifl.append_block(ring, out)
            return logs, ring
        """)
    tree, report = transform_source("twin.py", src)
    assert {c for _l, c in report.stripped} == {
        "clonos_tpu_torch.causal.log.v_append_full",
        "clonos_tpu_torch.inflight.log.append_block"}
    code = ast.unparse(tree)
    assert "v_append_full" not in code
    assert "logs = logs" in code


def test_ablation_report_equals_reference_apart_from_prefix():
    """(v) Nine stripped sites in each executor, the same callees once
    the package prefix is set aside."""
    import clonos_tpu.runtime.executor as jex
    import clonos_tpu_torch.runtime.executor as tex

    def report(mod, transform):
        with open(mod.__file__) as f:
            return transform(mod.__file__, f.read())[1]

    port = report(tex, transform_source)
    ref = report(jex, jablate.transform_source)
    assert len(port.stripped) == len(ref.stripped) == 9
    strip = lambda r, pre: sorted(c[len(pre):] for _l, c in r.stripped)
    assert strip(port, "clonos_tpu_torch.") == strip(ref, "clonos_tpu.")
    assert port.to_dict()["stripped_sites"] == 9


def _unlogged_salt_bait(tmp_path):
    path = tmp_path / "salt_bait.py"
    path.write_text(textwrap.dedent("""\
        import os
        import torch

        SALT = int.from_bytes(os.urandom(3), "little")

        class SaltMap:
            def process_block(self, state, ins, ctx):
                vals = (ins.values * 31 + SALT) % 9973
                return state, torch.where(ins.valid, vals, 0)
        """))
    return path


def test_ablation_refused_on_load_bearing_nondet(tmp_path, monkeypatch):
    path = _unlogged_salt_bait(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(AblationRefused) as ei:
        check_ablatable([path.name])
    assert [(f.rule, f.line) for f in ei.value.findings] == [("entropy", 4)]
    assert "stripping FT would change results" in str(ei.value)


def test_ablation_accepts_the_ports_executor_and_operators(monkeypatch):
    monkeypatch.chdir(_REPO)
    check_ablatable(["clonos_tpu_torch/runtime/executor.py",
                     "clonos_tpu_torch/api/operators.py"])


def test_ablated_twin_bit_identical_outputs():
    """The golden equivalence run on the CPU: parallelism 2, 32 steps,
    logical time — the twin's sinks, states, edge buffers and counts
    are bit-identical to the port's executor's; only the logs and the
    rings differ (the twin's stay empty)."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime import executor as real_ex
    from clonos_tpu_torch.utils.tree import tree_leaves

    twin_mod, report = ablated_executor()
    assert len(report.stripped) == 9, report.to_dict()

    def build():
        env = StreamEnvironment(name="ablate-golden", num_key_groups=16)
        (env.synthetic_source(vocab=13, batch_size=8, parallelism=2)
            .key_by()
            .window_count(num_keys=13, window_size=1 << 30)
            .key_by()
            .reduce(num_keys=13)
            .sink())
        return env.build()

    def drive(ex_mod):
        ex = ex_mod.LocalExecutor(build(), steps_per_epoch=16,
                                  log_capacity=1 << 10, max_epochs=8,
                                  inflight_ring_steps=32, block_steps=8,
                                  seed=3, logical_time=True, device="cpu")
        outs = None
        for _ in range(2):
            outs = ex.run_epoch()
        leaves = tree_leaves((ex.carry.op_states, ex.carry.edge_bufs,
                              ex.carry.record_counts, outs.sinks))
        rings = [int(r.head.max()) for r in ex.carry.out_rings]
        return leaves, int(ex.carry.logs.head.max()), rings

    real_leaves, real_head, real_rings = drive(real_ex)
    twin_leaves, twin_head, twin_rings = drive(twin_mod)
    assert len(real_leaves) == len(twin_leaves) > 0
    for a, b in zip(real_leaves, twin_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert real_head > 0 and twin_head == 0
    assert min(real_rings) > 0 and twin_rings == [0] * len(real_rings)


# --- CLI -----------------------------------------------------------------

def test_cli_analyze_json_and_exit_codes(memo_analysis, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--report", "json", "--no-census"])
    doc = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and doc["ok"] is True
    assert len(doc["census_fingerprint"]) == 16
    assert "census" not in doc and "threads" not in doc


def test_cli_analyze_census_dump(memo_analysis, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--census"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["sync_lanes"] == ["TIMESTAMP", "RNG", "ORDER",
                                 "BUFFER_BUILT"]


def test_cli_analyze_expect_census_pin_and_drift(memo_analysis, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--expect-census",
                   "clonos_tpu_torch/.clonos-census"])
    capsys.readouterr()
    assert rc == 0
    # the repository root's pin is the reference's census: drift
    rc = cli.main(["analyze", "--expect-census", ".clonos-census"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "census drift" in err and REFERENCE_CENSUS_PIN in err
    rc = cli.main(["analyze", "--no-waivers", "--report", "json",
                   "--no-census"])
    doc = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and doc["errors"] == 14


def test_cli_analyze_verb_on_the_tree_exits_zero_with_pins():
    """``python -m clonos_tpu_torch analyze --report json`` from the
    repo root with both pin gates: exit 0, one JSON line that parses,
    and fingerprints equal to the port's pins."""
    proc = subprocess.run(
        [sys.executable, "-m", "clonos_tpu_torch", "analyze", "--report",
         "json", "--no-census", "--expect-census",
         "clonos_tpu_torch/.clonos-census", "--expect-threads",
         "clonos_tpu_torch/.clonos-threads"],
        cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (line,) = proc.stdout.strip().splitlines()
    doc = json.loads(line)
    assert doc["ok"] is True and doc["errors"] == 0
    assert doc["census_fingerprint"] == read_pin(CENSUS_PIN)
    assert doc["threads_fingerprint"] == read_pin(THREADS_PIN)
