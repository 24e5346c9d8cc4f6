"""PyTorch port, the whole-program race detector
(``clonos_tpu_torch/analysis/threads.py`` + ``races.py``): thread-root
inventory, lockset ∩ happens-before checking, join discipline (mirror of
the reference's ``tests/test_races.py``).

Parity: each ``SEEDED_BUGS`` entry yields the same counterexample —
rule, path, line, message — from both packages' race passes, and
``analyze --seed-bug <name>`` exits 1 in both CLIs; the two thread-root
inventories, each over its own package, list the same roots with the
same kinds, daemon flags, joins and stored identities once the package
prefix is set aside. The port is race-clean with every race finding an
inline waiver, and its thread census equals
``clonos_tpu_torch/.clonos-threads``. Tolerance: exact.
"""

import json
import os
import re
import textwrap

import pytest

from clonos_tpu import analysis as janalysis
from clonos_tpu import cli as jcli
from clonos_tpu_torch.analysis import (CallGraph, JOIN_DISCIPLINE,
                                       LockOrderGraph, SEEDED_BUGS,
                                       THREAD_RACE, ThreadInventory,
                                       run_analysis, run_races,
                                       seeded_findings, threads_fingerprint)
from clonos_tpu_torch.analysis.census import THREADS_PIN, read_pin
from clonos_tpu_torch.lint import FileContext

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RACE_RULES = {THREAD_RACE, JOIN_DISCIPLINE}


def _pipeline(src, name="mod.py"):
    ctx = FileContext(name, textwrap.dedent(src))
    graph = CallGraph([ctx])
    return (ctx, graph, LockOrderGraph([ctx], graph),
            ThreadInventory([ctx], graph))


def _race_findings(src, name="mod.py"):
    ctx, graph, lockgraph, inv = _pipeline(src, name)
    return run_races([ctx], graph, lockgraph, inv)


def _inventory(src, name="mod.py"):
    return _pipeline(src, name)[3]


@pytest.fixture(scope="module")
def port_analysis():
    cwd = os.getcwd()
    os.chdir(_REPO)
    try:
        return run_analysis()
    finally:
        os.chdir(cwd)


@pytest.fixture
def memo_analysis(monkeypatch, port_analysis):
    """The CLI's default ``run_analysis`` answered from the module's run
    (the same call, made once)."""
    from clonos_tpu_torch import analysis as pkg
    real = pkg.run_analysis

    def run(paths=("clonos_tpu_torch",), waiver_file=None,
            use_waivers=True):
        if list(paths) == ["clonos_tpu_torch"] and waiver_file is None \
                and use_waivers:
            return port_analysis
        return real(paths, waiver_file=waiver_file,
                    use_waivers=use_waivers)

    monkeypatch.setattr(pkg, "run_analysis", run)
    monkeypatch.chdir(_REPO)


# --- thread-root inventory ------------------------------------------------

_METHOD_ROOT_SRC = """\
    import threading

    class Pump:
        def __init__(self):
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True)
            self._thread.start()

        def _loop(self):
            pass

        def close(self):
            self._thread.join()
    """


def test_inventory_resolves_method_root():
    inv = _inventory(_METHOD_ROOT_SRC)
    (root,) = inv.roots
    assert root.kind == "method"
    assert root.entry == "mod.Pump._loop"
    assert root.daemon is True
    assert root.spawner == "mod.Pump.__init__"
    assert [s[2] for s in root.start_sites] == ["mod.Pump.__init__"]
    assert [s[2] for s in root.join_sites] == ["mod.Pump.close"]
    assert root.joined


def test_inventory_resolves_closure_root():
    inv = _inventory("""\
        import threading

        class Job:
            def run(self):
                done = []
                def _work():
                    done.append(1)
                t = threading.Thread(target=_work)
                t.start()
                t.join()
                return done
        """)
    (root,) = inv.roots
    assert root.kind == "closure"
    assert root.entry == "mod.Job.run.<_work>"
    assert root.joined


def test_fingerprint_ignores_line_shifts_not_renames():
    base = threads_fingerprint(_inventory(_METHOD_ROOT_SRC))
    shifted = threads_fingerprint(_inventory(
        "    # a comment that moves every line down\n"
        + _METHOD_ROOT_SRC))
    assert shifted == base
    renamed = threads_fingerprint(_inventory(
        _METHOD_ROOT_SRC.replace("_loop", "_pump_loop")))
    assert renamed != base


# --- seeded bugs: each rule provably bites --------------------------------

@pytest.mark.parametrize("name", sorted(SEEDED_BUGS))
def test_seeded_bug_yields_minimal_counterexample(name):
    spec = SEEDED_BUGS[name]
    (f,) = seeded_findings(name)
    assert f.rule == spec["rule"]
    assert f.severity == "error"
    assert f"`{spec['attr']}`" in f.message
    assert "thread roots" in f.message
    assert "chain[" in f.message


@pytest.mark.parametrize("name", sorted(SEEDED_BUGS))
def test_seeded_bug_counterexample_equals_reference(name):
    """(ii) The same module through both race passes: the same finding,
    word for word."""
    assert SEEDED_BUGS[name] == janalysis.SEEDED_BUGS[name]
    got = [(f.rule, f.path, f.line, f.severity, f.message)
           for f in seeded_findings(name)]
    want = [(f.rule, f.path, f.line, f.severity, f.message)
            for f in janalysis.seeded_findings(name)]
    assert got == want and len(got) == 1


def test_seeded_bug_corrected_twins_stay_quiet():
    twins = {"drop-a-join": "_joined_product",
             "unguarded-cross-thread-write": "_guarded",
             "queue-bypass": "_q"}
    assert set(twins) == set(SEEDED_BUGS)
    for name, twin in twins.items():
        for f in seeded_findings(name):
            assert twin not in f.message.split(";")[0]


def test_unknown_seed_name_rejected():
    with pytest.raises(ValueError, match="drop-a-join"):
        seeded_findings("no-such-bug")


# --- happens-before discharges --------------------------------------------

def test_shared_lock_discharges():
    assert _race_findings("""\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._totals = {}
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                with self._lock:
                    self._totals["beat"] = 1

            def bump(self):
                with self._lock:
                    self._totals["n"] = 1
        """) == []


def test_condition_guard_discharges():
    assert _race_findings("""\
        import threading

        class C:
            def __init__(self):
                self._cv = threading.Condition()
                self._items = []
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                with self._cv:
                    self._items.append(1)

            def take(self):
                with self._cv:
                    return self._items.pop()
        """) == []


def test_queue_handoff_discharges():
    assert _race_findings("""\
        import queue
        import threading

        class C:
            def __init__(self):
                self._q = queue.Queue()
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                self._q.put(1)

            def take(self):
                return self._q.get()
        """) == []


def test_prestart_publication_discharges():
    assert _race_findings("""\
        import threading

        class C:
            def __init__(self):
                self._cfg = {}
                self._cfg["mode"] = "fast"
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                return self._cfg["mode"]
        """) == []


def test_join_dominance_discharges():
    assert _race_findings("""\
        import threading

        class C:
            def __init__(self):
                self._out = []
                self._t = threading.Thread(target=self._work)

            def _work(self):
                self._out.append(1)

            def run(self):
                self._t.start()
                self._t.join()
                return list(self._out)
        """) == []


def test_plain_scalar_publish_discharges():
    assert _race_findings("""\
        import threading

        class C:
            def __init__(self):
                self.result = None
                self._t = threading.Thread(target=self._work)
                self._t.start()

            def _work(self):
                self.result = 42

            def peek(self):
                return self.result
        """) == []


def test_host_copy_wait_on_a_worker_is_not_a_race():
    """The port's fence worker only waits for a ``HostCopy`` the main
    thread started: the copy handle crosses through a queue, and the
    worker touches nothing else of the runner."""
    assert _race_findings("""\
        import queue
        import threading

        class Runner:
            def __init__(self):
                self._tails = queue.Queue()
                self._t = threading.Thread(target=self._worker,
                                           daemon=True)
                self._t.start()

            def _worker(self):
                handle = self._tails.get()
                return handle.wait()

            def fence(self, handle):
                self._tails.put(handle)
        """) == []


# --- waivers ---------------------------------------------------------------

def _analyze_src(tmp_path, monkeypatch, files, use_waivers=True):
    monkeypatch.chdir(tmp_path)
    for name, src in files.items():
        (tmp_path / name).write_text(textwrap.dedent(src))
    return run_analysis(sorted(files), use_waivers=use_waivers)


_RACY_SRC = """\
    import threading

    class C:
        def __init__(self):
            self._totals = {}
            self._t = threading.Thread(target=self._loop)
            self._t.start()

        def _loop(self):
            __WAIVER__self._totals["beat"] = 1

        def bump(self):
            self._totals["n"] = 1
    """


def test_inline_waiver_suppresses_and_persists(tmp_path, monkeypatch):
    waiver = ("# clonos: allow(thread-race): test fixture\n"
              "            ")
    res = _analyze_src(
        tmp_path, monkeypatch,
        {"mod.py": _RACY_SRC.replace("__WAIVER__", waiver)})
    races = [f for f in res.findings if f.rule in RACE_RULES]
    assert races and all(f.waived for f in races)
    assert res.ok

    res = _analyze_src(
        tmp_path, monkeypatch,
        {"mod.py": _RACY_SRC.replace("__WAIVER__", "")})
    races = [f for f in res.findings if f.rule in RACE_RULES]
    assert races and not any(f.waived for f in races)
    assert res.exit_code() == 1


def test_stale_race_waiver_warns(tmp_path, monkeypatch):
    res = _analyze_src(tmp_path, monkeypatch, {"mod.py": """\
        # clonos: allow(join-discipline): nothing to waive here
        X = 1
        """})
    assert any(f.rule == "stale-waiver"
               and "join-discipline" in f.message
               for f in res.warnings)


# --- the port itself -------------------------------------------------------

def test_port_is_race_clean(port_analysis):
    res = port_analysis
    assert res.errors == [], "\n".join(
        f"{f.location()}: [{f.rule}] {f.message}" for f in res.errors)
    races = [f for f in res.findings if f.rule in RACE_RULES]
    assert races, "race pass found nothing at all — lost its teeth?"
    assert all(f.waived for f in races)


def test_port_thread_census_matches_pin(port_analysis):
    assert port_analysis.threads_fingerprint == read_pin(THREADS_PIN), (
        "thread-root census drifted; review `python -m clonos_tpu_torch "
        "analyze --threads` and re-pin clonos_tpu_torch/.clonos-threads")
    assert port_analysis.threads["roots"], "empty thread inventory"


def test_thread_inventories_equal_reference_apart_from_prefix(
        port_analysis, monkeypatch):
    """(iii) The reference's inventory over ``clonos_tpu`` and the
    port's over ``clonos_tpu_torch`` list the same 20 roots — entry,
    kind, daemon flag, spawner, stored identities — once the package
    prefix (and line numbers, which the census leaves out) is set aside.
    Joins agree too, but for one root: the port's heartbeat client joins
    its thread on ``close()`` (runtime/remote.py), the reference's
    never does."""
    monkeypatch.chdir(_REPO)
    ctxs = janalysis.census._repo_contexts(("clonos_tpu",))
    ref = janalysis.ThreadInventory(ctxs, janalysis.CallGraph(ctxs))

    def census(roots, pre):
        def strip(name):
            # library roots are named path:line:callee
            name = re.sub(rf"^{pre}[./]", "", name or "")
            return re.sub(r":\d+:", ":", name)

        return {strip(r["root_id"]): {
            "kind": r["kind"], "daemon": r["daemon"],
            "spawner": strip(r["spawner"]),
            "path": strip(r["path"]), "joined": bool(r["join_sites"]),
            "idents": sorted(f"{k}:{n}" for k, n in r["idents"])}
            for r in roots}

    port = census(port_analysis.threads["roots"], "clonos_tpu_torch")
    want = census(ref.to_dict()["roots"], "clonos_tpu")
    assert len(port) == len(want) == 20
    assert sorted(port) == sorted(want)
    differ = sorted(k for k in port if port[k] != want[k])
    assert differ == ["runtime.remote.TaskExecutorClient._beat"]
    k = differ[0]
    assert (port[k]["joined"], want[k]["joined"]) == (True, False)
    assert {**port[k], "joined": False} == want[k]


# --- CLI -------------------------------------------------------------------

def test_cli_races_json_exits_zero_at_head(memo_analysis, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--races", "--report", "json",
                   "--no-census"])
    out = capsys.readouterr().out.strip()
    assert rc == 0
    rep = json.loads(out)
    assert rep["ok"] is True
    assert all(f["rule"] in RACE_RULES or "waiver" in f["rule"]
               for f in rep["findings"])
    assert rep["threads_fingerprint"] == read_pin(THREADS_PIN)


@pytest.mark.parametrize("name", sorted(SEEDED_BUGS))
def test_cli_seed_bug_exits_one_with_counterexample(name, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--seed-bug", name])
    out = capsys.readouterr().out
    assert rc == 1
    assert SEEDED_BUGS[name]["rule"] in out
    assert SEEDED_BUGS[name]["attr"] in out
    # the reference's verb exits 1 with the same lines
    assert jcli.main(["analyze", "--seed-bug", name]) == 1
    assert capsys.readouterr().out == out


def test_cli_seed_bug_unknown_exits_two(capsys):
    from clonos_tpu_torch import cli

    assert cli.main(["analyze", "--seed-bug", "no-such"]) == 2


def test_cli_expect_threads_gate(memo_analysis, capsys):
    from clonos_tpu_torch import cli

    rc = cli.main(["analyze", "--races", "--expect-threads",
                   "clonos_tpu_torch/.clonos-threads"])
    capsys.readouterr()
    assert rc == 0
    rc = cli.main(["analyze", "--races", "--expect-threads",
                   "0" * 16])
    err = capsys.readouterr().err
    assert rc == 1
    assert "thread-census drift" in err


# --- lease deadlines are wall-clock time -----------------------------------

def test_lease_deadlines_are_wall_clock_not_per_boot(tmp_path):
    """Lease deadlines in the shared claim file are wall-clock time by
    default (claim files are read by contenders on other hosts, where a
    per-boot monotonic value means nothing); an injected clock stands
    for each host's wall clock here."""
    import time
    from clonos_tpu_torch.runtime.leader import FileLeaderElection

    assert FileLeaderElection(str(tmp_path / "x"), "jm")._clock \
        is time.time
    t0 = 1_760_000_000.0
    lease = str(tmp_path / "lease")
    a = FileLeaderElection(lease, "jm-a", lease_ttl_s=30.0,
                           clock=lambda: t0)
    assert a.try_acquire()
    with open(f"{lease}.epoch1.claim") as f:
        rec = json.load(f)
    assert rec["deadline_wall"] == t0 + 30.0

    b = FileLeaderElection(lease, "jm-b", lease_ttl_s=30.0,
                           clock=lambda: t0 + 1.0)
    assert b.leader() == "jm-a"
    assert not b.try_acquire()
    b._clock = lambda: t0 + 3600.0   # an hour later, anywhere
    assert b.try_acquire() and b.epoch == 2
