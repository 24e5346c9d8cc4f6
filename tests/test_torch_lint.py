"""PyTorch port, the static determinism lint (``clonos_tpu_torch/lint/``):
rules, waivers, registry, CLI (mirror of the reference's
``tests/test_lint.py``, plus the window-rule cases of
``tests/test_pipelined_fence.py`` and ``tests/test_serve_replica.py``).

Parity: fixture sources in the standard-library idiom (wall clock, RNG,
entropy, set iteration, lock discipline, and the inline, file, stale and
unknown-rule waivers) get identical findings — rule, line, severity,
waived — from the reference's lint and the port's, run in one process on
the same files. Port idiom: ``.item()`` in a ``process_block`` body, a
``torch.cuda.synchronize()`` inside an overlap window (a ``HostCopy``
start there is allowed), and torch's global-RNG draws and unseeded
``torch.Generator`` are flagged. The port's own sources lint clean with
every exemption an inline waiver, and ``--no-waivers`` shows what those
waivers excuse. Tolerance: exact.

NOTE: ``tests/conftest.py`` lints this file with the reference's markers rule
(line-regex based), so unregistered-marker fixtures below are built by
string concatenation, bait code lives only in strings written to
``tmp_path``, and no real comment here names a waiver.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from clonos_tpu import lint as jlint
from clonos_tpu_torch.lint import (WARNING, RULES, FileContext,
                                   rule_names, run_lint)
from clonos_tpu_torch.lint import markers as port_markers
from clonos_tpu_torch.lint.runner import (DEFAULT_WAIVER_FILE,
                                          collect_files, format_json)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the findings the port's waivers answer (file, rule), each at its line
#: once the waiver comments were inserted above it
WAIVED_BY_THIS_SLICE = {
    ("clonos_tpu_torch/obs/history.py", "wallclock"),
    ("clonos_tpu_torch/obs/trace.py", "wallclock"),
    ("clonos_tpu_torch/obs/trace.py", "entropy"),
    ("clonos_tpu_torch/runtime/checkpoint.py", "wallclock"),
    ("clonos_tpu_torch/runtime/leader.py", "wallclock"),
    ("clonos_tpu_torch/ops/cuda_build.py", "entropy"),
    ("clonos_tpu_torch/ops/native.py", "entropy"),
}


def _lint_src(tmp_path, monkeypatch, src, name="mod.py",
              waiver_text=None, use_waivers=True, rules=None):
    monkeypatch.chdir(tmp_path)
    (tmp_path / name).write_text(textwrap.dedent(src))
    waiver_file = None
    if waiver_text is not None:
        (tmp_path / ".clonos-waivers").write_text(
            textwrap.dedent(waiver_text))
        waiver_file = ".clonos-waivers"
    return run_lint([name], waiver_file=waiver_file,
                    use_waivers=use_waivers, rules=rules)


def _hits(result, rule):
    return [f for f in result.findings if f.rule == rule]


@pytest.fixture(scope="module")
def port_lint():
    """One lint of the port's sources from the repo root, with waivers
    and without, shared by the tests that read it."""
    cwd = os.getcwd()
    os.chdir(_REPO)
    try:
        return run_lint(), run_lint(use_waivers=False)
    finally:
        os.chdir(cwd)


# --- rule family 1: nondeterminism escapes -------------------------------


def test_wallclock_flags_aliased_import(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time as _t
        def now():
            return _t.time()
        """, use_waivers=False)
    (f,) = _hits(res, "wallclock")
    assert f.line == 3 and "causal time service" in f.message
    assert res.exit_code() == 1


def test_wallclock_reference_without_call_flagged(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        def mk(clock=time.time):
            return clock
        """, use_waivers=False)
    assert len(_hits(res, "wallclock")) == 1


def test_monotonic_not_flagged(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        def span():
            t0 = time.monotonic()
            return time.monotonic() - t0
        """, use_waivers=False)
    assert res.ok


def test_rng_global_draw_and_unseeded_ctor(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import random
        import numpy as np
        def a():
            return random.random()
        def b():
            return np.random.rand(3)
        def c():
            return np.random.RandomState()
        """, use_waivers=False)
    assert len(_hits(res, "rng")) == 3


def test_rng_seeded_ctor_is_deterministic(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import numpy as np
        def mk(seed):
            return np.random.RandomState(seed)
        """, use_waivers=False)
    assert res.ok


def test_entropy_urandom_and_uuid(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import os
        import uuid
        SALT = int.from_bytes(os.urandom(3), "little")
        TAG = uuid.uuid4().hex
        """, use_waivers=False)
    assert {f.line for f in _hits(res, "entropy")} == {3, 4}


def test_entropy_from_import_aliases_flagged(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        from os import urandom
        from uuid import uuid4 as mkid
        SALT = urandom(3)
        TAG = mkid().hex
        """, use_waivers=False)
    assert {f.line for f in _hits(res, "entropy")} == {3, 4}


def test_entropy_getpid_dotted_and_aliased(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import os
        from os import getpid as gp
        KEY = os.getpid() & 0xFF
        KEY2 = gp() & 0xFF
        """, use_waivers=False)
    hits = _hits(res, "entropy")
    assert {f.line for f in hits} == {3, 4}
    assert "restart" in hits[0].message


def test_entropy_unimported_getpid_name_not_flagged(tmp_path,
                                                    monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        def getpid():
            return 7
        KEY = getpid()
        """, use_waivers=False)
    assert _hits(res, "entropy") == []


def test_unordered_iter_set_flagged_sorted_ok(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        def bad(xs, out):
            for x in set(xs):
                out.append(x)
        def good(xs, out):
            for x in sorted(set(xs)):
                out.append(x)
        def comp(xs):
            return [x for x in {1, 2, 3}]
        """, use_waivers=False)
    assert {f.line for f in _hits(res, "unordered-iter")} == {2, 8}


# --- torch's RNG: explicit, seeded generators ----------------------------


def test_torch_global_rng_draws_flagged_generator_kwarg_ok(tmp_path,
                                                           monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import torch
        def draws(g):
            a = torch.rand(3)
            b = torch.randn(3, generator=g)
            c = torch.randint(0, 9, (3,))
            d = torch.randperm(5, generator=g)
            e = torch.normal(0.0, 1.0, (2,))
            f = torch.bernoulli(a)
            h = torch.multinomial(a, 1, generator=g)
            return a, b, c, d, e, f, h
        """, use_waivers=False)
    assert {f.line for f in _hits(res, "rng")} == {3, 5, 7, 8}
    assert all("generator=" in f.message for f in _hits(res, "rng"))


def test_torch_generator_seeded_ok_unseeded_flagged(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import torch
        def chained(seed, dev):
            return torch.Generator(dev).manual_seed(seed)
        def named(seed):
            g = torch.Generator()
            g.manual_seed(seed)
            return torch.rand(4, generator=g)
        class Holder:
            def __init__(self, seed):
                self.gen = torch.Generator()
                self.gen.manual_seed(seed)
        def unseeded():
            return torch.Generator()
        """, use_waivers=False)
    (f,) = _hits(res, "rng")
    assert f.line == 13 and "manual_seed" in f.message


# --- rule family 2: replay and sync safety of block bodies ---------------


def test_host_branch_on_traced_param(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        class Op:
            def process(self, state, batch):
                if batch > 0:
                    return state
                return state + 1
        """, use_waivers=False)
    (f,) = _hits(res, "host-branch")
    assert f.line == 3 and "batch" in f.message


def test_host_branch_static_metadata_exempt(tmp_path, monkeypatch):
    # shape/dtype/device/dim()/numel()/size() answer from tensor
    # metadata on the host; self-config branches are static too.
    res = _lint_src(tmp_path, monkeypatch, """\
        class Op:
            def process(self, state, batch):
                if batch.shape[0] == 8:
                    return state
                if batch.device.type == "cuda" and batch.dim() == 1:
                    return state
                if batch.numel() == 0 or batch.size(0) == 4:
                    return state
                if self.fancy:
                    return state
                return state
        """, use_waivers=False)
    assert res.ok


def test_host_branch_in_map_lambda(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        def build(env):
            return env.map(lambda k, v, t: v if v > 0 else -v)
        """, use_waivers=False)
    assert len(_hits(res, "host-branch")) == 1


def test_mutable_closure_capture(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        seen = []
        class Op:
            def process(self, state, batch):
                seen.append(batch)
                return state
        """, use_waivers=False)
    (f,) = _hits(res, "mutable-closure")
    assert "seen" in f.message


def test_mutable_local_ok(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        class Op:
            def process(self, state, batch):
                acc = []
                acc.append(batch)
                return state
        """, use_waivers=False)
    assert res.ok


def test_host_callback_and_item_sync(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        class Op:
            def process(self, state, batch):
                print(batch)
                x = batch.item()
                return state
        """, use_waivers=False)
    assert len(_hits(res, "host-callback")) == 2


def test_block_body_host_syncs_flagged(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import torch
        class Op:
            def process_block(self, state, ins, ctx):
                n = ins.valid.sum().item()
                keys = ins.keys.tolist()
                host = ins.values.cpu()
                arr = state.numpy()
                torch.cuda.synchronize()
                return state, (n, keys, host, arr)
        """, use_waivers=False)
    hits = _hits(res, "host-callback")
    assert sorted(f.line for f in hits) == [4, 5, 6, 7, 8]
    assert any("torch.cuda.synchronize" in f.message for f in hits)


def test_block_body_on_device_work_is_clean(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import torch
        class Op:
            def process_block(self, state, ins, ctx):
                keep = torch.where(ins.valid, ins.values, 0)
                return state + keep.sum(), ins
        """, use_waivers=False)
    assert res.ok


def test_plain_methods_not_traced(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        class Helper:
            def run(self, batch):
                if batch > 0:
                    print(batch)
                return batch.item()
        """, use_waivers=False)
    assert res.ok


# --- rule family 3: lock discipline --------------------------------------


def test_lock_discipline_unlocked_mutation(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []
            def put(self, x):
                with self._lock:
                    self._items.append(x)
            def race(self, x):
                self._items.append(x)
        """, use_waivers=False)
    (f,) = _hits(res, "lock-discipline")
    assert f.line == 10 and "_items" in f.message


def test_lock_discipline_helper_called_under_lock_ok(tmp_path,
                                                     monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []
            def put(self, x):
                with self._lock:
                    self._items.append(x)
                    self._fill(x)
            def _fill(self, x):
                self._items.append(x)
            def drain_locked(self):
                self._items.clear()
        """, use_waivers=False)
    assert res.ok


def test_lock_discipline_del_statement_is_a_mutation(tmp_path,
                                                     monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._jobs = {}
            def put(self, jid, rec):
                with self._lock:
                    self._jobs[jid] = rec
            def evict(self, jid):
                del self._jobs[jid]
        """, use_waivers=False)
    (f,) = _hits(res, "lock-discipline")
    assert f.line == 10 and "deletes from" in f.message
    assert "_jobs" in f.message


def test_lock_discipline_init_exempt_and_unlocked_class_quiet(
        tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        class NoLocks:
            def __init__(self):
                self._items = []
            def put(self, x):
                self._items.append(x)
        """, use_waivers=False)
    assert res.ok


# --- waivers --------------------------------------------------------------


def test_inline_waiver_same_line(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        STARTED = time.time()  # clonos: allow(wallclock) banner only
        """)
    assert res.ok and len(res.waived) == 1


def test_inline_waiver_comment_block_above(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        # clonos: allow(wallclock) — process start banner,
        # never replayed data.
        STARTED = time.time()
        """)
    assert res.ok and len(res.waived) == 1


def test_inline_waiver_in_string_is_documentation(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, '''\
        """Docs: write `# clonos: allow(wallclock)` to waive."""
        import time
        STARTED = time.time()
        ''')
    assert not res.ok and not res.waived


def test_waiver_file_rule_glob(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        STARTED = time.time()
        """, waiver_text="wallclock mod.py\n")
    assert res.ok and len(res.waived) == 1


def test_unknown_rule_inline_is_error(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        STARTED = time.time()  # clonos: allow(wallclok) typo
        """)
    errs = _hits(res, "waiver-unknown-rule")
    assert len(errs) == 1 and "wallclok" in errs[0].message
    assert res.exit_code() == 1


def test_unknown_rule_in_waiver_file_is_error(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, "X = 1\n",
                    waiver_text="wallclok mod.py\n")
    errs = _hits(res, "waiver-unknown-rule")
    assert len(errs) == 1 and res.exit_code() == 1


def test_stale_inline_waiver_warns_exit_zero(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        X = 1  # clonos: allow(wallclock) nothing here any more
        """)
    (w,) = _hits(res, "stale-waiver")
    assert w.severity == WARNING
    assert res.exit_code() == 0


def test_stale_waiver_file_entry_warns(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, "X = 1\n",
                    waiver_text="entropy other_*.py\n")
    (w,) = _hits(res, "stale-waiver")
    assert ".clonos-waivers" in w.path and res.exit_code() == 0


def test_exclude_skips_traversal_but_not_explicit_target(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "bait.py").write_text(
        "import os\nS = os.urandom(3)\n")
    (tmp_path / "pkg" / "clean.py").write_text("X = 1\n")
    (tmp_path / ".clonos-waivers").write_text("exclude pkg/bait.py\n")
    res = run_lint(["pkg"], waiver_file=".clonos-waivers")
    assert res.ok and res.files == ["pkg/clean.py"]
    res2 = run_lint(["pkg/bait.py"], waiver_file=".clonos-waivers")
    assert res2.exit_code() == 1
    assert not _hits(res2, "stale-waiver")


def test_no_waivers_flag_shows_raw_findings(tmp_path, monkeypatch):
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        STARTED = time.time()  # clonos: allow(wallclock) reason
        """, use_waivers=False)
    assert res.exit_code() == 1 and not res.waived


def test_unknown_rule_filter_raises(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="no-such-rule"):
        _lint_src(tmp_path, monkeypatch, "X = 1\n",
                  rules=["no-such-rule"])


def test_default_waiver_file_is_the_packages_not_the_cwd(tmp_path,
                                                         monkeypatch):
    # The repository root's .clonos-waivers belongs to the reference
    # (its `exclude examples/audit_nondet.py` would go stale here).
    assert DEFAULT_WAIVER_FILE == os.path.join(
        _REPO, "clonos_tpu_torch", ".clonos-waivers")
    (tmp_path / ".clonos-waivers").write_text("wallclock mod.py\n")
    res = _lint_src(tmp_path, monkeypatch, """\
        import time
        STARTED = time.time()
        """)
    assert not res.ok and not res.waived
    assert not _hits(res, "stale-waiver")


# --- registry -------------------------------------------------------------


def test_registry_contents_and_custom_rule():
    assert {"wallclock", "rng", "entropy", "unordered-iter",
            "host-branch", "mutable-closure", "host-callback",
            "lock-discipline", "markers", "overlap-window",
            "serve-window"} <= set(rule_names())
    assert set(jlint.rule_names()) == set(rule_names())

    from clonos_tpu_torch.lint import Rule, register_rule

    class NoTodo(Rule):
        name = "no-todo-test-rule"
        description = "test-only rule"

        def check(self, ctx):
            return [self.finding(ctx, i, "todo")
                    for i, line in enumerate(ctx.lines, 1)
                    if "TODO" in line]

    try:
        register_rule(NoTodo)
        assert "no-todo-test-rule" in RULES
        ctx = FileContext("x.py", "A = 1  # TODO later\n")
        assert len(RULES["no-todo-test-rule"].check(ctx)) == 1
        with pytest.raises(ValueError, match="duplicate"):
            register_rule(NoTodo)
    finally:
        RULES.pop("no-todo-test-rule", None)


# --- the port itself ------------------------------------------------------


def test_self_lint_port_clean(port_lint):
    """The port lints clean with every exemption an explicit inline
    waiver (the package's waiver file holds no entry: no directory is
    excluded from traversal)."""
    res, _raw = port_lint
    assert res.ok, "\n".join(
        f.location() + " " + f.message for f in res.errors)
    assert res.waived, "expected explicit waivers, found none"
    assert not res.warnings
    assert any(f.startswith("clonos_tpu_torch/ops/") for f in res.files)
    with open(DEFAULT_WAIVER_FILE) as f:
        entries = [ln for ln in f.read().splitlines()
                   if ln.split("#", 1)[0].strip()]
    assert entries == []


def test_no_waivers_shows_what_the_waivers_excuse(port_lint):
    """Without waivers the lint reports every finding this slice
    answered — six wall-clock reads and four entropy reads (an
    exemption hidden by an exclude would vanish from this list too)."""
    res, raw = port_lint
    assert {(f.path, f.rule) for f in raw.errors} >= WAIVED_BY_THIS_SLICE
    mine = [f.rule for f in raw.errors
            if (f.path, f.rule) in WAIVED_BY_THIS_SLICE]
    assert (mine.count("wallclock"), mine.count("entropy")) == (6, 4)
    # every raw finding sits on a line an inline waiver names
    assert sorted((f.path, f.line, f.rule) for f in raw.errors) \
        == sorted((f.path, f.line, f.rule) for f in res.waived)


def test_port_examples_lint_clean(monkeypatch):
    monkeypatch.chdir(_REPO)
    res = run_lint(["clonos_tpu_torch/examples"], use_waivers=False)
    assert res.ok and not res.findings
    assert len(res.files) >= 3


def _salted_bait(tmp_path):
    """An operator module whose record values take an unlogged
    ``os.urandom`` salt (the reference's audit bait, in the port's
    idiom), written to ``tmp_path``; returns (path, salt line)."""
    src = textwrap.dedent("""\
        import os
        import torch

        SALT = int.from_bytes(os.urandom(3), "little")

        class SaltMap:
            def process_block(self, state, ins, ctx):
                vals = (ins.values * 31 + SALT) % 9973
                return state, torch.where(ins.valid, vals, 0)
        """)
    path = tmp_path / "salt_bait.py"
    path.write_text(src)
    return path, 4


def test_bait_flagged_at_salt_line(tmp_path, monkeypatch):
    path, salt_line = _salted_bait(tmp_path)
    monkeypatch.chdir(tmp_path)
    res = run_lint([path.name])
    (f,) = res.errors
    assert (f.rule, f.path, f.line) == ("entropy", path.name, salt_line)
    payload = json.loads(format_json(res))
    assert payload["ok"] is False
    assert payload["findings"][0]["line"] == salt_line


def test_same_bug_static_and_runtime(tmp_path, monkeypatch):
    """The line the linter names is the line the audit blames: two
    processes draw two salts, and per-epoch ring digests of the salted
    values diverge exactly as ``recovery.audit.divergence`` reports
    it."""
    from clonos_tpu_torch.obs.digest import EpochDigest, diff_ledgers

    path, salt_line = _salted_bait(tmp_path)
    monkeypatch.chdir(tmp_path)
    (finding,) = run_lint([path.name]).errors
    assert (finding.rule, finding.line) == ("entropy", salt_line)

    def ledger(salt):
        d = EpochDigest(0)
        for v in range(16):
            salted = (v * 31 + salt) % 9973
            d.fold("ring/salt", salted.to_bytes(4, "little"))
        return [d.to_entry()]

    lines = diff_ledgers(ledger(0x1234), ledger(0x4321))
    assert lines and "ring/salt" in lines[0]
    assert "content divergence" in lines[0]


# --- markers rule ---------------------------------------------------------


def test_markers_rule_flags_unregistered(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tests_dir = tmp_path / "tests"
    tests_dir.mkdir()
    bad = "import pytest\n@pytest." + "mark.mystery\ndef test_x():\n    pass\n"
    (tests_dir / "test_bad.py").write_text(bad)
    res = run_lint(["tests"])
    (f,) = _hits(res, "markers")
    assert f.line == 2 and "mystery" in f.message
    assert {x.rule for x in res.findings} == {"markers"}


def test_markers_registry_and_scan(tmp_path):
    from clonos_tpu.lint.markers import REGISTERED_MARKERS as jmarkers
    assert port_markers.REGISTERED_MARKERS == jmarkers
    bad = "import pytest\n@pytest." + "mark.mystery\ndef test_x():\n    pass\n"
    (tmp_path / "test_bad.py").write_text(bad)
    (tmp_path / "test_ok.py").write_text(
        "import pytest\n@pytest." + "mark.slow\ndef test_y():\n    pass\n")
    assert port_markers.check(str(tmp_path)) == [
        "tests/test_bad.py:2: unregistered marker 'mystery'"]


# --- CLI ------------------------------------------------------------------


def test_cli_lint_json_and_exit_codes(tmp_path, monkeypatch, capsys):
    from clonos_tpu_torch.cli import main

    path, salt_line = _salted_bait(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "clean.py").write_text("X = 1\n")
    assert main(["lint", "clean.py"]) == 0
    capsys.readouterr()
    rc = main(["lint", path.name, "--report", "json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["ok"] is False and payload["errors"] == 1
    (f,) = payload["findings"]
    assert (f["rule"], f["path"], f["line"]) == (
        "entropy", path.name, salt_line)


def test_cli_list_rules_and_bad_rule_filter(monkeypatch, capsys):
    from clonos_tpu_torch.cli import main

    monkeypatch.chdir(_REPO)
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "wallclock" in out and "lock-discipline" in out
    assert main(["lint", "--rule", "bogus-rule", "clonos_tpu_torch"]) == 2


def test_cli_lint_verb_on_the_tree_exits_zero():
    """``python -m clonos_tpu_torch lint --report json`` from the repo
    root: exit 0 and one JSON line that parses."""
    proc = subprocess.run(
        [sys.executable, "-m", "clonos_tpu_torch", "lint", "--report",
         "json"], cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (line,) = proc.stdout.strip().splitlines()
    doc = json.loads(line)
    assert doc["ok"] is True and doc["errors"] == 0
    assert doc["warnings"] == 0 and doc["waived"] >= 18


def test_collect_files_dedup_and_skip_dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.py").write_text("X = 1\n")
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "junk.py").write_text("X = 1\n")
    files = collect_files(["a.py", "."])
    assert files == ["a.py"]


# --- overlap and serve windows -------------------------------------------


def test_overlap_window_lint_rule_flags_host_syncs():
    """A blocking host read between the overlap-window markers
    re-serializes the tail the pipeline hides; ``device.HostCopy(...)``
    (the non-blocking start) and ``copy_(..., non_blocking=True)`` stay
    allowed, and the port's production window is clean."""
    from clonos_tpu_torch.lint.overlapwindow import OverlapWindowSyncRule

    src = (
        "import numpy as np\n"
        "import torch\n"
        "from clonos_tpu_torch import device as _device\n"
        "def fence(x, h, pinned):\n"
        "    # clonos: overlap-window-begin\n"
        "    a = np.asarray(x)\n"
        "    snap = _device.HostCopy(x)\n"
        "    torch.cuda.synchronize()\n"
        "    pinned.copy_(x, non_blocking=True)\n"
        "    n = x.sum().item()\n"
        "    host = snap.wait()\n"
        "    t = torch.tensor([1], device=x.device)\n"
        "    u = torch.tensor([1])\n"
        "    c = x.cpu()\n"
        "    # clonos: overlap-window-end\n"
        "    return np.asarray(a)\n"
    )
    rule = OverlapWindowSyncRule()
    findings = rule.check(FileContext("fake.py", src))
    assert sorted(f.line for f in findings) == [6, 8, 10, 11, 12, 14], \
        [f.message for f in findings]

    assert rule.check(FileContext(
        "fake.py", "import numpy as np\nx = np.asarray(1)\n")) == []

    torn = rule.check(FileContext(
        "fake.py", "# clonos: overlap-window-begin\n"))
    assert any("unbalanced" in f.message for f in torn)

    cpath = os.path.join(_REPO, "clonos_tpu_torch", "runtime",
                         "cluster.py")
    with open(cpath) as f:
        csrc = f.read()
    assert "clonos: overlap-window-begin" in csrc
    assert "_device.HostCopy(" in csrc
    assert rule.check(FileContext(cpath, csrc)) == []


def test_serve_window_lint_rule():
    """The batched read path's window: a blocking host sync inside it
    is flagged, the port's production dispatch region is clean."""
    from clonos_tpu_torch.lint.overlapwindow import ServeWindowSyncRule

    rule = ServeWindowSyncRule()
    bad = (
        "import numpy as np\n"
        "def dispatch(fn, acc, keys):\n"
        "    # clonos: serve-window-begin\n"
        "    vals, subs, kgs = fn(acc, keys)\n"
        "    host = vals.tolist()\n"
        "    vals.synchronize()\n"
        "    # clonos: serve-window-end\n"
        "    return host\n"
    )
    found = rule.check(FileContext("fake.py", bad))
    assert sorted(f.line for f in found) == [5, 6]
    assert all(f.rule == "serve-window" for f in found)

    ok = bad.replace("    host = vals.tolist()\n", "") \
            .replace("    vals.synchronize()\n", "") \
            .replace("return host", "return vals.tolist()")
    assert rule.check(FileContext("fake.py", ok)) == []

    torn = bad.replace("    # clonos: serve-window-end\n", "")
    msgs = [f.message for f in rule.check(FileContext("fake.py", torn))]
    assert any("unbalanced" in m for m in msgs)

    import clonos_tpu_torch.runtime.serve as serve_mod
    with open(serve_mod.__file__) as f:
        src = f.read()
    assert "clonos: serve-window-begin" in src
    assert rule.check(FileContext(serve_mod.__file__, src)) == []


# --- parity with the reference's lint ------------------------------------

#: fixtures in the standard-library idiom: (source, waiver-file text)
PARITY_FIXTURES = {
    "wallclock": ("""\
        import time as _t
        import datetime
        from datetime import datetime as dt
        def now(clock=_t.time):
            return _t.time(), datetime.datetime.now(), dt.utcnow()
        def span():
            return _t.monotonic()
        """, None),
    "rng": ("""\
        import random
        import numpy as np
        def a():
            return random.random(), random.choice([1, 2])
        def b(seed):
            return np.random.rand(3), np.random.RandomState(seed)
        def c():
            return np.random.RandomState(), random.Random()
        """, None),
    "entropy": ("""\
        import os
        import uuid
        import secrets
        from os import getpid as gp
        SALT = int.from_bytes(os.urandom(3), "little")
        TAG = uuid.uuid4().hex + secrets.token_hex(4)
        KEY = os.getpid() ^ gp()
        """, None),
    "unordered-iter": ("""\
        def bad(xs, out):
            for x in set(xs):
                out.append(x)
            return {x: 1 for x in frozenset(xs)}
        def good(xs):
            return [x for x in sorted(set(xs))] + [y for y in {4, 5}]
        """, None),
    "lock-discipline": ("""\
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition()
                self._items = []
                self._jobs = {}
            def put(self, x, jid):
                with self._lock:
                    self._items.append(x)
                    self._fill(x)
                with self._cv:
                    self._jobs[jid] = x
            def _fill(self, x):
                self._items.append(x)
            def race(self, x, jid):
                self._items.append(x)
                del self._jobs[jid]
            def drain_locked(self):
                self._items.clear()
        """, None),
    "inline-waivers": ("""\
        import os
        import time
        STARTED = time.time()  # clonos: allow(wallclock) banner only
        # clonos: allow(entropy) — a temp name,
        # never replayed data.
        TMP = os.getpid()
        X = 1  # clonos: allow(rng) nothing here any more
        """, None),
    "waiver-file": ("""\
        import time
        STARTED = time.time()
        """, "wallclock mod.py\nentropy other_*.py\n"),
    "unknown-rule": ("""\
        import time
        STARTED = time.time()  # clonos: allow(wallclok) typo
        """, "wallclok mod.py\nmalformed line here\n"),
}


def _triples(result):
    return sorted((f.rule, f.path, f.line, f.severity, f.waived)
                  for f in result.findings)


@pytest.mark.parametrize("name", sorted(PARITY_FIXTURES))
def test_fixture_findings_equal_reference(tmp_path, monkeypatch, name):
    src, waiver_text = PARITY_FIXTURES[name]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mod.py").write_text(textwrap.dedent(src))
    if waiver_text is not None:
        (tmp_path / ".clonos-waivers").write_text(waiver_text)
    for use in (True, False):
        wf = ".clonos-waivers" if waiver_text is not None else None
        ref = jlint.run_lint(["mod.py"], waiver_file=wf, use_waivers=use)
        port = run_lint(["mod.py"], waiver_file=wf, use_waivers=use)
        assert _triples(port) == _triples(ref)
        assert port.exit_code() == ref.exit_code()
    assert _triples(ref), "fixture produced no finding at all"


def test_json_report_shape_equals_reference(tmp_path, monkeypatch):
    src, _ = PARITY_FIXTURES["entropy"]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mod.py").write_text(textwrap.dedent(src))
    ref = json.loads(jlint.format_json(jlint.run_lint(["mod.py"])))
    port = json.loads(format_json(run_lint(["mod.py"])))
    strip = lambda d: {**d, "findings": [
        {k: v for k, v in f.items() if k != "message"}
        for f in d["findings"]]}
    assert strip(port) == strip(ref)
    assert port["errors"] == 4
