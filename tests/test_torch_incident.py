"""PyTorch port, incident bundles and root-cause analysis (mirror of the
reference's ``tests/test_incident.py``).

Every test drives the reference (``clonos_tpu.obs.incident`` /
``rootcause``, ``clonos_tpu.utils.jsonl``, ``clonos_tpu.cli``) and the
port with the same inputs and an injected clock: the JSONL substrate's
files and reads, the streaming timeline merge, the manager's capture
discipline (atomic landing, dedup, rate limit, cap, restart) and the
bundles it lands, the analyzer's reports, and the CLI's outputs and exit
codes. A bundle's canonical JSON must equal the reference's except its
wall-clock ``ts`` fields, ``service`` name and ``census`` (each package
names its own pinned FT call-site census); ``analyze_bundle`` and
``render_report`` must give the same report and bytes on the same
bundle; the bundle schema fingerprint must equal the pinned
``.clonos-incident-schema``. Beside them, the planes' hooks in the
port's runtime: ``recovery.failure`` from ``recover()`` and from a
``bootstrap_standby`` that no checkpoint matches, ``audit.divergence``
from the recovery validator, and ``job.failure`` from the dispatcher.
The reference's soak-driven test waits for the port's soak harness
(ROADMAP Queue 1 item 8). Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from clonos_tpu import cli as jcli
from clonos_tpu.obs import hlc as jhlc
from clonos_tpu.obs import incident as jinc
from clonos_tpu.obs import rootcause as jrc
from clonos_tpu.obs import timeline as jtl
from clonos_tpu.utils import jsonl as jjsonl
from clonos_tpu.utils import metrics as jmet
from clonos_tpu_torch import cli as tcli
from clonos_tpu_torch.analysis import census_fingerprint
from clonos_tpu_torch.analysis.census import CENSUS_PIN, read_pin
from clonos_tpu_torch.obs import hlc as thlc
from clonos_tpu_torch.obs import incident as tinc
from clonos_tpu_torch.obs import rootcause as trc
from clonos_tpu_torch.obs import timeline as ttl
from clonos_tpu_torch.utils import jsonl as tjsonl
from clonos_tpu_torch.utils import metrics as tmet

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(inc=jinc, rc=jrc, tl=jtl, hlc=jhlc,
                            jsonl=jjsonl, met=jmet, cli=jcli,
                            name="ref", module="clonos_tpu.cli")
PORT = types.SimpleNamespace(inc=tinc, rc=trc, tl=ttl, hlc=thlc,
                             jsonl=tjsonl, met=tmet, cli=tcli,
                             name="port", module="clonos_tpu_torch")
BOTH = [REF, PORT]


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    for pkg in BOTH:
        pkg.inc.reset_incidents()
        pkg.tl.reset_timeline()
        pkg.hlc.reset_hlc()


def _volatile_free(bundle):
    """A bundle's canonical JSON without its wall-clock and service
    fields and its census (the parts two packages' bundles may differ
    in: each names its own package's pinned census)."""
    b = json.loads(json.dumps(bundle))
    b["bundle"].pop("ts", None)
    b["bundle"].pop("service", None)
    b.pop("census", None)
    for rec in b.get("timeline") or []:
        for k in ("ts", "service", "pid"):
            rec.pop(k, None)
    return tinc.canonical_json(b)


def test_bundle_schema_fingerprint_equals_pin():
    with open(os.path.join(_REPO, ".clonos-incident-schema")) as f:
        pinned = f.read().split()[0]
    assert tinc.bundle_schema_fingerprint() == pinned == \
        jinc.bundle_schema_fingerprint()
    assert tinc.BUNDLE_SCHEMA == jinc.BUNDLE_SCHEMA
    assert tinc.TRIGGER_KINDS == jinc.TRIGGER_KINDS


# --- JSONL substrate ---------------------------------------------------------


def test_jsonl_appender_roundtrip(tmp_path):
    out = []
    for pkg in BOTH:
        path = str(tmp_path / f"a-{pkg.name}.jsonl")
        w = pkg.jsonl.JsonlAppender(path, sort_keys=True)
        w.append({"b": 2, "a": 1})
        w.append({"x": [1, 2]})
        w.sync()
        w.close()
        with open(path, "rb") as f:
            out.append((w.appended, list(pkg.jsonl.iter_jsonl(path, "t")),
                        f.read()))
    assert out[1] == out[0]
    assert out[1][1] == [{"a": 1, "b": 2}, {"x": [1, 2]}]
    assert out[1][2].startswith(b'{"a"')


def test_iter_jsonl_tolerates_torn_tail_only(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        f.write('{"ok": 1}\n{"torn": ')
    assert list(tjsonl.iter_jsonl(path, "test")) == [{"ok": 1}] == \
        list(jjsonl.iter_jsonl(path, "test"))
    with open(path, "w") as f:
        f.write('{"ok": 1}\nGARBAGE\n{"ok": 2}\n')
    msgs = []
    for pkg in BOTH:
        with pytest.raises(ValueError) as ei:
            list(pkg.jsonl.iter_jsonl(path, "test"))
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_atomic_rewrite_jsonl(tmp_path):
    out = []
    for pkg in BOTH:
        path = str(tmp_path / f"r-{pkg.name}.jsonl")
        with open(path, "w") as f:
            f.write('{"old": 1}\n' * 5)
        n = pkg.jsonl.atomic_rewrite_jsonl(path,
                                           [{"new": i} for i in range(3)])
        assert not os.path.exists(path + ".tmp")
        with open(path, "rb") as f:
            out.append((n, f.read()))
    assert out[1] == out[0]
    assert out[1][0] == 3


def _write_timeline(path, service, stamps):
    w = tjsonl.JsonlAppender(str(path), default=str)
    for i, (l_us, c) in enumerate(stamps):
        w.append({"kind": f"k{i}", "ts": 0.0, "hlc": [l_us, c, service],
                  "service": service, "pid": 1})
    w.close()


def test_iter_merged_matches_materialized_merge(tmp_path):
    a, b = tmp_path / "ta.jsonl", tmp_path / "tb.jsonl"
    rng = np.random.RandomState(11)
    sa = sorted((int(x), int(c)) for x, c in zip(
        rng.randint(0, 50, 12), rng.randint(0, 3, 12)))
    sb = sorted((int(x), int(c)) for x, c in zip(
        rng.randint(0, 50, 12), rng.randint(0, 3, 12)))
    _write_timeline(a, "a", sa)
    _write_timeline(b, "b", sb)
    paths = [str(a), str(b)]
    streamed = list(ttl.iter_merged(paths))
    assert streamed == ttl.merge_records(ttl.read_timeline(paths))
    assert streamed == list(jtl.iter_merged(paths))
    keys = [ttl.record_key(r) for r in streamed]
    assert keys == sorted(keys)


def test_causality_inversions_stream_matches_batch():
    recs = [
        {"kind": "msg.send", "ts": 0.0, "hlc": [10, 0, "a"],
         "service": "a", "pid": 1},
        {"kind": "msg.recv", "ts": 0.0, "hlc": [11, 0, "b"],
         "service": "b", "pid": 2, "sent": [10, 0, "a"]},
        {"kind": "msg.send", "ts": 0.0, "hlc": [20, 0, "a"],
         "service": "a", "pid": 1},
        {"kind": "msg.recv", "ts": 0.0, "hlc": [15, 0, "b"],
         "service": "b", "pid": 2, "sent": [20, 0, "a"]},
    ]
    merged = ttl.merge_records(recs)
    batch = ttl.causality_inversions(merged)
    streamed = ttl.causality_inversions_stream(iter(merged))
    assert batch == jtl.causality_inversions(merged)
    assert streamed == jtl.causality_inversions_stream(iter(merged))
    assert len(batch) == len(streamed)
    assert {f["rule"] for f in streamed} == {f["rule"] for f in batch} \
        == {"stamp", "merge"}


def test_cli_timeline_streaming_report_counts_inversions(tmp_path):
    a = tmp_path / "timeline-a.jsonl"
    _write_timeline(a, "a", [(10, 0), (20, 0)])
    outs = []
    for pkg in BOTH:
        out = subprocess.run(
            [sys.executable, "-m", pkg.module, "timeline", str(a),
             "--report", "json"],
            capture_output=True, text=True, cwd=_REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO))
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.strip().splitlines()[-1])
    assert outs[1] == outs[0]
    line = json.loads(outs[1])
    assert line["ok"] is True and line["records"] == 2
    assert line["inversions"] == []


def test_cli_timeline_inversion_fires_armed_recorder(tmp_path, capsys):
    recs = [
        {"kind": "msg.send", "ts": 0.0, "hlc": [20, 0, "a"],
         "service": "a", "pid": 1},
        {"kind": "msg.recv", "ts": 0.0, "hlc": [15, 0, "b"],
         "service": "b", "pid": 2, "sent": [20, 0, "a"]},
    ]
    path = tmp_path / "timeline-bad.jsonl"
    path.write_text("".join(json.dumps(r) + "\n"
                            for r in sorted(recs, key=lambda r: r["hlc"])))
    bundles = []
    for pkg in BOTH:
        mgr = pkg.inc.configure_incidents(str(tmp_path / pkg.name),
                                          service="cli",
                                          clock=lambda: 1.0)
        assert pkg.cli.main(["timeline", str(path), "--report",
                             "json"]) == 1
        capsys.readouterr()
        (bundle_path,) = mgr.bundles()
        bundles.append(pkg.inc.load_bundle(bundle_path))
    assert _volatile_free(bundles[1]) == _volatile_free(bundles[0])
    assert bundles[1]["census"] == read_pin(CENSUS_PIN)
    assert bundles[1]["trigger"]["kind"] == "timeline.inversion"
    assert bundles[1]["trigger"]["count"] == 2


# --- the flight recorder -----------------------------------------------------


def test_null_incident_manager_is_inert():
    mgr = tinc.get_incidents()
    assert mgr.enabled is False
    assert mgr.signal("slo.breach", window=0) is None
    assert mgr.bundles() == []
    assert (mgr.captured, mgr.deduped, mgr.suppressed,
            mgr.signals) == (0, 0, 0, 0)
    reg = tmet.MetricRegistry()
    mgr.register_gauges(reg)
    assert not any(k.startswith("incident.") for k in reg.snapshot())


def _manager(pkg, tmp_path, **kw):
    clock = {"t": 100.0}
    kw.setdefault("service", "test")
    kw.setdefault("min_interval_s", 5.0)
    mgr = pkg.inc.IncidentManager(str(tmp_path / pkg.name),
                                  clock=lambda: clock["t"], **kw)
    return mgr, clock


def test_unknown_kind_raises(tmp_path):
    msgs = []
    for pkg in BOTH:
        mgr, _ = _manager(pkg, tmp_path)
        with pytest.raises(ValueError) as ei:
            mgr.signal("not-a-kind")
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def _capture(pkg, tmp_path):
    mgr, _ = _manager(pkg, tmp_path)
    mgr.attach(
        ledgers=lambda: {"expected": [{"epoch": 3, "channels": {}}],
                         "actual": [{"epoch": 3, "channels": {}}]},
        chaos=lambda: "at 1s nondet",
        config=lambda: {"rate": 100.0},
        metrics=lambda: [{"metrics": {"m": 1}}])
    path = mgr.signal("audit.divergence", epoch=3, problem="p")
    assert path is not None and os.path.isfile(path)
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.dir))
    reg = pkg.met.MetricRegistry()
    mgr.register_gauges(reg)
    with open(path) as f:
        raw = f.read()
    return os.path.basename(path), raw, mgr, reg.snapshot()


def test_capture_lands_atomic_bundle_with_sections(tmp_path):
    rname, rraw, rmgr, rsnap = _capture(REF, tmp_path)
    name, raw, mgr, snap = _capture(PORT, tmp_path)
    assert name == rname == "incident-0001-audit.divergence.json"
    # Same clock and service: the files are byte-identical but for the
    # census, which names each package's own pinned FT call-site census.
    b, rb = json.loads(raw), json.loads(rraw)
    assert b["census"] == read_pin(CENSUS_PIN) != rb["census"]
    assert raw.replace(b["census"], rb["census"]) == rraw
    assert b["bundle"]["schema"] == "clonos-incident-bundle/v1"
    assert b["bundle"]["schema_fingerprint"] == \
        tinc.bundle_schema_fingerprint()
    assert b["trigger"] == {"kind": "audit.divergence", "epoch": 3,
                            "problem": "p"}
    assert b["ledgers"]["actual"][0]["epoch"] == 3
    assert b["chaos"] == "at 1s nondet" and b["config"] == {"rate": 100.0}
    assert mgr.captured == 1 and mgr.signals == 1
    assert snap == rsnap and snap["incident.captured"] == 1


def test_bundle_census_is_the_ports_pin_not_the_references(tmp_path):
    """A port bundle's ``census`` is the port's pin
    (``clonos_tpu_torch/.clonos-census``), the fingerprint of the port's
    own FT call-site census, and not the repository root's pin, which is
    the reference's."""
    _name, raw, _mgr, _snap = _capture(PORT, tmp_path)
    census = json.loads(raw)["census"]
    assert census == read_pin(CENSUS_PIN) == census_fingerprint()
    with open(os.path.join(_REPO, ".clonos-census")) as f:
        assert census != f.read().split()[0]


def _dedup(pkg, tmp_path):
    mgr, clock = _manager(pkg, tmp_path, max_bundles=3)
    got = []
    for dt, window in ((0.0, 1), (1.0, 2), (100.0, 1), (0.0, 2),
                       (100.0, 3), (100.0, 4)):
        clock["t"] += dt
        p = mgr.signal("slo.breach", window=window)
        got.append(None if p is None else os.path.basename(p))
    return got, (mgr.captured, mgr.deduped, mgr.suppressed, mgr.signals)


def test_dedup_rate_limit_and_cap(tmp_path):
    port = _dedup(PORT, tmp_path)
    assert port == _dedup(REF, tmp_path)
    got, counts = port
    assert [g is not None for g in got] == [True, False, False, True,
                                            True, False]
    assert counts == (3, 1, 2, 6)


def _restart(pkg, tmp_path):
    mgr, clock = _manager(pkg, tmp_path)
    mgr.signal("slo.breach", window=1)
    clock["t"] += 100.0
    mgr.signal("timeline.inversion", rule="stamp")
    mgr2, clock2 = _manager(pkg, tmp_path)
    first = mgr2.signal("slo.breach", window=1)
    clock2["t"] += 100.0
    path = mgr2.signal("slo.breach", window=9)
    return first, mgr2.deduped, os.path.basename(path)


def test_restart_resumes_seq_and_dedup(tmp_path):
    port = _restart(PORT, tmp_path)
    assert port == _restart(REF, tmp_path)
    assert port[0] is None and port[1] == 1
    assert port[2].startswith("incident-0003-")


def test_provider_error_degrades_section_not_bundle(tmp_path):
    out = []
    for pkg in BOTH:
        mgr, _ = _manager(pkg, tmp_path)
        mgr.attach(ledgers=lambda: 1 / 0)
        b = pkg.inc.load_bundle(mgr.signal("recovery.failure", epoch=1,
                                           error="x"))
        out.append(b["ledgers"])
    assert out[1] == out[0] and "provider-error" in out[1]


def test_ledger_section_trimmed_to_epoch_radius(tmp_path):
    out = []
    for pkg in BOTH:
        mgr, _ = _manager(pkg, tmp_path, epoch_radius=1)
        entries = [{"epoch": e, "channels": {}} for e in range(10)]
        mgr.attach(ledgers=lambda: {"expected": entries,
                                    "actual": entries})
        b = pkg.inc.load_bundle(mgr.signal("audit.divergence", epoch=5))
        out.append([e["epoch"] for e in b["ledgers"]["actual"]])
    assert out[1] == out[0] == [4, 5, 6]


def test_attach_rejects_unknown_slot(tmp_path):
    msgs = []
    for pkg in BOTH:
        mgr, _ = _manager(pkg, tmp_path)
        with pytest.raises(ValueError) as ei:
            mgr.attach(ledgrs=lambda: {})
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_signal_records_capture_on_timeline(tmp_path):
    recs = []
    for pkg in BOTH:
        pkg.hlc.configure_hlc(node="test", clock=lambda: 3.0)
        pkg.tl.configure_timeline("test", clock=lambda: 3.0)
        mgr, _ = _manager(pkg, tmp_path)
        mgr.signal("slo.breach", window=0)
        recs.append(pkg.tl.get_timeline().records())
    assert ttl.diff_timelines(recs[1], recs[0]) == []
    assert [r["hlc"] for r in recs[1]] == [r["hlc"] for r in recs[0]]
    assert "incident.captured" in [r["kind"] for r in recs[1]]


# --- deterministic root cause ------------------------------------------------


def test_incident_self_check_clean():
    assert tinc.incident_self_check() == [] == jinc.incident_self_check()


@pytest.mark.parametrize("name", ["unlogged-ring", "log-row"])
def test_rootcause_equals_reference_on_synthetic_bundles(name):
    b = tinc._synthetic_bundles()[name]
    assert tinc.canonical_json(b) == jinc.canonical_json(
        jinc._synthetic_bundles()[name])
    rep = trc.analyze_bundle(b)
    assert trc.render_report(rep) == jrc.render_report(
        jrc.analyze_bundle(b))
    assert trc.format_report(rep) == jrc.format_report(rep)


def test_rootcause_localizes_synthetic_ring_bundle():
    rep = trc.analyze_bundle(tinc._synthetic_bundles()["unlogged-ring"])
    assert rep["verdict"] == "localized"
    assert rep["first_divergent_epoch"] == 2
    assert rep["first_divergent_channel"] == "ring/v1"
    assert rep["determinant"]["kind"] == "ring-step"
    assert "unlogged nondeterminism" in rep["determinant"]["note"]
    assert rep["injected_by"] == "w0"
    assert rep["causal_chain"][0]["kind"] == "chaos"


def test_rootcause_no_divergence_verdict():
    entries = [{"epoch": 0, "channels": {
        "log/0": {"count": 1, "fp": "aa"}}}]
    b = {"bundle": {"fingerprint": "f", "schema_fingerprint": "s"},
         "trigger": {"kind": "slo.breach"},
         "ledgers": {"expected": entries, "actual": entries}}
    assert trc.analyze_bundle(b) == jrc.analyze_bundle(b)
    assert trc.analyze_bundle(b)["verdict"] == "no-divergence"


def _ledger_entries(rng, epochs, layout=None):
    out = []
    for e in range(epochs):
        chans = {f"log/{f}": {"count": int(rng.randint(1, 9)),
                              "fp": "%016x" % rng.randint(1 << 30)}
                 for f in range(3)}
        chans["ring/v1"] = {"count": 8, "fp": "%016x" % rng.randint(9)}
        chans["ringsum/v1"] = {"count": 8, "fp": "%016x" % rng.randint(9)}
        ent = {"epoch": e, "channels": chans, "det_counts": {}}
        if layout is not None:
            ent["layout"] = layout
        out.append(ent)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_rootcause_and_cross_diff_equal_reference_on_seeded_ledgers(seed):
    """Seeded ledger pairs, same layout and across a re-cut: the port's
    ``diff_ledgers_cross`` findings and root-cause reports equal the
    reference's."""
    from clonos_tpu.obs import audit as jaudit
    from clonos_tpu_torch.obs import audit as taudit
    rng = np.random.RandomState(seed)
    a = _ledger_entries(rng, 5, layout=[[0, 2], [1, 1]])
    b = json.loads(json.dumps(a))
    b[2]["channels"]["log/1"]["fp"] = "f" * 16
    c = json.loads(json.dumps(a))
    for ent in c[3:]:
        ent["layout"] = [[0, 1], [1, 2]]
    c[4]["channels"]["ringsum/v1"]["fp"] = "e" * 16
    for x, y in ((a, b), (a, c), (b, c), (a, a)):
        assert taudit.diff_ledgers_cross(x, y) == \
            jaudit.diff_ledgers_cross(x, y)
        bundle = {"bundle": {"fingerprint": "f"},
                  "trigger": {"kind": "audit.divergence"},
                  "ledgers": {"expected": x, "actual": y}}
        assert trc.render_report(trc.analyze_bundle(bundle)) == \
            jrc.render_report(jrc.analyze_bundle(bundle))
    assert taudit.key_group_directory(3, 5, 16) == \
        jaudit.key_group_directory(3, 5, 16)
    assert taudit.moved_key_groups(taudit.key_group_directory(3, 5, 16)) \
        == jaudit.moved_key_groups(jaudit.key_group_directory(3, 5, 16))


def test_explain_byte_identical_across_two_processes(tmp_path):
    bdir = tmp_path / "incidents"
    bdir.mkdir()
    bundle = tinc._synthetic_bundles()["unlogged-ring"]
    path = bdir / "incident-0001-audit.divergence.json"
    path.write_text(tinc.canonical_json(bundle) + "\n")

    def run(module):
        return subprocess.run(
            [sys.executable, "-m", module, "incident", "explain",
             str(path), "--report", "json"],
            capture_output=True, cwd=_REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO))
    one, two = run(PORT.module), run(PORT.module)
    ref = run(REF.module)
    assert one.returncode == two.returncode == ref.returncode == 0, \
        one.stderr
    assert one.stdout == two.stdout == ref.stdout
    rep = json.loads(one.stdout)
    assert rep["verdict"] == "localized"
    assert rep["first_divergent_channel"] == "ring/v1"


def test_cli_incident_list_show_and_self_check(tmp_path):
    mgr = tinc.configure_incidents(str(tmp_path), service="cli",
                                   min_interval_s=0.0)
    mgr.signal("slo.breach", window=0, breaches=["p99"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    for argv in (["incident", "list", "--dir", str(tmp_path)],
                 ["incident", "show", "1", "--dir", str(tmp_path)],
                 ["incident", "explain", "--dir", str(tmp_path)],
                 ["incident", "--self-check"]):
        outs = [subprocess.run([sys.executable, "-m", pkg.module, *argv],
                               capture_output=True, text=True, cwd=_REPO,
                               env=env) for pkg in BOTH]
        assert (outs[1].returncode, outs[1].stdout) == \
            (outs[0].returncode, outs[0].stdout), argv
    out = outs[1]
    assert out.returncode == 0
    line = json.loads(out.stdout)
    assert line["ok"] is True
    assert line["schema"] == tinc.bundle_schema_fingerprint()
    listing = subprocess.run(
        [sys.executable, "-m", PORT.module, "incident", "list", "--dir",
         str(tmp_path)], capture_output=True, text=True, cwd=_REPO,
        env=env)
    assert "slo.breach" in listing.stdout


# --- the hooks in the port's runtime -----------------------------------------


def _small_runner(tmp_path, **kw):
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    env = StreamEnvironment(name="inc", num_key_groups=8)
    (env.synthetic_source(vocab=13, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=13, window_size=1 << 30).sink())
    return ClusterRunner(env.build(), steps_per_epoch=4, log_capacity=256,
                         max_epochs=8, seed=3, device="cpu",
                         checkpoint_dir=str(tmp_path / "ck"), **kw)


def test_failed_recovery_lands_a_recovery_failure_bundle(tmp_path):
    """``recover()`` wraps the protocol: a recovery that raises lands one
    ``recovery.failure`` bundle naming the error and the failed subtasks,
    and re-raises; the incident gauges ride the runner's registry."""
    from clonos_tpu_torch.causal.recovery import RecoveryError
    mgr = tinc.configure_incidents(str(tmp_path), service="runner",
                                   clock=lambda: 1.0)
    r = _small_runner(tmp_path)
    r.run_epoch(complete_checkpoint=False)
    r.inject_failure([2])
    with pytest.raises(RecoveryError):
        r.recover()            # no completed checkpoint to restore
    (path,) = mgr.bundles()
    b = tinc.load_bundle(path)
    assert b["trigger"]["kind"] == "recovery.failure"
    assert b["trigger"]["failed"] == [2]
    assert "RecoveryError" in b["trigger"]["error"]
    assert r.metrics.snapshot()["incident.captured"] == 1


def test_unmatched_standby_bootstrap_lands_a_bundle(tmp_path):
    from clonos_tpu_torch.causal.recovery import RecoveryError
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    mgr = tinc.configure_incidents(str(tmp_path), service="standby")
    r = _small_runner(tmp_path)
    r.run_epoch(complete_checkpoint=True)
    r.coordinator.storage._close_ledger()
    rows = {f: (np.zeros((0, 8), np.int32), 12345) for f in range(6)}
    with pytest.raises(RecoveryError, match="mirror starts"):
        ClusterRunner.bootstrap_standby(
            r.job, str(tmp_path / "ck"), rows, steps_per_epoch=4,
            log_capacity=256, max_epochs=8, seed=3, device="cpu")
    (path,) = mgr.bundles()
    trig = tinc.load_bundle(path)["trigger"]
    assert trig["kind"] == "recovery.failure"
    assert trig["source"] == "bootstrap_standby"


def test_audit_divergence_signals_the_recorder(tmp_path):
    """The recovery validator signals ``audit.divergence`` for a replayed
    epoch whose digest differs from the sealed ledger entry, before its
    abort policy acts."""
    from clonos_tpu_torch.causal.recovery import (AuditDivergenceError,
                                                  AuditValidator)
    mgr = tinc.configure_incidents(str(tmp_path), service="v",
                                   min_interval_s=0.0)
    r = _small_runner(tmp_path, audit=True)
    for _ in range(2):
        r.run_epoch(complete_checkpoint=False)
    r.drain_fence()
    ledger = r.coordinator.storage.read_ledger()
    ledger[0]["channels"]["log/0"]["fp"] = "0" * 16
    v = AuditValidator(r.executor, ledger, on_divergence="abort")
    with pytest.raises(AuditDivergenceError):
        v.validate([0, 1])
    (path,) = mgr.bundles()
    trig = tinc.load_bundle(path)["trigger"]
    assert trig == {"kind": "audit.divergence", "epoch": 0,
                    "channel": "log/0", "reason": trig["reason"],
                    "source": "recovery-validator"}


def test_failed_job_lands_a_job_failure_bundle(tmp_path):
    from clonos_tpu_torch.runtime.dispatcher import Dispatcher
    mgr = tinc.configure_incidents(str(tmp_path / "inc"), service="disp")
    disp = Dispatcher(lease_path=str(tmp_path / "lease"),
                      checkpoint_root=str(tmp_path / "ck"),
                      device="cpu")
    try:
        jid = disp.submit_job("no.such.module:build_job",
                              {"tenant": "red", "slots": 1})["job_id"]
        disp._jobs[jid].state = "ADMITTED"
        disp._deploy_ready()          # the launch fails: no such job
        state = disp._jobs[jid].state
    finally:
        disp.close()
    assert state == "FAILED"
    (path,) = mgr.bundles()
    trig = tinc.load_bundle(path)["trigger"]
    assert (trig["kind"], trig["job_id"], trig["tenant"]) == \
        ("job.failure", jid, "red")
    assert trig["error"]
