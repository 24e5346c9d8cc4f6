"""PyTorch port, the causal timeline and gray-failure detection (mirror of
the reference's ``tests/test_timeline.py`` and of
``tests/test_obs.py::test_trace_reconstructs_recovery_timeline_across_processes``).

Every unit test drives the reference (``clonos_tpu.obs``) and the port
(``clonos_tpu_torch.obs``) with the same inputs: the same injected clocks
(no wall clock), the same node names and seeded ``np.random.RandomState``
interleavings. The HLC stamps, timeline records and files, detector
verdicts and replay logs, CLI outputs and exit codes, and the wire
headers with the planes on must equal the reference's; ``diff_timelines``
(which ignores ``ts``, ``hlc``, ``pid``, ``service`` and ``sent``) finds
nothing between the two packages' timelines. The two-process tests run
the port alone: a SIGKILLed child whose timeline merges with its
parent's, and the spanned job over two ``slotworker`` processes with
tracing and the timeline on, whose merged files reconstruct the
recovery with zero causality inversions. The reference's soak-driven
test waits for the port's soak harness (ROADMAP Queue 1 item 8).
Tolerance: exact.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from clonos_tpu import cli as jcli
from clonos_tpu.obs import detect as jdetect
from clonos_tpu.obs import hlc as jhlc
from clonos_tpu.obs import timeline as jtimeline
from clonos_tpu.obs import trace as jtrace
from clonos_tpu.parallel import transport as jtp
from clonos_tpu.utils import metrics as jmetrics
from clonos_tpu_torch import cli as tcli
from clonos_tpu_torch import obs as tobs
from clonos_tpu_torch.obs import detect as tdetect
from clonos_tpu_torch.obs import hlc as thlc
from clonos_tpu_torch.obs import timeline as ttimeline
from clonos_tpu_torch.obs import trace as ttrace
from clonos_tpu_torch.parallel import transport as ttp
from clonos_tpu_torch.utils import metrics as tmetrics

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(hlc=jhlc, tl=jtimeline, det=jdetect, cli=jcli,
                            tp=jtp, met=jmetrics, trace=jtrace)
PORT = types.SimpleNamespace(hlc=thlc, tl=ttimeline, det=tdetect,
                             cli=tcli, tp=ttp, met=tmetrics, trace=ttrace)
BOTH = [REF, PORT]


@pytest.fixture(autouse=True)
def _clean_obs_globals():
    yield
    for pkg in BOTH:
        pkg.det.reset_detector()
        pkg.tl.reset_timeline()
        pkg.hlc.reset_hlc()


def _fake_clock(start: float, step: float = 0.001):
    """A deterministic wall clock: starts skewed, advances per read."""
    t = [start]

    def clock():
        t[0] += step
        return t[0]

    return clock


# --- hybrid logical clock ----------------------------------------------------


def test_hlc_tick_is_strictly_monotonic_under_frozen_clock():
    runs = []
    for pkg in BOTH:
        h = pkg.hlc.HybridLogicalClock("a", clock=lambda: 100.0)
        runs.append([h.tick() for _ in range(50)])
    ref, port = runs
    assert port == ref
    for prev, nxt in zip(port, port[1:]):
        assert thlc.stamp_key(nxt) > thlc.stamp_key(prev)
    assert port[0][0] == port[-1][0] and port[-1][1] > port[0][1]


def test_hlc_observe_orders_receive_after_send_despite_skew():
    runs = []
    for pkg in BOTH:
        sender = pkg.hlc.HybridLogicalClock("fast",
                                            clock=_fake_clock(1000.0))
        receiver = pkg.hlc.HybridLogicalClock("slow",
                                              clock=_fake_clock(970.0))
        pairs = []
        for _ in range(200):
            sent = sender.tick()
            pairs.append((sent, receiver.observe(sent)))
        runs.append(pairs)
    assert runs[1] == runs[0]
    for sent, recv in runs[1]:
        assert thlc.stamp_key(recv) > thlc.stamp_key(sent)


def _interleaving(pkg, seed):
    """Two processes with seeded clock skew exchange messages in a seeded
    random order; returns the record stream."""
    rng = np.random.RandomState(seed)
    skew = float(rng.uniform(-60.0, 60.0))
    clocks = {"a": pkg.hlc.HybridLogicalClock("a",
                                              clock=_fake_clock(500.0)),
              "b": pkg.hlc.HybridLogicalClock(
                  "b", clock=_fake_clock(500.0 + skew))}
    records, in_flight = [], []
    for _ in range(120):
        op = rng.random_sample()
        src = "ab"[rng.randint(2)]
        dst = "b" if src == "a" else "a"
        if op < 0.5:
            sent = clocks[src].tick()
            in_flight.append((dst, sent))
            records.append({"kind": "msg.send", "ts": 0.0,
                            "hlc": list(sent), "service": src,
                            "verb": "DEPLOY"})
        elif in_flight:
            dst, sent = in_flight.pop(rng.randint(len(in_flight)))
            got = clocks[dst].observe(sent)
            records.append({"kind": "msg.recv", "ts": 0.0,
                            "hlc": list(got), "service": dst,
                            "verb": "DEPLOY", "sent": list(sent)})
    return records


@pytest.mark.parametrize("seed", range(4))
def test_hlc_merged_streams_show_no_inversions_seeded_interleavings(seed):
    ref = _interleaving(REF, seed)
    port = _interleaving(PORT, seed)
    assert port == ref
    merged = ttimeline.merge_records(port)
    assert merged == jtimeline.merge_records(ref)
    assert ttimeline.causality_inversions(merged) == [] == \
        jtimeline.causality_inversions(merged)


def test_timeline_self_check_is_clean():
    assert ttimeline.timeline_self_check() == [] == \
        jtimeline.timeline_self_check()


def test_causality_inversions_catches_a_broken_receive_rule():
    bad = [{"kind": "msg.send", "ts": 0.0, "hlc": [10, 0, "a"],
            "service": "a", "verb": "HEARTBEAT"},
           {"kind": "msg.recv", "ts": 0.0, "hlc": [9, 0, "b"],
            "service": "b", "verb": "HEARTBEAT", "sent": [10, 0, "a"]}]
    port = ttimeline.causality_inversions(ttimeline.merge_records(bad))
    assert port == jtimeline.causality_inversions(
        jtimeline.merge_records(bad))
    assert any(f["rule"] == "stamp" for f in port)


# --- timeline store + reader -------------------------------------------------


def _store_file(pkg, tmp_path, torn):
    path = str(tmp_path / f"timeline-{pkg is PORT}.jsonl")
    tl = pkg.tl.TimelineStore("a", path=path, clock=_fake_clock(10.0))
    tl.record("epoch.seal", epoch=3)
    tl.record("scale.decision", epoch=3, action="hold")
    tl.close()
    if torn:
        with open(path, "a") as f:
            f.write('{"kind": "msg.send", "ts": 11.0, "hl')
    return path


def test_timeline_store_writes_and_reader_survives_torn_tail(tmp_path):
    pr, pp = (_store_file(pkg, tmp_path, torn=True) for pkg in BOTH)
    with open(pr, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()
    recs = ttimeline.read_timeline(pp)
    assert recs == jtimeline.read_timeline(pr)
    assert [r["kind"] for r in recs] == ["epoch.seal", "scale.decision"]
    assert recs[0]["service"] == "a" and recs[0]["epoch"] == 3


def test_timeline_reader_refuses_mid_file_junk(tmp_path):
    path = str(tmp_path / "timeline-junk.jsonl")
    with open(path, "w") as f:
        f.write('{"kind": "epoch.seal", "ts": 1.0, "epoch": 1}\n')
        f.write("not json at all\n")
        f.write('{"kind": "epoch.seal", "ts": 2.0, "epoch": 2}\n')
    msgs = []
    for pkg in BOTH:
        with pytest.raises(ValueError) as ei:
            pkg.tl.read_timeline(path)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert "timeline-junk.jsonl:2" in msgs[1]


def _two_stores(pkg, tmp_path):
    pa = str(tmp_path / f"a-{pkg is PORT}.jsonl")
    pb = str(tmp_path / f"b-{pkg is PORT}.jsonl")
    ta = pkg.tl.TimelineStore("a", path=pa, clock=_fake_clock(5.0))
    tb = pkg.tl.TimelineStore("b", path=pb, clock=_fake_clock(900.0))
    ta.record("epoch.seal", epoch=1)
    tb.record("epoch.seal", epoch=1)
    ta.record("chaos", chaos_kind="kill", at_s=1.0)
    ta.close(), tb.close()
    ra, rb = pkg.tl.read_timeline(pa), pkg.tl.read_timeline(pb)
    return (pkg.tl.merge_records(ra + rb),
            pkg.tl.diff_timelines(
                [r for r in ra if r["kind"] == "epoch.seal"], rb),
            pkg.tl.diff_timelines(ra, rb))


def test_merge_and_diff_of_two_stores(tmp_path):
    ref = _two_stores(REF, tmp_path)
    port = _two_stores(PORT, tmp_path)
    assert port == ref
    merged, same, findings = port
    assert len(merged) == 3 and same == []
    assert [f["only"] for f in findings] == ["a"]
    assert findings[0]["record"]["kind"] == "chaos"


# --- gray-failure detector (pure core) ---------------------------------------


def _snap(pkg, epoch=1, hb=None, ep=None, stal=None, stall=0.0):
    return pkg.det.GraySnapshot.build(
        epoch=epoch, hb_age_ms=hb or {}, epoch_ms=ep or {},
        staleness=stal or {}, fence_stall_ms=stall)


def test_snapshot_canonical_crc_roundtrip():
    kw = dict(epoch=7, hb={"w0": 0.0, "w3": 412.3},
              ep={"w0": 100.0, "w3": 950.0}, stal={"replica.0": 0.5},
              stall=133.7)
    s, r = _snap(PORT, **kw), _snap(REF, **kw)
    assert s.canonical() == r.canonical() and s.crc() == r.crc()
    d = json.loads(s.canonical())
    assert tdetect.GraySnapshot.from_dict(d) == s
    assert tdetect.GraySnapshot.from_dict(d).crc() == s.crc()


def test_detect_gray_is_deterministic():
    out = []
    for pkg in BOTH:
        s = _snap(pkg, hb={"w0": 0.0, "w1": 0.0, "w3": 500.0})
        v1, st1 = pkg.det.detect_gray(s, pkg.det.DetectorConfig(),
                                      pkg.det.DetectorState())
        v2, st2 = pkg.det.detect_gray(s, pkg.det.DetectorConfig(),
                                      pkg.det.DetectorState())
        assert v1 == v2 and st1 == st2 and v1.snapshot_crc == s.crc()
        out.append((v1.to_dict(), st1.as_dict()))
    assert out[1] == out[0]


def _scores(pkg, **kw):
    return pkg.det.score_gray(_snap(pkg, **kw), pkg.det.DetectorConfig())


def test_peer_relative_scoring_ignores_cluster_wide_slowdown():
    uniform = dict(ep={f"w{i}": 5000.0 for i in range(4)})
    skewed = dict(ep={"w0": 100.0, "w1": 100.0, "w2": 100.0, "w3": 400.0})
    for kw in (uniform, skewed):
        assert _scores(PORT, **kw) == _scores(REF, **kw)
    assert _scores(PORT, **uniform) == {}
    scores = _scores(PORT, **skewed)
    assert list(scores) == ["w3"] and "epoch-outlier" in scores["w3"][1]


def test_fence_stall_corroborates_but_never_accuses():
    lone = dict(stall=9000.0)
    lagging = dict(hb={"w0": 0.0, "w2": 400.0}, stall=9000.0)
    for kw in (lone, lagging):
        assert _scores(PORT, **kw) == _scores(REF, **kw)
    assert _scores(PORT, **lone) == {}
    assert _scores(PORT, **lagging)["w2"] == (2, ("hb-lag", "fence-stall"))


def _sustain(pkg):
    cfg = pkg.det.DetectorConfig(sustain_fences=2)
    lagging = _snap(pkg, hb={"w0": 0.0, "w1": 300.0})
    healthy = _snap(pkg, hb={"w0": 0.0, "w1": 0.0})
    st = pkg.det.DetectorState()
    out = []
    for snap in (lagging, lagging, healthy, lagging):
        v, st = pkg.det.detect_gray(snap, cfg, st)
        out.append((v.suspects, v.scores, st.as_dict()))
    return out


def test_suspicion_must_sustain_and_resets_on_recovery():
    port = _sustain(PORT)
    assert port == _sustain(REF)
    assert [s for s, _, _ in port] == [(), (("w1", 1, "hb-lag"),), (), ()]
    assert port[0][1] == (("w1", 1),)


def _detector_run(pkg, tmp_path):
    path = str(tmp_path / f"t-{pkg is PORT}.jsonl")
    pkg.tl.configure_timeline("jm", path=path, clock=_fake_clock(50.0))
    pkg.hlc.configure_hlc(node="jm", clock=_fake_clock(50.0))
    det = pkg.det.GrayFailureDetector(
        pkg.det.DetectorConfig(sustain_fences=1))
    det.on_fence(_snap(pkg, epoch=1, hb={"w0": 0.0, "w1": 300.0}))
    det.on_fence(_snap(pkg, epoch=2, hb={"w0": 0.0, "w1": 280.0}))
    det.on_fence(_snap(pkg, epoch=3, hb={"w0": 0.0, "w1": 0.0}))
    verdicts = [v.to_dict() for v in det.replay()]
    pkg.tl.reset_timeline()
    return det, verdicts, pkg.tl.read_timeline(path)


def test_detector_replays_bit_identically_and_catches_tampering(tmp_path):
    rdet, rverdicts, rrecs = _detector_run(REF, tmp_path)
    det, verdicts, recs = _detector_run(PORT, tmp_path)
    assert det.log == rdet.log and verdicts == rverdicts
    assert det.suspects() == [] and det.events_emitted >= 2
    assert [v["epoch"] for v in verdicts] == [1, 2, 3]
    assert verdicts[0]["suspects"] == (("w1", 1, "hb-lag"),)
    # Same records, same stamps (one injected clock per package).
    assert ttimeline.diff_timelines(recs, rrecs) == []
    assert [r["hlc"] for r in recs] == [r["hlc"] for r in rrecs]
    kinds = [r["kind"] for r in recs]
    assert "health.gray-suspect" in kinds
    assert "health.gray-cleared" in kinds
    det.log[1]["snapshot"]["hb_age_ms"][1][1] = 0.0
    with pytest.raises(ValueError):
        det.replay()


def test_detector_gauges_ride_the_metric_rollup():
    snaps = []
    for pkg in BOTH:
        reg = pkg.met.MetricRegistry()
        det = pkg.det.GrayFailureDetector(
            pkg.det.DetectorConfig(sustain_fences=1))
        det.register_gauges(reg)
        det.on_fence(_snap(pkg, epoch=1, hb={"w0": 0.0, "w1": 300.0}))
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["cluster.health.suspects"] == 1
    assert snaps[1]["cluster.health.gray-events"] == 1
    assert snaps[1]["cluster.health.fences-scored"] == 1


def test_top_renders_health_row_and_trace_drop_line():
    snap = {"cluster.health.suspects": 1, "cluster.health.gray-events": 3,
            "trace.dropped-records": 42}
    table = tcli._top_table(snap)
    assert table == jcli._top_table(snap)
    health = next(ln for ln in table.splitlines()
                  if ln.startswith("health:"))
    assert "suspects=1" in health and "gray-events=3" in health
    assert "dropped-records=42" in table
    quiet = {"cluster.health.suspects": 0, "trace.dropped-records": 0}
    assert tcli._top_table(quiet) == jcli._top_table(quiet)
    assert "dropped-records" not in tcli._top_table(quiet)


def test_tracer_counts_ring_evictions():
    out = []
    for pkg in BOTH:
        tr = pkg.trace.Tracer("t", clock=_fake_clock(1.0), buffer=4)
        for i in range(7):
            tr.event("e", i=i)
        out.append((tr.dropped, [r["args"] for r in tr.records()]))
        tr.close()
    assert out[1] == out[0] == (3, [{"i": i} for i in range(3, 7)])


# --- the CLI contract --------------------------------------------------------


def _cli(pkg, argv, capsys):
    rc = pkg.cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_timeline_cli_report_json_and_filters(tmp_path, capsys):
    pa = str(tmp_path / "timeline-jm.jsonl")
    tl = ttimeline.TimelineStore("jm", path=pa, clock=_fake_clock(5.0))
    tl.record("epoch.seal", epoch=1)
    tl.record("epoch.seal", epoch=2)
    tl.record("scale.decision", epoch=2, action="hold")
    tl.close()
    for argv in (["timeline", pa, "--report", "json"],
                 ["timeline", pa, "--kind", "scale", "--report", "json"],
                 ["timeline", pa]):
        assert _cli(PORT, argv, capsys) == _cli(REF, argv, capsys)
    rc, out, _ = _cli(PORT, ["timeline", pa, "--report", "json"], capsys)
    rep = json.loads(out)
    assert rc == 0 and rep["ok"] is True and rep["records"] == 3
    assert rep["inversions"] == [] and rep["by_kind"]["epoch.seal"] == 2
    rc, out, _ = _cli(PORT, ["timeline", pa, "--kind", "scale",
                             "--report", "json"], capsys)
    assert rc == 0 and json.loads(out)["shown"] == 1


def test_timeline_cli_self_check_and_diff_exit_codes(tmp_path, capsys):
    assert _cli(PORT, ["timeline", "--self-check"], capsys) == \
        _cli(REF, ["timeline", "--self-check"], capsys)
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    ta = ttimeline.TimelineStore("a", path=pa, clock=_fake_clock(1.0))
    tb = ttimeline.TimelineStore("b", path=pb, clock=_fake_clock(2.0))
    ta.record("epoch.seal", epoch=1)
    tb.record("epoch.seal", epoch=1)
    ta.close(), tb.close()
    same = _cli(PORT, ["timeline", pa, "--diff", pb], capsys)
    assert same == _cli(REF, ["timeline", pa, "--diff", pb], capsys)
    assert same[0] == 0
    tb2 = ttimeline.TimelineStore("b", path=pb, clock=_fake_clock(3.0))
    tb2.record("epoch.seal", epoch=2)
    tb2.close()
    diverged = _cli(PORT, ["timeline", pa, "--diff", pb], capsys)
    assert diverged == _cli(REF, ["timeline", pa, "--diff", pb], capsys)
    assert diverged[0] == 1
    report = ["timeline", pa, "--diff", pb, "--report", "json"]
    assert _cli(PORT, report, capsys) == _cli(REF, report, capsys)


def test_timeline_cli_reports_inversions_with_exit_1(tmp_path, capsys):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "msg.send", "ts": 1.0,
                            "hlc": [10, 0, "a"], "service": "a",
                            "verb": "DEPLOY"}) + "\n")
        f.write(json.dumps({"kind": "msg.recv", "ts": 2.0,
                            "hlc": [9, 0, "b"], "service": "b",
                            "verb": "DEPLOY",
                            "sent": [10, 0, "a"]}) + "\n")
    for argv in (["timeline", path, "--report", "json"],
                 ["timeline", path]):
        port = _cli(PORT, argv, capsys)
        assert port == _cli(REF, argv, capsys)
        assert port[0] == 1
    rep = json.loads(_cli(PORT, ["timeline", path, "--report", "json"],
                          capsys)[1])
    assert rep["ok"] is False and rep["inversions"]


def test_timeline_cli_chrome_export(tmp_path, capsys):
    pa = str(tmp_path / "t.jsonl")
    tl = ttimeline.TimelineStore("jm", path=pa, clock=_fake_clock(5.0))
    tl.record("epoch.seal", epoch=1)
    tl.close()
    docs = []
    for pkg, name in ((REF, "ref"), (PORT, "port")):
        out = str(tmp_path / f"chrome-{name}.json")
        assert _cli(pkg, ["timeline", pa, "--chrome", out],
                    capsys)[0] == 0
        with open(out) as f:
            docs.append(json.load(f))
    assert docs[1] == docs[0]
    instants = [e for e in docs[1]["traceEvents"] if e["ph"] == "i"]
    assert instants and instants[0]["name"] == "epoch.seal"


# --- the planes on the wire --------------------------------------------------


def _stamped(pkg, tmp_path):
    """One process's view of a send and a receive with HLC and timeline
    on, under one injected clock: the headers and the timeline."""
    path = str(tmp_path / f"wire-{pkg is PORT}.jsonl")
    pkg.hlc.configure_hlc(node="jm", clock=_fake_clock(77.0))
    pkg.tl.configure_timeline("jm", path=path, clock=_fake_clock(77.0))
    headers = []
    for verb in ("DEPLOY", "HEARTBEAT", "FETCH_EDGE",
                 "DETERMINANT_REQUEST", "QUERY_STATE", "QUERY_BATCH"):
        h = pkg.tp.attach_hlc({"seq": len(headers)}, verb=verb)
        headers.append(h)
        pkg.tp.adopt_hlc({"hlc": {"ts": [h["hlc"]["ts"][0] + 5, 0],
                                  "node": "w"}}, verb=verb)
    pkg.tl.reset_timeline()
    return headers, pkg.tl.read_timeline(path)


def test_hlc_headers_and_records_equal_reference(tmp_path):
    """With the HLC on (same clock, same node), every verb's header field
    and every ``msg.send`` / ``msg.recv`` record's stamp equal the
    reference's, and the two timelines diff clean."""
    rh, rrecs = _stamped(REF, tmp_path)
    ph, precs = _stamped(PORT, tmp_path)
    assert ph == rh
    assert [(r["kind"], r["verb"], r["hlc"], r.get("sent"))
            for r in precs] == [(r["kind"], r["verb"], r["hlc"],
                                 r.get("sent")) for r in rrecs]
    assert ttimeline.diff_timelines(precs, rrecs) == []
    assert ttimeline.causality_inversions(precs) == []


def test_planes_off_attach_nothing():
    """Every plane off: the headers are untouched (the wire bytes equal
    a build without the planes)."""
    for pkg in BOTH:
        h = {"a": 1}
        pkg.tp.attach_hlc(h, verb="DEPLOY")
        assert h == {"a": 1}
    h = {"a": 1}
    ttp.attach_lineage(ttp.attach_profile(ttp.attach_audit(h)))
    assert h == {"a": 1}
    ttp.adopt_hlc({"hlc": {"ts": [1, 0], "node": "x"}})
    assert tobs.get_timeline().records() == []


def test_deploy_headers_with_planes_on_equal_reference(tmp_path,
                                                       monkeypatch):
    """The scheduler's DEPLOY headers (first deploys and the recovery
    redeploy) with the HLC, timeline and lineage planes on in both
    packages (same injected clock, node and dye config) equal the
    reference's key for key but the job spec."""
    from clonos_tpu.obs import lineage as jlin
    from clonos_tpu.runtime import remote as jremote
    from clonos_tpu.runtime import scheduler as jsch
    from clonos_tpu_torch.obs import lineage as tlin
    from clonos_tpu_torch.runtime import remote as tremote
    from clonos_tpu_torch.runtime import scheduler as tsch
    from test_torch_scheduler import JAX_SPEC, SPEC, _record_deploys

    sent = {}
    for name, pkg, lin, sch, rem, spec in (
            ("ref", REF, jlin, jsch, jremote, JAX_SPEC),
            ("port", PORT, tlin, tsch, tremote, SPEC)):
        pkg.hlc.configure_hlc(node="jm", clock=lambda: 12.5)
        pkg.tl.configure_timeline("jm", clock=lambda: 12.5)
        lin.configure_lineage(str(tmp_path / "lin"), service="jm", k=3)
        kw = {"device": "cpu"} if name == "port" else {}
        try:
            _, sent[name] = _record_deploys(sch, rem, spec, tmp_path,
                                            monkeypatch, **kw)
            sent[name + "-tl"] = pkg.tl.get_timeline().records()
        finally:
            lin.reset_lineage()
    assert len(sent["port"]) == len(sent["ref"]) == 3
    for (pw, ptdd, pframe), (rw, rtdd, rframe) in zip(sent["port"],
                                                      sent["ref"]):
        assert pw == rw and pframe == rframe
        assert "hlc" in ptdd and "lineage" in ptdd
        assert {k: v for k, v in ptdd.items() if k != "job"} == \
            {k: v for k, v in rtdd.items() if k != "job"}
    assert ttimeline.diff_timelines(sent["port-tl"], sent["ref-tl"]) == []


def test_concurrent_stamps_append_in_stamp_order(tmp_path):
    """Threads that stamp and record at once (in a worker: the driving
    thread, the fence worker, the heartbeat and handler threads) append
    to one store in stamp order, each stamp once: the streaming merge
    relies on every file being sorted by its stamps. Eight threads, a
    shortened switch interval."""
    path = str(tmp_path / "timeline-p.jsonl")
    tobs.configure_hlc(node="p", clock=lambda: 5.0)
    tobs.configure_timeline("p", path=path, clock=lambda: 5.0)

    def work(i):
        for j in range(150):
            if j % 3 == 0:
                ttp.attach_hlc({"i": i}, verb="HEARTBEAT")
            elif j % 3 == 1:
                ttp.adopt_hlc({"hlc": {"ts": [5_000_000 + j, i],
                                       "node": "q"}}, verb="FETCH_EDGE")
            else:
                tobs.get_timeline().record("epoch.seal", epoch=j)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tobs.reset_timeline()
    recs = ttimeline.read_timeline(path)
    keys = [ttimeline.record_key(r) for r in recs]
    assert len(recs) == 8 * 150 and len(set(keys)) == len(keys)
    assert keys == sorted(keys)
    assert list(ttimeline.iter_merged([path])) == \
        ttimeline.merge_records(recs)
    assert ttimeline.causality_inversions(recs) == []


# --- acceptance: 2-process SIGKILL, one merged timeline ----------------------


_CHILD = r"""
import sys, time
port, path = int(sys.argv[1]), sys.argv[2]
from clonos_tpu_torch.obs import configure_hlc, configure_timeline
from clonos_tpu_torch.parallel import transport as tp
import time as _t
configure_hlc(node="child", clock=lambda: _t.time() + 45.0)
configure_timeline("child", path=path)
c = tp.ControlClient(("127.0.0.1", port), timeout_s=10.0)
for i in range(100000):
    msg = tp.attach_hlc({"seq": i}, verb="HEARTBEAT")
    c.call_json(tp.HEARTBEAT, msg)
    if i == 0:
        print("ready", flush=True)
    time.sleep(0.002)
"""


def test_sigkilled_child_merges_into_one_causal_timeline(tmp_path):
    """A port child process streams HLC-stamped heartbeats (its wall
    clock skewed +45 s) until it is SIGKILLed; its timeline file and the
    port parent's merge into one stream with zero causality
    inversions."""
    parent_tl = str(tmp_path / "timeline-parent.jsonl")
    child_tl = str(tmp_path / "timeline-child.jsonl")
    tobs.configure_hlc(node="parent")
    tobs.configure_timeline("parent", path=parent_tl)
    seen = []

    def handler(mtype, payload):
        obj = ttp.unpack_json(payload)
        ttp.adopt_hlc(obj, verb="HEARTBEAT")
        seen.append(obj["seq"])
        return mtype, ttp.pack_json({"ok": True})

    srv = ttp.ControlServer(handler)
    child_src = str(tmp_path / "child.py")
    with open(child_src, "w") as f:
        f.write(_CHILD)
    env = dict(os.environ, PYTHONPATH=_REPO)
    pb = subprocess.Popen(
        [sys.executable, child_src, str(srv.address[1]), child_tl],
        cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        assert pb.stdout.readline().strip() == "ready"
        deadline = time.monotonic() + 20.0
        while len(seen) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(seen) >= 8, "child never delivered 8 heartbeats"
        pb.send_signal(signal.SIGKILL)
        pb.wait(timeout=10.0)
    finally:
        if pb.poll() is None:
            pb.kill()
        srv.close()
    assert pb.returncode == -signal.SIGKILL
    tobs.reset_timeline()

    merged = ttimeline.merge_records(ttimeline.read_timeline(parent_tl)
                                     + ttimeline.read_timeline(child_tl))
    assert ttimeline.causality_inversions(merged) == []
    assert jtimeline.causality_inversions(merged) == []
    sends = [r for r in merged if r["kind"] == "msg.send"]
    recvs = [r for r in merged if r["kind"] == "msg.recv"]
    assert len(sends) >= 8 and len(recvs) >= 8
    assert len(recvs) <= len(sends)
    assert {r["service"] for r in sends} == {"child"}
    assert {r["service"] for r in recvs} == {"parent"}
    assert merged[0]["kind"] == "msg.send"
    # The streaming merge over the two files agrees with the batch one.
    streamed = list(ttimeline.iter_merged([parent_tl, child_tl]))
    assert ttimeline.causality_inversions_stream(iter(streamed)) == []


# --- acceptance: the spanned job's recovery across three processes -----------


def _reader(stream, out):
    for line in iter(stream.readline, ""):
        out.put(line)
    out.put(None)


def _read_status(lines, want, deadline_s=90.0):
    deadline = time.monotonic() + deadline_s
    while True:
        left = deadline - time.monotonic()
        assert left > 0, "worker status timeout"
        line = lines.get(timeout=left)
        assert line is not None, "worker stdout closed before the status"
        st = json.loads(line)
        if want(st):
            return st


def test_trace_reconstructs_recovery_timeline_across_processes(tmp_path):
    """The spanned job over two ``slotworker`` processes with tracing and
    the timeline on (``--trace-dir``, ``--timeline-dir``; the JobMaster
    is this process). Worker b is killed at a fence its mirror covers and
    its vertices are rebuilt on a. The three trace files reconstruct the
    recovery under one trace id (detect -> redeploy -> determinant fetch
    -> rebuild -> replay -> caught up), and the three timeline files
    merge with zero causality inversions: every DEPLOY, FETCH_EDGE,
    HEARTBEAT and DETERMINANT_REQUEST has its send and receive, and each
    receive orders after its send."""
    from clonos_tpu_torch.runtime import scheduler as sch
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    from clonos_tpu_torch.runtime.remote import JobMasterServer
    from test_torch_scheduler import SPEC, _line_server, _mirror_covers

    env = dict(os.environ, PYTHONPATH=_REPO)
    trace_dir = tmp_path / "traces"
    tl_dir = tmp_path / "timelines"
    trace_dir.mkdir()
    tl_dir.mkdir()
    lease = str(tmp_path / "jm.lease")
    lines = [((i * 37) % 997, 1 + i % 5) for i in range(600)]
    srv, lport, _conns = _line_server(lines)

    jm_tracer = tobs.configure("jm", path=str(trace_dir / "trace-jm.jsonl"))
    tobs.configure_timeline("jm", path=str(tl_dir / "timeline-jm.jsonl"))
    jm = JobMasterServer(heartbeat_timeout_s=2.0)
    election = FileLeaderElection(lease, "jm-0", lease_ttl_s=30.0)
    assert election.try_acquire()
    spe = 4
    runner_kw = dict(steps_per_epoch=spe, log_capacity=512, max_epochs=64,
                     inflight_ring_steps=64, seed=7, logical_time=True)
    scheduler = sch.SlotPoolScheduler(
        jm, election, SPEC, runner_kw=runner_kw, feed_batch=4,
        target_epochs=8, complete_every=2,
        checkpoint_root=str(tmp_path / "ck"), deploy_timeout_s=90.0,
        device="cpu")

    def spawn(eid):
        proc = subprocess.Popen(
            [sys.executable, "-m", "clonos_tpu_torch", "slotworker",
             "--jm", f"127.0.0.1:{jm.address[1]}",
             "--executor-id", eid, "--slots", "2", "--lease", lease,
             "--heartbeat-interval", "0.3", "--max-seconds", "110",
             "--epoch-sleep", "0.25", "--device", "cpu",
             "--trace-dir", str(trace_dir), "--timeline-dir",
             str(tl_dir)],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        q: "queue.Queue" = queue.Queue()
        threading.Thread(target=_reader, args=(proc.stdout, q),
                         daemon=True).start()
        return proc, q

    (pa, qa), (pb, qb) = spawn("a"), spawn("b")
    try:
        _read_status(qa, lambda st: "registered" in st)
        _read_status(qb, lambda st: "registered" in st)
        deadline = time.monotonic() + 30
        while {"a", "b"} - set(jm.registered()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert scheduler.deploy(external_feeds={
            0: {"kind": "socket", "host": "127.0.0.1", "port": lport,
                "num_subtasks": 1}}) == {0: "a", 1: "b"}
        _read_status(qa, lambda st: st.get("deployed") == 0)
        _read_status(qb, lambda st: st.get("deployed") == 1)
        _read_status(qa, lambda st: st.get("finished") == 0)

        def at_fence(st):
            if "group" in st and "digest" in st:
                scheduler.sync()
            return st.get("epoch", -1) >= 5 or "finished" in st

        last_step = -1
        while True:
            st = _read_status(qb, at_fence)
            assert "finished" not in st
            last_step = max(last_step, st.get("global_step", -1))
            time.sleep(0.05)
            scheduler.sync()
            pb.send_signal(signal.SIGSTOP)
            time.sleep(0.2)
            while not qb.empty():
                st = json.loads(qb.get_nowait())
                last_step = max(last_step, st.get("global_step", -1))
            if _mirror_covers(scheduler.mirrors[1],
                              str(tmp_path / "ck" / "g1"), last_step, spe):
                break
            pb.send_signal(signal.SIGCONT)
        pb.send_signal(signal.SIGKILL)
        pb.wait(timeout=15)

        deadline = time.monotonic() + 20
        while "b" not in scheduler.failed_workers():
            assert time.monotonic() < deadline, "heartbeat expiry not seen"
            time.sleep(0.1)
        assert scheduler.recover_worker("b") == {1: "a"}
        dep = _read_status(qa, lambda st: st.get("deployed") == 1)
        assert dep["recovered"] and dep["vertices"] == [2, 3]
        snap = scheduler.metrics.snapshot()
        assert snap["scheduler.recovery.redeploy-ms"]["count"] == 1
        assert snap["scheduler.recovery.determinant-fetch-ms"]["count"] == 1
        fin = _read_status(qa, lambda st: st.get("finished") == 1)
        assert fin["global_step"] == 8 * spe
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=15)
        scheduler.close()
        jm.close()
        srv.close()
        tobs.reset()
        tobs.reset_timeline()

    # --- the recovery from the three trace files ------------------------------
    T = jm_tracer.trace_id
    paths = [str(trace_dir / f"trace-{s}.jsonl") for s in ("jm", "a", "b")]
    records = tobs.load_jsonl(paths)
    ours = [r for r in records if r["trace"] == T]
    assert {r["service"] for r in ours} >= {"jm", "a", "b"}

    def first(name, service):
        for r in ours:
            if r["name"] == name and r["service"] == service:
                return r
        raise AssertionError(
            f"{name} ({service}) not in trace: "
            f"{sorted({(r['service'], r['name']) for r in ours})}")

    detect = first("recovery.detect", "jm")
    assert detect["args"]["worker"] == "b"
    redeploy = first("recovery.redeploy", "jm")
    fetch = first("recovery.determinant_fetch", "jm")
    rebuild = first("recovery.rebuild", "a")
    replay = first("recovery.replay", "a")
    caught = first("recovery.caught_up", "a")
    assert detect["ts"] <= redeploy["ts"] <= fetch["ts"]
    assert rebuild["ts"] + rebuild["dur"] <= caught["ts"] + 1e-6
    assert replay["ts"] + replay["dur"] <= caught["ts"] + 1e-6
    assert fetch["parent"] == redeploy["span"]
    doc = tobs.to_chrome(records, trace_id=T)
    assert tobs.validate_chrome(doc) > len(ours)

    # --- the merged causal timeline -------------------------------------------
    tl_paths = [str(tl_dir / f"timeline-{s}.jsonl") for s in ("jm", "a", "b")]
    merged = ttimeline.merge_records(ttimeline.read_timeline(tl_paths))
    assert ttimeline.causality_inversions(merged) == []
    assert jtimeline.causality_inversions(merged) == []
    pairs = {}
    for r in merged:
        if r["kind"] in ("msg.send", "msg.recv"):
            pairs.setdefault(r["verb"], set()).add(r["kind"])
    for verb in ("DEPLOY", "FETCH_EDGE", "HEARTBEAT",
                 "DETERMINANT_REQUEST"):
        assert pairs.get(verb) == {"msg.send", "msg.recv"}, (verb, pairs)
    # Each DEPLOY receive on a worker orders after the JobMaster's send.
    sends = {tuple(r["hlc"]): i for i, r in enumerate(merged)
             if r["kind"] == "msg.send" and r["verb"] == "DEPLOY"}
    for i, r in enumerate(merged):
        if r["kind"] == "msg.recv" and r["verb"] == "DEPLOY":
            assert sends[tuple(r["sent"])] < i
    assert any(r["kind"] == "epoch.seal" and r["service"] == "a"
               for r in merged)
    assert any(r["kind"] == "recovery.fsm" and r["service"] == "a"
               for r in merged)
