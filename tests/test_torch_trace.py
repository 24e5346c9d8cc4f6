"""PyTorch port, tracing and the recovery flight recorder: mirrors of the
in-process halves of the reference's ``tests/test_obs.py`` (tracer core,
context adoption, Chrome conversion, checkpoint and epoch lifecycles),
plus parity with the reference on the same inputs: the multiset of trace
records a job emits through a window recovery, and the Chrome document
and summary of one seeded record list. Records are compared as (name,
phase, sorted arg keys, integer arg values): timestamps, durations, ids,
pids and thread ids are dropped. Tolerance: exact."""

import collections
import json

import numpy as np
import pytest

from clonos_tpu import obs as jobs
from clonos_tpu.api.environment import StreamEnvironment as JaxEnv
from clonos_tpu.runtime.cluster import ClusterRunner as JaxRunner
from clonos_tpu_torch import obs
from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.runtime.cluster import ClusterRunner

KW = dict(steps_per_epoch=8, log_capacity=512, max_epochs=8,
          inflight_ring_steps=32, seed=3, logical_time=True)


@pytest.fixture(autouse=True)
def _null_tracer_after():
    """Every test leaves both packages' process tracers disabled."""
    yield
    obs.reset()
    jobs.reset()


# --- tracer core -------------------------------------------------------------


def test_tracer_spans_nest_backdate_and_persist(tmp_path):
    t = [100.0]
    path = str(tmp_path / "t.jsonl")
    tr = obs.Tracer("svc", path=path, clock=lambda: t[0])
    with tr.span("outer", epoch=3) as outer:
        t[0] += 1.0
        with tr.span("inner") as inner:
            t[0] += 0.5
        tr.event("mark", k=7)
    t[0] += 2.0
    tr.complete("measured", 2.0, phase="replay")
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")

    recs = tr.records()
    assert [r["name"] for r in recs] == ["inner", "mark", "outer",
                                        "measured", "boom"]
    by = {r["name"]: r for r in recs}
    assert by["inner"]["parent"] == outer.span_id
    assert by["inner"]["span"] == inner.span_id
    assert by["mark"]["parent"] == outer.span_id
    assert by["outer"]["parent"] is None
    assert by["outer"]["ph"] == "X"
    assert by["outer"]["ts"] == 100.0
    assert by["outer"]["dur"] == 1.5
    assert by["inner"]["ts"] == 101.0
    assert by["inner"]["dur"] == 0.5
    assert by["mark"]["ph"] == "i" and by["mark"]["args"] == {"k": 7}
    assert by["measured"]["ts"] == 101.5
    assert by["measured"]["dur"] == 2.0
    assert "ValueError" in by["boom"]["args"]["error"]
    assert {r["trace"] for r in recs} == {tr.trace_id}
    assert {r["service"] for r in recs} == {"svc"}
    # Flushed per record: the file is complete before close.
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["name"] for ln in lines] == [r["name"] for r in recs]
    tr.close()

    small = obs.Tracer("s2", clock=lambda: t[0], buffer=4)
    for i in range(9):
        small.event(f"e{i}")
    assert [r["name"] for r in small.records()] == ["e5", "e6", "e7", "e8"]
    assert small.dropped == 5


def test_span_stacks_are_per_thread():
    """A span opened on another thread (the fence worker, the finalize
    barrier) never nests under the main thread's open span."""
    import threading
    tr = obs.Tracer("svc", clock=lambda: 0.0)
    with tr.span("main") as main:
        th = threading.Thread(target=lambda: tr.complete("worker", 0.0))
        th.start()
        th.join(timeout=30)
        tr.event("main.event")
    assert not th.is_alive()
    by = {r["name"]: r for r in tr.records()}
    assert by["worker"]["parent"] is None
    assert by["main.event"]["parent"] == main.span_id


def test_context_adoption_and_null_tracer_zero_overhead():
    tr0 = obs.get_tracer()
    assert isinstance(tr0, obs.NullTracer) and not tr0.enabled
    with tr0.span("x") as s:
        assert s.span_id is None
    tr0.event("y")
    tr0.complete("z", 1.0)
    assert tr0.records() == [] and tr0.wire_context() is None

    jm = obs.configure("jm")
    with jm.span("deploy", group=1) as sp:
        ctx = jm.wire_context()
    assert ctx == {"trace_id": jm.trace_id, "span": sp.span_id}

    worker = obs.Tracer("worker-a")
    assert worker.trace_id != jm.trace_id
    worker.adopt(ctx)
    worker.event("recovery.caught_up", group=1)
    assert worker.records()[0]["trace"] == jm.trace_id
    worker.adopt(None)
    assert worker.trace_id == jm.trace_id
    obs.reset()
    assert not obs.get_tracer().enabled


# --- Chrome conversion -------------------------------------------------------


def test_chrome_conversion_and_validation(tmp_path):
    t = [50.0]
    jm_path = str(tmp_path / "trace-jm.jsonl")
    jm = obs.Tracer("jm", path=jm_path, clock=lambda: t[0])
    jm.event("recovery.detect", worker="b")
    with jm.span("recovery.redeploy", worker="b"):
        t[0] += 0.25
    jm.close()
    wk_path = str(tmp_path / "trace-a.jsonl")
    wk = obs.Tracer("a", path=wk_path, trace_id=jm.trace_id,
                    clock=lambda: t[0])
    wk.complete("recovery.replay", 0.1)
    wk.close()

    records = obs.load_jsonl([jm_path, wk_path])
    assert len(records) == 3
    assert records == sorted(records, key=lambda r: r["ts"])
    doc = obs.to_chrome(records)
    n = obs.validate_chrome(doc)
    evs = doc["traceEvents"]
    assert n == len(evs)
    metas = [e for e in evs if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"jm", "a"}
    redeploy = next(e for e in evs
                    if e["ph"] == "X" and e["name"] == "recovery.redeploy")
    assert redeploy["dur"] == 0.25 * 1e6
    assert all(e["s"] == "p" for e in evs if e["ph"] == "i")
    assert redeploy["args"]["trace"] == jm.trace_id

    other = obs.Tracer("x")
    other.event("noise")
    only = obs.to_chrome(records + other.records(), trace_id=jm.trace_id)
    assert all(e["ph"] == "M" or e["args"]["trace"] == jm.trace_id
               for e in only["traceEvents"])

    with pytest.raises(ValueError, match="traceEvents"):
        obs.validate_chrome({})
    with pytest.raises(ValueError, match="unknown ph"):
        obs.validate_chrome({"traceEvents": [
            {"ph": "Z", "name": "x", "ts": 0, "pid": 1, "tid": 1}]})
    with pytest.raises(ValueError, match="dur"):
        obs.validate_chrome({"traceEvents": [
            {"ph": "X", "name": "x", "ts": 0, "pid": 1, "tid": 1,
             "dur": -1}]})

    s = obs.summarize(records)
    assert s["records"] == 3 and s["main_trace"] == jm.trace_id
    assert s["names"]["recovery.redeploy"]["count"] == 1
    assert [e["name"] for e in s["timeline"]] == [
        "recovery.detect", "recovery.redeploy", "recovery.replay"]

    # A torn final line (a killed writer) is dropped; an earlier one
    # raises with the file and line.
    with open(wk_path, "a") as f:
        f.write('{"ts": 1, "na')
    assert len(obs.load_jsonl([jm_path, wk_path])) == 3
    with open(wk_path, "a") as f:
        f.write('\n{"ts": 2, "name": "late"}\n')
    with pytest.raises(ValueError, match="trace-a.jsonl:2"):
        obs.load_jsonl(wk_path)


def _seeded_records(seed=11, n=40):
    rs = np.random.RandomState(seed)
    names = ["epoch", "epoch.steps", "epoch.fence", "checkpoint",
             "checkpoint.trigger", "recovery.replay"]
    out = []
    for i in range(n):
        ph = "X" if rs.randint(2) else "i"
        rec = {"ts": float(rs.randint(0, 10 ** 6)) / 1e3,
               "name": names[rs.randint(len(names))], "ph": ph,
               "trace": f"{rs.randint(3):016x}",
               "service": ["runner", "jm", None][rs.randint(3)],
               "pid": int(rs.randint(1, 4)), "tid": int(rs.randint(0, 9)),
               "span": f"{i:016x}",
               "parent": None if rs.randint(2) else f"{i - 1:016x}"}
        if ph == "X":
            rec["dur"] = float(rs.randint(-5, 10 ** 4)) / 1e6
        if rs.randint(2):
            rec["args"] = {"epoch": int(rs.randint(9)),
                           "drill": bool(rs.randint(2))}
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_chrome_export_matches_reference(seed, tmp_path):
    """``load_jsonl`` / ``to_chrome`` / ``validate_chrome`` /
    ``summarize`` of one seeded record list: the port's results equal
    the reference's."""
    from clonos_tpu.obs import chrome as ref_chrome
    from clonos_tpu_torch.obs import chrome
    recs = _seeded_records(seed)
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    loaded = chrome.load_jsonl(path)
    assert loaded == ref_chrome.load_jsonl(path)
    main = loaded[0]["trace"]
    for tid in (None, main):
        doc = chrome.to_chrome(loaded, trace_id=tid)
        assert doc == ref_chrome.to_chrome(loaded, trace_id=tid)
        assert chrome.validate_chrome(doc) \
            == ref_chrome.validate_chrome(doc) > 0
    assert chrome.summarize(loaded) == ref_chrome.summarize(loaded)


# --- lifecycle instrumentation, in-process -----------------------------------


def test_checkpoint_lifecycle_traced_with_latency():
    from clonos_tpu_torch.runtime.checkpoint import (
        CheckpointCoordinator, InMemoryCheckpointStorage)

    tr = obs.configure("runner")
    co = CheckpointCoordinator(InMemoryCheckpointStorage(), num_subtasks=2)
    carry = {"w": np.zeros(4, np.float32)}
    co.trigger(7, carry, async_write=False, owned=True)
    co.ack(7, 0)
    assert 7 not in co.completion_latency_s
    co.ack(7, 1)
    assert co.completion_latency_s[7] >= 0.0

    recs = tr.records()
    names = [r["name"] for r in recs]
    assert names.index("checkpoint.trigger") \
        < names.index("checkpoint") < names.index("checkpoint.truncate")
    ck = next(r for r in recs if r["name"] == "checkpoint")
    assert ck["ph"] == "X" and ck["args"]["cid"] == 7
    assert ck["args"]["size_bytes"] == 16
    assert ck["dur"] == co.completion_latency_s[7]

    for cid in range(100, 170):
        co.trigger(cid, carry, async_write=False, owned=True)
        co.ack_all(cid)
    assert len(co.completion_latency_s) <= 64
    assert 169 in co.completion_latency_s


def test_epoch_spans_and_histograms_in_process(tmp_path):
    tr = obs.configure("runner")
    env = StreamEnvironment(name="obsjob", num_key_groups=8)
    env.synthetic_source(vocab=7, batch_size=4, parallelism=1)
    r = ClusterRunner(env.build(), steps_per_epoch=2,
                      checkpoint_dir=str(tmp_path / "ck"),
                      log_capacity=256, max_epochs=8, seed=2,
                      logical_time=True, device="cpu")
    r.run_epoch(complete_checkpoint=True)
    r.run_epoch(complete_checkpoint=True)

    recs = tr.records()
    names = [rec["name"] for rec in recs]
    for want in ("epoch", "epoch.steps", "epoch.fence",
                 "checkpoint.trigger", "checkpoint", "checkpoint.truncate",
                 "epoch.inflight_truncate"):
        assert want in names, f"missing {want} in {sorted(set(names))}"
    epoch0 = next(rec for rec in recs if rec["name"] == "epoch")
    assert epoch0["args"]["epoch"] == 0
    steps0 = next(rec for rec in recs if rec["name"] == "epoch.steps")
    fence0 = next(rec for rec in recs if rec["name"] == "epoch.fence")
    assert steps0["parent"] == epoch0["span"]
    assert fence0["parent"] == epoch0["span"]
    assert epoch0["dur"] >= steps0["dur"]

    snap = r.metrics.snapshot()
    assert snap["job.obsjob.epoch.steps-ms"]["count"] == 2
    assert snap["job.obsjob.epoch.fence-ms"]["count"] == 2
    assert snap["job.obsjob.checkpoint.trigger-to-complete-ms"]["count"] >= 1
    assert snap["job.obsjob.epoch.steps-ms"]["p99"] >= 0.0


# --- parity with the reference ----------------------------------------------


def _window_job(env_cls):
    env = env_cls(name="tr", num_key_groups=8)
    (env.synthetic_source(vocab=11, batch_size=4, parallelism=2)
        .key_by()
        .window_count(num_keys=11, window_size=1 << 30)
        .sink())
    return env.build()


#: counters the port adds to two recovery phase spans; the reference's
#: spans carry none
PORT_COUNTERS = {"recovery.fetch_determinants": ("rows", "host_rows"),
                 "recovery.replay": ("steps", "rows", "async", "inputs",
                                     "rank_launches")}


def _record_key(rec, strip=()):
    args = {k: v for k, v in (rec.get("args") or {}).items()
            if k not in strip}
    ints = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in args.items() if isinstance(v, (int, list))))
    return (rec["name"], rec["ph"], tuple(sorted(args)), ints)


def _traced_run(mod, runner, counters=None):
    """The records' keys, with the ``counters`` (span name -> arg names)
    left out, and the recovery's report."""
    tr = mod.configure("runner")
    counters = counters or {}
    try:
        runner.run_epoch(complete_checkpoint=True)
        runner.run_epoch(complete_checkpoint=False)
        runner.inject_failure([2 + 1])
        report = runner.recover()
        runner.run_epoch(complete_checkpoint=True)
        recs = tr.records()
        for name, keys in counters.items():
            # Each phase's span for the failed subtask carries them.
            assert any(set(keys) <= set(r.get("args") or {})
                       for r in recs if r["name"] == name), name
        return collections.Counter(
            _record_key(r, counters.get(r["name"], ())) for r in recs), \
            report
    finally:
        mod.reset()


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlapped-finalize", "sequential-finalize"])
def test_trace_records_match_reference(tmp_path, overlap):
    """The same job under the sequential fence (audit on, checkpoints on
    disk), one window subtask recovered across a pending checkpoint: of
    the names the reference emits, the port emits exactly the
    reference's records — spans, instants, their arg keys and integer
    arg values, each as often — but for the row and step counters it
    adds to ``recovery.fetch_determinants`` and ``recovery.replay``. Its
    other records are its own spans at the block and patch
    boundaries."""
    port = ClusterRunner(_window_job(StreamEnvironment), device="cpu",
                         audit=True, overlap_recovery=overlap,
                         checkpoint_dir=str(tmp_path / "port"), **KW)
    ref = JaxRunner(_window_job(JaxEnv), heartbeat_timeout_s=600.0,
                    audit=True, overlap_recovery=overlap,
                    checkpoint_dir=str(tmp_path / "ref"), **KW)
    got, report = _traced_run(obs, port, PORT_COUNTERS)
    want, _ = _traced_run(jobs, ref)
    ref_names = {k[0] for k in want}
    assert collections.Counter(
        {k: n for k, n in got.items() if k[0] in ref_names}) == want
    names = {k[0] for k in got}
    assert names - ref_names == {"block.inputs", "block.run",
                                 "block.listeners", "recovery.patch.log",
                                 "recovery.patch.lane"}
    assert {f"recovery.{p}" for p in report.phase_ms
            if p != "finalize.overlap-saved"} <= names
    assert {"epoch", "epoch.steps", "epoch.fence", "checkpoint",
            "checkpoint.trigger", "checkpoint.truncate", "recovery",
            "recovery.fsm", "recovery.audit.match"} <= names
