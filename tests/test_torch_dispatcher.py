"""PyTorch port, the multi-tenant dispatcher's units (mirror of the 16
tests of the reference's ``tests/test_dispatcher.py``): fair-share
admission (quotas, strict-FIFO queueing, typed rejection, slot release),
per-job lease scoping and worker-side fencing lanes, the SUBMIT_JOB /
JOB_STATUS / CANCEL_JOB wire surface, per-job cluster-metric rollups and
job-scoped slot keys. Beside them the port is held against the reference:
admission verdicts and observer streams over a seeded random sequence of
requests, cancels, drains and releases, and the wire replies to one
sequence of client calls, byte for byte. Tolerance: exact.

The CLI's per-job views are held to the reference too: ``top``'s
per-job and tenant sections render the reference's table, and ``audit
--job`` resolves a dispatcher root's ledgers with the reference's exit
codes and output.

The two-process, multi-job SIGKILL test is
``tests/test_torch_multitenant.py``; everything here runs in-process.
"""

import argparse
import json
import os

import numpy as np
import pytest

from clonos_tpu.parallel import transport as jtp
from clonos_tpu.runtime import dispatcher as jdisp
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.runtime import dispatcher as tdisp
from clonos_tpu_torch.runtime import scheduler as sch
from clonos_tpu_torch.runtime.dispatcher import (AdmissionController,
                                                 Dispatcher,
                                                 QuotaExceededError,
                                                 TenantConfig)
from clonos_tpu_torch.runtime.leader import FileLeaderElection, job_lease_path
from clonos_tpu_torch.runtime.remote import JobMasterServer

JOB = "clonos_tpu_torch.examples.wordcount:build_job"


# --- admission control -------------------------------------------------------


def test_quota_rejection_is_typed_and_counts_reservations():
    adm = AdmissionController(quotas={"red": 3}, default_quota=None)
    assert adm.request("red-001", "red", 2, free_slots=8) == "admitted"
    with pytest.raises(QuotaExceededError) as ei:
        adm.request("red-002", "red", 2, free_slots=8)
    e = ei.value
    assert (e.tenant, e.requested, e.quota, e.held) == ("red", 2, 3, 2)
    payload = e.wire_payload()
    assert payload["error_type"] == "quota-exceeded"
    assert payload["quota"] == 3 and payload["requested"] == 2
    assert adm.request("blue-005", "blue", 50, free_slots=60) == "admitted"
    assert adm.quota("blue") is None
    assert adm.request("red-003", "red", 1, free_slots=0) == "queued"
    with pytest.raises(QuotaExceededError):
        adm.request("red-004", "red", 1, free_slots=8)


def test_fifo_queueing_no_jumping_and_head_blocking():
    adm = AdmissionController()
    assert adm.request("a-001", "a", 3, free_slots=4) == "admitted"
    assert adm.request("b-002", "b", 3, free_slots=1) == "queued"
    # 1 slot IS free for this 1-slot job, but the queue is non-empty.
    assert adm.request("c-003", "c", 1, free_slots=1) == "queued"
    assert adm.queued() == ["b-002", "c-003"]
    # Strict FIFO drain: the 3-slot head blocks on 2 free slots.
    assert adm.admit_queued(free_slots=2) == []
    adm.release("a", 3)
    assert adm.held("a") == 0
    assert adm.admit_queued(free_slots=4) == ["b-002", "c-003"]
    assert adm.held("b") == 3 and adm.held("c") == 1
    assert adm.queued() == []
    adm.release("b", 99)
    assert adm.held("b") == 0


def test_cancel_queued_and_total_held():
    adm = AdmissionController()
    assert adm.request("a-001", "a", 2, free_slots=2) == "admitted"
    assert adm.request("b-002", "b", 1, free_slots=0) == "queued"
    assert adm.total_held() == 2
    assert adm.cancel_queued("b-002") is True
    assert adm.cancel_queued("b-002") is False
    assert adm.queued() == []
    assert adm.admit_queued(free_slots=8) == []


def test_cancel_of_queued_job_releases_its_quota_charge():
    adm = AdmissionController(quotas={"red": 3})
    assert adm.request("red-001", "red", 2, free_slots=0) == "queued"
    assert adm.reserved("red") == 2
    with pytest.raises(QuotaExceededError):
        adm.request("red-002", "red", 2, free_slots=8)
    assert adm.cancel_queued("red-001") is True
    assert adm.reserved("red") == 0
    assert adm.request("red-002", "red", 2, free_slots=8) == "admitted"
    assert adm.held("red") == 2


def test_double_release_clamps_and_never_mints_slots():
    adm = AdmissionController()
    assert adm.request("a-001", "a", 2, free_slots=4) == "admitted"
    adm.release("a", 2)
    assert adm.held("a") == 0
    adm.release("a", 2)
    assert adm.held("a") == 0 and adm.total_held() == 0
    assert adm.request("a-002", "a", 2, free_slots=2) == "admitted"
    assert adm.held("a") == 2


def test_admission_transition_observers_see_every_verdict():
    adm = AdmissionController(quotas={"red": 2})
    obs = []
    adm.transition_observers.append(
        lambda kind, **f: obs.append((kind, f.get("job_id",
                                                  f.get("tenant")))))
    assert adm.request("red-001", "red", 2, free_slots=2) == "admitted"
    with pytest.raises(QuotaExceededError):
        adm.request("red-002", "red", 1, free_slots=1)
    adm.release("red", 2)
    assert adm.request("red-003", "red", 1, free_slots=0) == "queued"
    assert adm.cancel_queued("red-003") is True
    assert obs == [("admit", "red-001"), ("reject", "red-002"),
                   ("release", "red"), ("queue", "red-003"),
                   ("cancel", "red-003")]


def _admission_run(mod, seed, n=300):
    """Drive ``mod``'s AdmissionController with a seeded random sequence;
    returns every verdict, its state after each call, and the observer
    stream."""
    rng = np.random.RandomState(seed)
    adm = mod.AdmissionController(quotas={"red": 4, "blue": 6},
                                  default_quota=(None if seed % 2 else 5))
    seen = []
    adm.transition_observers.append(
        lambda kind, **f: seen.append((kind, sorted(f.items()))))
    tenants = ["red", "blue", "green"]
    out = []
    for i in range(n):
        op = rng.choice(["request", "request", "drain", "cancel",
                         "release"])
        if op == "request":
            t = tenants[rng.randint(0, 3)]
            try:
                out.append(("request", adm.request(
                    f"{t}-{i:03d}", t, int(rng.randint(1, 4)),
                    free_slots=int(rng.randint(0, 8)))))
            except mod.QuotaExceededError as e:
                out.append(("reject", e.wire_payload()))
        elif op == "drain":
            out.append(("drain", adm.admit_queued(int(rng.randint(0, 8)))))
        elif op == "cancel":
            q = adm.queued()
            jid = (q[rng.randint(0, len(q))] if q and rng.rand() < 0.8
                   else "ghost-999")
            out.append(("cancel", adm.cancel_queued(jid)))
        else:
            t = tenants[rng.randint(0, 3)]
            adm.release(t, int(rng.randint(0, 4)))
            out.append(("release", t))
        out.append((adm.queued(), adm.total_held(),
                    [(t, adm.held(t), adm.reserved(t), adm.quota(t))
                     for t in tenants]))
    return out, seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_verdicts_and_observers_equal_reference(seed):
    assert _admission_run(tdisp, seed) == _admission_run(jdisp, seed)


def test_tenant_config_validation_and_from_any():
    cfg = TenantConfig.from_any({"tenant": "red", "slots": 2,
                                 "unknown_knob": 1})
    assert cfg.tenant == "red" and cfg.slots == 2
    assert cfg.max_concurrent_recoveries == 1
    assert TenantConfig.from_any(None).tenant == "default"
    assert TenantConfig.from_any(cfg) is cfg
    for bad in ("", "a.b", "a/b", "a-b"):
        with pytest.raises(ValueError):
            TenantConfig(tenant=bad)
    with pytest.raises(ValueError):
        TenantConfig(slots=0)
    with pytest.raises(TypeError):
        TenantConfig.from_any("red")
    # The same normalisation as the reference's.
    for raw in ({"tenant": "x", "slots": "3",
                 "max_concurrent_recoveries": 0, "workers": ("a", 2)},
                {"tenant": "y"}):
        a, b = TenantConfig.from_any(raw), jdisp.TenantConfig.from_any(raw)
        assert (a.tenant, a.slots, a.max_concurrent_recoveries,
                a.workers) == (b.tenant, b.slots,
                               b.max_concurrent_recoveries, b.workers)


# --- per-job leases + worker fencing lanes -----------------------------------


def test_job_lease_path_scoping():
    assert job_lease_path("/tmp/jm.lease", "") == "/tmp/jm.lease"
    assert job_lease_path("/tmp/jm.lease", None) == "/tmp/jm.lease"
    assert job_lease_path("/tmp/jm.lease", "red-001") \
        == "/tmp/jm.lease.red-001"
    with pytest.raises(ValueError, match="must not contain"):
        job_lease_path("/tmp/jm.lease", "red/001")


def _deploy_frame(tdd):
    hdr = tp.pack_json(tdd)
    return len(hdr).to_bytes(4, "little") + hdr


def test_endpoint_fencing_lanes_are_per_job(tmp_path):
    """Two jobs share one worker and one lease directory; each runs its
    own election. Job B's leader change (epoch 2) must not fence job A's
    epoch-1 DEPLOYs, while within one lane stale tokens are rejected."""
    base = str(tmp_path / "jm.lease")
    ea = FileLeaderElection(job_lease_path(base, "red-001"), "jm-a")
    assert ea.try_acquire() and ea.epoch == 1
    t = [0.0]
    b1 = FileLeaderElection(job_lease_path(base, "blue-002"), "jm-b1",
                            lease_ttl_s=2.0, clock=lambda: t[0])
    b2 = FileLeaderElection(job_lease_path(base, "blue-002"), "jm-b2",
                            lease_ttl_s=2.0, clock=lambda: t[0])
    assert b1.try_acquire() and b1.epoch == 1
    t[0] = 3.5
    assert b2.try_acquire() and b2.epoch == 2

    ep = sch.TaskExecutorEndpoint(lease_path=base)
    cl = tp.ControlClient(ep.address)
    try:
        rt, _ = cl.call(tp.DEPLOY, _deploy_frame(
            {"group": 0, "fencing_epoch": 2, "job_id": "blue-002"}))
        assert rt == tp.OK
        rt, resp = cl.call(tp.DEPLOY, _deploy_frame(
            {"group": 0, "fencing_epoch": 1, "job_id": "blue-002"}))
        assert rt == tp.ERROR
        assert "stale fencing" in tp.unpack_json(resp)["error"]
        rt, _ = cl.call(tp.DEPLOY, _deploy_frame(
            {"group": 0, "fencing_epoch": 1, "job_id": "red-001"}))
        assert rt == tp.OK
        rt, resp = cl.call(tp.DEPLOY, _deploy_frame(
            {"group": 0, "fencing_epoch": 1}))
        assert rt == tp.ERROR
        assert "lease claim" in tp.unpack_json(resp)["error"]
        jobs = {ep.queue.get_nowait().get("job_id") for _ in range(2)}
        assert jobs == {"blue-002", "red-001"}
    finally:
        cl.close()
        ep.close()


# --- dispatcher intake (wire + direct) ---------------------------------------


class _StubJM:
    """JobMasterServer stand-in for admission tests: advertised slots
    and expiry only (no sockets, no workers)."""

    def __init__(self, slots=None, expired=()):
        self._slots = dict(slots or {})
        self._expired = list(expired)

    def slots(self):
        return dict(self._slots)

    def expired(self):
        return list(self._expired)

    def cluster_metrics(self):
        return {}

    def close(self):
        pass


def _dispatcher(tmp_path, jm, serve=False, mod=tdisp, **kw):
    if mod is tdisp:
        kw["device"] = "cpu"
    return mod.Dispatcher(lease_path=str(tmp_path / "jm.lease"),
                          checkpoint_root=str(tmp_path / "ck"),
                          jm=jm, serve=serve, **kw)


def test_submit_mints_deterministic_job_ids_and_states(tmp_path):
    disp = _dispatcher(tmp_path, _StubJM(slots={"a": 4}))
    try:
        r1 = disp.submit_job(JOB, {"tenant": "red", "slots": 2})
        assert r1 == {"job_id": "red-001", "state": "ADMITTED"}
        r2 = disp.submit_job(JOB, {"tenant": "blue", "slots": 2})
        assert r2 == {"job_id": "blue-002", "state": "ADMITTED"}
        r3 = disp.submit_job(JOB, {"tenant": "red", "slots": 1})
        assert r3["state"] == "QUEUED"
        assert disp.admission.queued() == ["red-003"]
        assert disp.cancel_job("red-001")["state"] == "CANCELLED"
        assert disp.admission.held("red") == 0
        assert disp.cancel_job("red-003")["state"] == "CANCELLED"
        assert disp.admission.queued() == []
        with pytest.raises(KeyError, match="unknown job"):
            disp.cancel_job("nope-999")
        states = {j["job_id"]: j["state"] for j in disp.jobs()}
        assert states == {"red-001": "CANCELLED", "blue-002": "ADMITTED",
                          "red-003": "CANCELLED"}
    finally:
        disp.close()


def test_wire_submit_status_cancel_and_typed_quota_error(tmp_path):
    disp = _dispatcher(tmp_path, _StubJM(), serve=True, quotas={"red": 1})
    cl = tp.ControlClient(disp.address)
    try:
        res = cl.call_json(tp.SUBMIT_JOB, {
            "job": JOB, "tenant_config": {"tenant": "red", "slots": 1}})
        assert res == {"job_id": "red-001", "state": "QUEUED"}
        rt, resp = cl.call(tp.SUBMIT_JOB, tp.pack_json({
            "job": JOB, "tenant_config": {"tenant": "red", "slots": 1}}))
        body = tp.unpack_json(resp)
        assert rt == tp.ERROR
        assert body["error_type"] == "quota-exceeded"
        assert body["tenant"] == "red" and body["quota"] == 1
        st = cl.call_json(tp.JOB_STATUS, {"job_id": "red-001"})
        assert st["state"] == "QUEUED" and st["tenant"] == "red"
        rt, resp = cl.call(tp.JOB_STATUS, tp.pack_json(
            {"job_id": "ghost-7"}))
        assert rt == tp.ERROR
        assert "red-001" in tp.unpack_json(resp)["error"]
        allj = cl.call_json(tp.JOB_STATUS, {})
        assert [j["job_id"] for j in allj["jobs"]] == ["red-001"]
        res = cl.call_json(tp.CANCEL_JOB, {"job_id": "red-001"})
        assert res["state"] == "CANCELLED"
        assert disp.admission.queued() == []
    finally:
        cl.close()
        disp.close()


def test_wire_replies_equal_reference(tmp_path):
    """One sequence of client calls gets byte-identical replies from the
    port's dispatcher and the reference's (the job spec is carried, not
    resolved, before deployment)."""
    calls = [
        (tp.SUBMIT_JOB, {"job": JOB, "tenant_config": {
            "tenant": "red", "slots": 2, "workers": ["a"]}}),
        (tp.SUBMIT_JOB, {"job": JOB, "target_epochs": 3,
                         "tenant_config": {"tenant": "blue", "slots": 3}}),
        (tp.SUBMIT_JOB, {"job": JOB, "tenant_config": {
            "tenant": "red", "slots": 2}}),
        (tp.SUBMIT_JOB, {"job": JOB, "tenant_config": {
            "tenant": "green", "slots": 1}}),
        (tp.JOB_STATUS, {"job_id": "blue-002"}),
        (tp.JOB_STATUS, {"job_id": "ghost-1"}),
        (tp.CANCEL_JOB, {"job_id": "blue-002"}),
        (tp.CANCEL_JOB, {"job_id": "red-001"}),
        (tp.JOB_STATUS, {}),
        (99, {}),
    ]
    replies = {}
    for name, mod, tmod in (("port", tdisp, tp), ("ref", jdisp, jtp)):
        disp = _dispatcher(tmp_path / name, _StubJM(slots={"a": 4}),
                           serve=True, mod=mod, quotas={"red": 3})
        cl = tmod.ControlClient(disp.address)
        try:
            replies[name] = [cl.call(m, tmod.pack_json(body))
                             for m, body in calls]
            replies[name].append(sorted(disp.metrics_extra().items()))
        finally:
            cl.close()
            disp.close()
    assert replies["port"] == replies["ref"]


def test_metrics_extra_reports_tenant_gauges(tmp_path):
    disp = _dispatcher(tmp_path, _StubJM(slots={"a": 4}),
                       quotas={"red": 3})
    try:
        disp.submit_job(JOB, {"tenant": "red", "slots": 2})
        disp.submit_job(JOB, {"tenant": "blue", "slots": 4})   # queued
        m = disp.metrics_extra()
        assert m["tenant.red.slots-held"] == 2
        assert m["tenant.red.quota"] == 3
        assert m["tenant.red.jobs-running"] == 1
        assert m["tenant.blue.jobs-queued"] == 1
        assert m["tenant.blue.slots-held"] == 0
        assert m["dispatcher.queue-depth"] == 1
        assert m["dispatcher.jobs-total"] == 2
    finally:
        disp.close()


def test_dispatcher_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        Dispatcher(lease_path=str(tmp_path / "jm.lease"),
                   jm=_StubJM(), serve=False)


# --- per-job cluster rollups -------------------------------------------------


def test_cluster_metrics_rolls_up_per_job(tmp_path):
    jm = JobMasterServer(heartbeat_timeout_s=5.0)
    try:
        with jm._lock:
            jm._hb_metrics["a"] = {
                "job.red-001.group.0.job.wc.audit.epochs-sealed": 4,
                "job.red-001.group.0.job.wc.audit.epochs-validated": 2,
                "job.red-001.group.0.job.wc.audit.divergences": 0,
                "job.blue-002.group.0.job.wc.records-total": 10,
                "job.blue-002.group.1.job.wc.records-total": 12,
                "group.0.job.legacy.audit.epochs-sealed": 3,
            }
            jm._slots["a"] = 2
        out = jm.cluster_metrics()
        assert out["cluster.job.red-001.groups"] == 1
        assert out["cluster.job.red-001.audit.epochs-sealed"] == 4
        assert out["cluster.job.red-001.audit.exactly-once-ok"] == 1
        assert out["cluster.job.blue-002.groups"] == 2
        assert "cluster.job.blue-002.audit.epochs-sealed" not in out
        assert out["cluster.audit.epochs-sealed"] == 7
    finally:
        jm.close()


# --- shared-pool slot keying -------------------------------------------------


def test_slot_pool_job_scoped_keys_share_one_pool():
    pool = sch.SlotPool()
    pool.sync_offers({"a": 2, "b": 2})
    sa = pool.allocate(("red-001", 0), prefer="a")
    sb = pool.allocate(("blue-002", 0), prefer="a")
    assert sa.worker_id == "a" and sb.worker_id == "a"
    assert pool.placements() == {("red-001", 0): "a",
                                 ("blue-002", 0): "a"}
    pool.release_group(("red-001", 0))
    assert pool.placements() == {("blue-002", 0): "a"}
    pool.allocate(("red-001", 0), prefer="a")
    assert sorted(pool.drop_worker("a")) == [("blue-002", 0),
                                             ("red-001", 0)]
    assert pool.drop_worker("a") == []


# --- the CLI's per-job views -------------------------------------------------


def test_top_table_renders_per_job_and_tenant_sections():
    from clonos_tpu.cli import _top_table as jtop
    from clonos_tpu_torch.cli import _top_rows, _top_table

    snap = {
        "worker.a.slots": 4,
        "worker.a.job.red-001.group.0.job.wc.audit.epochs-sealed": 4,
        "cluster.job.red-001.groups": 1,
        "cluster.job.red-001.audit.epochs-sealed": 4,
        "cluster.job.red-001.audit.epochs-validated": 2,
        "cluster.job.red-001.audit.divergences": 0,
        "cluster.job.red-001.audit.exactly-once-ok": 1,
        "cluster.audit.exactly-once-ok": 1,
        "tenant.red.slots-held": 1,
        "tenant.red.quota": 2,
        "dispatcher.queue-depth": 0,
    }
    rows = _top_rows(snap)
    assert rows["a"]["groups"] == {"red-001:g0"}
    assert rows["a"]["sealed"] == 4
    out = _top_table(snap)
    assert out == jtop(snap)
    assert "XONCE" in out and "red-001" in out
    assert "tenant.red.slots-held=1" in out
    assert "dispatcher.queue-depth=0" in out
    cluster_line = [ln for ln in out.splitlines()
                    if ln.startswith("cluster: ")]
    assert cluster_line and "job.red-001" not in cluster_line[0]


def _write_ledger(path, epochs=3):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ep in range(epochs):
            f.write(json.dumps({"epoch": ep, "combined": f"d{ep}",
                                "records": 8 * (ep + 1),
                                "channels": {}, "det_counts": {}}) + "\n")


def _audit_args(**kw):
    base = dict(dir="", diff=None, job=None, report="text", json=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _audit_both(capsys, **kw):
    """The port's ``cmd_audit`` and the reference's on the same
    arguments: their exit codes and outputs must be equal."""
    from clonos_tpu.cli import cmd_audit as jaudit
    from clonos_tpu_torch.cli import cmd_audit
    rc = cmd_audit(_audit_args(**kw))
    out = capsys.readouterr()
    assert (rc, out.out, out.err) == (
        jaudit(_audit_args(**kw)), *capsys.readouterr())
    return rc, out.out, out.err


def test_audit_job_scoped_ledgers_and_ambiguity(tmp_path, capsys):
    from clonos_tpu_torch.cli import _find_ledgers, _ledger_job_ids

    root = tmp_path / "ck"
    _write_ledger(str(root / "red-001" / "g0" / "ledger.jsonl"))
    _write_ledger(str(root / "blue-002" / "g0" / "ledger.jsonl"))
    ledgers = _find_ledgers(str(root))
    assert [lab for lab, _ in ledgers] == [
        os.path.join("blue-002", "g0", "ledger.jsonl"),
        os.path.join("red-001", "g0", "ledger.jsonl")]
    assert _ledger_job_ids(ledgers) == ["blue-002", "red-001"]

    rc, out, _ = _audit_both(capsys, dir=str(root), job="red-001")
    assert rc == 0 and "g0" in out and "blue-002" not in out
    rc, _, err = _audit_both(capsys, dir=str(root), job="nope-9")
    assert rc == 2 and "available job ids: blue-002, red-001" in err
    rc, _, err = _audit_both(capsys, dir=str(root), diff=str(root))
    assert rc == 2 and "ambiguous" in err

    single = tmp_path / "single"
    _write_ledger(str(single / "g0" / "ledger.jsonl"))
    rc, out, _ = _audit_both(capsys, dir=str(root), diff=str(single),
                             job="red-001")
    assert rc == 0 and "ledgers match" in out
    bad = tmp_path / "bad"
    _write_ledger(str(bad / "g0" / "ledger.jsonl"), epochs=2)
    assert _audit_both(capsys, dir=str(root), diff=str(bad),
                       job="red-001")[0] == 1
    assert _audit_both(capsys, dir=str(root), diff=str(bad),
                       job="red-001", report="json")[0] == 1
