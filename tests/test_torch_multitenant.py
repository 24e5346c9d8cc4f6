"""PyTorch port, multi-tenant acceptance (mirror of the reference's
``tests/test_multitenant.py``): many jobs, one slot pool, contained blast
radius.

A real two-process cluster: ``python -m clonos_tpu_torch slotworker
--device cpu`` processes ``a`` (4 slots) and ``b`` (2 slots) under one
in-process port ``Dispatcher``. Three tenants submit the port's wordcount
job (one over the control wire): red and blue land on ``b``, green on
``a``. Worker ``b`` is SIGKILLed; the dispatcher recovers red and blue
INDEPENDENTLY onto ``a`` — each with its own job-tagged trace, its own
``<root>/<job_id>/`` checkpoint and ledger tree, causal replay
bit-identical to the dead worker's reported fences and to a no-failure
control — while green is never redeployed and keeps fencing at a bounded
cadence through the recovery storm. Worker ``b`` is killed only at a
moment both mirrors cover (the reference test kills on sight, which can
leave a mirror one fence behind a completed checkpoint; the reference's
rebuild then lands on a wrong state, and the port's restores the older
checkpoint the mirror starts at, ``tests/test_torch_remote.py``).
Afterwards the audit rollups prove exactly-once per job, and the CLI's
``audit --job`` resolves one job's ledgers while an unscoped diff over
the multi-job root refuses as ambiguous. Tolerance: exact.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.cli import cmd_audit
from clonos_tpu_torch.examples import wordcount as twc
from clonos_tpu_torch.obs import configure_audit, reset_audit
from clonos_tpu_torch.parallel import transport as tp
from clonos_tpu_torch.runtime.checkpoint import FileCheckpointStorage
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.dispatcher import Dispatcher

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: digests are a pure function of (job, seed, records) under the logical
#: clock, so every tenant's run (and the control) is comparable bit for
#: bit
RUNNER_KW = dict(steps_per_epoch=4, log_capacity=512, max_epochs=64,
                 inflight_ring_steps=64, seed=7, logical_time=True)

JOB = "clonos_tpu_torch.examples.wordcount:build_job"   # no feeds


def _mirror_covers(mirror, ckdir, step, spe):
    """A rebuild from ``mirror`` and the checkpoints in ``ckdir`` lands
    on global step ``step`` only when the mirror's rows run from the
    newest completed checkpoint's fence (its log head) to ``step``."""
    storage = FileCheckpointStorage(ckdir)
    done = storage.completed_ids()
    if not done:
        return False
    heads = np.asarray(storage.read(max(done)).carry.log_heads)
    rows, start = mirror.rows_with_start(0)
    fence = (max(done) + 1) * spe
    return (start == int(heads[0]) and fence + len(
        det.sync_anchors(np.asarray(rows, np.int32))) == step)


def _fences(events, jid):
    """(t, status) pairs of job ``jid``'s epoch-fence reports."""
    return [(t, s) for t, s in events
            if s.get("job") == jid and "group" in s and "digest" in s]


def test_two_tenants_recover_independently_third_unharmed(tmp_path):
    env = dict(os.environ, PYTHONPATH=_REPO)
    lease = str(tmp_path / "jm.lease")
    ckroot = str(tmp_path / "ck")
    tracedir = str(tmp_path / "traces")

    configure_audit(on_divergence="warn")
    disp = Dispatcher(lease_path=lease, checkpoint_root=ckroot,
                      runner_kw=RUNNER_KW, target_epochs=8,
                      complete_every=2, deploy_timeout_s=90.0,
                      trace_dir=tracedir, heartbeat_timeout_s=2.0,
                      device="cpu")

    def spawn(eid, slots):
        return subprocess.Popen(
            [sys.executable, "-m", "clonos_tpu_torch", "slotworker",
             "--jm", f"127.0.0.1:{disp.jm.address[1]}",
             "--executor-id", eid, "--slots", str(slots),
             "--lease", lease, "--heartbeat-interval", "0.3",
             "--max-seconds", "115", "--epoch-sleep", "0.25",
             "--device", "cpu"],
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)

    pa, pb = spawn("a", 4), spawn("b", 2)
    lk = threading.Lock()
    ev_a, ev_b = [], []

    def reader(proc, out):
        for line in iter(proc.stdout.readline, ""):
            try:
                st = json.loads(line)
            except ValueError:
                continue
            with lk:
                out.append((time.monotonic(), st))

    ta = threading.Thread(target=reader, args=(pa, ev_a), daemon=True)
    tb = threading.Thread(target=reader, args=(pb, ev_b), daemon=True)
    ta.start()
    tb.start()

    def pump(pred, deadline_s, what):
        """Drive the dispatcher loop until ``pred`` over the two workers'
        status streams returns something truthy."""
        deadline = time.monotonic() + deadline_s
        while True:
            disp.step()
            with lk:
                ea, eb = list(ev_a), list(ev_b)
            got = pred(ea, eb)
            if got:
                return got
            assert time.monotonic() < deadline, f"timeout: {what}"
            time.sleep(0.05)

    try:
        deadline = time.monotonic() + 30
        while {"a", "b"} - set(disp.jm.registered()):
            assert time.monotonic() < deadline, "workers never registered"
            time.sleep(0.05)
        assert disp.jm.info("a")["device"] == "cpu"
        assert disp.jm.info("b")["device"] == "cpu"

        cl = tp.ControlClient(disp.address)
        rx = cl.call_json(tp.SUBMIT_JOB, {
            "job": JOB, "target_epochs": 20,
            "tenant_config": {"tenant": "red", "slots": 1,
                              "workers": ["b"]}})
        cl.close()
        assert rx == {"job_id": "red-001", "state": "ADMITTED"}
        ry = disp.submit_job(JOB, {"tenant": "blue", "slots": 1,
                                   "workers": ["b"]}, target_epochs=20)
        rz = disp.submit_job(JOB, {"tenant": "green", "slots": 1,
                                   "workers": ["a"]}, target_epochs=30)
        assert ry["job_id"] == "blue-002" and rz["job_id"] == "green-003"

        def deployed(ea, eb):
            dx = [s for _, s in eb if s.get("deployed") == 0
                  and s.get("job") == "red-001"]
            dy = [s for _, s in eb if s.get("deployed") == 0
                  and s.get("job") == "blue-002"]
            dz = [s for _, s in ea if s.get("deployed") == 0
                  and s.get("job") == "green-003"]
            return (dx[0], dy[0], dz[0]) if dx and dy and dz else None

        dx, dy, dz = pump(deployed, 60, "initial deploys")
        for d in (dx, dy, dz):
            assert d["vertices"] == [0, 1, 2] and not d["recovered"]
        assert disp.pool.placements() == {("red-001", 0): "b",
                                          ("blue-002", 0): "b",
                                          ("green-003", 0): "a"}
        assert all(j["state"] == "RUNNING" for j in disp.jobs())

        def ripe(ea, eb):
            ex = _fences(eb, "red-001")
            ey = _fences(eb, "blue-002")
            ez = _fences(ea, "green-003")
            return (ex and ey and len(ez) >= 4
                    and max(s["epoch"] for _, s in ex) >= 5
                    and max(s["epoch"] for _, s in ey) >= 5)

        # Kill b only where its rebuilds reproduce a reported fence: sync
        # the mirrors (each endpoint refreshes just after its status
        # line), stop b, let its printed lines arrive, and kill it if each
        # mirror covers its job's last reported step; else resume it and
        # try again a little later.
        while True:
            pump(ripe, 60, "pre-kill epochs")
            time.sleep(0.05)
            disp.step()
            pb.send_signal(signal.SIGSTOP)
            time.sleep(0.2)
            with lk:
                n_b = len(ev_b)
                covered = all(_mirror_covers(
                    disp._jobs[jid].scheduler.mirrors[0],
                    os.path.join(ckroot, jid, "g0"),
                    max(s["global_step"] for _, s in _fences(ev_b, jid)),
                    RUNNER_KW["steps_per_epoch"])
                    for jid in ("red-001", "blue-002"))
            if covered:
                break
            pb.send_signal(signal.SIGCONT)
        t_kill = time.monotonic()
        pb.send_signal(signal.SIGKILL)
        pb.wait(timeout=15)
        tb.join(timeout=30)          # EOF: every fence b reported is in
        assert not tb.is_alive()

        with lk:
            eb = list(ev_b)
        assert len(eb) == n_b, "b printed past the moment it was stopped"
        digests_b = {jid: {s["global_step"]: s["digest"]
                           for _, s in _fences(eb, jid)}
                     for jid in ("red-001", "blue-002")}

        def recovered(ea, eb):
            out = {}
            for _, s in ea:
                if s.get("deployed") == 0 and s.get("recovered"):
                    out[s.get("job")] = s
            if {"red-001", "blue-002"} <= set(out):
                return out
            return None

        rec = pump(recovered, 60, "independent recoveries")
        t_rec = time.monotonic()

        for jid in ("red-001", "blue-002"):
            d = rec[jid]
            assert d["vertices"] == [0, 1, 2]
            assert d["global_step"] > 0
            assert d["global_step"] in digests_b[jid], \
                f"{jid}: recovery fence never reported by dead worker"
            assert d["digest"] == digests_b[jid][d["global_step"]]

        with lk:
            ea = list(ev_a)
        dz_all = [s for _, s in ea if s.get("deployed") == 0
                  and s.get("job") == "green-003"]
        assert len(dz_all) == 1 and not dz_all[0]["recovered"]
        idx = [i for i, (_, s) in enumerate(ea)
               if s.get("deployed") == 0 and s.get("recovered")]
        assert len(idx) == 2
        i1, i2 = sorted(idx)
        assert any(s.get("job") == "green-003" and "group" in s
                   for _, s in ea[i1 + 1:i2]), \
            "no green fence between the two recovery rebuilds"

        tz = [t for t, _ in _fences(ea, "green-003")]
        pre = [t for t in tz if t <= t_kill]
        assert len(pre) >= 4
        gaps = sorted(b - a for a, b in zip(pre, pre[1:]))
        median = gaps[len(gaps) // 2]
        storm = [pre[-1]] + [t for t in tz if t_kill < t <= t_rec]
        assert len(storm) >= 2, "green never fenced during recovery"
        max_gap = max(b - a for a, b in zip(storm, storm[1:]))
        bound = max(30.0, 25 * median)
        assert max_gap <= bound, \
            f"fence gap {max_gap:.1f}s breaches bound {bound:.1f}s"

        def all_done(ea, eb):
            states = {j["job_id"]: j["state"] for j in disp.jobs()}
            return states if set(states.values()) == {"FINISHED"} else None

        pump(all_done, 90, "jobs running to completion")

        def finished(ea, eb):   # a worker reports FINISHED, then prints
            fins = {s["job"]: s for _, s in ea if "finished" in s}
            return fins if len(fins) == 3 else None
        fins = pump(finished, 30, "the finished lines")
        with lk:
            ea = list(ev_a)
        assert fins["red-001"]["global_step"] == 20 * 4
        assert fins["blue-002"]["global_step"] == 20 * 4
        assert fins["green-003"]["global_step"] == 30 * 4

        # No-failure control in this process: every fence any tenant
        # reported matches one seed-7 run of the job.
        sub, _v, _f, _e = twc.build_job().subgraph(
            [0, 1, 2], feed_batch_size=8)
        ctrl = ClusterRunner(sub, device="cpu", **RUNNER_KW)
        ctrl_digests = {}
        for _ in range(30):
            closed = ctrl.executor.epoch_id
            ctrl.run_epoch(complete_checkpoint=(closed % 2 == 0))
            ctrl_digests[ctrl.global_step] = ctrl.state_digest()
        for jid in ("red-001", "blue-002", "green-003"):
            for events in (ea, eb):
                for _, s in _fences(events, jid):
                    assert s["digest"] == ctrl_digests[s["global_step"]], \
                        f"{jid} fence {s['global_step']} diverges"

        # Job-scoped durable artifacts: each tenant's ledger lives under
        # <root>/<job_id>/g0/ and holds every epoch its runs sealed;
        # `audit --job` resolves it while an unscoped diff over the
        # multi-job root refuses (ambiguous).
        for jid, n in (("red-001", 20), ("blue-002", 20),
                       ("green-003", 30)):
            path = os.path.join(ckroot, jid, "g0", "ledger.jsonl")
            with open(path) as f:
                epochs = {json.loads(ln)["epoch"] for ln in f
                          if ln.strip()}
            assert epochs == set(range(n)), jid

        def ns(**kw):
            base = dict(dir=ckroot, diff=None, job=None, report="text",
                        json=False)
            base.update(kw)
            return argparse.Namespace(**base)

        assert cmd_audit(ns(job="red-001")) == 0
        assert cmd_audit(ns(diff=ckroot)) == 2

        m = disp.metrics_extra()
        for jid in ("red-001", "blue-002", "green-003"):
            assert m[f"cluster.job.{jid}.audit.exactly-once-ok"] == 1
            assert m[f"cluster.job.{jid}.audit.divergences"] == 0
            assert m[f"cluster.job.{jid}.groups"] >= 1
        for tenant in ("red", "blue", "green"):
            assert m[f"tenant.{tenant}.slots-held"] == 0
        assert m["dispatcher.jobs-total"] == 3
        assert m["dispatcher.queue-depth"] == 0

        for jid, stormy in (("red-001", True), ("blue-002", True),
                            ("green-003", False)):
            path = os.path.join(tracedir, f"trace-jm.{jid}.jsonl")
            with open(path) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
            assert recs
            assert all(r["trace"].startswith(f"{jid}:") for r in recs)
            names = {r["name"] for r in recs}
            assert ("recovery.redeploy" in names) == stormy
    finally:
        for p in (pa, pb):
            if p.poll() is None:
                p.kill()
            p.wait(timeout=15)
        disp.close()
        reset_audit()
