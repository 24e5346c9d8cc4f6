"""Command-line front end of the port (``clonos_tpu/cli.py``'s ``run``,
``info`` and ``worker``).

The CLI builds a job from ``module:function`` and drives an in-process
``ClusterRunner`` on the card (``--device cuda``, the default; it raises
without one) or, when asked, on the CPU (``--device cpu``).

Usage:
    python -m clonos_tpu_torch run <module:function> [--epochs N] ...
    python -m clonos_tpu_torch info <module:function>
    python -m clonos_tpu_torch worker <module:function> --jm HOST:PORT \\
        --checkpoint-dir DIR [--epochs N] [--complete-every K] ...
    python -m clonos_tpu_torch dispatcher --lease PATH [--quota T=N] ...
    python -m clonos_tpu_torch slotworker --jm HOST:PORT \\
        --executor-id ID [--slots N] [--lease PATH] ...
    python -m clonos_tpu_torch submit <module:function> \\
        --dispatcher HOST:PORT [--tenant T] [--slots N] [--wait] ...
    python -m clonos_tpu_torch jobs --dispatcher HOST:PORT [--json]

``worker`` is the TaskExecutor process: it registers with a remote
JobMaster (naming its device and which path frames its deltas) and
heartbeats, writes durable checkpoints, prints one JSON
status line per epoch with the state digest, and serves its determinant
logs at every fence to the standby host's mirrors
(``runtime/remote.py``). It is one process on one card: the multi-host
bootstrap flags (``--coordinator``, ``--num-processes``,
``--process-id``) are refused.

``slotworker`` is the slot-pool TaskExecutor (``runtime/scheduler.py``):
it advertises slots and runs only the task slices a JobMaster deploys
onto it, on its ``--device``. ``dispatcher`` is the multi-tenant
JobMaster (``runtime/dispatcher.py``) that slot workers register with;
``submit`` and ``jobs`` are its clients.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def _load_job(spec: str):
    """Load 'module.path:function' returning a JobGraph."""
    from clonos_tpu_torch.graph.job_graph import JobGraph
    mod_name, _, fn_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name or "build_job")
    job = fn()
    if not isinstance(job, JobGraph):
        raise TypeError(f"{spec} returned {type(job).__name__}, not JobGraph")
    return job


def _setup_tracer(args, service: str):
    """Opt-in tracing: ``--trace-dir`` installs the process tracer
    writing trace-<service>.jsonl there. Returns the tracer or None."""
    if getattr(args, "trace_dir", None) is None:
        return None
    from clonos_tpu_torch import obs
    os.makedirs(args.trace_dir, exist_ok=True)
    return obs.configure(service, path=os.path.join(
        args.trace_dir, f"trace-{service}.jsonl"))


def _setup_profile(args) -> None:
    """Opt-in overhead attribution: ``--profile`` installs the process
    profiler before any runner is built (runners bind it at
    construction)."""
    if getattr(args, "profile", False):
        from clonos_tpu_torch.obs import configure_profile
        configure_profile()


def _make_history(args):
    """A MetricsHistory per the ``--history-*`` flags (sampled by the
    endpoint it is handed to)."""
    from clonos_tpu_torch.obs import MetricsHistory
    return MetricsHistory(path=getattr(args, "history_file", None),
                          interval_s=args.history_interval,
                          window=args.history_window)


def _add_profile_args(sp) -> None:
    """Shared observability flags."""
    sp.add_argument("--profile", action="store_true",
                    help="attribute fault-tolerance overhead per section "
                         "(overhead.* metrics + overhead.ft-fraction; "
                         "off by default)")
    sp.add_argument("--history-interval", type=float, default=2.0,
                    help="metrics-history sampling period for "
                         "/metrics/history.json (seconds)")
    sp.add_argument("--history-window", type=int, default=512,
                    help="samples kept in the metrics-history ring")
    sp.add_argument("--history-file", default=None,
                    help="also persist history samples to this JSONL "
                         "file (ring resumes from its tail on restart)")


def _add_device_arg(sp) -> None:
    sp.add_argument("--device", default="cuda",
                    help="torch device the job runs on (default cuda; "
                         "raises without a card — pass cpu to run the "
                         "plain PyTorch path)")


def cmd_run(args) -> int:
    from clonos_tpu_torch.runtime.cluster import ClusterRunner

    tracer = _setup_tracer(args, "run")
    _setup_profile(args)
    job = _load_job(args.job)
    runner = ClusterRunner(job, steps_per_epoch=args.steps_per_epoch,
                           checkpoint_dir=args.checkpoint_dir,
                           device=args.device)
    endpoint = None
    if args.metrics_port is not None:
        from clonos_tpu_torch.utils.metrics import MetricsEndpoint
        endpoint = MetricsEndpoint(runner.metrics, port=args.metrics_port,
                                   tracer=tracer,
                                   history=_make_history(args))
        print(f"# metrics: http://{endpoint.address[0]}:"
              f"{endpoint.address[1]}/metrics", file=sys.stderr)
    t0 = time.monotonic()
    try:
        for _ in range(args.epochs):
            runner.run_epoch()
            runner.watchdog.check()
    finally:
        if endpoint is not None:
            endpoint.close()
    dt = time.monotonic() - t0
    snap = runner.metrics.snapshot()
    print(json.dumps({"job": job.name, "epochs": args.epochs,
                      "wall_s": round(dt, 3), "metrics": snap},
                     default=str))
    return 0


def cmd_info(args) -> int:
    job = _load_job(args.job)
    info = {
        "name": job.name,
        "vertices": [
            {"id": v.vertex_id, "name": v.name,
             "operator": type(v.operator).__name__,
             "parallelism": v.parallelism}
            for v in job.vertices],
        "edges": [
            {"src": e.src, "dst": e.dst, "partition": e.partition.value,
             "capacity": e.capacity}
            for e in job.edges],
        "num_key_groups": job.num_key_groups,
        "sharing_depth": job.sharing_depth,
        "total_subtasks": job.total_subtasks(),
        "topological_order": job.topo_order(),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_worker(args) -> int:
    """TaskExecutor-process entry point (reference TaskExecutor.java:422):
    run a job under a remote JobMaster — register and heartbeat, serve
    the determinant logs to standby-host mirrors at every epoch fence,
    and write durable checkpoints the JobMaster can rebuild from after
    this host dies. One JSON status line per epoch on stdout."""
    if args.coordinator is not None or args.num_processes not in (None, 1) \
            or args.process_id not in (None, 0):
        raise SystemExit(
            "worker: --coordinator/--num-processes/--process-id (the "
            "multi-host bootstrap) are not supported by this package; a "
            "worker is process 0 of 1 on one card")
    from clonos_tpu_torch.ops import native
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.remote import (HostLogEndpoint,
                                                 TaskExecutorClient)

    _setup_tracer(args, args.executor_id)
    _setup_profile(args)
    job = _load_job(args.job)
    runner = ClusterRunner(job, steps_per_epoch=args.steps_per_epoch,
                           checkpoint_dir=args.checkpoint_dir,
                           seed=args.seed, device=args.device)
    endpoint = HostLogEndpoint(runner.executor, host=args.bind_host)
    host, _, port = args.jm.partition(":")
    tx = TaskExecutorClient(
        args.executor_id, (host, int(port)),
        interval_s=args.heartbeat_interval,
        info={"log_host": args.advertise_host or args.bind_host,
              "log_port": endpoint.address[1],
              "num_subtasks": job.total_subtasks(),
              "checkpoint_dir": args.checkpoint_dir, "job": args.job,
              "process_id": 0, "device": str(runner.device),
              "codec": "native" if native.available() else "zlib"})
    print(json.dumps({"registered": args.executor_id,
                      "log_port": endpoint.address[1],
                      "subtasks": job.total_subtasks()}), flush=True)
    try:
        for i in range(args.epochs):
            runner.run_epoch(
                complete_checkpoint=(i % args.complete_every == 0))
            # Status before the endpoint refresh: a mirror can then never
            # hold a fence whose digest was not yet reported (a kill
            # between the two leaves the mirror one fence behind the
            # last report, never ahead).
            print(json.dumps({"epoch": runner.executor.epoch_id,
                              "global_step": runner.global_step,
                              "digest": runner.state_digest()}),
                  flush=True)
            endpoint.refresh()         # fence snapshot for the mirrors
            if args.epoch_sleep:
                time.sleep(args.epoch_sleep)
    finally:
        tx.close()
        endpoint.close()
    return 0


def cmd_slotworker(args) -> int:
    """Slot-pool TaskExecutor entry point (``runtime/scheduler.py``): the
    process advertises slot capacity and runs ONLY the task slices the
    JobMaster deploys onto it, on ``--device``. Job spec, runner settings
    and recovery state all arrive inside the fenced deployment
    descriptors; this process brings slots and its device. One JSON line
    per deployment and per (group, epoch)."""
    from clonos_tpu_torch.runtime.scheduler import SliceWorker

    tracer = _setup_tracer(args, args.executor_id)
    _setup_profile(args)
    host, _, port = args.jm.partition(":")
    worker = SliceWorker(
        args.executor_id, (host, int(port)), lease_path=args.lease,
        slots=args.slots, bind_host=args.bind_host,
        heartbeat_interval=args.heartbeat_interval,
        chaos_step_delay_s=args.chaos_step_delay, device=args.device)
    endpoint = None
    if args.metrics_port is not None:
        from clonos_tpu_torch.utils.metrics import (MetricRegistry,
                                                    MetricsEndpoint)
        # The worker's metric view is its per-slice snapshot cache (the
        # same dict its heartbeats piggyback to the JobMaster).
        endpoint = MetricsEndpoint(
            MetricRegistry(), port=args.metrics_port,
            extra=lambda: dict(worker._metrics_cache), tracer=tracer,
            history=_make_history(args))
        print(f"# metrics: http://{endpoint.address[0]}:"
              f"{endpoint.address[1]}/metrics", file=sys.stderr)
    print(json.dumps({"registered": args.executor_id,
                      "deploy_port": worker.endpoint.address[1],
                      "slots": args.slots,
                      "device": str(worker.device)}), flush=True)
    try:
        worker.run(max_seconds=args.max_seconds,
                   epoch_sleep=args.epoch_sleep)
    finally:
        worker.close()
        if endpoint is not None:
            endpoint.close()
    return 0


def cmd_dispatcher(args) -> int:
    """Multi-tenant dispatcher entry point (``runtime/dispatcher.py``):
    one shared slot pool serving many concurrent jobs. Slot workers point
    their ``--jm`` at the printed jm address; clients submit over the
    printed dispatcher address (``submit`` / ``jobs``). One JSON line
    with both addresses on startup."""
    from clonos_tpu_torch.runtime.dispatcher import Dispatcher

    _setup_tracer(args, "dispatcher")
    _setup_profile(args)
    if args.audit:
        from clonos_tpu_torch.obs import configure_audit
        configure_audit(on_divergence=args.audit)
    quotas = {}
    for spec in args.quota or []:
        tenant, _, n = spec.partition("=")
        quotas[tenant] = int(n)
    disp = Dispatcher(
        lease_path=args.lease, checkpoint_root=args.checkpoint_root,
        quotas=quotas, default_quota=args.default_quota,
        runner_kw={"steps_per_epoch": args.steps_per_epoch,
                   "seed": args.seed},
        target_epochs=args.epochs, complete_every=args.complete_every,
        trace_dir=args.trace_dir, host=args.bind_host, port=args.port,
        heartbeat_timeout_s=args.heartbeat_timeout, device=args.device)
    endpoint = None
    if args.metrics_port is not None:
        from clonos_tpu_torch.utils.metrics import (MetricRegistry,
                                                    MetricsEndpoint)
        endpoint = MetricsEndpoint(
            MetricRegistry(), port=args.metrics_port,
            extra=disp.metrics_extra, history=_make_history(args))
        print(f"# metrics: http://{endpoint.address[0]}:"
              f"{endpoint.address[1]}/metrics", file=sys.stderr)
    print(json.dumps({"dispatcher": list(disp.address),
                      "jm": list(disp.jm.address)}), flush=True)
    try:
        disp.run(max_seconds=args.max_seconds)
    finally:
        disp.close()
        if endpoint is not None:
            endpoint.close()
    return 0


def cmd_submit(args) -> int:
    """Submit a job to a running dispatcher. Prints the admission result
    ({job_id, state}) or, with ``--wait``, the terminal job record; a
    typed quota rejection prints its error JSON and exits 1."""
    from clonos_tpu_torch.parallel import transport as tp

    host, _, port = args.dispatcher.partition(":")
    client = tp.ControlClient((host, int(port)))
    cfg = {"tenant": args.tenant, "slots": args.slots,
           "max_concurrent_recoveries": args.max_recoveries}
    if args.workers:
        cfg["workers"] = [w for w in args.workers.split(",") if w]
    req = {"job": args.job, "tenant_config": cfg}
    if args.target_epochs is not None:
        req["target_epochs"] = args.target_epochs
    try:
        rt, resp = client.call(tp.SUBMIT_JOB, tp.pack_json(req))
        body = tp.unpack_json(resp)
        if rt == tp.ERROR:
            print(json.dumps(body))
            return 1
        if args.wait:
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                body = client.call_json(
                    tp.JOB_STATUS, {"job_id": body["job_id"]})
                if body["state"] in ("FINISHED", "FAILED", "CANCELLED"):
                    break
                time.sleep(0.5)
    finally:
        client.close()
    print(json.dumps(body))
    return 1 if body.get("state") == "FAILED" else 0


def cmd_jobs(args) -> int:
    """List a dispatcher's jobs (or cancel one with ``--cancel``)."""
    from clonos_tpu_torch.parallel import transport as tp

    host, _, port = args.dispatcher.partition(":")
    client = tp.ControlClient((host, int(port)))
    try:
        if args.cancel:
            print(json.dumps(client.call_json(
                tp.CANCEL_JOB, {"job_id": args.cancel})))
            return 0
        res = client.call_json(tp.JOB_STATUS, {})
    finally:
        client.close()
    if args.json:
        print(json.dumps(res))
        return 0
    jobs = res.get("jobs", [])
    print(f"{'JOB':<20} {'TENANT':<12} {'STATE':<11} {'SLOTS':>5}  "
          f"PLACEMENTS")
    for j in jobs:
        placements = " ".join(
            f"g{g}={w}" for g, w in sorted(
                (j.get("placements") or {}).items()))
        if j.get("error"):
            placements = (placements + "  " if placements else "") \
                + f"error: {j['error']}"
        print(f"{j['job_id']:<20} {j['tenant']:<12} {j['state']:<11} "
              f"{j['slots']:>5}  {placements}")
    if not jobs:
        print("(no jobs submitted)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="clonos_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a job to completion of N epochs")
    pr.add_argument("job", help="module:function returning a JobGraph")
    pr.add_argument("--epochs", type=int, default=4)
    pr.add_argument("--steps-per-epoch", type=int, default=16)
    pr.add_argument("--checkpoint-dir", default=None)
    pr.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus) + /metrics.json "
                         "+ /trace on this port while running "
                         "(0 = ephemeral)")
    pr.add_argument("--trace-dir", default=None,
                    help="record trace spans to trace-run.jsonl here "
                         "(off by default)")
    _add_profile_args(pr)
    _add_device_arg(pr)
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("info", help="describe a job graph")
    pi.add_argument("job")
    pi.set_defaults(fn=cmd_info)

    pw = sub.add_parser("worker", help="run a job as a TaskExecutor "
                                       "process under a remote JobMaster")
    pw.add_argument("job", help="module:function returning a JobGraph")
    pw.add_argument("--jm", required=True, help="JobMaster host:port")
    pw.add_argument("--executor-id", default="worker-0")
    pw.add_argument("--checkpoint-dir", required=True)
    pw.add_argument("--epochs", type=int, default=8)
    pw.add_argument("--steps-per-epoch", type=int, default=16)
    pw.add_argument("--complete-every", type=int, default=4,
                    help="complete (ack) every k-th checkpoint; others "
                         "stay pending (the large-interval regime)")
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--heartbeat-interval", type=float, default=0.5)
    pw.add_argument("--epoch-sleep", type=float, default=0.0,
                    help="pause between epochs (lets tests kill mid-run)")
    pw.add_argument("--bind-host", default="127.0.0.1",
                    help="interface the determinant-log endpoint binds")
    pw.add_argument("--advertise-host", default=None,
                    help="address mirrors should dial (defaults to "
                         "--bind-host)")
    pw.add_argument("--coordinator", default=None,
                    help="multi-host bootstrap address (not supported: "
                         "refused when given)")
    pw.add_argument("--num-processes", type=int, default=None)
    pw.add_argument("--process-id", type=int, default=None)
    pw.add_argument("--trace-dir", default=None,
                    help="record trace spans to "
                         "trace-<executor-id>.jsonl here")
    pw.add_argument("--profile", action="store_true",
                    help="attribute fault-tolerance overhead per section "
                         "(overhead.* metrics; off by default)")
    _add_device_arg(pw)
    pw.set_defaults(fn=cmd_worker)

    ps = sub.add_parser("slotworker",
                        help="serve task slots to a slot-pool JobMaster; "
                             "runs only the task slices deployed onto it")
    ps.add_argument("--jm", required=True, help="JobMaster host:port")
    ps.add_argument("--executor-id", default="slotworker-0")
    ps.add_argument("--slots", type=int, default=1)
    ps.add_argument("--lease", default=None,
                    help="shared leader-lease dir; DEPLOY fencing tokens "
                         "are validated against its claims")
    ps.add_argument("--bind-host", default="127.0.0.1")
    ps.add_argument("--heartbeat-interval", type=float, default=0.5)
    ps.add_argument("--max-seconds", type=float, default=600.0,
                    help="wall guard: exit after this long")
    ps.add_argument("--epoch-sleep", type=float, default=0.0,
                    help="pause after each served epoch round (lets "
                         "tests kill mid-run)")
    ps.add_argument("--chaos-step-delay", type=float, default=0.0,
                    metavar="SECONDS",
                    help="gray-failure injection: sleep this long "
                         "before each slice epoch — degraded (late "
                         "fences) but never dead (heartbeats keep "
                         "flowing)")
    ps.add_argument("--metrics-port", type=int, default=None,
                    help="serve this worker's /metrics + /metrics.json "
                         "+ /trace on this port (0 = ephemeral)")
    ps.add_argument("--trace-dir", default=None,
                    help="record trace spans to "
                         "trace-<executor-id>.jsonl here; DEPLOY "
                         "headers make the spans join the JobMaster's "
                         "trace id (off by default)")
    _add_profile_args(ps)
    _add_device_arg(ps)
    ps.set_defaults(fn=cmd_slotworker)

    pc = sub.add_parser("dispatcher",
                        help="multi-tenant dispatcher: one shared slot "
                             "pool serving many concurrent jobs")
    pc.add_argument("--lease", required=True,
                    help="cluster lease path; each job's leader claims "
                         "<lease>.<job-id>.epochN.claim (slot workers "
                         "validate DEPLOY fencing against the same "
                         "path)")
    pc.add_argument("--checkpoint-root",
                    default="/tmp/clonos-dispatcher",
                    help="every job's checkpoints + ledgers land under "
                         "<root>/<job-id>/")
    pc.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=N",
                    help="per-tenant slot quota (repeatable); "
                         "submissions beyond it are rejected with a "
                         "typed quota-exceeded error")
    pc.add_argument("--default-quota", type=int, default=None,
                    help="slot quota for tenants without an explicit "
                         "--quota (default: unlimited)")
    pc.add_argument("--port", type=int, default=0,
                    help="dispatcher submit/status port (0 = ephemeral)")
    pc.add_argument("--bind-host", default="127.0.0.1")
    pc.add_argument("--epochs", type=int, default=8,
                    help="default target epochs per job (submit may "
                         "override)")
    pc.add_argument("--steps-per-epoch", type=int, default=16)
    pc.add_argument("--seed", type=int, default=0)
    pc.add_argument("--complete-every", type=int, default=1)
    pc.add_argument("--heartbeat-timeout", type=float, default=5.0)
    pc.add_argument("--max-seconds", type=float, default=600.0,
                    help="wall guard: exit after this long")
    pc.add_argument("--audit", choices=["warn", "abort"], default=None,
                    help="enable the exactly-once audit for every "
                         "deployed job (DEPLOY headers carry the "
                         "stance)")
    pc.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics + /metrics.json with "
                         "per-tenant rollups (0 = ephemeral)")
    pc.add_argument("--trace-dir", default=None,
                    help="per-job trace files "
                         "(trace-jm.<job-id>.jsonl) land here")
    _add_profile_args(pc)
    _add_device_arg(pc)
    pc.set_defaults(fn=cmd_dispatcher)

    pj = sub.add_parser("submit", help="submit a job to a running "
                                       "dispatcher")
    pj.add_argument("job", help="module:function returning a JobGraph "
                                "(resolved by the slot workers)")
    pj.add_argument("--dispatcher", required=True,
                    help="dispatcher host:port")
    pj.add_argument("--tenant", default="default")
    pj.add_argument("--slots", type=int, default=1,
                    help="slices to cut the job into (= pool slots "
                         "held)")
    pj.add_argument("--max-recoveries", type=int, default=1,
                    help="cap on concurrently rebuilt groups after a "
                         "worker death (storm containment)")
    pj.add_argument("--workers", default=None,
                    help="comma-separated placement hint (slice i "
                         "prefers the i-th worker)")
    pj.add_argument("--target-epochs", type=int, default=None)
    pj.add_argument("--wait", action="store_true",
                    help="poll until the job reaches a terminal state")
    pj.add_argument("--timeout", type=float, default=600.0,
                    help="--wait deadline (seconds)")
    pj.set_defaults(fn=cmd_submit)

    po = sub.add_parser("jobs", help="list (or cancel) a dispatcher's "
                                     "jobs")
    po.add_argument("--dispatcher", required=True,
                    help="dispatcher host:port")
    po.add_argument("--json", action="store_true",
                    help="machine-readable job list")
    po.add_argument("--cancel", default=None, metavar="JOB_ID",
                    help="cancel this job instead of listing")
    po.set_defaults(fn=cmd_jobs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
