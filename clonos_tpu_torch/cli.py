"""Command-line front end of the port (``clonos_tpu/cli.py``): the job,
process, dispatcher, observability, soak, verify, lint and analyze
verbs.

The CLI builds a job from ``module:function`` and drives an in-process
``ClusterRunner`` on the card (``--device cuda``, the default; it raises
without one) or, when asked, on the CPU (``--device cpu``).

Usage:
    python -m clonos_tpu_torch run <module:function> [--epochs N] ...
    python -m clonos_tpu_torch info <module:function>
    python -m clonos_tpu_torch dryrun [--devices N] [--backend gloo|nccl]
    python -m clonos_tpu_torch worker <module:function> --jm HOST:PORT \\
        --checkpoint-dir DIR [--epochs N] [--complete-every K] ...
    python -m clonos_tpu_torch dispatcher --lease PATH [--quota T=N] ...
    python -m clonos_tpu_torch slotworker --jm HOST:PORT \\
        --executor-id ID [--slots N] [--lease PATH] ...
    python -m clonos_tpu_torch submit <module:function> \\
        --dispatcher HOST:PORT [--tenant T] [--slots N] [--wait] ...
    python -m clonos_tpu_torch jobs --dispatcher HOST:PORT [--json]
    python -m clonos_tpu_torch audit <checkpoint-dir> [--diff DIR2] [--job ID]
    python -m clonos_tpu_torch top HOST:PORT [--once]
    python -m clonos_tpu_torch trace trace-*.jsonl [--chrome OUT]
    python -m clonos_tpu_torch timeline timeline-*.jsonl [--report json]
    python -m clonos_tpu_torch incident {list,show,explain} [--dir DIR]
    python -m clonos_tpu_torch lineage lineage-*.jsonl [--key K]
    python -m clonos_tpu_torch soak [--rate R] [--duration S] \\
        [--schedule DSL|FILE] [--autoscale] [--report json] [--out FILE] ...
    python -m clonos_tpu_torch verify [--quick] [--model NAME] \\
        [--seed-bug MODEL:BUG] [--chaos-out DIR] [--conformance] ...
    python -m clonos_tpu_torch lint [paths...] [--report json] \\
        [--rule NAME] [--no-waivers] [--list-rules]
    python -m clonos_tpu_torch analyze [paths...] [--report json] \\
        [--census] [--no-census] [--races] [--threads] \\
        [--expect-census FP|FILE] [--expect-threads FP|FILE] \\
        [--seed-bug NAME]

``worker`` is the TaskExecutor process: it registers with a remote
JobMaster (naming its device, its process id and which path frames its
deltas) and heartbeats, writes durable checkpoints, prints one JSON
status line per epoch with the state digest, and serves its determinant
logs at every fence to the standby host's mirrors
(``runtime/remote.py``). The multi-host bootstrap flags
(``--coordinator``, ``--num-processes``, ``--process-id``, ``--backend``)
join a ``torch.distributed`` process group first; as in the reference,
the worker's runner gets no mesh.

``dryrun --devices N`` runs the flagship job's supersteps sharded over N
rank processes and on one (``parallel/dryrun.py``) and prints one JSON
line with both rates.

``slotworker`` is the slot-pool TaskExecutor (``runtime/scheduler.py``):
it advertises slots and runs only the task slices a JobMaster deploys
onto it, on its ``--device``. ``dispatcher`` is the multi-tenant
JobMaster (``runtime/dispatcher.py``) that slot workers register with;
``submit`` and ``jobs`` are its clients.

The observability verbs read what the planes wrote: ``audit`` prints or
diffs epoch ledgers, ``top`` renders a metrics endpoint, ``trace``
summarizes or converts tracer files, ``timeline`` merges the per-process
HLC timelines (``--timeline-dir`` on ``run``, ``worker``, ``slotworker``
and ``dispatcher``) and proves them causal, ``incident`` lists and
explains incident bundles, and ``lineage`` reconstructs dyed records'
paths (``worker --lineage-dir``, or a DEPLOY header's dye config).

``soak`` (``soak/``) paces a runner and its fault-free control twin at a
fixed rate through a chaos schedule and writes the verdict (corrected
latency, SLO windows, faults, the exactly-once audit) to ``--out``
(default: the next free ``SOAK_r0N.json`` in the working directory);
``--report json`` prints one line and exits 0 on pass, 1 on fail.
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


def _setup_timeline(args, service: str):
    """Opt-in causal timeline: ``--timeline-dir`` installs the process
    TimelineStore (and an HLC, so every cross-process message carries a
    causal stamp) writing timeline-<service>.jsonl there. Returns the
    store or None."""
    if getattr(args, "timeline_dir", None) is None:
        return None
    from clonos_tpu_torch.obs import configure_timeline
    os.makedirs(args.timeline_dir, exist_ok=True)
    return configure_timeline(service, path=os.path.join(
        args.timeline_dir, f"timeline-{service}.jsonl"))


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
    _setup_timeline(args, "run")
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


def cmd_dryrun(args) -> int:
    """The flagship job's supersteps sharded over ``--devices`` ranks and
    on one rank (``parallel/dryrun.py``): one JSON line."""
    from clonos_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(args.devices, device=args.device, backend=args.backend,
                     timeout_s=args.timeout)
    return 0


def cmd_worker(args) -> int:
    """TaskExecutor-process entry point (reference TaskExecutor.java:422):
    run a job under a remote JobMaster — register and heartbeat, serve
    the determinant logs to standby-host mirrors at every epoch fence,
    and write durable checkpoints the JobMaster can rebuild from after
    this host dies. One JSON status line per epoch on stdout."""
    if args.coordinator is None and (args.num_processes not in (None, 1)
                                     or args.process_id not in (None, 0)):
        raise SystemExit("worker: --num-processes/--process-id join a "
                         "process group only with --coordinator")
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        raise SystemExit("worker: --coordinator needs --num-processes and "
                         "--process-id")
    from clonos_tpu_torch.ops import native
    from clonos_tpu_torch.parallel import distributed
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from clonos_tpu_torch.runtime.remote import (HostLogEndpoint,
                                                 TaskExecutorClient)

    _setup_tracer(args, args.executor_id)
    _setup_timeline(args, args.executor_id)
    _setup_profile(args)
    if args.lineage_dir is not None:
        from clonos_tpu_torch.obs import configure_lineage
        configure_lineage(args.lineage_dir, service=args.executor_id)
    # The multi-host bootstrap: join the process group (the backend named
    # by --backend, else NCCL on the card and gloo on the CPU). As in the
    # reference, the runner gets no mesh: each worker runs its job whole.
    ctx = distributed.initialize(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device,
                                 backend=args.backend)
    job = _load_job(args.job)
    runner = ClusterRunner(job, steps_per_epoch=args.steps_per_epoch,
                           checkpoint_dir=args.checkpoint_dir,
                           seed=args.seed, logical_time=args.logical_time,
                           device=args.device)
    if args.sink_dir is not None:
        for vid in sorted(runner.txn_logs):
            runner.attach_file_sink(vid, os.path.join(args.sink_dir,
                                                      f"v{vid}"))
    endpoint = HostLogEndpoint(runner.executor, host=args.bind_host)
    host, _, port = args.jm.partition(":")
    tx = TaskExecutorClient(
        args.executor_id, (host, int(port)),
        interval_s=args.heartbeat_interval,
        info={"log_host": args.advertise_host or args.bind_host,
              "log_port": endpoint.address[1],
              "num_subtasks": job.total_subtasks(),
              "checkpoint_dir": args.checkpoint_dir, "job": args.job,
              "process_id": ctx.process_id,
              "num_processes": ctx.num_processes,
              "device": str(runner.device),
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
        distributed.shutdown()
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
    _setup_timeline(args, args.executor_id)
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
    _setup_timeline(args, "dispatcher")
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


def _find_ledgers(root):
    """Ledger files under ``root``: the path itself (file or dir with
    ledger.jsonl), per-group ``g*/ledger.jsonl`` subdirs (slot-pool
    layout), or per-job ``<job_id>/g*/ledger.jsonl`` trees (dispatcher
    layout — every job's artifacts live under ``<root>/<job_id>/``).
    Returns [(label, entries)] sorted by label; dispatcher-layout
    labels carry the job-id prefix (``<job_id>/g0/ledger.jsonl``)."""
    import glob
    from clonos_tpu_torch.runtime.checkpoint import read_ledger_file

    if os.path.isfile(root):
        return [(os.path.basename(root), read_ledger_file(root))]
    direct = os.path.join(root, "ledger.jsonl")
    if os.path.exists(direct):
        return [("ledger.jsonl", read_ledger_file(direct))]
    out = []
    for pat in (os.path.join(root, "*", "ledger.jsonl"),
                os.path.join(root, "*", "*", "ledger.jsonl")):
        for p in sorted(glob.glob(pat)):
            label = os.path.relpath(p, root)
            out.append((label, read_ledger_file(p)))
    return sorted(out)


def _ledger_job_ids(ledgers):
    """Job ids present in a dispatcher-layout ledger set: the leading
    path component of every ``<job_id>/g*/ledger.jsonl`` label."""
    jobs = set()
    for label, _ in ledgers:
        parts = label.split(os.sep)
        if len(parts) >= 3:
            jobs.add(parts[0])
    return sorted(jobs)


def cmd_audit(args) -> int:
    """Print or diff a job's epoch audit ledger (``python -m clonos_tpu_torch audit``):
    the per-epoch digests obs/audit.py sealed at each checkpoint
    barrier. ``--diff`` compares against a second run's ledger and
    exits 1 on the first divergence (epoch + channel named). A
    dispatcher root holds MANY jobs' ledgers (``<root>/<job_id>/g*/``);
    ``--job`` selects one (labels lose the job prefix so they line up
    against a single-job run's), and a diff over an ambiguous
    multi-job root exits 2 listing the available job ids."""
    from clonos_tpu_torch.obs import audit as _audit_mod

    ledgers = _find_ledgers(args.dir)
    if not ledgers:
        if args.report == "json":
            print(json.dumps({"match": False, "groups": {},
                              "problems": [f"no ledger.jsonl under "
                                           f"{args.dir}"]}))
        else:
            print(f"no ledger.jsonl under {args.dir}", file=sys.stderr)
        return 1
    job_ids = _ledger_job_ids(ledgers)
    job = getattr(args, "job", None)
    if job:
        pre = job + os.sep
        picked = [(label[len(pre):], entries)
                  for label, entries in ledgers
                  if label.startswith(pre)]
        if not picked:
            print(f"no ledgers for job {job!r} under {args.dir} "
                  f"(available job ids: "
                  f"{', '.join(job_ids) or 'none'})", file=sys.stderr)
            return 2
        ledgers = picked
    elif args.diff and len(job_ids) > 1:
        print(f"ambiguous: {args.dir} holds ledgers for "
              f"{len(job_ids)} jobs ({', '.join(job_ids)}) — pass "
              f"--job <id> to pick one", file=sys.stderr)
        return 2
    if args.diff:
        other_ledgers = _find_ledgers(args.diff)
        if job:
            pre = job + os.sep
            picked = [(label[len(pre):], entries)
                      for label, entries in other_ledgers
                      if label.startswith(pre)]
            # The compared run may itself be single-job (no prefix);
            # fall through to its raw labels then.
            other_ledgers = picked or other_ledgers
        other = dict(other_ledgers)
        problems = []
        groups = {}
        for label, entries in ledgers:
            # Layout-aware: epochs sealed under the same cut compare
            # bit for bit; across a live re-cut the group-directory
            # mapping compares the partition-invariant channels.
            lines = _audit_mod.diff_ledgers_cross(entries,
                                                  other.get(label, []))
            groups[label] = {"entries": len(entries),
                             "epochs": len({e.get("epoch")
                                            for e in entries}),
                             "problems": lines}
            problems += [f"{label}: {line}" for line in lines]
        if args.report == "json":
            # CI convention: one machine-readable line, exit 0/1.
            print(json.dumps({"match": not problems, "groups": groups,
                              "problems": problems}))
            return 1 if problems else 0
        for line in problems:
            print(line)
        if not problems:
            print(f"ledgers match ({sum(len(e) for _, e in ledgers)} "
                  f"entries)")
        return 1 if problems else 0
    if args.report == "json":
        groups = {label: {"entries": len(entries),
                          "epochs": len({e.get("epoch")
                                         for e in entries})}
                  for label, entries in ledgers}
        print(json.dumps({"match": True, "groups": groups,
                          "problems": []}))
        return 0
    if args.json:
        print(json.dumps({label: entries for label, entries in ledgers},
                         indent=2))
        return 0
    for label, entries in ledgers:
        # last-wins per epoch: a rebuilt runner re-seals replayed epochs
        by_epoch = {e["epoch"]: e for e in entries}
        print(f"# {label} — {len(by_epoch)} epochs "
              f"({len(entries)} entries)")
        for ep in sorted(by_epoch):
            e = by_epoch[ep]
            dets = " ".join(f"{k}={v}" for k, v in
                            sorted((e.get("det_counts") or {}).items()))
            print(f"epoch {ep:>4}  records {e.get('records', 0):>8}  "
                  f"channels {len(e.get('channels') or {}):>3}  "
                  f"combined {e.get('combined', '?')}  {dets}")
    return 0


def _top_rows(snap):
    """Fold a JobMaster ``/metrics.json`` snapshot into per-worker rows.

    Keys arrive flattened as ``worker.<eid>.<metric>`` where ``<metric>``
    is the worker's own snapshot name (e.g.
    ``group.g0.job.bench.audit.epochs-sealed``); suffix-match so the row
    survives arbitrary group/job nesting. Histogram values are the
    flattened ``{count, mean, p50, p99}`` dicts snapshot() emits."""
    workers = {}

    def row(eid):
        return workers.setdefault(eid, {
            "slots": None, "groups": set(), "sealed": 0, "validated": 0,
            "ring": None, "lag": None, "ft": None,
            "spill_host": None, "spill_disk": None, "phases": {}})

    for key, v in snap.items():
        if not key.startswith("worker."):
            continue
        eid, _, rest = key[len("worker."):].partition(".")
        if not eid or not rest:
            continue
        r = row(eid)
        if rest == "slots" and isinstance(v, (int, float)):
            r["slots"] = int(v)
            continue
        if rest.startswith("group."):
            r["groups"].add(rest.split(".", 2)[1])
        elif rest.startswith("job."):
            # multi-tenant prefix: job.<jid>.group.<g>.<metric>
            jparts = rest.split(".")
            if len(jparts) >= 4 and jparts[2] == "group":
                r["groups"].add(f"{jparts[1]}:g{jparts[3]}")
        num = isinstance(v, (int, float)) and not isinstance(v, bool)
        if num and rest.endswith(".audit.epochs-sealed"):
            r["sealed"] += int(v)
        elif num and rest.endswith(".audit.epochs-validated"):
            r["validated"] += int(v)
        elif num and (rest.endswith(".backpressure.inflight-occupancy")
                      or rest.endswith(".causal-log.max-occupancy")):
            r["ring"] = max(r["ring"] or 0.0, float(v))
        elif num and rest.endswith(".recovery.replay-lag-steps"):
            r["lag"] = max(r["lag"] or 0, int(v))
        elif num and rest.endswith(".overhead.ft-fraction"):
            r["ft"] = max(r["ft"] or 0.0, float(v))
        elif num and rest.endswith(".spill.host-epochs"):
            r["spill_host"] = (r["spill_host"] or 0) + int(v)
        elif num and rest.endswith(".spill.disk-epochs"):
            r["spill_disk"] = (r["spill_disk"] or 0) + int(v)
        elif (isinstance(v, dict) and ".recovery." in rest
              and rest.endswith("-ms") and v.get("count")):
            phase = rest.rsplit(".recovery.", 1)[1][:-len("-ms")]
            r["phases"][phase] = float(v.get("p50") or v.get("mean") or 0)
    return workers


def _top_table(snap) -> str:
    """Render one ``python -m clonos_tpu_torch top`` frame from a /metrics.json dict."""
    rows = _top_rows(snap)
    lines = [f"{'WORKER':<18} {'SLOTS':>5} {'GROUPS':>6} {'SEALED':>6} "
             f"{'VALID':>5} {'RING':>6} {'LAG':>5} {'FT%':>7} "
             f"{'SPILL':>7}  RECOVERY p50 ms"]
    for eid in sorted(rows):
        r = rows[eid]
        slots = "-" if r["slots"] is None else str(r["slots"])
        ring = "-" if r["ring"] is None else f"{r['ring']:.2f}"
        lag = "-" if r["lag"] is None else str(r["lag"])
        ft = "-" if r["ft"] is None else f"{r['ft'] * 100:.2f}"
        # tier residency: host-tier / disk-tier sealed epochs held
        # (the spill.* gauges; storage/tiered.py)
        spill = ("-" if r["spill_host"] is None and r["spill_disk"] is None
                 else f"{r['spill_host'] or 0}/{r['spill_disk'] or 0}")
        phases = " ".join(f"{k}={v:.0f}"
                          for k, v in sorted(r["phases"].items()))
        lines.append(f"{eid:<18} {slots:>5} {len(r['groups']):>6} "
                     f"{r['sealed']:>6} {r['validated']:>5} {ring:>6} "
                     f"{lag:>5} {ft:>7} {spill:>7}  {phases}")
    if not rows:
        lines.append("(no worker.* metrics yet)")
    # Per-job section (multi-tenant dispatcher): one row per job id
    # from the cluster.job.<jid>.* rollups remote.cluster_metrics()
    # computes, plus the dispatcher's tenant admission gauges.
    jobs = {}
    for k, v in snap.items():
        if k.startswith("cluster.job."):
            jid, _, metric = k[len("cluster.job."):].partition(".")
            if jid and metric:
                jobs.setdefault(jid, {})[metric] = v

    def _cell(m, name):
        v = m.get(name)
        return "-" if v is None else str(v)

    if jobs:
        lines.append("")
        lines.append(f"{'JOB':<20} {'GROUPS':>6} {'SEALED':>6} "
                     f"{'VALID':>5} {'DIV':>4} {'XONCE':>5}")
        for jid in sorted(jobs):
            m = jobs[jid]
            lines.append(
                f"{jid:<20} {_cell(m, 'groups'):>6} "
                f"{_cell(m, 'audit.epochs-sealed'):>6} "
                f"{_cell(m, 'audit.epochs-validated'):>5} "
                f"{_cell(m, 'audit.divergences'):>4} "
                f"{_cell(m, 'audit.exactly-once-ok'):>5}")
    # Soak status row: the open-loop driver's soak.* gauges (rate vs
    # target, backlog, SLO breaches, fault + audit tallies). Matched by
    # suffix too, so the row survives a worker.<eid> prefix.
    soak = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("soak."):
            soak[k[len("soak."):]] = v
        elif ".soak." in k:
            soak.setdefault(k.rsplit(".soak.", 1)[1], v)
    if soak:
        lines.append("")
        lines.append("soak: " + "  ".join(
            f"{k}={v}" for k, v in sorted(soak.items())))
    # Serve status row: the read tier's serve.* gauges (read QPS, p99
    # read latency, per-replica staleness-epochs, reroutes) — same
    # suffix matching, so the row survives a worker.<eid> prefix on
    # metrics that rode a HEARTBEAT into cluster_metrics().
    serve = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("serve."):
            serve[k[len("serve."):]] = v
        elif ".serve." in k:
            serve.setdefault(k.rsplit(".serve.", 1)[1], v)
    if serve:
        lines.append("")
        lines.append("serve: " + "  ".join(
            f"{k}={v}" for k, v in sorted(serve.items())))
    # Autoscale status row: the closed-loop controller's autoscale.*
    # gauges (decision/action tallies, cooldown, target vs actual cut)
    # — same suffix matching as soak:/serve:.
    autoscale = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("autoscale."):
            autoscale[k[len("autoscale."):]] = v
        elif ".autoscale." in k:
            autoscale.setdefault(k.rsplit(".autoscale.", 1)[1], v)
    if autoscale:
        lines.append("")
        lines.append("autoscale: " + "  ".join(
            f"{k}={v}" for k, v in sorted(autoscale.items())))
    # Health status row: the gray-failure detector's cluster.health.*
    # gauges (sustained suspects, events, fences scored) — same suffix
    # matching as soak:/serve:, so the row survives any prefix.
    health = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("cluster.health."):
            health[k[len("cluster.health."):]] = v
        elif ".cluster.health." in k:
            health.setdefault(k.rsplit(".cluster.health.", 1)[1], v)
    if health:
        lines.append("")
        lines.append("health: " + "  ".join(
            f"{k}={v}" for k, v in sorted(health.items())))
    # Incidents status row: the flight recorder's incident.* gauges
    # (bundles captured, dedup/rate-limit drops, signals seen) — same
    # suffix matching as soak:/serve:/health:.
    incidents = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("incident."):
            incidents[k[len("incident."):]] = v
        elif ".incident." in k:
            incidents.setdefault(k.rsplit(".incident.", 1)[1], v)
    if incidents:
        lines.append("")
        lines.append("incidents: " + "  ".join(
            f"{k}={v}" for k, v in sorted(incidents.items())))
    # Lineage status row: the dye plane's lineage.* gauges (records
    # dyed, observations logged, epochs scanned) — same convention.
    lineage = {}
    for k, v in sorted(snap.items()):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if k.startswith("lineage."):
            lineage[k[len("lineage."):]] = v
        elif ".lineage." in k:
            lineage.setdefault(k.rsplit(".lineage.", 1)[1], v)
    if lineage:
        lines.append("")
        lines.append("lineage: " + "  ".join(
            f"{k}={v}" for k, v in sorted(lineage.items())))
    tenant = {k: v for k, v in sorted(snap.items())
              if (k.startswith("tenant.")
                  or k.startswith("dispatcher."))
              and isinstance(v, (int, float))}
    if tenant:
        lines.append("")
        lines.append("tenants: " + "  ".join(
            f"{k}={v}" for k, v in tenant.items()))
    cluster = {k: v for k, v in sorted(snap.items())
               if k.startswith("cluster.")
               and not k.startswith("cluster.job.")
               and not k.startswith("cluster.health.")
               and isinstance(v, (int, float))}
    if cluster:
        lines.append("")
        lines.append("cluster: " + "  ".join(
            f"{k[len('cluster.'):]}={v}" for k, v in cluster.items()))
    # Trace-ring truncation: a nonzero dropped count means the flight
    # recorder (and /trace) no longer holds the full run.
    dropped = snap.get("trace.dropped-records")
    if isinstance(dropped, (int, float)) and dropped:
        lines.append("")
        lines.append(f"trace: dropped-records={int(dropped)} "
                     f"(flight-recorder ring truncated)")
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live per-worker cluster view (``python -m clonos_tpu_torch top``): poll a
    JobMaster metrics endpoint's /metrics.json and render slots, sealed/
    validated epochs, ring occupancy, replay lag, overhead fraction, and
    last recovery phase times per worker. ``--once`` prints a single
    snapshot (scriptable); otherwise redraws every ``--interval`` s
    until interrupted."""
    import urllib.request

    url = args.endpoint
    if "://" not in url:
        url = "http://" + url
    url = url.rstrip("/") + "/metrics.json"

    def fetch():
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return json.loads(resp.read().decode("utf-8"))

    if args.once:
        print(_top_table(fetch()))
        return 0
    try:
        while True:
            frame = _top_table(fetch())
            sys.stdout.write("\x1b[2J\x1b[H")   # clear + home
            sys.stdout.write(f"clonos_tpu_torch top — {url} — "
                             f"{time.strftime('%H:%M:%S')}\n\n")
            sys.stdout.write(frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_trace(args) -> int:
    """Dump / convert recorded trace files (``python -m clonos_tpu_torch trace``):
    summary by default, Chrome trace_event JSON with ``--chrome`` (the
    output is validated before writing — Perfetto-loadable or error)."""
    from clonos_tpu_torch import obs

    records = obs.load_jsonl(args.files)
    if args.trace_id:
        records = [r for r in records if r.get("trace") == args.trace_id]
    if args.chrome:
        doc = obs.to_chrome(records)
        n = obs.validate_chrome(doc)
        with open(args.chrome, "w") as f:
            json.dump(doc, f)
        print(json.dumps({"events": n, "out": args.chrome}))
        return 0
    summary = obs.summarize(records)
    timeline = summary.pop("timeline")
    print(json.dumps(summary, indent=2, default=str))
    if args.timeline:
        for ev in timeline:
            dur = (f" dur={ev['dur'] * 1e3:.1f}ms"
                   if ev.get("dur") is not None else "")
            print(f"{ev['ts']:.6f} [{ev['service']}] "
                  f"{ev['ph']} {ev['name']}{dur}")
    return 0


def cmd_timeline(args) -> int:
    """Merge, check, filter, diff and export causal timelines
    (``python -m clonos_tpu_torch timeline``): any number of per-process
    timeline-*.jsonl files reconstruct ONE HLC-ordered incident
    timeline; ``--report json`` is the causality gate (exit 1 on any
    inversion); ``--diff`` compares two runs structurally; ``--chrome``
    exports through the same validated trace_event path as
    ``python -m clonos_tpu_torch trace``."""
    from clonos_tpu_torch import obs

    if args.self_check:
        findings = obs.timeline_self_check()
        print(json.dumps({"ok": not findings, "check": "hlc-causality",
                          "inversions": findings}))
        return 0 if not findings else 1

    if not args.files:
        print("timeline: at least one timeline-*.jsonl file required "
              "(or --self-check)", file=sys.stderr)
        return 2

    def _match(rec) -> bool:
        if args.kind and not str(rec.get("kind", "")).startswith(
                args.kind):
            return False
        if args.job is not None and str(
                rec.get("job", rec.get("service", ""))) != args.job:
            return False
        if args.epoch is not None and rec.get("epoch") != args.epoch:
            return False
        if args.worker is not None:
            cands = [rec.get("worker"), rec.get("flat"),
                     rec.get("subtask")]
            targets = rec.get("targets")
            if isinstance(targets, list):
                cands.extend(targets)
            if args.worker not in {str(c) for c in cands
                                   if c is not None}:
                return False
        return True

    # The default and --report paths STREAM: a k-way heap merge over
    # per-file cursors (obs.iter_merged) keeps memory O(open files),
    # not O(total events) — a long soak's timelines merge flat.
    # --trace/--diff/--chrome mix in unsorted sources or need the full
    # set in hand, so they still materialize.
    if not (args.trace or args.diff is not None or args.chrome):
        # inversions are checked over the FULL merged stream — filters
        # narrow what is shown, never what is proven
        inversions = obs.causality_inversions_stream(
            obs.iter_merged(args.files))
        if inversions:
            # A broken receive rule IS an incident: when a flight
            # recorder is armed in this process, the first inversion
            # lands a bundle (Null manager: no-op).
            from clonos_tpu_torch.obs.incident import get_incidents
            get_incidents().signal(
                "timeline.inversion", rule=inversions[0]["rule"],
                detail=inversions[0]["detail"],
                count=len(inversions))
        if args.report == "json":
            by_kind: dict = {}
            total = shown_n = 0
            for r in obs.iter_merged(args.files):
                total += 1
                if not _match(r):
                    continue
                shown_n += 1
                k = str(r.get("kind", "?"))
                by_kind[k] = by_kind.get(k, 0) + 1
            print(json.dumps({"ok": not inversions, "records": total,
                              "shown": shown_n,
                              "by_kind": dict(sorted(by_kind.items())),
                              "inversions": inversions}))
            return 0 if not inversions else 1
        for r in obs.iter_merged(args.files):
            if not _match(r):
                continue
            hlc = r.get("hlc")
            stamp = (f"{hlc[0]}.{hlc[1]}@{hlc[2]}" if hlc
                     else f"~{r.get('ts', 0):.6f}")
            extras = " ".join(
                f"{k}={v}" for k, v in sorted(r.items())
                if k not in ("kind", "ts", "hlc", "service", "pid"))
            print(f"{stamp:<40} [{r.get('service')}] "
                  f"{r.get('kind')} {extras}".rstrip())
        if inversions:
            print(f"\nCAUSALITY INVERSIONS: {len(inversions)}",
                  file=sys.stderr)
            for f in inversions:
                print(f"  {f['rule']}: {f['detail']} "
                      f"(verb={f.get('verb')})", file=sys.stderr)
        return 0 if not inversions else 1

    records = obs.read_timeline(args.files)
    if args.trace:
        records = records + obs.from_trace_records(
            obs.load_jsonl(args.trace))
    # inversions are checked over the FULL merged set — filters narrow
    # what is shown, never what is proven
    inversions = obs.causality_inversions(records)
    merged = obs.merge_records(records)
    shown = [r for r in merged if _match(r)]

    if args.diff is not None:
        other = obs.read_timeline(args.diff)
        findings = obs.diff_timelines(shown,
                                      [r for r in obs.merge_records(other)
                                       if _match(r)])
        if args.report == "json":
            print(json.dumps({"match": not findings,
                              "only_a": sum(f["count"] for f in findings
                                            if f["only"] == "a"),
                              "only_b": sum(f["count"] for f in findings
                                            if f["only"] == "b")}))
        else:
            for f in findings:
                print(f"only in {'A' if f['only'] == 'a' else 'B'} "
                      f"(x{f['count']}): "
                      f"{json.dumps(f['record'], sort_keys=True)}")
            print(f"{'match' if not findings else 'DIVERGED'}: "
                  f"{len(findings)} differing record shapes")
        return 0 if not findings else 1

    if args.chrome:
        doc = obs.to_chrome(obs.to_trace_records(shown))
        n = obs.validate_chrome(doc)
        with open(args.chrome, "w") as f:
            json.dump(doc, f)
        print(json.dumps({"events": n, "out": args.chrome}))
        return 0

    if args.report == "json":
        by_kind: dict = {}
        for r in shown:
            k = str(r.get("kind", "?"))
            by_kind[k] = by_kind.get(k, 0) + 1
        print(json.dumps({"ok": not inversions, "records": len(merged),
                          "shown": len(shown),
                          "by_kind": dict(sorted(by_kind.items())),
                          "inversions": inversions}))
        return 0 if not inversions else 1

    for r in shown:
        hlc = r.get("hlc")
        stamp = (f"{hlc[0]}.{hlc[1]}@{hlc[2]}" if hlc
                 else f"~{r.get('ts', 0):.6f}")
        extras = " ".join(
            f"{k}={v}" for k, v in sorted(r.items())
            if k not in ("kind", "ts", "hlc", "service", "pid"))
        print(f"{stamp:<40} [{r.get('service')}] "
              f"{r.get('kind')} {extras}".rstrip())
    if inversions:
        print(f"\nCAUSALITY INVERSIONS: {len(inversions)}",
              file=sys.stderr)
        for f in inversions:
            print(f"  {f['rule']}: {f['detail']} "
                  f"(verb={f.get('verb')})", file=sys.stderr)
    return 0 if not inversions else 1


def cmd_incident(args) -> int:
    """Incident forensics (``python -m clonos_tpu_torch incident``): list, dump and
    root-cause-localize the flight-recorder bundles an IncidentManager
    landed under ``<dir>/incidents/``. ``explain`` runs the pure
    deterministic analyzer (obs/rootcause.py) — same bundle, same
    bytes, in any process; ``--report json`` prints the canonical
    one-line report and exits 0 (localized) / 1 (could not localize).
    ``--self-check`` is the conftest gate: synthetic bundles through
    the full pipeline, byte-identity enforced."""
    from clonos_tpu_torch.obs import incident as inc
    from clonos_tpu_torch.obs import rootcause as rc

    if args.self_check:
        findings = inc.incident_self_check()
        print(json.dumps({"ok": not findings, "check": "incident-forensics",
                          "schema": inc.bundle_schema_fingerprint(),
                          "findings": findings}))
        return 0 if not findings else 1

    if args.action is None:
        print("incident: an action (list|show|explain) or --self-check "
              "is required", file=sys.stderr)
        return 2

    bdir = os.path.join(args.dir, "incidents")
    if os.path.isdir(args.dir) and os.path.basename(
            os.path.normpath(args.dir)) == "incidents":
        bdir = args.dir            # already pointed at the bundle dir
    try:
        names = sorted(n for n in os.listdir(bdir)
                       if n.startswith("incident-")
                       and n.endswith(".json"))
    except OSError:
        names = []
    paths = [os.path.join(bdir, n) for n in names]

    if args.action == "list":
        if not paths:
            print(f"no incident bundles under {bdir}")
            return 0
        print(f"{'seq':>4}  {'kind':<20} {'epoch':>5}  "
              f"{'fingerprint':<16} file")
        for path in paths:
            try:
                b = inc.load_bundle(path)
            except (OSError, ValueError):
                print(f"  ??  {'<unreadable>':<20} {'':>5}  {'':<16} "
                      f"{os.path.basename(path)}")
                continue
            info = b.get("bundle", {})
            trig = b.get("trigger", {})
            ep = trig.get("epoch")
            print(f"{info.get('seq', 0):>4}  "
                  f"{trig.get('kind', '?'):<20} "
                  f"{'-' if ep is None else ep:>5}  "
                  f"{info.get('fingerprint', '?'):<16} "
                  f"{os.path.basename(path)}")
        return 0

    # show/explain take a bundle: a path, a seq number, or a substring
    def _resolve(target):
        if target is None:
            return paths[-1] if paths else None   # newest
        if os.path.isfile(target):
            return target
        if target.isdigit():
            want = f"incident-{int(target):04d}-"
            for path in paths:
                if os.path.basename(path).startswith(want):
                    return path
        for path in paths:
            if target in os.path.basename(path):
                return path
        return None

    path = _resolve(args.bundle)
    if path is None:
        print(f"incident: no bundle matching "
              f"{args.bundle!r} under {bdir}", file=sys.stderr)
        return 2
    try:
        bundle = inc.load_bundle(path)
    except (OSError, ValueError) as e:
        print(f"incident: cannot read {path}: {e}", file=sys.stderr)
        return 1

    if args.action == "show":
        print(json.dumps(bundle, indent=2, sort_keys=True))
        return 0

    report = rc.analyze_bundle(bundle)
    ok = str(report.get("verdict", "")).startswith("localized")
    if args.report == "json":
        sys.stdout.write(rc.render_report(report))
        return 0 if ok else 1
    print(f"bundle: {path}")
    print(rc.format_report(report))
    return 0 if ok else 1


def cmd_lineage(args) -> int:
    """Record-level lineage (``python -m clonos_tpu_torch lineage``): reconstruct dyed
    records' causal paths from any number of per-process
    ``lineage-*.jsonl`` observation files (source offset → every
    vertex/step → sink part or serve read, with the ORDER/TIMESTAMP/RNG
    determinant rows that influenced them). The reconstructor is pure
    and order-free, so any process renders the same bytes
    (obs/lineage.render_trace — the rootcause convention).
    ``--report json`` is the CI gate: the canonical one-line report,
    exit 0 (every path reaches a terminus) / 1 (broken paths);
    ``--key`` traces one record; ``--chrome`` exports the paths through
    the same validated trace_event writer as ``python -m clonos_tpu_torch trace``;
    ``--self-check`` is the conftest gate (synthetic observations
    through the full join, byte-identity enforced)."""
    from clonos_tpu_torch import obs
    from clonos_tpu_torch.obs import lineage as lin

    if args.self_check:
        findings = lin.lineage_self_check()
        print(json.dumps({"ok": not findings, "check": "record-lineage",
                          "schema": lin.lineage_schema_fingerprint(),
                          "findings": findings}))
        return 0 if not findings else 1

    if not args.files:
        print("lineage: at least one lineage-*.jsonl file required "
              "(or --self-check)", file=sys.stderr)
        return 2
    try:
        observations = lin.read_observations(args.files)
    except (OSError, ValueError) as e:
        print(f"lineage: {e}", file=sys.stderr)
        return 1

    if args.key is not None:
        report = lin.trace_key(observations, args.key)
        if args.report == "json":
            sys.stdout.write(lin.render_trace(report))
            return 0 if report["ok"] else 1
        path = report["path"]
        if path is None:
            print(f"lineage: key {args.key} was never dyed/observed",
                  file=sys.stderr)
            return 1
        full = lin.reconstruct(observations)
        full["keys"] = {str(args.key): path}
        print(lin.format_trace(dict(full, ok=report["ok"],
                                    broken_keys=path["broken"])),
              end="")
        return 0 if report["ok"] else 1

    report = lin.reconstruct(observations)
    if args.chrome:
        doc = obs.to_chrome(lin.to_trace_records(report))
        n = obs.validate_chrome(doc)
        with open(args.chrome, "w") as f:
            json.dump(doc, f)
        print(json.dumps({"events": n, "out": args.chrome}))
        return 0
    if args.report == "json":
        sys.stdout.write(lin.render_trace(report))
        return 0 if report["ok"] else 1
    print(lin.format_trace(report), end="")
    return 0 if report["ok"] else 1


def cmd_soak(args) -> int:
    """Open-loop soak run (``clonos_tpu_torch soak``): paced load at a fixed
    ingestion rate, a seeded (or explicit) chaos schedule, windowed SLO
    evaluation on coordinated-omission-corrected latency, and the
    exactly-once audit re-validated against a fault-free control twin
    after every injected fault. Writes the full verdict to a durable
    ``SOAK_r0N.json`` artifact and exits 0 (pass) / 1 (fail)."""
    import os
    import tempfile
    from clonos_tpu_torch.soak import (ChaosSchedule, SLOSpec, SoakConfig,
                                       SoakDriver, build_soak_fixture,
                                       default_kill_targets,
                                       next_autoscale_artifact_path,
                                       next_soak_artifact_path,
                                       parse_schedule)

    tracer = _setup_tracer(args, "soak")
    _setup_timeline(args, "soak")
    _setup_profile(args)
    if args.detect_gray:
        from clonos_tpu_torch.obs import configure_detector
        configure_detector()
    workdir = args.workdir or tempfile.mkdtemp(prefix="clonos-soak-")
    if args.incidents:
        # Flight recorder: any failure signal during the soak (audit
        # divergence, SLO breach, gray suspect, conformance mismatch)
        # lands a durable forensic bundle under <workdir>/incidents/;
        # `clonos_tpu_torch incident explain` localizes it afterwards.
        from clonos_tpu_torch.obs import configure_incidents
        configure_incidents(workdir, service="soak")
    if args.lineage:
        # Record-level dye (obs/lineage.py): arm the process plane so
        # build_soak_fixture gives BOTH twins per-twin planes with the
        # same dye config — k records per epoch dyed by key hash, every
        # hop/sink observed at the seals; `clonos_tpu_torch lineage
        # <workdir>/lineage-*.jsonl` reconstructs the paths afterwards.
        from clonos_tpu_torch.obs import configure_lineage
        configure_lineage(workdir, service="soak")
    runner, control, election = build_soak_fixture(
        workdir, rate=args.rate, duration_s=args.duration,
        steps_per_epoch=args.steps_per_epoch, par=args.parallelism,
        batch=args.batch, seed=args.seed, audit=not args.no_audit,
        device=args.device)

    if args.schedule is not None:
        text = args.schedule
        if os.path.exists(text):
            with open(text) as f:
                text = f.read()
        schedule = parse_schedule(text)
    else:
        # one kill/gray candidate per vertex class (a cascade must not
        # take every replica of one vertex with it); fire times stay
        # inside the paced window
        targets = default_kill_targets(runner.job)
        schedule = ChaosSchedule.seeded(
            args.seed, args.duration, targets,
            kinds=tuple(args.faults.split(",")) if args.faults
            else ("kill", "gray", "leader-loss"),
            n_events=args.events, cascade=args.cascade)

    spec = SLOSpec(max_p99_ms=args.max_p99_ms,
                   min_throughput=args.min_throughput,
                   max_recovery_ms=args.max_recovery_ms,
                   exactly_once=not args.no_audit)
    cfg = SoakConfig(rate=args.rate, duration_s=args.duration,
                     window_s=args.window,
                     chunk_steps=args.chunk_steps,
                     complete_every=args.complete_every)
    autoscaler = None
    if args.autoscale:
        # the closed loop: a deterministic policy engine evaluates at
        # every completed fence and re-cuts the job itself (zero
        # operator rescale events); every decision + signal snapshot
        # lands in the SCALE determinant log under the workdir, so a
        # recovered controller REPLAYS it instead of re-deciding.
        from clonos_tpu_torch.autoscale import (AutoscaleController,
                                                DecisionLog, PolicyConfig,
                                                ScalePolicy)
        autoscaler = AutoscaleController(
            ScalePolicy(PolicyConfig(
                min_workers=1, max_workers=max(args.parallelism * 2,
                                               args.parallelism + 2))),
            log=DecisionLog(os.path.join(workdir, "scale.det")))
    driver = SoakDriver(runner, cfg, schedule=schedule, spec=spec,
                        control=control, election=election,
                        records_per_step=args.parallelism * args.batch,
                        autoscaler=autoscaler)

    endpoint = None
    if args.metrics_port is not None:
        from clonos_tpu_torch.utils.metrics import MetricsEndpoint
        endpoint = MetricsEndpoint(runner.metrics,
                                   port=args.metrics_port,
                                   tracer=tracer,
                                   history=_make_history(args))
        print(f"# metrics: http://{endpoint.address[0]}:"
              f"{endpoint.address[1]}/metrics", file=sys.stderr)
    try:
        verdict = driver.run()
    finally:
        if endpoint is not None:
            endpoint.close()

    out_path = args.out or (next_autoscale_artifact_path()
                            if args.autoscale
                            else next_soak_artifact_path())
    with open(out_path, "w") as f:
        json.dump(verdict, f, indent=2)
    rc = 0 if verdict["pass"] else 1
    if args.report == "json":
        # CI convention: one machine-readable line, exit 0/1.
        lat = verdict["latency"]
        line = {
            "pass": verdict["pass"],
            "rate_target": verdict["rate_target"],
            "rate_achieved": verdict["rate_achieved"],
            "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
            "windows_breached": verdict["windows_breached"],
            "faults": verdict["faults"]["injected"],
            "survived": verdict["faults"]["survived"],
            "exactly_once": verdict["audit"]["exactly_once"],
            "divergences": len(verdict["audit"]["divergences"]),
            "artifact": out_path}
        if "autoscale" in verdict:
            asc = verdict["autoscale"]
            line["autoscale_decisions"] = asc["decisions"]
            line["autoscale_rescales"] = asc["autoscale_rescales"]
            line["operator_rescale_events"] = \
                asc["operator_rescale_events"]
        if "health" in verdict:
            hl = verdict["health"]
            line["gray_suspects"] = hl["suspects"]
            line["gray_replay_ok"] = hl["replay_bit_identical"]
        if args.incidents:
            from clonos_tpu_torch.obs.incident import get_incidents
            line["incidents"] = get_incidents().captured
        if args.lineage:
            line["lineage_dyed"] = runner.lineage.dyed
            line["lineage_observations"] = runner.lineage.observations
        print(json.dumps(line))
        return rc
    lat = verdict["latency"]
    print(f"soak {'PASS' if verdict['pass'] else 'FAIL'}: "
          f"{verdict['rate_achieved']:.0f}/{verdict['rate_target']:.0f} "
          f"rec/s over {verdict['duration_s']:.1f}s")
    print(f"latency (corrected): p50={lat['p50_ms']}ms "
          f"p99={lat['p99_ms']}ms p99.9={lat['p999_ms']}ms "
          f"(actual-send p99={lat['actual_send_p99_ms']}ms)")
    f_ = verdict["faults"]
    print(f"faults: {f_['injected']} injected, {f_['survived']} "
          f"survived {f_['by_kind']}; recoveries "
          f"{[round(m) for m in f_['recoveries_ms']]} ms")
    a = verdict["audit"]
    print(f"audit: exactly_once={a['exactly_once']} "
          f"({a['epochs_checked']} epochs checked, "
          f"{len(a['divergences'])} divergences)")
    if "health" in verdict:
        hl = verdict["health"]
        print(f"health: suspects={hl['suspects']} "
              f"gray_events={hl['gray_events']} "
              f"fences_scored={hl['fences_scored']} "
              f"replay_ok={hl['replay_bit_identical']}")
    if "autoscale" in verdict:
        asc = verdict["autoscale"]
        print(f"autoscale: {asc['decisions']} decisions "
              f"{asc['by_action']}; {asc['autoscale_rescales']} "
              f"self-directed re-cuts, "
              f"{asc['operator_rescale_events']} operator events; "
              f"max {asc['max_actions_per_cooldown']} action(s) per "
              f"{asc['cooldown_fences']}-fence cooldown; "
              f"log {asc['log_digest']}")
    for d in a["divergences"]:
        print(f"  divergence: {d}")
    for w in verdict["windows"]:
        for b in w["breaches"]:
            print(f"  window {w['window']} breach: {b}")
    if args.incidents:
        from clonos_tpu_torch.obs.incident import get_incidents
        mgr = get_incidents()
        if mgr.captured:
            print(f"incidents: {mgr.captured} bundle(s) under "
                  f"{mgr.dir} — `clonos_tpu_torch incident explain "
                  f"--dir {workdir}`")
    if args.lineage:
        lin = runner.lineage
        print(f"lineage: {lin.dyed} records dyed, "
              f"{lin.observations} observations across "
              f"{lin.epochs_observed} epochs — `clonos_tpu_torch lineage "
              f"{workdir}/lineage-*.jsonl`")
    print(f"artifact: {out_path}")
    return rc


def cmd_verify(args) -> int:
    """Protocol model checker (``clonos_tpu_torch verify``): exhaustively
    explore the checkpoint / recovery / lease-fencing / admission /
    repartition / scale-policy transition models at a small bound,
    checking every safety invariant on every reachable state and bounded
    liveness on every terminal state. ``--seed-bug model:bug`` injects a
    named protocol defect (verify/models.py BUGS): the checker must then
    find a minimal counterexample (exit 1), which ``--chaos-out``
    compiles into a chaos-DSL schedule that ``soak --schedule FILE``
    replays. Pure Python except ``--conformance``, which replays model
    traces against the port's components (on the host; no device)."""
    from clonos_tpu_torch import verify as _v

    if args.list_bugs:
        for model in sorted(_v.BUGS):
            for bug, what in sorted(_v.BUGS[model].items()):
                print(f"{model}:{bug:20} {what}")
        return 0
    bugs = {}
    for spec in args.seed_bug:
        model, sep, bug = spec.partition(":")
        if not sep:
            print(f"--seed-bug wants model:bug, got {spec!r} "
                  f"(see --list-bugs)", file=sys.stderr)
            return 2
        bugs[model] = bug
    try:
        result = _v.run_verify(
            models=args.model or None, workers=args.workers,
            epochs=args.epochs, faults=args.faults, depth=args.depth,
            max_states=args.max_states, quick=args.quick, bugs=bugs,
            conformance=args.conformance)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    if args.chaos_out:
        os.makedirs(args.chaos_out, exist_ok=True)
        for v in result.violations:
            out = _v.write_counterexample(args.chaos_out, v)
            print(f"counterexample: {out['chaos']}", file=sys.stderr)
    if args.report == "json":
        print(_v.format_json(result))
    else:
        print(_v.format_text(result))
    return result.exit_code()


def cmd_lint(args) -> int:
    """Static determinism lint (``clonos_tpu_torch lint``): check the
    port's pipeline and runtime code against the causal-services
    contract — the audit proves a replay diverged; this names the line
    that made it diverge, before the job ever runs. Standard library
    only: it runs on any machine, with or without torch."""
    from clonos_tpu_torch import lint as _lint

    if args.list_rules:
        for rule in _lint.all_rules():
            print(f"{rule.name:16} {rule.description}")
        return 0
    try:
        result = _lint.run_lint(args.paths, waiver_file=args.waivers,
                                use_waivers=not args.no_waivers,
                                rules=args.rule or None)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    if args.report == "json":
        # CI convention: one machine-readable line, exit 0/1.
        print(_lint.format_json(result))
    else:
        print(_lint.format_text(result, verbose=args.verbose))
    return result.exit_code()


def _pin_gate(actual: str, expect: str, what: str, hint: str) -> int:
    """0 when ``actual`` equals ``expect`` (a hex fingerprint, or a pin
    file whose first token is one), else 1 with a drift message."""
    if os.path.isfile(expect):
        from clonos_tpu_torch.analysis.census import read_pin
        expect = read_pin(expect)
    if actual == expect:
        return 0
    print(f"{what} drift: fingerprint {actual} != pinned {expect} — "
          f"{hint}", file=sys.stderr)
    return 1


def cmd_analyze(args) -> int:
    """Whole-program static analysis (``clonos_tpu_torch analyze``): the
    interprocedural passes the per-file lint cannot run — nondet-escape
    propagation to step functions, the lock-order cycle check, the
    thread-root race detector, and the FT census + static cost model
    (analysis/). Same waiver file, same ``--report json`` one-liner,
    same 0/1 exit convention as the lint; it reads sources and imports
    none of them."""
    from clonos_tpu_torch import analysis as _an

    if args.seed_bug is not None:
        # Self-test: the seeded-bug registry must make its rule bite.
        if args.seed_bug not in _an.SEEDED_BUGS:
            known = ", ".join(sorted(_an.SEEDED_BUGS))
            print(f"unknown seeded bug {args.seed_bug!r} "
                  f"(known: {known})", file=sys.stderr)
            return 2
        findings = _an.seeded_findings(args.seed_bug)
        for f in findings:
            print(f"{f.location()}: [{f.rule}] {f.message}")
        if not findings:
            print(f"seeded bug {args.seed_bug!r} produced NO finding "
                  f"— the race detector lost its teeth",
                  file=sys.stderr)
            return 2
        return 1        # the bug was detected, as it must be

    result = _an.run_analysis(args.paths, waiver_file=args.waivers,
                              use_waivers=not args.no_waivers)
    if args.races:
        # Restrict the report and the exit code to the race pass.
        race_rules = {_an.THREAD_RACE, _an.JOIN_DISCIPLINE}
        kept = [f for f in result.findings
                if f.rule in race_rules
                or any(r in f.message for r in race_rules)]
        result = _an.AnalysisResult(
            findings=kept, files=result.files, census=result.census,
            census_fingerprint=result.census_fingerprint,
            threads=result.threads,
            threads_fingerprint=result.threads_fingerprint)
    if args.report == "json":
        # CI convention: one machine-readable line, exit 0/1.
        print(_an.format_json(result, with_census=not args.no_census))
    elif args.census:
        print(json.dumps(result.census, indent=2, sort_keys=True))
    elif args.threads:
        print(json.dumps(result.threads, indent=2, sort_keys=True))
    else:
        print(_an.format_text(result, verbose=args.verbose))
    rc = result.exit_code()
    if args.expect_census is not None:
        rc = max(rc, _pin_gate(
            result.census_fingerprint, args.expect_census, "census",
            "the FT call-site population changed; review `python -m "
            "clonos_tpu_torch analyze --census` and re-pin the "
            "fingerprint in clonos_tpu_torch/.clonos-census"))
    if args.expect_threads is not None:
        rc = max(rc, _pin_gate(
            result.threads_fingerprint, args.expect_threads,
            "thread-census",
            "the thread-root population changed (a thread was added, "
            "removed, or re-homed); review `python -m clonos_tpu_torch "
            "analyze --threads` and re-pin the fingerprint in "
            "clonos_tpu_torch/.clonos-threads"))
    return rc


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
    pr.add_argument("--timeline-dir", default=None,
                    help="record HLC-stamped causal events to "
                         "timeline-run.jsonl here (off by default)")
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
                    help="multi-host bootstrap: the process group's "
                         "address (host:port, or a tcp:// or file:// URL)")
    pw.add_argument("--num-processes", type=int, default=None)
    pw.add_argument("--process-id", type=int, default=None)
    pw.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend (default: nccl on the card, "
                         "gloo on the CPU)")
    pw.add_argument("--trace-dir", default=None,
                    help="record trace spans to "
                         "trace-<executor-id>.jsonl here")
    pw.add_argument("--timeline-dir", default=None,
                    help="record HLC-stamped causal events to "
                         "timeline-<executor-id>.jsonl here")
    pw.add_argument("--lineage-dir", default=None,
                    help="dye records and write their lineage "
                         "observations to lineage-<executor-id>.jsonl "
                         "here (off by default)")
    pw.add_argument("--sink-dir", default=None,
                    help="back each transactional sink vertex V with "
                         "durable part files under <dir>/v<V>")
    pw.add_argument("--logical-time", action="store_true",
                    help="stamp records from the step count instead of "
                         "the wall clock, so the job's output is a "
                         "function of --seed (a standby rebuilds it with "
                         "logical_time=True)")
    pw.add_argument("--profile", action="store_true",
                    help="attribute fault-tolerance overhead per section "
                         "(overhead.* metrics; off by default)")
    _add_device_arg(pw)
    pw.set_defaults(fn=cmd_worker)

    pd = sub.add_parser("dryrun", help="multi-rank probe: the flagship "
                                       "job sharded over N ranks and on "
                                       "one, one JSON line")
    pd.add_argument("--devices", type=int, default=2,
                    help="ranks (one process each)")
    pd.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend (default: nccl on the card, "
                         "gloo on the CPU; gloo with --device cuda shares "
                         "one card through host memory)")
    pd.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each rank may run")
    _add_device_arg(pd)
    pd.set_defaults(fn=cmd_dryrun)

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
    ps.add_argument("--timeline-dir", default=None,
                    help="record HLC-stamped causal events to "
                         "timeline-<executor-id>.jsonl here; merges "
                         "with the JobMaster's through `timeline` (off "
                         "by default)")
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
    pc.add_argument("--timeline-dir", default=None,
                    help="record HLC-stamped causal events to "
                         "timeline-dispatcher.jsonl here")
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

    pt = sub.add_parser("trace", help="summarize or convert recorded "
                                      "trace JSON-lines files")
    pt.add_argument("files", nargs="+",
                    help="trace-*.jsonl files (a run's set of "
                         "per-process files reconstructs one timeline)")
    pt.add_argument("--chrome", default=None, metavar="OUT",
                    help="write Chrome trace_event JSON (load in "
                         "Perfetto / about:tracing)")
    pt.add_argument("--trace-id", default=None,
                    help="keep only records of this trace id")
    pt.add_argument("--timeline", action="store_true",
                    help="also print the dominant trace's ordered "
                         "event timeline")
    pt.set_defaults(fn=cmd_trace)

    pm = sub.add_parser("timeline",
                        help="merge, check and export causal timelines "
                             "(HLC-ordered, cross-process)")
    pm.add_argument("files", nargs="*",
                    help="timeline-*.jsonl files (each process writes "
                         "one; together they reconstruct ONE causally-"
                         "ordered incident timeline)")
    pm.add_argument("--trace", action="append", default=[],
                    metavar="FILE",
                    help="also merge tracer trace-*.jsonl files "
                         "(wall-clock ordered within their process)")
    pm.add_argument("--kind", default=None,
                    help="show only records whose kind starts with "
                         "this (e.g. msg., epoch.seal, health.)")
    pm.add_argument("--job", default=None,
                    help="show only records of this job / service")
    pm.add_argument("--worker", default=None,
                    help="show only records naming this worker / "
                         "flat subtask")
    pm.add_argument("--epoch", type=int, default=None,
                    help="show only records of this epoch")
    pm.add_argument("--diff", default=None, metavar="FILE",
                    help="second run's timeline file(s); structural "
                         "record diff (volatile fields ignored), "
                         "exit 1 on divergence")
    pm.add_argument("--chrome", default=None, metavar="OUT",
                    help="write Chrome trace_event JSON of the merged "
                         "timeline (validated; load in Perfetto)")
    pm.add_argument("--report", choices=["json"], default=None,
                    help="machine-readable summary for CI: one JSON "
                         "line {ok, records, by_kind, inversions}; "
                         "exit 0 iff zero causality inversions")
    pm.add_argument("--self-check", action="store_true",
                    help="run the deterministic in-memory HLC "
                         "causality self-check instead of reading "
                         "files (the conftest gate)")
    pm.set_defaults(fn=cmd_timeline)

    pn = sub.add_parser("incident",
                        help="list / show / root-cause-explain the "
                             "flight-recorder bundles an incident "
                             "manager landed")
    pn.add_argument("action", nargs="?",
                    choices=["list", "show", "explain"],
                    help="list bundles, dump one, or run the "
                         "deterministic root-cause analyzer on one")
    pn.add_argument("bundle", nargs="?", default=None,
                    help="bundle selector for show/explain: a path, a "
                         "seq number, or a filename substring "
                         "(default: the newest bundle)")
    pn.add_argument("--dir", default=".",
                    help="run workdir holding incidents/ (or the "
                         "incidents/ dir itself); default cwd")
    pn.add_argument("--report", choices=["json"], default=None,
                    help="explain: one canonical JSON line (byte-"
                         "identical across processes); exit 0 "
                         "localized / 1 not")
    pn.add_argument("--self-check", action="store_true",
                    help="run the deterministic forensics self-check "
                         "on synthetic bundles (no files); exit 0/1")
    pn.set_defaults(fn=cmd_incident)

    pg = sub.add_parser("lineage",
                        help="reconstruct dyed records' end-to-end "
                             "causal paths from lineage-*.jsonl "
                             "observation files")
    pg.add_argument("files", nargs="*",
                    help="per-process lineage-*.jsonl files (any "
                         "subset joins; torn tails from a SIGKILLed "
                         "writer are tolerated)")
    pg.add_argument("--key", type=int, default=None, metavar="K",
                    help="trace one record key end to end; exit 1 if "
                         "its path is broken or it was never dyed")
    pg.add_argument("--report", choices=["json"], default=None,
                    help="one canonical JSON line (byte-identical "
                         "across processes); exit 0 when every dyed "
                         "path reaches a terminus / 1 on broken paths")
    pg.add_argument("--chrome", default=None, metavar="OUT",
                    help="export the paths as a validated Chrome "
                         "trace_event file (chrome://tracing, "
                         "Perfetto)")
    pg.add_argument("--self-check", action="store_true",
                    help="run the deterministic lineage self-check on "
                         "synthetic observations (no files); exit 0/1")
    pg.set_defaults(fn=cmd_lineage)

    pa = sub.add_parser("audit", help="print or diff a job's epoch "
                                      "audit ledger")
    pa.add_argument("dir", help="checkpoint dir (or slot-pool "
                                "checkpoint root with g*/ subdirs, or a "
                                "ledger.jsonl file)")
    pa.add_argument("--diff", default=None, metavar="DIR",
                    help="second run's checkpoint dir; exit 1 naming "
                         "the first diverging epoch and channel per "
                         "group (layout-aware: epochs sealed under "
                         "different cuts of one job compare via the "
                         "key-group directory)")
    pa.add_argument("--job", default=None, metavar="ID",
                    help="select one job's ledgers under a dispatcher "
                         "root (<dir>/<job-id>/g*/ledger.jsonl); "
                         "without it a --diff over a multi-job root "
                         "exits 2 listing the available job ids")
    pa.add_argument("--json", action="store_true",
                    help="dump raw ledger entries as JSON")
    pa.add_argument("--report", choices=["json"], default=None,
                    help="machine-readable summary for CI: one JSON "
                         "line {match, groups, problems}; exit code "
                         "stays 0 on match / 1 on divergence")
    pa.set_defaults(fn=cmd_audit)

    pk = sub.add_parser("soak", help="open-loop soak: fixed-rate load "
                                     "+ chaos schedule + SLO windows + "
                                     "exactly-once audit under fault")
    pk.add_argument("--rate", type=float, default=2000.0,
                    help="ingestion rate the token bucket sustains "
                         "(records/sec); chunks falling behind are "
                         "charged from their intended-send instant")
    pk.add_argument("--duration", type=float, default=60.0,
                    help="paced-phase length (seconds of soak clock)")
    pk.add_argument("--window", type=float, default=5.0,
                    help="SLO evaluation window width (seconds)")
    pk.add_argument("--seed", type=int, default=11,
                    help="seeds BOTH the job and the generated chaos "
                         "schedule — same seed, same run, bit for bit")
    pk.add_argument("--schedule", default=None, metavar="DSL|FILE",
                    help="explicit chaos schedule: DSL text (';'-"
                         "separated) or a path to a schedule file; "
                         "overrides the seeded generator")
    pk.add_argument("--faults", default=None,
                    metavar="KIND[,KIND...]",
                    help="fault kinds for the seeded generator "
                         "(default kill,gray,leader-loss; add nondet "
                         "to prove the audit catches an unlogged "
                         "perturbation — that run MUST exit 1)")
    pk.add_argument("--events", type=int, default=None,
                    help="events in the seeded schedule (default: one "
                         "per kind)")
    pk.add_argument("--cascade", type=int, default=3,
                    help="subtasks per cascading kill")
    pk.add_argument("--max-p99-ms", type=float, default=None,
                    help="SLO: per-window corrected p99 bound")
    pk.add_argument("--min-throughput", type=float, default=None,
                    help="SLO: per-window records/sec floor")
    pk.add_argument("--max-recovery-ms", type=float, default=None,
                    help="SLO: bound on any single recovery/pause")
    pk.add_argument("--no-audit", action="store_true",
                    help="skip the control twin + exactly-once "
                         "re-validation (halves the compute; the "
                         "verdict then rests on SLO windows alone)")
    pk.add_argument("--steps-per-epoch", type=int, default=64)
    pk.add_argument("--parallelism", type=int, default=2)
    pk.add_argument("--batch", type=int, default=8)
    pk.add_argument("--chunk-steps", type=int, default=8,
                    help="supersteps per token-bucket release")
    pk.add_argument("--complete-every", type=int, default=2,
                    help="complete every Nth checkpoint (in-between "
                         "fences stay pending: checkpoint-under-load)")
    pk.add_argument("--autoscale", action="store_true",
                    help="close the loop: a deterministic policy "
                         "engine samples the metric rollup at every "
                         "completed fence and re-cuts the job itself "
                         "(rescale_live) — decisions ride the SCALE "
                         "determinant log so recovery replays them; "
                         "the verdict lands in AUTOSCALE_r0N.json")
    pk.add_argument("--workdir", default=None,
                    help="checkpoint/lease dir (default: a fresh "
                         "tempdir)")
    pk.add_argument("--out", default=None, metavar="FILE",
                    help="verdict artifact path (default: next free "
                         "SOAK_r0N.json in the cwd, AUTOSCALE_r0N."
                         "json with --autoscale)")
    pk.add_argument("--report", choices=["json"], default=None,
                    help="machine-readable summary for CI: one JSON "
                         "line; exit 0 pass / 1 fail either way")
    pk.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics + /metrics.json with the "
                         "soak.* gauges while running (0 = ephemeral; "
                         "point `clonos_tpu_torch top` here)")
    pk.add_argument("--trace-dir", default=None,
                    help="record soak/chaos/breach trace spans to "
                         "trace-soak.jsonl here")
    pk.add_argument("--timeline-dir", default=None,
                    help="record the unified causal timeline (chaos / "
                         "epoch seals / scale decisions / SLO breaches "
                         "/ gray suspicion, HLC-stamped) to "
                         "timeline-soak.jsonl here (off by default: "
                         "zero overhead)")
    pk.add_argument("--incidents", action="store_true",
                    help="arm the incident flight recorder: failure "
                         "signals (audit divergence, SLO breach, gray "
                         "suspect, conformance mismatch) land durable "
                         "forensic bundles under <workdir>/incidents/ "
                         "for `clonos_tpu_torch incident explain` (off by "
                         "default: zero overhead, zero wire fields)")
    pk.add_argument("--lineage", action="store_true",
                    help="arm the record-level lineage plane: a "
                         "deterministic sampler dyes k records per "
                         "epoch by key hash (the control twin dyes "
                         "the SAME records, zero coordination) and "
                         "every fence logs their hops, determinant "
                         "rows, and sink/serve termini to "
                         "<workdir>/lineage-*.jsonl for `clonos_tpu_torch "
                         "lineage` (off by default: zero overhead, "
                         "zero wire fields)")
    pk.add_argument("--detect-gray", action="store_true",
                    help="score the gray-failure detector at every "
                         "completed fence (cluster.health.* gauges, "
                         "health.gray-suspect timeline events, and a "
                         "health section in the verdict; feeds the "
                         "autoscaler's unhealthy arm)")
    _add_profile_args(pk)
    _add_device_arg(pk)
    pk.set_defaults(fn=cmd_soak)

    pv = sub.add_parser("verify",
                        help="protocol model checker: exhaustive "
                             "exploration of the checkpoint/recovery/"
                             "lease/admission/repartition/scale-policy "
                             "protocols with chaos-replayable "
                             "counterexamples")
    pv.add_argument("--model", action="append", default=[],
                    metavar="NAME",
                    help="model to check: checkpoint, recovery, lease, "
                         "admission, repartition, scalepolicy "
                         "(repeatable; default: all six)")
    pv.add_argument("--workers", type=int, default=2,
                    help="worker/contender count in the bound "
                         "(default 2)")
    pv.add_argument("--epochs", type=int, default=2,
                    help="checkpoint epochs in the bound (default 2)")
    pv.add_argument("--faults", type=int, default=1,
                    help="injected faults in the bound (default 1)")
    pv.add_argument("--depth", type=int, default=48,
                    help="BFS depth budget (default 48)")
    pv.add_argument("--max-states", type=int, default=200_000,
                    help="state budget per model (default 200000)")
    pv.add_argument("--quick", action="store_true",
                    help="the quick bound: workers=2 epochs=2 faults=1 "
                         "at reduced depth/state budget (sub-second)")
    pv.add_argument("--seed-bug", action="append", default=[],
                    metavar="MODEL:BUG",
                    help="inject a named protocol defect (repeatable); "
                         "the checker must find a counterexample "
                         "(exit 1). See --list-bugs")
    pv.add_argument("--list-bugs", action="store_true",
                    help="print the seeded-bug registry and exit")
    pv.add_argument("--conformance", action="store_true",
                    help="also replay model traces against the port's "
                         "components and fail on observable-transition "
                         "divergence")
    pv.add_argument("--chaos-out", default=None, metavar="DIR",
                    help="compile each counterexample into a chaos-DSL "
                         "schedule (.chaos) + trace (.jsonl) under DIR")
    pv.add_argument("--report", choices=["text", "json"],
                    default="text",
                    help="json = one machine-readable line {ok, bound, "
                         "models, ...}; exit 0 clean / 1 on violations")
    pv.set_defaults(fn=cmd_verify)

    pl = sub.add_parser("lint", help="static determinism lint of "
                                     "pipeline and runtime code")
    pl.add_argument("paths", nargs="*", default=["clonos_tpu_torch"],
                    help="files and/or directories to lint (default: "
                         "clonos_tpu_torch); naming a file directly "
                         "overrides waiver-file `exclude` entries")
    pl.add_argument("--report", choices=["json"], default=None,
                    help="machine-readable summary for CI: one JSON "
                         "line {ok, files, errors, warnings, waived, "
                         "findings}; exit 0 clean / 1 on findings")
    pl.add_argument("--waivers", default=None, metavar="FILE",
                    help="waiver file (default: the package's own "
                         "clonos_tpu_torch/.clonos-waivers)")
    pl.add_argument("--no-waivers", action="store_true",
                    help="ignore all waivers (inline and file) — show "
                         "every raw finding")
    pl.add_argument("--rule", action="append", default=[],
                    metavar="NAME",
                    help="restrict to one rule (repeatable); unknown "
                         "names exit 2")
    pl.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    pl.add_argument("-v", "--verbose", action="store_true",
                    help="also print waived findings")
    pl.set_defaults(fn=cmd_lint)

    pa = sub.add_parser("analyze",
                        help="whole-program static analysis: nondet "
                             "reachability, lock-order cycles, races, "
                             "FT census + cost model")
    pa.add_argument("paths", nargs="*", default=["clonos_tpu_torch"],
                    help="files or directories (default: "
                         "clonos_tpu_torch)")
    pa.add_argument("--report", choices=["text", "json"],
                    default="text",
                    help="json = one machine-readable line {ok, files, "
                         "errors, warnings, waived, census_fingerprint, "
                         "threads_fingerprint, findings, census, "
                         "threads}; exit 0 clean / 1 on findings")
    pa.add_argument("--waivers", default=None, metavar="FILE",
                    help="waiver file (default: the package's own "
                         "clonos_tpu_torch/.clonos-waivers)")
    pa.add_argument("--no-waivers", action="store_true",
                    help="ignore all waivers (inline and file) — show "
                         "every raw finding")
    pa.add_argument("--census", action="store_true",
                    help="print the full FT census as indented JSON "
                         "instead of the findings")
    pa.add_argument("--no-census", action="store_true",
                    help="omit the census and thread bodies from "
                         "--report json (fingerprints stay)")
    pa.add_argument("-v", "--verbose", action="store_true",
                    help="also print waived findings")
    pa.add_argument("--expect-census", default=None, metavar="FP",
                    help="census-drift gate: fail (exit 1) unless the "
                         "census fingerprint equals FP — a hex "
                         "fingerprint or a pin file like "
                         "clonos_tpu_torch/.clonos-census whose first "
                         "token is one")
    pa.add_argument("--races", action="store_true",
                    help="restrict the report and exit code to the "
                         "race pass (thread-race / join-discipline)")
    pa.add_argument("--threads", action="store_true",
                    help="print the thread-root inventory as indented "
                         "JSON instead of the findings")
    pa.add_argument("--expect-threads", default=None, metavar="FP",
                    help="thread-census drift gate: fail (exit 1) "
                         "unless the thread-root fingerprint equals FP "
                         "— a hex fingerprint or a pin file like "
                         "clonos_tpu_torch/.clonos-threads whose first "
                         "token is one")
    pa.add_argument("--seed-bug", default=None, metavar="NAME",
                    help="self-test: run the race pass on a seeded "
                         "concurrency bug (drop-a-join, unguarded-"
                         "cross-thread-write, queue-bypass) — must "
                         "exit 1 with the minimal counterexample")
    pa.set_defaults(fn=cmd_analyze)


    pp = sub.add_parser("top", help="live per-worker cluster view from "
                                    "a JobMaster metrics endpoint")
    pp.add_argument("endpoint",
                    help="metrics endpoint, host:port or http://... "
                         "(the server started with --metrics-port)")
    pp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (scriptable)")
    pp.add_argument("--interval", type=float, default=2.0,
                    help="redraw period in live mode (seconds)")
    pp.set_defaults(fn=cmd_top)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
