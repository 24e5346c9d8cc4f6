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

``worker`` is the TaskExecutor process: it registers with a remote
JobMaster (naming its device and which path frames its deltas) and
heartbeats, writes durable checkpoints, prints one JSON
status line per epoch with the state digest, and serves its determinant
logs at every fence to the standby host's mirrors
(``runtime/remote.py``). It is one process on one card: the multi-host
bootstrap flags (``--coordinator``, ``--num-processes``,
``--process-id``) are refused.
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
