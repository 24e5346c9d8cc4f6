"""Backlog kill: a long checkpoint interval that fails late. Warm-up runs
one epoch whose checkpoint completes, ``prewarm_recovery()``, then
``pending_epochs`` epochs whose checkpoints stay pending, with the join's
external calls before each; the window then kills and recovers over and
over with no step between kills, so every recovery replays the whole
backlog. The kill set rotates over the cell's ``kills`` (vertex names
killed together), one subtask of each drawn from the seed.

Each report is let go once read and its external calls checked: the
runner would otherwise keep every recovery's replayed outputs on the
card for the life of the job. Outside each recovery's timing, the
replicas of the killed subtasks' logs, and those they hold, are read
back before the kill and after the recovery.

A recovery's time runs from ``inject_failure`` to ``recover()``
returning with the card synchronised. ``recovery_ms_p90`` is the 90th
percentile over every recovery in the window.

In a traced run the program's tracer is on over the window (installed
here, after warm-up) and its records are kept as ``ctx.spans``.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from portbench.harness import log, mean, quantile

#: the program tracer's ring over a traced window: well above the
#: records of the recoveries a 40-s window holds
SPAN_BUFFER = 1 << 18


def warmup(ctx) -> None:
    r = ctx.runner
    cfg = ctx.config
    t0 = time.perf_counter()
    r.run_epoch(complete_checkpoint=True)
    r.drain_fence()
    r.prewarm_recovery()
    for e in range(cfg["pending_epochs"]):
        ctx.services.call_all(e)
        r.run_epoch(complete_checkpoint=False)
    r.drain_fence()
    ctx.sync()
    fill_s = time.perf_counter() - t0
    dets = int(r.executor.log_sizes().sum())
    steps = ctx.steps_executed()
    records = steps * ctx.topology.records_per_step(cfg)
    log(f"[backlog_kill] fill: {steps} steps, {records} records in "
        f"{fill_s:.3f} s ({records / fill_s:.0f} records/s); {dets} "
        f"buffered determinants")
    if dets < ctx.cell["min_determinants"]:
        raise RuntimeError(f"{dets} buffered determinants before the first "
                           f"kill, fewer than {ctx.cell['min_determinants']}")


def run(ctx) -> dict:
    r = ctx.runner
    job = r.job
    vid = {v.name: v.vertex_id for v in job.vertices}
    kills = ctx.cell["kills"]
    rng = ctx.rng("kills")
    snapshot = ctx.topology.snapshot_state
    tracer = None
    if ctx.trace:
        from clonos_tpu_torch import obs
        tracer = obs.configure("portbench", buffer=SPAN_BUFFER)
    rec_ms, phases, recovered, kinds = [], [], [], []
    bad_services = bad_replicas = 0
    replicas = ctx.topology.replica_mismatches
    cycles = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    try:
        while True:
            ctx.tick(cycles, time.perf_counter() - t0)
            kind = kills[cycles % len(kills)]
            flats = [job.subtask_base(vid[name]) + int(rng.integers(
                job.vertices[vid[name]].parallelism)) for name in kind]
            r.drain_fence()
            bad_replicas += replicas(ctx, flats)
            ctx.sync()
            t = time.perf_counter()
            with record_function("portbench.recover"):
                r.inject_failure(flats)
                rep = r.recover()
                ctx.sync()
            rec_ms.append((time.perf_counter() - t) * 1e3)
            phases.append(dict(rep.phase_ms))
            bad_services += ctx.services.mismatches(rep)
            # The runner keeps every report, and each holds its replayed
            # output chunks on the card: read, it is let go.
            r.reports.clear()
            del rep
            bad_replicas += replicas(ctx, flats)
            kinds.append("+".join(kind))
            recovered.append((ctx.steps_executed(), snapshot(ctx)))
            cycles += 1
            if not ctx.window_open(deadline):
                break
        wall = time.perf_counter() - t0
        ctx.tick(cycles, wall, final=True)
    finally:
        if tracer is not None:
            from clonos_tpu_torch import obs
            ctx.spans = tracer.records()
            ctx.spans_dropped = tracer.dropped
            obs.reset()
    by_kind = {}
    for k, ms in zip(kinds, rec_ms):
        by_kind.setdefault(k, []).append(ms)
    log("[backlog_kill] recovery ms by kill, n / p50 / p90 / max: "
        + "; ".join(f"{k} {len(v)} / {quantile(v, .5):.2f} / "
                    f"{quantile(v, .9):.2f} / {max(v):.2f}"
                    for k, v in by_kind.items()))
    names = sorted({n for p in phases for n in p})
    log("[backlog_kill] mean phase ms: " + ", ".join(
        f"{n} {mean(p.get(n) for p in phases):.2f}" for n in names))
    return {
        "attempted": cycles,
        "failed": 0,
        "recovery_ms_p90": quantile(rec_ms, 0.9),
        "recovery_kinds": kinds,
        "phase_ms": phases,
        "recovered": recovered,
        "service_mismatches": bad_services,
        "replica_mismatches": bad_replicas,
    }
