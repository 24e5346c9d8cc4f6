"""Kill cycle: one epoch whose checkpoint completes, one left pending, then
a kill at the fence, over and over. The kill set rotates over the
cell's ``kills`` (vertex names killed together), one subtask of each
drawn from the seed; ``recover()`` replays the pending epoch and ignores
its checkpoint, and the cycle goes on.

Each report is let go once read: the runner would otherwise keep every
recovery's replayed outputs on the card for the life of the job.

A recovery's time runs from ``inject_failure`` to ``recover()``
returning with the card synchronised; the fence and the card are
settled before the kill, so it holds the recovery alone.
``recovery_ms_p90`` is the 90th percentile over every recovery in the
window.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from portbench.harness import log, quantile


def warmup(ctx) -> None:
    for _ in range(ctx.cell["warmup_epochs"]):
        ctx.runner.run_epoch(complete_checkpoint=True)
    ctx.runner.drain_fence()
    ctx.runner.prewarm_recovery()


def run(ctx) -> dict:
    r = ctx.runner
    job = r.job
    vid = {v.name: v.vertex_id for v in job.vertices}
    kills = ctx.cell["kills"]
    rng = ctx.rng("kills")
    snapshot = ctx.topology.snapshot_state
    rec_ms, phases, recovered, kinds = [], [], [], []
    cycles = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        ctx.tick(cycles, time.perf_counter() - t0)
        with record_function("portbench.run_epoch"):
            r.run_epoch(complete_checkpoint=True)
            r.run_epoch(complete_checkpoint=False)
        kind = kills[cycles % len(kills)]
        flats = [job.subtask_base(vid[name]) + int(rng.integers(
            job.vertices[vid[name]].parallelism)) for name in kind]
        r.drain_fence()
        ctx.sync()
        t = time.perf_counter()
        with record_function("portbench.recover"):
            r.inject_failure(flats)
            rep = r.recover()
            ctx.sync()
        rec_ms.append((time.perf_counter() - t) * 1e3)
        phases.append(dict(rep.phase_ms))
        # The runner keeps every report, and each holds its replayed
        # output chunks on the card: read, it is let go (PERF.md, Open
        # questions), or a window of kills fills the card.
        r.reports.clear()
        del rep
        kinds.append("+".join(kind))
        recovered.append((ctx.steps_executed(), snapshot(ctx)))
        cycles += 1
        if not ctx.window_open(deadline):
            break
    wall = time.perf_counter() - t0
    ctx.tick(cycles, wall, final=True)
    by_kind = {}
    for k, ms in zip(kinds, rec_ms):
        by_kind.setdefault(k, []).append(ms)
    log("[kill_cycle] recovery ms by kill, p50 / p90 / max: " + "; ".join(
        f"{k} {quantile(v, .5):.2f} / {quantile(v, .9):.2f} / {max(v):.2f}"
        for k, v in by_kind.items()))
    worst = max(range(len(rec_ms)), key=rec_ms.__getitem__)
    log(f"[kill_cycle] slowest recovery {rec_ms[worst]:.2f} ms "
        f"({kinds[worst]}), phases ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in phases[worst].items()))
    return {
        "attempted": cycles,
        "failed": 0,
        "recovery_ms_p90": quantile(rec_ms, 0.9),
        "recovery_kinds": kinds,
        "phase_ms": phases,
        "recovered": recovered,
    }
