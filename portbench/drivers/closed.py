"""Closed loop: epochs back to back, a checkpoint completed at every fence,
the fence pipelined behind the next epoch's blocks, no faults.

``records_per_s`` is every source record of the epochs run in the
window over the window's whole wall time, which ends when the last
fence has drained and the card has finished.
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from portbench.harness import log


def warmup(ctx) -> None:
    for _ in range(ctx.cell["warmup_epochs"]):
        ctx.runner.run_epoch(complete_checkpoint=True)
    ctx.runner.drain_fence()


def run(ctx) -> dict:
    r = ctx.runner
    fence_tail, walls = [], []
    epochs = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        ctx.tick(epochs, time.perf_counter() - t0)
        t = time.perf_counter()
        with record_function("portbench.run_epoch"):
            r.run_epoch(complete_checkpoint=True)
        walls.append((time.perf_counter() - t) * 1e3)
        if epochs:
            # The fence joined in this call is the previous epoch's.
            fence_tail.append(r.last_fence_phases.get("fence-tail"))
        epochs += 1
        if not ctx.window_open(deadline):
            break
    with record_function("portbench.drain"):
        r.drain_fence()
    ctx.sync()
    wall = time.perf_counter() - t0
    ctx.tick(epochs, wall, final=True)
    log("[closed] epoch host ms: quartiles "
        + ", ".join(f"{q:.2f}" for q in np.quantile(walls, [.25, .5, .75]))
        + f", max {max(walls):.2f}, {epochs} epochs")
    return {
        "attempted": epochs,
        "failed": 0,
        "records_per_s": epochs * ctx.records_per_epoch / wall,
        "fence_tail_ms": fence_tail,
    }
