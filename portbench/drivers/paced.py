"""Open loop: records arrive evenly at the cell's fixed rate, whatever the
job does, and each block is dispatched when its records are due
(``feeds.PacedFeed`` holds the block's pull until its last record has
arrived). The window holds the whole epochs that the rate fills in
``--seconds``, so every seed offers the same work.

A record's latency runs from its scheduled arrival to the completion on
the card of the block that carries it to the sink, read by a thread
that waits on an event recorded behind each block. A block dispatched
late charges every record in it the wait (coordinated omission
corrected). ``latency_ms_p95`` is the 95th percentile over all records
of the window, each block's records spread evenly over its span.
"""

from __future__ import annotations

import queue
import threading
import time

import torch
from torch.profiler import record_function

from portbench.harness import log, quantile

#: evenly spaced records standing for a block's arrivals
POINTS_PER_BLOCK = 64


class Completions:
    """Host times at which each block queued since :meth:`arm` finished on
    the card."""

    def __init__(self, device):
        self.device = device
        self.armed = False
        self.times = []
        self._q: "queue.Queue" = queue.Queue()
        self._thread = None

    def arm(self) -> None:
        self.armed = True
        if self.device.type == "cuda":
            self._thread = threading.Thread(target=self._wait, daemon=True)
            self._thread.start()

    def __call__(self, _t, _stamp) -> None:          # a block listener
        if not self.armed:
            return
        if self.device.type != "cuda":
            self.times.append(time.perf_counter())
            return
        ev = torch.cuda.Event(blocking=True)
        ev.record()
        self._q.put(ev)

    def _wait(self) -> None:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            ev.synchronize()
            self.times.append(time.perf_counter())

    def close(self) -> None:
        self.armed = False
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()


def warmup(ctx) -> None:
    for _ in range(ctx.cell["warmup_epochs"]):
        ctx.runner.run_epoch(complete_checkpoint=True)
    ctx.runner.drain_fence()


def run(ctx) -> dict:
    r = ctx.runner
    feed = ctx.feed
    rate = float(ctx.cell["rate_records_per_s"])
    per_epoch = ctx.records_per_epoch
    epochs = max(1, int(ctx.seconds * rate // per_epoch))
    done = Completions(ctx.device)
    r.executor.block_listeners.append(done)
    done.arm()
    t0 = time.perf_counter()
    feed.start(rate, t0)
    for e in range(epochs):
        ctx.tick(e, time.perf_counter() - t0)
        with record_function("portbench.run_epoch"):
            r.run_epoch(complete_checkpoint=True)
    feed.stop()
    with record_function("portbench.drain"):
        r.drain_fence()
    ctx.sync()
    wall = time.perf_counter() - t0
    done.close()
    ctx.tick(epochs, wall, final=True)
    r.executor.block_listeners.remove(done)
    blocks = feed.blocks
    if len(blocks) != len(done.times):
        raise RuntimeError(f"{len(blocks)} blocks pulled, "
                           f"{len(done.times)} completed")
    span = per_epoch / rate / (len(blocks) // epochs)
    lat = []
    for (due, _), end in zip(blocks, done.times):
        lat.extend(end - (due - span * (j + 0.5) / POINTS_PER_BLOCK)
                   for j in range(POINTS_PER_BLOCK))
    lag_ms = [(got - due) * 1e3 for due, got in blocks]
    log(f"[paced] {len(blocks)} blocks of {span * 1e3:.1f} ms; dispatch lag "
        f"ms p50 {quantile(lag_ms, 0.5):.3f} p95 {quantile(lag_ms, 0.95):.3f} "
        f"max {max(lag_ms):.3f}; latency ms p50 "
        f"{quantile(lat, 0.5) * 1e3:.2f} max {max(lat) * 1e3:.2f}")
    return {
        "attempted": epochs,
        "failed": 0,
        "latency_ms_p95": quantile(lat, 0.95) * 1e3,
        "latency_ms_p50": quantile(lat, 0.5) * 1e3,
        "dispatch_lag_ms": lag_ms,
        "records_per_s": epochs * per_epoch / wall,
    }
