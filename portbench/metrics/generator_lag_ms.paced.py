"""How late block dispatch ran against the open-loop schedule: the 95th
percentile over the window's blocks of (block handed to the job - its
last record due), on the benchmark's own clock. In a traced run only the
blocks before the traced stretch count: starting and stopping the
profiler delays the schedule."""

from portbench.harness import quantile


def read(ctx):
    lag = ctx.results.get("dispatch_lag_ms")
    tr = ctx.tracer
    if lag and tr is not None and tr.opened_at >= 0:
        cfg = ctx.config
        lag = lag[:tr.opened_at * cfg["steps_per_epoch"]
                  // cfg["block_steps"]]
    return quantile(lag, 0.95) if lag else None
