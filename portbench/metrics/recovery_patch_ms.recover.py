"""Mean ``RecoveryReport.phase_ms["patch"]`` over the window's recoveries
(``runtime/cluster.py`` ``recover``: the replayed state and outputs
written into the live carry, with the wait for the deferred replay)."""

from portbench.harness import mean


def read(ctx):
    return mean(p.get("patch") for p in ctx.results.get("phase_ms", []))
