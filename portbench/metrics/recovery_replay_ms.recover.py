"""Mean ``RecoveryReport.phase_ms["replay"]`` over the window's
recoveries (``causal/recovery.py``'s replay)."""

from portbench.harness import mean


def read(ctx):
    return mean(p.get("replay") for p in ctx.results.get("phase_ms", []))
