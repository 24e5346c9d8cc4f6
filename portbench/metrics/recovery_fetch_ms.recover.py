"""Mean ``RecoveryReport.phase_ms["fetch_determinants"]`` over the
window's recoveries (``runtime/cluster.py`` ``recover``)."""

from portbench.harness import mean


def read(ctx):
    return mean(p.get("fetch_determinants")
                for p in ctx.results.get("phase_ms", []))
