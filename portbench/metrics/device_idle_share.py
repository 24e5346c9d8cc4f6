"""Share of the traced stretch, in percent, in which no operation ran on
the card (``torch.profiler``, CUPTI)."""

from portbench.trace import idle_share


def read(ctx):
    share = idle_share(ctx.tracer.summary if ctx.tracer is not None
                       else None)
    return None if share is None else 100.0 * share
