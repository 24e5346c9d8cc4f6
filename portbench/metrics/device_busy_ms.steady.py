"""Device busy ms per block over the traced stretch: the union of the
intervals in which an operation ran on the card (operators, exchange,
logs, ring), divided by the blocks the stretch ran."""


def read(ctx):
    s = ctx.tracer.summary if ctx.tracer is not None else None
    if not s or not s["steps"] or not s["device_operations"]:
        return None
    return s["busy_s"] * 1e3 / (s["steps"] / ctx.config["block_steps"])
