"""Device ms of host-to-device copies per block over the traced stretch:
the host boundary's uploads (``api/feeds.py``, the executor's
``_pull_feeds``: one pinned copy per block per feed)."""


def read(ctx):
    s = ctx.tracer.summary if ctx.tracer is not None else None
    if not s or not s["steps"] or not s["h2d_s"]:
        return None
    return s["h2d_s"] * 1e3 / (s["steps"] / ctx.config["block_steps"])
