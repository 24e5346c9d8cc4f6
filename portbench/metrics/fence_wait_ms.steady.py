"""Mean wall ms an epoch waited for its fence: the runner's
``last_fence_phases["fence-tail"]`` after each epoch of the window
(``runtime/cluster.py``, ``runtime/checkpoint.py``)."""

from portbench.harness import mean


def read(ctx):
    return mean(ctx.results.get("fence_tail_ms", []))
