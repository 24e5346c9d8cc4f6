"""Spanning job: one job deployed across several slot-worker processes
(the port's copy of ``examples/spanning.py``).

The SocketWindowWordCount shape arranged for the slot-pool scheduler
(``runtime/scheduler.py``): a fed source slice and a keyed-window slice,
cut on the HASH exchange between them. With two slot workers the
scheduler places ``[lines, tag]`` on one process and ``[window, sink]``
on the other; records cross between them over the edge-export wire.

Run (the feed is any line server, e.g. ``nc -lk 9999``):
    python -m clonos_tpu_torch slotworker --jm HOST:PORT --executor-id a
    python -m clonos_tpu_torch slotworker --jm HOST:PORT --executor-id b
    # then drive SlotPoolScheduler.deploy() with the job spec
    # clonos_tpu_torch.examples.spanning:build_job
"""

from clonos_tpu_torch.api.environment import StreamEnvironment

VOCAB = 256
WINDOW_MS = 500
BATCH = 8


def build_job():
    """lines -> tag -> (HASH) -> window -> sink.

    ``lines`` is a HostFeedSource at parallelism 1 (fed from outside, a
    SocketFeedReader in the distributed tests); ``tag`` rides the same
    slice on a FORWARD edge; the key_by HASH exchange is the only legal
    slice boundary, so two workers always split exactly there."""
    env = StreamEnvironment(name="spanning-wordcount", num_key_groups=64)
    (env.host_source(batch_size=BATCH, parallelism=1, name="lines")
        .map(lambda k, v, t: (k % VOCAB, v, t), name="tag")
        .key_by()
        .window_count(num_keys=VOCAB, window_size=WINDOW_MS, name="window")
        .sink(name="sink"))
    return env.build()
