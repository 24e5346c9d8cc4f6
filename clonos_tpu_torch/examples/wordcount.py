"""SocketWindowWordCount (the port's copy of ``examples/wordcount.py``).

The reference's demo job (flink-examples-streaming
.../socket/SocketWindowWordCount.java): words from a socket (or a
synthetic generator), keyed tumbling-window counts, printed at the sink.

Run:
    python -m clonos_tpu_torch run \\
        clonos_tpu_torch.examples.wordcount:build_job --epochs 4
"""

from clonos_tpu_torch.api.environment import StreamEnvironment

VOCAB = 1000
WINDOW_MS = 500


def build_job():
    """4 synthetic sources x 64 words a step -> keyBy (64 key groups) ->
    4 tumbling windows over 1,000 keys -> 4 sinks."""
    env = StreamEnvironment(name="socket-window-wordcount",
                            num_key_groups=64)
    (env.synthetic_source(vocab=VOCAB, batch_size=64, parallelism=4,
                          name="words")
        .key_by()
        .window_count(num_keys=VOCAB, window_size=WINDOW_MS, name="window")
        .sink(name="print"))
    return env.build()


#: :func:`build_txn_job`'s window: under logical time (1 ms a step) it
#: fires every 16 steps, so a few epochs already commit records
TXN_WINDOW_MS = 16


def build_txn_job():
    """:func:`build_job` with an exactly-once sink: the window counts go
    to a transactional sink (``sink(transactional=True)``), whose epochs
    commit with their checkpoints (back it with part files through
    ``ClusterRunner.attach_file_sink``, or the worker's ``--sink-dir``).
    Its windows are ``TXN_WINDOW_MS`` long."""
    env = StreamEnvironment(name="socket-window-wordcount",
                            num_key_groups=64)
    (env.synthetic_source(vocab=VOCAB, batch_size=64, parallelism=4,
                          name="words")
        .key_by()
        .window_count(num_keys=VOCAB, window_size=TXN_WINDOW_MS,
                      name="window")
        .sink(name="print", transactional=True))
    return env.build()


def build_socket_job(host: str = "localhost", port: int = 9999):
    """The literal socket variant: lines ``key[:value]`` over TCP, read by
    a :class:`~clonos_tpu_torch.api.feeds.SocketFeedReader` registered on
    vertex 0 (``ClusterRunner.executor.register_feed``)."""
    env = StreamEnvironment(name="socket-window-wordcount",
                            num_key_groups=64)
    (env.host_source(batch_size=64, parallelism=1, name="socket")
        .key_by()
        .window_count(num_keys=VOCAB, window_size=WINDOW_MS, name="window")
        .sink(name="print"))
    return env.build()
