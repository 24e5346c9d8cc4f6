"""The flagship job (the port's copy of ``__graft_entry__._flagship_job``):
keyed windowed wordcount with full causal logging, in-flight logging and
determinant replication — the job ``dryrun`` shards over its ranks."""

from __future__ import annotations


def flagship_job(parallelism: int, num_key_groups: int = 64):
    """Synthetic source (211 keys, 32 records a step per subtask) ->
    keyBy -> tumbling window count (64 steps) -> keyBy -> reduce -> sink,
    every vertex at ``parallelism``."""
    from clonos_tpu_torch.api.environment import StreamEnvironment

    env = StreamEnvironment(name="flagship-wordcount",
                            num_key_groups=num_key_groups,
                            default_edge_capacity=128)
    (env.synthetic_source(vocab=211, batch_size=32, parallelism=parallelism)
        .key_by()
        .window_count(num_keys=211, window_size=64, name="window")
        .key_by()
        .reduce(num_keys=211, name="reduce")
        .sink())
    return env.build()
