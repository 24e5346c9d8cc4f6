"""Mean host ms of one ``CompiledJob.run_block`` call
(``runtime/executor.py``), timed by the benchmark around the call on the
runner's instance: the dispatch of a block's operations."""

from portbench.harness import mean


def read(ctx):
    return mean(ctx.block_host_ms)
