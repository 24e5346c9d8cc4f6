"""Shared settings of the benchmark's CPU tests: a tiny copy of each
configuration, small enough that a whole run takes about a second."""

import pytest
import torch

#: overrides that shrink both configurations and every cell alike
TINY = dict(parallelism=4, batch=16, vocab=37, edge_capacity=64,
            fire_interval_steps=8, steps_per_epoch=32, block_steps=16,
            inflight_ring_steps=64, log_capacity=512, pool_records=1024,
            warmup_epochs=1)

CELLS = ("allround.steady", "allround.recover", "kafka_window.paced")


def tiny(cell: str) -> dict:
    ov = dict(TINY)
    if cell.endswith("paced"):
        # 20 epochs a second: a tiny CPU job keeps up with it.
        ov["rate_records_per_s"] = 4 * 16 * 32 * 20
    return ov


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
