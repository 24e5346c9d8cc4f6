"""In-flight log: the device ring of one producer's output batches, kept
for replay after a downstream failure.

Port of the device-ring half of ``clonos_tpu/inflight/log.py`` (host spill
comes with a later slice). A ring is a ``[S, P, cap]`` tensor per record
field over supersteps, with the causal log's absolute-offset and
epoch-index discipline.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from clonos_tpu_torch.api.records import RecordBatch
from clonos_tpu_torch.device import scalar as _i32


class EdgeLogState(NamedTuple):
    """Device ring of one producer's output batches, indexed by absolute
    superstep; ring position = offset & (S-1)."""

    keys: torch.Tensor          # int32[S, P, cap]
    values: torch.Tensor        # int32[S, P, cap]
    timestamps: torch.Tensor    # int32[S, P, cap]
    valid: torch.Tensor         # bool[S, P, cap]
    head: torch.Tensor          # int32 scalar: absolute steps appended
    tail: torch.Tensor          # int32 scalar: oldest retained step
    epoch_starts: torch.Tensor  # int32[max_epochs]
    epoch_base: torch.Tensor    # int32 scalar
    latest_epoch: torch.Tensor  # int32 scalar

    @property
    def ring_steps(self) -> int:
        return self.keys.shape[0]

    @property
    def max_epochs(self) -> int:
        return self.epoch_starts.shape[0]


def create(ring_steps: int, parallelism: int, capacity: int,
           max_epochs: int, device) -> EdgeLogState:
    if ring_steps & (ring_steps - 1):
        raise ValueError(
            f"ring_steps must be a power of two, got {ring_steps}")
    shape = (ring_steps, parallelism, capacity)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return EdgeLogState(
        keys=z(*shape), values=z(*shape), timestamps=z(*shape),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        head=z(), tail=z(), epoch_starts=z(max_epochs), epoch_base=z(),
        latest_epoch=z())


def size(state: EdgeLogState) -> torch.Tensor:
    return state.head - state.tail


def overflowed(state: EdgeLogState) -> torch.Tensor:
    """True when un-truncated steps exceed the ring."""
    return size(state) > state.ring_steps


def append_block(state: EdgeLogState, block: RecordBatch) -> EdgeLogState:
    """Log a block of K steps' batches (``[K, P, cap]``). K must be <=
    ring_steps, so ring positions are unique.

    Updates the ring storage IN PLACE (the returned state shares it): the
    rings are the carry's largest tensors, and a copy per block would add
    their whole size to every block's memory traffic. Callers that keep
    an older state must copy it first (``LocalExecutor.lean_snapshot``
    holds no ring storage)."""
    K = block.keys.shape[0]
    idx = ((state.head + torch.arange(K, dtype=torch.int32,
                                      device=state.head.device))
           & (state.ring_steps - 1)).to(torch.int64)
    state.keys[idx] = block.keys
    state.values[idx] = block.values
    state.timestamps[idx] = block.timestamps
    state.valid[idx] = block.valid
    return state._replace(head=state.head + K)


def start_epoch(state: EdgeLogState, epoch_id) -> EdgeLogState:
    """Record epoch ``epoch_id``'s replay-start offset (= ``head``)."""
    e = int(epoch_id)
    starts = state.epoch_starts.clone()
    starts[e % state.max_epochs] = state.head
    return state._replace(epoch_starts=starts,
                          latest_epoch=state.latest_epoch.clamp(min=e))


def epoch_start_step(state: EdgeLogState, epoch_id) -> torch.Tensor:
    return state.epoch_starts[int(epoch_id) % state.max_epochs]


def truncate(state: EdgeLogState, completed_epoch) -> EdgeLogState:
    """Checkpoint complete: drop steps of epochs <= completed_epoch."""
    e = int(completed_epoch)
    new_tail = torch.maximum(epoch_start_step(state, e + 1), state.tail)
    return state._replace(tail=new_tail,
                          epoch_base=state.epoch_base.clamp(min=e + 1))


def _gather_steps(state: EdgeLogState, start: torch.Tensor, max_out: int
                  ) -> Tuple[RecordBatch, torch.Tensor]:
    count = (state.head - start).clamp(0, max_out)
    idx = torch.arange(max_out, dtype=torch.int32, device=state.head.device)
    pos = ((start + idx) & (state.ring_steps - 1)).to(torch.int64)
    live = (idx < count)[:, None, None]
    return RecordBatch(
        keys=torch.where(live, state.keys[pos], 0),
        values=torch.where(live, state.values[pos], 0),
        timestamps=torch.where(live, state.timestamps[pos], 0),
        valid=state.valid[pos] & live), count


def slice_steps_at(state: EdgeLogState, abs_step, max_out: int
                   ) -> RecordBatch:
    """Gather ``max_out`` steps from exactly ``abs_step`` with NO tail
    clamp: slots before the tail come back as whatever the ring holds
    there — the caller masks them (recovery's replay windows start one
    slot before the fence)."""
    return _gather_steps(state, _i32(abs_step, state.head.device),
                         max_out)[0]


def slice_steps(state: EdgeLogState, abs_step, max_out: int
                ) -> Tuple[RecordBatch, torch.Tensor, torch.Tensor]:
    """Gather up to ``max_out`` retained steps from ``abs_step``:
    ``(stacked RecordBatch [max_out, P, cap], count, start)``."""
    start = torch.maximum(_i32(abs_step, state.head.device), state.tail)
    batch, count = _gather_steps(state, start, max_out)
    return batch, count, start
