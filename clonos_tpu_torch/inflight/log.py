"""In-flight log: the device ring of one producer's output batches, kept
for replay after a downstream failure.

Port of ``clonos_tpu/inflight/log.py``:

- the hot path is a **device ring**: a ``[S, P, cap]`` tensor per record
  field over supersteps, with the causal log's absolute-offset and
  epoch-index discipline;
- **spill** (:class:`SpillingInFlightLog`) moves a closed epoch's steps
  to the host and disk tiers of a ``storage.TieredEpochStore``, one
  segment file per epoch so truncation deletes files. The device-to-host
  copy starts on the thread that calls :meth:`spill_epoch` (the one that
  queued the ring's blocks); the store's writer thread only waits for it;
- **replay** of spilled epochs (:class:`ReplayIterator`) is a
  producer/consumer iterator whose prefetch thread reads epochs back as
  numpy arrays in step order; the consumer uploads them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch
from clonos_tpu_torch.device import HostCopy
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


def append_step(state: EdgeLogState, batch: RecordBatch) -> EdgeLogState:
    """Log one superstep's routed batch (``[P, cap]``; reference
    InFlightLog.log): :func:`append_block` of a block of one step, in
    place as it is."""
    return append_block(state, RecordBatch(*(x[None] for x in batch)))


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


# --- host spill path ---------------------------------------------------------


class SpillPolicy:
    """When to move closed-epoch step ranges out of the device ring."""

    EAGER = "eager"                # spill every epoch as soon as it closes
    AVAILABILITY = "availability"  # spill when ring occupancy crosses a ratio
    DISABLED = "disabled"          # in-memory only


class SpillingInFlightLog:
    """Host-side owner of one ring vertex's spilled epochs: a RecordBatch
    adapter over :class:`storage.TieredEpochStore` (one checksummed
    segment per epoch, so truncation deletes files). A flush failure
    keeps the data host-resident, so replay still works."""

    def __init__(self, spool_dir: Optional[str], edge_id: int,
                 policy: str = SpillPolicy.EAGER,
                 availability_trigger: float = 0.3,
                 host_budget_epochs: Optional[int] = 2):
        from clonos_tpu_torch.storage import TieredEpochStore
        self.edge_id = edge_id
        self.policy = policy
        self.availability_trigger = availability_trigger
        self.store = TieredEpochStore(
            spool_dir, f"edge{edge_id}",
            durable=bool(spool_dir) and policy != SpillPolicy.DISABLED,
            host_budget_epochs=host_budget_epochs)

    def spill_epoch(self, epoch: int, start_step: int,
                    batches: RecordBatch) -> None:
        """Accept one closed epoch's stacked steps (``[n, P, cap]`` per
        field, tensors or numpy). Tensors must be fresh (not views of a
        ring later blocks overwrite): their copies to pinned host memory
        start here, on the calling thread."""
        self.store.put(epoch, start_step, HostCopy({
            "keys": batches.keys, "values": batches.values,
            "timestamps": batches.timestamps, "valid": batches.valid}))

    def truncate(self, completed_epoch: int) -> None:
        self.store.truncate(completed_epoch)

    def retained_epochs(self) -> List[int]:
        return self.store.retained_epochs()

    def load_epoch(self, epoch: int) -> Tuple[int, RecordBatch]:
        """One epoch back as ``(start_step, RecordBatch of numpy
        [n, P, cap])`` from whichever tier holds it. Host arrays: the
        caller uploads them on the thread that drives the card."""
        start, p = self.store.load_epoch(epoch)
        return start, RecordBatch(p["keys"], p["values"], p["timestamps"],
                                  p["valid"])

    def attach_digest(self, epoch: int, digest: str) -> None:
        """Pin the audit ledger's ring-channel digest on the spilled
        epoch's segment."""
        self.store.attach_digest(epoch, digest)

    def drain(self) -> None:
        """Block until pending spill writes are durable."""
        self.store.drain()

    def close(self) -> None:
        self.store.close()


class ReplayIterator:
    """Prefetching replay of epochs ``[from_epoch, to_epoch]`` in step
    order: a producer thread reads epochs ahead into a bounded queue (host
    reads only — it never touches the card); the consumer blocks on the
    queue head. ``skip_steps`` skips already-delivered steps of the first
    epoch."""

    def __init__(self, log: SpillingInFlightLog, from_epoch: int,
                 to_epoch: int, skip_steps: int = 0, prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._epochs = [e for e in log.retained_epochs()
                        if from_epoch <= e <= to_epoch]
        self._log = log
        self._skip = skip_steps
        self._stop = False
        self._t = threading.Thread(target=self._produce, daemon=True,
                                   name=f"replay-edge{log.edge_id}")
        self._t.start()

    def close(self) -> None:
        """Release the producer if the consumer stops early (a full
        bounded queue would otherwise block the thread forever)."""
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def _put(self, item) -> None:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self) -> None:
        for e in self._epochs:
            if self._stop:
                return
            try:
                item = self._log.load_epoch(e)
            except Exception as exc:
                # A torn segment (or any refill failure) rides the queue
                # and re-raises on the consumer, which would otherwise
                # wait forever.
                item = exc
            self._put(item)
            if isinstance(item, Exception):
                return
        self._put(None)

    def epochs(self) -> Iterator[Tuple[int, RecordBatch]]:
        """Prefetched ``(start_step, stacked numpy steps)`` per retained
        epoch."""
        first = True
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            start, batch = item
            if first and self._skip:
                start += self._skip
                batch = RecordBatch(*(x[self._skip:] for x in batch))
            first = False
            yield start, batch

    def __iter__(self) -> Iterator[Tuple[int, RecordBatch]]:
        for start, batch in self.epochs():
            for i in range(batch.keys.shape[0]):
                yield start + i, RecordBatch(*(np.asarray(x[i])
                                               for x in batch))
