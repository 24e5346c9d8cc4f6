"""Thread causal log: device-resident determinant ring buffer.

Port of ``clonos_tpu/causal/log.py``. A log is one
``int32[capacity, NUM_LANES]`` ring plus int32 offsets, bundled as
:class:`ThreadLogState`. Offsets are absolute (monotonic append counts);
the ring position is ``offset & (capacity - 1)``; truncation only advances
``tail``.

A device holds many logs stacked as one ``[L, capacity, NUM_LANES]``
state. The reference ``vmap``\\ s its single-log functions over that stack;
here the batched ``v_*`` functions are written with the stack as a leading
dimension, and the single-log functions run them on a stack of one.

The functions are pure: they return new tensors and leave their inputs as
they were (a stacked log is a few MB, the copy is cheap next to safety).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from clonos_tpu_torch.causal.determinant import NUM_LANES
from clonos_tpu_torch.device import resolve
from clonos_tpu_torch.device import scalar as _i32
from clonos_tpu_torch.utils.tree import tree_map


class ThreadLogState(NamedTuple):
    """State of one thread causal log (or a stack of them)."""

    rows: torch.Tensor          # int32[(L,) capacity, NUM_LANES] ring
    head: torch.Tensor          # int32[(L)]: absolute append count
    tail: torch.Tensor          # int32[(L)]: oldest retained offset
    epoch_starts: torch.Tensor  # int32[(L,) max_epochs]: start offset of
                                #   epoch e at index e % max_epochs
    epoch_base: torch.Tensor    # int32[(L)]: oldest retained epoch id
    latest_epoch: torch.Tensor  # int32[(L)]: newest epoch started

    @property
    def capacity(self) -> int:
        return self.rows.shape[-2]

    @property
    def max_epochs(self) -> int:
        return self.epoch_starts.shape[-1]


def v_create(n: int, capacity: int, max_epochs: int,
             device) -> ThreadLogState:
    """A stack of ``n`` empty logs."""
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return ThreadLogState(rows=z(n, capacity, NUM_LANES), head=z(n),
                          tail=z(n), epoch_starts=z(n, max_epochs),
                          epoch_base=z(n), latest_epoch=z(n))


def _one(fn, state: ThreadLogState, *args) -> ThreadLogState:
    """Run a batched function on a single log as a stack of one."""
    out = fn(tree_map(lambda x: x[None], state), *args)
    return tree_map(lambda x: x[0], out)


def create(capacity: int, max_epochs: int, device) -> ThreadLogState:
    return tree_map(lambda x: x[0], v_create(1, capacity, max_epochs,
                                              device))


def size(state: ThreadLogState) -> torch.Tensor:
    """Live determinants currently retained."""
    return state.head - state.tail


def overflowed(state: ThreadLogState) -> torch.Tensor:
    """True if appends clobbered un-truncated determinants."""
    return size(state) > state.capacity


def epoch_index_overflowed(state: ThreadLogState) -> torch.Tensor:
    """True if more than ``max_epochs`` epochs are un-truncated."""
    return state.latest_epoch - state.epoch_base + 1 > state.max_epochs


def near_offset_wrap(state: ThreadLogState,
                     margin: int = 1 << 29) -> torch.Tensor:
    """True when absolute int32 offsets approach 2^31."""
    return state.head > (1 << 31) - 1 - margin


def v_append(state: ThreadLogState, rows: torch.Tensor,
             count: torch.Tensor) -> ThreadLogState:
    """Append the first ``count[l]`` rows of each padded
    ``[L, max_batch, NUM_LANES]`` buffer at its log's head."""
    L, m = rows.shape[:2]
    dev = rows.device
    count = _i32(count, dev).expand(L)
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    pos = ((state.head[:, None] + idx[None, :])
           & (state.capacity - 1)).to(torch.int64)               # [L, m]
    live = idx[None, :] < count[:, None]
    lidx = torch.arange(L, device=dev)[:, None].expand(L, m)
    new_rows = state.rows.clone()
    # Rows past `count` write back their current value.
    new_rows[lidx, pos] = torch.where(live[:, :, None], rows,
                                      new_rows[lidx, pos])
    return state._replace(rows=new_rows, head=state.head + count)


def append(state: ThreadLogState, rows: torch.Tensor,
           count) -> ThreadLogState:
    """Append the first ``count`` rows of a padded ``[max_batch, lanes]``
    buffer at head (reference appendDeterminant:158)."""
    return _one(v_append, state, rows[None],
                _i32(count, rows.device).reshape(1))


def v_append_full(state: ThreadLogState, rows: torch.Tensor
                  ) -> ThreadLogState:
    """Append ALL rows of each ``[L, n, NUM_LANES]`` slice at its log's
    head — the block-fence bulk path (``n <= capacity``, so ring positions
    are unique). The reference's dense windowed read-modify-write is a
    TPU workaround for slow row scatters; here it is one index_put."""
    L, n = rows.shape[:2]
    cap = state.capacity
    if n > cap:
        raise ValueError(f"bulk append of {n} rows > capacity {cap}")
    dev = rows.device
    pos = ((state.head[:, None]
            + torch.arange(n, dtype=torch.int32, device=dev)[None, :])
           & (cap - 1)).to(torch.int64)
    lidx = torch.arange(L, device=dev)[:, None].expand(L, n)
    new_rows = state.rows.clone()
    new_rows[lidx, pos] = rows
    return state._replace(rows=new_rows, head=state.head + n)


def append_full(state: ThreadLogState, rows: torch.Tensor) -> ThreadLogState:
    return _one(v_append_full, state, rows[None])


def v_start_epoch(state: ThreadLogState, epoch_id) -> ThreadLogState:
    """Record the epoch -> offset index entry for a newly started epoch
    on every log of the stack."""
    e = int(epoch_id)
    starts = state.epoch_starts.clone()
    starts[:, e % state.max_epochs] = state.head
    return state._replace(epoch_starts=starts,
                          latest_epoch=state.latest_epoch.clamp(min=e))


def start_epoch(state: ThreadLogState, epoch_id) -> ThreadLogState:
    return _one(v_start_epoch, state, epoch_id)


def epoch_start_offset(state: ThreadLogState, epoch_id) -> torch.Tensor:
    return state.epoch_starts[..., int(epoch_id) % state.max_epochs]


def v_truncate(state: ThreadLogState, completed_epoch) -> ThreadLogState:
    """Checkpoint ``completed_epoch`` finished: drop determinants of epochs
    <= it (pure offset rebase; late notifications are no-ops)."""
    e = int(completed_epoch)
    new_tail = torch.maximum(epoch_start_offset(state, e + 1), state.tail)
    new_base = torch.clamp(state.epoch_base, min=e + 1)
    return state._replace(tail=new_tail, epoch_base=new_base)


def truncate(state: ThreadLogState, completed_epoch) -> ThreadLogState:
    return _one(v_truncate, state, completed_epoch)


def v_slice_from(state: ThreadLogState, abs_offset, max_out: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each log's rows ``[abs_offset, head)`` into a fixed-size
    buffer: ``(buf[L, max_out, lanes], count[L], start[L])``."""
    L = state.head.shape[0]
    dev = state.head.device
    start = torch.maximum(_i32(abs_offset, dev).expand(L), state.tail)
    count = (state.head - start).clamp(0, max_out)
    idx = torch.arange(max_out, dtype=torch.int32, device=dev)
    pos = ((start[:, None] + idx[None, :])
           & (state.capacity - 1)).to(torch.int64)
    lidx = torch.arange(L, device=dev)[:, None].expand(L, max_out)
    buf = torch.where((idx[None, :] < count[:, None])[:, :, None],
                      state.rows[lidx, pos], 0)
    return buf, count, start


def slice_from(state: ThreadLogState, abs_offset, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather rows ``[abs_offset, head)`` of one log:
    ``(buf[max_out, lanes], count, start)``."""
    buf, count, start = v_slice_from(
        tree_map(lambda x: x[None], state),
        _i32(abs_offset, state.head.device).reshape(1), max_out)
    return buf[0], count[0], start[0]


def get_determinants(state: ThreadLogState, from_epoch, max_out: int):
    """All retained determinants of one log from the start of
    ``from_epoch`` (the replay feed)."""
    return slice_from(state, epoch_start_offset(state, from_epoch), max_out)


def rebase(state: ThreadLogState, amount) -> ThreadLogState:
    """Subtract ``amount`` from every absolute offset (head, tail, epoch
    index) — the int32-wrap mitigation. Safe only when every producer and
    replica of the log rebases by the same agreed amount (a multiple of
    capacity, so ring positions stay) at a quiescent point."""
    amount = _i32(amount, state.head.device)
    return state._replace(head=state.head - amount,
                          tail=state.tail - amount,
                          epoch_starts=state.epoch_starts - amount)


def append_one(state: ThreadLogState, row: torch.Tensor) -> ThreadLogState:
    """Append a single ``[NUM_LANES]`` row at head."""
    return append(state, row.reshape(1, -1), 1)


def v_merge_delta(state: ThreadLogState, rows: torch.Tensor, count,
                  abs_start) -> Tuple[ThreadLogState, torch.Tensor]:
    """Ingest a replicated delta of another task's log into each replica
    of the stack: ``rows [L, m, lanes]``, ``count [L]``, ``abs_start
    [L]``. Dedups by absolute offset (reference processUpstreamDelta:117):
    entries with offset < head are already present and skipped; only the
    fresh suffix is appended.

    Returns ``(new_state, gap[L])``. ``gap`` is True where ``abs_start >
    head`` (a preceding delta was lost): nothing is appended there, and
    the caller must request a re-send from ``head``."""
    L, m = rows.shape[:2]
    dev = rows.device
    count = _i32(count, dev).expand(L)
    abs_start = _i32(abs_start, dev).expand(L)
    gap = abs_start > state.head
    skip = torch.minimum((state.head - abs_start).clamp(min=0), count)
    fresh = torch.where(gap, 0, count - skip).to(torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    shifted = torch.where(idx + skip[:, None] < m, idx + skip[:, None], 0)
    fresh_rows = torch.gather(
        rows, 1, shifted.to(torch.int64)[:, :, None].expand(L, m,
                                                             rows.shape[2]))
    return v_append(state, fresh_rows, fresh), gap


def merge_delta(state: ThreadLogState, rows: torch.Tensor, count, abs_start
                ) -> Tuple[ThreadLogState, torch.Tensor]:
    """:func:`v_merge_delta` on one log: ``rows [m, lanes]``."""
    dev = rows.device
    out, gap = v_merge_delta(tree_map(lambda x: x[None], state), rows[None],
                             _i32(count, dev).reshape(1),
                             _i32(abs_start, dev).reshape(1))
    return tree_map(lambda x: x[0], out), gap[0]


def stack_logs(states) -> ThreadLogState:
    """Stack per-log states into one stacked state (a leading ``[L]``)."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_logs(stacked: ThreadLogState):
    """The stacked state's logs, one state each."""
    n = stacked.head.shape[0]
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


# --- host-side wrapper (control plane, remote mirrors, tests) ---------------


class ThreadCausalLog:
    """One log as an object, for host-side use: the remote mirror's
    replica log and the control plane's log manipulation. The executor
    never uses it; there the logs live stacked in the carry. The state
    stays on ``device``; reads come back as numpy arrays."""

    def __init__(self, capacity: int = 1 << 12, max_epochs: int = 64,
                 device="cuda"):
        self.device = resolve(device)
        self.state = create(capacity, max_epochs, self.device)

    def _rows(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.array(rows, np.int32)).to(self.device)

    def append_rows(self, rows: np.ndarray) -> None:
        if rows.ndim != 2 or rows.shape[1] != NUM_LANES:
            raise ValueError(
                f"expected [n, {NUM_LANES}] rows, got {rows.shape}")
        self.state = append(self.state, self._rows(rows), rows.shape[0])

    def start_epoch(self, epoch_id: int) -> None:
        self.state = start_epoch(self.state, epoch_id)

    def notify_checkpoint_complete(self, epoch_id: int) -> None:
        self.state = truncate(self.state, epoch_id)

    def merge_delta(self, rows: np.ndarray, abs_start: int) -> bool:
        """True on success; False when a gap was detected (nothing merged
        — request a re-send from ``self.head``)."""
        self.state, gap = merge_delta(self.state, self._rows(rows),
                                      rows.shape[0], abs_start)
        return not bool(gap)

    def delta_for_consumer(self, consumer_offset: int, max_out: int):
        buf, count, start = slice_from(self.state, consumer_offset, max_out)
        return buf[:int(count)].cpu().numpy(), int(start)

    def determinants_from_epoch(self, epoch: int,
                                max_out: int) -> np.ndarray:
        buf, count, _ = get_determinants(self.state, epoch, max_out)
        return buf[:int(count)].cpu().numpy()

    @property
    def capacity(self) -> int:
        return self.state.capacity

    @property
    def head(self) -> int:
        return int(self.state.head)

    @property
    def tail(self) -> int:
        return int(self.state.tail)

    def __len__(self) -> int:
        return int(size(self.state))
