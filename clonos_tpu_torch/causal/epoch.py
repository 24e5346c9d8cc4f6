"""Epoch tracking (port of ``clonos_tpu/causal/epoch.py``).

- :class:`EpochState` — three int32 scalars (epoch id, records since the
  epoch started, records since the job started) as tensors, advanced by
  pure functions on the device;
- :class:`EpochTracker` — the host control plane: the listener bus and
  the async-determinant firing queue (targets only matter between
  supersteps).

Epoch n = all records between checkpoint barrier n and n+1; a completed
checkpoint truncates the causal and in-flight logs back to its boundary.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.causal.determinant import Determinant


class EpochState(NamedTuple):
    """Device-resident epoch scalars."""

    epoch_id: torch.Tensor       # int32 scalar
    record_count: torch.Tensor   # int32 scalar, records since epoch start
    total_records: torch.Tensor  # int32 scalar, records since job start

    @staticmethod
    def initial(epoch_id: int = 0, device="cuda") -> "EpochState":
        dev = _device.resolve(device)
        return EpochState(_device.scalar(epoch_id, dev),
                          _device.scalar(0, dev), _device.scalar(0, dev))


def inc_record_count(state: EpochState, n) -> EpochState:
    n = _device.scalar(n, state.record_count.device)
    return EpochState(state.epoch_id, state.record_count + n,
                      state.total_records + n)


def start_new_epoch(state: EpochState, new_epoch_id) -> EpochState:
    return EpochState(_device.scalar(new_epoch_id, state.epoch_id.device),
                      torch.zeros_like(state.record_count),
                      state.total_records)


def total_records_near_wrap(state: EpochState,
                            margin: int = 1 << 29) -> torch.Tensor:
    """True when the int32 job-lifetime record counter approaches 2^31;
    the control plane rebases it at a checkpoint fence."""
    return state.total_records > (1 << 31) - 1 - margin


def rebase_total_records(state: EpochState, amount) -> EpochState:
    """Subtract a globally-agreed amount at a quiescent fence."""
    return state._replace(total_records=state.total_records
                          - _device.scalar(amount,
                                           state.total_records.device))


@dataclasses.dataclass
class EpochTracker:
    """Host-side epoch control plane for one task: the listener bus and
    the async-determinant firing queue used during replay (fire each
    stored async determinant exactly when record_count reaches its
    recorded target)."""

    epoch_id: int = 0
    record_count: int = 0
    _epoch_listeners: List[Callable[[int], None]] = dataclasses.field(
        default_factory=list)
    _checkpoint_listeners: List[Callable[[int], None]] = dataclasses.field(
        default_factory=list)
    #: (epoch_id, sealed digest) listeners — the audit plane's fan-out
    _seal_listeners: List[Callable[[int, object], None]] = dataclasses.field(
        default_factory=list)
    #: sorted (epoch, target_record_count, seq, determinant, callback)
    _targets: List[Tuple[int, int, int, Determinant,
                         Callable[[Determinant], None]]] = dataclasses.field(
        default_factory=list)
    _seq: int = 0

    def subscribe_epoch_start(self, fn: Callable[[int], None]) -> None:
        self._epoch_listeners.append(fn)

    def subscribe_checkpoint_complete(self, fn: Callable[[int], None]
                                      ) -> None:
        self._checkpoint_listeners.append(fn)

    def start_new_epoch(self, epoch_id: int) -> None:
        self.epoch_id = epoch_id
        self.record_count = 0
        # clonos: allow(join-discipline): listeners are registered during
        # wiring, before any worker thread exists (pre-start publication
        # across functions, which the race pass only models within the
        # spawning function); the list is never mutated after start.
        for fn in self._epoch_listeners:
            fn(epoch_id)
        # A replay target at record count 0 fires as the epoch starts.
        self.fire_due_events()

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for fn in self._checkpoint_listeners:
            fn(checkpoint_id)

    def subscribe_epoch_seal(self,
                             fn: Callable[[int, object], None]) -> None:
        """``fn(epoch_id, digest)`` fires when an epoch's audit digest is
        sealed at its barrier, before the checkpoint completes."""
        self._seal_listeners.append(fn)

    def notify_epoch_sealed(self, epoch_id: int, digest: object) -> None:
        # clonos: allow(join-discipline): seal listeners are registered
        # during wiring, before the fence worker starts (pre-start
        # publication across functions); never mutated after start.
        for fn in self._seal_listeners:
            fn(epoch_id, digest)

    def set_record_count_target(
            self, target: int, det: Determinant,
            callback: Callable[[Determinant], None],
            epoch: Optional[int] = None) -> None:
        """Register an async determinant to fire when ``record_count``
        hits ``target`` within ``epoch`` (default: the current epoch). A
        target already passed within the current epoch is an error; one
        due now fires at once."""
        e = self.epoch_id if epoch is None else epoch
        if e < self.epoch_id or (e == self.epoch_id
                                 and target < self.record_count):
            raise ValueError(
                f"target epoch={e} count={target} already passed "
                f"(epoch={self.epoch_id}, record_count={self.record_count})")
        # seq is unique, so tuple comparison never reaches the determinant.
        # clonos: allow(join-discipline): record-count targets register
        # and fire on the step thread only — inc_record_count is never
        # called from the fence tail (the reach chain the race pass
        # reports goes through cluster helpers the tail shares but does
        # not execute); replay installation runs with the tail joined.
        bisect.insort(self._targets, (e, target, self._seq, det, callback))
        self._seq += 1
        self.fire_due_events()

    def inc_record_count(self, n: int = 1) -> None:
        self.record_count += n
        self.fire_due_events()

    def fire_due_events(self) -> None:
        while self._targets:
            e, target, _, det, callback = self._targets[0]
            due = e < self.epoch_id or (e == self.epoch_id
                                        and target <= self.record_count)
            if not due:
                return
            self._targets.pop(0)
            callback(det)

    @property
    def pending_targets(self) -> int:
        return len(self._targets)
