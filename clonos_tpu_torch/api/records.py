"""Record batches: the unit of dataflow (port of ``clonos_tpu/api/records.py``).

A record is ``(key: int32, value: int32, timestamp: int32)``; a batch is a
fixed-capacity struct-of-arrays with a validity mask. Padding rows are
zeroed so replay comparisons are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from clonos_tpu_torch import device as _device


class RecordBatch(NamedTuple):
    """Fixed-capacity struct-of-arrays batch. Leading dims are arbitrary
    (e.g. ``[P, B]`` for a vertex with parallelism P)."""

    keys: torch.Tensor        # int32[..., B]
    values: torch.Tensor      # int32[..., B]
    timestamps: torch.Tensor  # int32[..., B]
    valid: torch.Tensor       # bool[..., B]

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    def count(self) -> torch.Tensor:
        """Live records per leading index (int32[...])."""
        return self.valid.sum(dim=-1, dtype=torch.int32)


def empty(shape, device) -> RecordBatch:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    z = lambda dt: torch.zeros(shape, dtype=dt, device=device)
    return RecordBatch(z(torch.int32), z(torch.int32), z(torch.int32),
                       z(torch.bool))


def make(keys, values=None, timestamps=None, capacity=None,
         device="cuda") -> RecordBatch:
    """Host-side constructor from numpy/lists, padded to ``capacity``, on
    ``device`` (the card by default; raises without one)."""
    device = _device.resolve(device)
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values if values is not None
                        else np.ones_like(keys), np.int32)
    timestamps = np.asarray(timestamps if timestamps is not None
                            else np.zeros_like(keys), np.int32)
    n = keys.shape[-1]
    cap = capacity or n
    if n > cap:
        raise ValueError(f"{n} records exceed capacity {cap}")
    pad = [(0, 0)] * (keys.ndim - 1) + [(0, cap - n)]
    valid = np.pad(np.ones(keys.shape, bool), pad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return RecordBatch(t(np.pad(keys, pad)), t(np.pad(values, pad)),
                       t(np.pad(timestamps, pad)), t(valid))


def zero_invalid(batch: RecordBatch) -> RecordBatch:
    """Force padding rows to zero — the canonical form all operators emit."""
    m = batch.valid
    return RecordBatch(torch.where(m, batch.keys, 0),
                       torch.where(m, batch.values, 0),
                       torch.where(m, batch.timestamps, 0), m)


def to_numpy(batch: RecordBatch):
    """Host view: list of (key, value, ts) tuples for the valid rows of a
    batch, flattened (tests / sinks)."""
    k, v, t, m = (x.detach().cpu().numpy().reshape(-1) for x in batch)
    return [(int(k[i]), int(v[i]), int(t[i])) for i in range(m.size) if m[i]]
