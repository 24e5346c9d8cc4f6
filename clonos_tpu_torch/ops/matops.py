"""Exact integer row gather (port of ``clonos_tpu/ops/matops.py``).

The TPU package expresses this gather as two one-hot f32 matmuls on the
MXU because dynamic gathers are slow there; it is not a Pallas kernel, and
on the GPU it is one ``torch.gather``."""

from __future__ import annotations

import torch


def onehot_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[k, p, :] = table[idx[k, p], p, :]`` for a ``[J, P, N]`` table;
    ``idx`` must already be clipped to ``[0, J)``."""
    n = table.shape[2]
    index = idx.to(torch.int64)[:, :, None].expand(-1, -1, n)
    return torch.gather(table, 0, index)
