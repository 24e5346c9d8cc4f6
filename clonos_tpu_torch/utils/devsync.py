"""Device-completion sync (port of ``clonos_tpu/utils/devsync.py``).

CUDA work is queued asynchronously, so a host clock read after a call
measures the enqueue. :func:`device_sync` waits until every card that
holds a tensor of ``tree`` has finished its queued work — the profiler's
``fence`` (``obs/profile.py``) and timing code call it."""

from __future__ import annotations

import torch

from clonos_tpu_torch.utils.tree import tree_leaves


def device_sync(tree) -> None:
    """Synchronise each CUDA device that holds a leaf of ``tree``, once.
    A tree with no CUDA tensor (CPU tensors, numpy arrays, scalars) is a
    no-op."""
    seen = set()
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            idx = x.device.index
            if idx not in seen:
                seen.add(idx)
                torch.cuda.synchronize(x.device)
