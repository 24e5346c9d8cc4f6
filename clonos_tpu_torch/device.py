"""Device selection for the port's entry points, and host-to-device
uploads that do not stall the host."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default
    everywhere) raises when no card is present: the port never falls
    back to the CPU on its own — the CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(arr, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. On a card the bytes go
    through pinned memory with ``non_blocking=True``: a pageable copy
    would wait for every queued kernel (a host sync) before it starts."""
    t = torch.from_numpy(np.array(arr, copy=True))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def scalar(x, device, dtype=torch.int32) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device``: a tensor is cast and
    moved; a host int becomes a 0-dim tensor made on the device by a fill
    (``torch.tensor(x, device=...)`` copies from the host and syncs)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), int(x), dtype=dtype, device=device)
