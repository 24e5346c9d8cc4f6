"""Device selection for the port's entry points, and host-device copies
that do not stall the host."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from clonos_tpu_torch.obs.trace import get_tracer
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map


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


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as a numpy array. From a card the copy first
    waits for the work queued before it: that wait is a ``device.wait``
    span, as :meth:`HostCopy.wait`'s is."""
    if x.device.type != "cuda":
        return x.cpu().numpy()
    with get_tracer().span("device.wait"):
        return x.cpu().numpy()


#: ``torch.cuda.memory_stats()`` counters of the device allocator's trips
#: to CUDA: segments allocated and freed (``cudaMalloc``, ``cudaFree``,
#: which synchronises the device) and retries after a failed allocation
_DEVICE_TRIPS = ("segment.all.allocated", "segment.all.freed",
                 "num_alloc_retries")


def cuda_allocs(device) -> Optional[int]:
    """The caching allocators' trips to CUDA so far, device and pinned
    host (``num_host_alloc``: a ``cudaHostAlloc`` for a new pinned
    block); the change over a span is what it cost. None off a card."""
    if torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    host = torch.cuda.host_memory_stats()
    return (sum(int(stats.get(k, 0)) for k in _DEVICE_TRIPS)
            + int(host.get("num_host_alloc", 0)))


class HostCopy:
    """A tree of tensors (or numpy arrays) on its way to the host.

    Made on the thread that queued the tensors' work: each CUDA leaf is
    copied into pinned host memory with ``non_blocking=True`` behind that
    work on the current stream, and one event marks the copies done; CPU
    tensors and numpy arrays are copied at once. :meth:`wait` may run on
    any thread: it waits for that event alone (never for work queued
    after it, and it queues no work of its own) and returns the tree as
    numpy arrays. The sources stay referenced until then."""

    def __init__(self, tree: Any):
        self._sources: Optional[Any] = tree
        self._event = None

        def start(x):
            if not isinstance(x, torch.Tensor):
                return np.array(x, copy=True)
            x = x.detach()
            if x.device.type != "cuda":
                return x.clone()
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return host

        self._host = tree_map(start, tree)
        cuda = [x for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"]
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))

    @property
    def nbytes(self) -> int:
        """Bytes of the host copies (known before they land)."""
        return sum(int(x.numel() * x.element_size())
                   if isinstance(x, torch.Tensor) else int(x.nbytes)
                   for x in tree_leaves(self._host))

    def wait(self) -> Any:
        if self._event is not None:
            with get_tracer().span("device.wait"):
                self._event.synchronize()
        self._sources = None
        return tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                        else x, self._host)


def rank_device(rank: int, world: int, device="cuda",
                backend: str = "nccl", share: bool = False) -> torch.device:
    """The device of rank ``rank`` of ``world``: ``cuda:{rank % count}``,
    or the CPU when asked for. Ranks share a card only when the caller
    asks (``share=True``) and only over gloo, whose collectives the port
    stages through host memory; NCCL refuses two ranks on one device."""
    dev = resolve(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if world > count and not share:
        raise RuntimeError(
            f"{world} ranks over {count} card(s): pass share=True (gloo "
            f"only) to let ranks share a card")
    if world > count and backend != "gloo":
        raise ValueError("ranks share a card only over gloo")
    return torch.device("cuda", rank % count)
