"""Keyed arrival rank: the interval join's grouped block form
(``api/operators.py`` ``IntervalJoinOperator.process_block``) ranks each
left record among the valid records of its key in its group, and counts
each key's records through each step.

The TPU package computes it with ``jnp.cumsum`` over a one-hot
(``clonos_tpu/api/operators.py``); no Pallas kernel covers it. Here a
CUDA kernel written for Hopper (``csrc/keyed_rank.cu``: warps group their
records by key with ``__match_any_sync`` and take turns on a per-key
count table, then a second launch adds each step's offset) computes it
without the one-hot, and :func:`keyed_rank_plain` is the plain PyTorch
version: the one-hot ``cumsum``, bit-identical to the reference's.

:func:`keyed_rank` picks by the device of the tensors it is given: the
plain version for CPU tensors, the kernel for CUDA tensors (a build or
launch failure raises; there is no fallback). The library is bound once
and the launch arguments are cached per shape, so a launch takes no lock
and makes no device query.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from clonos_tpu_torch.ops import LAUNCH_COUNTERS, cuda_build, histogram

_SOURCE = "keyed_rank.cu"
#: table bytes a block keeps in shared memory without an opt-in (the
#: kernel's kSmemTableBytes); a wider table is counted in the global
#: scratch, one row a block
SMEM_TABLE_BYTES = 48 * 1024
_MAX_THREADS = 1024
#: lanes are the grid's second dimension
_MAX_LANES = 65535
_EXTENT = 2 ** 31


def keyed_rank_plain(keys: torch.Tensor, valid: torch.Tensor, G: int,
                     B: int, nk: int):
    """Plain version on ``[P, G*B]`` rows (keys in ``[0, nk)``): the
    one-hot ``cumsum``. Returns ``(rank, through)``: int64 ``[P, G*B]``,
    each valid record's 0-based rank among the valid records of its key
    at or before it and ``G*B`` for an invalid one; int32 ``[P, G, nk]``,
    each key's valid records in steps ``0..g``."""
    P, n = keys.shape
    lk = keys.to(torch.int64)
    ks = torch.arange(nk, device=keys.device)
    oh = valid[..., None] & (lk[..., None] == ks)         # [P, n, nk]
    cum = torch.cumsum(oh.to(torch.int32), dim=1, dtype=torch.int32)
    rank = torch.gather(cum, 2, lk[..., None])[..., 0] - 1
    rank = torch.where(valid, rank, n).to(torch.int64)   # n = spare
    through = cum.reshape(P, G, B, nk)[:, :, -1]          # [P, G, nk]
    return rank, through


def plan(B: int, nk: int) -> Tuple[int, int]:
    """The step kernel's threads a block (a warp for each 32 slots of a
    step, at most 1,024) and its table's shared bytes (0: the table is
    global)."""
    threads = min(_MAX_THREADS, max(32, -(-B // 32) * 32))
    return threads, (nk * 4 if nk * 4 <= SMEM_TABLE_BYTES else 0)


#: the bound C launcher (set at first use)
_launch = None


def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, and bind its
    launcher to the module."""
    global _launch
    lib = cuda_build.load(_SOURCE)
    if _launch is None:
        lib.keyed_rank_error_string.restype = ctypes.c_char_p
        lib.keyed_rank_error_string.argtypes = [ctypes.c_int]
        lib.keyed_rank_launch.restype = ctypes.c_int
        lib.keyed_rank_launch.argtypes = [ctypes.c_void_p] * 7
        _launch = lib.keyed_rank_launch
    return lib


@functools.lru_cache(maxsize=1024)
def _launch_args(P: int, G: int, B: int, nk: int, index: int):
    """The C launcher's seven int arguments for this shape on CUDA device
    ``index``, packed in a ctypes array kept alive by the cache, and its
    address."""
    args = (ctypes.c_int * 7)(P, G, B, nk, *plan(B, nk), index)
    return args, ctypes.addressof(args)


#: the handle of a CUDA device's current stream (the caller's), by index
_current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def keyed_rank_cuda(keys: torch.Tensor, valid: torch.Tensor, G: int,
                    B: int, nk: int):
    """Launch the Hopper kernel on ``[P, G*B]`` CUDA rows (int32 keys,
    bool valid) on the current stream of their device; returns what
    :func:`keyed_rank_plain` returns. ``through`` is a view of one
    ``[2, P, G, nk]`` allocation whose other half is the kernel's count
    scratch."""
    index = keys.get_device()
    if not (keys.dtype is torch.int32 and valid.dtype is torch.bool
            and keys.is_cuda and valid.is_cuda
            and valid.get_device() == index and keys.dim() == 2
            and valid.shape == keys.shape):
        raise ValueError(
            f"keyed_rank_cuda takes int32 keys and bool valid of one shape "
            f"[P, G*B] on one CUDA device, got {keys.dtype}/{valid.dtype} "
            f"{tuple(keys.shape)}/{tuple(valid.shape)} on "
            f"{keys.device}/{valid.device}")
    P, n = keys.shape
    if not (G >= 0 and B >= 0 and n == G * B and P <= _MAX_LANES
            and 0 < nk and P * G * nk < _EXTENT and P * n < _EXTENT):
        raise ValueError(f"keyed_rank_cuda: shape {tuple(keys.shape)}, "
                         f"G={G} B={B} nk={nk} is outside the kernel's "
                         f"extents")
    rank = torch.empty((P, n), dtype=torch.int64, device=keys.device)
    counts, through = keys.new_empty((2, P, G, nk)).unbind(0)
    if P == 0 or G == 0:
        return rank, through
    launch = _launch
    if launch is None:
        _lib()
        launch = _launch
    keys = keys.contiguous()
    valid = valid.contiguous()
    _, args = _launch_args(P, G, B, nk, index)
    err = launch(keys.data_ptr(), valid.data_ptr(), rank.data_ptr(),
                 counts.data_ptr(), through.data_ptr(), args,
                 _current_stream(index))
    if err != 0:
        raise RuntimeError(
            f"keyed_rank kernel launch failed: "
            f"{_lib().keyed_rank_error_string(err).decode()} (cuda error "
            f"{err}) at P={P} G={G} B={B} nk={nk}, plan {plan(B, nk)}")
    if histogram.warming():
        keyed_rank.warm_launches += 1
    else:
        keyed_rank.launches += 1
    return rank, through


def keyed_rank(keys: torch.Tensor, valid: torch.Tensor, G: int, B: int,
               nk: int):
    """Each left record's arrival rank among its key's valid records over
    ``[P, G*B]`` rows of G steps of B slots, and each key's count through
    each step (see :func:`keyed_rank_plain`). CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``keyed_rank.launches``; under ``histogram.counting_as_warm`` in
    ``keyed_rank.warm_launches`` instead)."""
    if keys.is_cuda:
        return keyed_rank_cuda(keys, valid, G, B, nk)
    if keys.device.type == "cpu":
        return keyed_rank_plain(keys, valid, G, B, nk)
    raise ValueError(f"keyed_rank: unsupported device {keys.device}")


#: kernel calls (two launches each: the in-step ranks, then the offsets)
#: since the last reset
keyed_rank.launches = 0
#: calls made under ``histogram.counting_as_warm``
keyed_rank.warm_launches = 0
LAUNCH_COUNTERS["rank_launches"] = lambda: keyed_rank.launches
