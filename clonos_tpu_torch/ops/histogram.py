"""Keyed histogram (segment sum): the heart of every keyed aggregation and
of the exchange's record placement.

Port of ``clonos_tpu/ops/histogram.py``. The TPU package streams records
through a Pallas compare-accumulate kernel (``_hist_kernel`` /
``_hist_kernel_sums``); here a CUDA kernel written for Hopper
(``csrc/keyed_hist.cu``: persistent blocks walking their rows, counted
into a shared-memory table with int32 atomics; where few blocks fit an
SM, each next row prefetched into a shared-memory ring by bulk async
copies) takes their place, and
:func:`keyed_hist_plain` is its plain PyTorch version — a masked
``scatter_add_`` bit-identical to the reference's XLA fallback
(``_hist_xla``).

:func:`keyed_hist` picks by the device of the tensors it is given: the
plain version for CPU tensors, the kernel for CUDA tensors (a build or
launch failure raises; there is no fallback). The launch plan
(:func:`_plan`) is pure Python, cached per shape; the library is bound
once and each device's properties are read once, so a launch takes no
lock and makes no device query.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from clonos_tpu_torch.ops import cuda_build

_SOURCE = "keyed_hist.cu"


def keyed_hist_plain(keys: torch.Tensor, vals: torch.Tensor,
                     valid: torch.Tensor, nk: int, want_counts: bool = True):
    """Plain version on ``[R, B]`` rows: masked int32 ``scatter_add_``.
    Invalid records and keys outside ``[0, nk)`` drop."""
    r, _ = keys.shape
    dev = keys.device
    ok = valid & (keys >= 0) & (keys < nk)
    row = torch.arange(r, device=dev, dtype=torch.int64)[:, None] * nk
    # Dropped records go to one spare slot past the table, cut off below.
    idx = torch.where(ok, row + keys.to(torch.int64), r * nk).reshape(-1)
    sums = torch.zeros(r * nk + 1, dtype=torch.int32, device=dev)
    sums.scatter_add_(0, idx, torch.where(ok, vals, 0).to(torch.int32)
                      .reshape(-1))
    sums = sums[:-1].reshape(r, nk)
    if not want_counts:
        return sums, None
    cnts = torch.zeros(r * nk + 1, dtype=torch.int32, device=dev)
    cnts.scatter_add_(0, idx, ok.to(torch.int32).reshape(-1))
    return sums, cnts[:-1].reshape(r, nk)


#: the kernel's branches, as csrc/keyed_hist.cu numbers them: rows
#: prefetched by bulk async copies into a shared-memory ring; rows loaded
#: straight from device memory; global atomics (the table exceeds the
#: shared-memory budget)
BULK, DIRECT, GLOBAL = 0, 1, 2
#: records per ring stage, and stages per block (kStages in the kernel:
#: the plan's shared bytes must cover the kernel's layout)
_CHUNK = 1024
_STAGES = 2
#: the ring is taken only where fewer blocks than this share an SM: with
#: 4 or more resident, the other blocks' warps hide the direct loads'
#: latency as well or better (chip_smoke.py phase 2 times both branches at
#: each shape; PERF.md §6 and §7 hold the readings)
_BULK_BELOW_RESIDENT = 4
#: shared memory the runtime keeps for every resident block (sm_80 on), and
#: the SM's shared memory is the per-block opt-in plus one such share
_RESERVED_SMEM = 1024
#: resident threads and blocks per SM (the kernel's launch bounds hold
#: registers to 32 a thread, so 2,048 threads always fit)
_THREADS_PER_SM = 2048
_BLOCKS_PER_SM = 32
_GLOBAL_THREADS = 256


class Plan(NamedTuple):
    """One launch: the branch, the grid, threads per block, dynamic shared
    bytes, records per ring stage (bulk only) and resident blocks per SM."""
    branch: int
    grid: int
    threads: int
    smem: int
    chunk: int
    resident: int


def _table_bytes(nk: int, counts: bool) -> int:
    return -(-nk * 4 * (2 if counts else 1) // 16) * 16


def _ring_bytes(b: int) -> int:
    return _STAGES * (9 * min(b, _CHUNK) + 8)


def _branch_plan(branch: int, r: int, b: int, nk: int, counts: bool,
                 smem_optin: int, sms: int) -> Plan:
    """The launch of the shared-memory ``branch`` (BULK or DIRECT) for this
    shape: persistent, at most the blocks that are resident at once."""
    table = _table_bytes(nk, counts)
    bulk = branch == BULK
    smem = table + _ring_bytes(b) if bulk else table
    threads = (1024 if table >= 96 * 1024 else 512 if table >= 32 * 1024
               else 256)
    resident = min((smem_optin + _RESERVED_SMEM) // (smem + _RESERVED_SMEM),
                   _THREADS_PER_SM // threads, _BLOCKS_PER_SM)
    return Plan(branch, min(r, sms * resident), threads, smem,
                min(b, _CHUNK) if bulk else 0, resident)


@functools.lru_cache(maxsize=1024)
def _plan(r: int, b: int, nk: int, counts: bool, aligned: bool,
          smem_optin: int, sms: int) -> Plan:
    """The launch plan for ``[r, b]`` rows into ``nk`` keys on a card with
    ``sms`` SMs and ``smem_optin`` shared bytes a block may opt into;
    ``aligned``: the three input bases are 16-byte aligned. Bulk copies
    need 16-byte aligned rows (B % 16 == 0) and bases."""
    table = _table_bytes(nk, counts)
    if table > smem_optin:
        blocks = -(-r * b // _GLOBAL_THREADS)
        return Plan(GLOBAL, max(1, min(r, blocks, sms * _BLOCKS_PER_SM)),
                    _GLOBAL_THREADS, 0, 0, 0)
    direct = _branch_plan(DIRECT, r, b, nk, counts, smem_optin, sms)
    if (aligned and b > 0 and b % 16 == 0
            and direct.resident < _BULK_BELOW_RESIDENT
            and table + _ring_bytes(b) <= smem_optin):
        return _branch_plan(BULK, r, b, nk, counts, smem_optin, sms)
    return direct


@functools.lru_cache(maxsize=1024)
def _launch_args(r: int, b: int, nk: int, counts: bool, aligned: bool,
                 index: int):
    """``(plan, array, address)``: the plan for this shape on CUDA device
    ``index`` and the C launcher's ten int arguments packed in a ctypes
    array (kept alive by the cache) — ctypes passes one pointer far faster
    than ten ints."""
    plan = _plan(r, b, nk, counts, aligned, *_device_info(index))
    args = (ctypes.c_int * 10)(r, b, nk, int(counts), plan.branch,
                               plan.grid, plan.threads, plan.smem,
                               plan.chunk, index)
    return plan, args, ctypes.addressof(args)


#: the bound C launcher (set at first use) and each device's
#: (shared-memory opt-in, SM count)
_launch = None
_devices: Dict[int, Tuple[int, int]] = {}


def _lib() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library, and bind its
    launcher to the module."""
    global _launch
    lib = cuda_build.load(_SOURCE)
    if _launch is None:
        lib.keyed_hist_error_string.restype = ctypes.c_char_p
        lib.keyed_hist_error_string.argtypes = [ctypes.c_int]
        lib.keyed_hist_device_info.restype = ctypes.c_int
        lib.keyed_hist_device_info.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.keyed_hist_launch.restype = ctypes.c_int
        lib.keyed_hist_launch.argtypes = [ctypes.c_void_p] * 7
        _launch = lib.keyed_hist_launch
    return lib


def _device_info(index: int) -> Tuple[int, int]:
    """(shared-memory opt-in bytes, SM count) of CUDA device ``index``,
    read once."""
    info = _devices.get(index)
    if info is None:
        lib = _lib()
        smem, sms = ctypes.c_int(), ctypes.c_int()
        err = lib.keyed_hist_device_info(index, ctypes.byref(smem),
                                         ctypes.byref(sms))
        if err != 0:
            raise RuntimeError(
                f"keyed_hist: reading device {index}'s properties failed: "
                f"{lib.keyed_hist_error_string(err).decode()}")
        info = _devices[index] = (smem.value, sms.value)
    return info


def smem_budget(device) -> int:
    """Shared-memory bytes one block may use on ``device`` — rows whose
    table (``nk * 4`` bytes, doubled with counts) exceeds it take the
    kernel's global-atomic branch."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _device_info(index)[0]


def _refuse(keys, vals, valid, nk):
    """Raise the error for inputs ``keyed_hist_cuda`` does not take."""
    if keys.dtype != torch.int32 or vals.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise TypeError(f"keyed_hist_cuda takes int32 keys/vals and bool "
                        f"valid, got {keys.dtype}/{vals.dtype}/"
                        f"{valid.dtype}")
    if not (keys.is_cuda and vals.device == keys.device
            and valid.device == keys.device):
        raise ValueError("keyed_hist_cuda needs all inputs on one CUDA "
                         "device")
    if keys.dim() != 2 or vals.shape != keys.shape \
            or valid.shape != keys.shape:
        raise ValueError(f"keyed_hist_cuda takes matching [R, B] inputs, "
                         f"got {tuple(keys.shape)}/{tuple(vals.shape)}/"
                         f"{tuple(valid.shape)}")
    raise ValueError(f"keyed_hist_cuda: shape {tuple(keys.shape)}, nk={nk} "
                     f"is outside the kernel's int32 extents")


#: the handle of a CUDA device's current stream (the caller's), by index
_current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_INT32 = torch.int32
_BOOL = torch.bool
_EXTENT = 2 ** 31


def keyed_hist_cuda(keys: torch.Tensor, vals: torch.Tensor,
                    valid: torch.Tensor, nk: int, want_counts: bool = True):
    """Launch the Hopper kernel on ``[R, B]`` CUDA rows, on the current
    stream of their device. The sums+counts form returns two views of one
    ``[2, R, nk]`` allocation."""
    # One test on the fast path; _refuse names what failed.
    index = keys.get_device()
    shape = keys.shape
    if not (keys.dtype is _INT32 and vals.dtype is _INT32
            and valid.dtype is _BOOL and keys.is_cuda
            and vals.get_device() == index and vals.is_cuda
            and valid.get_device() == index and valid.is_cuda
            and len(shape) == 2 and vals.shape == shape
            and valid.shape == shape and shape[0] < _EXTENT
            and shape[1] < _EXTENT and 0 <= nk < _EXTENT):
        _refuse(keys, vals, valid, nk)
    r, b = shape
    keys = keys.contiguous()
    vals = vals.contiguous()
    valid = valid.contiguous()
    if want_counts:
        sums, cnts = keys.new_empty((2, r, nk)).unbind(0)
    else:
        sums, cnts = keys.new_empty((r, nk)), None
    if r == 0 or nk == 0:
        return sums, cnts
    launch = _launch
    if launch is None:
        _lib()
        launch = _launch
    kp, vp, mp = keys.data_ptr(), vals.data_ptr(), valid.data_ptr()
    plan, _, args = _launch_args(r, b, nk, want_counts,
                                 ((kp | vp | mp) & 15) == 0, index)
    err = launch(kp, vp, mp, sums.data_ptr(),
                 cnts.data_ptr() if want_counts else None, args,
                 _current_stream(index))
    if err != 0:
        raise RuntimeError(
            f"keyed_hist kernel launch failed: "
            f"{_lib().keyed_hist_error_string(err).decode()} (cuda error "
            f"{err}) at R={r} B={b} nk={nk} counts={want_counts}, {plan}")
    if warming():
        keyed_hist.warm_launches += 1
        if want_counts:
            keyed_hist.warm_launches_counts += 1
    else:
        keyed_hist.launches += 1
        if want_counts:
            keyed_hist.launches_counts += 1
    return sums, cnts


#: set on a thread while it warms the failure path on disposable inputs
#: (``utils/compile_cache.py``): its launches count in
#: ``keyed_hist.warm_launches``, so a path's own counts hold its own work
_warming = threading.local()


@contextlib.contextmanager
def counting_as_warm():
    """Count this thread's kernel launches as warm launches while open."""
    prev = warming()
    _warming.on = True
    try:
        yield
    finally:
        _warming.on = prev


def warming() -> bool:
    """Whether this thread is inside :func:`counting_as_warm` (every
    kernel wrapper counts its launches by it)."""
    return getattr(_warming, "on", False)


def keyed_hist(keys: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor,
               nk: int, want_counts: bool = True):
    """Per-row keyed sums and counts.

    ``keys/vals/valid``: ``[..., B]`` (any leading dims, flattened to rows).
    Returns ``(sums, counts)`` of shape ``[..., nk]``: per row, the sum of
    ``vals`` and the count of valid records carrying each key in
    ``[0, nk)``; other keys drop. ``want_counts=False`` returns counts as
    None. CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``keyed_hist.launches``; the sums+counts form also
    in ``keyed_hist.launches_counts``; under :func:`counting_as_warm` in
    ``keyed_hist.warm_launches`` and ``warm_launches_counts`` instead)."""
    flatten = keys.dim() != 2
    if flatten:
        lead = tuple(keys.shape[:-1])
        b = keys.shape[-1]
        r = 1
        for d in lead:
            r *= d
        keys = keys.reshape(r, b)
        vals = vals.reshape(r, b)
        valid = valid.reshape(r, b)
    if keys.is_cuda:
        sums, cnts = keyed_hist_cuda(keys, vals, valid, nk, want_counts)
    elif keys.device.type == "cpu":
        sums, cnts = keyed_hist_plain(keys, vals, valid, nk, want_counts)
    else:
        raise ValueError(f"keyed_hist: unsupported device {keys.device}")
    if not flatten:
        return sums, cnts
    return (sums.reshape(lead + (nk,)),
            cnts.reshape(lead + (nk,)) if cnts is not None else None)


#: kernel launches (both forms) since the last reset
keyed_hist.launches = 0
#: of those, launches of the sums+counts form
keyed_hist.launches_counts = 0
#: launches made under :func:`counting_as_warm` (both forms), and of
#: those the sums+counts form's
keyed_hist.warm_launches = 0
keyed_hist.warm_launches_counts = 0
