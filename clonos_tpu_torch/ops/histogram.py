"""Keyed histogram (segment sum): the heart of every keyed aggregation and
of the exchange's record placement.

Port of ``clonos_tpu/ops/histogram.py``. The TPU package streams records
through a Pallas compare-accumulate kernel (``_hist_kernel`` /
``_hist_kernel_sums``); here a CUDA kernel written for Hopper
(``csrc/keyed_hist.cu``: one thread block per row, the row's table in
shared memory, int32 atomics) takes their place, and
:func:`keyed_hist_plain` is its plain PyTorch version — a masked
``scatter_add_`` bit-identical to the reference's XLA fallback
(``_hist_xla``).

:func:`keyed_hist` picks by the device of the tensors it is given: the
plain version for CPU tensors, the kernel for CUDA tensors (a build or
launch failure raises; there is no fallback).
"""

from __future__ import annotations

import ctypes

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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_SOURCE)
    if not getattr(lib, "_clonos_bound", False):
        lib.keyed_hist_launch.restype = ctypes.c_int
        lib.keyed_hist_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.keyed_hist_error_string.restype = ctypes.c_char_p
        lib.keyed_hist_error_string.argtypes = [ctypes.c_int]
        lib.keyed_hist_smem_budget.restype = ctypes.c_int
        lib.keyed_hist_smem_budget.argtypes = []
        lib._clonos_bound = True
    return lib


def smem_budget(device) -> int:
    """Shared-memory bytes one block may use on ``device`` — rows whose
    table (``nk * 4`` bytes, doubled with counts) exceeds it take the
    kernel's global-atomic branch."""
    with torch.cuda.device(device):
        return int(_lib().keyed_hist_smem_budget())


def keyed_hist_cuda(keys: torch.Tensor, vals: torch.Tensor,
                    valid: torch.Tensor, nk: int, want_counts: bool = True):
    """Launch the Hopper kernel on ``[R, B]`` CUDA rows."""
    if not (keys.device.type == "cuda" and vals.device == keys.device
            and valid.device == keys.device):
        raise ValueError("keyed_hist_cuda needs all inputs on one CUDA "
                         "device")
    if keys.dtype != torch.int32 or vals.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise TypeError(f"keyed_hist_cuda takes int32 keys/vals and bool "
                        f"valid, got {keys.dtype}/{vals.dtype}/"
                        f"{valid.dtype}")
    if keys.dim() != 2 or vals.shape != keys.shape \
            or valid.shape != keys.shape:
        raise ValueError(f"keyed_hist_cuda takes matching [R, B] inputs, "
                         f"got {tuple(keys.shape)}/{tuple(vals.shape)}/"
                         f"{tuple(valid.shape)}")
    r, b = keys.shape
    if r >= 2 ** 31 or b >= 2 ** 31 or nk >= 2 ** 31:
        raise ValueError(f"keyed_hist_cuda: shape {r}x{b}, nk={nk} "
                         f"exceeds the kernel's int32 extents")
    keys = keys.contiguous()
    vals = vals.contiguous()
    valid = valid.contiguous()
    sums = torch.empty((r, nk), dtype=torch.int32, device=keys.device)
    cnts = (torch.empty((r, nk), dtype=torch.int32, device=keys.device)
            if want_counts else None)
    if r == 0 or nk == 0:
        return sums, cnts
    with torch.cuda.device(keys.device):
        lib = _lib()
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.keyed_hist_launch(
            keys.data_ptr(), vals.data_ptr(), valid.data_ptr(),
            sums.data_ptr(), cnts.data_ptr() if cnts is not None else None,
            r, b, nk, int(want_counts), stream)
    if err != 0:
        raise RuntimeError(
            f"keyed_hist kernel launch failed: "
            f"{lib.keyed_hist_error_string(err).decode()} (cuda error "
            f"{err}) at R={r} B={b} nk={nk} counts={want_counts}")
    keyed_hist.launches += 1
    if want_counts:
        keyed_hist.launches_counts += 1
    return sums, cnts


def keyed_hist(keys: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor,
               nk: int, want_counts: bool = True):
    """Per-row keyed sums and counts.

    ``keys/vals/valid``: ``[..., B]`` (any leading dims, flattened to rows).
    Returns ``(sums, counts)`` of shape ``[..., nk]``: per row, the sum of
    ``vals`` and the count of valid records carrying each key in
    ``[0, nk)``; other keys drop. ``want_counts=False`` returns counts as
    None. CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``keyed_hist.launches``; the sums+counts form also
    in ``keyed_hist.launches_counts``)."""
    lead = tuple(keys.shape[:-1])
    b = keys.shape[-1]
    r = 1
    for d in lead:
        r *= d
    kf = keys.reshape(r, b)
    vf = vals.reshape(r, b)
    mf = valid.reshape(r, b)
    if kf.device.type == "cpu":
        sums, cnts = keyed_hist_plain(kf, vf, mf, nk, want_counts)
    elif kf.device.type == "cuda":
        sums, cnts = keyed_hist_cuda(kf, vf, mf, nk, want_counts)
    else:
        raise ValueError(f"keyed_hist: unsupported device {kf.device}")
    return (sums.reshape(lead + (nk,)),
            cnts.reshape(lead + (nk,)) if cnts is not None else None)


#: kernel launches (both forms) since the last reset
keyed_hist.launches = 0
#: of those, launches of the sums+counts form
keyed_hist.launches_counts = 0
