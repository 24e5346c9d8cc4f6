"""Persistent kernel build cache (port of ``clonos_tpu/utils/compile_cache.py``).

The reference persists XLA executables so a RESTARTED job pays near zero
for the failure path's compiles. On the card a "compile" is build, load
and first dispatch: the ``nvcc`` build and ``dlopen`` of the kernel
library (``ops/cuda_build.py``), CUDA's lazy load of each kernel module
at its first launch, and the caching allocator's first growth to a
shape. Only the first survives a process, so the persistent cache is the
build directory: :func:`enable_compile_cache` points every build of the
port (the CUDA kernels and the host codec, ``ops/native.py``) at one
directory, and a restarted process (a rebooted standby) loads the
libraries its predecessor built instead of running ``nvcc`` inside
``finalize.first-step-recompile``.

Mesh-sharded runs get a namespace of their own, as in the reference:
:func:`enable_compile_cache` takes the mesh and the carry's placement
tree and keys a subdirectory from their fingerprints, so unsharded and
sharded runs never share a directory.

Where the port differs: every build is persisted — the reference's
thresholds (``CLONOS_COMPILE_CACHE_MIN_S`` and
``jax_persistent_cache_min_*``) have no counterpart, and this module
reads no environment variable. The port has no Triton kernel and no
``torch.compile``, so no other cache directory exists to point.
:func:`aot_lower_first_step` cannot lower without running, so it
dispatches the first-step block program once on disposable zero inputs.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple, Optional

import torch

from clonos_tpu_torch.ops import cuda_build


class FirstStepWarm(NamedTuple):
    """What :func:`aot_lower_first_step` warmed: the first-step block's
    length, the device it ran on and the wall seconds it took."""

    block_steps: int
    device: str
    seconds: float


def sharding_cache_key(mesh: Optional[Any] = None,
                       specs: Optional[Any] = None) -> str:
    """Cache-namespace token for a (mesh, placement tree) pair. ``None``
    and ``None`` (the single-process program) get their own stable token,
    so turning sharding on or off switches namespaces."""
    from clonos_tpu_torch.parallel.distributed import (mesh_fingerprint,
                                                       spec_fingerprint)
    mk = mesh_fingerprint(mesh)
    sk = spec_fingerprint(specs) if specs is not None else "nospec"
    return f"{mk}-{sk}"


def enable_compile_cache(cache_dir: str, mesh: Optional[Any] = None,
                         specs: Optional[Any] = None) -> str:
    """Point every later build of the port at ``cache_dir`` — suffixed
    with :func:`sharding_cache_key` when a mesh (and optionally the
    carry's placement tree) is given. Creates the directory and returns
    it. Libraries already loaded in this process stay loaded."""
    if mesh is not None or specs is not None:
        cache_dir = os.path.join(cache_dir, sharding_cache_key(mesh, specs))
    os.makedirs(cache_dir, exist_ok=True)
    cuda_build.set_build_dir(cache_dir)
    return cache_dir


def load_kernels(device) -> None:
    """Build (or find in the cache) and load every kernel library a run
    on ``device`` launches: the keyed histogram and the join's keyed rank
    on a card; none on the CPU, where every kernel takes its plain
    version."""
    if torch.device(device).type == "cuda":
        from clonos_tpu_torch.ops import histogram, keyrank
        histogram._lib()
        keyrank._lib()


def aot_lower_first_step(executor, metric_group: Optional[Any] = None
                         ) -> Optional[FirstStepWarm]:
    """Warm the standby's FIRST-STEP program — the block a rehydrated
    standby dispatches before anything else — before any failure: build
    and load the kernel libraries the executor's device needs, then run
    ``CompiledJob.run_block`` once on a zero carry shaped like the live
    one and on :meth:`LocalExecutor.first_step_inputs`, and synchronise.

    The live carry, the step counters, the host RNG, the step-input
    ledger, the sinks and the block listeners are never touched: the
    block runs on a carry of its own (``run_block`` writes the rings of
    the carry it is given in place), never through the executor's own
    block loop. The zero carry is freed before returning. Its kernel
    launches count as warm launches (``ops/histogram.py``). On a mesh the
    block gathers across the ranks, so every rank calls this in
    lockstep.

    Returns a :class:`FirstStepWarm`, or None when the warm fails — not
    silently: it emits a ``recovery.aot-lower-failed`` trace instant and,
    when ``metric_group`` is given, bumps the counter of the same name,
    so a standby that will pay the cold load at failover is visible now.
    A failure never switches any kernel to its plain version."""
    from clonos_tpu_torch.obs.trace import get_tracer
    from clonos_tpu_torch.ops.histogram import counting_as_warm
    from clonos_tpu_torch.utils.devsync import device_sync
    from clonos_tpu_torch.utils.tree import tree_map
    t0 = time.monotonic()
    try:
        carry = executor.carry      # one read: stable vs a concurrent swap
        device = carry.record_counts.device
        load_kernels(device)
        zero = tree_map(torch.zeros_like, carry)
        inputs = executor.first_step_inputs()
        with counting_as_warm():
            new, outs = executor.compiled.run_block(zero, inputs)
        device_sync(new)
        del zero, new, outs
        seconds = time.monotonic() - t0
        get_tracer().complete("recovery.aot-lower", seconds)
        return FirstStepWarm(int(inputs.times.shape[0]), str(device),
                             seconds)
    except Exception as err:
        get_tracer().event("recovery.aot-lower-failed",
                           error=repr(err)[:200])
        if metric_group is not None:
            metric_group.counter("recovery.aot-lower-failed").inc()
        return None
