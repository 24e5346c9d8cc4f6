"""Build-at-first-use for the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library is keyed by a hash of the source and the flags, under the build
directory, so an edited source rebuilds and an unchanged one loads the
cached build. The directory is ``build/clonos_tpu_torch/`` at the
repository root (listed in ``.gitignore``) unless :func:`set_build_dir`
re-points it (``utils/compile_cache.py``'s ``enable_compile_cache``); it
is read at every call, and a library already loaded in this process
stays loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_dir = Path(__file__).resolve().parents[2] / "build" / "clonos_tpu_torch"
#: per source: {"seconds": build wall (0.0 when cached), "log": the
#: compiler's stderr (ptxas's register/shared-memory report) or
#: "(cached)", "path": the library} — chip_smoke prints it.
BUILD_INFO: Dict[str, dict] = {}


def build_dir() -> Path:
    """The directory builds are published to and loaded from."""
    return _build_dir


def set_build_dir(path) -> Path:
    """Publish later builds to ``path`` and load them from there.
    Libraries this process has already loaded stay loaded."""
    global _build_dir
    _build_dir = Path(path)
    return _build_dir


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / name
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>`` unless a build of this exact source exists.
    Raises with nvcc's output when the compile fails."""
    out = library_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "(cached)",
                                     "path": str(out)})
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # clonos: allow(entropy): the pid only names this process's private
    # temp file for nvcc's output, renamed into place once built — a
    # build artifact, never record data
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        # Publish atomically: a concurrent process must never dlopen a
        # half-written library.
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    BUILD_INFO[name] = {"seconds": time.monotonic() - t0,
                        "log": proc.stderr.strip(), "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
