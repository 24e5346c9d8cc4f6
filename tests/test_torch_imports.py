"""PyTorch port, package rules: every module of ``clonos_tpu_torch``, and
``chip_smoke``, imports without pulling in ``jax`` or any ``clonos_tpu``
module (checked in a fresh interpreter, since this test process has both
loaded), and the entry
points default to the card: without one they raise instead of running on
the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from clonos_tpu_torch.api.environment import StreamEnvironment
from clonos_tpu_torch.api.records import make
from clonos_tpu_torch.runtime.cluster import ClusterRunner
from clonos_tpu_torch.runtime.executor import CompiledJob, LocalExecutor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import clonos_tpu_torch
names = ["clonos_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(clonos_tpu_torch.__path__,
                                          "clonos_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "clonos_tpu" or m.startswith("clonos_tpu."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = (proc.stdout.splitlines() + [""])[:2]
    assert int(count) >= 64          # every module of the port was walked
    assert bad == "", f"port pulled in {bad}"


_ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "clonos_tpu"))))
"""


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.storage", "clonos_tpu_torch.storage.segment",
    "clonos_tpu_torch.storage.tiered", "clonos_tpu_torch.utils.jsonl",
    "clonos_tpu_torch.runtime.incremental",
    "clonos_tpu_torch.inflight.log"])
def test_tiered_storage_modules_import_alone_without_jax(module):
    """The tiered-storage slice's modules (whose references are partly
    JAX-free) each import alone in a fresh interpreter without ``jax``
    or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.causal.services", "clonos_tpu_torch.causal.determinant",
    "clonos_tpu_torch.runtime.timers", "clonos_tpu_torch.api.feeds",
    "clonos_tpu_torch.runtime.txn", "clonos_tpu_torch.runtime.filesink"])
def test_host_boundary_modules_import_alone_without_jax(module):
    """The host-boundary slice's modules (services, timers, feeds, the
    transaction log and the file sink, whose references are JAX-free)
    each import alone in a fresh interpreter without ``jax`` or
    ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.obs", "clonos_tpu_torch.obs.trace",
    "clonos_tpu_torch.obs.chrome", "clonos_tpu_torch.obs.profile",
    "clonos_tpu_torch.obs.history", "clonos_tpu_torch.utils.metrics",
    "clonos_tpu_torch.utils.devsync", "clonos_tpu_torch.config",
    "clonos_tpu_torch.config.options", "clonos_tpu_torch.config.defaults"])
def test_observability_modules_import_alone_without_jax(module):
    """The observability slice's modules (tracer, Chrome export,
    profiler, history, reporters and endpoint, device sync, typed
    configuration; their references are partly JAX-free) each import
    alone in a fresh interpreter without ``jax`` or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.version", "clonos_tpu_torch.__main__",
    "clonos_tpu_torch.cli", "clonos_tpu_torch.ops.native",
    "clonos_tpu_torch.causal.serde", "clonos_tpu_torch.causal.log",
    "clonos_tpu_torch.causal.replication",
    "clonos_tpu_torch.parallel.transport",
    "clonos_tpu_torch.runtime.remote",
    "clonos_tpu_torch.examples.wordcount"])
def test_process_runtime_modules_import_alone_without_jax(module):
    """The wire-format and process-runtime slice's modules (the codec and
    its native loader, the transport, the host-side log, the remote
    control plane, the CLI and its entry point, the example job; their
    references are partly JAX-free) each import alone in a fresh
    interpreter without ``jax`` or ``clonos_tpu``, and importing the
    entry point runs nothing."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.runtime.query", "clonos_tpu_torch.runtime.serve",
    "clonos_tpu_torch.runtime.leader"])
def test_read_tier_modules_import_alone_without_jax(module):
    """The read tier's modules (queryable state, the replicas, endpoint
    and router, and leader leases; their references are partly
    JAX-free) each import alone in a fresh interpreter without ``jax``
    or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


def _job():
    env = StreamEnvironment(name="imports", num_key_groups=8)
    (env.synthetic_source(vocab=7, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=7, window_size=4).sink())
    return env.build()


@pytest.mark.parametrize("entry", ["LocalExecutor", "ClusterRunner",
                                   "init_carry", "records.make"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "LocalExecutor":
            LocalExecutor(_job())
        elif entry == "ClusterRunner":
            ClusterRunner(_job())
        elif entry == "records.make":
            make([1, 2, 3], capacity=4)
        else:
            CompiledJob(_job()).init_carry()
