"""PyTorch port, package rules: every module of ``clonos_tpu_torch``, and
``chip_smoke``, imports without pulling in ``jax`` or any ``clonos_tpu``
module (checked in a fresh interpreter, since this test process has both
loaded; the model checker ``verify`` and its conformance layer
among them), no source file names one in an import statement at any depth
(function bodies included), and the entry
points default to the card: without one they raise instead of running on
the CPU."""

import ast
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
verify = [name for name in ("clonos_tpu_torch.verify",
                            "clonos_tpu_torch.verify.conformance")
          if importlib.import_module(name) is sys.modules[name]]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "clonos_tpu" or m.startswith("clonos_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(verify))
"""


def test_port_imports_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad, verify = (proc.stdout.splitlines() + ["", ""])[:3]
    assert int(count) >= 64          # every module of the port was walked
    assert bad == "", f"port pulled in {bad}"
    # the model checker and its conformance layer were imported too
    assert verify == ("clonos_tpu_torch.verify,"
                      "clonos_tpu_torch.verify.conformance")


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


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.runtime.scheduler",
    "clonos_tpu_torch.runtime.dispatcher",
    "clonos_tpu_torch.parallel.distributed",
    "clonos_tpu_torch.examples.spanning"])
def test_slot_pool_modules_import_alone_without_jax(module):
    """The slot-pool slice's modules (the scheduler, the dispatcher, the
    placement helper and the spanning example; their references are
    partly JAX-free) each import alone in a fresh interpreter without
    ``jax`` or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.obs.hlc", "clonos_tpu_torch.obs.timeline",
    "clonos_tpu_torch.obs.incident", "clonos_tpu_torch.obs.rootcause",
    "clonos_tpu_torch.obs.detect", "clonos_tpu_torch.obs.lineage",
    "clonos_tpu_torch.obs.audit"])
def test_cross_process_plane_modules_import_alone_without_jax(module):
    """The cross-process observability planes (hybrid logical clocks and
    the causal timeline, incident bundles and their root-cause analysis,
    gray-failure detection, record lineage, and the audit's cross-layout
    diff; their references are JAX-free) each import alone in a fresh
    interpreter without ``jax`` or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.autoscale", "clonos_tpu_torch.autoscale.signals",
    "clonos_tpu_torch.autoscale.policy",
    "clonos_tpu_torch.autoscale.controller"])
def test_autoscale_modules_import_alone_without_jax(module):
    """The autoscaler (signals, policy, controller; their references are
    JAX-free) imports alone in a fresh interpreter without ``jax`` or
    ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.soak", "clonos_tpu_torch.soak.slo",
    "clonos_tpu_torch.soak.chaos", "clonos_tpu_torch.soak.serveload",
    "clonos_tpu_torch.soak.driver", "clonos_tpu_torch.runtime.serve"])
def test_soak_modules_import_alone_without_jax(module):
    """The soak harness (SLO tracker, chaos DSL, serve load, driver;
    ``slo`` and ``chaos`` are JAX-free in the reference, and the port keeps
    its own copies), and the read tier that takes its ``quantile``, each
    import alone in a fresh interpreter without ``jax`` or
    ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "clonos_tpu")


def _bad_imports(path: str):
    """``(line, module)`` of every import of ``jax``/``jaxlib`` or of the
    reference package in ``path``, at any depth: module level, function
    and class bodies, conditional blocks, and ``importlib.import_module``
    / ``__import__`` calls with a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else getattr(fn, "id", None))
            if (name in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _forbidden(node.args[0].value)):
                bad.append((node.lineno, node.args[0].value))
    return bad


def _port_sources():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(_REPO,
                                                   "clonos_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def test_no_source_imports_jax_or_reference_at_any_depth():
    """An AST scan of every ``.py`` of the port and of ``chip_smoke.py``:
    an import of ``jax``, ``jaxlib`` or ``clonos_tpu`` (but not
    ``clonos_tpu_torch``) anywhere, including inside functions, fails."""
    sources = _port_sources()
    assert len(sources) >= 69          # every module of the port
    found = {os.path.relpath(p, _REPO): _bad_imports(p) for p in sources}
    assert {p: b for p, b in found.items() if b} == {}


@pytest.mark.parametrize("snippet, hits", [
    ("import jax", 1), ("import jax.numpy as jnp", 1),
    ("from jax import numpy", 1), ("from jaxlib import x", 1),
    ("def f():\n    from clonos_tpu.inflight import log", 1),
    ("class C:\n    def m(self):\n        import clonos_tpu.obs", 1),
    ("if x:\n    import importlib\n"
     "    importlib.import_module('clonos_tpu.cli')", 1),
    ("from clonos_tpu_torch import obs", 0),
    ("import clonos_tpu_torch.runtime.scheduler", 0),
    ("from . import remote", 0), ("import jaxtyping", 0)])
def test_import_guard_sees_every_depth(tmp_path, snippet, hits):
    """The guard's own check: imports at any depth are caught; the port's
    package and relative imports are not."""
    p = tmp_path / "probe.py"
    p.write_text(snippet + "\n")
    assert len(_bad_imports(str(p))) == hits


def _job():
    env = StreamEnvironment(name="imports", num_key_groups=8)
    (env.synthetic_source(vocab=7, batch_size=4, parallelism=2)
        .key_by().window_count(num_keys=7, window_size=4).sink())
    return env.build()


@pytest.mark.parametrize("entry", ["LocalExecutor", "ClusterRunner",
                                   "init_carry", "records.make",
                                   "SliceWorker", "SlotPoolScheduler",
                                   "Dispatcher"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(entry,
                                                               tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from clonos_tpu_torch.runtime.dispatcher import Dispatcher
    from clonos_tpu_torch.runtime.leader import FileLeaderElection
    from clonos_tpu_torch.runtime.remote import JobMasterServer
    from clonos_tpu_torch.runtime.scheduler import (SliceWorker,
                                                    SlotPoolScheduler)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "LocalExecutor":
            LocalExecutor(_job())
        elif entry == "ClusterRunner":
            ClusterRunner(_job())
        elif entry == "records.make":
            make([1, 2, 3], capacity=4)
        elif entry == "SliceWorker":
            # Raises before it dials the JobMaster.
            SliceWorker("w0", ("127.0.0.1", 1))
        elif entry == "SlotPoolScheduler":
            jm = JobMasterServer()
            try:
                SlotPoolScheduler(
                    jm, FileLeaderElection(str(tmp_path / "l"), "jm"),
                    "clonos_tpu_torch.examples.spanning:build_job")
            finally:
                jm.close()
        elif entry == "Dispatcher":
            Dispatcher(lease_path=str(tmp_path / "l"), serve=False)
        else:
            CompiledJob(_job()).init_carry()


@pytest.mark.parametrize("module", [
    "clonos_tpu_torch.parallel.distributed",
    "clonos_tpu_torch.parallel.dryrun",
    "clonos_tpu_torch.examples.flagship", "clonos_tpu_torch.convert"])
def test_sharded_deployment_modules_import_alone_without_jax(module):
    """The sharded deployment's modules (the torch.distributed backend
    with its rule table and collectives, the multi-rank dryrun, the
    flagship job, and the shard/unshard conversion) each import alone in
    a fresh interpreter without ``jax`` or ``clonos_tpu``."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE, module], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


_LINT_MODULES = [
    "clonos_tpu_torch.lint", "clonos_tpu_torch.lint.core",
    "clonos_tpu_torch.lint.waivers", "clonos_tpu_torch.lint.runner",
    "clonos_tpu_torch.lint.nondet", "clonos_tpu_torch.lint.concurrency",
    "clonos_tpu_torch.lint.markers", "clonos_tpu_torch.lint.tracesafe",
    "clonos_tpu_torch.lint.overlapwindow"]
_ANALYSIS_MODULES = [
    "clonos_tpu_torch.analysis", "clonos_tpu_torch.analysis.callgraph",
    "clonos_tpu_torch.analysis.threads",
    "clonos_tpu_torch.analysis.lockorder",
    "clonos_tpu_torch.analysis.races", "clonos_tpu_torch.analysis.census",
    "clonos_tpu_torch.analysis.runner", "clonos_tpu_torch.analysis.ablate"]

_ALONE_STDLIB = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "clonos_tpu",
                                             "torch", "numpy"))))
"""


@pytest.mark.parametrize("module", _LINT_MODULES + _ANALYSIS_MODULES)
def test_lint_and_analysis_modules_import_alone_on_the_stdlib(module):
    """The determinism lint and the whole-program analysis each import
    alone in a fresh interpreter with nothing but the standard library:
    no ``jax``, no ``clonos_tpu``, no ``torch`` and no ``numpy`` (the
    census reads the port's wire widths, and the ablation twin execs the
    port's executor, only when they run)."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _ALONE_STDLIB, module],
                          cwd=_REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"{module} pulled in {proc.stdout}"


_LINT_RUN = r"""
import sys
from clonos_tpu_torch.lint import run_lint
res = run_lint(["clonos_tpu_torch/lint", "clonos_tpu_torch/analysis"])
print(res.ok, ",".join(sorted(m for m in sys.modules
                              if m.split(".")[0] in ("torch", "numpy",
                                                     "jax", "clonos_tpu"))))
"""


def test_lint_runs_without_torch_or_numpy():
    """A lint run (which also loads the analysis rules' registry entries
    for waiver validation) imports no ``torch`` and no ``numpy``, and no
    source of either package names one in an import statement at any
    depth."""
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", _LINT_RUN], cwd=_REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True"], proc.stdout
    for sub in ("lint", "analysis"):
        root = os.path.join(_REPO, "clonos_tpu_torch", sub)
        for name in sorted(os.listdir(root)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in (
                        "torch", "numpy", "jax", "clonos_tpu"), \
                        f"{sub}/{name} imports {m}"
