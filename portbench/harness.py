"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything that belongs to one cell, configuration, driver, topology or
per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the configuration, the driver and the
  traffic's parameters;
- ``configs/<config>.json``: the deployment's sizes and guarantees, and
  the topology it runs;
- ``topologies/<topology>.py`` (with its plain reference under
  ``reference/``): builds the job on the port, captures what the timed
  path produced and compares it;
- ``drivers/<driver>.py``: ``warmup(ctx)`` and ``run(ctx)``, which
  returns the end-to-end readings;
- ``metrics/<metric>.py``: ``read(ctx)``, one per-layer metric, or None
  where the run holds nothing for it to read. A metric read alike in
  several cells, ``<quantity>.<cells>``, may share one reader,
  ``metrics/<quantity>.py``, where it has no file of its own.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: top-level modules that must not be loaded: the JAX stack and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "clonos_tpu")


def load_json(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    else the shared ``metrics/<quantity>.py`` of ``<quantity>.<cells>``."""
    if (HERE / "metrics" / f"{name}.py").exists() or "." not in name:
        return load_module("metrics", name)
    return load_module("metrics", name.rsplit(".", 1)[0])


def manifest() -> Dict:
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Ctx:
    """What one run knows: the cell, its configuration, the seed, the
    runner, the driver's readings and the traced stretch."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, device, overrides: Optional[Dict] = None):
        self.cell_name = cell_name
        self.cell = load_json("workloads", cell_name)
        self.config_name = self.cell["config"]
        self.config = load_json("configs", self.config_name)
        for k, v in (overrides or {}).items():
            (self.cell if k in self.cell else self.config)[k] = v
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.topology = load_module("topologies", self.config["topology"])
        self.runner = None
        self.feed = None
        self.sink_tap = None
        self.stream_inputs: Dict[str, Any] = {}
        self.results: Dict[str, Any] = {}
        self.tracer = None
        self.block_host_ms: list = []

    def rng(self, purpose: str) -> np.random.Generator:
        """A generator for one purpose, drawn from the seed: the same seed
        gives the same draws whatever else the run does."""
        tag = int.from_bytes(purpose.encode()[:8].ljust(8, b"\0"), "little")
        return np.random.default_rng([self.seed % 2 ** 63, tag])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def steps_executed(self) -> int:
        return self.runner.executor._steps_executed

    @property
    def records_per_epoch(self) -> int:
        return (self.config["steps_per_epoch"]
                * self.topology.records_per_step(self.config))

    def tick(self, unit: int, elapsed_s: float, final: bool = False) -> None:
        if self.tracer is not None:
            self.tracer.tick(unit, elapsed_s, final)

    def window_open(self, deadline: float) -> bool:
        """True while a closed-loop window runs: until ``deadline`` and,
        in a traced run, until its stretch has been traced."""
        return time.perf_counter() < deadline or (
            self.tracer is not None and self.tracer.pending)

    def time_blocks(self) -> None:
        """Time each ``run_block`` call on the host (traced runs only)."""
        compiled = self.runner.executor.compiled
        inner = compiled.run_block

        def timed(carry, binputs):
            t0 = time.perf_counter()
            out = inner(carry, binputs)
            self.block_host_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        compiled.run_block = timed


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             overrides: Optional[Dict] = None, tamper=None) -> Dict:
    """Run one cell once and return its result (``line``, the JSON object
    to print, and ``compared``, each number beside its limit).
    ``tamper(ctx, captured, device)``, for the controls only, edits what
    the run produced before it is compared."""
    t_start = time.perf_counter() if t_start is None else t_start
    split = {"import": time.perf_counter() - t_start}
    t = time.perf_counter()
    ctx = Ctx(cell_name, seed, seconds, trace, device, overrides)
    if ctx.device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=ctx.device)
        torch.cuda.synchronize()
    split["context"] = time.perf_counter() - t
    t = time.perf_counter()
    from clonos_tpu_torch.utils.compile_cache import (enable_compile_cache,
                                                      load_kernels)
    enable_compile_cache(str(CHECKOUT / "build" / "portbench"))
    load_kernels(ctx.device)
    split["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx.topology.build(ctx)
    ctx.sync()
    split["allocation"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = load_module("drivers", ctx.cell["driver"])
    driver.warmup(ctx)
    ctx.sync()
    split["warmup"] = time.perf_counter() - t
    if trace:
        from portbench.trace import TraceStretch
        tr = ctx.cell["trace"]
        ctx.tracer = TraceStretch(ctx, tr["start_frac"], tr["units"])
        ctx.tracer.prime()
        ctx.time_blocks()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")
    if ctx.sink_tap is not None:
        ctx.sink_tap.armed = True
    ctx.results = driver.run(ctx)
    ctx.results["setup_s"] = setup_s
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    cap = ctx.topology.capture(ctx)
    ctx.runner = None
    ctx.sink_tap = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if tamper is not None:
        tamper(ctx, cap, ctx.device)
    t = time.perf_counter()
    compared = ctx.topology.compare(ctx, cap, ctx.device)
    log(f"[check] reference {time.perf_counter() - t:.3f} s over "
        f"{cap['steps']} steps")
    correct = all(v <= 0 for v in compared.values())
    line = {
        "correct": correct,
        "attempted": ctx.results["attempted"],
        "failed": ctx.results["failed"],
        "metrics": _metrics(ctx),
        "device": _device(ctx, peak),
    }
    if trace and ctx.tracer is not None and ctx.tracer.summary:
        line["breakdown"] = {
            "device_ops": ctx.tracer.summary["device_ops"],
            "idle_gaps": ctx.tracer.summary["idle_gaps"]}
    line["compared"] = {k: {"value": v, "limit": 0}
                        for k, v in compared.items()}
    return {"line": line, "compared": compared, "ctx": ctx, "captured": cap}


def _metrics(ctx: Ctx) -> Dict[str, Dict]:
    m = manifest()
    out = {}
    if not ctx.trace:
        for e in m["end_to_end"]:
            if ctx.cell_name in e.get("workloads", [ctx.cell_name]):
                out[e["name"]] = {"value": ctx.results[e["name"]],
                                  "unit": e["unit"]}
        return out
    for e in m["per_layer"]:
        if ctx.cell_name not in e.get("workloads", []):
            continue
        value = metric_reader(e["name"]).read(ctx)
        if value is not None:
            out[e["name"]] = {"value": value, "unit": e["unit"]}
    return out


def _device(ctx: Ctx, peak: int) -> Dict:
    if ctx.device.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if ctx.trace:
        s = ctx.tracer.summary if ctx.tracer is not None else None
        d["busy_s"] = s["busy_s"] if s else 0.0
        d["window_s"] = s["window_s"] if s else 0.0
    return d


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) of ``values``, linear between
    order statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def mean(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None
