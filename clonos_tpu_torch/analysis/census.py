"""FT census and the static cost model it feeds.

The paper's overhead claim is about *call sites*: every
nondeterministic decision inside a step function costs one determinant
row (causal/determinant.py: 8 int32 lanes = 32 bytes), every epoch
ships those rows in serde frames (causal/serde.py: 12-byte entry
header + rows + 4-byte CRC under a 9-byte frame header), and the block
program appends the sync-path rows for every subtask every superstep
(executor.py DETS_PER_STEP). All of that is statically visible, so the
census enumerates it from source:

- the executor's fixed sync-lane sequence, parsed out of
  ``CompiledJob._det_rows`` (the determinant tags it stamps, in order);
- per step function (operator ``process_block`` bodies and the block
  program itself), the causal-input references (``ctx.times`` /
  ``ctx.rng_bits``) that consume logged determinants;
- every host-side causal-service call site across the repo
  (``current_time_millis``, ``next_int``, ``serializable_service``,
  ``append_async_determinant``) with its determinant type.

``static_cost_model`` folds the census with a job shape into
bytes-per-epoch and calls-per-step, and predicts an ft-fraction as a
bytes-moved ratio: determinant + replica + in-flight-ring traffic over
total traffic (FT + record flow). It is a bandwidth model — on a
bandwidth-bound pipeline that is the first-order driver — and
``chip_smoke.py``'s ablation phase prints its relative error against
the measured ablation diff rather than pretending it is exact.

``census_fingerprint`` is the blake2b of the census JSON: soak verdicts
and incident bundles record it, and ``clonos_tpu_torch/.clonos-census``
pins it, so a number is traceable to the exact FT call-site population
that produced it. The census covers the port's own sources
(``clonos_tpu_torch``) and reads the widths it asserts from the port's
own ``causal`` modules.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

from clonos_tpu_torch.lint.core import FileContext

from clonos_tpu_torch.analysis.callgraph import CallGraph, module_name

#: repo root (census paths are repo-relative regardless of cwd, so the
#: fingerprint is stable across where the caller ran from).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: host-side causal-service entry points -> determinant type they log.
SERVICE_CALLS = {
    "current_time_millis": "TIMESTAMP",
    "next_int": "RNG",
    "serializable_service": "SERIALIZABLE",
    "timer_service": "TIMER_TRIGGER",
    "append_async_determinant": "ASYNC_ROW",
    "append_scale_determinant": "SCALE",
}

#: block-context attributes whose read consumes a logged determinant.
CAUSAL_INPUT_ATTRS = {
    "times": "TIMESTAMP", "time": "TIMESTAMP",
    "rng_bits": "RNG",
}

#: wire-format widths, kept in lockstep with causal/serde.py and
#: determinant.py (checked against the real structs when a census is
#: built, so importing this module loads nothing beyond the standard
#: library).
ENCODING = {
    "row_bytes": 32,           # det.ROW_BYTES: 8 int32 lanes
    "lanes": 8,                # det.NUM_LANES
    "frame_header_bytes": 9,   # serde._HDR "<IBI"
    "flat_entry_bytes": 12,    # serde._FLAT_E "<iiI"
    "crc_bytes": 4,            # serde._CRC "<I"
}


#: the package's pins: the census and thread-census fingerprints of
#: ``clonos_tpu_torch`` (first token of each file).
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENSUS_PIN = os.path.join(PACKAGE_DIR, ".clonos-census")
THREADS_PIN = os.path.join(PACKAGE_DIR, ".clonos-threads")


def read_pin(path: str) -> str:
    """First token of a pin file, or "" when the file is missing or
    empty."""
    try:
        with open(path) as f:
            toks = f.read().split()
    except OSError:
        return ""
    return toks[0] if toks else ""


def _check_encoding() -> None:
    from clonos_tpu_torch.causal import determinant as det
    from clonos_tpu_torch.causal import serde
    live = {"row_bytes": det.ROW_BYTES, "lanes": det.NUM_LANES,
            "frame_header_bytes": serde._HDR.size,
            "flat_entry_bytes": serde._FLAT_E.size,
            "crc_bytes": serde._CRC.size}
    if live != ENCODING:
        raise RuntimeError(
            f"census ENCODING {ENCODING} disagrees with the port's "
            f"causal/serde.py and determinant.py {live}")


def _sync_lanes(ctx: FileContext) -> List[str]:
    """The ordered determinant tags ``CompiledJob._det_rows`` stamps
    (the fixed sync-path rows every subtask pays every superstep)."""
    from clonos_tpu_torch.causal.determinant import TAG_NAMES
    tag_names = set(TAG_NAMES)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "_det_rows":
            hits = []
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) \
                        and sub.attr in tag_names:
                    hits.append((sub.lineno, sub.col_offset, sub.attr))
            return [t for _l, _c, t in sorted(hits)]
    return []


def build_census(contexts: Sequence[FileContext],
                 graph: Optional[CallGraph] = None) -> Dict:
    """Assemble the census over a parsed file set (AST only)."""
    _check_encoding()
    if graph is None:
        graph = CallGraph(contexts)

    sync_lanes: List[str] = []
    step_functions: List[Dict] = []
    service_sites: List[Dict] = []

    for ctx in contexts:
        if "runtime/executor.py" in ctx.path.replace(os.sep, "/"):
            lanes = _sync_lanes(ctx)
            if lanes:
                sync_lanes = lanes
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in SERVICE_CALLS:
                fi = graph.enclosing(ctx.path, node.lineno)
                service_sites.append({
                    "path": ctx.path, "line": node.lineno,
                    "callee": node.func.attr,
                    "determinant": SERVICE_CALLS[node.func.attr],
                    "function": fi.qname if fi is not None else None,
                })

    for fi in graph.step_entries():
        ctx = next((c for c in contexts if c.path == fi.path), None)
        if ctx is None:
            continue
        counts: Dict[str, int] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr in CAUSAL_INPUT_ATTRS \
                    and fi.covers(node.lineno):
                det_type = CAUSAL_INPUT_ATTRS[node.attr]
                counts[det_type] = counts.get(det_type, 0) + 1
        step_functions.append({
            "function": fi.qname, "path": fi.path, "line": fi.line,
            "causal_input_refs": dict(sorted(counts.items())),
        })

    return {
        "schema": 1,
        "encoding": ENCODING,
        "dets_per_step": len(sync_lanes) or None,
        "sync_lanes": sync_lanes,
        "step_functions": sorted(step_functions,
                                 key=lambda s: s["function"]),
        "service_call_sites": sorted(
            service_sites,
            key=lambda s: (s["path"], s["line"], s["callee"])),
    }


def census_json(census: Dict) -> str:
    return json.dumps(census, sort_keys=True, separators=(",", ":"))


def fingerprint(census: Dict) -> str:
    """blake2b over the canonical census JSON, 16 hex chars — the FT
    call-site population id recorded in soak verdicts and incident
    bundles."""
    return hashlib.blake2b(census_json(census).encode(),
                           digest_size=8).hexdigest()


def _repo_files(paths: Sequence[str]) -> List[str]:
    """The .py files under ``paths`` (relative to the repository root,
    whatever the working directory), repo-relative, after the package
    waiver file's ``exclude`` entries. The process's working directory
    is left alone: other threads may be resolving relative paths."""
    from clonos_tpu_torch.lint.runner import build_waivers, collect_files
    ws = build_waivers()
    found = collect_files([os.path.join(REPO_ROOT, p) for p in paths])
    rel = [os.path.relpath(os.path.abspath(p), REPO_ROOT).replace(
        os.sep, "/") for p in found]
    return [p for p in rel if not ws.excluded(p)]


def _repo_contexts(paths: Sequence[str]) -> List[FileContext]:
    out = []
    for p in _repo_files(paths):
        try:
            with open(os.path.join(REPO_ROOT, p)) as f:
                out.append(FileContext(p, f.read()))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
    return out


#: the last fingerprint computed, keyed by the paths and each file's
#: (name, mtime, size): a soak writes one per verdict, and parsing the
#: package again for an unchanged tree would cost seconds each time.
_last_fingerprint: Dict[tuple, str] = {}


def census_fingerprint(paths: Sequence[str] = ("clonos_tpu_torch",)
                       ) -> str:
    """Fingerprint of the repo's current census (cwd-independent)."""
    files = _repo_files(paths)
    key = (tuple(paths), tuple(
        (p, st.st_mtime_ns, st.st_size)
        for p, st in ((p, os.stat(os.path.join(REPO_ROOT, p)))
                      for p in files)))
    fp = _last_fingerprint.get(key)
    if fp is None:
        fp = fingerprint(build_census(_repo_contexts(paths)))
        _last_fingerprint.clear()
        _last_fingerprint[key] = fp
    return fp


def static_cost_model(census: Dict, *, steps_per_epoch: int,
                      subtasks: int, records_per_step: int,
                      replica_logs: int = 0, ring_vertices: int = 0,
                      record_touches: int = 4,
                      record_bytes: int = 16,
                      spill: bool = False) -> Dict:
    """Fold the census with a job shape into the FT cost ledger.

    ``record_touches`` is how many vertices each record flows through
    (topology depth); ``record_bytes`` is the RecordBatch footprint per
    record (4 int32 fields: key, value, timestamp, valid). The
    predicted ft-fraction is FT bytes moved / total bytes moved per
    epoch — a bandwidth model, cross-checked against the measured
    ablation diff by ``chip_smoke.py``'s ablation phase.

    With ``spill=True`` the ledger grows the tiered-storage lanes
    (storage/tiered.py): every sealed epoch's ring slices AND
    determinant windows cross the d2h lane into the host tier, then the
    host→disk lane as checksummed segments — two extra moves of the
    same bytes, but on the writer thread, so they cost *bandwidth*
    (modeled here), not fence latency.
    """
    enc = census["encoding"]
    dets = census["dets_per_step"] or 0
    row = enc["row_bytes"]

    det_rows = steps_per_epoch * subtasks * dets
    det_bytes = det_rows * row
    replica_bytes = steps_per_epoch * replica_logs * dets * row
    # In-flight rings retain each producing vertex's raw output block.
    ring_bytes = (steps_per_epoch * ring_vertices
                  * records_per_step * record_bytes)
    # Shipping one epoch's determinants as serde FLAT frames: one frame,
    # one entry per log (owner + replica).
    n_logs = subtasks + replica_logs
    wire_bytes = (enc["frame_header_bytes"]
                  + n_logs * (enc["flat_entry_bytes"]
                              + enc["crc_bytes"])
                  + (det_rows + steps_per_epoch * replica_logs * dets)
                  * row)
    data_bytes = (steps_per_epoch * records_per_step
                  * record_touches * record_bytes)
    # Tiered-storage lanes: spilled epoch payload = ring slices + the
    # owner determinant windows (replicas stay device-only); it crosses
    # d2h once and host→disk once.
    spill_payload = (ring_bytes + det_bytes) if spill else 0
    spill_d2h = spill_payload
    spill_disk = spill_payload
    # Fence-tail lanes — the per-epoch bytes the pipelined fence
    # (runtime/cluster.py run_epoch overlap mode) moves off the
    # critical path, itemized so the predicted hidden tail is
    # attributable. Seal: the audit digest d2h's the epoch's causal
    # surface (owner determinant windows + ring slices). Ledger: one
    # JSON line with a fixed header plus one fingerprint per channel
    # (owner logs + rings), ~64 bytes each as serialized. Snapshot: the
    # lean fence offsets (per-log heads + per-ring heads + record
    # counts, int64-scale per lane) — operator state is job-dependent
    # and priced by the data lane, not here.
    fence_seal = det_bytes + ring_bytes
    fence_ledger = 64 * (1 + subtasks + ring_vertices)
    fence_snapshot = 8 * (2 * subtasks + ring_vertices)
    ft_bytes = (det_bytes + replica_bytes + ring_bytes
                + spill_d2h + spill_disk)
    total = ft_bytes + data_bytes
    return {
        "calls_per_step": dets * subtasks,
        "determinant_rows_per_epoch": det_rows,
        "determinant_bytes_per_epoch": det_bytes,
        "replica_bytes_per_epoch": replica_bytes,
        "ring_bytes_per_epoch": ring_bytes,
        "wire_bytes_per_epoch": wire_bytes,
        "data_bytes_per_epoch": data_bytes,
        "spill_d2h_bytes_per_epoch": spill_d2h,
        "spill_disk_bytes_per_epoch": spill_disk,
        "fence_seal_bytes_per_epoch": fence_seal,
        "fence_ledger_bytes_per_epoch": fence_ledger,
        "fence_snapshot_bytes_per_epoch": fence_snapshot,
        "ft_fraction_static": (round(ft_bytes / total, 6)
                               if total else 0.0),
    }
