"""Counterexample → chaos bridge: replay a model bug on the live
cluster (port of ``clonos_tpu/verify/bridge.py``).

A violating trace from the explorer is a sequence of protocol actions;
the subset with a live-fault analog (worker kills, lease expiry,
unlogged perturbations, storage stalls) carries a ``chaos`` hint naming
the fault-DSL event (soak/chaos.py) it corresponds to. This module compiles those
hints into a :class:`~clonos_tpu_torch.soak.chaos.ChaosSchedule`, so
the port's soak harness (``python -m clonos_tpu_torch soak --schedule``) re-injects the
model-level failure pattern against a real job — the audit ledger then
catches the same divergence the invariant caught in the model.

Two artifacts per counterexample, both replayable:

- ``.chaos`` — the schedule as DSL text (``parse_schedule`` input);
- ``.jsonl`` — one record per trace step (action label + the chaos
  event dict or null), tail-tolerant like every other append log, so
  ``soak.chaos.read_trace_schedule`` can import it directly.

Fire times are synthetic: hinted steps are spaced ``spacing_s`` apart
from ``start_s`` in trace order — the TEMPORAL shape of a model trace
is abstract, only the order matters, and the soak clock needs concrete
instants.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from clonos_tpu_torch.soak.chaos import ChaosEvent, ChaosSchedule
from clonos_tpu_torch.verify.explorer import Violation

#: ChaosEvent field defaults the hints may override
_EVENT_FIELDS = ("targets", "delay_s", "duration_s", "hold_s", "factor")


def event_for(action, at_s: float) -> Optional[ChaosEvent]:
    """The chaos event for one trace action, or None for pure protocol
    steps (acks, triggers, queue ops) with no live-fault analog."""
    if action.chaos is None:
        return None
    kind, overrides = action.chaos
    kw = {k: v for k, v in overrides if k in _EVENT_FIELDS}
    if "targets" in kw:
        kw["targets"] = tuple(int(t) for t in kw["targets"])
    return ChaosEvent(at_s=round(float(at_s), 3), kind=kind, **kw)


def compile_trace(violation: Violation, start_s: float = 0.5,
                  spacing_s: float = 1.0) -> ChaosSchedule:
    """Compile a violating trace's fault actions into a schedule."""
    events: List[ChaosEvent] = []
    at = start_s
    for action in violation.trace:
        ev = event_for(action, at)
        if ev is not None:
            events.append(ev)
            at += spacing_s
    return ChaosSchedule(events)


def trace_records(violation: Violation, start_s: float = 0.5,
                  spacing_s: float = 1.0) -> List[dict]:
    """One JSONL-able record per trace step, fault steps annotated
    with their compiled chaos event (the ``.jsonl`` artifact)."""
    out: List[dict] = []
    at = start_s
    for step, action in enumerate(violation.trace):
        ev = event_for(action, at)
        rec = {"model": violation.model, "step": step,
               "action": action.label(), "kind": action.kind,
               "args": list(action.args), "chaos": None}
        if ev is not None:
            rec["chaos"] = {"at_s": ev.at_s, "kind": ev.kind,
                            "targets": list(ev.targets),
                            "delay_s": ev.delay_s,
                            "duration_s": ev.duration_s,
                            "hold_s": ev.hold_s,
                            "factor": ev.factor}
            at += spacing_s
        out.append(rec)
    return out


def write_counterexample(dirpath: str, violation: Violation,
                         start_s: float = 0.5,
                         spacing_s: float = 1.0) -> dict:
    """Persist both artifacts; returns their paths and the schedule.

    File stem: ``counterexample-<model>-<invariant>`` (one pair per
    violated invariant — re-running overwrites, the trace is minimal
    and deterministic so that is idempotent)."""
    os.makedirs(dirpath, exist_ok=True)
    stem = os.path.join(
        dirpath,
        f"counterexample-{violation.model}-{violation.invariant}")
    schedule = compile_trace(violation, start_s, spacing_s)
    chaos_path = stem + ".chaos"
    with open(chaos_path, "w") as f:
        header = (f"# {violation.model}: {violation.invariant} — "
                  f"{len(violation.trace)}-step counterexample\n")
        f.write(header + schedule.to_text() + "\n")
    jsonl_path = stem + ".jsonl"
    with open(jsonl_path, "w") as f:
        for rec in trace_records(violation, start_s, spacing_s):
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return {"chaos": chaos_path, "trace": jsonl_path,
            "schedule": schedule}
