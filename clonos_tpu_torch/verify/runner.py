"""Verify driver: the model checker's CI conventions (port of
``clonos_tpu/verify/runner.py``).

``run_verify`` explores every requested protocol model at one bound
(workers/epochs/faults × depth/state budget) and reports violations
with minimal counterexample traces, in the CI shape of the
reference's lint/analyze verbs: one-line ``--report json``, exit 0/1,
a ``--quick`` bound cheap enough to run before every test session.

Pure Python end to end (models and explorer import no torch) — the
conformance layer (verify/conformance.py), which drives the port's
REAL components and therefore imports the runtime, is opt-in via
``conformance=True``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from clonos_tpu_torch.verify.explorer import ExploreResult, explore
from clonos_tpu_torch.verify.models import BUGS, MODELS

#: the ``--quick`` session-gate bound: small enough to finish in well
#: under a second, big enough that every invariant is exercised on
#: thousands of states.
QUICK_BOUND = dict(workers=2, epochs=2, faults=1, depth=24,
                   max_states=20_000)


@dataclasses.dataclass
class VerifyResult:
    reports: List[ExploreResult]
    bound: Dict[str, int]
    quick: bool
    conformance: Optional[Dict] = None   # component -> report dict

    @property
    def violations(self) -> List:
        return [v for r in self.reports for v in r.violations]

    @property
    def ok(self) -> bool:
        if self.conformance is not None and any(
                not c["ok"] for c in self.conformance.values()):
            return False
        return all(r.ok for r in self.reports)

    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def to_dict(self) -> dict:
        out = {
            "ok": self.ok,
            "quick": self.quick,
            "bound": dict(self.bound),
            "models": [{
                "model": r.model,
                "states": r.states,
                "transitions": r.transitions,
                "depth": r.depth,
                "truncated": r.truncated,
                "violations": [v.to_dict() for v in r.violations],
            } for r in self.reports],
        }
        if self.conformance is not None:
            out["conformance"] = self.conformance
        return out


def run_verify(models: Optional[Sequence[str]] = None,
               workers: int = 2, epochs: int = 2, faults: int = 1,
               depth: int = 48, max_states: int = 200_000,
               quick: bool = False,
               bugs: Optional[Dict[str, str]] = None,
               conformance: bool = False,
               conformance_traces: int = 3) -> VerifyResult:
    """Check the requested models (default: all six) at one bound.

    ``quick`` swaps in :data:`QUICK_BOUND` wholesale. ``bugs`` maps a
    model name to a seeded defect from :data:`models.BUGS` — the
    checker is then EXPECTED to find a counterexample, and the result's
    exit code says whether it did (nonzero = found, the
    prove-the-invariants-bite mode)."""
    if quick:
        workers, epochs, faults = (QUICK_BOUND["workers"],
                                   QUICK_BOUND["epochs"],
                                   QUICK_BOUND["faults"])
        depth = QUICK_BOUND["depth"]
        max_states = QUICK_BOUND["max_states"]
    names = list(models or MODELS)
    bugs = dict(bugs or {})
    for name in names:
        if name not in MODELS:
            raise ValueError(f"unknown model {name!r} "
                             f"(one of {', '.join(sorted(MODELS))})")
    for name, bug in bugs.items():
        if name not in BUGS or bug not in BUGS[name]:
            raise ValueError(f"unknown seeded bug {name}:{bug}")
    reports = [explore(MODELS[name](workers=workers, epochs=epochs,
                                    faults=faults,
                                    bug=bugs.get(name)),
                       depth=depth, max_states=max_states)
               for name in names]
    conf = None
    if conformance:
        from clonos_tpu_torch.verify.conformance import run_conformance
        conf = {c: r.to_dict() for c, r in run_conformance(
            names, n_traces=conformance_traces, workers=workers,
            epochs=epochs, faults=faults).items()}
    return VerifyResult(reports=reports,
                        bound={"workers": workers, "epochs": epochs,
                               "faults": faults, "depth": depth,
                               "max_states": max_states},
                        quick=quick, conformance=conf)


def format_text(result: VerifyResult) -> str:
    lines: List[str] = []
    for r in result.reports:
        flag = " (truncated)" if r.truncated else ""
        lines.append(f"{r.model}: {r.states} state(s), "
                     f"{r.transitions} transition(s), depth {r.depth}"
                     f"{flag}, {len(r.violations)} violation(s)")
        for v in r.violations:
            lines.append(f"  {v.invariant} at depth {v.depth}: "
                         f"{v.detail}")
            for i, a in enumerate(v.trace):
                lines.append(f"    {i + 1}. {a.label()}")
    if result.conformance:
        for c, rep in sorted(result.conformance.items()):
            ok = "ok" if rep["ok"] else "DIVERGED"
            lines.append(f"conformance {c}: {rep['traces']} trace(s), "
                         f"{rep['steps']} step(s), {ok}")
            for d in rep["divergences"]:
                lines.append(
                    f"  trace {d['trace']} step {d['step']} "
                    f"({d['action']}): expected {d['expected']}, "
                    f"observed {d['observed']}")
    b = result.bound
    lines.append(
        f"verify: {len(result.reports)} model(s) at "
        f"workers={b['workers']} epochs={b['epochs']} "
        f"faults={b['faults']} depth={b['depth']}; "
        f"{sum(r.states for r in result.reports)} state(s), "
        f"{len(result.violations)} violation(s)"
        + ("" if result.ok else " — FAILED"))
    return "\n".join(lines)


def format_json(result: VerifyResult) -> str:
    """One machine-readable line (the lint/analyze CI convention)."""
    return json.dumps(result.to_dict(), sort_keys=True)
