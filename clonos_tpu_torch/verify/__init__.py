"""Protocol model checker (port of ``clonos_tpu/verify/``): exhaustive exploration of the
checkpoint–recovery–fencing–admission protocols at small bounds, with
chaos-replayable counterexamples.

- explorer.py — BFS state-space search, minimal counterexample traces
- models.py — the six formal transition models (+ seeded bugs)
- bridge.py — counterexample → chaos-DSL schedule compiler
- conformance.py — replay model traces against the real components
- runner.py — CLI/CI driver (``python -m clonos_tpu_torch verify``)
"""

from clonos_tpu_torch.verify.explorer import (Action, ExploreResult,
                                              Model, Violation, explore,
                                              traces)
from clonos_tpu_torch.verify.models import BUGS, MODELS
from clonos_tpu_torch.verify.runner import (QUICK_BOUND, VerifyResult,
                                            format_json, format_text,
                                            run_verify)
from clonos_tpu_torch.verify.bridge import (compile_trace, event_for,
                                            trace_records,
                                            write_counterexample)

__all__ = [
    "Action", "ExploreResult", "Model", "Violation", "explore",
    "traces", "BUGS", "MODELS", "QUICK_BOUND", "VerifyResult",
    "format_json", "format_text", "run_verify", "compile_trace",
    "event_for", "trace_records", "write_counterexample",
]
