"""Whole-program static analysis: the lint grown into a cost model.

``python -m clonos_tpu_torch analyze [paths...]`` — passes over one
parsed file set, sharing the lint's registry/waiver/CLI conventions
(clonos_tpu_torch/lint/):

- ``callgraph``  — interprocedural call graph (attribute chains,
  import aliases, instance-attribute type inference).
- ``runner``     — nondet-escape propagation to step-function entry
  points (``nondet-reach``) + the census, with waivers and the
  ``--report json`` / exit-0/1 CI contract.
- ``lockorder``  — whole-repo lock acquisition-order graph; cycles are
  ERROR findings (``lock-order``).
- ``threads``    — thread-root inventory: every ``threading.Thread``
  spawn site resolved through the call graph to its entry function,
  daemon flag, and start/join sites; fingerprinted for the
  ``clonos_tpu_torch/.clonos-threads`` pin.
- ``races``      — lockset ∩ happens-before race detection over the
  inventory (``thread-race``, ``join-discipline``), with pre-start /
  join / queue-handoff / publish discharge edges and a seeded-bug
  registry proving each rule bites.
- ``census``     — FT call-site census folded with serde encoding
  widths into a static bytes-per-epoch cost model; its blake2b
  fingerprint is recorded in soak verdicts and incident bundles and
  pinned in ``clonos_tpu_torch/.clonos-census``.
- ``ablate``     — the no-FT ablation twin, run head-to-head against
  the real executor to *measure* the ft-fraction the static model
  predicts.

The package imports the standard library only. The census reads the
port's wire widths from ``clonos_tpu_torch.causal`` (numpy) when it
runs, and the ablation twin execs the port's executor (torch) only when
it is asked for.

Importing this package registers the analysis rules (``nondet-reach``,
``lock-order``, ``thread-race``, ``join-discipline``) in the shared
lint registry so waivers naming them validate.
"""

from clonos_tpu_torch.analysis.ablate import (AblationRefused,
                                              AblationReport,
                                              ablated_executor,
                                              check_ablatable)
from clonos_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                 STEP_ENTRY_NAMES)
from clonos_tpu_torch.analysis.census import (build_census,
                                              census_fingerprint,
                                              fingerprint,
                                              static_cost_model)
from clonos_tpu_torch.analysis.lockorder import (LOCK_BALANCE, LOCK_ORDER,
                                                 LockOrderGraph)
from clonos_tpu_torch.analysis.races import (JOIN_DISCIPLINE, SEEDED_BUGS,
                                             THREAD_RACE, RaceAnalysis,
                                             run_races, seeded_findings)
from clonos_tpu_torch.analysis.runner import (ANALYSIS_RULES, NONDET_REACH,
                                              AnalysisResult, format_json,
                                              format_text, run_analysis)
from clonos_tpu_torch.analysis.threads import (ThreadInventory, ThreadRoot,
                                               threads_fingerprint)

__all__ = [
    "AblationRefused", "AblationReport", "ablated_executor",
    "check_ablatable",
    "CallGraph", "FunctionInfo", "STEP_ENTRY_NAMES",
    "build_census", "census_fingerprint", "fingerprint",
    "static_cost_model",
    "LOCK_BALANCE", "LOCK_ORDER", "LockOrderGraph",
    "JOIN_DISCIPLINE", "SEEDED_BUGS", "THREAD_RACE", "RaceAnalysis",
    "run_races", "seeded_findings",
    "ANALYSIS_RULES", "NONDET_REACH", "AnalysisResult",
    "format_json", "format_text", "run_analysis",
    "ThreadInventory", "ThreadRoot", "threads_fingerprint",
]
