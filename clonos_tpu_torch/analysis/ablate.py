"""Ablation generator: the semantics-preserving no-FT twin.

The census says what fault tolerance *should* cost; this module makes
the cost measurable. It rewrites the executor module's AST so every
fault-tolerance lane becomes the identity on its storage argument —
``clog.v_append_full(carry.logs, rows)`` -> ``carry.logs``,
``ifl.append_block(ring, out)`` -> ``ring``, and likewise the epoch
fence's start/truncate/replica-sync — then compiles the transformed
source as a twin module. The twin's ``LocalExecutor`` runs the same
block program minus FT: operators, routing, and the record data path
are untouched, so under ``logical_time=True`` with a fixed seed the
twin's sink outputs, record counts, and operator states are
bit-identical to the real executor's — only logs/rings/replicas stay
empty. ``chip_smoke.py``'s ablation phase times the two head-to-head;
the wall delta IS the measured ft-fraction.

What the identity means for each lane in the port:

- ``causal.log.v_append_full`` returns a new log state (it clones the
  whole log every block); the twin keeps the old one, so the clone and
  the append are both gone.
- ``inflight.log.append_block`` writes the ring IN PLACE
  (inflight/log.py) and returns it; replacing the call with its first
  argument leaves the ring untouched, which is the intent: no ring
  write happens at all.
- The port runs eagerly, so nothing eliminates the determinant rows the
  block still builds (``CompiledJob._det_rows``) and no longer appends:
  the twin pays for building them, and the measured fraction covers
  the appends, the ring writes and the epoch-fence maintenance only.

Why the twin stays *semantics-preserving*: the causal inputs
(times/rng_bits) still flow to operators, they are just no longer
*logged*. That substitution is only sound when those inputs are pure
functions of (job, seed, step index) — the ``LogicalTimeSource`` +
seeded-RNG regime. A module whose record values depend on unlogged
process entropy (an unlogged ``os.urandom`` salt) has no no-FT twin: replacing its FT would change its outputs, so
:func:`check_ablatable` *refuses* — the refusal is load-bearing and
tested, not a missing feature.
"""

from __future__ import annotations

import ast
import dataclasses
import types
from typing import Dict, List, Optional, Sequence, Tuple

from clonos_tpu_torch.lint.core import FileContext

#: calls replaced by their first argument (identity on the storage
#: tree): the per-step append lanes and the epoch-fence log maintenance.
FT_IDENTITY_CALLS = {
    "clonos_tpu_torch.causal.log.v_append_full",
    "clonos_tpu_torch.causal.log.v_start_epoch",
    "clonos_tpu_torch.causal.log.v_truncate",
    "clonos_tpu_torch.inflight.log.append_block",
    "clonos_tpu_torch.inflight.log.start_epoch",
    "clonos_tpu_torch.inflight.log.truncate",
    "clonos_tpu_torch.causal.replication.sync_replica_epochs",
}

#: rules whose unwaived findings make a module un-ablatable: its
#: outputs depend on values the determinant log was the only witness of.
NONDET_RULES = ("wallclock", "rng", "entropy")


class AblationRefused(RuntimeError):
    """The target's nondeterminism is load-bearing — a no-FT twin would
    not be semantics-preserving. Carries the findings that prove it."""

    def __init__(self, findings):
        self.findings = list(findings)
        locs = "; ".join(
            f"{f.location()} [{f.rule}] {f.message.split(chr(10))[0]}"
            for f in self.findings[:4])
        super().__init__(
            f"refusing to generate a no-FT ablation twin: "
            f"{len(self.findings)} unlogged-nondeterminism finding(s) "
            f"make its outputs depend on values only the determinant "
            f"log captures — stripping FT would change results, not "
            f"just cost. {locs}")


@dataclasses.dataclass
class AblationReport:
    """What the transform actually stripped (auditable, and asserted
    non-trivial by the tests: an ablation that strips nothing measures
    nothing)."""

    source_path: str
    stripped: List[Tuple[int, str]]     # (line, canonical callee)

    def to_dict(self) -> dict:
        return {
            "source_path": self.source_path,
            "stripped_sites": len(self.stripped),
            "stripped": [{"line": l, "callee": c}
                         for l, c in self.stripped],
        }


class _StripFT(ast.NodeTransformer):
    """Replace FT-lane calls with their first argument."""

    def __init__(self, ctx: FileContext):
        self._ctx = ctx
        self.stripped: List[Tuple[int, str]] = []

    def visit_Call(self, node: ast.Call):
        node = self.generic_visit(node)
        dotted = self._ctx.resolve(node.func)
        if dotted in FT_IDENTITY_CALLS and node.args:
            self.stripped.append((node.lineno, dotted))
            return node.args[0]
        return node


def check_ablatable(paths: Sequence[str],
                    use_waivers: bool = True) -> None:
    """Raise :class:`AblationRefused` if any target module has unwaived
    nondeterminism-escape findings (waived nondet is observability
    metadata by the waiver's own justification — it never feeds record
    values, so the twin stays equivalent)."""
    from clonos_tpu_torch.lint.runner import run_lint
    result = run_lint(list(paths), use_waivers=use_waivers,
                      rules=list(NONDET_RULES))
    bad = [f for f in result.errors if f.rule in NONDET_RULES]
    if bad:
        raise AblationRefused(bad)


def transform_source(path: str, source: str
                     ) -> Tuple[ast.Module, AblationReport]:
    """Parse + strip one module's source; returns (tree, report)."""
    ctx = FileContext(path, source)
    stripper = _StripFT(ctx)
    tree = stripper.visit(ctx.tree)
    ast.fix_missing_locations(tree)
    return tree, AblationReport(source_path=path,
                                stripped=sorted(stripper.stripped))


_cached: Optional[Tuple[types.ModuleType, AblationReport]] = None


def ablated_executor(refresh: bool = False
                     ) -> Tuple[types.ModuleType, AblationReport]:
    """The no-FT twin of ``clonos_tpu_torch.runtime.executor`` as a live
    module (compiled from the transformed AST; cached per process).

    Refuses first: the executor and the operator library must
    themselves be free of unwaived nondeterminism, or the twin's
    "bit-identical outputs" premise is void.
    """
    global _cached
    if _cached is not None and not refresh:
        return _cached
    import clonos_tpu_torch.runtime.executor as _ex

    src_path = _ex.__file__
    if src_path.endswith((".pyc", ".pyo")):       # pragma: no cover
        src_path = src_path[:-1]
    check_ablatable([src_path,
                     _module_path("clonos_tpu_torch.api.operators")])
    with open(src_path) as f:
        source = f.read()
    tree, report = transform_source(src_path, source)
    if not report.stripped:
        raise RuntimeError(
            "ablation transform stripped zero FT call sites in "
            f"{src_path} — the executor's FT lanes moved; update "
            "analysis/ablate.py FT_IDENTITY_CALLS")
    mod = types.ModuleType("clonos_tpu_torch.runtime.executor_noft")
    mod.__file__ = src_path + "<no-ft twin>"
    mod.__dict__["__builtins__"] = __builtins__
    # dataclass/typing machinery resolves classes through
    # sys.modules[cls.__module__]; the twin must be importable by name.
    import sys
    sys.modules[mod.__name__] = mod
    exec(compile(tree, src_path, "exec"), mod.__dict__)
    _cached = (mod, report)
    return _cached


def _module_path(modname: str) -> str:
    import importlib
    m = importlib.import_module(modname)
    p = m.__file__
    return p[:-1] if p.endswith((".pyc", ".pyo")) else p
