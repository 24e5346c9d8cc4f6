"""Rule family 1: nondeterminism escapes.

The causal-services contract (causal/services.py, PAPER.md's
``getTimeService()`` wrappers): wall clocks, RNG draws, and entropy
reads in anything reachable from operator/source/sink/timer code must
be routed through a causal service so the value is logged as a
determinant and replays bit-identically. A direct ``time.time()`` or
``os.urandom()`` produces a value the determinant log never sees —
exactly the bug class an unlogged salt plants and the runtime audit
catches as a ``recovery.audit.divergence``; these rules catch it at
review time instead, naming the line.

torch draws count too: ``torch.rand``/``randn``/``randint``/``randperm``
/``normal``/``bernoulli``/``multinomial`` without ``generator=`` draw
from the process-global generator, and a ``torch.Generator()`` nobody
seeds with ``manual_seed`` starts from a fixed default that no log
records. The port's rule is explicit, seeded generators.

Legitimate wall reads exist (lease clocks in runtime/leader.py, span
timestamps in obs/trace.py — observability metadata, never replayed
data); those carry ``# clonos: allow(<rule>)`` waivers with a one-line
justification rather than being silently exempt.
"""

from __future__ import annotations

import ast
import copy
from typing import List, Set

from clonos_tpu_torch.lint.core import (FileContext, Finding, Rule,
                                        register_rule)

#: wall-clock reads — comparable across processes, different on replay.
WALLCLOCK = {
    "time.time", "time.time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

#: process-seeded / global RNG draws (a seeded
#: ``np.random.RandomState(seed)`` is deterministic and NOT flagged).
RNG_FNS = {
    "random.random", "random.randint", "random.randrange",
    "random.choice", "random.choices", "random.shuffle",
    "random.sample", "random.uniform", "random.getrandbits",
    "random.gauss", "random.normalvariate", "random.betavariate",
    "random.expovariate", "random.triangular",
}
NP_RANDOM_DRAWS = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "bytes", "exponential", "poisson",
}
#: RNG constructors that are only deterministic when explicitly seeded.
SEEDABLE_CTORS = {
    "random.Random", "numpy.random.RandomState",
    "numpy.random.default_rng",
}

#: torch draws that use the process-global generator unless the call
#: passes ``generator=``.
TORCH_GLOBAL_DRAWS = {
    f"torch.{f}" for f in ("rand", "randn", "randint", "randperm",
                           "normal", "bernoulli", "multinomial")
}

#: torch's generator: deterministic only once ``manual_seed`` is called.
TORCH_GENERATOR = "torch.Generator"

#: pure entropy: different every process, by design.
ENTROPY = {
    "os.urandom",
    "uuid.uuid1", "uuid.uuid3", "uuid.uuid4", "uuid.uuid5",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.randbelow", "secrets.choice",
}

#: process identity: stable within one process, different on every
#: restart — anything derived from it diverges on recovery exactly like
#: entropy does (a pid-salted key is the audit_nondet SALT bug in
#: disguise).
PROCESS_IDENTITY = {
    "os.getpid", "os.getppid",
}


class _ResolvedRefRule(Rule):
    """Shared walk: flag every Name/Attribute whose canonical dotted
    name lands in the rule's match set — references count, not just
    calls (``clock=time.time`` stashes the wall clock just as surely as
    calling it)."""

    matches: Set[str] = set()

    def message(self, dotted: str) -> str:
        raise NotImplementedError

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        seen = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            dotted = ctx.resolve(node)
            if dotted is None or dotted not in self.matches:
                continue
            key = (node.lineno, dotted)
            # one finding per (line, symbol): `time.time` is both an
            # Attribute and, on the call path, the func of a Call.
            if key in seen:
                continue
            seen.add(key)
            out.append(self.finding(ctx, node.lineno,
                                    self.message(dotted)))
        return out


@register_rule
class WallclockRule(_ResolvedRefRule):
    name = "wallclock"
    description = ("direct wall-clock read (time.time / datetime.now) "
                   "outside the causal time service")
    matches = WALLCLOCK

    def message(self, dotted: str) -> str:
        return (f"direct wall-clock read `{dotted}` bypasses the causal "
                f"time service — replay sees a different value; use "
                f"ctx.time / CausalTimeService.current_time_millis(), "
                f"or waive with a justification if the value is never "
                f"replayed data")


@register_rule
class RngRule(_ResolvedRefRule):
    name = "rng"
    description = ("global/unseeded RNG draw outside the causal random "
                   "service")
    matches = RNG_FNS | {f"numpy.random.{f}" for f in NP_RANDOM_DRAWS}

    def message(self, dotted: str) -> str:
        return (f"global RNG draw `{dotted}` is not logged as a "
                f"determinant — replay re-draws a different value; use "
                f"ctx.rng_bits / CausalRandomService.next_int(), or a "
                f"seeded np.random.RandomState carried in state")

    def check(self, ctx: FileContext) -> List[Finding]:
        out = super().check(ctx)
        seeded = _manual_seeded(ctx)
        # Unseeded constructor calls: `np.random.RandomState()` seeds
        # from OS entropy; with an explicit seed it is deterministic.
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.resolve(node.func)
            if dotted in SEEDABLE_CTORS and not node.args \
                    and not node.keywords:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"`{dotted}()` without a seed draws its state from "
                    f"OS entropy — pass an explicit seed so replay "
                    f"reconstructs the same stream"))
            elif dotted in TORCH_GLOBAL_DRAWS and not any(
                    k.arg == "generator" for k in node.keywords):
                out.append(self.finding(
                    ctx, node.lineno,
                    f"`{dotted}` without `generator=` draws from torch's "
                    f"process-global generator — replay re-draws a "
                    f"different value; pass a seeded torch.Generator"))
            elif dotted == TORCH_GENERATOR and id(node) not in seeded:
                out.append(self.finding(
                    ctx, node.lineno,
                    "`torch.Generator()` is never given `manual_seed` "
                    "— seed it explicitly so replay reconstructs the "
                    "same stream"))
        return out


def _manual_seeded(ctx: FileContext) -> Set[int]:
    """ids of ``torch.Generator(...)`` calls that get ``manual_seed``:
    chained (``torch.Generator(d).manual_seed(s)``) or through the name
    or attribute they are assigned to (``g = torch.Generator(d)`` then
    ``g.manual_seed(s)`` anywhere in the file)."""
    seeded_targets = set()
    out: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "manual_seed":
            recv = node.func.value
            if isinstance(recv, ast.Call):
                out.add(id(recv))
            else:
                seeded_targets.add(ast.dump(recv))
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Call):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(ast.dump(_as_load(t)) in seeded_targets
                   for t in targets):
                out.add(id(node.value))
    return out


def _as_load(node: ast.AST) -> ast.AST:
    """``node`` with Load contexts, so an assignment target compares
    equal to the same expression read back."""
    node = copy.deepcopy(node)
    for sub in ast.walk(node):
        if hasattr(sub, "ctx"):
            sub.ctx = ast.Load()
    return node


@register_rule
class EntropyRule(_ResolvedRefRule):
    name = "entropy"
    description = ("os.urandom / uuid / secrets / os.getpid read "
                   "(fresh per process)")
    matches = ENTROPY | PROCESS_IDENTITY

    def message(self, dotted: str) -> str:
        if dotted in PROCESS_IDENTITY:
            return (f"`{dotted}` changes on every restart — a value "
                    f"derived from the process id diverges on recovery "
                    f"just like entropy; key on logged job/subtask "
                    f"identity instead, or waive with a justification "
                    f"if the value is never replayed data")
        return (f"`{dotted}` is fresh entropy every process — a "
                f"restarted worker computes different values from the "
                f"same replayed inputs (the audit_nondet SALT bug); "
                f"route it through a causal service or derive it from "
                f"logged determinants")


@register_rule
class UnorderedIterRule(Rule):
    name = "unordered-iter"
    description = ("iteration over a set feeding ordered output "
                   "(serialization paths must be order-stable)")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        iters: List[ast.AST] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
        for it in iters:
            if self._is_set_expr(ctx, it):
                out.append(self.finding(
                    ctx, it.lineno,
                    "iterating a set is unordered across processes — "
                    "serialized output (causal/serde.py frames, wire "
                    "headers, digests) built from it diverges on "
                    "replay; wrap in sorted(...)"))
        return out

    @staticmethod
    def _is_set_expr(ctx: FileContext, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            dotted = ctx.resolve(node.func)
            return dotted in {"set", "frozenset"}
        return False
