"""Explicit-state explorer: exhaustive BFS over a protocol model (port
of ``clonos_tpu/verify/explorer.py``).

TLA+-style bounded model checking, in-process: a :class:`Model` is a
transition system with hashable states; :func:`explore` enumerates
every state reachable within a depth/state budget, checks every safety
invariant on every reachable state, and checks bounded liveness on
every terminal (deadlock) state. Because the search is breadth-first,
the first trace reaching a violating state is a MINIMAL counterexample
— no shrinking pass needed.

Interleaving reduction is by state merging: two action orders that
land in the same (canonicalized) state are explored once. Models with
symmetric components (interchangeable workers, contenders) can
canonicalize harder via :meth:`Model.canon`.

Everything here is pure Python and deterministic — no wall clock, no
RNG, no torch — so the ``--quick`` sweep runs on any host, card or
none.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

#: invariant check: state -> None (holds) or a violation detail string
Invariant = Tuple[str, Callable[[object], Optional[str]]]


@dataclasses.dataclass(frozen=True)
class Action:
    """One enabled protocol step. ``chaos`` optionally names the
    fault-DSL event (soak/chaos.py) this step corresponds to on a live cluster — the
    counterexample→chaos bridge compiles exactly those steps."""

    kind: str
    args: Tuple = ()
    #: chaos-DSL hint: (kind, field-overrides) or None for pure
    #: protocol steps with no live-fault analog
    chaos: Optional[Tuple[str, Tuple[Tuple[str, object], ...]]] = None

    def label(self) -> str:
        if not self.args:
            return self.kind
        return f"{self.kind}({', '.join(str(a) for a in self.args)})"


class Model:
    """A finite protocol transition system. States must be hashable
    and treated as immutable; ``apply`` returns a NEW state."""

    name = "?"

    def initial_state(self):
        raise NotImplementedError

    def enabled(self, state) -> List[Action]:
        """Every action enabled in ``state`` (deterministic order)."""
        raise NotImplementedError

    def apply(self, state, action: Action):
        raise NotImplementedError

    def invariants(self) -> List[Invariant]:
        """Safety: checked on every reachable state."""
        return []

    def canon(self, state):
        """Symmetry reduction hook: map a state to its equivalence-
        class representative before dedup (default: identity)."""
        return state

    def settled(self, state) -> Optional[str]:
        """Bounded liveness: called on every TERMINAL state (no
        enabled actions). None = acceptable final state; a string =
        the protocol wedged (e.g. a recovery that never caught up)."""
        return None


@dataclasses.dataclass
class Violation:
    model: str
    invariant: str               # invariant name, or "liveness"
    detail: str
    trace: List[Action]          # minimal: BFS discovery order
    state: object
    depth: int

    def to_dict(self) -> dict:
        return {"model": self.model, "invariant": self.invariant,
                "detail": self.detail, "depth": self.depth,
                "trace": [a.label() for a in self.trace]}


@dataclasses.dataclass
class ExploreResult:
    model: str
    states: int                  # distinct states reached
    transitions: int             # edges taken (post-dedup source count)
    depth: int                   # deepest layer fully expanded
    truncated: bool              # hit the depth or state budget
    violations: List[Violation]

    @property
    def ok(self) -> bool:
        return not self.violations


def explore(model: Model, depth: int = 48, max_states: int = 200_000,
            stop_at_first: bool = True) -> ExploreResult:
    """Exhaustive BFS from the model's initial state.

    Invariants are checked on every state at discovery; liveness
    (``settled``) on every terminal state. When the depth or state
    budget truncates the frontier, ``truncated`` is set and liveness
    is NOT judged on cut-off states — an unexpanded state is not a
    deadlock.
    """
    init = model.initial_state()
    init_key = model.canon(init)
    #: canon-key -> (parent key, action, concrete state, depth)
    seen: Dict[object, Tuple[Optional[object], Optional[Action],
                             object, int]] = {
        init_key: (None, None, init, 0)}
    queue = collections.deque([init_key])
    invs = model.invariants()
    violations: List[Violation] = []
    transitions = 0
    max_depth = 0
    truncated = False

    def trace_to(key: object) -> List[Action]:
        out: List[Action] = []
        while True:
            parent, action, _state, _d = seen[key]
            if action is None:
                return list(reversed(out))
            out.append(action)
            key = parent

    def check(key: object, state, d: int) -> bool:
        """True if a violation was recorded for this state."""
        bad = False
        for name, fn in invs:
            detail = fn(state)
            if detail is not None:
                violations.append(Violation(
                    model=model.name, invariant=name, detail=detail,
                    trace=trace_to(key), state=state, depth=d))
                bad = True
        return bad

    if check(init_key, init, 0) and stop_at_first:
        return ExploreResult(model.name, 1, 0, 0, False, violations)

    while queue:
        key = queue.popleft()
        _parent, _action, state, d = seen[key]
        max_depth = max(max_depth, d)
        actions = model.enabled(state)
        if not actions:
            wedged = model.settled(state)
            if wedged is not None:
                violations.append(Violation(
                    model=model.name, invariant="liveness",
                    detail=wedged, trace=trace_to(key), state=state,
                    depth=d))
                if stop_at_first:
                    break
            continue
        if d >= depth:
            truncated = True
            continue
        stop = False
        for action in actions:
            nxt = model.apply(state, action)
            nkey = model.canon(nxt)
            transitions += 1
            if nkey in seen:
                continue
            if len(seen) >= max_states:
                truncated = True
                continue
            seen[nkey] = (key, action, nxt, d + 1)
            queue.append(nkey)
            if check(nkey, nxt, d + 1) and stop_at_first:
                stop = True
                break
        if stop:
            break

    return ExploreResult(model=model.name, states=len(seen),
                         transitions=transitions, depth=max_depth,
                         truncated=truncated, violations=violations)


def traces(model: Model, n: int, depth: int = 48,
           max_states: int = 200_000,
           admissible: Optional[Callable[[List[Action]], bool]] = None
           ) -> List[List[Action]]:
    """Up to ``n`` distinct model-generated traces for conformance
    replay: the BFS paths to terminal states (preferred — they exercise
    the full protocol round) then to the deepest interior states,
    filtered by the adapter's ``admissible`` predicate. Deterministic:
    same model, same arguments, same traces."""
    init = model.initial_state()
    init_key = model.canon(init)
    seen: Dict[object, Tuple[Optional[object], Optional[Action],
                             object, int]] = {
        init_key: (None, None, init, 0)}
    queue = collections.deque([init_key])
    terminal: List[Tuple[object, int]] = []
    interior: List[Tuple[object, int]] = []
    while queue:
        key = queue.popleft()
        _p, _a, state, d = seen[key]
        actions = model.enabled(state)
        if not actions:
            terminal.append((key, d))
            continue
        interior.append((key, d))
        if d >= depth:
            continue
        for action in actions:
            nxt = model.apply(state, action)
            nkey = model.canon(nxt)
            if nkey in seen or len(seen) >= max_states:
                continue
            seen[nkey] = (key, action, nxt, d + 1)
            queue.append(nkey)

    def path(key: object) -> List[Action]:
        out: List[Action] = []
        while True:
            parent, action, _s, _d = seen[key]
            if action is None:
                return list(reversed(out))
            out.append(action)
            key = parent

    out: List[List[Action]] = []
    seen_traces = set()
    for key, _d in (sorted(terminal, key=lambda t: -t[1])
                    + sorted(interior, key=lambda t: -t[1])):
        t = path(key)
        if not t:
            continue
        if admissible is not None and not admissible(t):
            continue
        sig = tuple(a.label() for a in t)
        if sig in seen_traces:
            continue
        seen_traces.add(sig)
        out.append(t)
        if len(out) >= n:
            break
    return out
