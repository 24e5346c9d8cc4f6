"""Chaos schedule DSL: a seeded, replayable fault timetable (port of
``clonos_tpu/soak/chaos.py``; numpy only, the same schedule text for
the same seed).

The schedule is pure data — WHAT to break and WHEN, decoupled from HOW
(the :class:`soak.driver.SoakHarness` applies events to a live
cluster). That split is what makes runs replayable: the same schedule
text (or the same ``seed``) produces the identical fault sequence, so a
soak that tripped the audit can be re-run bit-for-bit.

Grammar (one event per line or ``;``-separated; ``#`` comments)::

    at 5s kill 1,9,17                 # cascading SIGKILL: flat subtasks
    at 12s gray 2 delay=50ms for 3s   # slow-worker gray failure
    at 20s leader-loss hold=1s        # rival claims the lease for 1s
    at 30s stall delay=200ms for 2s   # checkpoint-storage + spill-
                                      # segment write stall
    at 35s backlog for 4s             # suppress checkpoint completion:
                                      # replay backlog grows past the
                                      # device ring into the spill tiers
    at 40s nondet                     # unlogged value perturbation
                                      # (audit bait — MUST fail the run)
    at 45s replica-kill 1             # kill serve replica 1: reads must
                                      # re-route to the owner, no errors
    at 50s rescale 4                  # live re-cut: keyed vertices to
                                      # parallelism 4 at the next fence
    at 55s load-spike 4x for 3s       # offered-rate multiplier over a
                                      # window — the autoscaler's cue

Durations accept ``ms``/``s`` suffixes (bare numbers are seconds).
``ChaosSchedule.seeded`` generates a schedule from a seed via a seeded
``np.random.RandomState`` — deterministic by construction, covering
every requested fault kind at least once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: every fault kind the harness knows how to apply. ``nondet`` is the
#: audit bait: an unlogged perturbation that every structural check
#: passes and only the epoch-digest diff catches. ``backlog`` starves
#: checkpoint completion so truncation stops and the replay backlog
#: spills past the device ring into the host/disk tiers
#: (storage/tiered.py) — the long-backlog disk-replay scenario.
#: ``replica-kill`` targets the READ tier, not the job: a serve replica
#: (runtime/serve.py) drops dead mid-run; the router must re-route its
#: key groups to the owner with zero client-visible errors, and the
#: replica revives (staleness spike, then recovery) at the next seal.
#: Optional target = replica index (defaults to replica 0).
#: ``rescale`` re-cuts the JOB under live traffic: at the next
#: completed checkpoint fence the keyed vertices re-partition to the
#: target parallelism (``ClusterRunner.rescale_live``) — exactly-once
#: must hold across the handoff and the read tier re-homes. Target =
#: the new keyed parallelism (exactly one positive integer).
#: ``load-spike`` is not a fault at all but a LOAD event: the offered
#: rate multiplies by ``factor`` for ``duration_s`` — the token bucket
#: paces chunks closer together while record CONTENTS stay identical
#: (logical time), so the fault-free control twin sees the exact same
#: spike and the byte-exact audit diff keeps gating. It is the cue the
#: autoscaler (clonos_tpu_torch/autoscale/) is designed to answer.
FAULT_KINDS = ("kill", "gray", "leader-loss", "stall", "nondet",
               "backlog", "replica-kill", "rescale", "load-spike")


def _dur(tok: str) -> float:
    """Parse a duration token: ``200ms`` / ``1.5s`` / ``3`` (seconds)."""
    tok = tok.strip()
    try:
        if tok.endswith("ms"):
            return float(tok[:-2]) / 1e3
        if tok.endswith("s"):
            return float(tok[:-1])
        return float(tok)
    except ValueError:
        raise ValueError(f"bad duration {tok!r} (want e.g. 200ms, 1.5s)")


def _fmt_dur(s: float) -> str:
    if s < 1.0:
        return f"{s * 1e3:g}ms"
    return f"{s:g}s"


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One fault at one instant of the soak clock (seconds from the
    start of the paced phase)."""

    at_s: float
    kind: str
    #: flat subtask ids (kill: the cascade; gray: the slow worker)
    targets: Tuple[int, ...] = ()
    #: gray: injected heartbeat/transport delay; stall: per-write delay
    delay_s: float = 0.0
    #: gray/stall: how long the degradation stays active
    duration_s: float = 0.0
    #: leader-loss: how long the rival holds the stolen lease
    hold_s: float = 0.0
    #: load-spike: offered-rate multiplier over the window
    factor: float = 0.0

    def to_text(self) -> str:
        parts = [f"at {_fmt_dur(self.at_s)}", self.kind]
        if self.targets:
            parts.append(",".join(str(t) for t in self.targets))
        if self.kind == "load-spike":
            parts.append(f"{self.factor:g}x")
        if self.kind in ("gray", "stall"):
            parts.append(f"delay={_fmt_dur(self.delay_s)}")
            parts.append(f"for {_fmt_dur(self.duration_s)}")
        if self.kind in ("backlog", "load-spike"):
            parts.append(f"for {_fmt_dur(self.duration_s)}")
        if self.kind == "leader-loss" and self.hold_s:
            parts.append(f"hold={_fmt_dur(self.hold_s)}")
        return " ".join(parts)


def _parse_event(line: str) -> ChaosEvent:
    toks = line.split()
    if len(toks) < 3 or toks[0] != "at":
        raise ValueError(f"chaos event {line!r}: want 'at <time> <kind> "
                         f"[args]'")
    at_s = _dur(toks[1])
    kind = toks[2]
    if kind not in FAULT_KINDS:
        raise ValueError(f"chaos event {line!r}: unknown kind {kind!r} "
                         f"(one of {', '.join(FAULT_KINDS)})")
    targets: Tuple[int, ...] = ()
    delay_s = 0.0
    duration_s = 0.0
    hold_s = 0.0
    factor = 0.0
    i = 3
    if kind == "load-spike":
        if i >= len(toks):
            raise ValueError(f"chaos event {line!r}: load-spike needs "
                             f"a rate multiplier (e.g. 4x)")
        tok = toks[i]
        try:
            factor = float(tok[:-1] if tok.endswith("x") else tok)
        except ValueError:
            raise ValueError(f"chaos event {line!r}: bad multiplier "
                             f"{tok!r} (want e.g. 4x)")
        if factor <= 0:
            raise ValueError(f"chaos event {line!r}: multiplier must "
                             f"be positive")
        i += 1
    elif kind == "rescale":
        if i >= len(toks):
            raise ValueError(f"chaos event {line!r}: rescale needs the "
                             f"new keyed parallelism")
        try:
            targets = (int(toks[i]),)
        except ValueError:
            raise ValueError(f"chaos event {line!r}: bad parallelism "
                             f"{toks[i]!r}")
        if targets[0] < 1:
            raise ValueError(f"chaos event {line!r}: parallelism must "
                             f"be positive")
        i += 1
    elif kind in ("kill", "gray"):
        if i >= len(toks):
            raise ValueError(f"chaos event {line!r}: {kind} needs "
                             f"target subtask(s)")
        try:
            targets = tuple(int(t) for t in toks[i].split(",") if t)
        except ValueError:
            raise ValueError(f"chaos event {line!r}: bad targets "
                             f"{toks[i]!r}")
        if not targets:
            raise ValueError(f"chaos event {line!r}: empty target list")
        i += 1
    elif kind == "replica-kill" and i < len(toks) \
            and not toks[i].startswith(("delay=", "hold=")) \
            and toks[i] != "for":
        # optional replica index (defaults to replica 0 in the harness)
        try:
            targets = tuple(int(t) for t in toks[i].split(",") if t)
        except ValueError:
            raise ValueError(f"chaos event {line!r}: bad replica index "
                             f"{toks[i]!r}")
        i += 1
    while i < len(toks):
        tok = toks[i]
        if tok.startswith("delay="):
            delay_s = _dur(tok[len("delay="):])
        elif tok.startswith("hold="):
            hold_s = _dur(tok[len("hold="):])
        elif tok == "for":
            i += 1
            if i >= len(toks):
                raise ValueError(f"chaos event {line!r}: 'for' needs a "
                                 f"duration")
            duration_s = _dur(toks[i])
        else:
            raise ValueError(f"chaos event {line!r}: unexpected token "
                             f"{tok!r}")
        i += 1
    if kind in ("gray", "stall") and (delay_s <= 0 or duration_s <= 0):
        raise ValueError(f"chaos event {line!r}: {kind} needs "
                         f"delay=<d> for <d>")
    if kind in ("backlog", "load-spike") and duration_s <= 0:
        raise ValueError(f"chaos event {line!r}: {kind} needs "
                         f"for <duration>")
    if kind == "gray" and len(targets) != 1:
        raise ValueError(f"chaos event {line!r}: gray takes exactly one "
                         f"target")
    return ChaosEvent(at_s=at_s, kind=kind, targets=targets,
                      delay_s=delay_s, duration_s=duration_s,
                      hold_s=hold_s, factor=factor)


def event_from_dict(d: dict) -> ChaosEvent:
    """Build an event from its dict form (the verify counterexample
    trace records' ``chaos`` field; inverse of the bridge's record
    writer)."""
    kind = d.get("kind")
    if kind not in FAULT_KINDS:
        raise ValueError(f"chaos record {d!r}: unknown kind {kind!r}")
    return ChaosEvent(
        at_s=float(d.get("at_s", 0.0)), kind=kind,
        targets=tuple(int(t) for t in d.get("targets") or ()),
        delay_s=float(d.get("delay_s", 0.0)),
        duration_s=float(d.get("duration_s", 0.0)),
        hold_s=float(d.get("hold_s", 0.0)),
        factor=float(d.get("factor", 0.0)))


def read_trace_schedule(path: str) -> "ChaosSchedule":
    """Import a verify counterexample trace (JSONL, one record per
    model-trace step) as a schedule: the records whose ``chaos`` field
    is set are the steps with a live-fault analog. Tail-tolerant like
    every other append log (utils/jsonl.py)."""
    from clonos_tpu_torch.utils.jsonl import read_jsonl
    events = []
    for rec in read_jsonl(path, label=path):
        ev = rec.get("chaos") if isinstance(rec, dict) else None
        if ev:
            events.append(event_from_dict(ev))
    return ChaosSchedule(events)


def parse_schedule(text: str) -> "ChaosSchedule":
    """Parse DSL text into a schedule (events sorted by fire time)."""
    events = []
    for raw in text.replace(";", "\n").splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        events.append(_parse_event(line))
    return ChaosSchedule(events)


class ChaosSchedule:
    """An ordered fault timetable. Immutable once built; the driver
    keeps its own cursor, so one schedule can drive many runs."""

    def __init__(self, events: Sequence[ChaosEvent]):
        self.events: List[ChaosEvent] = sorted(events,
                                               key=lambda e: e.at_s)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChaosSchedule)
                and self.events == other.events)

    def kinds(self) -> List[str]:
        return [e.kind for e in self.events]

    def to_text(self) -> str:
        return "\n".join(e.to_text() for e in self.events)

    @classmethod
    def seeded(cls, seed: int, duration_s: float,
               targets: Sequence[int],
               kinds: Sequence[str] = ("kill", "gray", "leader-loss"),
               n_events: Optional[int] = None,
               cascade: int = 3) -> "ChaosSchedule":
        """Generate a replayable schedule: same ``seed`` (and the same
        other arguments) → the same fault sequence, byte for byte.

        Fire times land in the middle ``[0.2, 0.85] * duration_s`` band
        so the paced warm-in and the final seal/audit window stay
        fault-free. Every requested kind appears at least once
        (``n_events`` defaults to ``len(kinds)``); extra events draw
        kinds uniformly. Kill cascades pick ``cascade`` distinct flat
        subtasks from ``targets`` — the config4 "connected failures"
        pattern when the caller passes one subtask per vertex class.
        """
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        if not targets and any(k in ("kill", "gray") for k in kinds):
            raise ValueError("kill/gray faults need candidate targets")
        n = max(n_events or len(kinds), len(kinds))
        rng = np.random.RandomState(seed)
        times = np.sort(rng.uniform(0.2 * duration_s, 0.85 * duration_s,
                                    size=n))
        # Coverage first, then uniform draws — order shuffled so the
        # guaranteed instances are not always the earliest events.
        picked = list(kinds) + [kinds[int(rng.randint(len(kinds)))]
                                for _ in range(n - len(kinds))]
        rng.shuffle(picked)
        events = []
        for at_s, kind in zip(times, picked):
            # ms precision: to_text() must round-trip byte-for-byte
            at_s = round(float(at_s), 3)
            if kind == "kill":
                k = min(cascade, len(targets))
                tg = tuple(int(t) for t in sorted(
                    rng.choice(np.asarray(targets), size=k,
                               replace=False)))
                events.append(ChaosEvent(float(at_s), "kill", targets=tg))
            elif kind == "gray":
                tg = (int(np.asarray(targets)[
                    int(rng.randint(len(targets)))]),)
                events.append(ChaosEvent(
                    float(at_s), "gray", targets=tg,
                    delay_s=round(float(rng.uniform(0.02, 0.08)), 3),
                    duration_s=round(float(rng.uniform(2.0, 4.0)), 2)))
            elif kind == "leader-loss":
                events.append(ChaosEvent(
                    float(at_s), "leader-loss",
                    hold_s=round(float(rng.uniform(0.4, 0.9)), 2)))
            elif kind == "stall":
                events.append(ChaosEvent(
                    float(at_s), "stall",
                    delay_s=round(float(rng.uniform(0.1, 0.3)), 3),
                    duration_s=round(float(rng.uniform(1.0, 3.0)), 2)))
            elif kind == "backlog":
                events.append(ChaosEvent(
                    float(at_s), "backlog",
                    duration_s=round(float(rng.uniform(1.0, 3.0)), 2)))
            elif kind == "replica-kill":
                events.append(ChaosEvent(float(at_s), "replica-kill"))
            elif kind == "rescale":
                # N±k under live traffic: scale the keyed vertices up
                # or down; the harness picks the fence.
                events.append(ChaosEvent(
                    float(at_s), "rescale",
                    targets=(int((2, 4)[int(rng.randint(2))]),)))
            elif kind == "load-spike":
                events.append(ChaosEvent(
                    float(at_s), "load-spike",
                    factor=float((2.0, 4.0)[int(rng.randint(2))]),
                    duration_s=round(float(rng.uniform(1.0, 3.0)), 2)))
            else:                       # nondet
                events.append(ChaosEvent(float(at_s), "nondet"))
        return cls(events)
