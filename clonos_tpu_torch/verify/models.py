"""Formal transition models of the six runtime protocols (port of
``clonos_tpu/verify/models.py``; the same states, the same transition
order, the same traces).

Each model mirrors ONE real component's protocol — the transitions the
implementation exposes to its driver — at the smallest state that
preserves the safety argument:

- :class:`CheckpointModel` — runtime/checkpoint.py's coordinator as
  driven by the cluster runner: trigger → (async) durable write →
  per-worker acks at the closing fence → completion → log truncation,
  with worker kills, failure detection (``ignore_unacked_for``) and
  the driver's ``discard_pending_through`` sweep of superseded fences.
- :class:`RecoveryModel` — causal/recovery.py's per-subtask FSM:
  STANDBY → WAITING_CONNECTIONS → WAITING_DETERMINANTS → REPLAYING →
  RUNNING, under every notification interleaving the driver permits.
- :class:`LeaseModel` — runtime/leader.py's claim-file election:
  epoch claims, lease expiry, rival takeover, and the receiver-side
  fencing check that makes a deposed leader's token worthless.
- :class:`AdmissionModel` — runtime/dispatcher.py's
  ``AdmissionController``: per-tenant quota charged on reservation
  (held + queued), strict-FIFO head-blocking queue, cancel/release.
- :class:`RepartitionModel` — the live re-cut protocol
  (runtime/cluster.py's ``rescale_live`` driven by the
  ``RescaleCoordinator``): at a completed checkpoint fence the old
  incarnation stops ingesting, drains each key group's in-flight edge
  records into its state, migrates the drained groups to the N±k
  incarnation, and only then redirects traffic — exactly once per
  record across the fence.
- :class:`ScalePolicyModel` — the autoscaler's decision protocol
  (autoscale/controller.py's ``AutoscaleController`` over the pure
  ``ScalePolicy``): per completed fence, fold the load signal into
  sustain streaks, decide under hysteresis + cooldown, LOG the
  decision as a SCALE determinant, then execute the re-cut only if
  the cluster is still healthy — under worker kills landing anywhere,
  including between decide and execute.

``bug=`` injects a named, intentional protocol defect (see ``BUGS``).
Each seeded bug reproduces a hazard the real protocol's discipline
exists to prevent; the checker must find a minimal counterexample for
every one of them (tests/test_torch_verify.py), which is the evidence the
invariants are not vacuous.

States are nested tuples/frozensets (hashable, immutable); every
transition is pure. No wall clock, no RNG, no torch.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from clonos_tpu_torch.verify.explorer import Action, Model

#: model name -> {bug name: what protocol discipline it removes}
BUGS: Dict[str, Dict[str, str]] = {
    "checkpoint": {
        "late-ack": "acks accepted for superseded fences (drops the "
                    "executors' ack-at-the-closing-fence discipline) — "
                    "a late completion regresses the truncation fence",
        "unlogged-write": "a worker may perturb its output without "
                          "logging a determinant — replay diverges "
                          "(the audit-bait nondet fault)",
    },
    "recovery": {
        "early-response": "determinant responses delivered before the "
                          "manager reaches WAITING_DETERMINANTS — the "
                          "real manager raises RecoveryError",
    },
    "lease": {
        "no-fencing-check": "receivers skip the fencing_valid claim "
                            "check — a deposed leader's stale token "
                            "is accepted alongside the rival's",
    },
    "admission": {
        "cancel-leaks-quota": "cancelling a queued job forgets to "
                              "release its reservation charge — the "
                              "tenant's quota leaks",
    },
    "repartition": {
        "migrate-skips-drain": "a key group may migrate while its "
                               "in-flight edge records are still "
                               "buffered — the leftovers die with the "
                               "old incarnation at redirect (records "
                               "lost)",
        "redirect-before-migrate": "traffic redirects before every "
                                   "group has migrated — unmigrated "
                                   "groups restart empty on the new "
                                   "incarnation (state and in-flight "
                                   "records lost)",
        "stale-writer": "the old incarnation keeps applying to a "
                        "group it already handed off — the new owner "
                        "replays the same records (duplicates)",
    },
    "scalepolicy": {
        "no-cooldown": "decisions skip the cooldown gate — a sustained "
                       "spike followed by its own backpressure dip "
                       "thrashes the cluster up-then-down inside one "
                       "cooldown window",
        "unlogged-decision": "a scale action executes without its "
                             "SCALE determinant — a recovered "
                             "controller cannot replay it and would "
                             "re-decide (double re-cut)",
        "rescale-mid-recovery": "execute skips the health re-check — a "
                                "worker kill landing between decide "
                                "and execute lets a re-cut run over an "
                                "in-progress recovery",
    },
}


def _check_bug(model: str, bug: Optional[str]) -> Optional[str]:
    if bug is not None and bug not in BUGS[model]:
        raise ValueError(f"unknown {model} bug {bug!r} "
                         f"(one of {', '.join(sorted(BUGS[model]))})")
    return bug


# --- checkpoint coordination ---------------------------------------------

#: per-cid status markers (cids tuple entries; pending carries payload)
_UNBORN = ("unborn",)
_IGNORED = ("ignored",)
_COMPLETE = ("complete",)


class CheckpointModel(Model):
    """Checkpoint coordination for one coordinator (one job/group).

    State::

        (cids, alive, undetected, truncated, hi_truncated,
         faults_left, unlogged)

    ``cids[i]`` is checkpoint id ``i+1``: ``("unborn",)``,
    ``("pending", missing, written)``, ``("ignored",)`` or
    ``("complete",)``. Completion is NOT a scheduled choice — exactly
    like ``_maybe_complete`` it fires deterministically the moment a
    pending checkpoint is durable with an empty missing set, ignoring
    superseded lower fences (the driver's ``discard_pending_through``
    at the completion fence) and truncating logs to its fence.

    Invariants:

    - **truncate-monotone** — the truncation fence never regresses
      (a regression re-truncates rings below already-released state).
    - **truncate-sealed** — logs are only ever truncated at a fence
      backed by a durable COMPLETED checkpoint (exactly-once: records
      below the fence are re-derivable from that checkpoint alone).
    - **exactly-once-logged** — no worker holds an unlogged
      perturbation (every replayed value has a determinant).
    """

    name = "checkpoint"

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        self.workers = int(workers)
        self.epochs = int(epochs)
        self.faults = int(faults)
        self.bug = _check_bug("checkpoint", bug)

    def initial_state(self):
        return ((_UNBORN,) * self.epochs,
                frozenset(range(self.workers)), frozenset(),
                0, 0, self.faults, frozenset())

    # dense encoding helpers
    @staticmethod
    def _pending(missing, written):
        return ("pending", missing, written)

    def enabled(self, state) -> List[Action]:
        cids, alive, undetected, _tr, _hi, faults_left, unlogged = state
        out: List[Action] = []
        triggered = sum(1 for c in cids if c != _UNBORN)
        newest = triggered  # cid number of the newest triggered fence
        if triggered < self.epochs:
            out.append(Action("trigger", (triggered + 1,)))
        for i, c in enumerate(cids):
            if c[0] != "pending":
                continue
            cid = i + 1
            _tag, missing, written = c
            if not written:
                out.append(Action("write", (cid,)))
            ack_ok = (cid == newest or self.bug == "late-ack")
            if ack_ok:
                for w in sorted(missing & alive):
                    out.append(Action("ack", (cid, w)))
            if cid < newest:
                # The driver's discard_pending_through sweep: a fence
                # superseded by a newer trigger may be abandoned.
                out.append(Action("discard", (cid,)))
        for w in sorted(alive):
            if faults_left > 0:
                out.append(Action(
                    "kill", (w,),
                    chaos=("kill", (("targets", (w,)),))))
            if self.bug == "unlogged-write" and w not in unlogged:
                out.append(Action("perturb", (w,),
                                  chaos=("nondet", ())))
        for w in sorted(undetected):
            out.append(Action("detect", (w,)))
        return out

    def apply(self, state, action: Action):
        cids, alive, undetected, tr, hi, faults_left, unlogged = state
        cids = list(cids)
        k, args = action.kind, action.args
        if k == "trigger":
            cid = args[0]
            cids[cid - 1] = self._pending(
                frozenset(range(self.workers)), False)
        elif k == "write":
            cid = args[0]
            _t, missing, _w = cids[cid - 1]
            cids[cid - 1] = self._pending(missing, True)
            cids, tr, hi = self._maybe_complete(cids, cid, tr, hi)
        elif k == "ack":
            cid, w = args
            _t, missing, written = cids[cid - 1]
            cids[cid - 1] = self._pending(missing - {w}, written)
            cids, tr, hi = self._maybe_complete(cids, cid, tr, hi)
        elif k == "discard":
            cids[args[0] - 1] = _IGNORED
        elif k == "kill":
            w = args[0]
            alive = alive - {w}
            undetected = undetected | {w}
            faults_left -= 1
        elif k == "detect":
            # ignore_unacked_for({w}) + (abstracted) instant redeploy:
            # the detailed standby path is RecoveryModel's subject.
            w = args[0]
            for i, c in enumerate(cids):
                if c[0] == "pending" and w in c[1]:
                    cids[i] = _IGNORED
            undetected = undetected - {w}
            alive = alive | {w}
        elif k == "perturb":
            unlogged = unlogged | {args[0]}
        else:
            raise ValueError(f"bad action {action}")
        return (tuple(cids), alive, undetected, tr, hi, faults_left,
                unlogged)

    def _maybe_complete(self, cids, cid, tr, hi):
        tag, missing, written = cids[cid - 1]
        if tag != "pending" or missing or not written:
            return cids, tr, hi
        cids[cid - 1] = _COMPLETE
        # Completion fence: superseded pendings are swept (the driver's
        # discard_pending_through) and logs truncate to this fence.
        # Bug late-ack drops BOTH halves of the fence discipline — the
        # sweep and the ack gate — so a superseded checkpoint can
        # complete late and regress the truncation fence.
        if self.bug != "late-ack":
            for i in range(cid - 1):
                if cids[i][0] == "pending":
                    cids[i] = _IGNORED
        return cids, cid, max(hi, cid)

    def invariants(self):
        def monotone(state):
            _c, _a, _u, tr, hi, _f, _ul = state
            if tr != hi:
                return (f"truncation fence regressed to {tr} after "
                        f"reaching {hi} — rings below {hi} were "
                        f"already released")
            return None

        def sealed(state):
            cids, _a, _u, tr, _hi, _f, _ul = state
            if tr and cids[tr - 1] != _COMPLETE:
                return (f"logs truncated at fence {tr} but checkpoint "
                        f"{tr} is {cids[tr - 1][0]}, not durable — "
                        f"records below the fence are unrecoverable")
            return None

        def logged(state):
            unlogged = state[6]
            if unlogged:
                return (f"worker(s) {sorted(unlogged)} hold an "
                        f"unlogged perturbation — replay of their "
                        f"block diverges from the delivered output "
                        f"(exactly-once broken)")
            return None

        return [("truncate-monotone", monotone),
                ("truncate-sealed", sealed),
                ("exactly-once-logged", logged)]

    def canon(self, state):
        """Workers are symmetric: relabel to the lexicographically
        smallest image over all worker permutations."""
        if self.workers > 3:
            return state
        cids, alive, undetected, tr, hi, fl, unlogged = state

        def encode(s):
            # Fully-sorted injective encoding: min() over it picks one
            # well-defined representative per equivalence class.
            ecids, ea, eu, etr, ehi, efl, eul = s
            return (tuple(c if c[0] != "pending" else
                          ("pending", tuple(sorted(c[1])), c[2])
                          for c in ecids),
                    tuple(sorted(ea)), tuple(sorted(eu)),
                    etr, ehi, efl, tuple(sorted(eul)))

        best = None
        for perm in itertools.permutations(range(self.workers)):
            m = {w: perm[w] for w in range(self.workers)}
            cand = (tuple(c if c[0] != "pending" else
                          ("pending", frozenset(m[w] for w in c[1]),
                           c[2]) for c in cids),
                    frozenset(m[w] for w in alive),
                    frozenset(m[w] for w in undetected),
                    tr, hi, fl,
                    frozenset(m[w] for w in unlogged))
            enc = encode(cand)
            if best is None or enc < best[0]:
                best = (enc, cand)
        return best[1]

    def settled(self, state) -> Optional[str]:
        cids = state[0]
        stuck = [i + 1 for i, c in enumerate(cids)
                 if c[0] in ("unborn", "pending")]
        if stuck:
            return (f"checkpoint(s) {stuck} never resolved "
                    f"(complete or ignored) — the protocol wedged")
        return None


# --- recovery FSM ---------------------------------------------------------

#: RecoveryState mirror (ints keep the state tuple tiny; names match
#: causal/recovery.py's enum so conformance compares by name)
FSM_NAMES = ("STANDBY", "WAITING_CONNECTIONS", "WAITING_DETERMINANTS",
             "REPLAYING", "RUNNING")
_STANDBY, _WAIT_CONN, _WAIT_DET, _REPLAYING, _RUNNING = range(5)


class RecoveryModel(Model):
    """One recovering subtask's FSM under every notification
    interleaving the cluster driver permits: restoration completion,
    input/output channel establishment and the expected-response count
    arrive in ANY order after ``start``; determinant responses are
    delivered only once the manager is WAITING_DETERMINANTS (the real
    manager raises ``RecoveryError`` otherwise — bug
    ``early-response`` removes that gate to prove the model notices).

    State: ``(fsm, restored, ins, outs, expected_set, responses,
    errored)``; ``ins``/``outs`` are per-peer booleans.

    Liveness is the point here: every interleaving must reach RUNNING
    (recovery always catches up); a terminal state anywhere else is a
    lost-wakeup bug in the advance conditions.
    """

    name = "recovery"

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        del epochs, faults      # recovery explores one incarnation
        self.peers = max(1, int(workers) - 1)
        self.bug = _check_bug("recovery", bug)

    def initial_state(self):
        return (_STANDBY, False, (False,) * self.peers,
                (False,) * self.peers, False, 0, False)

    def enabled(self, state) -> List[Action]:
        fsm, restored, ins, outs, expected_set, resp, errored = state
        if errored:
            return []
        out: List[Action] = []
        if fsm == _STANDBY:
            out.append(Action(
                "start", (),
                chaos=("kill", (("targets", (1,)),))))
            return out
        if fsm == _WAIT_CONN and not restored:
            out.append(Action("restore_done"))
        if fsm == _WAIT_CONN:
            for i, up in enumerate(ins):
                if not up:
                    out.append(Action("chan_in", (i,)))
            for i, up in enumerate(outs):
                if not up:
                    out.append(Action("chan_out", (i,)))
        if not expected_set and fsm in (_WAIT_CONN, _WAIT_DET):
            out.append(Action("expect", (self.peers,)))
        if resp < self.peers and (
                fsm == _WAIT_DET
                or (self.bug == "early-response"
                    and fsm == _WAIT_CONN and expected_set)):
            out.append(Action("response", (resp,)))
        if fsm == _REPLAYING:
            out.append(Action("replay"))
        return out

    def apply(self, state, action: Action):
        fsm, restored, ins, outs, expected_set, resp, errored = state
        k = action.kind
        if k == "start":
            fsm = _WAIT_CONN
        elif k == "restore_done":
            restored = True
        elif k == "chan_in":
            ins = ins[:action.args[0]] + (True,) \
                + ins[action.args[0] + 1:]
        elif k == "chan_out":
            outs = outs[:action.args[0]] + (True,) \
                + outs[action.args[0] + 1:]
        elif k == "expect":
            expected_set = True
        elif k == "response":
            if fsm != _WAIT_DET:
                # the real notify_determinant_response raises here
                errored = True
            else:
                resp += 1
        elif k == "replay":
            fsm = _RUNNING
        else:
            raise ValueError(f"bad action {action}")
        # _maybe_advance_connections / _maybe_have_determinants mirrors
        if fsm == _WAIT_CONN and restored and all(ins) and all(outs):
            fsm = _WAIT_DET
        if fsm == _WAIT_DET and expected_set and resp >= self.peers:
            fsm = _REPLAYING
        return (fsm, restored, ins, outs, expected_set, resp, errored)

    def invariants(self):
        def no_error(state):
            if state[6]:
                return ("a notification arrived in a state the real "
                        "RecoveryManager raises RecoveryError for — "
                        "the driver's ordering guarantee is broken")
            return None

        def gated(state):
            fsm, restored, ins, outs, expected_set, resp, _e = state
            if fsm >= _REPLAYING and not (
                    restored and all(ins) and all(outs)
                    and expected_set and resp >= self.peers):
                return ("replay started before restoration, channels "
                        "and all determinant responses were in")
            return None

        return [("no-protocol-error", no_error),
                ("replay-gated", gated)]

    def settled(self, state) -> Optional[str]:
        if state[0] != _RUNNING:
            return (f"recovery wedged in {FSM_NAMES[state[0]]} — "
                    f"never reached RUNNING (caught-up)")
        return None


# --- leader-lease fencing -------------------------------------------------

class LeaseModel(Model):
    """Claim-file leader election with receiver-side fencing.

    State: ``(claims, believed, faults_left)`` — ``claims[e-1] =
    (owner, live)`` for epoch ``e`` (epochs are claimed in order, one
    owner each, exactly the O_CREAT|O_EXCL arbitration); ``believed[c]``
    is contender ``c``'s own fencing token (its ``election.epoch``),
    which goes stale silently when a rival claims a higher epoch —
    the split-brain window fencing exists to close.

    Each lease expiry consumes one injected fault (a leader pause long
    enough for the TTL to lapse — the chaos ``leader-loss`` event).

    Invariant **single-fenced-writer**: at most one contender holds a
    token the receiver-side check (``fencing_valid``: token == highest
    existing claim) would accept. Bug ``no-fencing-check`` makes
    receivers accept any token, and the checker must find the classic
    three-step counterexample: acquire(A) → expiry → acquire(B) leaves
    A and B both writing.
    """

    name = "lease"

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        del epochs              # epoch count is derived: faults + 1
        self.contenders = max(2, int(workers))
        self.faults = int(faults)
        self.bug = _check_bug("lease", bug)

    def initial_state(self):
        return ((), (None,) * self.contenders, self.faults)

    def enabled(self, state) -> List[Action]:
        claims, believed, faults_left = state
        out: List[Action] = []
        top_live = bool(claims) and claims[-1][1]
        if not top_live:
            for c in range(self.contenders):
                out.append(Action("acquire", (c,)))
        elif faults_left > 0:
            out.append(Action(
                "expire", (),
                chaos=("leader-loss", (("hold_s", 0.6),))))
        for c in range(self.contenders):
            e = believed[c]
            if e is None:
                continue
            if e == len(claims) and not claims[-1][1]:
                out.append(Action("renew", (c,)))   # revives own lease
            elif e != len(claims):
                out.append(Action("renew", (c,)))   # discovers deposed
        return out

    def apply(self, state, action: Action):
        claims, believed, faults_left = state
        k = action.kind
        believed = list(believed)
        if k == "acquire":
            c = action.args[0]
            claims = claims + ((c, True),)
            believed[c] = len(claims)
        elif k == "expire":
            claims = claims[:-1] + ((claims[-1][0], False),)
            faults_left -= 1
        elif k == "renew":
            c = action.args[0]
            if believed[c] == len(claims):
                claims = claims[:-1] + ((claims[-1][0], True),)
            else:
                believed[c] = None      # deposed: a higher claim exists
        else:
            raise ValueError(f"bad action {action}")
        return (claims, tuple(believed), faults_left)

    def _accepted(self, token: int, claims) -> bool:
        if self.bug == "no-fencing-check":
            return True
        return bool(claims) and token == len(claims)

    def invariants(self):
        def single_writer(state):
            claims, believed, _f = state
            writers = [c for c, e in enumerate(believed)
                       if e is not None and self._accepted(e, claims)]
            if len(writers) > 1:
                toks = {c: believed[c] for c in writers}
                return (f"contenders {writers} all hold accepted "
                        f"fencing tokens {toks} — two fenced writers "
                        f"for one job (split brain)")
            return None

        return [("single-fenced-writer", single_writer)]

    def settled(self, state) -> Optional[str]:
        return None     # a live, renewing leader is a fine place to end


# --- dispatcher admission -------------------------------------------------

class AdmissionModel(Model):
    """The AdmissionController's bookkeeping under one dispatcher lock:
    quota charged on RESERVATION (held + queued), strict-FIFO
    head-blocking drain, queued-cancel releasing the charge, release
    on finish/cancel of admitted jobs.

    Configuration scales with ``workers``: a pool of ``workers`` slots,
    two tenants with quota ``workers + 1``, and per tenant two jobs of
    1 and ``workers`` slots — small enough to exhaust, shaped to force
    queueing, head-blocking and cross-tenant contention.

    State: ``(status, queue, pending, held)`` — per-job status in
    {new, queued, held, done, cancelled, rejected}, the FIFO queue,
    the reservation-charge set, per-tenant held counts. ``held`` is
    EXPLICIT (not derived) precisely so accounting bugs are
    expressible; invariant **no-leak** re-derives it from statuses and
    must always agree.
    """

    name = "admission"

    NEW, QUEUED, HELD, DONE, CANCELLED, REJECTED = range(6)

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        del epochs, faults
        self.pool = max(2, int(workers))
        self.quota = self.pool + 1
        #: (tenant, slots) per job: two tenants, small + pool-sized
        self.jobs: Tuple[Tuple[int, int], ...] = (
            (0, 1), (0, self.pool), (1, 1), (1, self.pool))
        self.bug = _check_bug("admission", bug)

    def initial_state(self):
        return ((self.NEW,) * len(self.jobs), (), frozenset(), (0, 0))

    def _reserved(self, tenant, pending, held):
        return held[tenant] + sum(
            s for j, (t, s) in enumerate(self.jobs)
            if t == tenant and j in pending)

    def _free(self, held):
        return self.pool - sum(held)

    def enabled(self, state) -> List[Action]:
        status, queue, pending, held = state
        out: List[Action] = []
        for j, st in enumerate(status):
            if st == self.NEW:
                out.append(Action("submit", (j,)))
            elif st == self.QUEUED:
                out.append(Action("cancel_queued", (j,)))
            elif st == self.HELD:
                out.append(Action("finish", (j,)))
                out.append(Action("cancel_held", (j,)))
        if queue:
            _t, slots = self.jobs[queue[0]]
            if slots <= self._free(held):
                out.append(Action("admit"))
        return out

    def apply(self, state, action: Action):
        status, queue, pending, held = state
        status = list(status)
        held = list(held)
        k = action.kind
        if k == "submit":
            j = action.args[0]
            t, slots = self.jobs[j]
            if self._reserved(t, pending, tuple(held)) + slots \
                    > self.quota:
                status[j] = self.REJECTED
            elif queue or slots > self._free(held):
                status[j] = self.QUEUED
                queue = queue + (j,)
                pending = pending | {j}
            else:
                status[j] = self.HELD
                held[t] += slots
        elif k == "admit":
            # admit_queued: drain the head while slots last — strict
            # FIFO, a too-big head blocks the drain.
            free = self._free(held)
            while queue:
                t, slots = self.jobs[queue[0]]
                if slots > free:
                    break
                j = queue[0]
                queue = queue[1:]
                pending = pending - {j}
                status[j] = self.HELD
                held[t] += slots
                free -= slots
        elif k == "cancel_queued":
            j = action.args[0]
            status[j] = self.CANCELLED
            queue = tuple(q for q in queue if q != j)
            if self.bug != "cancel-leaks-quota":
                pending = pending - {j}
        elif k == "cancel_held" or k == "finish":
            j = action.args[0]
            t, slots = self.jobs[j]
            status[j] = (self.CANCELLED if k == "cancel_held"
                         else self.DONE)
            held[t] = max(0, held[t] - slots)   # release clamps at 0
        else:
            raise ValueError(f"bad action {action}")
        return (tuple(status), queue, pending, tuple(held))

    def invariants(self):
        def quota_ok(state):
            _s, _q, pending, held = state
            for t in (0, 1):
                r = self._reserved(t, pending, held)
                if r > self.quota:
                    return (f"tenant {t} reserved {r} > quota "
                            f"{self.quota}")
            return None

        def no_overcommit(state):
            held = state[3]
            if min(held) < 0:
                return f"negative held counts {held}"
            if sum(held) > self.pool:
                return (f"held {sum(held)} slots exceed the pool of "
                        f"{self.pool}")
            return None

        def no_leak(state):
            status, queue, pending, held = state
            for t in (0, 1):
                true_held = sum(
                    s for j, (jt, s) in enumerate(self.jobs)
                    if jt == t and status[j] == self.HELD)
                if held[t] != true_held:
                    return (f"tenant {t} accounting drift: held "
                            f"{held[t]} but {true_held} slots are "
                            f"actually admitted")
            if pending != frozenset(queue):
                ghost = sorted(pending - frozenset(queue))
                return (f"reservation charge leaked for job(s) "
                        f"{ghost} no longer queued — quota never "
                        f"recovers")
            return None

        return [("quota-never-exceeded", quota_ok),
                ("no-negative-or-overcommit", no_overcommit),
                ("no-leak", no_leak)]

    def settled(self, state) -> Optional[str]:
        status, queue, _p, _h = state
        if queue:
            return f"queue wedged with job(s) {list(queue)}"
        open_jobs = [j for j, st in enumerate(status)
                     if st in (self.NEW, self.QUEUED, self.HELD)]
        if open_jobs:
            return f"job(s) {open_jobs} never reached a terminal state"
        return None


# --- elastic repartition --------------------------------------------------

#: repartition phases (state[0])
_PRE, _FENCED, _REDIRECTED = range(3)
PHASE_NAMES = ("PRE", "FENCED", "REDIRECTED")


class RepartitionModel(Model):
    """The live re-cut handoff: fence → drain → migrate → redirect.

    One key group per old worker (``workers`` groups; groups are
    symmetric so one per worker preserves the argument). Records flow
    per group as ``ingest`` (old incarnation admits a record onto the
    group's in-flight edge) and ``process`` (the record is applied to
    the group's keyed state). The re-cut:

    - ``fence`` — a checkpoint fence completes; the old incarnation
      stops admitting new records (carries the ``rescale`` chaos hint:
      replaying a model counterexample on the live system re-cuts to
      ``workers + 1``).
    - ``drain(g)`` — a buffered in-flight record of group ``g`` is
      applied by the old incarnation (edge drain before handoff).
    - ``migrate(g)`` — group ``g``'s keyed state moves to the new
      incarnation; legal only once its edge buffer is empty.
    - ``redirect`` — traffic cuts over to the new incarnation; legal
      only once EVERY group has migrated. Whatever the old incarnation
      still buffers dies with it, and an unmigrated group restarts
      empty — the model charges both to ``lost`` so the seeded bugs
      that reach this state are caught by the invariant, not by fiat.

    After redirect the new incarnation ingests/processes fresh traffic;
    bug ``stale-writer`` lets the OLD incarnation re-apply a record of
    a group it already handed off (the duplicate hazard fencing-token
    discipline exists to prevent).

    State: ``(phase, groups)`` with per-group
    ``(produced, applied, buf, migrated, lost, stale)``.

    Invariants:

    - **no-record-lost** — no group ever loses a record across the
      re-cut fence (``lost == 0`` everywhere).
    - **no-record-duplicated** — no group applies more records than
      were produced for it (``applied + buf + lost <= produced``).
    """

    name = "repartition"

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        del faults              # the re-cut itself is the disturbance
        self.groups = max(2, int(workers))
        self.pre_cap = max(1, int(epochs))   # per-group records pre-fence
        self.post_cap = 1                    # per-group records post-cut
        self.bug = _check_bug("repartition", bug)

    def initial_state(self):
        return (_PRE, ((0, 0, 0, False, 0, False),) * self.groups)

    def enabled(self, state) -> List[Action]:
        phase, groups = state
        out: List[Action] = []
        if phase == _PRE:
            for g, (prod, _a, buf, _m, _l, _s) in enumerate(groups):
                if prod < self.pre_cap:
                    out.append(Action("ingest", (g,)))
                if buf > 0:
                    out.append(Action("process", (g,)))
            out.append(Action(
                "fence", (),
                chaos=("rescale", (("targets", (self.groups + 1,)),))))
        elif phase == _FENCED:
            all_migrated = all(m for _p, _a, _b, m, _l, _s in groups)
            for g, (_p, _a, buf, migrated, _l, _s) in enumerate(groups):
                if buf > 0:
                    out.append(Action("drain", (g,)))
                if not migrated and (
                        buf == 0 or self.bug == "migrate-skips-drain"):
                    out.append(Action("migrate", (g,)))
            if all_migrated or self.bug == "redirect-before-migrate":
                out.append(Action("redirect"))
        else:                   # _REDIRECTED
            for g, (prod, applied, buf, _m, _l, stale) in \
                    enumerate(groups):
                if prod < self.pre_cap + self.post_cap:
                    out.append(Action("ingest_new", (g,)))
                if buf > 0:
                    out.append(Action("process_new", (g,)))
                if (self.bug == "stale-writer" and applied > 0
                        and not stale):
                    out.append(Action("stale_write", (g,)))
        return out

    def apply(self, state, action: Action):
        phase, groups = state
        groups = list(groups)
        k = action.kind
        if k == "fence":
            phase = _FENCED
        elif k == "redirect":
            phase = _REDIRECTED
            # The old incarnation's leftovers die with it; an
            # unmigrated group's state never reached the new owner.
            for g, (prod, applied, buf, migrated, lost, stale) in \
                    enumerate(groups):
                if not migrated:
                    lost += applied
                    applied = 0
                lost += buf
                buf = 0
                groups[g] = (prod, applied, buf, True, lost, stale)
        else:
            g = action.args[0]
            prod, applied, buf, migrated, lost, stale = groups[g]
            if k in ("ingest", "ingest_new"):
                prod += 1
                buf += 1
            elif k in ("process", "process_new", "drain"):
                applied += 1
                buf -= 1
            elif k == "migrate":
                migrated = True
            elif k == "stale_write":
                applied += 1    # re-applies a record already handed off
                stale = True
            else:
                raise ValueError(f"bad action {action}")
            groups[g] = (prod, applied, buf, migrated, lost, stale)
        return (phase, tuple(groups))

    def invariants(self):
        def no_loss(state):
            _phase, groups = state
            lost = {g: gl for g, (_p, _a, _b, _m, gl, _s)
                    in enumerate(groups) if gl}
            if lost:
                return (f"group(s) {sorted(lost)} lost {lost} "
                        f"record(s) across the re-cut fence — "
                        f"in-flight or keyed state never reached the "
                        f"new incarnation")
            return None

        def no_dup(state):
            _phase, groups = state
            for g, (prod, applied, buf, _m, lost, _s) in \
                    enumerate(groups):
                if applied + buf + lost > prod:
                    return (f"group {g} accounts for "
                            f"{applied + buf + lost} records but only "
                            f"{prod} were produced — a record was "
                            f"applied twice across the handoff")
            return None

        return [("no-record-lost", no_loss),
                ("no-record-duplicated", no_dup)]

    def canon(self, state):
        """Key groups are symmetric: sort the per-group tuples."""
        phase, groups = state
        return (phase, tuple(sorted(groups)))

    def settled(self, state) -> Optional[str]:
        phase, groups = state
        if phase != _REDIRECTED:
            return (f"re-cut wedged in {PHASE_NAMES[phase]} — the old "
                    f"incarnation never handed off")
        undrained = [g for g, (_p, _a, b, _m, _l, _s)
                     in enumerate(groups) if b]
        if undrained:
            return (f"group(s) {undrained} finished with buffered "
                    f"records never applied")
        return None


# --- autoscale policy ------------------------------------------------------

# decision phases (the controller's observe → fence → decide cycle)
_AS_IDLE = 0       # awaiting this fence's signal snapshot
_AS_SIGNALED = 1   # snapshot taken, awaiting the fence completion
_AS_FENCED = 2     # fence completed+drained, awaiting the decision
_AS_PHASES = ("idle", "signaled", "fenced")


class ScalePolicyModel(Model):
    """The autoscaler's decision protocol (autoscale/policy.py +
    autoscale/controller.py), at abstract load levels.

    Per fence the controller observes one load level (0 low / 1 steady
    / 2 high), completes the fence, and decides: fold the level into
    sustain streaks, then — healthy and out of cooldown — scale up on
    a sustained high, down on a sustained low, bounded to ±1 within
    [min, max] workers. A scale decision is LOGGED as a SCALE
    determinant when made and sits pending until ``execute`` carries
    it out; worker kills land anywhere the controller is idle,
    INCLUDING between decide and execute — the window the execute-time
    health re-check exists for.

    State::

        (phase, fence, level, over, under, cooldown, workers,
         failed, faults_left, pending, last_dec, last_execs, n_dec)

    ``pending`` is ``(dir, fence_decided, logged)`` or None;
    ``last_dec`` records the newest decision as ``(action, over,
    under, cooldown_gate, healthy, room_up, room_down)`` — invariants
    judge each decision the moment it is made, so only the newest need
    be carried; ``last_execs`` keeps the two newest executed actions
    ``(fence, dir, healthy, logged)`` (oscillation is a property of
    consecutive pairs). ``n_dec`` counts decisions for the liveness
    check (every completed fence must have produced exactly one).

    Invariants:

    - **no-thrash** — consecutive executed actions in OPPOSITE
      directions are at least one full cooldown window apart.
    - **decision-logged** — nothing executes without its SCALE
      determinant (the replay-not-re-decide recovery contract).
    - **no-rescale-mid-recovery** — nothing executes while a subtask
      is failed (``rescale_live`` would be re-cutting a cluster that
      is mid-recovery).
    - **monotone-in-sustained-signals** — a healthy, out-of-cooldown
      controller facing a sustained high MUST scale up (and never
      down); facing a sustained low with headroom it MUST scale down.
      Sustained pressure cannot be ignored or inverted.
    """

    name = "scalepolicy"

    def __init__(self, workers: int = 2, epochs: int = 2,
                 faults: int = 1, bug: Optional[str] = None):
        self.min_w = 1
        self.max_w = int(workers) + 1     # headroom for one scale-up
        self.start_w = int(workers)
        self.fences = int(epochs) + 2     # decision rounds
        self.sustain = 1                  # fences a signal must hold
        self.cooldown = 2                 # fences between actions
        self.faults = int(faults)
        self.bug = _check_bug("scalepolicy", bug)

    def initial_state(self):
        return (_AS_IDLE, 0, -1, 0, 0, 0, self.start_w,
                0, self.faults, None, None, (), 0)

    def enabled(self, state) -> List[Action]:
        (phase, fence, _level, _over, _under, _cd, _w,
         failed, faults_left, pending, _ld, _le, _nd) = state
        acts: List[Action] = []
        if phase == _AS_IDLE and pending is None and fence < self.fences:
            # a 4x offered-rate spike is the live analog of sustained
            # high load — the bridge compiles exactly this hint
            acts.append(Action("signal", (2,),
                               chaos=("load-spike",
                                      (("factor", 4.0),
                                       ("duration_s", 2.0)))))
            acts.append(Action("signal", (1,)))
            acts.append(Action("signal", (0,)))
        if phase == _AS_SIGNALED:
            acts.append(Action("fence"))
        if phase == _AS_FENCED:
            acts.append(Action("decide"))
        if (phase == _AS_IDLE and pending is not None
                and (failed == 0 or self.bug == "rescale-mid-recovery")):
            acts.append(Action("execute"))
        # kills and recoveries land only while the controller is idle:
        # the signal→fence→decide triplet is atomic with respect to
        # health — the controller decides on the snapshot it OBSERVED,
        # so a health flip inside the triplet has no decision analog.
        # The decide→execute window stays open (that interleaving is
        # the rescale-mid-recovery hazard).
        if phase == _AS_IDLE and failed == 0 and faults_left > 0:
            acts.append(Action("kill",
                               chaos=("kill", (("targets", (1,)),))))
        if phase == _AS_IDLE and failed > 0:
            acts.append(Action("recover"))
        return acts

    def apply(self, state, action: Action):
        (phase, fence, level, over, under, cd, w,
         failed, faults_left, pending, last_dec, last_execs,
         n_dec) = state
        k = action.kind
        if k == "signal":
            return (_AS_SIGNALED, fence, action.args[0], over, under,
                    cd, w, failed, faults_left, pending, last_dec,
                    last_execs, n_dec)
        if k == "fence":
            return (_AS_FENCED, fence + 1, level, over, under, cd, w,
                    failed, faults_left, pending, last_dec, last_execs,
                    n_dec)
        if k == "decide":
            over2 = over + 1 if level == 2 else 0
            under2 = under + 1 if level == 0 else 0
            cd_gate = max(0, cd - 1)
            healthy = failed == 0
            room_up = w < self.max_w
            room_down = w > self.min_w
            dec = "hold"
            if healthy and (cd_gate == 0 or self.bug == "no-cooldown"):
                if over2 >= self.sustain and room_up:
                    dec = "up"
                elif under2 >= self.sustain and room_down:
                    dec = "down"
            last_dec = (dec, over2, under2, cd_gate, healthy,
                        room_up, room_down)
            cd2, pend = cd_gate, pending
            if dec != "hold":
                logged = self.bug != "unlogged-decision"
                pend = (1 if dec == "up" else -1, fence, logged)
                cd2 = self.cooldown        # restart the cooldown clock
                over2 = under2 = 0         # post-action: a new trend
            return (_AS_IDLE, fence, -1, over2, under2, cd2, w,
                    failed, faults_left, pend, last_dec, last_execs,
                    n_dec + 1)
        if k == "execute":
            direction, _fdec, logged = pending
            entry = (fence, direction, failed == 0, logged)
            return (phase, fence, level, over, under, cd,
                    w + direction, failed, faults_left, None, last_dec,
                    (last_execs + (entry,))[-2:], n_dec)
        if k == "kill":
            return (phase, fence, level, over, under, cd, w, 1,
                    faults_left - 1, pending, last_dec, last_execs,
                    n_dec)
        if k == "recover":
            return (phase, fence, level, over, under, cd, w, 0,
                    faults_left, pending, last_dec, last_execs, n_dec)
        raise ValueError(f"unknown action {action}")

    def invariants(self):
        def no_thrash(state):
            execs = state[11]
            if len(execs) == 2:
                (f1, d1, _h1, _l1), (f2, d2, _h2, _l2) = execs
                if d1 != d2 and f2 - f1 < self.cooldown:
                    return (f"opposite re-cuts {d1:+d} then {d2:+d} "
                            f"only {f2 - f1} fence(s) apart (cooldown "
                            f"window is {self.cooldown})")
            return None

        def logged(state):
            execs = state[11]
            for f, d, _h, lg in execs:
                if not lg:
                    return (f"re-cut {d:+d} at fence {f} executed "
                            f"without its SCALE determinant")
            return None

        def healthy_exec(state):
            execs = state[11]
            for f, d, h, _lg in execs:
                if not h:
                    return (f"re-cut {d:+d} at fence {f} executed "
                            f"over a failed subtask (mid-recovery)")
            return None

        def monotone(state):
            last_dec = state[10]
            if last_dec is None:
                return None
            dec, ov, un, cd_gate, healthy, room_up, room_down = last_dec
            if not healthy or cd_gate > 0:
                return None
            if ov >= self.sustain and dec == "down":
                return (f"sustained high load ({ov} fence(s)) answered "
                        f"with a scale-DOWN")
            if ov >= self.sustain and room_up and dec != "up":
                return (f"sustained high load ({ov} fence(s)), healthy "
                        f"and out of cooldown with headroom, but "
                        f"decision was {dec!r}")
            if (ov < self.sustain and un >= self.sustain and room_down
                    and dec != "down"):
                return (f"sustained low load ({un} fence(s)), healthy "
                        f"and out of cooldown with floor room, but "
                        f"decision was {dec!r}")
            return None

        return [("no-thrash", no_thrash),
                ("decision-logged", logged),
                ("no-rescale-mid-recovery", healthy_exec),
                ("monotone-in-sustained-signals", monotone)]

    def settled(self, state) -> Optional[str]:
        (_phase, fence, _level, _over, _under, _cd, _w,
         _failed, _faults_left, pending, _ld, _le, n_dec) = state
        if fence < self.fences:
            return (f"controller wedged after fence {fence} of "
                    f"{self.fences}")
        if n_dec != self.fences:
            return (f"{self.fences} fence(s) completed but only "
                    f"{n_dec} decision(s) made")
        if pending is not None:
            return "a logged scale decision was never executed"
        return None


#: registry: CLI/runner model names -> constructor
MODELS = {
    "checkpoint": CheckpointModel,
    "recovery": RecoveryModel,
    "lease": LeaseModel,
    "admission": AdmissionModel,
    "repartition": RepartitionModel,
    "scalepolicy": ScalePolicyModel,
}
