"""Conformance: replay model traces against the port's real components
(port of ``clonos_tpu/verify/conformance.py``).

The models in verify/models.py claim to mirror the real protocols; this
module is what makes that claim checkable instead of aspirational. For
each component it takes model-generated traces (explorer.traces — the
deepest terminal paths, i.e. full protocol rounds), drives the REAL
implementation through the same steps, and asserts the implementation's
observable transitions (the ``transition_observers`` streams grown for
exactly this purpose) match the model's expected transitions bit for
bit. A divergence means the model and the code have drifted — the
checker's proofs no longer cover the shipping protocol — and fails CI.

The adapters drive the components exactly the way their real drivers
do (the cluster runner's ack-at-the-fence discipline, the dispatcher's
free-slot accounting, the soak driver's ``discard_pending_through``
sweep after a completion), so a conformance trace is a miniature of a
real run, minus the data plane.

Real components import torch; all component imports are lazy so the
model checker itself (verify/explorer.py, verify/models.py) stays
importable anywhere. No adapter touches a device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

from clonos_tpu_torch.verify.explorer import Action, traces
from clonos_tpu_torch.verify.models import (FSM_NAMES, PHASE_NAMES,
                                            AdmissionModel,
                                            CheckpointModel, LeaseModel,
                                            RecoveryModel,
                                            RepartitionModel,
                                            ScalePolicyModel)


@dataclasses.dataclass
class Divergence:
    """One step where the implementation's observable transitions did
    not match the model's."""

    component: str
    trace: int                   # trace index within the run
    step: int                    # action index within the trace
    action: str                  # Action.label()
    expected: List
    observed: List

    def to_dict(self) -> dict:
        return {"component": self.component, "trace": self.trace,
                "step": self.step, "action": self.action,
                "expected": [list(e) for e in self.expected],
                "observed": [list(o) for o in self.observed]}


@dataclasses.dataclass
class ConformanceReport:
    component: str
    traces: int
    steps: int
    divergences: List[Divergence]

    @property
    def ok(self) -> bool:
        return not self.divergences

    def to_dict(self) -> dict:
        return {"component": self.component, "traces": self.traces,
                "steps": self.steps, "ok": self.ok,
                "divergences": [d.to_dict() for d in self.divergences]}


def _replay(component: str, model, model_traces: List[List[Action]],
            make_adapter: Callable) -> ConformanceReport:
    """Drive one fresh adapter per trace; compare per-step expected vs
    observed transition lists, then the adapter's state projection.
    The first divergence aborts the trace (everything after it would
    diverge for the same reason)."""
    divergences: List[Divergence] = []
    steps = 0
    for ti, trace in enumerate(model_traces):
        adapter = make_adapter()
        state = model.initial_state()
        for si, action in enumerate(trace):
            expected = adapter.expected(state, action)
            observed = adapter.apply(state, action)
            state = model.apply(state, action)
            steps += 1
            if observed != expected:
                divergences.append(Divergence(
                    component=component, trace=ti, step=si,
                    action=action.label(), expected=expected,
                    observed=observed))
                break
            drift = adapter.projection_drift(state)
            if drift is not None:
                divergences.append(Divergence(
                    component=component, trace=ti, step=si,
                    action=action.label(),
                    expected=[("projection", drift[0])],
                    observed=[("projection", drift[1])]))
                break
    return ConformanceReport(component=component,
                             traces=len(model_traces), steps=steps,
                             divergences=divergences)


# --- checkpoint -----------------------------------------------------------

def _ckpt_expected(model: CheckpointModel, state, action: Action):
    """The observation stream CheckpointCoordinator must emit for this
    model step (plus the driver's post-completion discard sweep)."""
    cids = state[0]
    k, args = action.kind, action.args

    def discards_below(cid):
        return [("discard", i + 1) for i, c in enumerate(cids)
                if c[0] == "pending" and i + 1 < cid]

    if k == "trigger":
        return [("trigger", args[0])]
    if k in ("write", "ack"):
        cid = args[0]
        _t, missing, written = cids[cid - 1]
        out = []
        if k == "ack":
            missing = missing - {args[1]}
            written_after = written
            out.append(("ack", cid, args[1]))
        else:
            written_after = True
        if written_after and not missing:
            out.append(("complete", cid))
            out.extend(discards_below(cid))
        return out
    if k == "discard":
        return [("discard", args[0])]
    if k == "kill":
        return []                # the coordinator sees nothing yet
    if k == "detect":
        w = args[0]
        return [("ignore", i + 1) for i, c in enumerate(cids)
                if c[0] == "pending" and w in c[1]]
    raise ValueError(f"unmapped checkpoint action {action}")


def _ckpt_admissible(model: CheckpointModel):
    """The real driver abandons superseded fences with ONE
    ``discard_pending_through`` sweep; a model trace discarding cid
    while an older fence is still pending has no single-call impl
    analog — skip it (the sweep variant is covered by completion)."""
    def ok(trace: List[Action]) -> bool:
        state = model.initial_state()
        for a in trace:
            if a.kind == "discard":
                cid = a.args[0]
                if any(c[0] == "pending" and i + 1 < cid
                       for i, c in enumerate(state[0])):
                    return False
            state = model.apply(state, a)
        return True
    return ok


def conform_checkpoint(n_traces: int = 3, workers: int = 2,
                       epochs: int = 2, faults: int = 1,
                       depth: int = 48) -> ConformanceReport:
    from clonos_tpu_torch.runtime.checkpoint import (
        CheckpointCoordinator, InMemoryCheckpointStorage)

    class GatedStorage(InMemoryCheckpointStorage):
        """Holds written snapshots non-durable until the model's
        ``write`` step lands — the model's handle on the async-write
        race (``_maybe_complete`` retries through the read gate)."""

        def __init__(self):
            super().__init__()
            self.durable: set = set()

        def read(self, checkpoint_id: int):
            if checkpoint_id not in self.durable:
                raise KeyError(checkpoint_id)
            return super().read(checkpoint_id)

    model = CheckpointModel(workers=workers, epochs=epochs,
                            faults=faults)

    class Adapter:
        def __init__(self):
            self.storage = GatedStorage()
            self.coord = CheckpointCoordinator(
                self.storage, num_subtasks=workers, max_retained=8)
            self.obs: List[Tuple] = []
            self.coord.transition_observers.append(self._on)

        def _on(self, kind, **fields):
            if kind == "ack":
                self.obs.append((kind, fields["cid"],
                                 fields["subtask"]))
            else:
                self.obs.append((kind, fields["cid"]))

        def expected(self, state, action):
            return _ckpt_expected(model, state, action)

        def apply(self, state, action):
            self.obs = []
            k, args = action.kind, action.args
            if k == "trigger":
                self.coord.trigger(args[0], {"x": args[0]},
                                   async_write=False, owned=True)
            elif k == "write":
                cid = args[0]
                self.storage.durable.add(cid)
                missing = state[0][cid - 1][1]
                # re-run _maybe_complete through the read gate without
                # acking anyone: everyone still missing stays excepted
                self.coord.ack_all(cid,
                                   except_subtasks=tuple(sorted(missing)))
                self._sweep_if_completed(cid)
            elif k == "ack":
                self.coord.ack(args[0], args[1])
                self._sweep_if_completed(args[0])
            elif k == "discard":
                self.coord.discard_pending_through(args[0])
            elif k == "kill":
                pass             # death is invisible until detection
            elif k == "detect":
                self.coord.ignore_unacked_for({args[0]})
            else:
                raise ValueError(f"unmapped checkpoint action {action}")
            return self.obs

        def _sweep_if_completed(self, cid):
            # The driver's fence discipline: a completion supersedes
            # every older pending fence (soak driver's pre-kill sweep).
            if ("complete", cid) in self.obs:
                self.coord.discard_pending_through(cid - 1)

        def projection_drift(self, state):
            want = sorted(i + 1 for i, c in enumerate(state[0])
                          if c == ("complete",))
            got = self.storage.completed_ids()
            if want != got:
                return (f"completed={want}", f"completed={got}")
            return None

    model_traces = traces(model, n_traces, depth=depth,
                          admissible=_ckpt_admissible(model))
    return _replay("checkpoint", model, model_traces, Adapter)


# --- recovery -------------------------------------------------------------

def conform_recovery(n_traces: int = 3, workers: int = 2,
                     depth: int = 48) -> ConformanceReport:
    import types

    import numpy as np

    from clonos_tpu_torch.causal.recovery import RecoveryManager

    model = RecoveryModel(workers=workers)
    peers = model.peers

    class Adapter:
        def __init__(self):
            self.mgr = RecoveryManager(
                vertex_id=0, subtask=0, flat_subtask=0,
                replayer=types.SimpleNamespace())
            self.obs: List[Tuple] = []
            self.mgr.transition_observers.append(
                lambda kind, **f: self.obs.append(("goto", kind)))

        def expected(self, state, action):
            pre = state[0]
            post = model.apply(state, action)[0]
            return [("goto", FSM_NAMES[f])
                    for f in range(pre + 1, post + 1)]

        def apply(self, state, action):
            self.obs = []
            k = action.kind
            if k == "start":
                self.mgr.notify_start_recovery(
                    in_edges=range(peers), out_edges=range(peers))
            elif k == "restore_done":
                self.mgr.notify_state_restoration_complete()
            elif k == "chan_in":
                self.mgr.notify_new_input_channel(action.args[0])
            elif k == "chan_out":
                self.mgr.notify_new_output_channel(action.args[0])
            elif k == "expect":
                self.mgr.expect_determinant_responses(action.args[0])
            elif k == "response":
                self.mgr.notify_determinant_response(
                    np.zeros((0, 8), dtype=np.int64), 0)
            elif k == "replay":
                # the port's replay takes the device it replays on; the
                # stubbed replayer below touches none
                self.mgr.run_replay(
                    types.SimpleNamespace(verify_outputs=False), "cpu")
            else:
                raise ValueError(f"unmapped recovery action {action}")
            return self.obs

        def projection_drift(self, state):
            want = FSM_NAMES[state[0]]
            got = self.mgr.state.name
            if want != got:
                return (want, got)
            return None

    # run_replay calls replayer.replay(...); stub it per adapter
    def make():
        a = Adapter()
        a.mgr.replayer = types.SimpleNamespace(
            replay=lambda plan, device, defer_sync=False:
                types.SimpleNamespace(deferred=True))
        return a

    model_traces = traces(model, n_traces, depth=depth)
    return _replay("recovery", model, model_traces, make)


# --- leader lease ---------------------------------------------------------

def conform_lease(workdir: str, n_traces: int = 3, workers: int = 2,
                  faults: int = 1, depth: int = 48) -> ConformanceReport:
    from clonos_tpu_torch.runtime.leader import FileLeaderElection

    model = LeaseModel(workers=workers, faults=faults)
    ttl = 50.0
    counter = [0]

    class Adapter:
        def __init__(self):
            counter[0] += 1
            path = os.path.join(workdir, f"lease{counter[0]}")
            self.clock = [1000.0]
            self.obs: List[Tuple] = []
            self.elections = []
            for c in range(model.contenders):
                e = FileLeaderElection(path, f"c{c}", lease_ttl_s=ttl,
                                       clock=lambda: self.clock[0])
                e.transition_observers.append(
                    lambda kind, c=c, **f:
                        self.obs.append((kind, c, f.get("epoch"))))
                self.elections.append(e)
            self.observer = FileLeaderElection(path, "observer",
                                              lease_ttl_s=ttl,
                                              clock=lambda:
                                              self.clock[0])

        def expected(self, state, action):
            claims, believed, _f = state
            k, args = action.kind, action.args
            if k == "acquire":
                return [("claim", args[0], len(claims) + 1)]
            if k == "expire":
                return []
            if k == "renew":
                c = args[0]
                if believed[c] == len(claims):
                    return [("renew", c, believed[c])]
                return [("deposed", c, believed[c])]
            raise ValueError(f"unmapped lease action {action}")

        def apply(self, state, action):
            self.obs = []
            k, args = action.kind, action.args
            if k == "acquire":
                self.elections[args[0]].try_acquire()
            elif k == "expire":
                self.clock[0] += ttl + 1.0
            elif k == "renew":
                self.elections[args[0]].renew()
            else:
                raise ValueError(f"unmapped lease action {action}")
            return self.obs

        def projection_drift(self, state):
            claims, believed, _f = state
            for c in range(model.contenders):
                if self.elections[c].epoch != believed[c]:
                    return (f"c{c} epoch={believed[c]}",
                            f"c{c} epoch={self.elections[c].epoch}")
            # receiver-side fencing agrees with the model's acceptance
            for e in range(1, len(claims) + 1):
                want = model._accepted(e, claims)
                got = self.observer.fencing_valid(e)
                if want != got:
                    return (f"fencing_valid({e})={want}",
                            f"fencing_valid({e})={got}")
            return None

    model_traces = traces(model, n_traces, depth=depth)
    return _replay("lease", model, model_traces, Adapter)


# --- dispatcher admission -------------------------------------------------

def conform_admission(n_traces: int = 3, workers: int = 2,
                      depth: int = 48) -> ConformanceReport:
    from clonos_tpu_torch.runtime.dispatcher import (
        AdmissionController, QuotaExceededError)

    model = AdmissionModel(workers=workers)

    class Adapter:
        def __init__(self):
            self.ac = AdmissionController(
                quotas={"t0": model.quota, "t1": model.quota})
            self.obs: List[Tuple] = []
            self.ac.transition_observers.append(self._on)

        def _on(self, kind, **fields):
            if kind == "release":
                self.obs.append((kind, fields["tenant"],
                                 fields["slots"]))
            else:
                self.obs.append((kind, fields["job_id"]))

        def _free(self):
            return model.pool - self.ac.total_held()

        def expected(self, state, action):
            status, queue, pending, held = state
            k, args = action.kind, action.args
            if k == "submit":
                j = args[0]
                post = model.apply(state, action)[0][j]
                kind = {model.REJECTED: "reject",
                        model.QUEUED: "queue",
                        model.HELD: "admit"}[post]
                return [(kind, f"j{j}")]
            if k == "admit":
                post_q = model.apply(state, action)[1]
                drained = [j for j in queue if j not in post_q]
                return [("admit", f"j{j}") for j in drained]
            if k == "cancel_queued":
                return [("cancel", f"j{args[0]}")]
            if k in ("cancel_held", "finish"):
                t, slots = model.jobs[args[0]]
                return [("release", f"t{t}", slots)]
            raise ValueError(f"unmapped admission action {action}")

        def apply(self, state, action):
            self.obs = []
            k, args = action.kind, action.args
            if k == "submit":
                j = args[0]
                t, slots = model.jobs[j]
                try:
                    self.ac.request(f"j{j}", f"t{t}", slots,
                                    self._free())
                except QuotaExceededError:
                    pass
            elif k == "admit":
                self.ac.admit_queued(self._free())
            elif k == "cancel_queued":
                self.ac.cancel_queued(f"j{args[0]}")
            elif k in ("cancel_held", "finish"):
                t, slots = model.jobs[args[0]]
                self.ac.release(f"t{t}", slots)
            else:
                raise ValueError(f"unmapped admission action {action}")
            return self.obs

        def projection_drift(self, state):
            _s, queue, _p, held = state
            for t in (0, 1):
                if self.ac.held(f"t{t}") != held[t]:
                    return (f"held[t{t}]={held[t]}",
                            f"held[t{t}]={self.ac.held(f't{t}')}")
                want_r = model._reserved(t, state[2], held)
                if self.ac.reserved(f"t{t}") != want_r:
                    return (f"reserved[t{t}]={want_r}",
                            f"reserved[t{t}]="
                            f"{self.ac.reserved(f't{t}')}")
            want_q = [f"j{j}" for j in queue]
            if self.ac.queued() != want_q:
                return (f"queue={want_q}",
                        f"queue={self.ac.queued()}")
            return None

    model_traces = traces(model, n_traces, depth=depth)
    return _replay("admission", model, model_traces, Adapter)


# --- elastic repartition --------------------------------------------------

def conform_repartition(n_traces: int = 3, workers: int = 2,
                        epochs: int = 2,
                        depth: int = 48) -> ConformanceReport:
    """Drive the real :class:`RescaleCoordinator` — the control plane
    ``ClusterRunner.rescale_live`` walks through a live re-cut —
    through model traces. Pre-fence ingest/process are data-plane
    bookkeeping (``note_inflight``; nothing observable), as is the new
    incarnation's post-redirect traffic; fence/drain/migrate/redirect
    must emit exactly the model's transition per step."""
    from clonos_tpu_torch.runtime.scheduler import RescaleCoordinator

    model = RepartitionModel(workers=workers, epochs=epochs)

    class Adapter:
        def __init__(self):
            self.coord = RescaleCoordinator(model.groups)
            self.obs: List[Tuple] = []
            self.coord.transition_observers.append(self._on)

        def _on(self, kind, **fields):
            if kind in ("drain", "migrate"):
                self.obs.append((kind, fields["group"]))
            else:
                self.obs.append((kind,))

        def expected(self, state, action):
            k, args = action.kind, action.args
            if k in ("ingest", "process", "ingest_new", "process_new"):
                return []
            if k == "fence":
                return [("fence",)]
            if k in ("drain", "migrate"):
                return [(k, args[0])]
            if k == "redirect":
                return [("redirect",)]
            raise ValueError(f"unmapped repartition action {action}")

        def apply(self, state, action):
            self.obs = []
            k, args = action.kind, action.args
            if k == "ingest":
                self.coord.note_inflight(args[0], 1)
            elif k == "process":
                self.coord.note_inflight(args[0], -1)
            elif k == "fence":
                self.coord.fence(1)
            elif k == "drain":
                self.coord.drain(args[0])
            elif k == "migrate":
                self.coord.migrate(args[0])
            elif k == "redirect":
                self.coord.redirect()
            elif k in ("ingest_new", "process_new"):
                pass        # the NEW incarnation's traffic
            else:
                raise ValueError(f"unmapped repartition action {action}")
            return self.obs

        def projection_drift(self, state):
            phase, groups = state
            want_phase = PHASE_NAMES[phase]
            # model PRE/FENCED/REDIRECTED == coordinator phase names
            if self.coord.phase != want_phase:
                return (f"phase={want_phase}",
                        f"phase={self.coord.phase}")
            if phase == 2:      # redirected: new incarnation owns state
                return None
            for g, (_p, _a, buf, migrated, _l, _s) in enumerate(groups):
                if self.coord.inflight[g] != buf:
                    return (f"inflight[{g}]={buf}",
                            f"inflight[{g}]={self.coord.inflight[g]}")
                if self.coord.migrated[g] != migrated:
                    return (f"migrated[{g}]={migrated}",
                            f"migrated[{g}]={self.coord.migrated[g]}")
            return None

    model_traces = traces(model, n_traces, depth=depth)
    return _replay("repartition", model, model_traces, Adapter)


def conform_scalepolicy(n_traces: int = 3, workers: int = 2,
                        epochs: int = 2, faults: int = 1,
                        depth: int = 40) -> ConformanceReport:
    """Replay ScalePolicyModel traces through the REAL
    ``AutoscaleController`` (autoscale/controller.py) over the real
    ``ScalePolicy``, configured to the model's bounds (sustain 1,
    cooldown 2, one step of worker headroom, replica arms pinned
    shut). Model load levels become concrete snapshots via
    ``signals_for_level``; the controller's transition observers must
    emit exactly the model's observe/fence/decide/log/execute stream,
    and its PolicyState/decision-log projection must track the model
    state step for step."""
    from clonos_tpu_torch.autoscale import (AutoscaleController,
                                            PolicyConfig, ScalePolicy,
                                            signals_for_level)

    model = ScalePolicyModel(workers=workers, epochs=epochs,
                             faults=faults)
    _LOAD = {0: 0.4, 1: 1.0, 2: 1.6}

    class Adapter:
        def __init__(self):
            cfg = PolicyConfig(sustain_fences=model.sustain,
                               cooldown_fences=model.cooldown,
                               min_workers=model.min_w,
                               max_workers=model.max_w,
                               min_replicas=1, max_replicas=1)
            self.workers = model.start_w
            self.failed = 0
            self.ac = AutoscaleController(
                ScalePolicy(cfg),
                execute_workers=self._exec_workers,
                healthy=lambda: self.failed == 0)
            self.ac.transition_observers.append(self._on)
            self.obs: List[Tuple] = []

        def _exec_workers(self, target):
            self.workers = target

        def _on(self, kind, **fields):
            if kind == "observe":
                self.obs.append((kind, fields["load"]))
            elif kind == "fence":
                self.obs.append((kind, fields["epoch"]))
            elif kind == "decide":
                self.obs.append((kind, fields["action"]))
            elif kind == "log":
                self.obs.append((kind, fields["seq"]))
            elif kind == "execute":
                self.obs.append((kind, fields["action"],
                                 fields["target"]))
            else:
                self.obs.append((kind,))

        def _model_decision(self, state):
            """The model's decide outcome, recomputed from its
            pre-decide state (mirrors ScalePolicyModel.apply)."""
            (_ph, _fence, level, over, under, cd, w,
             failed, _fl, _pend, _ld, _le, n_dec) = state
            over2 = over + 1 if level == 2 else 0
            under2 = under + 1 if level == 0 else 0
            cd_gate = max(0, cd - 1)
            dec = "hold"
            if failed == 0 and cd_gate == 0:
                if over2 >= model.sustain and w < model.max_w:
                    dec = "up"
                elif under2 >= model.sustain and w > model.min_w:
                    dec = "down"
            action = "hold" if dec == "hold" else "scale-workers"
            return dec, action, n_dec + 1

        def expected(self, state, action: Action):
            k = action.kind
            if k == "signal":
                return [("observe", _LOAD[action.args[0]])]
            if k == "fence":
                return [("fence", state[1] + 1)]
            if k == "decide":
                _dec, act, seq = self._model_decision(state)
                return [("decide", act), ("log", seq)]
            if k == "execute":
                direction, _fdec, _logged = state[9]
                return [("execute", "scale-workers",
                         state[6] + direction)]
            if k in ("kill", "recover"):
                return []        # the controller sees nothing yet
            raise ValueError(f"unmapped scalepolicy action {action}")

        def apply(self, state, action: Action):
            self.obs = []
            k = action.kind
            if k == "signal":
                # the snapshot carries the fence it will decide for
                # and the health the controller observed
                self.ac.observe(signals_for_level(
                    action.args[0], epoch=state[1],
                    workers=self.workers,
                    failed_subtasks=self.failed))
            elif k == "fence":
                self.ac.note_fence(state[1] + 1)
            elif k == "decide":
                self.ac.decide()
            elif k == "execute":
                self.ac.execute()
            elif k == "kill":
                self.failed = 1
            elif k == "recover":
                self.failed = 0
            return list(self.obs)

        def projection_drift(self, state):
            (_ph, _fence, _level, over, under, cd, w,
             _failed, _fl, pend, _ld, _le, n_dec) = state
            st = self.ac.state
            if st.cooldown != cd:
                return (f"cooldown={cd}", f"cooldown={st.cooldown}")
            if (st.over_streak, st.under_streak) != (over, under):
                return (f"streaks=({over},{under})",
                        f"streaks=({st.over_streak},"
                        f"{st.under_streak})")
            if st.seq != n_dec or len(self.ac.log) != n_dec:
                return (f"decisions={n_dec}",
                        f"seq={st.seq} log={len(self.ac.log)}")
            if self.workers != w:
                return (f"workers={w}", f"workers={self.workers}")
            if (self.ac.pending is not None) != (pend is not None):
                return (f"pending={pend is not None}",
                        f"pending={self.ac.pending is not None}")
            return None

    model_traces = traces(model, n_traces, depth=depth)
    return _replay("scalepolicy", model, model_traces, Adapter)


def run_conformance(components: Optional[List[str]] = None,
                    n_traces: int = 3, workers: int = 2,
                    epochs: int = 2, faults: int = 1,
                    workdir: Optional[str] = None
                    ) -> Dict[str, ConformanceReport]:
    """Conformance for the requested components (default: all six).
    ``workdir`` hosts the lease claim files (a temp dir is created
    when omitted)."""
    import tempfile
    components = list(components or ("checkpoint", "recovery", "lease",
                                     "admission", "repartition",
                                     "scalepolicy"))
    out: Dict[str, ConformanceReport] = {}
    for c in components:
        if c == "checkpoint":
            out[c] = conform_checkpoint(n_traces, workers=workers,
                                        epochs=epochs, faults=faults)
        elif c == "recovery":
            out[c] = conform_recovery(n_traces, workers=workers)
        elif c == "lease":
            wd = workdir or tempfile.mkdtemp(prefix="clonos-verify-")
            out[c] = conform_lease(wd, n_traces, workers=workers,
                                   faults=faults)
        elif c == "admission":
            out[c] = conform_admission(n_traces, workers=workers)
        elif c == "repartition":
            out[c] = conform_repartition(n_traces, workers=workers,
                                         epochs=epochs)
        elif c == "scalepolicy":
            out[c] = conform_scalepolicy(n_traces, workers=workers,
                                         epochs=epochs, faults=faults)
        else:
            raise ValueError(f"unknown component {c!r}")
    return out
