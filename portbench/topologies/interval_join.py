"""The interval join on the port: two synthetic sources -> keyBy on both
-> keyed interval join -> sink, under a ``ClusterRunner`` with causal
logging, each log replicated to ``replication_factor`` holders in every
downstream vertex, and the in-flight rings; the join's subtasks call external
services through their causal services.

``build`` makes the job, its inputs, its services and its runner from
the seed; ``capture`` copies to the host what the run produced (state,
the last step of both keyBy edges, both sources' logged draws, the
sink's output sampled over the fill, the join's output ring at the
window's end, the recovered states, the replicas read back); ``compare``
holds all of it to the plain reference (``reference/interval_join.py``),
exact, so every limit is 0.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.interval_join import IntervalJoin
from portbench.reference.window_chain import SyntheticStream

#: the job's vertices, in id order
VERTICES = ("source", "source-r", "join", "sink")
#: the state compared, per vertex
STATE_KEYS = ("source", "source_r", "lv", "lt", "lm", "cursor",
              "sink_emitted")


def records_per_step(cfg: Dict) -> int:
    return 2 * cfg["parallelism"] * cfg["batch"]


def build(ctx) -> None:
    """The job and its runner on ``ctx.device``; sets ``ctx.runner``,
    ``ctx.stream_inputs`` (both sources' starting counters),
    ``ctx.services`` and the sink's tap."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    cfg = ctx.config
    p, b, vocab = cfg["parallelism"], cfg["batch"], cfg["vocab"]
    env = StreamEnvironment(name=ctx.config_name,
                            num_key_groups=cfg["num_key_groups"],
                            default_edge_capacity=cfg["edge_capacity"])
    left = env.synthetic_source(vocab=vocab, batch_size=b, parallelism=p,
                                name="source").key_by()
    right = env.synthetic_source(vocab=vocab, batch_size=b, parallelism=p,
                                 name="source-r").key_by()
    (left.join(right, num_keys=vocab, window=cfg["join_window"],
               interval=cfg["join_interval"], parallelism=p, name="join")
         .sink(parallelism=p, name="sink"))
    job = env.build()
    rng = ctx.rng("inputs")
    runner = ClusterRunner(
        job, steps_per_epoch=cfg["steps_per_epoch"],
        log_capacity=cfg["log_capacity"], max_epochs=cfg["max_epochs"],
        inflight_ring_steps=cfg["inflight_ring_steps"],
        block_steps=cfg["block_steps"], logical_time=cfg["logical_time"],
        replication_factor=cfg["replication_factor"],
        seed=int(rng.integers(0, 2 ** 31)), device=ctx.device)
    ex = runner.executor
    # Each generator resumes from seeded positions, as a source restarted
    # at an offset would.
    seq0 = {name: rng.integers(0, 2 ** 30, size=p, dtype=np.int64)
            for name in ("source", "source-r")}
    ops = list(ex.carry.op_states)
    for name, s0 in seq0.items():
        ops[VERTICES.index(name)] = {"seq": torch.as_tensor(
            s0.astype(np.int32), device=ex.device)}
    ex.carry = ex.carry._replace(op_states=tuple(ops))
    ctx.stream_inputs = {"seq0": seq0["source"], "seq0_r": seq0["source-r"]}
    ctx.runner = runner
    ctx.services = JoinServices(ctx)
    ctx.join_tap = FillTap(ctx, ctx.cell.get("sink_samples", 16))
    ex.on_block_outputs = ctx.join_tap


class FillTap:
    """The executor's per-block output hook: keeps the sink's output at
    ``size`` steps of the fill, drawn from the seed before it runs."""

    def __init__(self, ctx, size: int):
        self.ctx = ctx
        cfg = ctx.config
        n = cfg["steps_per_epoch"] * (1 + cfg["pending_epochs"])
        self.steps = sorted(set(int(s) for s in ctx.rng(
            "sink_samples").integers(3, n, size=size)))
        self.kept: Dict[int, tuple] = {}

    def __call__(self, outs, epoch: int) -> None:
        out = outs.sinks[VERTICES.index("sink")]
        k = out.keys.shape[0]
        s1 = self.ctx.runner.executor._steps_executed
        for s in self.steps:
            if s1 - k <= s < s1 and s not in self.kept:
                self.kept[s] = tuple(_np(x[s - (s1 - k)]) for x in out)


class JoinServices:
    """The join subtasks' external calls: each subtask's causal services
    (``executor.service_factory`` with a ``SidecarStore`` of its own), an
    external function that answers from a seeded call counter (a second
    call gives other bytes), and what each call returned live."""

    def __init__(self, ctx):
        ex = ctx.runner.executor
        job = ctx.runner.job
        vid = VERTICES.index("join")
        base = job.subtask_base(vid)
        rng = ctx.rng("services")
        self.salt = int(rng.integers(0, 2 ** 62))
        #: external calls made, over the whole run
        self.calls = 0
        self.flats = [base + i for i in range(job.vertices[vid].parallelism)]
        self.sidecars = {}
        self.live = {}
        self.recorded: Dict[int, List] = {f: [] for f in self.flats}
        self.queries: Dict[int, List[bytes]] = {f: [] for f in self.flats}
        from clonos_tpu_torch.causal import determinant as det
        for f in self.flats:
            self.sidecars[f] = det.SidecarStore(owner=f)
            fac = ex.service_factory(f, self.sidecars[f],
                                     seed=int(rng.integers(0, 2 ** 31)),
                                     clock=ex.time_source.now)
            self.live[f] = (fac.serializable_service(self.external),
                            fac.time_service(), fac.random_service())

    def external(self, request: bytes) -> bytes:
        """The external service: its answer depends on how often it was
        called before."""
        self.calls += 1
        return b"%s=%d" % (request, hash((self.salt, self.calls)) & (
            2 ** 61 - 1))

    def call_all(self, epoch: int) -> None:
        """Every join subtask: one external call, one time read, one
        random draw (three asynchronous determinant rows each)."""
        for f in self.flats:
            ext, clock, rand = self.live[f]
            q = b"q%d.%d" % (f, epoch)
            self.queries[f].append(q)
            self.recorded[f] += [ext.apply(q), clock.current_time_millis(),
                                 rand.next_int()]

    def mismatches(self, report) -> int:
        """For each join subtask ``report`` recovered: the external-call,
        time and random rows its recovery brought back (the replay's
        async events), served by a ``CausalServiceFactory`` in replay
        mode over them and the subtask's sidecar, in the order they were
        recorded, against what each call returned live; plus every
        external call beyond one per recorded call. The calls are made
        here, not by the recovery: the rows come from the timed path,
        the serving from this check."""
        from clonos_tpu_torch.causal import determinant as det
        from clonos_tpu_torch.causal import services as svc
        kinds = (det.SerializableDeterminant, det.TimestampDeterminant,
                 det.RNGDeterminant)
        bad = 0
        for m in report.managers:
            f = m.flat_subtask
            if f not in self.recorded:
                continue
            events = [d for _s, d in m.result.async_events
                      if isinstance(d, kinds)]
            # The rows are back in the rebuilt log already: the ones
            # served again go nowhere.
            fac = svc.CausalServiceFactory(
                lambda d: None, self.sidecars[f], epoch_of=lambda: 0,
                replay_feed=svc.ReplayFeed(events))
            ext = fac.serializable_service(self.external)
            clock, rand = fac.time_service(), fac.random_service()
            served = []
            try:
                for q in self.queries[f]:
                    served += [ext.apply(q), clock.current_time_millis(),
                               rand.next_int()]
            except RuntimeError:
                pass                    # the feed ran out or disagreed
            want = self.recorded[f]
            bad += sum(a != b for a, b in zip(served, want))
            bad += abs(len(served) - len(want)) + abs(len(events) - len(want))
        return bad + max(0, self.calls - sum(len(q) for q in
                                             self.queries.values()))


def _vertex(job, flat: int) -> int:
    return [v for v in range(len(job.vertices))
            if job.subtask_base(v) <= flat][-1]


def _downstream(job, vid: int) -> set:
    """The vertices reachable from ``vid`` over the job's edges."""
    seen, todo = set(), [vid]
    while todo:
        for e in job.out_edges(todo.pop()):
            d = job.edges[e].dst
            if d not in seen:
                seen.add(d)
                todo.append(d)
    return seen


#: replica rows compared on the card at a time
_PAIRS_AT_ONCE = 16


def replica_mismatches(ctx, flats=None) -> int:
    """Every replica of each owner subtask read back, held to 0: the
    owners are ``flats`` and the owners of the replicas they hold (every
    subtask where ``flats`` is None). Counts, for each owner, the holders
    it lacks in each downstream vertex (``replication_factor`` distinct
    subtasks, or all of a narrower vertex), and each replica row whose
    head, tail or epoch index differs from its owner's log, or whose
    retained rows ``[tail, head)`` do."""
    r = ctx.runner
    job, plan = r.job, r.plan
    k = ctx.config["replication_factor"]
    if flats is None:
        owners = set(range(job.total_subtasks()))
    else:
        owners = set(flats) | {plan.pairs[x][0] for f in flats
                               for x in plan.replicas_held_by(f)}
    bad = 0
    pairs = []
    for o in sorted(owners):
        rows = plan.replicas_of(o)
        pairs += [(x, o) for x in rows]
        for d in _downstream(job, _vertex(job, o)):
            held = {plan.pairs[x][1] for x in rows
                    if _vertex(job, plan.pairs[x][1]) == d}
            bad += max(0, min(k, job.vertices[d].parallelism) - len(held))
    c = r.executor.carry
    logs, reps = c.logs, c.replicas
    cap = logs.rows.shape[-2]
    dev = logs.rows.device
    ar = torch.arange(cap, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, len(pairs), _PAIRS_AT_ONCE):
        ri, oi = (torch.as_tensor(x, device=dev) for x in zip(
            *pairs[i:i + _PAIRS_AT_ONCE]))
        off = torch.zeros(len(ri), dtype=torch.bool, device=dev)
        for f in ("head", "tail", "epoch_starts", "epoch_base",
                  "latest_epoch"):
            a, b = getattr(logs, f)[oi], getattr(reps, f)[ri]
            off |= (a != b).reshape(len(ri), -1).any(1)
        tail = logs.tail[oi].long()
        pos = (tail[:, None] + ar) & (cap - 1)
        live = ar < (logs.head[oi].long() - tail)[:, None]
        diff = (logs.rows[oi[:, None], pos] != reps.rows[ri[:, None], pos])
        off |= (diff.any(-1) & live).any(1)
        total += off.sum()
    return bad + int(total)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def capture(ctx) -> Dict:
    """Host copies of what the run produced, for :func:`compare`."""
    ex = ctx.runner.executor
    c = ex.carry
    cfg = ctx.config
    steps = ex._steps_executed
    rng = ctx.rng("ring_samples")
    # The backlog's steps: the span the last completed checkpoint's
    # rings still hold.
    lo = max(steps - cfg["steps_per_epoch"] * cfg["pending_epochs"], 0)
    rings = {}
    for name in ("source", "source-r", "join"):
        ring = c.out_rings[ex.compiled.ring_index[VERTICES.index(name)]]
        n_ring = ring.keys.shape[0]
        size = ctx.cell.get("sink_samples" if name == "join"
                            else "ring_samples", 8)
        picks = sorted(set(int(s) for s in rng.integers(
            max(lo, steps - n_ring), steps, size=size)))
        pos = torch.as_tensor([s & (n_ring - 1) for s in picks],
                              device=ring.keys.device)
        rings[name] = (picks, [_np(x[pos]) for x in (
            ring.keys, ring.values, ring.timestamps, ring.valid)])
    job = ctx.runner.job
    edges = {side: [_np(x) for x in c.edge_bufs[e]] for side, e in zip(
        ("left", "right"), job.in_edges(VERTICES.index("join")))}
    return {
        "steps": steps,
        "state": _state_np(c.op_states),
        "edges": edges,
        "rings": rings,
        "sink": sorted(ctx.join_tap.kept.items()),
        "recovered": ctx.results.get("recovered", []),
        "services": ctx.results.get("service_mismatches", 0),
        "replicas": (ctx.results.get("replica_mismatches", 0)
                     + replica_mismatches(ctx)),
    }


def snapshot_state(ctx) -> Dict[str, np.ndarray]:
    """The operator state now (a recovery's recovered state)."""
    return _state_np(ctx.runner.executor.carry.op_states)


def _state_np(op_states) -> Dict[str, np.ndarray]:
    src, src_r, join, snk = op_states
    out = {"source": _np(src["seq"]), "source_r": _np(src_r["seq"]),
           "sink_emitted": _np(snk["emitted"])}
    out.update({k: _np(join[k]) for k in ("lv", "lt", "lm", "cursor")})
    return {k: v.astype(np.int64) for k, v in out.items()}


def reference(ctx, steps: int, device) -> IntervalJoin:
    cfg = ctx.config
    streams = [SyntheticStream(ctx.stream_inputs[k], cfg["batch"],
                               cfg["vocab"], device)
               for k in ("seq0", "seq0_r")]
    return IntervalJoin(*streams, cfg["parallelism"], cfg["vocab"],
                        cfg["num_key_groups"], cfg["join_window"],
                        cfg["join_interval"], steps)


def _state_diff(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                keys) -> int:
    return sum(int(np.count_nonzero(got[k] != want[k])) for k in keys)


def _records(k, v, t, m) -> List[tuple]:
    return sorted(zip(k[m].tolist(), v[m].tolist(), t[m].tolist()))


def _multiset_diff(a: List[tuple], b: List[tuple]) -> int:
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def compare(ctx, cap: Dict, device) -> Dict[str, int]:
    """Mismatch counts, each held to 0: the sources' draws (positions and
    sampled logged steps), the keyBy routing of both edges' last step,
    the join's rings and cursors, the sink's sampled output and emitted
    counts with the join's sampled output ring, the replicas read back
    (around every kill and at the window's end), every recovered state,
    and the external calls served again from the recovered rows."""
    steps = cap["steps"]
    ref = reference(ctx, steps, device)
    want = ref.state_at(steps)
    got = cap["state"]
    out = {}
    draws = _state_diff(got, want, ["source", "source_r"])
    for name, side in (("source", "left"), ("source-r", "right")):
        picks, (keys, vals, ts, valid) = cap["rings"][name]
        for i, s in enumerate(picks):
            draws += int(np.count_nonzero(keys[i] != ref.drawn(s, side)))
            draws += int(np.count_nonzero(~valid[i]))
            draws += int(np.count_nonzero(vals[i] != 1))
            draws += int(np.count_nonzero(ts[i] != s))
    out["draws"] = draws
    routing = 0
    for side, (ekeys, _, _, evalid) in cap["edges"].items():
        for q, want_q in enumerate(ref.routed(steps - 1, side)):
            n = min(len(want_q), ekeys.shape[1])
            routing += len(want_q) - n      # records the edge had no slot for
            routing += int(np.count_nonzero(ekeys[q, :n] != want_q[:n]))
            routing += int(np.count_nonzero(~evalid[q, :n]))
            routing += int(np.count_nonzero(evalid[q, n:]))
    out["routing"] = routing
    out["join_state"] = _state_diff(got, want, ["lv", "lt", "lm", "cursor"])
    sink = _state_diff(got, want, ["sink_emitted"])
    for s, (k, v, t, m) in cap["sink"]:
        exp = ref.sink_records(s)
        sink += sum(_multiset_diff(_records(k[q], v[q], t[q], m[q]), exp[q])
                    for q in range(k.shape[0]))
    picks, (k, v, t, m) = cap["rings"]["join"]
    for i, s in enumerate(picks):
        exp = ref.join_records(s)
        sink += sum(_multiset_diff(_records(k[i, q], v[i, q], t[i, q],
                                            m[i, q]), exp[q])
                    for q in range(k.shape[1]))
    out["sink"] = sink
    out["replicas"] = int(cap["replicas"])
    if cap["recovered"]:
        cache = {}
        out["recovered"] = sum(
            _state_diff(st, cache.setdefault(s, ref.state_at(s)), STATE_KEYS)
            for s, st in cap["recovered"])
        out["services"] = int(cap["services"])
    return out
