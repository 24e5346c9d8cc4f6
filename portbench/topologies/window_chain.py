"""The window chain on the port: source -> keyBy -> tumbling window count
-> keyBy -> keyed running sum -> sink, under a ``ClusterRunner`` with
causal logging, determinant replication, the in-flight rings and a
checkpoint at every epoch fence.

``build`` makes the job, its inputs and its runner from the seed;
``capture`` copies to the host what the timed path produced (state,
the last routed edge, the source's logged draws, the sampled sink
outputs, the recovered states); ``compare`` holds all of it to the plain
reference (``reference/window_chain.py``), exact, so every limit is 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.window_chain import (PoolStream, SyntheticStream,
                                              WindowChain)

#: the job's vertices, in id order
VERTICES = ("source", "window", "reduce", "sink")


def records_per_step(cfg: Dict) -> int:
    return cfg["parallelism"] * cfg["batch"]


def build(ctx) -> None:
    """The job and its runner on ``ctx.device``; sets ``ctx.runner``,
    ``ctx.stream_inputs`` (what the reference needs of the inputs) and,
    for a fed source, ``ctx.feed``."""
    from clonos_tpu_torch.api.environment import StreamEnvironment
    from clonos_tpu_torch.runtime.cluster import ClusterRunner
    from portbench.feeds import PacedFeed, make_pool
    cfg = ctx.config
    p, b, vocab = cfg["parallelism"], cfg["batch"], cfg["vocab"]
    env = StreamEnvironment(name=ctx.config_name,
                            num_key_groups=cfg["num_key_groups"],
                            default_edge_capacity=cfg["edge_capacity"])
    if cfg["source_kind"] == "synthetic":
        src = env.synthetic_source(vocab=vocab, batch_size=b, parallelism=p,
                                   name="source")
    else:
        src = env.host_source(batch_size=b, parallelism=p, name="source")
    (src.key_by()
        .window_count(num_keys=vocab, window_size=cfg["fire_interval_steps"],
                      name="window")
        .key_by().reduce(num_keys=vocab, name="reduce")
        .sink(name="sink"))
    job = env.build()
    rng = ctx.rng("inputs")
    runner = ClusterRunner(
        job, steps_per_epoch=cfg["steps_per_epoch"],
        log_capacity=cfg["log_capacity"], max_epochs=cfg["max_epochs"],
        inflight_ring_steps=cfg["inflight_ring_steps"],
        block_steps=cfg["block_steps"], logical_time=cfg["logical_time"],
        replication_factor=cfg["replication_factor"],
        overlap_epoch=cfg["overlap_epoch"],
        seed=int(rng.integers(0, 2 ** 31)), device=ctx.device)
    ex = runner.executor
    if cfg["source_kind"] == "synthetic":
        # The generator resumes from seeded positions, as a source
        # restarted at an offset would.
        seq0 = rng.integers(0, 2 ** 30, size=p, dtype=np.int64)
        c = ex.carry
        ops = list(c.op_states)
        ops[0] = {"seq": torch.as_tensor(seq0.astype(np.int32),
                                         device=ex.device)}
        ex.carry = c._replace(op_states=tuple(ops))
        ctx.stream_inputs = {"seq0": seq0}
    else:
        pool = make_pool(rng, p, cfg["pool_records"], vocab)
        ctx.feed = PacedFeed(pool)
        ex.register_feed(0, ctx.feed)
        ctx.stream_inputs = {"pool": pool}
    ctx.runner = runner
    ctx.sink_tap = SinkTap(ctx, cfg["fire_interval_steps"],
                           ctx.cell.get("sink_samples", 16))
    ex.on_block_outputs = ctx.sink_tap


class SinkTap:
    """The executor's per-block output hook: keeps a seeded reservoir of
    the sink's output at the steps where fired windows reach it (and the
    newest such step), once armed at the window's start."""

    def __init__(self, ctx, window: int, size: int):
        self.ctx = ctx
        self.window = window
        self.size = size
        self.rng = ctx.rng("sink_samples")
        self.armed = False
        self.seen = 0
        self.kept: Dict[int, tuple] = {}
        self.newest = None

    def __call__(self, outs, epoch: int) -> None:
        if not self.armed:
            return
        ex = self.ctx.runner.executor
        out = outs.sinks[VERTICES.index("sink")]
        k = out.keys.shape[0]
        s1 = ex._steps_executed
        s0 = s1 - k
        w = self.window
        first = max(s0, w + 2)
        first += (2 - first) % w
        for s in range(first, s1, w):
            row = tuple(x[s - s0].clone() for x in out)
            slot = self.seen if self.seen < self.size else int(
                self.rng.integers(self.seen + 1))
            self.seen += 1
            if slot < self.size:
                self.kept[slot] = (s, row)
            self.newest = (s, row)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def capture(ctx) -> Dict:
    """Host copies of what the timed path produced, for :func:`compare`."""
    r = ctx.runner
    ex = r.executor
    c = ex.carry
    cfg = ctx.config
    steps = ex._steps_executed
    ring = c.out_rings[ex.compiled.ring_index[VERTICES.index("source")]]
    n_ring = ring.keys.shape[0]
    # The source's logged draws: a seeded sample of the last epoch's
    # steps (the ring's span the last checkpoint still covers).
    spe = cfg["steps_per_epoch"]
    lo = max(steps - min(spe, n_ring), 0)
    picks = sorted(set(int(s) for s in ctx.rng("ring_samples").integers(
        lo, steps, size=ctx.cell.get("ring_samples", 8))))
    pos = torch.as_tensor([s & (n_ring - 1) for s in picks],
                          device=ring.keys.device)
    samples = [s for s in ctx.sink_tap.kept.values()]
    if ctx.sink_tap.newest is not None:
        samples.append(ctx.sink_tap.newest)
    return {
        "steps": steps,
        "state": _state_np(c.op_states, cfg["source_kind"]),
        "edge0": [_np(x) for x in c.edge_bufs[0]],
        "ring_steps": picks,
        "ring": [_np(x[pos]) for x in (ring.keys, ring.values,
                                        ring.timestamps, ring.valid)],
        "sink": [(s, [_np(x) for x in row]) for s, row in samples],
        "recovered": ctx.results.get("recovered", []),
    }


def snapshot_state(ctx) -> Dict[str, np.ndarray]:
    """The operator state now (a kill cycle's recovered state)."""
    return _state_np(ctx.runner.executor.carry.op_states,
                     ctx.config["source_kind"])


def _state_np(op_states, source_kind: str) -> Dict[str, np.ndarray]:
    src, win, red, snk = op_states
    pos = src["seq"] if source_kind == "synthetic" else src["offset"]
    return {"source": _np(pos).astype(np.int64),
            "window_acc": _np(win["acc"]).astype(np.int64),
            "window_id": _np(win["window"]).astype(np.int64),
            "reduce_acc": _np(red["acc"]).astype(np.int64),
            "sink_emitted": _np(snk["emitted"]).astype(np.int64)}


def reference(ctx, steps: int, device) -> WindowChain:
    cfg = ctx.config
    if cfg["source_kind"] == "synthetic":
        stream = SyntheticStream(ctx.stream_inputs["seq0"], cfg["batch"],
                                 cfg["vocab"], device)
    else:
        stream = PoolStream(ctx.stream_inputs["pool"], cfg["batch"], device)
    return WindowChain(stream, cfg["parallelism"], cfg["vocab"],
                       cfg["num_key_groups"], cfg["fire_interval_steps"],
                       steps)


def _state_diff(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                keys) -> int:
    return sum(int(np.count_nonzero(got[k] != want[k])) for k in keys)


def compare(ctx, cap: Dict, device) -> Dict[str, int]:
    """Mismatch counts, each held to 0: the source's draws (its position
    and sampled logged steps), the keyBy routing of the last step, the
    window's counts, the reduce's totals, the sink's sampled outputs and
    emitted counts, and every recovered state."""
    steps = cap["steps"]
    ref = reference(ctx, steps, device)
    want = ref.state_at(steps)
    got = cap["state"]
    out = {}
    draws = _state_diff(got, want, ["source"])
    keys, vals, ts, valid = cap["ring"]
    for i, s in enumerate(cap["ring_steps"]):
        draws += int(np.count_nonzero(keys[i] != ref.drawn(s)))
        draws += int(np.count_nonzero(~valid[i]))
        draws += int(np.count_nonzero(vals[i] != 1))
        draws += int(np.count_nonzero(ts[i] != s))
    out["draws"] = draws
    ekeys, _, _, evalid = cap["edge0"]
    routing = 0
    for q, want_q in enumerate(ref.routed(steps - 1)):
        n = min(len(want_q), ekeys.shape[1])
        routing += len(want_q) - n          # records the edge had no slot for
        routing += int(np.count_nonzero(ekeys[q, :n] != want_q[:n]))
        routing += int(np.count_nonzero(~evalid[q, :n]))
        routing += int(np.count_nonzero(evalid[q, n:]))
    out["routing"] = routing
    out["window"] = _state_diff(got, want, ["window_acc", "window_id"])
    out["reduce"] = _state_diff(got, want, ["reduce_acc"])
    sink = _state_diff(got, want, ["sink_emitted"])
    for s, (k, v, t, m) in cap["sink"]:
        exp = ref.sink_records(s)
        for q in range(k.shape[0]):
            have = sorted(zip(k[q][m[q]].tolist(), v[q][m[q]].tolist(),
                              t[q][m[q]].tolist()))
            sink += _multiset_diff(have, exp[q])
    out["sink"] = sink
    if cap["recovered"]:
        out["recovered"] = sum(
            _state_diff(st, ref.state_at(s), st.keys())
            for s, st in cap["recovered"])
    return out


def _multiset_diff(a: List[tuple], b: List[tuple]) -> int:
    from collections import Counter
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())
