"""Single-process cluster with failure injection and local recovery.

Port of the quick-start surface of ``clonos_tpu/runtime/cluster.py``:
``run_epoch`` (run to the fence, checkpoint in memory, complete it,
truncate), ``step``, ``inject_failure`` and ``recover`` for one failed
subtask of a keyed vertex with a single input edge (a window or a
reduce). Recovery restores the checkpointed operator row, takes the
failed subtask's determinants from its downstream replicas, re-routes the
upstream in-flight ring into the failed lane, replays through
:class:`~clonos_tpu_torch.causal.recovery.LogReplayer`, verifies every
output cut, and patches back the operator row, the log row, the ring lane
and the record count — bit-identical to a run that never failed.

Source and sink failures, concurrent failures, the recovery FSM, durable
checkpoints and standby bootstrap come with later slices.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.causal import recovery as rec
from clonos_tpu_torch.causal.replication import merge_determinant_responses
from clonos_tpu_torch.graph.job_graph import JobGraph, PartitionType
from clonos_tpu_torch.inflight import log as ifl
from clonos_tpu_torch.parallel import routing
from clonos_tpu_torch.runtime.executor import (DETS_PER_STEP, JobCarry,
                                               LeanSnapshot, LocalExecutor)
from clonos_tpu_torch.utils.tree import tree_map


class OverflowError_(RuntimeError):
    """A log or ring overflowed: recovery state was clobbered."""


@dataclasses.dataclass
class RecoveryReport:
    failed_subtasks: Tuple[int, ...]
    from_epoch: int
    steps_replayed: int
    determinants_replayed: int
    records_replayed: int
    recovery_ms: float
    results: Tuple[rec.ReplayResult, ...] = ()


class ClusterRunner:
    """Drives epochs; at every fence takes a lean snapshot, completes the
    checkpoint and truncates the logs and rings."""

    def __init__(self, job: JobGraph, steps_per_epoch: int = 8,
                 recovery_block_steps: Optional[int] = None,
                 device="cuda", **executor_kw):
        self.job = job
        self.executor = LocalExecutor(job, steps_per_epoch=steps_per_epoch,
                                      device=device, **executor_kw)
        self.device = self.executor.device
        self.plan = self.executor.compiled.plan
        self.failed: Set[int] = set()
        self.global_step = 0
        #: epoch -> global step at its start
        self._fence_step = {0: 0}
        #: (checkpoint id, snapshot) of the latest completed checkpoint
        self.latest_checkpoint: Optional[Tuple[int, LeanSnapshot]] = None
        self.reports: List[RecoveryReport] = []
        self._source_flats = [
            job.subtask_base(v.vertex_id) + s
            for v in job.vertices if not job.in_edges(v.vertex_id)
            for s in range(v.parallelism)]
        compiled = self.executor.compiled
        self._recovery_ch = min(
            recovery_block_steps or self.executor.block_steps,
            compiled.inflight_ring_steps,
            compiled.log_capacity // DETS_PER_STEP)

    # --- live path ----------------------------------------------------------

    def run_epoch(self) -> None:
        """Run to the next epoch fence, checkpoint and complete it."""
        if self.failed:
            raise rec.RecoveryError(
                f"cannot run with failed subtasks {sorted(self.failed)}; "
                f"call recover() first")
        ex = self.executor
        closed = ex.epoch_id
        n = ex.steps_per_epoch - ex.step_in_epoch
        ex.run_epoch()
        self.global_step += n
        self._fence_step[ex.epoch_id] = self.global_step
        violations = ex.check_overflow()
        if violations:
            raise OverflowError_("; ".join(violations))
        snap = ex.lean_snapshot()
        # Every source logs the checkpoint-trigger arrival (after the
        # snapshot, so the checkpointed log heads stay at the fence).
        if self._source_flats:
            t_ms = (ex.step_input_history[-1][0]
                    if ex.step_input_history else 0)
            ex.append_async_many(
                self._source_flats, det.SourceCheckpointDeterminant(
                    record_count=ex.global_record_stamp(),
                    checkpoint_id=closed, timestamp=t_ms))
        self.latest_checkpoint = (closed, snap)
        ex.notify_checkpoint_complete(closed)

    def step(self) -> None:
        if self.failed:
            raise rec.RecoveryError("failed subtasks present; recover() first")
        self.executor.step()
        self.global_step += 1

    # --- failure injection --------------------------------------------------

    def _vertex_of(self, flat: int) -> Tuple[int, int]:
        for v in self.job.vertices:
            base = self.job.subtask_base(v.vertex_id)
            if base <= flat < base + v.parallelism:
                return v.vertex_id, flat - base
        raise ValueError(f"no subtask {flat}")

    def inject_failure(self, flat_subtasks: Sequence[int]) -> None:
        """Kill subtasks: zero their operator-state row, causal log row,
        held replica rows and their lane of the vertex's in-flight ring."""
        ex = self.executor
        compiled = ex.compiled
        c = ex.carry
        for flat in flat_subtasks:
            self.failed.add(flat)
            vid, sub = self._vertex_of(flat)
            fresh = clog.create(compiled.log_capacity, compiled.max_epochs,
                                self.device)

            def put(stack, rows, one):
                stack = stack.clone()
                stack[rows] = one
                return stack

            ops = list(c.op_states)
            ops[vid] = tree_map(lambda x: put(x, sub, 0), ops[vid])
            logs = tree_map(lambda s, fr: put(s, flat, fr), c.logs, fresh)
            held = self.plan.replicas_held_by(flat)
            replicas = c.replicas
            if held:
                idx = torch.tensor(held, dtype=torch.int64,
                                   device=self.device)
                replicas = tree_map(lambda s, fr: put(s, idx, fr),
                                    c.replicas, fresh)
            rings = list(c.out_rings)
            if vid in compiled.ring_index:
                ri = compiled.ring_index[vid]
                el = rings[ri]
                rings[ri] = el._replace(
                    keys=put(el.keys, (slice(None), sub), 0),
                    values=put(el.values, (slice(None), sub), 0),
                    timestamps=put(el.timestamps, (slice(None), sub), 0),
                    valid=put(el.valid, (slice(None), sub), False))
            c = c._replace(op_states=tuple(ops), logs=logs,
                           replicas=replicas, out_rings=tuple(rings),
                           record_counts=put(c.record_counts, flat, 0))
        ex.carry = c

    # --- recovery -----------------------------------------------------------

    def recover(self) -> RecoveryReport:
        """Recover the one failed subtask (a keyed vertex with one input
        edge and downstream holders of its log) bit-identically."""
        if not self.failed:
            raise rec.RecoveryError("no failed subtasks")
        if len(self.failed) != 1:
            raise rec.RecoveryError(
                f"one failed subtask per recover() in this port; got "
                f"{sorted(self.failed)}")
        if self.latest_checkpoint is None:
            raise rec.RecoveryError(
                "no completed checkpoint to restore from")
        t0 = _time.monotonic()
        (flat,) = tuple(self.failed)
        vid, sub = self._vertex_of(flat)
        v = self.job.vertices[vid]
        in_edges = self.job.in_edges(vid)
        if len(in_edges) != 1 or not self.job.out_edges(vid):
            raise rec.RecoveryError(
                f"subtask {flat}: only vertices with one input edge and a "
                f"downstream consumer recover in this port (source and sink "
                f"recovery come with a later slice)")
        ex = self.executor
        compiled = ex.compiled
        ckpt_id, snap = self.latest_checkpoint
        from_epoch = ckpt_id + 1
        fence = self._fence_step[from_epoch]
        n_steps = self.global_step - fence
        carry = ex.carry

        # Determinant request to every surviving holder of the log.
        holders = [r for r, (o, h) in enumerate(self.plan.pairs)
                   if o == flat and h not in self.failed]
        if not holders and n_steps > 0:
            raise rec.RecoveryError(
                f"subtask {flat}: no surviving replica holds its "
                f"determinant log")
        responses = []
        for r in holders:
            one = tree_map(lambda x: x[r], carry.replicas)
            buf, count, start = clog.get_determinants(
                one, from_epoch, compiled.log_capacity)
            responses.append((buf[:int(count)].cpu().numpy(), int(start)))
        rows, start = merge_determinant_responses(responses)

        input_steps = self._replay_inputs(carry, snap, in_edges[0], sub,
                                          fence, n_steps)
        slot_keys = compiled.consumer_slot_keys(vid)
        replayer = rec.LogReplayer(
            v.operator, v.parallelism, block_steps=self._recovery_ch,
            in_slot_keys=(slot_keys[sub:sub + 1]
                          if slot_keys is not None else None))
        plan = rec.ReplayPlan(
            vertex_id=vid, subtask=sub, flat_subtask=flat,
            from_epoch=from_epoch, input_steps=input_steps, det_rows=rows,
            det_start=start, checkpoint_op_state=snap.op_states[vid],
            n_steps=n_steps)
        result = replayer.replay(plan, self.device)
        result.verify()
        rebuilt = result.rebuilt_log_rows
        if not np.array_equal(rebuilt, rows[:rebuilt.shape[0]]):
            raise rec.RecoveryError(
                f"subtask {flat}: replayed determinant stream diverges "
                f"from the recovered log")
        carry = self._patch(carry, snap, vid, sub, flat, result, rebuilt,
                            from_epoch, fence, n_steps)
        # Replica rows the failed subtask held: replicas equal their
        # owner's log by construction, so copy the owner's row.
        held = self.plan.replicas_held_by(flat)
        if held:
            ri = torch.tensor(held, dtype=torch.int64, device=self.device)
            oi = torch.tensor([self.plan.pairs[r][0] for r in held],
                              dtype=torch.int64, device=self.device)

            def copy_rows(s, lg):
                s = s.clone()
                s[ri] = lg[oi]
                return s

            carry = carry._replace(replicas=tree_map(
                copy_rows, carry.replicas, carry.logs))
        ex.carry = carry
        self.failed.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        report = RecoveryReport(
            failed_subtasks=(flat,), from_epoch=from_epoch,
            steps_replayed=n_steps, determinants_replayed=len(rows),
            records_replayed=result.records_replayed,
            recovery_ms=(_time.monotonic() - t0) * 1e3, results=(result,))
        self.reports.append(report)
        return report

    def _replay_inputs(self, carry: JobCarry, snap: LeanSnapshot, eidx: int,
                       sub: int, fence: int, n_steps: int
                       ) -> List[RecordBatch]:
        """The failed consumer's lost inputs on edge ``eidx``: the
        checkpointed depth-1 edge buffer (its input at the first lost step)
        followed by the upstream ring's outputs re-routed into its lane.

        Windows are uniform ``[ch]`` steps: window i covers absolute steps
        ``[fence-1+i*ch, fence-1+(i+1)*ch)``; slot 0 of window 0 is the
        dead pre-fence slot, masked and replaced by the edge buffer."""
        if n_steps <= 0:
            return []
        e = self.job.edges[eidx]
        compiled = self.executor.compiled
        dst_p = self.job.vertices[e.dst].parallelism
        ch = self._recovery_ch
        el = carry.out_rings[compiled.ring_index[e.src]]
        tail, head = int(el.tail), int(el.head)
        ring_lo = max(tail, head - el.ring_steps)
        rr = int(snap.rr_offsets[eidx][0])
        need = n_steps
        lead = 1
        idx = torch.arange(ch, dtype=torch.int32, device=self.device)
        chunks = []
        for i in range(-(-n_steps // ch)):
            h_start = fence - 1 + i * ch
            lo_real = max(h_start, fence)
            h_need = max(min(h_start + ch, fence - 1 + n_steps) - lo_real, 0)
            if not (lo_real >= ring_lo and head - lo_real >= h_need):
                raise rec.RecoveryError(
                    f"in-flight ring of vertex {e.src} no longer holds steps "
                    f"[{lo_real}, {lo_real + h_need}) (spill comes with a "
                    f"later slice)")
            raw = ifl.slice_steps_at(el, h_start, ch)
            live = (idx >= lead) & (idx < min(max(need, 0), ch))
            raw = raw._replace(valid=raw.valid & live[:, None, None])
            if eidx in compiled.static_route:
                r, _ = compiled.static_route[eidx].apply(raw)
                lane = RecordBatch(*(x[:, sub] for x in r))
            elif e.partition == PartitionType.HASH:
                lane = routing.route_hash_block_lane(
                    raw, sub, dst_p, self.job.num_key_groups, e.capacity)
            elif e.partition == PartitionType.FORWARD:
                lane = routing.route_forward_block_lane(raw, sub, e.capacity)
            elif e.partition == PartitionType.REBALANCE:
                counts = raw.count().sum(dim=1, dtype=torch.int32)
                offs = rr + torch.cumsum(counts, 0, dtype=torch.int32) \
                    - counts
                lane = routing.route_rebalance_block_lane(
                    raw, sub, dst_p, e.capacity, offs)
            else:
                lane = routing.route_broadcast_block_lane(raw, sub,
                                                          e.capacity)
            rr += int(raw.count().sum())
            need -= ch
            lead = 0
            if i == 0:
                lane = RecordBatch(*(torch.cat([b[sub][None], x[1:]])
                                     for x, b in zip(lane,
                                                     snap.edge_bufs[eidx])))
            chunks.append(lane)
        return chunks

    def _patch(self, carry: JobCarry, snap: LeanSnapshot, vid: int,
               sub: int, flat: int, result: rec.ReplayResult,
               det_rows: np.ndarray, from_epoch: int, fence: int,
               n_steps: int) -> JobCarry:
        """Graft the rebuilt subtask back into the live carry."""
        compiled = self.executor.compiled
        ck_head = int(snap.log_heads[flat])
        n = det_rows.shape[0]
        # The epoch->offset index died with the task; rebuild it from the
        # fence-step ledger. Sync blocks anchor at TIMESTAMP rows; rows
        # appended in an epoch's roll gap belong to the new epoch.
        ts_pos = (det.sync_anchors(det_rows) if n > 0
                  else np.zeros((0,), np.int64))
        me = compiled.max_epochs
        starts = np.zeros((me,), np.int32)
        mask = np.zeros((me,), bool)
        latest = 0
        for e in range(from_epoch, self.executor.epoch_id + 1):
            if e not in self._fence_step:
                continue
            step_i = self._fence_step[e] - fence
            gap = self.executor.roll_gap_async.get((flat, e), 0)
            if step_i == 0:
                off = ck_head
            elif step_i < len(ts_pos):
                off = ck_head + int(ts_pos[step_i]) - gap
            else:
                off = ck_head + n - gap
            starts[e % me] = off
            mask[e % me] = True
            latest = max(latest, e)
        dev = self.device
        restored = clog.create(compiled.log_capacity, me, dev)
        base = torch.tensor(ck_head, dtype=torch.int32, device=dev)
        restored = restored._replace(head=base, tail=base)
        if n > 0:
            restored = clog.append(restored,
                                   torch.from_numpy(det_rows).to(dev), n)
        restored = restored._replace(
            epoch_starts=torch.where(torch.from_numpy(mask).to(dev),
                                     torch.from_numpy(starts).to(dev),
                                     restored.epoch_starts),
            latest_epoch=restored.latest_epoch.clamp(min=latest),
            epoch_base=restored.epoch_base.clamp(min=from_epoch))

        def put(stack, i, one):
            stack = stack.clone()
            stack[i] = one
            return stack

        ops = list(carry.op_states)
        ops[vid] = tree_map(lambda live, new: put(live, sub, new[0]),
                            ops[vid], result.op_state)
        rc = snap.record_counts[flat] + result.records_replayed
        carry = carry._replace(
            op_states=tuple(ops),
            logs=tree_map(lambda s, r: put(s, flat, r), carry.logs,
                          restored),
            record_counts=put(carry.record_counts, flat, rc))
        # Rebuild the failed producer's lane of its in-flight ring from the
        # replayed outputs, at their original steps (only the last
        # ring_steps replayed steps fit). Written in place: the ring
        # belongs to the live carry being patched.
        if vid in compiled.ring_index and result.out_chunks is not None:
            el = carry.out_rings[compiled.ring_index[vid]]
            keep_from = fence + n_steps - min(n_steps, el.ring_steps)
            step = fence
            for chunk in result.out_chunks:
                m = chunk.keys.shape[0]
                steps = torch.arange(step, step + m, device=dev)
                keep = steps >= keep_from
                pos = steps[keep] & (el.ring_steps - 1)
                for ring_f, chunk_f in zip(
                        (el.keys, el.values, el.timestamps, el.valid),
                        chunk):
                    ring_f[pos, sub] = chunk_f[keep]
                step += m
        return carry
