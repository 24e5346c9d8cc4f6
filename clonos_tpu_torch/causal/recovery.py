"""Causal recovery: replay of one failed subtask from its recovered
determinants (port of the host-rows path of ``clonos_tpu/causal/recovery.py``).

The failed subtask's determinant rows, merged from its downstream
replicas, pin every nondeterministic step input (causal time, RNG draw)
and every output cut (BUFFER_BUILT). The replayer locates the per-step
sync blocks, runs the operator's block form over the lost step range —
the same step-batched code as the live path — and checks every replayed
output cut against the recorded one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.operators import BlockContext, Operator
from clonos_tpu_torch.api.records import RecordBatch, empty
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.utils.tree import tree_map


class RecoveryError(RuntimeError):
    pass


@dataclasses.dataclass
class ReplayPlan:
    """Everything a standby needs to replay one failed subtask."""

    vertex_id: int
    subtask: int                    # subtask index within the vertex
    flat_subtask: int               # global flat id (log row)
    from_epoch: int                 # first lost epoch
    #: the lost input batches as a list of block-sized chunks
    #: (RecordBatch [CH, cap] each), or None for self-generating sources
    input_steps: Optional[List[RecordBatch]]
    det_rows: np.ndarray            # int32[m, lanes] merged determinant rows
    det_start: int                  # absolute offset of det_rows[0]
    checkpoint_op_state: Any        # the vertex's checkpointed [P, ...] state
    n_steps: int                    # lost supersteps to replay
    #: False when the determinant rows were synthesized rather than
    #: recovered from replicas (no recorded output cuts to check against).
    verify_outputs: bool = True


@dataclasses.dataclass
class ReplayResult:
    op_state: Any                   # rebuilt [1, ...] subtask state
    rebuilt_log_rows: np.ndarray    # regenerated determinant rows
    emit_counts: np.ndarray         # [n] replayed output batch cuts
    expected_emits: np.ndarray      # [n] recorded BUFFER_BUILT values
    #: the replayed outputs as block-sized chunks [CH, out_cap] — the
    #: failed producer's in-flight log shard, rebuilt
    out_chunks: Optional[List[RecordBatch]]
    records_replayed: int
    #: async determinants found between the sync blocks:
    #: (step_index, determinant), fired before that replayed step
    async_events: List[Tuple[int, det.Determinant]] = dataclasses.field(
        default_factory=list)

    def verify(self) -> None:
        """Every replayed output cut must equal the recorded one."""
        got = np.asarray(self.emit_counts)
        want = np.asarray(self.expected_emits)
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            raise RecoveryError(
                f"replay diverged: output batch cuts differ at replayed "
                f"steps {bad.tolist()} (got {got[bad].tolist()}, recorded "
                f"{want[bad].tolist()})")


class LogReplayer:
    """Serves recorded determinants back and drives the replay of one
    failed subtask, ``block_steps`` steps per operator call."""

    #: per-step sync row layout (executor.DETS_PER_STEP appends)
    LAYOUT = (det.TIMESTAMP, det.RNG, det.ORDER, det.BUFFER_BUILT)

    def __init__(self, operator: Operator, parallelism: int,
                 block_steps: int = 512, in_slot_keys=None):
        self.operator = operator
        self.parallelism = parallelism
        self.block_steps = block_steps
        #: static [1, cap] input-slot keys when the failed subtask's input
        #: edge is statically routed (the live path's static gather).
        self.in_slot_keys = in_slot_keys

    def _replay_block(self, op_state, batches: RecordBatch,
                      times: torch.Tensor, rngs: torch.Tensor,
                      subtask: torch.Tensor):
        """One block of replay on the failed subtask alone (state and
        inputs with a leading subtask dim of 1)."""
        lift = RecordBatch(*(x[:, None] for x in batches))
        z = torch.zeros((), dtype=torch.int32, device=times.device)
        bctx = BlockContext(times=times, rng_bits=rngs, epoch=z, step0=z,
                            subtask=subtask.reshape(1))
        if self.in_slot_keys is not None and hasattr(
                self.operator, "process_block_static_keys"):
            new_state, out = self.operator.process_block_static_keys(
                op_state, lift, bctx, self.in_slot_keys)
        else:
            new_state, out = self.operator.process_block(op_state, lift,
                                                         bctx)
        out = RecordBatch(*(x[:, 0] for x in out))
        return new_state, out, out.count(), batches.count().sum()

    def _parse(self, rows: np.ndarray, n: int):
        """Locate the n per-step sync blocks (anchored at TIMESTAMP rows)
        and classify the rows between them as async determinants."""
        k = len(self.LAYOUT)
        tags = rows[:, det.LANE_TAG]
        ts_idx = det.sync_anchors(rows)
        if len(ts_idx) < n:
            raise RecoveryError(
                f"determinant log too short: need {n} superstep blocks, "
                f"have {len(ts_idx)}")
        ts_idx = ts_idx[:n]
        for i, tag in enumerate(self.LAYOUT[1:], start=1):
            pos = ts_idx + i
            if (pos >= rows.shape[0]).any() or not (tags[pos] == tag).all():
                raise RecoveryError(
                    "determinant stream has unexpected layout (corrupt or "
                    f"misaligned response at sync lane {i})")
        sync_pos = (ts_idx[:, None] + np.arange(k)[None, :]).ravel()
        used = int(sync_pos.max()) + 1 if n > 0 else 0
        # Trailing async rows (appended after the last replayed step).
        while used < rows.shape[0] and not (
                tags[used] == det.TIMESTAMP
                and rows[used, det.LANE_RC] == 0):
            used += 1
        mask = np.ones(used, bool)
        mask[sync_pos] = False
        async_pos = np.nonzero(mask)[0]
        async_step = np.searchsorted(ts_idx, async_pos)
        async_events = [(int(async_step[j]),
                         det.Determinant.unpack(rows[async_pos[j]]))
                        for j in range(len(async_pos))]
        return ts_idx, used, async_events

    def replay(self, plan: ReplayPlan, device) -> ReplayResult:
        n = plan.n_steps
        k = len(self.LAYOUT)
        rows = np.asarray(plan.det_rows)
        ts_idx, used, async_events = self._parse(rows, n)
        times_np = rows[ts_idx, det.LANE_P + 1].astype(np.int32)
        rngs_np = rows[ts_idx + 1, det.LANE_P].astype(np.int32)
        expected = rows[ts_idx + 3, det.LANE_P].astype(np.int32)
        times = torch.from_numpy(times_np).to(device)
        rngs = torch.from_numpy(rngs_np).to(device)

        state = tree_map(lambda x: x[plan.subtask:plan.subtask + 1],
                         plan.checkpoint_op_state)
        subtask = torch.tensor(plan.subtask, dtype=torch.int32,
                               device=device)
        out_chunks: List[RecordBatch] = []
        emit_chunks: List[torch.Tensor] = []
        consumed = torch.zeros((), dtype=torch.int64, device=device)
        ch = self.block_steps
        lo = 0
        ci = 0
        while lo < n:
            hi = min(lo + ch, n)
            if plan.input_steps is None:
                # Source vertex: regenerates its records; inputs are empty.
                chunk = empty((hi - lo, self.operator.out_capacity or 1),
                              device)
            else:
                # Runs the exact tail: the reference pads pad-safe
                # operators to the fixed block only to reuse a compiled
                # program, and padding leaves their state unchanged.
                chunk = RecordBatch(*(x[:hi - lo]
                                      for x in plan.input_steps[ci]))
            state, out, counts, cons = self._replay_block(
                state, chunk, times[lo:hi], rngs[lo:hi], subtask)
            out_chunks.append(out)
            emit_chunks.append(counts)
            consumed = consumed + cons
            lo = hi
            ci += 1
        emit_np = (torch.cat(emit_chunks).cpu().numpy() if emit_chunks
                   else np.zeros((0,), np.int32))

        # The rows the replayed run would log: sync blocks re-derived from
        # the replay, async rows spliced back at their recorded positions.
        blocks = np.zeros((n, k, det.NUM_LANES), np.int32)
        blocks[:, 0, det.LANE_TAG] = det.TIMESTAMP
        blocks[:, 0, det.LANE_P] = np.where(times_np < 0, -1, 0)
        blocks[:, 0, det.LANE_P + 1] = times_np
        blocks[:, 1, det.LANE_TAG] = det.RNG
        blocks[:, 1, det.LANE_P] = rngs_np
        blocks[:, 2, det.LANE_TAG] = det.ORDER
        blocks[:, 3, det.LANE_TAG] = det.BUFFER_BUILT
        blocks[:, 3, det.LANE_P] = emit_np
        rebuilt = rows[:used].copy()
        sync_pos = ts_idx[:, None] + np.arange(k)[None, :]
        rebuilt[sync_pos.ravel()] = blocks.reshape(n * k, det.NUM_LANES)

        records = (int(consumed) if plan.input_steps is not None
                   else int(emit_np.sum()))
        return ReplayResult(
            op_state=state, rebuilt_log_rows=rebuilt, emit_counts=emit_np,
            expected_emits=expected,
            out_chunks=out_chunks if out_chunks else None,
            records_replayed=records, async_events=async_events)
