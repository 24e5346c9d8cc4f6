"""Causal recovery: the standby-replay protocol (port of
``clonos_tpu/causal/recovery.py``).

- :class:`RecoveryManager` is the per-failed-subtask host FSM: STANDBY ->
  WAITING_CONNECTIONS -> WAITING_DETERMINANTS -> REPLAYING -> RUNNING.
- :class:`LogReplayer` runs the failed vertex's operator block form over
  the lost step range, fed by the failed subtask's determinants: either
  host rows merged from its downstream replicas (parsed here: sync blocks
  anchored at TIMESTAMP rows, async rows between them), or the device-
  resident stream of a clean replica (``ReplayPlan.det_device``: times,
  RNG draws and expected output cuts already extracted on the device, so
  the log body never crosses to the host). Every replayed output cut is
  checked against the recorded BUFFER_BUILT determinant; with
  ``defer_sync`` that check is a device flag and the consumed total a
  device scalar, both read in the cluster's one packed read at the end.
- :class:`AuditValidator` recomputes each replayed closed epoch's audit
  digest from the patched carry and compares it with the sealed ledger.

With a tracer configured (``obs/trace.py``) each FSM transition is a
``recovery.fsm`` instant and each validated epoch a
``recovery.audit.{match,divergence,missing}`` instant.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.api.operators import (BlockContext, Operator,
                                            TwoInputOperator)
from clonos_tpu_torch.api.records import RecordBatch, empty
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.obs.incident import get_incidents
from clonos_tpu_torch.obs.timeline import get_timeline
from clonos_tpu_torch.obs.trace import get_tracer
from clonos_tpu_torch.utils.tree import tree_leaves, tree_map


class RecoveryState(enum.Enum):
    STANDBY = "standby"
    WAITING_CONNECTIONS = "waiting_connections"
    WAITING_DETERMINANTS = "waiting_determinants"
    REPLAYING = "replaying"
    RUNNING = "running"


class RecoveryError(RuntimeError):
    pass


class AuditDivergenceError(RecoveryError):
    """A replayed epoch's recomputed audit digest does not match the
    sealed ledger entry (raised only under the ``abort`` policy)."""


class AuditValidator:
    """Recovery-time half of the epoch audit ledger (``obs/audit.py``):
    recomputes each replayed epoch's digest from the same extraction path
    the live seal used (``LocalExecutor.epoch_window`` +
    ``digest_epoch_window``) and compares it with the persisted ledger.
    ``events`` records one ``(kind, fields)`` pair per epoch, kind being
    ``recovery.audit.match`` / ``.divergence`` / ``.missing``."""

    def __init__(self, executor, ledger_entries: Sequence[dict],
                 on_divergence: str = "warn"):
        self.executor = executor
        # last-wins per epoch: a rebuilt runner re-seals replayed epochs
        self.ledger: Dict[int, dict] = {
            int(e["epoch"]): e for e in ledger_entries}
        self.on_divergence = on_divergence
        #: running totals — accurate even when the abort policy throws
        self.stats: Dict[str, int] = {"match": 0, "divergence": 0,
                                      "missing": 0}
        self.events: List[Tuple[str, Dict[str, Any]]] = []

    def validate(self, epochs: Sequence[int]) -> Dict[str, int]:
        """Validate the given replayed (closed) epochs against the
        ledger; raises :class:`AuditDivergenceError` on the first
        divergence under the abort policy."""
        from clonos_tpu_torch.obs import audit as _audit
        from clonos_tpu_torch.obs.digest import EpochDigest, diff as _diff
        tr = get_tracer()
        stats = self.stats

        def event(kind: str, **fields) -> None:
            self.events.append((kind, fields))
            tr.event(kind, **fields)

        for e in epochs:
            e = int(e)
            recomputed = _audit.digest_epoch_window(
                e, self.executor.epoch_window(e))
            entry = self.ledger.get(e)
            if entry is None:
                stats["missing"] += 1
                event("recovery.audit.missing", epoch=e)
                continue
            d = _diff(EpochDigest.from_entry(entry), recomputed)
            if d is None:
                stats["match"] += 1
                event("recovery.audit.match", epoch=e,
                      channels=len(recomputed.channels),
                      records=recomputed.record_count())
            else:
                stats["divergence"] += 1
                channel, reason = d
                event("recovery.audit.divergence", epoch=e,
                      channel=channel, reason=reason)
                # The replayed epoch went off-script: bundle the evidence
                # before the abort policy may tear recovery down (a no-op
                # while the incident plane is off).
                get_incidents().signal("audit.divergence", epoch=e,
                                       channel=channel, reason=reason,
                                       source="recovery-validator")
                if self.on_divergence == "abort":
                    raise AuditDivergenceError(
                        f"epoch {e} channel {channel}: {reason} — replay "
                        f"did not reproduce the original execution")
        return stats

    def recompute_entries(self, epochs: Sequence[int]) -> List[dict]:
        """The given epochs' digests recomputed from the current carry, as
        ledger entries, without validating them: what ``diff_ledgers``
        compares across two recovery modes."""
        from clonos_tpu_torch.obs import audit as _audit
        return [_audit.digest_epoch_window(
                    int(e), self.executor.epoch_window(int(e))).to_entry()
                for e in epochs]


@dataclasses.dataclass
class ReplayPlan:
    """Everything a standby needs to replay one failed subtask."""

    vertex_id: int
    subtask: int                    # subtask index within the vertex
    flat_subtask: int               # global flat id (log row)
    from_epoch: int                 # first lost epoch
    #: the lost input batches as a list of block-sized chunks (each a
    #: RecordBatch [CH, cap], or a (left, right) pair of them for a
    #: two-input vertex), or None for self-generating sources
    input_steps: Optional[List[Any]]
    det_rows: np.ndarray            # int32[m, lanes] merged determinant rows
    det_start: int                  # absolute offset of det_rows[0]
    checkpoint_op_state: Any        # the vertex's checkpointed [P, ...] state
    n_steps: int                    # lost supersteps to replay
    #: False when the determinant rows were synthesized rather than
    #: recovered from replicas (no recorded output cuts to check against).
    verify_outputs: bool = True
    #: Device-resident determinant stream of the clean fast path: (times,
    #: rngs, expected) int32 device tensors padded to the replayer's
    #: ``pad_steps``. When set, ``det_rows`` stays empty.
    det_device: Optional[Tuple[torch.Tensor, torch.Tensor,
                               torch.Tensor]] = None
    #: the subtask's row in ``checkpoint_op_state`` (default: ``subtask``;
    #: 0 when the state is already the one-subtask slice a rank of a
    #: sharded job received)
    state_row: Optional[int] = None


@dataclasses.dataclass
class ReplayResult:
    op_state: Any                   # rebuilt [1, ...] subtask state
    rebuilt_log_rows: np.ndarray    # regenerated determinant rows
    emit_counts: Any                # [n] replayed output batch cuts
    expected_emits: Any             # [n] recorded BUFFER_BUILT values
    #: the replayed outputs as block-sized chunks [CH, out_cap] — the
    #: failed producer's in-flight log shard, rebuilt
    out_chunks: Optional[List[RecordBatch]]
    records_replayed: int
    #: async determinants found between the sync blocks:
    #: (step_index, determinant), fired before that replayed step
    async_events: List[Tuple[int, det.Determinant]] = dataclasses.field(
        default_factory=list)
    #: True when rebuilt_log_rows is a view of the recovered rows (no
    #: async rows, real recovered determinants): verify() already checks
    #: the only re-derived lane, so callers must not re-compare them.
    rebuilt_is_view: bool = False
    #: Deferred-sync replay: nothing crossed to the host; emit/expected
    #: stay device tensors, records_replayed is -1 until the cluster's
    #: final packed read resolves it from ``consumed_d``, and the
    #: output-cut check is the device flag ``verify_ok_d``.
    deferred: bool = False
    verify_ok_d: Optional[torch.Tensor] = None
    consumed_d: Optional[torch.Tensor] = None

    def verify(self) -> None:
        """Every replayed output cut must equal the recorded one."""
        got = _host(self.emit_counts)
        want = _host(self.expected_emits)
        if not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0]
            raise RecoveryError(
                f"replay diverged: output batch cuts differ at replayed "
                f"steps {bad.tolist()} (got {got[bad].tolist()}, recorded "
                f"{want[bad].tolist()})")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _device.to_numpy(x)
    return np.asarray(x)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0))


def plan_restore_nbytes(plan: ReplayPlan) -> int:
    """Bytes this plan's shard-local restore moves: the failed subtask's
    row of the checkpointed vertex state, the recovered determinant
    stream and the replayed input windows."""
    total = 0
    for leaf in tree_leaves(plan.checkpoint_op_state):
        n0 = leaf.shape[0] if len(getattr(leaf, "shape", ())) > 0 else 1
        total += _nbytes(leaf) // max(1, n0)
    if plan.det_rows is not None and getattr(plan.det_rows, "size", 0):
        total += int(plan.det_rows.nbytes)
    elif plan.det_device is not None:
        total += sum(_nbytes(x) for x in plan.det_device)
    if plan.input_steps is not None:
        total += sum(_nbytes(x) for x in tree_leaves(plan.input_steps))
    return total


class LogReplayer:
    """Serves recorded determinants back and drives the replay of one
    failed subtask, ``block_steps`` steps per operator call."""

    #: per-step sync row layout (executor.DETS_PER_STEP appends)
    LAYOUT = (det.TIMESTAMP, det.RNG, det.ORDER, det.BUFFER_BUILT)

    def __init__(self, operator: Operator, parallelism: int,
                 block_steps: int = 512, in_slot_keys=None,
                 pad_steps: Optional[int] = None):
        self.operator = operator
        self.parallelism = parallelism
        self.block_steps = block_steps
        #: the device stream's fixed length (the recoverable window, a
        #: whole number of blocks)
        self.pad_steps = (-(-pad_steps // block_steps) * block_steps
                          if pad_steps else None)
        #: static [1, cap] input-slot keys when the failed subtask's input
        #: edge is statically routed (the live path's static gather).
        self.in_slot_keys = in_slot_keys

    def _replay_block(self, op_state, batches, times: torch.Tensor,
                      rngs: torch.Tensor, subtask: torch.Tensor,
                      consumed_in: torch.Tensor):
        """One block of replay on the failed subtask alone (state and
        inputs with a leading subtask dim of 1); the consumed-record total
        accumulates on the device. ``batches`` is a (left, right) pair
        for a two-input vertex."""
        lift = lambda b: RecordBatch(*(x[:, None] for x in b))
        z = torch.zeros((), dtype=torch.int32, device=times.device)
        bctx = BlockContext(times=times, rng_bits=rngs, epoch=z, step0=z,
                            subtask=subtask.reshape(1))
        if isinstance(self.operator, TwoInputOperator):
            left, right = batches
            new_state, out = self.operator.process_block(
                op_state, (lift(left), lift(right)), bctx)
            consumed = (left.count().sum(dtype=torch.int32)
                        + right.count().sum(dtype=torch.int32))
        elif self.in_slot_keys is not None and hasattr(
                self.operator, "process_block_static_keys"):
            new_state, out = self.operator.process_block_static_keys(
                op_state, lift(batches), bctx, self.in_slot_keys)
            consumed = batches.count().sum(dtype=torch.int32)
        else:
            new_state, out = self.operator.process_block(
                op_state, lift(batches), bctx)
            consumed = batches.count().sum(dtype=torch.int32)
        out = RecordBatch(*(x[:, 0] for x in out))
        return new_state, out, out.count(), consumed_in + consumed

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

    def replay(self, plan: ReplayPlan, device,
               defer_sync: bool = False) -> ReplayResult:
        """Drive the replay off host rows (``plan.det_rows``, parsed and
        spliced here) or the device stream (``plan.det_device``: no log
        body on the host, no parse, no splice). ``defer_sync`` (device
        stream only) transfers nothing: the output-cut check becomes
        ``verify_ok_d`` and the consumed total ``consumed_d``."""
        n = plan.n_steps
        k = len(self.LAYOUT)
        dev = plan.det_device is not None
        if dev:
            if not plan.verify_outputs:
                raise RecoveryError(
                    "device stream requires verifiable (non-synthesized) "
                    "recovery")
            times, rngs, expected_d = plan.det_device
            rows = np.zeros((0, det.NUM_LANES), np.int32)
            async_events: List[Tuple[int, det.Determinant]] = []
        else:
            if defer_sync:
                raise RecoveryError(
                    "defer_sync requires the device-resident determinant "
                    "stream (host-row plans parse on the host)")
            rows = np.asarray(plan.det_rows)
            ts_idx, used, async_events = self._parse(rows, n)
            times_np = rows[ts_idx, det.LANE_P + 1].astype(np.int32)
            rngs_np = rows[ts_idx + 1, det.LANE_P].astype(np.int32)
            expected = rows[ts_idx + 3, det.LANE_P].astype(np.int32)
            # One upload of the whole time/rng streams.
            both = _device.upload(np.stack([times_np, rngs_np]), device)
            times, rngs = both[0], both[1]

        row = plan.subtask if plan.state_row is None else plan.state_row
        state = tree_map(lambda x: x[row:row + 1], plan.checkpoint_op_state)
        subtask = _device.scalar(plan.subtask, device)
        out_chunks: List[RecordBatch] = []
        emit_chunks: List[torch.Tensor] = []
        consumed = torch.zeros((), dtype=torch.int32, device=device)
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
                cut = lambda b: RecordBatch(*(x[:hi - lo] for x in b))
                chunk = plan.input_steps[ci]
                chunk = (tuple(cut(b) for b in chunk)
                         if isinstance(chunk, tuple)
                         and not isinstance(chunk, RecordBatch)
                         else cut(chunk))
            state, out, counts, consumed = self._replay_block(
                state, chunk, times[lo:hi], rngs[lo:hi], subtask, consumed)
            out_chunks.append(out)
            emit_chunks.append(counts)
            lo = hi
            ci += 1
        if defer_sync:
            emit_d = (torch.cat(emit_chunks) if emit_chunks else
                      torch.zeros((0,), dtype=torch.int32, device=device))
            exp_d = expected_d[:n]
            return ReplayResult(
                op_state=state, rebuilt_log_rows=rows[:0],
                emit_counts=emit_d, expected_emits=exp_d,
                out_chunks=out_chunks if out_chunks else None,
                records_replayed=-1, rebuilt_is_view=True,
                deferred=True, verify_ok_d=(emit_d == exp_d).all(),
                consumed_d=consumed)
        # One copy for the emit counts, the consumed total and (device
        # stream) the expected cuts.
        tail = [consumed.reshape(1)]
        if dev:
            tail.append(expected_d[:n])
        packed = _device.to_numpy(torch.cat(emit_chunks + tail))
        emit_np = packed[:n]
        consumed_total = int(packed[n])
        if dev:
            expected = packed[n + 1:]

        # The rows the replayed run would log. Clean case (no async rows,
        # real recovered determinants): the re-derived sync rows differ
        # from the recorded ones only in BUFFER_BUILT, which verify()
        # checks — so the rebuilt stream IS the recovered prefix.
        rebuilt_is_view = not async_events and plan.verify_outputs
        if dev or rebuilt_is_view:
            rebuilt = rows if dev else rows[:used]
        else:
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
        records = (consumed_total if plan.input_steps is not None
                   else int(emit_np.sum()))
        return ReplayResult(
            op_state=state, rebuilt_log_rows=rebuilt, emit_counts=emit_np,
            expected_emits=expected,
            out_chunks=out_chunks if out_chunks else None,
            records_replayed=records, async_events=async_events,
            rebuilt_is_view=dev or rebuilt_is_view)


class RecoveryManager:
    """Host-side per-failed-subtask recovery FSM. Event methods mirror the
    reference's notifications; the cluster runner drives them in order
    and ``transitions`` records every state entered."""

    def __init__(self, vertex_id: int, subtask: int, flat_subtask: int,
                 replayer: Optional[LogReplayer]):
        self.vertex_id = vertex_id
        self.subtask = subtask
        self.flat_subtask = flat_subtask
        self.replayer = replayer
        self.state = RecoveryState.STANDBY
        self._pending_inputs: Dict[int, bool] = {}
        self._pending_outputs: Dict[int, bool] = {}
        self._state_restored = False
        self._responses: List[Tuple[np.ndarray, int]] = []
        self._expected_responses = 0
        self._expected_set = False
        self.plan: Optional[ReplayPlan] = None
        self.result: Optional[ReplayResult] = None
        self.transitions: List[RecoveryState] = [self.state]
        #: ``fn(kind, **fields)`` on every FSM state change, kind the
        #: entered state's name (verify/conformance.py observes these)
        self.transition_observers: List = []

    def _goto(self, s: RecoveryState) -> None:
        self.state = s
        self.transitions.append(s)
        for fn in self.transition_observers:
            fn(s.name, flat=self.flat_subtask)
        get_tracer().event("recovery.fsm", state=s.name,
                           flat=self.flat_subtask, vertex=self.vertex_id,
                           subtask=self.subtask)
        tl = get_timeline()
        if tl.enabled:
            tl.record("recovery.fsm", state=s.name,
                      flat=self.flat_subtask, vertex=self.vertex_id,
                      subtask=self.subtask)

    # --- events -------------------------------------------------------------

    def notify_start_recovery(self, in_edges: Sequence[int],
                              out_edges: Sequence[int]) -> None:
        if self.state != RecoveryState.STANDBY:
            raise RecoveryError(f"start_recovery in state {self.state}")
        self._pending_inputs = {e: False for e in in_edges}
        self._pending_outputs = {e: False for e in out_edges}
        self._goto(RecoveryState.WAITING_CONNECTIONS)
        if self._connections_ready():
            self._enter_waiting_determinants()

    def notify_state_restoration_complete(self) -> None:
        self._state_restored = True
        self._maybe_advance_connections()

    def notify_new_input_channel(self, edge: int) -> None:
        if edge in self._pending_inputs:
            self._pending_inputs[edge] = True
        self._maybe_advance_connections()

    def notify_new_output_channel(self, edge: int) -> None:
        if edge in self._pending_outputs:
            self._pending_outputs[edge] = True
        self._maybe_advance_connections()

    def _connections_ready(self) -> bool:
        # Every input and output channel established and state restored.
        return (self._state_restored
                and all(self._pending_inputs.values())
                and all(self._pending_outputs.values()))

    def _maybe_advance_connections(self) -> None:
        if (self.state == RecoveryState.WAITING_CONNECTIONS
                and self._connections_ready()):
            self._enter_waiting_determinants()

    def _enter_waiting_determinants(self) -> None:
        self._goto(RecoveryState.WAITING_DETERMINANTS)

    def expect_determinant_responses(self, n: int) -> None:
        self._expected_responses = n
        self._expected_set = True
        self._maybe_have_determinants()

    def notify_determinant_response(self, rows: np.ndarray,
                                    abs_start: int) -> None:
        if self.state != RecoveryState.WAITING_DETERMINANTS:
            raise RecoveryError(f"determinant response in state {self.state}")
        self._responses.append((rows, abs_start))
        self._maybe_have_determinants()

    def _maybe_have_determinants(self) -> None:
        if (self.state == RecoveryState.WAITING_DETERMINANTS
                and self._expected_set
                and len(self._responses) >= self._expected_responses):
            self._goto(RecoveryState.REPLAYING)

    def merged_determinants(self) -> Tuple[np.ndarray, int]:
        from clonos_tpu_torch.causal.replication import (
            merge_determinant_responses)
        return merge_determinant_responses(self._responses)

    def run_replay(self, plan: ReplayPlan, device,
                   defer_sync: bool = False) -> ReplayResult:
        if self.state != RecoveryState.REPLAYING:
            raise RecoveryError(f"replay in state {self.state}")
        self.plan = plan
        self.result = self.replayer.replay(plan, device,
                                           defer_sync=defer_sync)
        if plan.verify_outputs and not self.result.deferred:
            self.result.verify()
        self._goto(RecoveryState.RUNNING)
        return self.result
