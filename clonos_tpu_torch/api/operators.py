"""Operator library: per-superstep batch transforms on tensors.

Port of ``clonos_tpu/api/operators.py``. An operator is a pair of
functions

    init_state(parallelism, device)    -> state (dict of [P, ...] tensors)
    process(state, batch, ctx)         -> (state, out_batch)

applied to a whole ``RecordBatch[P, B]`` per superstep, plus the
step-batched ``process_block`` over ``[K, P, B]`` stacks that the executor
runs (bit-identical to looping ``process``). Operators never read a clock:
time is a step input (``OpContext.time``) recorded as a determinant.

Two-input operators (union, interval join) take a ``(left, right)`` pair;
event-time windows fire on a watermark that is a pure fold over the
record timestamps. Their scatters are plain tensor ops: a dropped row is
sent to a spare row or slot that is sliced off (an out-of-range index
would raise, or corrupt memory on the card), and compaction is an int32
``cumsum`` rank (a boolean mask or ``nonzero`` would synchronise). Every
expression stays int32, so it wraps as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch, zero_invalid
from clonos_tpu_torch.ops.histogram import keyed_hist
from clonos_tpu_torch.ops.keyrank import keyed_rank
from clonos_tpu_torch.ops.matops import onehot_gather_rows
from clonos_tpu_torch.parallel import routing

_I32_MIN = -(2 ** 31)
#: "nothing seen yet" for running timestamp maxima and session ends
_TS_MIN = -(2 ** 31) + 1
#: free-slot sentinel of open-window tables: far below any reachable
#: window id (ids are event_ts // size)
_NO_WINDOW = -(2 ** 30)


class OpContext(NamedTuple):
    """Per-superstep inputs an operator may consume (device tensors)."""

    time: torch.Tensor       # int32 scalar: causal processing time
    epoch: torch.Tensor      # int32 scalar: current epoch id
    step: torch.Tensor       # int32 scalar: superstep index
    rng_bits: torch.Tensor   # int32 scalar: causal host-RNG draw
    subtask: torch.Tensor    # int32[P]: subtask indices


class BlockContext(NamedTuple):
    """Step-batched context for :meth:`Operator.process_block`."""

    times: torch.Tensor      # int32[K]: causal time per superstep
    rng_bits: torch.Tensor   # int32[K]: causal host-RNG draw per superstep
    epoch: torch.Tensor      # int32 scalar: epoch id of the block
    step0: torch.Tensor      # int32 scalar: global step index of block start
    subtask: torch.Tensor    # int32[P]

    def at_step(self, k: int) -> OpContext:
        return OpContext(time=self.times[k], epoch=self.epoch,
                         step=self.step0 + k, rng_bits=self.rng_bits[k],
                         subtask=self.subtask)


def _stack_batches(outs) -> RecordBatch:
    return RecordBatch(*(torch.stack(f) for f in zip(*outs)))


def _take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise ``table[r, idx[r, i]]`` with the reference's ``x[idx]``
    semantics: negative indices wrap once, then clamp into range."""
    n = table.shape[-1]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return torch.gather(table, -1, i)


def _take_fill(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather with the reference's ``take_along_axis`` semantics:
    negative indices wrap once; still out of range reads INT32_MIN."""
    n = table.shape[-1]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    oob = (i < 0) | (i >= n)
    g = torch.gather(table, -1, i.clamp(0, n - 1))
    return torch.where(oob, _I32_MIN, g)


class Operator:
    """Base operator. ``process_block`` must be bit-identical to looping
    ``process`` over the step axis."""

    #: output batch capacity per subtask per superstep; None = input's.
    out_capacity: Optional[int] = None

    #: True iff extra steps with all-invalid inputs (and the last
    #: time/rng repeated) leave the state unchanged and emit nothing.
    replay_pad_safe: bool = True

    #: True iff every valid output record carries the updated keyed state.
    emits_running_value: bool = False

    def init_state(self, parallelism: int, device) -> Any:
        return ()

    def process(self, state: Any, batch: RecordBatch,
                ctx: OpContext) -> Tuple[Any, RecordBatch]:
        raise NotImplementedError

    def process_block(self, state: Any, batches: RecordBatch,
                      bctx: BlockContext) -> Tuple[Any, RecordBatch]:
        """Advance K supersteps; ``batches`` is ``[K, P, B]``. Default: a
        loop over :meth:`process` (the reference's ``lax.scan``)."""
        outs = []
        for k in range(bctx.times.shape[0]):
            state, out = self.process(
                state, RecordBatch(*(x[k] for x in batches)),
                bctx.at_step(k))
            outs.append(out)
        return state, _stack_batches(outs)

    def static_out_keys(self) -> Optional[np.ndarray]:
        """The statically-known key of each output slot, or None."""
        return None

    def rescale_keyed_state(self, state: Any, new_parallelism: int,
                            num_key_groups: int) -> Any:
        """Remap checkpointed state to another parallelism by key-group
        ownership (the split/merge of a planned rescale). Dense-table
        operators sum the disjoint per-subtask rows and keep, per new
        subtask, the keys it now owns; operators without a keyed
        rescaling story raise."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support rescaling")


def rescale_dense_table(table: torch.Tensor, new_parallelism: int,
                        num_key_groups: int,
                        fill: int = 0) -> torch.Tensor:
    """Remap a dense keyed table ``[P, ..., K]`` to ``new_parallelism``:
    the int32 sum over the old subtask axis (rows are disjoint by key
    ownership; the sum wraps as the reference's does), then per new
    subtask only the keys the new key-group assignment routes to it
    (``fill``, the operator's init value, elsewhere)."""
    nk = table.shape[-1]
    dev = table.device
    total = (table - fill).sum(dim=0, dtype=torch.int32) + fill
    kg = routing.key_group(torch.arange(nk, dtype=torch.int32, device=dev),
                           num_key_groups)
    owner = routing.subtask_for_key_group(kg, new_parallelism,
                                          num_key_groups)
    sub = torch.arange(new_parallelism, dtype=torch.int32, device=dev)
    mask = (owner[None, :] == sub[:, None]).reshape(
        (new_parallelism,) + (1,) * (total.dim() - 1) + (nk,))
    return torch.where(mask, total[None], fill).to(torch.int32)


class TwoInputOperator(Operator):
    """Base for vertices with two input edges. The lockstep superstep
    consumes both inputs' batches every step, so ``process2`` sees both
    and any merge is a pure function (no arrival-order race to log)."""

    def process2(self, state: Any, left: RecordBatch, right: RecordBatch,
                 ctx: OpContext) -> Tuple[Any, RecordBatch]:
        raise NotImplementedError

    def process(self, state, batch, ctx):
        raise TypeError("TwoInputOperator requires process2 with two inputs")

    def process_block(self, state: Any,
                      batches: Tuple[RecordBatch, RecordBatch],
                      bctx: BlockContext) -> Tuple[Any, RecordBatch]:
        """``batches`` is a (left, right) pair of ``[K, P, B]`` stacks.
        Default: a loop over :meth:`process2`."""
        left, right = batches
        outs = []
        for k in range(bctx.times.shape[0]):
            state, out = self.process2(
                state, RecordBatch(*(x[k] for x in left)),
                RecordBatch(*(x[k] for x in right)), bctx.at_step(k))
            outs.append(out)
        return state, _stack_batches(outs)


@dataclasses.dataclass
class MapOperator(Operator):
    """Elementwise transform ``fn(keys, values, timestamps)`` (StreamMap)."""

    fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

    def process(self, state, batch, ctx):
        k, v, t = self.fn(batch.keys, batch.values, batch.timestamps)
        return state, zero_invalid(RecordBatch(k, v, t, batch.valid))

    def process_block(self, state, batches, bctx):
        return self.process(state, batches, None)


@dataclasses.dataclass
class FilterOperator(Operator):
    """Keep records where ``pred(keys, values, timestamps)`` (StreamFilter)."""

    pred: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

    def process(self, state, batch, ctx):
        keep = batch.valid & self.pred(batch.keys, batch.values,
                                       batch.timestamps)
        return state, zero_invalid(batch._replace(valid=keep))

    def process_block(self, state, batches, bctx):
        return self.process(state, batches, None)


@dataclasses.dataclass
class SyntheticSource(Operator):
    """On-device record generator: ``batch_size`` records per superstep per
    subtask, keys from ``[0, vocab)`` by a counter hash — deterministic
    given the carried sequence counter."""

    vocab: int
    batch_size: int
    rate_limit: Optional[int] = None

    replay_pad_safe = False

    #: key-mix stride; exceeds any parallelism so (seq, subtask) pairs stay
    #: unique, and independent of the state's leading dim.
    SUBTASK_STRIDE = 1 << 10

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.batch_size

    def init_state(self, parallelism: int, device):
        return {"seq": torch.zeros((parallelism,), dtype=torch.int32,
                                   device=device)}

    def _n(self) -> int:
        b = self.batch_size
        return b if self.rate_limit is None else min(b, self.rate_limit)

    def _keys(self, seq: torch.Tensor, subtask: torch.Tensor):
        # seq * STRIDE + subtask wraps in int32 in the reference; computed
        # in int64 it has the same low 32 bits, which is all hash32 reads.
        mix = seq * self.SUBTASK_STRIDE + subtask.to(torch.int64)
        return (routing.hash32(mix) % self.vocab).to(torch.int32)

    def process(self, state, batch, ctx):
        seq0 = state["seq"]
        p = seq0.shape[0]
        b = self.batch_size
        lane = torch.arange(b, dtype=torch.int64, device=seq0.device)
        seq = seq0.to(torch.int64)[:, None] + lane[None, :]        # [P, B]
        keys = self._keys(seq, ctx.subtask[:, None])
        valid = (lane < self._n()).expand(p, b)
        ts = ctx.time.to(torch.int32).expand(p, b)
        out = zero_invalid(RecordBatch(
            keys, torch.ones((p, b), dtype=torch.int32, device=seq0.device),
            ts, valid))
        return {"seq": seq0 + self._n()}, out

    def process_block(self, state, batches, bctx):
        # seq advances by exactly n per step: the block's keys are a closed
        # form of (seq0, step index).
        seq0 = state["seq"]
        p = seq0.shape[0]
        b = self.batch_size
        K = bctx.times.shape[0]
        n = self._n()
        dev = seq0.device
        lane = torch.arange(b, dtype=torch.int64, device=dev)
        step = torch.arange(K, dtype=torch.int64, device=dev)
        seq = (seq0.to(torch.int64)[None, :, None]
               + step[:, None, None] * n + lane[None, None, :])   # [K, P, B]
        keys = self._keys(seq, bctx.subtask[None, :, None])
        valid = (lane < n)[None, None, :].expand(K, p, b)
        ts = bctx.times.to(torch.int32)[:, None, None].expand(K, p, b)
        out = zero_invalid(RecordBatch(
            keys, torch.ones((K, p, b), dtype=torch.int32, device=dev),
            ts, valid))
        return {"seq": seq0 + n * K}, out


@dataclasses.dataclass
class KeyedReduceOperator(Operator):
    """Running keyed reduce over a dense key table ``acc[P, num_keys]``;
    emits the updated running value for every input record."""

    num_keys: int
    reduce_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = \
        torch.add
    init_value: int = 0
    emits_running_value = True

    def __post_init__(self):
        #: slot_keys bytes -> static inverted index (built once per layout)
        self._static_index: Dict[tuple, tuple] = {}

    def init_state(self, parallelism: int, device):
        return {"acc": torch.full((parallelism, self.num_keys),
                                  self.init_value, dtype=torch.int32,
                                  device=device)}

    def rescale_keyed_state(self, state, new_parallelism, num_key_groups):
        return {"acc": rescale_dense_table(
            state["acc"], new_parallelism, num_key_groups,
            fill=self.init_value)}

    def process(self, state, batch, ctx):
        acc = state["acc"]
        # A key is touched iff a VALID record carries it (the count form).
        contrib, cnt = keyed_hist(batch.keys, batch.values, batch.valid,
                                  self.num_keys)
        new_acc = torch.where(cnt > 0, self.reduce_fn(acc, contrib), acc)
        out_vals = torch.where(batch.valid, _take_clip(new_acc, batch.keys),
                               0)
        return ({"acc": new_acc},
                zero_invalid(batch._replace(values=out_vals)))

    def process_block(self, state, batches, bctx):
        # The prefix over steps distributes only for the additive default;
        # other reduce_fns take the step loop.
        if self.reduce_fn is not torch.add:
            return super().process_block(state, batches, bctx)
        K, p, _ = batches.keys.shape
        nk = self.num_keys
        acc0 = state["acc"]                                     # [P, nk]
        contrib, _ = keyed_hist(batches.keys, batches.values,
                                batches.valid, nk, want_counts=False)
        cum = torch.cumsum(contrib, dim=0, dtype=torch.int32)  # inclusive
        acc_end = acc0[None] + cum                              # [K, P, nk]
        out_vals = torch.where(
            batches.valid,
            _take_fill(acc_end.reshape(K * p, nk),
                       batches.keys.reshape(K * p, -1)
                       ).reshape(batches.keys.shape), 0)
        return ({"acc": acc0 + cum[-1]},
                zero_invalid(batches._replace(values=out_vals)))

    def _index(self, sk: np.ndarray, device) -> tuple:
        """Static inverted index: for subtask q and key n, the input slots
        carrying n (padded with the zero column B)."""
        key = (sk.shape, sk.tobytes(), str(device))
        hit = self._static_index.get(key)
        if hit is not None:
            return hit
        p, B = sk.shape
        nk = self.num_keys
        occ = [[[] for _ in range(nk)] for _ in range(p)]
        for q in range(p):
            for b in range(B):
                k = int(sk[q, b])
                if 0 <= k < nk:
                    occ[q][k].append(b)
        S = max(1, max((len(o) for row in occ for o in row), default=0))
        idx = np.full((p, nk, S), B, np.int64)
        for q in range(p):
            for n in range(nk):
                for s, b in enumerate(occ[q][n]):
                    idx[q, n, s] = b
        hit = (torch.from_numpy(idx).to(device),
               torch.from_numpy(np.clip(sk, 0, nk - 1).astype(np.int64)
                                ).to(device),
               torch.arange(p, device=device)[:, None])
        self._static_index[key] = hit
        return hit

    def process_block_static_keys(self, state, batches, bctx,
                                  slot_keys: np.ndarray):
        """Fast path when the input arrives over a StaticRoutePlan edge:
        ``slot_keys[p, b]`` is the compile-time key of input slot (p, b)
        (-1 = never mapped). Contributions sit at static slots, so the
        per-step table is a few static gathers. Bit-identical to
        :meth:`process_block`."""
        if self.reduce_fn is not torch.add:
            return self.process_block(state, batches, bctx)
        K, p, B = batches.keys.shape
        sk = np.asarray(slot_keys)
        if sk.shape != (p, B):
            raise ValueError(f"slot_keys shape {sk.shape} != {(p, B)}")
        dev = batches.keys.device
        idx, key_of_slot, pp = self._index(sk, dev)
        vals = torch.where(batches.valid, batches.values, 0)
        vpad = torch.nn.functional.pad(vals, (0, 1))           # [K, P, B+1]
        contrib = vpad[:, pp, idx[:, :, 0]]
        for s in range(1, idx.shape[2]):
            contrib = contrib + vpad[:, pp, idx[:, :, s]]       # [K, P, nk]
        cum = torch.cumsum(contrib, dim=0, dtype=torch.int32)
        acc0 = state["acc"]
        acc_end = acc0[None] + cum
        out_vals = torch.where(batches.valid, acc_end[:, pp, key_of_slot], 0)
        return ({"acc": acc0 + cum[-1]},
                zero_invalid(batches._replace(values=out_vals)))


@dataclasses.dataclass
class TumblingWindowCountOperator(Operator):
    """Tumbling processing-time windowed sum per key over a dense table.
    When time crosses a window boundary, emits one record per key with a
    nonzero accumulator (key, aggregate, window_end) and resets."""

    num_keys: int
    window_size: int

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.num_keys

    def init_state(self, parallelism: int, device):
        return {
            "acc": torch.zeros((parallelism, self.num_keys),
                               dtype=torch.int32, device=device),
            "window": torch.zeros((parallelism,), dtype=torch.int32,
                                  device=device),
        }

    def process(self, state, batch, ctx):
        acc, window = state["acc"], state["window"]
        p = acc.shape[0]
        nk = self.num_keys
        w_now = (ctx.time // self.window_size).to(torch.int32)
        fire = w_now > window                                    # [P]
        window_end = (window + 1) * self.window_size
        keys = torch.arange(nk, dtype=torch.int32,
                            device=acc.device).expand(p, nk)
        out = RecordBatch(keys=keys, values=acc,
                          timestamps=window_end[:, None].expand(p, nk),
                          valid=fire[:, None] & (acc != 0))
        acc = torch.where(fire[:, None], 0, acc)
        contrib, _ = keyed_hist(batch.keys, batch.values, batch.valid, nk,
                                want_counts=False)
        acc = acc + contrib
        window = torch.where(fire, w_now, window)
        return {"acc": acc, "window": window}, zero_invalid(out)

    def process_block(self, state, batches, bctx):
        # Window ids evolve as a running max of the per-step ids; the
        # accumulator segments between fires are differences of an
        # inclusive prefix sum; a fire step emits the segment ending at the
        # previous step. All exact int32.
        K, p, _ = batches.keys.shape
        nk = self.num_keys
        size = self.window_size
        dev = batches.keys.device
        w_now = (bctx.times // size).to(torch.int32)               # [K]
        w0 = state["window"]                                       # [P]
        acc0 = state["acc"]                                        # [P, nk]
        rm = torch.cummax(w_now, dim=0).values                     # incl [K]
        neg_inf = torch.full((1,), -(2 ** 31) + 1, dtype=torch.int32,
                             device=dev)
        rm_excl = torch.cat([neg_inf, rm[:-1]])
        window_pre = torch.maximum(w0[None, :], rm_excl[:, None])  # [K, P]
        fire = w_now[:, None] > window_pre                         # [K, P]

        contrib, _ = keyed_hist(batches.keys, batches.values,
                                batches.valid, nk, want_counts=False)
        cum = torch.cumsum(contrib, dim=0, dtype=torch.int32)      # [K, P, nk]
        cum_excl = cum - contrib

        kidx = torch.arange(K, dtype=torch.int32, device=dev)[:, None]
        lf = torch.cummax(torch.where(fire, kidx, -1), dim=0).values
        seg_base = onehot_gather_rows(cum_excl, lf.clamp(0, K - 1))
        acc_end = torch.where(lf[:, :, None] >= 0, cum - seg_base,
                              acc0[None] + cum)                    # [K, P, nk]
        emit = torch.cat([acc0[None], acc_end[:-1]], dim=0)

        keys = torch.arange(nk, dtype=torch.int32,
                            device=dev)[None, None, :].expand(K, p, nk)
        window_end = (window_pre + 1) * size                       # [K, P]
        out = zero_invalid(RecordBatch(
            keys=keys, values=emit,
            timestamps=window_end[:, :, None].expand(K, p, nk),
            valid=fire[:, :, None] & (emit != 0)))
        return ({"acc": acc_end[-1],
                 "window": torch.maximum(w0, rm[-1])}, out)

    def rescale_keyed_state(self, state, new_parallelism, num_key_groups):
        # Window ids are lockstep across subtasks (shared causal time):
        # carry the max forward, materialised (the step loop writes
        # operator state in place; an expanded view would alias).
        return {"acc": rescale_dense_table(state["acc"], new_parallelism,
                                           num_key_groups),
                "window": state["window"].max().expand(
                    new_parallelism).clone()}

    def static_out_keys(self) -> Optional[np.ndarray]:
        # Dense table emission: slot i always carries key i.
        return np.arange(self.num_keys, dtype=np.int32)


def _advance_watermark(max_ts: torch.Tensor, batch: RecordBatch,
                       out_of_orderness: int):
    """One step of the pure-fold watermark: ``(max_ts, wm)``, each
    ``[P]``. An all-invalid step keeps ``max_ts``; before any record the
    int32 ``wm`` wraps, as the reference's does."""
    step_max = torch.where(batch.valid, batch.timestamps,
                           _TS_MIN).amax(dim=-1)
    max_ts = torch.maximum(max_ts, step_max)
    return max_ts, max_ts - out_of_orderness


def _event_window_state(parallelism: int, windows: int, num_keys: int,
                        device) -> Dict[str, torch.Tensor]:
    return {
        "acc": torch.zeros((parallelism, windows, num_keys),
                           dtype=torch.int32, device=device),
        "win": torch.full((parallelism, windows), _NO_WINDOW,
                          dtype=torch.int32, device=device),
        "max_ts": torch.full((parallelism,), _TS_MIN, dtype=torch.int32,
                             device=device),
        "late": torch.zeros((parallelism,), dtype=torch.int32,
                            device=device),
    }


def _fire_open_windows(acc, win, win_end, wm):
    """Fire-first: every open window whose end the watermark reached
    emits one record per key with a nonzero sum (timestamped with the
    window end) and frees its slot."""
    P, w, nk = acc.shape
    fire = (win != _NO_WINDOW) & (win_end <= wm[:, None])        # [P, W]
    keys = torch.arange(nk, dtype=torch.int32, device=acc.device)
    out = zero_invalid(RecordBatch(
        keys=keys.expand(P, w, nk).reshape(P, w * nk),
        values=acc.reshape(P, w * nk),
        timestamps=win_end[:, :, None].expand(P, w, nk).reshape(P, w * nk),
        valid=(fire[:, :, None] & (acc != 0)).reshape(P, w * nk)))
    return (torch.where(fire[:, :, None], 0, acc),
            torch.where(fire, _NO_WINDOW, win), out)


def _assign_window(acc, win, batch: RecordBatch, rw, closed):
    """Add the records whose absolute window ``rw`` is open (or its slot
    free) into slot ``rw mod W``; returns ``(acc, win, ok)``. Slots are
    always in range, so the scatters drop nothing."""
    P, w, nk = acc.shape
    slot = torch.remainder(rw, w).to(torch.int64)
    slot_win = torch.gather(win, 1, slot)
    ok = batch.valid & ~closed & ((slot_win == rw)
                                  | (slot_win == _NO_WINDOW))
    win = win.scatter_reduce(1, slot, torch.where(ok, rw, _NO_WINDOW),
                             "amax", include_self=True)
    idx = slot * nk + batch.keys.clamp(0, nk - 1).to(torch.int64)
    acc = acc.reshape(P, w * nk).scatter_add(
        1, idx, torch.where(ok, batch.values, 0)).reshape(P, w, nk)
    return acc, win, ok


@dataclasses.dataclass
class EventTimeTumblingWindowOperator(Operator):
    """Event-time tumbling windowed sum per key, fired by a watermark
    ``max(event ts seen) - out_of_orderness`` that is a pure fold over the
    inputs, so replay needs no watermark determinant. The watermark
    advances once per superstep, before the step's records are assigned.
    State per subtask: ``open_windows`` slots ``acc[W, nk]`` with absolute
    window ids ``win[W]``, ``max_ts``, and ``late`` (records whose window
    had fired, or found its slot taken). Event-time windows have no block
    form: ``process_block`` is the step loop."""

    num_keys: int
    window_size: int
    out_of_orderness: int = 0
    open_windows: int = 2

    def __post_init__(self):
        # Open ids span at most out_of_orderness // size + 1 values after
        # fire-first; one spare slot keeps (rw mod W) collision-free.
        need = self.out_of_orderness // self.window_size + 2
        self.open_windows = max(self.open_windows, need)

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.num_keys * self.open_windows

    def init_state(self, parallelism: int, device):
        return _event_window_state(parallelism, self.open_windows,
                                   self.num_keys, device)

    def process(self, state, batch, ctx):
        size = self.window_size
        max_ts, wm = _advance_watermark(state["max_ts"], batch,
                                        self.out_of_orderness)
        win = state["win"]
        win_end = (torch.where(win != _NO_WINDOW, win, 0) + 1) * size
        acc, win, out = _fire_open_windows(state["acc"], win, win_end, wm)
        rw = torch.div(batch.timestamps, size, rounding_mode="floor")
        closed = (rw + 1) * size <= wm[:, None]
        acc, win, ok = _assign_window(acc, win, batch, rw, closed)
        late = state["late"] + (batch.valid & ~ok).sum(dim=-1,
                                                        dtype=torch.int32)
        return {"acc": acc, "win": win, "max_ts": max_ts, "late": late}, out


@dataclasses.dataclass
class SlidingEventTimeWindowOperator(Operator):
    """Event-time sliding windowed sum per key: each record adds to
    ``window_size // slide`` consecutive windows (window id = start //
    slide). Same watermark discipline as the tumbling form."""

    num_keys: int
    window_size: int
    slide: int
    out_of_orderness: int = 0
    open_windows: int = 4

    def __post_init__(self):
        if self.window_size % self.slide:
            raise ValueError("window_size must be a multiple of slide")
        need = (self.out_of_orderness + self.window_size) // self.slide + 2
        self.open_windows = max(self.open_windows, need)

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.num_keys * self.open_windows

    def init_state(self, parallelism: int, device):
        return _event_window_state(parallelism, self.open_windows,
                                   self.num_keys, device)

    def process(self, state, batch, ctx):
        size, slide = self.window_size, self.slide
        max_ts, wm = _advance_watermark(state["max_ts"], batch,
                                        self.out_of_orderness)
        win = state["win"]
        win_end = torch.where(win != _NO_WINDOW, win, 0) * slide + size
        acc, win, out = _fire_open_windows(state["acc"], win, win_end, wm)
        # The newest window holding ts starts at floor(ts / slide) * slide;
        # the record is in the windows starting there minus j * slide.
        base = torch.div(batch.timestamps, slide, rounding_mode="floor")
        ok_any = torch.zeros_like(batch.valid)
        for j in range(size // slide):
            rw = base - j
            closed = rw * slide + size <= wm[:, None]
            acc, win, ok = _assign_window(acc, win, batch, rw, closed)
            ok_any = ok_any | ok
        # One late count per record dropped from ALL its windows.
        late = state["late"] + (batch.valid & ~ok_any).sum(
            dim=-1, dtype=torch.int32)
        return {"acc": acc, "win": win, "max_ts": max_ts, "late": late}, out


@dataclasses.dataclass
class SessionWindowOperator(Operator):
    """Event-time session windows per key: a session absorbs records
    within ``gap`` of its end and fires when the watermark passes end +
    gap (one open session per key; a record for a closed session is a
    late drop)."""

    num_keys: int
    gap: int
    out_of_orderness: int = 0

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.num_keys

    def init_state(self, parallelism: int, device):
        nk = self.num_keys
        z = lambda shape: torch.zeros(shape, dtype=torch.int32,
                                      device=device)
        return {"acc": z((parallelism, nk)),
                "end": torch.full((parallelism, nk), _TS_MIN,
                                  dtype=torch.int32, device=device),
                "max_ts": torch.full((parallelism,), _TS_MIN,
                                     dtype=torch.int32, device=device),
                "late": z((parallelism,))}

    def process(self, state, batch, ctx):
        nk, gap = self.num_keys, self.gap
        acc, end = state["acc"], state["end"]
        P = acc.shape[0]
        max_ts, wm = _advance_watermark(state["max_ts"], batch,
                                        self.out_of_orderness)
        # Fire first; a session closes even when its sum is zero (it just
        # emits nothing), or the key would wedge.
        live = end > _TS_MIN
        fire = live & (end + gap <= wm[:, None])
        out = zero_invalid(RecordBatch(
            keys=torch.arange(nk, dtype=torch.int32,
                              device=acc.device).expand(P, nk),
            values=acc, timestamps=end + gap, valid=fire & (acc != 0)))
        acc = torch.where(fire, 0, acc)
        end = torch.where(fire, _TS_MIN, end)
        live = live & ~fire
        k = batch.keys.clamp(0, nk - 1).to(torch.int64)
        # Absorb within gap of the open session's end, or open a session
        # whose own end + gap is still ahead of the watermark.
        ok = batch.valid & torch.where(
            torch.gather(live, 1, k),
            batch.timestamps - torch.gather(end, 1, k) <= gap,
            batch.timestamps + gap > wm[:, None])
        late = state["late"] + (batch.valid & ~ok).sum(dim=-1,
                                                        dtype=torch.int32)
        acc = acc.scatter_add(1, k, torch.where(ok, batch.values, 0))
        end = end.scatter_reduce(1, k, torch.where(ok, batch.timestamps,
                                                   _TS_MIN),
                                 "amax", include_self=True)
        return {"acc": acc, "end": end, "max_ts": max_ts, "late": late}, out


@dataclasses.dataclass
class UnionOperator(TwoInputOperator):
    """Merge two streams: left records first, then right, compacted into
    ``capacity`` slots (records past it are a deterministic overflow
    drop). The stable compaction is an int32 ``cumsum`` rank: valid
    records in order, then the invalid ones."""

    capacity: int

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.capacity

    def process2(self, state, left, right, ctx):
        fields = [torch.cat([a, b], dim=-1) for a, b in zip(left, right)]
        valid = fields[3]
        vi = valid.to(torch.int32)
        vrank = torch.cumsum(vi, dim=-1, dtype=torch.int32) - 1
        irank = torch.cumsum(1 - vi, dim=-1, dtype=torch.int32) - 1
        nvalid = vi.sum(dim=-1, keepdim=True, dtype=torch.int32)
        dest = torch.where(valid, vrank, nvalid + irank).to(torch.int64)
        take = min(self.capacity, valid.shape[-1])
        return state, zero_invalid(RecordBatch(
            *(torch.zeros_like(x).scatter_(-1, dest, x)[..., :take]
              for x in fields)))

    def process_block(self, state, batches, bctx):
        # Stateless: the [K, P] dims are leading batch dims of process2.
        return self.process2(state, batches[0], batches[1], None)


@dataclasses.dataclass
class IntervalJoinOperator(TwoInputOperator):
    """Keyed stream-stream join. State per subtask: per key a ring of the
    last ``window`` left records (value, timestamp, live flag) and its
    cursor. Each right record joins every retained left record of its key
    within ``interval``, emitting (key, left value + right value, right
    ts), compacted to ``capacity`` per step."""

    num_keys: int
    window: int               # retained left records per key
    interval: int             # max |ts_left - ts_right|
    capacity: int             # output capacity per subtask per step

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.capacity

    def init_state(self, parallelism: int, device):
        k, w = self.num_keys, self.window
        z = lambda dt: torch.zeros((parallelism, k, w), dtype=dt,
                                   device=device)
        return {"lv": z(torch.int32), "lt": z(torch.int32),
                "lm": z(torch.bool),
                "cursor": torch.zeros((parallelism, k), dtype=torch.int32,
                                      device=device)}

    def _probe(self, right: RecordBatch, cand):
        """Join right records ``[P, S, B2]`` against candidates ``cand``
        (values, timestamps, live) ``[P, S, B2, w]`` and compact each of
        the S steps' matches, in (right slot, ring slot) order, into
        ``capacity`` slots by their int32 ``cumsum`` rank (a spare slot
        takes every record past it)."""
        cap = self.capacity
        cand_v, cand_t, cand_m = cand
        match = (cand_m & right.valid[..., None]
                 & ((cand_t - right.timestamps[..., None]).abs()
                    <= self.interval))
        P, S = match.shape[:2]
        fm = match.reshape(P, S, -1)
        pos = torch.cumsum(fm.to(torch.int32), dim=2, dtype=torch.int32) - 1
        keep2 = fm & (pos < cap)
        dst = torch.where(keep2, pos, cap).to(torch.int64)

        def comp(src):
            src = src.expand(match.shape).reshape(P, S, -1)
            zero = torch.zeros((), dtype=src.dtype, device=src.device)
            out = torch.zeros((P, S, cap + 1), dtype=src.dtype,
                              device=src.device)
            return out.scatter_(2, dst, torch.where(keep2, src, zero)
                                )[..., :cap]

        return zero_invalid(RecordBatch(
            comp(right.keys[..., None]),
            comp(cand_v + right.values[..., None]),
            comp(right.timestamps[..., None]), comp(match)))

    def process2(self, state, left, right, ctx):
        k, w = self.num_keys, self.window
        lv, lt, lm, cursor = (state["lv"], state["lt"], state["lm"],
                              state["cursor"])
        P = lv.shape[0]
        dev = lv.device
        # A left record's ring slot is cursor[key] + its per-key arrival
        # rank in the batch; only a key's last w records survive a batch,
        # so every kept destination is unique. Dropped records go to the
        # spare row k.
        lk = left.keys.clamp(0, k - 1).to(torch.int64)
        onehot = left.valid[..., None] & (
            lk[..., None] == torch.arange(k, device=dev))        # [P, B, k]
        cum = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32)
        rank = torch.gather(cum, 2, lk[..., None])[..., 0] - 1
        total = cum[:, -1]                                       # [P, k]
        keep = left.valid & (torch.gather(total, 1, lk) - 1 - rank < w)
        slot = torch.remainder(torch.gather(cursor, 1, lk) + rank, w)
        row = torch.where(keep, lk, k)
        flat = row * w + slot.to(torch.int64)

        def insert(table, src):
            spare = torch.zeros((P, w), dtype=table.dtype, device=dev)
            grown = torch.cat([table.reshape(P, k * w), spare], dim=1)
            return grown.scatter_(1, flat, src)[:, :k * w].reshape(P, k, w)

        lv = insert(lv, left.values)
        lt = insert(lt, left.timestamps)
        lm = insert(lm, torch.ones_like(left.valid))
        cursor = cursor + total
        pidx = torch.arange(P, device=dev)[:, None]
        rk = right.keys.clamp(0, k - 1).to(torch.int64)          # [P, B2]
        lift = lambda b: RecordBatch(*(x[:, None] for x in b))
        out = self._probe(lift(right),
                          tuple(t[pidx, rk][:, None] for t in (lv, lt, lm)))
        return ({"lv": lv, "lt": lt, "lm": lm, "cursor": cursor},
                RecordBatch(*(x[:, 0] for x in out)))

    def group_size(self, K: int, P: int, B: int) -> int:
        """G supersteps fused per iteration: the largest divisor of K
        whose ``[P, nk, G*B]`` scratch fits the byte budget (at most 64)."""
        budget = 128 << 20
        per = P * self.num_keys * B * 4 * 3
        gmax = max(1, min(64, budget // max(per, 1)))
        return next(d for d in range(int(gmax), 0, -1) if K % d == 0)

    def process_block(self, state, batches, bctx):
        """Grouped step-batched form: G supersteps per iteration, all
        rank arithmetic, bit-identical to the step loop. A left record's
        ring slot is its global arrival index mod w (the cursor carries
        the global count), so a right record's slot-j candidate is the
        latest group-local left record with rank == (j - cursor) mod w
        below its through-count, read from a group-local rank-indexed
        table, else the carried ring slot j."""
        left, right = batches
        K, P, B = left.keys.shape
        B2 = right.keys.shape[2]
        nk, w = self.num_keys, self.window
        G = self.group_size(K, P, B)
        if G == 1:
            return TwoInputOperator.process_block(self, state, batches, bctx)
        n = G * B
        dev = left.keys.device
        ks = torch.arange(nk, device=dev)
        js = torch.arange(w, dtype=torch.int32, device=dev)
        p3 = torch.arange(P, device=dev)[:, None, None]
        p4 = p3[..., None]
        lv, lt, lm, cur = (state["lv"], state["lt"], state["lm"],
                           state["cursor"])
        outs = []
        for g0 in range(0, K, G):
            # [G, P, B] -> [P, G, B]: each lane's records in (step, slot)
            # order, the sequential insert order.
            lg = RecordBatch(*(x[g0:g0 + G].transpose(0, 1) for x in left))
            rg = RecordBatch(*(x[g0:g0 + G].transpose(0, 1) for x in right))
            lk32 = lg.keys.clamp(0, nk - 1).reshape(P, n)
            # rank: [P, n], n = spare; through: [P, G, nk] inclusive.
            rank, through = keyed_rank(lk32, lg.valid.reshape(P, n), G, B,
                                       nk)
            total = through[:, -1]                                # [P, nk]
            lk = lk32.to(torch.int64)
            tidx = lk * (n + 1) + rank

            def table(src):
                t = torch.zeros((P, nk * (n + 1)), dtype=torch.int32,
                                device=dev)
                return t.scatter_(1, tidx, src.reshape(P, n)).reshape(
                    P, nk, n + 1)[:, :, :n]

            Tv, Tt = table(lg.values), table(lg.timestamps)
            rk = rg.keys.clamp(0, nk - 1).to(torch.int64)         # [P, G, B2]
            hi = torch.gather(through, 2, rk)
            c0 = torch.gather(cur, 1, rk.reshape(P, G * B2)).reshape(
                P, G, B2)
            hib = hi[..., None]
            tmod = torch.remainder(js - c0[..., None], w)         # [P,G,B2,w]
            rc = hib - 1 - torch.remainder(hib - 1 - tmod, w)
            use_g = (hib > 0) & (rc >= 0)
            rc_s = rc.clamp(0, n - 1).to(torch.int64)
            rkb = rk[..., None]
            ring = lambda t: t[p3, rk]                            # [P,G,B2,w]
            cand = (torch.where(use_g, Tv[p4, rkb, rc_s], ring(lv)),
                    torch.where(use_g, Tt[p4, rkb, rc_s], ring(lt)),
                    use_g | ring(lm))
            outs.append(self._probe(rg, cand))
            # End-of-group ring: slot j <- the latest group arrival with
            # rank == (j - cursor) mod w, else the carried slot.
            tmod_k = torch.remainder(js - cur[..., None], w)      # [P, nk, w]
            tot = total[..., None]
            rck = tot - 1 - torch.remainder(tot - 1 - tmod_k, w)
            use_k = (tot > 0) & (rck >= 0)
            rck_s = rck.clamp(0, n - 1).to(torch.int64)
            kidx = ks[None, :, None]
            lv = torch.where(use_k, Tv[p3, kidx, rck_s], lv)
            lt = torch.where(use_k, Tt[p3, kidx, rck_s], lt)
            lm = lm | use_k
            cur = cur + total
        out = RecordBatch(*(torch.cat([o[i].transpose(0, 1) for o in outs])
                            for i in range(4)))
        return {"lv": lv, "lt": lt, "lm": lm, "cursor": cur}, out


@dataclasses.dataclass
class HostFeedSource(Operator):
    """Source fed by the host boundary (the Kafka/socket-source analog):
    the executor passes the pulled batch in as its input; the operator
    stamps causal time and counts the records into its ``offset`` state,
    so the checkpoint carries the feed position."""

    batch_size: int

    @property
    def out_capacity(self):  # type: ignore[override]
        return self.batch_size

    def init_state(self, parallelism: int, device):
        return {"offset": torch.zeros((parallelism,), dtype=torch.int32,
                                      device=device)}

    def process(self, state, batch, ctx):
        out = zero_invalid(batch._replace(
            timestamps=torch.where(batch.valid, ctx.time, 0)))
        return {"offset": state["offset"] + out.count()}, out

    def process_block(self, state, batches, bctx):
        out = zero_invalid(batches._replace(timestamps=torch.where(
            batches.valid, bctx.times[:, None, None], 0)))
        return ({"offset": state["offset"]
                 + out.count().sum(dim=0, dtype=torch.int32)}, out)


@dataclasses.dataclass
class SinkOperator(Operator):
    """Terminal operator: passes its input through as the job's visible
    output and counts emissions."""

    def init_state(self, parallelism: int, device):
        return {"emitted": torch.zeros((parallelism,), dtype=torch.int32,
                                       device=device)}

    def process(self, state, batch, ctx):
        return ({"emitted": state["emitted"] + batch.count()},
                zero_invalid(batch))

    def process_block(self, state, batches, bctx):
        out = zero_invalid(batches)
        return ({"emitted": state["emitted"]
                 + out.count().sum(dim=0, dtype=torch.int32)}, out)


@dataclasses.dataclass
class TransactionalSinkOperator(SinkOperator):
    """Exactly-once sink: on the device a pass-through counter like
    :class:`SinkOperator`; its emissions flow to the host-side
    ``runtime.txn.TransactionLog`` as per-epoch pending transactions,
    committed when the epoch's checkpoint completes."""
