"""Operator library: per-superstep batch transforms on tensors.

Port of the main-path operators of ``clonos_tpu/api/operators.py``. An
operator is a pair of functions

    init_state(parallelism, device)    -> state (dict of [P, ...] tensors)
    process(state, batch, ctx)         -> (state, out_batch)

applied to a whole ``RecordBatch[P, B]`` per superstep, plus the
step-batched ``process_block`` over ``[K, P, B]`` stacks that the executor
runs (bit-identical to looping ``process``). Operators never read a clock:
time is a step input (``OpContext.time``) recorded as a determinant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch, zero_invalid
from clonos_tpu_torch.ops.histogram import keyed_hist
from clonos_tpu_torch.ops.matops import onehot_gather_rows
from clonos_tpu_torch.parallel import routing

_I32_MIN = -(2 ** 31)


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

    def static_out_keys(self) -> Optional[np.ndarray]:
        # Dense table emission: slot i always carries key i.
        return np.arange(self.num_keys, dtype=np.int32)


@dataclasses.dataclass
class HostFeedSource(Operator):
    """Source fed by the host boundary (the Kafka/socket-source analog).
    Its executor wiring (feed readers) comes with a later slice; the class
    exists so the executor can recognise feed vertices."""

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
