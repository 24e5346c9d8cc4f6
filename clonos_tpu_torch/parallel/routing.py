"""Batched record routing: the network exchange as dense tensor ops.

Port of ``clonos_tpu/parallel/routing.py``. An exchange computes a target
subtask per record and places each record at its arrival rank within its
target (stable: p-major, slot order). Routing is a pure function of the
input batch, so exchanges need no determinants.

Key-group discipline matches the reference: ``key_group = hash(key) %
num_key_groups``, and key groups map to subtasks as
``kg * parallelism // num_key_groups``.

uint32 arithmetic is done in int64 masked to 32 bits (torch has no CPU
``>>`` or ``%`` for uint32), with each 32x32-bit product split into two
16-bit halves so that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.api.records import RecordBatch, zero_invalid
from clonos_tpu_torch.ops.histogram import keyed_hist

_M32 = 0xFFFFFFFF


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``(u * c) mod 2**32`` for int64 ``u`` in ``[0, 2**32)``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _M32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche hash; returns the uint32 value as int64.
    ``x`` is read as its low 32 bits (a wrapped int32, or an int64 whose
    low 32 bits are that int32's)."""
    u = x.to(torch.int64) & _M32
    u = _mul32(u ^ (u >> 16), 0x7FEB352D)
    u = _mul32(u ^ (u >> 15), 0x846CA68B)
    return u ^ (u >> 16)


def key_group(keys: torch.Tensor, num_key_groups: int) -> torch.Tensor:
    return (hash32(keys) % num_key_groups).to(torch.int32)


def subtask_for_key_group(kg: torch.Tensor, parallelism: int,
                          num_key_groups: int) -> torch.Tensor:
    # Matches KeyGroupRangeAssignment.computeOperatorIndexForKeyGroup.
    return (kg * parallelism) // num_key_groups


def key_group_range(subtask: int, parallelism: int,
                    num_key_groups: int) -> Tuple[int, int]:
    """[start, end) of key groups owned by ``subtask``."""
    start = -(-subtask * num_key_groups // parallelism)
    end = -(-(subtask + 1) * num_key_groups // parallelism)
    return start, end


def _scatter_to_targets(batch: RecordBatch, target: torch.Tensor,
                        num_targets: int, out_capacity: int
                        ) -> Tuple[RecordBatch, torch.Tensor]:
    """Per-step exchange: flatten, stable-sort by target, place into
    ``[num_targets, out_capacity]``. Returns (routed, dropped_per_target)."""
    dev = batch.keys.device
    T = num_targets
    n = batch.keys.numel()
    keys, vals, ts, valid = (x.reshape(n) for x in batch)
    target = torch.where(valid, target.reshape(n).to(torch.int32), T)
    order = torch.argsort(target, stable=True)
    st, sk, sv, sts = target[order], keys[order], vals[order], ts[order]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    run_start = torch.searchsorted(
        st, torch.arange(T + 1, dtype=st.dtype, device=dev),
        side="left").to(torch.int32)
    pos = idx - run_start[st.clamp(0, T).to(torch.int64)]
    live = st < T
    keep = live & (pos < out_capacity)
    dropped = torch.zeros(T + 1, dtype=torch.int32, device=dev).index_add_(
        0, st.to(torch.int64), (live & ~keep).to(torch.int32))[:T]
    # Dropped and invalid records land in the spare row T, cut off below.
    row = torch.where(keep, st, T).to(torch.int64)
    col = torch.where(keep, pos, 0).to(torch.int64)

    def place(src, dtype):
        out = torch.zeros((T + 1, out_capacity), dtype=dtype, device=dev)
        out[row, col] = src
        return out[:T]

    out = RecordBatch(place(sk, torch.int32), place(sv, torch.int32),
                      place(sts, torch.int32), place(keep, torch.bool))
    return zero_invalid(out), dropped


#: the counting exchange's [K, n, T+1] cumsum scratch is priced at ~3
#: concurrent buffers; routes past the budget take the flat sort.
_COUNT_ROUTE_FALLBACK_BYTES = 256 << 20


@functools.lru_cache(maxsize=None)
def _count_route_budget(device_type: str, device_index) -> int:
    if device_type == "cuda":
        total = torch.cuda.mem_get_info(device_index)[1]
        return max(_COUNT_ROUTE_FALLBACK_BYTES, min(2 << 30, total // 48))
    return _COUNT_ROUTE_FALLBACK_BYTES


def _budget_for(dev: torch.device) -> int:
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return _count_route_budget(dev.type, index)


def _block_to_targets(batch: RecordBatch, target: torch.Tensor,
                      num_targets: int, out_capacity: int
                      ) -> Tuple[RecordBatch, torch.Tensor]:
    """Block-form exchange of a ``[K, P, B]`` stack without sorting: a
    record's slot is its arrival rank, a running per-target count (one
    cumsum over a ``[K, n, T+1]`` one-hot). Placement is a keyed histogram
    over the flattened slot id (slots are unique per step, so the sum of
    one contribution is a select). Bit-identical to applying
    :func:`_scatter_to_targets` per step, overflow drops included.

    Branches, as in the reference: histogram placement when
    ``T * cap <= 2**14``; element scatter above that; and a flat
    composite-key sort when the cumsum scratch would exceed the budget."""
    K, P, B = batch.keys.shape
    T = num_targets
    cap = out_capacity
    n = P * B
    dev = batch.keys.device
    if K * n * (T + 1) * 4 * 3 <= _budget_for(dev):
        keys, vals, ts, valid = (x.reshape(K, n) for x in batch)
        tgt = torch.where(valid, target.reshape(K, n).to(torch.int32), T)
        onehot = tgt[:, :, None] == torch.arange(
            T + 1, dtype=torch.int32, device=dev)[None, None, :]
        pos_all = torch.cumsum(onehot.to(torch.int32), dim=1,
                               dtype=torch.int32)
        pos = torch.gather(pos_all, 2, tgt.to(torch.int64)[:, :, None]
                           )[:, :, 0] - 1
        counts = pos_all[:, -1, :T]
        keep = (tgt < T) & (pos < cap)
        dropped = (counts - cap).clamp(min=0).to(torch.int32)
        nk = T * cap
        if nk <= (1 << 14):
            slot = torch.where(keep, tgt * cap + pos, -1)
            out_k, cnt = keyed_hist(slot, keys, keep, nk)
            out_v, _ = keyed_hist(slot, vals, keep, nk, want_counts=False)
            out_t, _ = keyed_hist(slot, ts, keep, nk, want_counts=False)
            sh = (K, T, cap)
            out = RecordBatch(out_k.reshape(sh), out_v.reshape(sh),
                              out_t.reshape(sh), cnt.reshape(sh) > 0)
            return zero_invalid(out), dropped
        row = torch.where(keep, tgt, T).to(torch.int64)
        col = torch.where(keep, pos, 0).to(torch.int64)
        kidx = torch.arange(K, device=dev)[:, None].expand(K, n)

        def place(src, dtype):
            out = torch.zeros((K, T + 1, cap), dtype=dtype, device=dev)
            out[kidx, row, col] = src
            return out[:, :T]

        out = RecordBatch(place(keys, torch.int32), place(vals, torch.int32),
                          place(ts, torch.int32), place(keep, torch.bool))
        return zero_invalid(out), dropped
    # Flat-sort fallback (huge T): one composite-key sort over the block.
    if K * (T + 1) >= (1 << 31):
        raise ValueError(f"composite sort key overflow: K={K} T={T}")
    keys, vals, ts, valid = (x.reshape(K * n) for x in batch)
    tgt = torch.where(valid, target.reshape(K * n).to(torch.int32), T)
    step = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(n)
    composite = step * (T + 1) + tgt
    order = torch.argsort(composite, stable=True)
    sc = composite[order]
    bounds = torch.arange(K * (T + 1), dtype=torch.int32, device=dev)
    run_start = torch.searchsorted(sc, bounds, side="left").to(torch.int32)
    # Fills, not host tensors: a copy from the host would synchronise.
    run_end = torch.cat([run_start[1:], torch.full(
        (1,), K * n, dtype=torch.int32, device=dev)])
    run_len = (run_end - run_start).reshape(K, T + 1)[:, :T]
    dropped = (run_len - cap).clamp(min=0).to(torch.int32)
    c = torch.arange(cap, dtype=torch.int32, device=dev)
    src = run_start.reshape(K, T + 1)[:, :T, None] + c[None, None, :]
    ok = c[None, None, :] < run_len.clamp(max=cap)[:, :, None]
    pick = order[src.clamp(0, K * n - 1).to(torch.int64)]     # [K, T, cap]
    out = RecordBatch(keys[pick], vals[pick], ts[pick], ok)
    return zero_invalid(out), dropped


def _block_to_target_lane(batch: RecordBatch, target: torch.Tensor, lane,
                          out_capacity: int) -> RecordBatch:
    """ONE consumer lane of :func:`_block_to_targets` — bit-identical to
    ``_block_to_targets(...)[0][:, lane]``: a running count over a
    ``[K, n]`` membership mask, then histogram placement over the ranks.
    The single-failure replay exchange."""
    K, P, B = batch.keys.shape
    n = P * B
    keys, vals, ts, valid = (x.reshape(K, n) for x in batch)
    tgt = torch.where(valid, target.reshape(K, n).to(torch.int32), -1)
    hit = tgt == lane
    pos = torch.cumsum(hit.to(torch.int32), dim=1, dtype=torch.int32) - 1
    keep = hit & (pos < out_capacity)
    slot = torch.where(keep, pos, -1)
    out_k, cnt = keyed_hist(slot, keys, keep, out_capacity)
    out_v, _ = keyed_hist(slot, vals, keep, out_capacity, want_counts=False)
    out_t, _ = keyed_hist(slot, ts, keep, out_capacity, want_counts=False)
    return zero_invalid(RecordBatch(out_k, out_v, out_t, cnt > 0))


def _block_to_target_range(batch: RecordBatch, target: torch.Tensor,
                            lanes: Tuple[int, int], out_capacity: int
                            ) -> Tuple[RecordBatch, torch.Tensor]:
    """Consumer lanes ``[lo, hi)`` of :func:`_block_to_targets` —
    bit-identical to ``_block_to_targets(...)[0][:, lo:hi]`` and its drops
    ``[:, lo:hi]``: records for other lanes count as invalid, and a
    record's slot is still its arrival rank over the whole producer block
    in (step, lane, slot) order. A rank of a sharded job routes only its
    own lanes, at the rank-local shape ``[K, hi - lo, cap]``."""
    lo, hi = lanes
    mine = batch.valid & (target >= lo) & (target < hi)
    return _block_to_targets(batch._replace(valid=mine), target - lo,
                             hi - lo, out_capacity)


def _rebalance_targets(shape, parallelism: int,
                       offsets: torch.Tensor) -> torch.Tensor:
    K, P, B = shape
    idx = (torch.arange(P * B, dtype=torch.int32, device=offsets.device)
           [None, :] + offsets.to(torch.int32)[:, None])
    return (idx % parallelism).reshape(K, P, B)


def route_hash_block_lane(batch: RecordBatch, lane, parallelism: int,
                          num_key_groups: int, out_capacity: int
                          ) -> RecordBatch:
    """One consumer lane of :func:`route_hash_block`."""
    kg = key_group(batch.keys, num_key_groups)
    return _block_to_target_lane(
        batch, subtask_for_key_group(kg, parallelism, num_key_groups),
        lane, out_capacity)


def route_rebalance_block_lane(batch: RecordBatch, lane, parallelism: int,
                               out_capacity: int, offsets: torch.Tensor
                               ) -> RecordBatch:
    """One consumer lane of :func:`route_rebalance_block`."""
    return _block_to_target_lane(
        batch, _rebalance_targets(batch.keys.shape, parallelism, offsets),
        lane, out_capacity)


def route_broadcast_block_lane(batch: RecordBatch, lane,
                               out_capacity: int) -> RecordBatch:
    """One consumer lane of :func:`route_broadcast_block` (every lane
    receives the same packed records; ``lane`` is ignored)."""
    del lane
    return _block_to_target_lane(
        batch, torch.zeros_like(batch.keys), 0, out_capacity)


def route_forward_block_lane(batch: RecordBatch, lane,
                             out_capacity: int) -> RecordBatch:
    """One consumer lane of :func:`route_forward_block`."""
    one = RecordBatch(*(x[:, lane][:, None] for x in batch))
    routed, _ = route_forward_block(one, out_capacity)
    return RecordBatch(*(x[:, 0] for x in routed))


def route_hash(batch: RecordBatch, parallelism: int, num_key_groups: int,
               out_capacity: int) -> Tuple[RecordBatch, torch.Tensor]:
    """keyBy exchange of one step (KeyGroupStreamPartitioner)."""
    kg = key_group(batch.keys, num_key_groups)
    return _scatter_to_targets(
        batch, subtask_for_key_group(kg, parallelism, num_key_groups),
        parallelism, out_capacity)


def route_hash_block(batch: RecordBatch, parallelism: int,
                     num_key_groups: int, out_capacity: int,
                     lanes: Optional[Tuple[int, int]] = None
                     ) -> Tuple[RecordBatch, torch.Tensor]:
    """Block form of :func:`route_hash` over ``[K, P, B]`` stacks; returns
    (routed ``[K, parallelism, out_capacity]``, dropped ``[K, parallelism]``).
    ``lanes=(lo, hi)``: only those consumer lanes (``[K, hi - lo, ...]``)."""
    kg = key_group(batch.keys, num_key_groups)
    target = subtask_for_key_group(kg, parallelism, num_key_groups)
    if lanes is not None:
        return _block_to_target_range(batch, target, lanes, out_capacity)
    return _block_to_targets(batch, target, parallelism, out_capacity)


def route_rebalance_block(batch: RecordBatch, parallelism: int,
                          out_capacity: int, offsets: torch.Tensor,
                          lanes: Optional[Tuple[int, int]] = None
                          ) -> Tuple[RecordBatch, torch.Tensor]:
    """Block form of :func:`route_rebalance`; ``offsets`` is the ``[K]``
    per-step exclusive round-robin cursor. ``lanes`` as in
    :func:`route_hash_block`."""
    target = _rebalance_targets(batch.keys.shape, parallelism, offsets)
    if lanes is not None:
        return _block_to_target_range(batch, target, lanes, out_capacity)
    return _block_to_targets(batch, target, parallelism, out_capacity)


def route_broadcast_block(batch: RecordBatch, parallelism: int,
                          out_capacity: int
                          ) -> Tuple[RecordBatch, torch.Tensor]:
    """Block form of :func:`route_broadcast`."""
    K = batch.keys.shape[0]
    one, dropped = _block_to_targets(
        batch, torch.zeros_like(batch.keys), 1, out_capacity)
    rep = RecordBatch(*(x[:, :1].expand((K, parallelism) + x.shape[2:])
                        .contiguous() for x in one))
    return rep, dropped[:, :1].expand(K, parallelism).contiguous()


def route_forward_block(batch: RecordBatch, out_capacity: int
                        ) -> Tuple[RecordBatch, torch.Tensor]:
    """Block form of :func:`route_forward` (no exchange; re-capacity)."""
    K, P, B = batch.keys.shape
    zeros = torch.zeros((K, P), dtype=torch.int32, device=batch.keys.device)
    if out_capacity == B:
        return zero_invalid(batch), zeros
    if out_capacity > B:
        pad = lambda x: torch.nn.functional.pad(x, (0, out_capacity - B))
        return RecordBatch(*(pad(x) for x in batch)), zeros
    keep = batch.valid[:, :, :out_capacity]
    dropped = batch.count() - keep.sum(-1, dtype=torch.int32)
    return zero_invalid(RecordBatch(
        batch.keys[:, :, :out_capacity], batch.values[:, :, :out_capacity],
        batch.timestamps[:, :, :out_capacity], keep)), dropped


def route_rebalance(batch: RecordBatch, parallelism: int, out_capacity: int,
                    offset=0) -> Tuple[RecordBatch, torch.Tensor]:
    """Deterministic round-robin by global record index of one step."""
    n = batch.keys.numel()
    idx = (torch.arange(n, dtype=torch.int32, device=batch.keys.device)
           + int(offset))
    return _scatter_to_targets(
        batch, (idx % parallelism).reshape(batch.keys.shape),
        parallelism, out_capacity)


def route_forward(batch: RecordBatch, out_capacity: int
                  ) -> Tuple[RecordBatch, torch.Tensor]:
    """1:1 edge of one step: same subtask downstream, re-capacitied."""
    one, dropped = route_forward_block(
        RecordBatch(*(x[None] for x in batch)), out_capacity)
    return RecordBatch(*(x[0] for x in one)), dropped[0]


def route_broadcast(batch: RecordBatch, parallelism: int, out_capacity: int
                    ) -> Tuple[RecordBatch, torch.Tensor]:
    """Every downstream subtask receives every record (compacted)."""
    one, dropped = _scatter_to_targets(
        batch, torch.zeros_like(batch.keys), 1, out_capacity)
    rep = RecordBatch(*(x[0].expand((parallelism,) + x.shape[1:])
                        .contiguous() for x in one))
    return rep, dropped[0].expand(parallelism).contiguous()


def hash32_np(x: np.ndarray) -> np.ndarray:
    """Host-side (numpy) twin of :func:`hash32` for compile-time planning."""
    u = np.asarray(x, np.uint64) & 0xFFFFFFFF
    u = ((u ^ (u >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    u = ((u ^ (u >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    return (u ^ (u >> 16)) & 0xFFFFFFFF


@dataclasses.dataclass
class StaticRoutePlan:
    """Compile-time hash exchange for producers whose output slots carry
    statically known keys (the window operator: slot ``i`` holds key
    ``i``). The routed batch is a static gather
    ``out[k, t, c] = producer_out[k, src_p[t, c], src_slot[t, c]]``; slots
    are not compacted, and capacity overflow drops whole static slots
    (recorded in ``drop_p/drop_slot/drop_t``)."""

    src_p: np.ndarray      # int32 [T, cap]: producer subtask per out slot
    src_slot: np.ndarray   # int32 [T, cap]: producer slot per out slot
    ok: np.ndarray         # bool  [T, cap]: out slot is mapped
    slot_keys: np.ndarray  # int32 [T, cap]: static key (-1 = unmapped)
    drop_p: np.ndarray     # int32 [D]: overflow slots (producer subtask)
    drop_slot: np.ndarray  # int32 [D]
    drop_t: np.ndarray     # int32 [D]: target the overflow belonged to
    _on_device: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def _tensors(self, dev: torch.device) -> tuple:
        key = str(dev)
        if key not in self._on_device:
            t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(dt).to(dev)
            self._on_device[key] = (
                t(self.src_p, torch.int64), t(self.src_slot, torch.int64),
                t(self.ok, torch.bool), t(self.drop_p, torch.int64),
                t(self.drop_slot, torch.int64), t(self.drop_t, torch.int64))
        return self._on_device[key]

    def apply(self, out: RecordBatch,
              lanes: Optional[Tuple[int, int]] = None
              ) -> Tuple[RecordBatch, torch.Tensor]:
        """Route a producer block ``[K, P, B]`` -> ``[K, T, cap]``; with
        ``lanes=(lo, hi)`` only those targets' rows are gathered."""
        dev = out.keys.device
        src_p, src_slot, ok, drop_p, drop_slot, drop_t = self._tensors(dev)
        K = out.keys.shape[0]
        T = self.src_p.shape[0]
        lo, hi = lanes if lanes is not None else (0, T)
        if (lo, hi) != (0, T):
            src_p, src_slot, ok = src_p[lo:hi], src_slot[lo:hi], ok[lo:hi]
        g = lambda x: x[:, src_p, src_slot]
        valid = g(out.valid) & ok[None]
        routed = zero_invalid(RecordBatch(
            g(out.keys), g(out.values), g(out.timestamps), valid))
        dropped = torch.zeros((K, T), dtype=torch.int32, device=dev)
        if len(self.drop_p):
            dv = out.valid[:, drop_p, drop_slot]                   # [K, D]
            dropped.index_add_(1, drop_t, dv.to(torch.int32))
        return routed, dropped[:, lo:hi]

    def key_slots(self, src_parallelism: int, num_key_groups: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """The plan's inverse, on the host: for each key, the target and
        slot at which the producer subtask that owns the key delivers it
        (``-1`` where no slot carries the key)."""
        t, c = np.nonzero(self.ok)
        keys = self.slot_keys[t, c].astype(np.int64)
        mine = self.src_p[t, c] == _static_targets(keys, src_parallelism,
                                                   num_key_groups)
        lane = np.full(int(keys.max()) + 1, -1, np.int32)
        slot = np.full_like(lane, -1)
        lane[keys[mine]] = t[mine]
        slot[keys[mine]] = c[mine]
        return lane, slot

    def place(self, batch: RecordBatch, src_parallelism: int,
              num_key_groups: int) -> Tuple[RecordBatch, torch.Tensor]:
        """Place a buffer of records (any shape) into the plan's ``[T,
        cap]`` layout by key: each valid record goes to the slot its key's
        owning producer fills (:meth:`key_slots`). The inverse is built
        once per device and uploaded once. Returns the placed batch and
        the count of valid records that found no slot of their own (a key
        the plan does not carry, or two records on one slot), as a
        device scalar."""
        dev = batch.keys.device
        key = f"place:{src_parallelism}:{num_key_groups}:{dev}"
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.from_numpy(a).to(torch.int64).to(dev)
                for a in self.key_slots(src_parallelism, num_key_groups))
        lane, slot = self._on_device[key]
        T, cap = self.slot_keys.shape
        k = batch.keys.reshape(-1).to(torch.int64)
        valid = batch.valid.reshape(-1)
        known = valid & (k >= 0) & (k < lane.numel())
        kk = torch.where(known, k, 0)
        known = known & (lane[kk] >= 0)
        dst = torch.where(known, lane[kk] * cap + slot[kk], T * cap)
        hits = torch.zeros(T * cap + 1, dtype=torch.int32, device=dev)
        hits.index_add_(0, dst, known.to(torch.int32))
        unplaced = ((valid & ~known).sum(dtype=torch.int64)
                    + (hits[:-1] - 1).clamp(min=0).sum(dtype=torch.int64))

        def put(src):
            out = torch.zeros(T * cap + 1, dtype=src.dtype, device=dev)
            out.scatter_(0, dst, src.reshape(-1))
            return out[:-1].reshape(T, cap)

        placed = RecordBatch(put(batch.keys), put(batch.values),
                             put(batch.timestamps),
                             hits[:-1].reshape(T, cap) > 0)
        return zero_invalid(placed), unplaced


def _static_targets(slot_keys: np.ndarray, parallelism: int,
                    num_key_groups: int) -> np.ndarray:
    """Target subtask of each static slot key."""
    kg = (hash32_np(slot_keys) % num_key_groups).astype(np.int64)
    return (kg * parallelism) // num_key_groups


def static_hash_capacity(slot_keys: np.ndarray, src_parallelism: int,
                         parallelism: int, num_key_groups: int) -> int:
    """Smallest per-target receive capacity for which
    :func:`plan_static_hash` has no overflow slots."""
    slot_keys = np.asarray(slot_keys, np.int64)
    tgt = _static_targets(slot_keys, parallelism, num_key_groups)
    return int(np.bincount(tgt, minlength=parallelism).max()) \
        * src_parallelism


def plan_static_hash(slot_keys: np.ndarray, src_parallelism: int,
                     parallelism: int, num_key_groups: int,
                     out_capacity: int) -> StaticRoutePlan:
    """Build a :class:`StaticRoutePlan` for a HASH edge whose producer
    emits key ``slot_keys[i]`` in slot ``i`` on every subtask."""
    slot_keys = np.asarray(slot_keys, np.int64)
    tgt = _static_targets(slot_keys, parallelism, num_key_groups)
    T, cap = parallelism, out_capacity
    src_p = np.zeros((T, cap), np.int32)
    src_slot = np.zeros((T, cap), np.int32)
    ok = np.zeros((T, cap), bool)
    keys_out = np.full((T, cap), -1, np.int32)
    drop_p, drop_slot, drop_t = [], [], []
    for t in range(T):
        slots = np.nonzero(tgt == t)[0]
        c = 0
        for p in range(src_parallelism):      # p-major = arrival order
            for s in slots:
                if c < cap:
                    src_p[t, c] = p
                    src_slot[t, c] = s
                    ok[t, c] = True
                    keys_out[t, c] = slot_keys[s]
                    c += 1
                else:
                    drop_p.append(p)
                    drop_slot.append(s)
                    drop_t.append(t)
    return StaticRoutePlan(
        src_p=src_p, src_slot=src_slot, ok=ok, slot_keys=keys_out,
        drop_p=np.asarray(drop_p, np.int32),
        drop_slot=np.asarray(drop_slot, np.int32),
        drop_t=np.asarray(drop_t, np.int32))
