"""Plain reference of the interval join: two synthetic sources -> keyBy
on both -> keyed interval join -> sink.

Written from the join's semantics alone, in plain PyTorch on whatever
device it is given, in integers only: int32 for every count, slot,
value and timestamp (the frozen hash computes in int64), and importing
nothing of the program under test. The sources' counter hash and the
key-group owner are the frozen copies of ``reference/window_chain.py``.

Time is logical: superstep ``s`` carries time ``s``, and each operator
reads what its upstream produced one superstep earlier. So the join at
step ``s + 1`` takes the records both sources drew at step ``s`` (every
record's timestamp is ``s`` and its value 1), and the sink passes the
join's output on at ``s + 2``.

The join keeps, per subtask and key, a ring of the last ``window`` left
records: the left record that is the key's ``a``-th arrival (counted
from 0 over the whole run, in arrival order) goes to slot
``a mod window``, so slot ``j`` holds the latest arrival ``a`` with
``a mod window == j``. A step's left records are inserted before its
right records probe. Each valid right record emits ``(key, left value +
right value, right timestamp)`` once for every live slot of its key whose
timestamp lies within ``interval`` of its own. No output capacity is
applied: a match the program's compaction dropped is a mismatch.

Within one step every record of a key carries the same value and
timestamp, so the state and the output follow from the per-step count of
each key on each side: arrival ``a`` of key ``k`` was drawn at the first
step whose running left count of ``k`` exceeds ``a``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.window_chain import SyntheticStream, owner

#: the value every synthetic record carries
RECORD_VALUE = 1


class IntervalJoin:
    """The job's expected results for ``steps`` supersteps of two
    synthetic streams (left and right)."""

    def __init__(self, left: SyntheticStream, right: SyntheticStream,
                 parallelism: int, vocab: int, key_groups: int, window: int,
                 interval: int, steps: int, chunk_steps: int = 512):
        self.left = left
        self.right = right
        self.p = parallelism
        self.vocab = vocab
        self.g = key_groups
        self.w = window
        self.interval = interval
        self.steps = steps
        self.chunk = chunk_steps
        dev = left.device
        self.device = dev
        self.key_owner = owner(torch.arange(vocab, device=dev),
                               parallelism, key_groups)
        #: records per (draw step, key) on each side, int32 [steps, vocab]
        self.lcount = self._counts(left)
        self.rcount = self._counts(right)
        #: running left count of each key through each draw step, and
        #: the same per key ``[vocab, steps]``
        self.lcum = torch.cumsum(self.lcount, dim=0, dtype=torch.int32)
        self.lcum_t = self.lcum.t().contiguous()

    def _counts(self, stream: SyntheticStream) -> torch.Tensor:
        out = torch.zeros((self.steps, self.vocab), dtype=torch.int32,
                          device=self.device)
        for a in range(0, self.steps, self.chunk):
            b = min(a + self.chunk, self.steps)
            k = stream.keys(a, b).reshape(b - a, -1)
            out[a:b].scatter_add_(1, k, torch.ones(k.shape, dtype=torch.int32,
                                                   device=self.device))
        return out

    def _rings(self, t0: int, t1: int) -> Tuple[torch.Tensor, ...]:
        """Per draw step ``t`` in ``[t0, t1)`` and key, the ring once the
        left records drawn through ``t`` are in: the arrivals so far
        ``[n, vocab]`` and per slot the value, timestamp and live flag
        ``[n, vocab, window]``."""
        arrived = self.lcum[t0:t1]
        j = torch.arange(self.w, dtype=torch.int32, device=self.device)
        c = arrived[..., None]
        live = c > j
        # The latest arrival a < c with a mod w == j ...
        a = torch.where(live, c - 1 - torch.remainder(c - 1 - j, self.w),
                        torch.zeros_like(c))
        # ... was drawn at the first step whose running count exceeds a.
        n = t1 - t0
        drawn_at = torch.searchsorted(
            self.lcum_t, a.permute(1, 0, 2).reshape(self.vocab, -1),
            right=True, out_int32=True).reshape(self.vocab, n, self.w
                                                ).permute(1, 0, 2)
        zero = torch.zeros_like(a)
        ts = torch.where(live, drawn_at, zero)
        val = torch.where(live, torch.full_like(a, RECORD_VALUE), zero)
        return arrived, val, ts, live

    def _ring(self, t: int) -> Tuple[torch.Tensor, ...]:
        """:meth:`_rings` of one step (``t`` < 0: the empty ring)."""
        if t < 0:
            z = torch.zeros((self.vocab, self.w), dtype=torch.int32,
                            device=self.device)
            return z[:, 0], z, z, z.bool()
        return tuple(x[0] for x in self._rings(t, t + 1))

    def _by_owner(self, per_key: torch.Tensor) -> np.ndarray:
        """``[P, vocab, ...]`` table: each key's row in its owner's
        subtask, zero elsewhere."""
        shape = (self.p,) + tuple(per_key.shape)
        t = torch.zeros(shape, dtype=per_key.dtype, device=self.device)
        t[self.key_owner, torch.arange(self.vocab, device=self.device)] = \
            per_key
        return t.cpu().numpy()

    def _emitted(self, t0: int, t1: int) -> torch.Tensor:
        """Per key, the records the join emits for the draws of steps
        ``[t0, t1)``: each step's right records times the live slots
        within the interval of it."""
        out = torch.zeros(self.vocab, dtype=torch.int32, device=self.device)
        for a in range(t0, t1, self.chunk):
            b = min(a + self.chunk, t1)
            _, _, ts, live = self._rings(a, b)
            t = torch.arange(a, b, dtype=torch.int32,
                             device=self.device)[:, None, None]
            ok = live & ((ts - t).abs() <= self.interval)
            out += (self.rcount[a:b] * ok.sum(dim=2, dtype=torch.int32)
                    ).sum(dim=0, dtype=torch.int32)
        return out

    def state_at(self, steps: int) -> Dict[str, np.ndarray]:
        """State after ``steps`` supersteps: both sources' positions, the
        join's ring and cursor per subtask and key, the sink's emitted
        counts."""
        t = steps - 2                 # the newest draws the join took in
        arrived, val, ts, live = self._ring(t)
        # The draws of steps [0, steps - 2) reached the sink.
        emitted = self._emitted(0, max(steps - 2, 0))
        sink = torch.zeros(self.p, dtype=torch.int32, device=self.device)
        sink.scatter_add_(0, self.key_owner, emitted)
        return {
            "source": self.left.position(steps),
            "source_r": self.right.position(steps),
            "lv": self._by_owner(val),
            "lt": self._by_owner(ts),
            "lm": self._by_owner(live),
            "cursor": self._by_owner(arrived),
            "sink_emitted": sink.cpu().numpy(),
        }

    def join_records(self, step: int) -> List[List[Tuple[int, int, int]]]:
        """Per join subtask, the sorted ``(key, value, timestamp)`` records
        the join emits at ``step`` (from the draws of ``step - 1``)."""
        out: List[List[Tuple[int, int, int]]] = [[] for _ in range(self.p)]
        t = step - 1
        if t < 0 or t >= self.steps:
            return out
        _, val, ts, live = self._ring(t)
        ok = live & ((ts - t).abs() <= self.interval)
        rc = self.rcount[t].cpu().numpy()
        val, ok = val.cpu().numpy(), ok.cpu().numpy()
        own = self.key_owner.cpu().numpy()
        for k in np.nonzero(rc)[0]:
            for j in np.nonzero(ok[k])[0]:
                out[own[k]] += [(int(k), int(val[k, j]) + RECORD_VALUE,
                                 t)] * int(rc[k])
        return [sorted(r) for r in out]

    def sink_records(self, step: int) -> List[List[Tuple[int, int, int]]]:
        """Per sink subtask, its output at ``step``: what the join emitted
        at ``step - 1`` (the edge between them is one to one)."""
        return self.join_records(step - 1)

    def routed(self, step: int, side: str) -> List[np.ndarray]:
        """Keys of one side's records drawn at ``step`` as the keyBy
        exchange places them: per target subtask, in arrival order
        (producer subtask, then lane)."""
        stream = self.left if side == "left" else self.right
        k = stream.keys(step, step + 1)[0].reshape(-1)
        tgt = owner(k, self.p, self.g).cpu().numpy()
        k = k.cpu().numpy()
        return [k[tgt == q] for q in range(self.p)]

    def drawn(self, step: int, side: str) -> np.ndarray:
        """``[P, batch]`` keys one source drew at ``step``."""
        stream = self.left if side == "left" else self.right
        return stream.keys(step, step + 1)[0].cpu().numpy()
