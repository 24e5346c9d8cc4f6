"""Plain reference of the window chain: source -> keyBy -> tumbling window
count -> keyBy -> keyed running sum -> sink.

Written from the job's semantics alone, in plain PyTorch on whatever
device it is given, and importing nothing of the program under test. The
two functions the program derives from the seed are frozen copies here:
the synthetic source's counter hash and the key-group assignment (a
splitmix32 finaliser, then Flink's ``keyGroup * P / maxParallelism``).

Time is logical: superstep ``s`` carries time ``s``. Each operator reads
what its upstream produced one superstep earlier, so a record drawn at
step ``s`` reaches the window at ``s + 1``. The window fires when
``s // W`` passes the window it holds, emits the keys it counted, and
starts over with step ``s``'s input; the reduce adds the fired counts to
its running totals at ``s + 1`` and emits the new total of each key it
received; the sink passes that on at ``s + 2``. So with
``fire(j) = j * W`` for ``j >= 1``:

- fire ``j`` emits the counts of the records drawn at steps
  ``[max(W*(j-1) - 1, 0), W*j - 1)``;
- the sink's output at step ``W*j + 2`` holds ``(key, total through fire
  j, W*j)`` for every key that fire ``j`` counted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
#: the synthetic source's key-mix stride (a subtask index is added below
#: it, so (sequence, subtask) pairs stay distinct)
SUBTASK_STRIDE = 1 << 10


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``u * c mod 2**32`` for int64 ``u`` in ``[0, 2**32)``, in two 16-bit
    halves of ``c`` so no product leaves int64."""
    return (u * (c & 0xFFFF) + (((u * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finaliser of the low 32 bits of ``x`` (int64 result)."""
    u = x.to(torch.int64) & _M32
    u = _mul32(u ^ (u >> 16), 0x7FEB352D)
    u = _mul32(u ^ (u >> 15), 0x846CA68B)
    return u ^ (u >> 16)


def owner(keys: torch.Tensor, parallelism: int, key_groups: int
          ) -> torch.Tensor:
    """The subtask a key is routed to: its key group's operator index."""
    return (hash32(keys) % key_groups) * parallelism // key_groups


class SyntheticStream:
    """Records of the on-device generator: subtask ``p`` at step ``s``
    draws ``batch`` keys from the counter ``seq0[p] + s * batch + lane``."""

    def __init__(self, seq0: np.ndarray, batch: int, vocab: int, device):
        self.seq0 = torch.as_tensor(np.asarray(seq0, np.int64),
                                    device=device)
        self.batch = batch
        self.vocab = vocab
        self.parallelism = len(seq0)
        self.device = device

    def keys(self, s0: int, s1: int) -> torch.Tensor:
        """int64 ``[s1 - s0, P, batch]`` keys of steps ``[s0, s1)``."""
        b = self.batch
        step = torch.arange(s0, s1, dtype=torch.int64, device=self.device)
        lane = torch.arange(b, dtype=torch.int64, device=self.device)
        seq = (self.seq0[None, :, None] + step[:, None, None] * b
               + lane[None, None, :])
        sub = torch.arange(self.parallelism, dtype=torch.int64,
                           device=self.device)[None, :, None]
        return hash32(seq * SUBTASK_STRIDE + sub) % self.vocab

    def position(self, steps: int) -> np.ndarray:
        """Each subtask's counter after ``steps`` steps, as int32 wraps."""
        pos = self.seq0.cpu().numpy() + steps * self.batch
        return ((pos + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


class PoolStream:
    """Records of a partitioned feed that serves each partition's pool of
    keys in order, cycled by offset: partition ``p`` at step ``s`` holds
    ``pool[p, (s * batch + lane) % N]``."""

    def __init__(self, pool: np.ndarray, batch: int, device):
        self.pool = torch.as_tensor(np.asarray(pool, np.int64),
                                    device=device)
        self.batch = batch
        self.parallelism = pool.shape[0]
        self.device = device

    def keys(self, s0: int, s1: int) -> torch.Tensor:
        b = self.batch
        n = self.pool.shape[1]
        off = (torch.arange(s0, s1, dtype=torch.int64,
                            device=self.device)[:, None] * b
               + torch.arange(b, dtype=torch.int64,
                              device=self.device)[None, :]) % n
        return self.pool[:, off].permute(1, 0, 2)

    def position(self, steps: int) -> np.ndarray:
        """Records each partition has handed out after ``steps`` steps."""
        return np.full(self.parallelism, steps * self.batch, np.int64)


class WindowChain:
    """The job's expected results for ``steps`` supersteps of a stream."""

    def __init__(self, stream, parallelism: int, vocab: int,
                 key_groups: int, window: int, steps: int,
                 chunk_steps: int = 256):
        if window < 2:
            raise ValueError("the window spans at least two steps")
        self.stream = stream
        self.p = parallelism
        self.vocab = vocab
        self.g = key_groups
        self.w = window
        self.steps = steps
        self.chunk = chunk_steps
        dev = stream.device
        self.key_owner = owner(torch.arange(vocab, device=dev),
                               parallelism, key_groups).cpu().numpy()
        #: fire j's counts (row j - 1) for every fire whose counts the run
        #: needs, and their running totals
        n_fires = max(steps - 2, 0) // window
        self.fired = np.stack([self._hist(max(window * (j - 1) - 1, 0),
                                          window * j - 1)
                               for j in range(1, n_fires + 1)]
                              ) if n_fires else np.zeros((0, vocab), np.int64)
        self.totals = np.cumsum(self.fired, axis=0)

    def _hist(self, s0: int, s1: int) -> np.ndarray:
        """Records per key drawn at steps ``[s0, s1)``."""
        out = torch.zeros(self.vocab, dtype=torch.int64,
                          device=self.stream.device)
        for a in range(s0, s1, self.chunk):
            k = self.stream.keys(a, min(a + self.chunk, s1)).reshape(-1)
            out += torch.bincount(k, minlength=self.vocab)
        return out.cpu().numpy()

    def _by_owner(self, per_key: np.ndarray) -> np.ndarray:
        """``[P, vocab]`` table: each key's value in its owner's row."""
        t = np.zeros((self.p, self.vocab), np.int64)
        t[self.key_owner, np.arange(self.vocab)] = per_key
        return t

    def state_at(self, steps: int) -> Dict[str, np.ndarray]:
        """Operator state after ``steps`` supersteps (``steps`` >= 1)."""
        w = self.w
        last_fire = (steps - 1) // w * w          # 0: no fire yet
        acc = self._hist(max(last_fire - 1, 0), max(steps - 1, 0))
        fires_reduced = max(steps - 2, 0) // w    # reached the reduce
        fires_sunk = max(steps - 3, 0) // w       # reached the sink
        total = (self.totals[fires_reduced - 1] if fires_reduced
                 else np.zeros(self.vocab, np.int64))
        emitted = np.zeros(self.p, np.int64)
        for j in range(fires_sunk):
            np.add.at(emitted, self.key_owner[self.fired[j] > 0], 1)
        return {
            "source": self.stream.position(steps),
            "window_acc": self._by_owner(acc),
            "window_id": np.full(self.p, (steps - 1) // w, np.int64),
            "reduce_acc": self._by_owner(total),
            "sink_emitted": emitted,
        }

    def sink_records(self, step: int) -> List[List[Tuple[int, int, int]]]:
        """Per sink subtask, the sorted ``(key, value, timestamp)`` records
        of its output at ``step``."""
        out: List[List[Tuple[int, int, int]]] = [[] for _ in range(self.p)]
        j = (step - 2) // self.w
        if step < 2 or (step - 2) % self.w or j < 1:
            return out
        for k in np.nonzero(self.fired[j - 1])[0]:
            out[self.key_owner[k]].append(
                (int(k), int(self.totals[j - 1, k]), self.w * j))
        return [sorted(r) for r in out]

    def routed(self, step: int) -> List[np.ndarray]:
        """Keys of step ``step``'s records as the keyBy exchange places
        them: per target subtask, in arrival order (producer subtask, then
        lane)."""
        k = self.stream.keys(step, step + 1)[0].reshape(-1)
        tgt = owner(k, self.p, self.g).cpu().numpy()
        k = k.cpu().numpy()
        return [k[tgt == q] for q in range(self.p)]

    def drawn(self, step: int) -> np.ndarray:
        """``[P, batch]`` keys the source produced at ``step``."""
        return self.stream.keys(step, step + 1)[0].cpu().numpy()
