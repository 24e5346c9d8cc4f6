"""Incremental checkpoints: device-diffed, chunk-granular snapshot storage
(port of ``clonos_tpu/runtime/incremental.py``).

The snapshotter keeps the previous snapshot's leaves on the device as the
diff shadow and, per leaf,

- chunks the flat leaf,
- flags the chunks that changed since the shadow,
- compacts the first ``budget`` changed chunk ids and payloads into
  fixed-size buffers (each changed chunk's slot is its int32 cumsum rank,
  so no shape depends on the data),

so only the changed chunks cross to the host. Leaves whose change count
exceeds the budget ship whole; a chain of deltas is anchored by periodic
full snapshots, and deletion keeps a base alive until nothing retained
depends on it.

Torch tensors are mutable, unlike the reference's JAX arrays: the shadow
is the snapshot the coordinator was handed as owned (the executor's
``lean_snapshot`` deep copy, which nothing mutates), never a live carry
leaf. The device work runs on the thread that queued the snapshot's
work, in two steps (:class:`StagedSnapshot`):

1. ``stage`` dispatches every leaf's diff and starts one packed copy of
   all the change counts — no host read;
2. ``finish`` reads those counts (one wait, for that copy alone), slices
   the changed chunks by them and starts their copies to pinned host
   memory on a side stream that waits only for the diff.

The writer thread only waits for those copies and writes the file. The
pipelined fence stages in its capture window and finishes at the join.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from clonos_tpu_torch.device import HostCopy
from clonos_tpu_torch.runtime.checkpoint import (CheckpointStorage,
                                                 CompletedCheckpoint,
                                                 StagedWrite)
from clonos_tpu_torch.utils.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)


@dataclasses.dataclass
class LeafDelta:
    """Changed chunks of one flattened leaf since the previous snapshot."""

    chunk_ids: np.ndarray      # int32 [m] (m <= budget), ids < num_chunks
    chunks: np.ndarray         # [m, chunk_elems] in the leaf's dtype


#: per-leaf entry of a delta snapshot: LeafDelta, the whole leaf array
#: (budget exceeded / shape changed), or None (bit-identical leaf)
LeafEntry = Any


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


class StagedSnapshot(StagedWrite):
    """One snapshot on its way to the storage: ``kind`` is ``"full"`` (a
    HostCopy of the whole tree, started at staging) or ``"delta"``
    (per-leaf diff plans against the shadow)."""

    def __init__(self, kind: str, snap: Any, leaves: List[torch.Tensor]):
        self.kind = kind
        self.snap = snap
        self.leaves = leaves
        #: the checkpoint id whose snapshot this one is diffed against
        self.base: Optional[int] = None
        self.nbytes = sum(int(x.numel() * x.element_size()) for x in leaves)
        #: per leaf: None (same), ("whole", leaf) or ("delta", ids [m],
        #: data [m, chunk], m, slot in the counts, leaf)
        self.plans: List[Any] = []
        self._counts: Optional[HostCopy] = None
        self._ready = None            # CUDA event after the diff programs
        self._copy: Optional[HostCopy] = (HostCopy(snap) if kind == "full"
                                          else None)
        self._finished = threading.Event()
        if kind == "full":
            self._finished.set()
        #: the staging storage (None for a bare snapshotter)
        self.storage: Optional["IncrementalCheckpointStorage"] = None

    def finish(self) -> None:
        """Read the packed change counts, slice the changed chunks by
        them and start their copies to the host. Runs on the thread that
        staged; no-op for a full snapshot or when already finished."""
        if self._finished.is_set():
            return
        counts = self._counts.wait() if self._counts is not None else None
        out: List[Any] = []
        for plan in self.plans:
            if plan is None:
                out.append(None)
            elif plan[0] == "whole":
                out.append(plan[1])
            else:
                _, ids, data, m, slot, whole = plan
                nch = int(counts[slot])
                if nch == 0:
                    out.append(None)
                elif nch > m:
                    out.append(whole)               # budget exceeded
                else:
                    out.append({"ids": ids[:nch], "chunks": data[:nch]})
        side = contextlib.nullcontext()
        if self._ready is not None:
            stream = torch.cuda.Stream(device=self._ready.device)
            stream.wait_event(self._ready)
            side = torch.cuda.stream(stream)
        with side:
            self._copy = HostCopy(out)
        if self._counts is not None and self.storage is not None:
            self.storage.packed_reads += 1
        self._finished.set()

    def discard(self) -> None:
        """Never written: the storage's shadow must not stay on it."""
        if self.storage is not None:
            self.storage._drop_shadow(self)

    def payload(self) -> Any:
        """The host payload: the snapshot's numpy tree (full) or its
        per-leaf entries (delta). Waits for :meth:`finish` and the copies
        it started; queues no device work."""
        self._finished.wait()
        host = self._copy.wait()
        if self.kind == "full":
            return host
        return [LeafDelta(chunk_ids=e["ids"].astype(np.int32),
                          chunks=e["chunks"]) if isinstance(e, dict) else e
                for e in host]


class DeviceDiffSnapshotter:
    """Computes per-leaf chunk deltas against a device-side shadow."""

    def __init__(self, chunk_elems: int = 1024, budget_frac: float = 0.5):
        self.chunk_elems = chunk_elems
        self.budget_frac = budget_frac
        self._shadow: Optional[List[torch.Tensor]] = None
        self._treedef = None

    def _diff(self, new: torch.Tensor, old: torch.Tensor, chunk: int,
              m: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dispatch one leaf's diff: ``(ids [m] int64, data [m, chunk],
        nch int32)`` — the first ``m`` changed chunks in order (ids past
        the changed ones read ``c``, the chunk count)."""
        n = new.numel()
        c = -(-n // chunk)
        pad = c * chunk - n
        dev = new.device

        def chunks(x):
            flat = x.reshape(-1)
            if pad:
                flat = torch.cat([flat, torch.zeros(pad, dtype=x.dtype,
                                                    device=dev)])
            return flat.reshape(c, chunk)
        a = chunks(new)
        changed = (a != chunks(old)).any(dim=1)
        nch = changed.sum(dtype=torch.int32)
        rank = torch.cumsum(changed.to(torch.int32), 0,
                            dtype=torch.int32) - 1
        slot = torch.where(changed & (rank < m), rank, m).to(torch.int64)
        ids = torch.full((m + 1,), c, dtype=torch.int64, device=dev).scatter(
            0, slot, torch.arange(c, dtype=torch.int64, device=dev))[:m]
        return ids, a[ids.clamp(max=c - 1)], nch

    def stage(self, snap, force_full: bool = False) -> StagedSnapshot:
        """Dispatch the snapshot's diff against the shadow (dispatch only)
        and adopt ``snap`` as the next shadow."""
        leaves = [_as_tensor(x) for x in tree_leaves(snap)]
        treedef = tree_structure(snap)
        prev, ptd = self._shadow, self._treedef
        self._shadow, self._treedef = leaves, treedef
        if force_full or prev is None or ptd != treedef \
                or len(prev) != len(leaves):
            return StagedSnapshot("full", snap, leaves)
        staged = StagedSnapshot("delta", snap, leaves)
        nchs = []
        for new, old in zip(leaves, prev):
            if new.shape != old.shape or new.dtype != old.dtype:
                staged.plans.append(("whole", new))
                continue
            n = new.numel()
            if n == 0:
                staged.plans.append(None)
                continue
            chunk = min(self.chunk_elems, n)
            c = -(-n // chunk)
            m = max(1, int(c * self.budget_frac))
            ids, data, nch = self._diff(new, old.to(new.device), chunk, m)
            staged.plans.append(("delta", ids, data, m, len(nchs), new))
            nchs.append(nch)
        if nchs:
            staged._counts = HostCopy(torch.stack(nchs))
            dev = nchs[0].device
            if dev.type == "cuda":
                staged._ready = torch.cuda.Event()
                staged._ready.record(torch.cuda.current_stream(dev))
        return staged

    def snapshot(self, snap) -> Tuple[str, Any]:
        """Returns ``("full", host tree)`` or ``("delta", [LeafEntry...])``
        in one call on the calling thread; the shadow becomes ``snap``."""
        staged = self.stage(snap)
        staged.finish()
        return staged.kind, staged.payload()

    @staticmethod
    def apply(base_host, entries: List[LeafEntry], chunk_elems: int):
        """Apply one delta's entries over a host snapshot (new tree)."""
        leaves = tree_leaves(base_host)
        out = []
        for leaf, e in zip(leaves, entries):
            if e is None:
                out.append(leaf)
            elif isinstance(e, LeafDelta):
                leaf = np.asarray(leaf)
                n = leaf.size
                chunk = min(chunk_elems, max(n, 1))
                c = -(-n // chunk)
                flat = np.zeros((c * chunk,), leaf.dtype)
                flat[:n] = leaf.reshape(-1)
                ch = flat.reshape(c, chunk)
                ch[e.chunk_ids] = e.chunks
                out.append(ch.reshape(-1)[:n].reshape(leaf.shape))
            else:
                out.append(e)                         # whole-leaf payload
        return tree_unflatten(base_host, out)


class IncrementalCheckpointStorage(CheckpointStorage):
    """File-backed delta-chain storage: every ``base_every``-th write is a
    full snapshot; the rest persist only the device-diffed changed
    chunks. Reads reconstruct base + delta chain; deleting a checkpoint
    that later retained deltas still depend on defers the physical
    removal until the chain no longer needs it."""

    #: the coordinator hands device tensors to :meth:`stage`, never a
    #: host copy of the whole snapshot (the transfer this storage avoids)
    wants_host = False

    def __init__(self, root: str, base_every: int = 8,
                 chunk_elems: int = 1024, budget_frac: float = 0.5):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.base_every = base_every
        self.chunk_elems = chunk_elems
        self._snap = DeviceDiffSnapshotter(chunk_elems, budget_frac)
        #: writes staged since the last full one, and the checkpoint id
        #: the shadow holds (both advance at staging)
        self._since_base = 0
        self._shadow_cid: Optional[int] = None
        #: finishes that read change counts from the device (one packed
        #: read each)
        self.packed_reads = 0
        #: cid -> ("full", None) | ("delta", base_cid)
        self._index: Dict[int, Tuple[str, Optional[int]]] = {}
        #: cids logically deleted but physically retained for a chain
        self._zombie: set = set()
        self._order: List[int] = []     # write order
        self._recover_index()

    def _recover_index(self) -> None:
        """Rebuild the chain index from disk (a restart over the same
        directory). Only each file's small meta header is read. Persisted
        tombstones re-mark logical deletions; files whose chain is broken
        are unreadable and deleted."""
        found: Dict[int, Tuple[str, Optional[int]]] = {}
        for fn in os.listdir(self.root):
            if not (fn.startswith("inc_") and fn.endswith(".pkl")):
                continue
            try:
                meta = self._load_meta(int(fn[4:-4]))
                found[meta["checkpoint_id"]] = (meta["kind"], meta["base"])
            except Exception:
                continue

        def chain_ok(cid: int) -> bool:
            seen = set()
            while found[cid][0] == "delta":
                base = found[cid][1]
                if base not in found or base in seen:
                    return False
                seen.add(base)
                cid = base
            return True
        for cid in sorted(found):
            if chain_ok(cid):
                self._index[cid] = found[cid]
                self._order.append(cid)
            else:
                try:
                    os.remove(self._path(cid))
                except OSError:
                    pass
        try:
            with open(self._tomb_path()) as f:
                self._zombie = {c for c in json.load(f) if c in self._index}
        except (OSError, ValueError):
            self._zombie = set()
        self._gc()

    def _path(self, cid: int) -> str:
        return os.path.join(self.root, f"inc_{cid}.pkl")

    def _tomb_path(self) -> str:
        return os.path.join(self.root, "tombstones.json")

    def _write_tombstones(self) -> None:
        tmp = self._tomb_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sorted(self._zombie), f)
        os.replace(tmp, self._tomb_path())

    def stage(self, carry, checkpoint_id: int) -> StagedSnapshot:
        """Dispatch the diff of checkpoint ``checkpoint_id``'s ``carry``
        (device tensors of an owned snapshot, or numpy) on the calling
        thread: a full snapshot every ``base_every``-th write, a delta
        against the shadow otherwise. The shadow moves to ``carry``."""
        force_full = (self._since_base + 1 >= self.base_every
                      or not self._order or self._shadow_cid is None)
        staged = self._snap.stage(carry, force_full=force_full)
        staged.storage = self
        if staged.kind == "delta":
            staged.base = self._shadow_cid
            self._since_base += 1
        else:
            self._since_base = 0
        self._shadow_cid = checkpoint_id
        return staged

    def _drop_shadow(self, staged: StagedSnapshot) -> None:
        """Forget a shadow that will never be persisted: the next write
        is a full one."""
        if self._snap._shadow is staged.leaves:
            self._snap._shadow = None
            self._shadow_cid = None

    def write(self, ckpt: CompletedCheckpoint) -> None:
        staged = ckpt.carry
        if not isinstance(staged, StagedSnapshot):
            staged = self.stage(staged, ckpt.checkpoint_id)
            staged.finish()
        try:
            if staged.kind == "delta" and staged.base not in self._index:
                raise RuntimeError(
                    f"checkpoint {ckpt.checkpoint_id}: delta base "
                    f"{staged.base} was never written")
            payload = staged.payload()
            meta = {"checkpoint_id": ckpt.checkpoint_id,
                    "kind": staged.kind, "base": staged.base,
                    "wall_time": ckpt.wall_time,
                    "chunk_elems": self.chunk_elems}
            tmp = self._path(ckpt.checkpoint_id) + ".tmp"
            with open(tmp, "wb") as f:
                # Object 1: the small meta header (index recovery reads
                # only this). Object 2: the payload.
                pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._path(ckpt.checkpoint_id))
        except BaseException:
            # The shadow holds a snapshot that was never persisted: the
            # next write must not diff against it.
            self._drop_shadow(staged)
            raise
        self._index[ckpt.checkpoint_id] = (staged.kind, staged.base)
        self._order.append(ckpt.checkpoint_id)

    def _load_meta(self, cid: int) -> dict:
        with open(self._path(cid), "rb") as f:
            return pickle.load(f)

    def _load(self, cid: int) -> dict:
        with open(self._path(cid), "rb") as f:
            meta = pickle.load(f)
            meta["payload"] = pickle.load(f)
            return meta

    def _chain(self, cid: int) -> List[int]:
        """cids from the anchoring full snapshot to ``cid`` inclusive."""
        chain = [cid]
        while self._index[chain[0]][0] == "delta":
            chain.insert(0, self._index[chain[0]][1])
        return chain

    def read(self, checkpoint_id: int) -> CompletedCheckpoint:
        if checkpoint_id not in self._index or \
                checkpoint_id in self._zombie:
            raise KeyError(checkpoint_id)
        carry = None
        rec = None
        for cid in self._chain(checkpoint_id):
            rec = self._load(cid)
            if rec["kind"] == "full":
                carry = rec["payload"]
            else:
                carry = DeviceDiffSnapshotter.apply(
                    carry, rec["payload"], rec["chunk_elems"])
        size = int(sum(np.asarray(x).nbytes for x in tree_leaves(carry)))
        return CompletedCheckpoint(
            checkpoint_id=checkpoint_id, carry=carry,
            wall_time=rec["wall_time"], size_bytes=size)

    def delete(self, checkpoint_id: int) -> None:
        if checkpoint_id not in self._index:
            return
        self._zombie.add(checkpoint_id)
        # Tombstones persist so a restart cannot resurrect a logically
        # deleted checkpoint (and its file eventually GCs).
        self._write_tombstones()
        self._gc()

    def _gc(self) -> None:
        # A zombie is removable once no retained checkpoint's chain
        # passes through it.
        needed: set = set()
        for cid in self._index:
            if cid not in self._zombie:
                needed.update(self._chain(cid))
        removed = False
        for cid in [z for z in self._zombie if z not in needed]:
            for p in (self._path(cid), self._path(cid) + ".done"):
                try:
                    os.remove(p)
                except OSError:
                    pass
            self._zombie.discard(cid)
            self._index.pop(cid, None)
            if cid in self._order:
                self._order.remove(cid)
            removed = True
        if removed:
            self._write_tombstones()

    def list_ids(self) -> List[int]:
        return sorted(c for c in self._index if c not in self._zombie)

    def delta_bytes_on_disk(self) -> Dict[int, int]:
        """Per-checkpoint file size (full vs delta)."""
        return {cid: os.path.getsize(self._path(cid))
                for cid in self._index}
