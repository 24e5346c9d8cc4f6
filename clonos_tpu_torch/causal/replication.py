"""Determinant replication plan (port of ``clonos_tpu/causal/replication.py``).

Every (owner subtask -> holder subtask) pair within the sharing-depth cut
is one row of a stacked replica log ``[R, capacity, lanes]``. The block
program appends the same determinant rows to owners and (owner-indexed)
replicas, so replica heads equal owner heads at every block fence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from clonos_tpu_torch import device as _device
from clonos_tpu_torch.causal import determinant as det
from clonos_tpu_torch.causal import log as clog
from clonos_tpu_torch.graph.job_graph import JobGraph
from clonos_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    """Static description of who replicates whose log:
    ``pairs[r] = (owner_flat, holder_flat)``. ``replication_factor``
    bounds the holder subtasks per (owner subtask, holder vertex):
    ``(owner_sub + j) % P_holder`` for ``j < factor``; -1 = all."""

    pairs: Tuple[Tuple[int, int], ...]
    num_subtasks: int
    replication_factor: int = -1

    @classmethod
    def from_job(cls, job: JobGraph, sharing_depth: int = -1,
                 replication_factor: int = -1) -> "ReplicationPlan":
        mask = job.graph_info(0).sharing_mask(sharing_depth)
        pairs: List[Tuple[int, int]] = []
        for owner_v in range(len(job.vertices)):
            for holder_v in range(len(job.vertices)):
                if owner_v == holder_v or not mask[owner_v, holder_v]:
                    continue
                ob = job.subtask_base(owner_v)
                hb = job.subtask_base(holder_v)
                hp = job.vertices[holder_v].parallelism
                k = hp if replication_factor < 0 else min(replication_factor,
                                                          hp)
                for os_ in range(job.vertices[owner_v].parallelism):
                    for j in range(k):
                        pairs.append((ob + os_, hb + (os_ + j) % hp))
        return cls(tuple(pairs), job.total_subtasks(), replication_factor)

    @property
    def num_replicas(self) -> int:
        return len(self.pairs)

    def owner_index(self, device, rows=None) -> torch.Tensor:
        """Owner flat id of every replica row, on ``device`` (uploaded
        without a host sync). ``rows=(lo, hi)``: only the replica block a
        rank of a sharded job holds."""
        owners = [o for o, _ in self.pairs]
        if rows is not None:
            owners = owners[rows[0]:rows[1]]
        return _device.upload(np.asarray(owners, np.int64), device)

    def replicas_held_by(self, holder_flat: int) -> List[int]:
        """Replica row indices held by one subtask."""
        return [r for r, (_, h) in enumerate(self.pairs) if h == holder_flat]

    def replicas_of(self, owner_flat: int) -> List[int]:
        return [r for r, (o, _) in enumerate(self.pairs) if o == owner_flat]


def create_replicas(plan: ReplicationPlan, capacity: int, max_epochs: int,
                    device) -> clog.ThreadLogState:
    """Stacked replica logs ``[max(R, 1), capacity, lanes]``."""
    return clog.v_create(max(plan.num_replicas, 1), capacity, max_epochs,
                         device)


def replicate_step(replicas: clog.ThreadLogState,
                   owner_logs: clog.ThreadLogState,
                   owner_idx: torch.Tensor,
                   max_delta: int) -> Tuple[clog.ThreadLogState, torch.Tensor]:
    """One replication round: pull each owner's fresh suffix (at most
    ``max_delta`` rows) into every replica. Returns ``(replicas, lag)``,
    ``lag[r]`` the rows replica r is still behind its owner (nonzero when
    the owner produced more than ``max_delta`` since the last round; the
    next round catches up)."""
    owners = tree_map(lambda x: x[owner_idx], owner_logs)
    buf, count, start = clog.v_slice_from(owners, replicas.head, max_delta)
    new_replicas, _ = clog.v_merge_delta(replicas, buf, count, start)
    return new_replicas, owners.head - new_replicas.head


def sync_replica_epochs(replicas: clog.ThreadLogState, epoch_id
                        ) -> clog.ThreadLogState:
    """Record the epoch index on replicas at the epoch fence."""
    return clog.v_start_epoch(replicas, epoch_id)


def merge_determinant_responses(
    responses: Sequence[Tuple[np.ndarray, int]],
) -> Tuple[np.ndarray, int]:
    """Merge the responses of several holders of one owner log: each is a
    prefix-consistent slice, so the merge is the one reaching furthest,
    extended left to the earliest start. Raises if two holders disagree
    on a shared offset."""
    if not responses:
        return np.zeros((0, det.NUM_LANES), np.int32), 0
    best_rows, best_start = None, 0
    for rows, start in responses:
        if best_rows is None:
            best_rows, best_start = rows.copy(), start
            continue
        lo = max(start, best_start)
        hi = min(start + len(rows), best_start + len(best_rows))
        if hi > lo and not np.array_equal(
                best_rows[lo - best_start: hi - best_start],
                rows[lo - start: hi - start]):
            raise ValueError(
                "divergent determinant responses: replicas disagree on "
                f"offsets [{lo},{hi}) — protocol violation")
        if start + len(rows) > best_start + len(best_rows):
            tail_from = best_start + len(best_rows) - start
            if tail_from < 0:
                best_rows, best_start = rows.copy(), start
            else:
                best_rows = np.concatenate([best_rows, rows[tail_from:]])
        if start < best_start:
            best_rows = np.concatenate([rows[:best_start - start], best_rows])
            best_start = start
    return best_rows, best_start


# --- recovery side: determinant requests (host control plane) ---------------


def collect_determinant_response(
    replicas: clog.ThreadLogState, replica_rows: Sequence[int],
    from_epoch: int, max_out: int,
) -> Dict[int, Tuple[np.ndarray, int]]:
    """Serve a DeterminantRequest from this holder's replica rows
    (reference JobCausalLogImpl.respondToDeterminantRequest:188): for
    each replica row, every retained row from ``from_epoch``'s start, as
    ``{replica_row: (rows ndarray, abs_start)}``."""
    out: Dict[int, Tuple[np.ndarray, int]] = {}
    for r in replica_rows:
        one = tree_map(lambda x: x[r], replicas)
        buf, count, start = clog.get_determinants(one, from_epoch, max_out)
        out[r] = (buf[:int(count)].cpu().numpy(), int(start))
    return out
