"""Per-task view of the job DAG.

The port's own copy of what it needs of ``clonos_tpu/graph/vertex_info.py``
(a JAX-free, numpy-only module; the port imports nothing of the reference
package): the DAG distances, the determinant sharing mask and the
causal-log identity (flink-runtime .../causal/VertexGraphInformation.java:63,
CausalGraphUtils.computeDistances, CausalGraphUtils.java:41-108,
causal/log/job/CausalLogID.java:38-44).

Vertex IDs are dense small ints assigned in topological order (the reference
ships the topologically-sorted JobVertex list to every task manager,
taskmanager/Task.java:350). Distances are directed downstream hop counts,
used to mask determinant replication by sharing depth: a task holds replicas
of the logs of every task at distance <= depth *upstream* of it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import FrozenSet, List, Sequence, Tuple

import numpy as np

UNREACHABLE = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True, order=True)
class CausalLogID:
    """Identity of one thread causal log.

    ``subpartition == -1`` is the task's main-thread log; ``>= 0`` identifies
    an output-subpartition log (which records BUFFER_BUILT determinants for
    that outgoing edge partition).
    """

    vertex: int
    subtask: int
    subpartition: int = -1

    def is_main_thread(self) -> bool:
        return self.subpartition < 0

    def for_subpartition(self, idx: int) -> "CausalLogID":
        return CausalLogID(self.vertex, self.subtask, idx)


def compute_distances(
    num_vertices: int, edges: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """All-pairs directed downstream hop distance.

    ``dist[u, v]`` = fewest edges on a directed path u -> v; 0 on the
    diagonal; UNREACHABLE where no path exists. BFS per source (DAGs are
    tiny: this is control-plane-only, never in the hot path).
    """
    adj: List[List[int]] = [[] for _ in range(num_vertices)]
    for src, dst in edges:
        adj[src].append(dst)
    dist = np.full((num_vertices, num_vertices), UNREACHABLE, dtype=np.int64)
    for s in range(num_vertices):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[s, v] == UNREACHABLE:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


@dataclasses.dataclass(frozen=True)
class VertexGraphInformation:
    """One task's view of the DAG (shipped to every executor)."""

    vertex: int
    num_vertices: int
    edges: Tuple[Tuple[int, int], ...]          # all DAG edges (vertex ids)
    parallelism: Tuple[int, ...]                # per-vertex subtask counts

    @property
    def upstream(self) -> Tuple[int, ...]:
        return tuple(sorted({s for s, d in self.edges if d == self.vertex}))

    @property
    def downstream(self) -> Tuple[int, ...]:
        return tuple(sorted({d for s, d in self.edges if s == self.vertex}))

    @functools.cached_property
    def _dist(self) -> np.ndarray:
        return compute_distances(self.num_vertices, self.edges)

    def distances(self) -> np.ndarray:
        return self._dist

    def sharing_mask(self, sharing_depth: int) -> np.ndarray:
        """bool[num_vertices, num_vertices]: mask[owner, holder] == True iff
        ``holder`` replicates ``owner``'s determinant log — holders are
        *downstream* of owners within the depth cut (reference
        JobCausalLogImpl.respondToDeterminantRequest:192 enforces the same
        cut on the response path). depth == -1 means full sharing (reference
        ExecutionConfig default). Used to mask the step-boundary replication
        collective."""
        dist = self._dist
        mask = dist != UNREACHABLE
        if sharing_depth >= 0:
            mask = mask & (dist <= sharing_depth)
        mask = mask.copy()
        np.fill_diagonal(mask, True)  # every task holds its own log
        return mask

    def logs_to_replicate(self, sharing_depth: int) -> FrozenSet[int]:
        """Vertices whose causal logs this vertex must hold replicas of:
        the owners column of :meth:`sharing_mask` for this vertex."""
        mask = self.sharing_mask(sharing_depth)
        return frozenset(
            o for o in range(self.num_vertices)
            if o != self.vertex and mask[o, self.vertex])
