"""Job graph: the topology handed to the executor (port of
``clonos_tpu/graph/job_graph.py``). Vertices carry an operator and a
parallelism; edges carry the partition strategy and the receive capacity
per downstream subtask per superstep."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Sequence, Tuple

from clonos_tpu_torch.api.operators import Operator
from clonos_tpu_torch.graph.vertex_info import VertexGraphInformation


class PartitionType(enum.Enum):
    FORWARD = "forward"      # 1:1, same parallelism
    HASH = "hash"            # keyBy: key-group routing
    REBALANCE = "rebalance"  # deterministic round-robin
    BROADCAST = "broadcast"  # every record to every subtask


@dataclasses.dataclass
class JobVertex:
    """One logical operator instance in the DAG."""

    vertex_id: int
    name: str
    operator: Operator
    parallelism: int


@dataclasses.dataclass
class JobEdge:
    """Directed edge with exchange semantics; ``capacity`` is the receive
    buffer per downstream subtask per superstep (overflow drops)."""

    src: int
    dst: int
    partition: PartitionType
    capacity: int


@dataclasses.dataclass
class JobGraph:
    """The deployable topology."""

    vertices: List[JobVertex] = dataclasses.field(default_factory=list)
    edges: List[JobEdge] = dataclasses.field(default_factory=list)
    name: str = "job"
    num_key_groups: int = 128
    sharing_depth: int = -1

    def add_vertex(self, name: str, operator: Operator,
                   parallelism: int) -> JobVertex:
        v = JobVertex(len(self.vertices), name, operator, parallelism)
        self.vertices.append(v)
        return v

    def add_edge(self, src: JobVertex, dst: JobVertex,
                 partition: PartitionType, capacity: int) -> JobEdge:
        if partition == PartitionType.FORWARD and \
                src.parallelism != dst.parallelism:
            raise ValueError(
                f"FORWARD edge requires equal parallelism: "
                f"{src.name}({src.parallelism}) -> "
                f"{dst.name}({dst.parallelism})")
        e = JobEdge(src.vertex_id, dst.vertex_id, partition, capacity)
        self.edges.append(e)
        return e

    def in_edges(self, vertex_id: int) -> List[int]:
        return [i for i, e in enumerate(self.edges) if e.dst == vertex_id]

    def out_edges(self, vertex_id: int) -> List[int]:
        return [i for i, e in enumerate(self.edges) if e.src == vertex_id]

    def topo_order(self) -> List[int]:
        """Topologically sorted vertex ids (smallest ready id first)."""
        indeg = {v.vertex_id: 0 for v in self.vertices}
        for e in self.edges:
            indeg[e.dst] += 1
        ready = sorted(v for v, d in indeg.items() if d == 0)
        order: List[int] = []
        while ready:
            u = ready.pop(0)
            order.append(u)
            for i in self.out_edges(u):
                d = self.edges[i].dst
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
            ready.sort()
        if len(order) != len(self.vertices):
            raise ValueError("job graph has a cycle")
        return order

    def graph_info(self, vertex_id: int) -> VertexGraphInformation:
        return VertexGraphInformation(
            vertex=vertex_id,
            num_vertices=len(self.vertices),
            edges=tuple((e.src, e.dst) for e in self.edges),
            parallelism=tuple(v.parallelism for v in self.vertices),
        )

    def total_subtasks(self) -> int:
        return sum(v.parallelism for v in self.vertices)

    def subtask_base(self, vertex_id: int) -> int:
        """Global flat index of (vertex, subtask 0) in the stacked-log
        layout (all subtasks of all vertices, in vertex-id order)."""
        return sum(v.parallelism for v in self.vertices[:vertex_id])

    def subgraph(self, vertex_ids: Sequence[int], feed_batch_size: int = 8
                 ) -> Tuple["JobGraph", Dict[int, int],
                            Dict[int, int], Dict[int, int]]:
        """Deployment slice over ``vertex_ids`` (``runtime/scheduler.py``'s
        unit of placement, the per-TaskExecutor TaskDeploymentDescriptor
        analog). Cut edges become boundary vertices:

        - every in-cut edge (src outside the slice) is replaced by a
          ``HostFeedSource`` at parallelism 1 feeding the kept dst through
          the ORIGINAL partition and capacity: the records arrive from the
          upstream worker over the wire (a rewindable reader,
          ``api/feeds.py``);
        - every out-cut edge (dst outside the slice) gets a terminal
          ``SinkOperator`` on a FORWARD edge, which keeps the producer's
          in-flight out-ring in the slice: that ring is what the worker's
          edge export serves (and replays) to downstream workers.

        Returns ``(sub, vmap, feeds, exports)``: ``vmap`` maps original
        vertex id -> slice vertex id, ``feeds`` original in-cut edge index
        -> slice feed vertex id, ``exports`` original out-cut edge index
        -> slice vertex id of the producer whose ring serves that edge.
        The structure depends only on ``(vertex_ids, feed_batch_size)``,
        so the JobMaster and the workers derive identical slices."""
        from clonos_tpu_torch.api.operators import (HostFeedSource,
                                                    SinkOperator)
        keep = set(vertex_ids)
        unknown = keep - {v.vertex_id for v in self.vertices}
        if unknown:
            raise ValueError(f"subgraph: unknown vertex ids {sorted(unknown)}")
        sub = JobGraph(name=f"{self.name}-slice",
                       num_key_groups=self.num_key_groups,
                       sharing_depth=self.sharing_depth)
        vmap: Dict[int, int] = {}
        for vid in self.topo_order():
            if vid in keep:
                v = self.vertices[vid]
                vmap[vid] = sub.add_vertex(v.name, v.operator,
                                           v.parallelism).vertex_id
        feeds: Dict[int, int] = {}
        exports: Dict[int, int] = {}
        for eidx, e in enumerate(self.edges):
            if e.src in keep and e.dst in keep:
                sub.add_edge(sub.vertices[vmap[e.src]],
                             sub.vertices[vmap[e.dst]],
                             e.partition, e.capacity)
            elif e.dst in keep:
                # The wire export flattens the producer's lanes into ONE
                # record stream, so only exchange edges (which re-route
                # through the partition anyway) can be cut; a FORWARD cut
                # would need per-lane streams to keep lane affinity.
                if e.partition == PartitionType.FORWARD:
                    raise ValueError(
                        f"subgraph: cut crosses FORWARD edge {eidx} "
                        f"({self.vertices[e.src].name} -> "
                        f"{self.vertices[e.dst].name}); slice boundaries "
                        f"must land on exchange edges")
                fv = sub.add_vertex(f"feed-in-{eidx}",
                                    HostFeedSource(
                                        batch_size=feed_batch_size), 1)
                sub.add_edge(fv, sub.vertices[vmap[e.dst]],
                             e.partition, e.capacity)
                feeds[eidx] = fv.vertex_id
            elif e.src in keep:
                src = sub.vertices[vmap[e.src]]
                sv = sub.add_vertex(f"export-{eidx}", SinkOperator(),
                                    src.parallelism)
                sub.add_edge(src, sv, PartitionType.FORWARD, e.capacity)
                exports[eidx] = vmap[e.src]
        sub.validate()
        return sub, vmap, feeds, exports

    def validate(self) -> None:
        from clonos_tpu_torch.api.operators import TwoInputOperator
        self.topo_order()
        for v in self.vertices:
            ins = self.in_edges(v.vertex_id)
            two = isinstance(v.operator, TwoInputOperator)
            if two and len(ins) != 2:
                raise ValueError(
                    f"vertex {v.name}: TwoInputOperator needs exactly 2 "
                    f"input edges, has {len(ins)}")
            if not two and len(ins) > 1:
                raise ValueError(
                    f"vertex {v.name}: single-input operator with "
                    f"{len(ins)} input edges (use a TwoInputOperator)")
