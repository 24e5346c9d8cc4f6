"""User-facing job builder: the StreamExecutionEnvironment analog (port of
``clonos_tpu/api/environment.py``).

    env = StreamEnvironment(num_key_groups=128)
    (env.synthetic_source(vocab=1000, batch_size=64, parallelism=4)
        .key_by()
        .window_count(num_keys=1000, window_size=5)
        .sink())
    job = env.build()
"""

from __future__ import annotations

from typing import Optional

import torch

from clonos_tpu_torch.api.operators import (
    EventTimeTumblingWindowOperator, FilterOperator, HostFeedSource,
    IntervalJoinOperator, KeyedReduceOperator, MapOperator, Operator,
    SessionWindowOperator, SinkOperator, SlidingEventTimeWindowOperator,
    SyntheticSource, TransactionalSinkOperator, TumblingWindowCountOperator,
    UnionOperator,
)
from clonos_tpu_torch.graph.job_graph import JobGraph, JobVertex, PartitionType


class DataStream:
    """Handle to a vertex's output; transformation methods append vertices."""

    def __init__(self, env: "StreamEnvironment", vertex: JobVertex,
                 keyed: bool = False, force_rebalance: bool = False):
        self._env = env
        self._vertex = vertex
        self._keyed = keyed
        self._force_rebalance = force_rebalance

    def key_by(self) -> "DataStream":
        """Marks the next operator's input as HASH-partitioned by key."""
        return DataStream(self._env, self._vertex, keyed=True)

    def rebalance(self) -> "DataStream":
        return DataStream(self._env, self._vertex, force_rebalance=True)

    def _partition_to(self, p: int) -> PartitionType:
        """The exchange from this stream into a vertex of parallelism p."""
        if self._keyed:
            return PartitionType.HASH
        if self._force_rebalance or p != self._vertex.parallelism:
            return PartitionType.REBALANCE
        return PartitionType.FORWARD

    def _attach(self, name: str, op: Operator, parallelism: Optional[int],
                partition: Optional[PartitionType] = None,
                capacity: Optional[int] = None) -> "DataStream":
        p = parallelism or self._vertex.parallelism
        v = self._env.graph.add_vertex(name, op, p)
        cap = capacity or self._env.default_edge_capacity
        self._env.graph.add_edge(self._vertex, v,
                                 partition or self._partition_to(p), cap)
        return DataStream(self._env, v)

    def _attach2(self, other: "DataStream", name: str, op: Operator,
                 parallelism: Optional[int],
                 capacity: Optional[int] = None) -> "DataStream":
        """Two-input attachment: edge order is (self=left, other=right)."""
        p = parallelism or self._vertex.parallelism
        v = self._env.graph.add_vertex(name, op, p)
        cap = capacity or self._env.default_edge_capacity
        for side in (self, other):
            self._env.graph.add_edge(side._vertex, v, side._partition_to(p),
                                     cap)
        return DataStream(self._env, v)

    def map(self, fn, name: str = "map",
            parallelism: Optional[int] = None) -> "DataStream":
        return self._attach(name, MapOperator(fn), parallelism)

    def filter(self, pred, name: str = "filter",
               parallelism: Optional[int] = None) -> "DataStream":
        return self._attach(name, FilterOperator(pred), parallelism)

    def reduce(self, num_keys: int, reduce_fn=None, name: str = "reduce",
               parallelism: Optional[int] = None) -> "DataStream":
        if not self._keyed:
            raise ValueError("reduce requires key_by() first")
        op = KeyedReduceOperator(num_keys=num_keys,
                                 reduce_fn=reduce_fn or torch.add)
        return self._attach(name, op, parallelism)

    def window_count(self, num_keys: int, window_size: int,
                     name: str = "window",
                     parallelism: Optional[int] = None) -> "DataStream":
        if not self._keyed:
            raise ValueError("window_count requires key_by() first")
        return self._attach(
            name, TumblingWindowCountOperator(num_keys=num_keys,
                                              window_size=window_size),
            parallelism)

    def window_event_time(self, num_keys: int, window_size: int,
                          out_of_orderness: int = 0,
                          name: str = "event-window",
                          parallelism: Optional[int] = None
                          ) -> "DataStream":
        """Event-time tumbling window (watermark: a pure fold over record
        timestamps with bounded out-of-orderness)."""
        if not self._keyed:
            raise ValueError("window_event_time requires key_by() first")
        return self._attach(
            name, EventTimeTumblingWindowOperator(
                num_keys=num_keys, window_size=window_size,
                out_of_orderness=out_of_orderness), parallelism)

    def window_slide_event_time(self, num_keys: int, window_size: int,
                                slide: int, out_of_orderness: int = 0,
                                name: str = "sliding-window",
                                parallelism: Optional[int] = None
                                ) -> "DataStream":
        """Event-time sliding window."""
        if not self._keyed:
            raise ValueError(
                "window_slide_event_time requires key_by() first")
        return self._attach(
            name, SlidingEventTimeWindowOperator(
                num_keys=num_keys, window_size=window_size, slide=slide,
                out_of_orderness=out_of_orderness), parallelism)

    def window_session(self, num_keys: int, gap: int,
                       out_of_orderness: int = 0,
                       name: str = "session-window",
                       parallelism: Optional[int] = None) -> "DataStream":
        """Event-time session window."""
        if not self._keyed:
            raise ValueError("window_session requires key_by() first")
        return self._attach(
            name, SessionWindowOperator(num_keys=num_keys, gap=gap,
                                        out_of_orderness=out_of_orderness),
            parallelism)

    def union(self, other: "DataStream", capacity: Optional[int] = None,
              name: str = "union",
              parallelism: Optional[int] = None) -> "DataStream":
        cap = capacity or self._env.default_edge_capacity
        return self._attach2(other, name, UnionOperator(capacity=cap),
                             parallelism, cap)

    def join(self, other: "DataStream", num_keys: int, window: int,
             interval: int, capacity: Optional[int] = None,
             name: str = "join",
             parallelism: Optional[int] = None) -> "DataStream":
        """Keyed interval join: self is the left (buffered) side, other the
        right (probing) side. Both inputs must be key_by()'d."""
        if not (self._keyed and other._keyed):
            raise ValueError("join requires key_by() on both inputs")
        cap = capacity or self._env.default_edge_capacity
        op = IntervalJoinOperator(num_keys=num_keys, window=window,
                                  interval=interval, capacity=cap)
        return self._attach2(other, name, op, parallelism, cap)

    def sink(self, name: str = "sink",
             parallelism: Optional[int] = None,
             transactional: bool = False) -> "DataStream":
        """``transactional=True`` routes emissions through the two-phase
        commit transaction log (exactly-once egress, ``runtime/txn.py``)."""
        op = TransactionalSinkOperator() if transactional else SinkOperator()
        return self._attach(name, op, parallelism)

    @property
    def vertex(self) -> JobVertex:
        return self._vertex


class StreamEnvironment:
    """Builder root (StreamExecutionEnvironment analog)."""

    def __init__(self, name: str = "job", num_key_groups: int = 128,
                 sharing_depth: int = -1, default_edge_capacity: int = 256):
        self.graph = JobGraph(name=name, num_key_groups=num_key_groups,
                              sharing_depth=sharing_depth)
        self.default_edge_capacity = default_edge_capacity

    def source(self, op: Operator, parallelism: int = 1,
               name: str = "source") -> DataStream:
        v = self.graph.add_vertex(name, op, parallelism)
        return DataStream(self, v)

    def synthetic_source(self, vocab: int, batch_size: int,
                         parallelism: int = 1, name: str = "source",
                         rate_limit: Optional[int] = None) -> DataStream:
        return self.source(
            SyntheticSource(vocab=vocab, batch_size=batch_size,
                            rate_limit=rate_limit),
            parallelism, name)

    def host_source(self, batch_size: int, parallelism: int = 1,
                    name: str = "host-source") -> DataStream:
        """Externally fed source (register a FeedReader on the executor:
        ``executor.register_feed(vertex_id, reader)``)."""
        return self.source(HostFeedSource(batch_size=batch_size),
                           parallelism, name)

    def build(self) -> JobGraph:
        self.graph.validate()
        return self.graph
