"""User-facing job builder: the StreamExecutionEnvironment analog (port of
``clonos_tpu/api/environment.py``, main-path transformations).

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
    FilterOperator, KeyedReduceOperator, MapOperator, Operator, SinkOperator,
    SyntheticSource, TumblingWindowCountOperator,
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

    def _attach(self, name: str, op: Operator, parallelism: Optional[int],
                partition: Optional[PartitionType] = None,
                capacity: Optional[int] = None) -> "DataStream":
        p = parallelism or self._vertex.parallelism
        v = self._env.graph.add_vertex(name, op, p)
        if partition is None:
            if self._keyed:
                partition = PartitionType.HASH
            elif self._force_rebalance:
                partition = PartitionType.REBALANCE
            elif p == self._vertex.parallelism:
                partition = PartitionType.FORWARD
            else:
                partition = PartitionType.REBALANCE
        cap = capacity or self._env.default_edge_capacity
        self._env.graph.add_edge(self._vertex, v, partition, cap)
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

    def sink(self, name: str = "sink",
             parallelism: Optional[int] = None) -> "DataStream":
        return self._attach(name, SinkOperator(), parallelism)

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

    def build(self) -> JobGraph:
        self.graph.validate()
        return self.graph
