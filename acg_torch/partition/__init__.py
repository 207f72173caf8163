"""Partitioning: part vectors (``partitioner``) and the per-part local
views of a partitioned operator (``graph``)."""

from acg_torch.partition.graph import (LocalPartition, PartitionedSystem,
                                       partition_system)
from acg_torch.partition.partitioner import partition_graph

__all__ = ["LocalPartition", "PartitionedSystem", "partition_graph",
           "partition_system"]
