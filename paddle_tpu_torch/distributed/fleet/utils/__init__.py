"""``fleet.utils``: recompute and the sequence-parallel helpers."""

from ....incubate.recompute import recompute
from . import sequence_parallel_utils
from .sequence_parallel_utils import (
    ScatterOp, GatherOp, AllGatherOp, ReduceScatterOp,
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)

__all__ = ["recompute", "sequence_parallel_utils", "ScatterOp", "GatherOp",
           "AllGatherOp", "ReduceScatterOp", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]
