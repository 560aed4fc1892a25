"""``fleet.utils``: recompute, the sequence-parallel helpers and the
filesystem clients (``fs``)."""

from ....incubate.recompute import recompute
from . import fs, sequence_parallel_utils
from .fs import (FSFileExistsError, FSFileNotExistsError, HDFSClient,
                 LocalFS)
from .sequence_parallel_utils import (
    ScatterOp, GatherOp, AllGatherOp, ReduceScatterOp,
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)

__all__ = ["recompute", "sequence_parallel_utils", "fs", "LocalFS",
           "HDFSClient", "FSFileExistsError", "FSFileNotExistsError",
           "ScatterOp", "GatherOp",
           "AllGatherOp", "ReduceScatterOp", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]
