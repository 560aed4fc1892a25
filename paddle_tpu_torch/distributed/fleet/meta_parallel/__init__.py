"""``fleet.meta_parallel``: its tensor-parallel half. The pipeline
(``PipelineLayer``, ``PipelineParallel``) and context parallelism wait
for ROADMAP A.7 and are not exported."""

from ...parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                                VocabParallelEmbedding, ParallelCrossEntropy)
from ....framework.random import get_rng_state_tracker

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "get_rng_state_tracker", "TensorParallel"]


def TensorParallel(model, hcg=None, **kwargs):
    """The model as it is: the tensor-parallel layers hold their shards
    and run their collectives in their forward."""
    return model
