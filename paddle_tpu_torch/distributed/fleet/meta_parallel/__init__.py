"""``fleet.meta_parallel``: the tensor-parallel layers and the pipeline
(``PipelineLayer`` and its descriptions, ``PipelineParallel`` with the
FThenB, 1F1B, ZB-H1 and interleaved schedules). Context parallelism
waits for ROADMAP A.7 item 2."""

from ...parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                                VocabParallelEmbedding, ParallelCrossEntropy)
from ....framework.random import get_rng_state_tracker
from .pipeline_parallel import PipelineParallel
from .pp_layers import (LayerDesc, LocalSharedLayerDesc, PipelineLayer,
                        SharedLayerDesc)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "get_rng_state_tracker", "TensorParallel", "LayerDesc",
           "SharedLayerDesc", "LocalSharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


def TensorParallel(model, hcg=None, **kwargs):
    """The model as it is: the tensor-parallel layers hold their shards
    and run their collectives in their forward."""
    return model
