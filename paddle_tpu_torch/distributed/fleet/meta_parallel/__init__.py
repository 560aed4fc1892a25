"""``fleet.meta_parallel``: the tensor-parallel layers and the pipeline
(``PipelineLayer`` and its descriptions, ``PipelineParallel`` with the
FThenB, 1F1B, ZB-H1 and interleaved schedules) and context parallelism
over the ``sep`` group (``context_parallel``: the ring, Ulysses and
all-gather attention)."""

from ...parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                                VocabParallelEmbedding, ParallelCrossEntropy)
from ....framework.random import get_rng_state_tracker
from .context_parallel import (RingFlashAttention, gather_outputs_sequence_dim,
                               ring_flash_attention, sep_attention,
                               sep_attention_manual, sep_axis_is_manual,
                               sep_positions, split_inputs_sequence_dim,
                               ulysses_attention)
from .pipeline_parallel import PipelineParallel
from .pp_layers import (LayerDesc, LocalSharedLayerDesc, PipelineLayer,
                        SharedLayerDesc)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "get_rng_state_tracker", "TensorParallel", "LayerDesc",
           "SharedLayerDesc", "LocalSharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "RingFlashAttention", "ring_flash_attention",
           "ulysses_attention", "sep_attention", "sep_attention_manual",
           "sep_axis_is_manual", "split_inputs_sequence_dim",
           "gather_outputs_sequence_dim", "sep_positions"]


def TensorParallel(model, hcg=None, **kwargs):
    """The model as it is: the tensor-parallel layers hold their shards
    and run their collectives in their forward."""
    return model
