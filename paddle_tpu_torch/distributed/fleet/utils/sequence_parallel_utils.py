"""Megatron-style sequence parallelism: the port of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``.

The JAX package turns these ops into sharding constraints on the
sequence dim and lets GSPMD insert the collectives. The port runs the
collectives themselves, as Paddle does, over the ``model`` group along
``axis`` (the sequence dim, 1 in [B, S, H]):

- ``ScatterOp``: forward the rank's slice, backward an all-gather;
- ``GatherOp``: forward an all-gather, backward the rank's slice;
- ``AllGatherOp``: forward an all-gather, backward a reduce-scatter;
- ``ReduceScatterOp``: forward a reduce-scatter, backward an all-gather.

``ColumnSequenceParallelLinear`` all-gathers its sequence-split input
(``AllGatherOp``) before the column-split matmul; ``RowSequence
ParallelLinear`` reduce-scatters its partial outputs onto the sequence
dim. A parameter used on sequence-split activations (the norms) sees
only its rank's rows: ``mark_as_sequence_parallel_parameter`` tags it,
and ``register_sequence_parallel_allreduce_hooks`` adds a gradient hook
to each tagged parameter that all-reduces its gradient over the group
(all-reduce is linear, so each contribution is summed on its own and
accumulation over micro-batches stays right).
"""

from __future__ import annotations

from ...parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                                _matmul, all_gather_dim, gather_dim, mp_info,
                                reduce_scatter_dim, split_dim, _all_reduce)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks"]


def ScatterOp(x, axis=1, group=None):
    group, world, _ = mp_info(group)
    return x if world <= 1 else split_dim(x, axis, group)


def GatherOp(x, axis=1, group=None):
    group, world, _ = mp_info(group)
    return x if world <= 1 else gather_dim(x, axis, group)


def AllGatherOp(x, axis=1, group=None):
    group, world, _ = mp_info(group)
    return x if world <= 1 else all_gather_dim(x, axis, group)


def ReduceScatterOp(x, axis=1, group=None):
    group, world, _ = mp_info(group)
    return x if world <= 1 else reduce_scatter_dim(x, axis, group)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-split linear over a sequence-split input [B, S/mp, in]:
    the sequence all-gathered, then the local matmul; the output
    [B, S, out/mp] stays split on its features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, device=None, dtype=None):
        if gather_output:
            raise ValueError("ColumnSequenceParallelLinear: gather_output "
                             "is not supported")
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         False, mp_group=mp_group, device=device,
                         dtype=dtype)

    def forward(self, x):
        if self.mp_world > 1:
            x = all_gather_dim(x, 1, self.group)
        return super(ColumnParallelLinear, self).forward(x)


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-split linear whose partial outputs are reduce-scattered onto
    the sequence dim: [B, S, in/mp] -> [B, S/mp, out]; the bias (not
    split) is added after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         True, mp_group=mp_group, device=device,
                         dtype=dtype)

    def forward(self, x):
        if self.mp_world == 1:
            return super().forward(x)
        out = reduce_scatter_dim(_matmul(x, self.weight), 1, self.group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True
    return param


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False,
        group=None):
    """A gradient hook on each parameter tagged by
    :func:`mark_as_sequence_parallel_parameter`: its gradient summed over
    the ``model`` group. Returns the model."""
    group, world, _ = mp_info(group)
    if world <= 1:
        return model
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False) and \
                not getattr(p, "_sp_hooked", False):
            p.register_hook(lambda g, grp=group: _all_reduce(g, grp))
            p._sp_hooked = True
    return model
