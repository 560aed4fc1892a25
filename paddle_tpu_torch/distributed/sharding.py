"""``paddle.distributed.sharding``: ``group_sharded_parallel`` and its
classes (``fleet.sharding``), ``save_group_sharded_model``, and the
gather of a sharded model's and optimizer's state to full tensors that
it and ``hapi.Model.save`` write through (:func:`full_state`)."""

from __future__ import annotations

import math

import torch

from .fleet.sharding import (DygraphShardingOptimizer, GroupShardedStage3,
                             group_sharded_parallel)

__all__ = ["group_sharded_parallel", "GroupShardedStage3",
           "DygraphShardingOptimizer", "save_group_sharded_model",
           "full_state", "gather_full"]


def _sharding_optimizer(opt):
    while opt is not None and not isinstance(opt, DygraphShardingOptimizer):
        opt = getattr(opt, "_inner", None)
    return opt


def gather_full(t, layout, mp_group, sharding_group, ep_group=None):
    """The full tensor of this rank's part ``t`` under ``layout`` (a
    collective over the groups it is split over: ``mp_group`` for a
    tensor-parallel split, ``ep_group`` for an expert bank's, whose
    layout names ``expert``, ``sharding_group`` for a stage-3 flat
    range)."""
    from .parallel_layers import _all_gather

    def spans(group):
        return group is not None and group.nranks > 1
    t = t.detach()
    if layout is None:
        return t
    if layout.flat is not None:
        flat = t.reshape(-1)
        if spans(sharding_group):
            flat = _all_gather(flat, 0, sharding_group)
        t = flat[:math.prod(layout.flat[2])].view(layout.flat[2])
    if layout.split is not None and layout.split[2] > 1:
        axis = layout.split_axis
        group = ep_group if axis == "expert" else mp_group
        if not spans(group):
            raise ValueError(f"a tensor split over {layout.split[2]} ranks "
                             f"needs their {axis} group to be gathered")
        t = _all_gather(t, layout.split[0], group)
    return t


def _all_stages(model, state):
    """``state`` merged with the other pipeline stages' (host copies,
    gathered over the ``pipe`` group) when ``model`` is a
    ``PipelineLayer`` split over stages."""
    from .fleet.meta_parallel.pp_layers import PipelineLayer
    if not isinstance(model, PipelineLayer) or model._stage is None:
        return state
    from .communication import all_gather_object
    parts = []
    all_gather_object(parts, {k: v.detach().cpu() if isinstance(
        v, torch.Tensor) else v for k, v in state.items()},
        model._hcg.get_pipe_parallel_group())
    merged = {}
    for part in parts:
        merged.update(part)
    return merged


def full_state(model, optimizer=None):
    """``(model state, optimizer state or None)`` with every tensor at the
    unsharded model's full shape, under the unsharded keys: tensor-parallel
    shards and stage-3 slices all-gathered, stage-1/2 partitions merged,
    a pipeline's stages merged (host tensors then). Collectives over the
    fleet's groups: every rank calls it, in the same order."""
    from .checkpoint.metadata import layout_of
    from .fleet.base import current_hcg
    from .fleet.hybrid_optimizer import base_optimizer
    hcg = current_hcg()
    mp_group = hcg.get_model_parallel_group() if hcg else None
    ep_group = hcg.get_expert_parallel_group() if hcg else None
    sharding_group = hcg.get_sharding_parallel_group() if hcg else None
    if isinstance(model, GroupShardedStage3):
        sharding_group = model.group
    state = _all_stages(model, {
        k: gather_full(v, layout_of(v), mp_group, sharding_group, ep_group)
        for k, v in model.state_dict().items()})
    if optimizer is None:
        return state, None
    base = base_optimizer(optimizer)
    zero = _sharding_optimizer(optimizer)
    opt_state = base.state_dict()
    if zero is not None and zero.group.nranks > 1:
        from .communication import all_gather_object
        parts = []
        all_gather_object(parts, {k: (v.detach().cpu() if isinstance(
            v, torch.Tensor) else v) for k, v in opt_state.items()},
            zero.group)
        opt_state = {}
        for part in parts:
            opt_state.update(part)
    full = {}
    for k, v in opt_state.items():
        if isinstance(v, torch.Tensor):
            p = base._param_of(k)
            lay = layout_of(p) if p is not None and v.shape == p.shape \
                else None
            v = gather_full(v.to(p.device) if lay is not None else v, lay,
                            mp_group, sharding_group, ep_group)
        full[k] = v
    return state, _all_stages(model, full)


def save_group_sharded_model(model, output, optimizer=None):
    """Gather a group-sharded model (and optimizer) to full shapes
    (:func:`full_state`) and write ``output/model.pdparams`` (and
    ``model.pdopt``) from the first rank: the files an unsharded model
    writes. Every rank must call it: the gathers are collectives."""
    import os

    from ..framework.io import save
    from .communication import barrier
    from .env import get_rank

    state, opt_state = full_state(model, optimizer)
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
    barrier()
