"""``paddle.distributed.sharding``: ``group_sharded_parallel`` and its
classes (``fleet.sharding``), and ``save_group_sharded_model``."""

from __future__ import annotations

from .fleet.sharding import (DygraphShardingOptimizer, GroupShardedStage3,
                             group_sharded_parallel)

__all__ = ["group_sharded_parallel", "GroupShardedStage3",
           "DygraphShardingOptimizer", "save_group_sharded_model"]


def save_group_sharded_model(model, output, optimizer=None):
    """Gather a group-sharded model (and optimizer) to full shapes and
    write ``output/model.pdparams`` (and ``model.pdopt``) from the first
    rank. Every rank must call it: the gathers are collectives."""
    import os

    from ..framework.io import save
    from .communication import barrier
    from .env import get_rank

    state = model.full_state_dict() if isinstance(
        model, GroupShardedStage3) else model.state_dict()
    opt_state = None
    if optimizer is not None:
        if isinstance(model, GroupShardedStage3):
            opt_state = _stage3_optimizer_state(model, optimizer)
        elif isinstance(optimizer, DygraphShardingOptimizer):
            opt_state = optimizer.full_state_dict()
        else:
            opt_state = optimizer.state_dict()
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
    barrier()


def _stage3_optimizer_state(model, optimizer):
    """The optimizer's slots of each stage-3 slice gathered to the full
    parameter's shape; other entries as they are."""
    import torch

    from .fleet.hybrid_optimizer import base_optimizer
    from .fleet.sharding import _gather_full
    base = base_optimizer(optimizer)
    state = base.state_dict()
    full = {}
    by_key = {base._param_key(s): s for _, _, s in model.shards()}
    for k, v in state.items():
        keys = [key for key in by_key if k.startswith(key + "_")]
        owner = by_key[max(keys, key=len)] if keys else None
        if isinstance(v, torch.Tensor) and owner is not None and \
                v.shape == owner.shape:
            shape, numel = model._meta[id(owner)]
            v = _gather_full(v, shape, numel, model.group)
        full[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else v
    return full
