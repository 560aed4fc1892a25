"""``paddle.distributed.parallelize``: the port of
``paddle_tpu/distributed/parallelize.py``, over the tensor-parallel
layers of ``parallel_layers``.

A ``parallelize_plan`` maps sublayer names (``fnmatch`` patterns) to
placements. Where the JAX package re-places the matched weights with a
``NamedSharding`` and lets GSPMD lay out the activations, the port
replaces each matched layer by its parallel form holding the rank's
shard of the layer's current weights:

- ``ColWiseParallel``: a ``Linear`` becomes a ``ColumnParallelLinear``
  (output split on its features unless ``gather_output``); an
  ``Embedding`` stays whole on every rank (the JAX package splits its
  hidden dim, which changes no number);
- ``RowWiseParallel``: a ``Linear`` becomes a ``RowParallelLinear``
  (input split on its features, as a ``ColWiseParallel`` layer before it
  leaves it, unless ``is_input_parallel=False``); an ``Embedding``
  becomes a ``VocabParallelEmbedding``.

``PrepareLayerInput``/``PrepareLayerOutput`` wrap a layer's forward in
``fn``. Without a fleet, ``parallelize`` initialises one whose
``mp_degree`` is ``config["mp_config"]["mp_degree"]`` (all ranks when
absent); ``dp_config["sharding_level"]`` wraps the optimizer in
``DygraphShardingOptimizer`` (stage 1 or 2 by the level).
"""

from __future__ import annotations

import fnmatch
import warnings

import torch
from torch import nn

__all__ = ["parallelize", "ColWiseParallel", "RowWiseParallel",
           "PrepareLayerInput", "PrepareLayerOutput"]


class _Placement:
    def apply(self, layer):
        return layer


class ColWiseParallel(_Placement):
    def __init__(self, gather_output=False):
        self.gather_output = gather_output

    def apply(self, layer):
        from .parallel_layers import ColumnParallelLinear
        if isinstance(layer, nn.Linear):
            new = ColumnParallelLinear(
                layer.in_features, layer.out_features,
                has_bias=layer.bias is not None,
                gather_output=self.gather_output,
                device=layer.weight.device, dtype=layer.weight.dtype)
            return _load_shards(new, layer)
        return layer


class RowWiseParallel(_Placement):
    def __init__(self, is_input_parallel=True):
        self.is_input_parallel = is_input_parallel

    def apply(self, layer):
        from .parallel_layers import RowParallelLinear, VocabParallelEmbedding
        if isinstance(layer, nn.Linear):
            new = RowParallelLinear(
                layer.in_features, layer.out_features,
                has_bias=layer.bias is not None,
                input_is_parallel=self.is_input_parallel,
                device=layer.weight.device, dtype=layer.weight.dtype)
            return _load_shards(new, layer)
        if isinstance(layer, nn.Embedding):
            new = VocabParallelEmbedding(
                layer.num_embeddings, layer.embedding_dim,
                device=layer.weight.device, dtype=layer.weight.dtype)
            return _load_shards(new, layer)
        return layer


class PrepareLayerInput(_Placement):
    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer):
        if self.fn is not None:
            layer.register_forward_pre_hook(lambda mod, args: self.fn(*args))
        return layer


class PrepareLayerOutput(_Placement):
    def __init__(self, fn=None):
        self.fn = fn

    def apply(self, layer):
        if self.fn is not None:
            layer.register_forward_hook(
                lambda mod, args, out: self.fn(out))
        return layer


@torch.no_grad()
def _load_shards(new, old):
    from .parallel_layers import shard_of
    for name, p in new.named_parameters(recurse=False):
        p.copy_(shard_of(new, name, getattr(old, name).detach()))
        for attr in ("param_name", "regularizer", "need_clip"):
            if hasattr(getattr(old, name), attr):
                setattr(p, attr, getattr(getattr(old, name), attr))
    return new


def _ensure_fleet(config):
    from .env import get_world_size
    from .fleet import base as fb
    if fb.fleet._hcg is not None:
        return fb.fleet._hcg
    mp = int((config.get("mp_config") or {}).get("mp_degree", 0) or 0)
    strategy = fb.DistributedStrategy()
    strategy.hybrid_configs.update(mp_degree=mp or get_world_size())
    fb.fleet.init(strategy=strategy)
    return fb.fleet._hcg


def _swap(model, name, new):
    parent_name, _, attr = name.rpartition(".")
    parent = model.get_submodule(parent_name) if parent_name else model
    setattr(parent, attr, new)


def parallelize(model, optimizer=None, mesh=None, config=None):
    """Apply a parallelize_plan to ``model`` (module docstring) and wrap
    ``optimizer`` for sharding when ``dp_config`` asks. Returns
    ``(model, optimizer)``."""
    config = config or {}
    plan = (config.get("mp_config") or {}).get("parallelize_plan") or {}
    bad = [v for v in plan.values() if not isinstance(v, _Placement)]
    if bad:
        raise TypeError(
            f"parallelize_plan values must be placements, got {bad[:3]}")
    if plan:
        _ensure_fleet(config)
        matched = set()
        for lname, layer in list(model.named_modules()):
            if not lname:
                continue
            for pattern, placement in plan.items():
                if fnmatch.fnmatch(lname, pattern) or lname == pattern:
                    matched.add(pattern)
                    new = placement.apply(layer)
                    if new is not layer:
                        _swap(model, lname, new)
                    break
        unmatched = set(plan) - matched
        if unmatched:
            warnings.warn(f"parallelize: plan patterns matched no "
                          f"sublayer: {sorted(unmatched)}")
    level = (config.get("dp_config") or {}).get("sharding_level")
    if optimizer is not None and level:
        from .fleet.sharding import DygraphShardingOptimizer
        hcg = _ensure_fleet(config)
        optimizer = DygraphShardingOptimizer(
            optimizer, hcg, stage=2 if str(level) in ("2", "os_g") else 1)
    return model, optimizer
