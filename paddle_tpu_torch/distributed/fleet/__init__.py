"""``distributed.fleet`` of the port: ``fleet.init`` and the hybrid
topology (``base``, ``topology``), ``distributed_model`` and
``distributed_optimizer``, the tensor-parallel layers, ZeRO sharding
(``sharding``), ``meta_parallel``'s tensor-parallel half, the
sequence-parallel ``utils``, and ``elastic`` (preemption and the
heartbeat manager, standard library only). Names load at first use, so
``fleet.elastic`` stays free of torch for the launcher."""

import importlib

_NAMES = {
    ".base": ("fleet", "init", "DistributedStrategy", "Fleet", "UtilBase",
              "worker_num", "worker_index", "is_first_worker",
              "PaddleCloudRoleMaker", "UserDefinedRoleMaker"),
    ".topology": ("CommunicateTopology", "HybridCommunicateGroup"),
    "..parallel_layers": ("ColumnParallelLinear", "RowParallelLinear",
                          "VocabParallelEmbedding", "ParallelCrossEntropy"),
    ".sharding": ("DygraphShardingOptimizer", "group_sharded_parallel",
                  "GroupShardedStage3"),
    "...framework.random": ("get_rng_state_tracker",),
}
_MODULES = ("elastic", "base", "topology", "meta_parallel", "utils",
            "sharding", "hybrid_optimizer")
_LAZY = {name: mod for mod, names in _NAMES.items() for name in names}
_FLEET_METHODS = ("distributed_model", "distributed_optimizer",
                  "get_hybrid_communicate_group")

__all__ = sorted(set(_LAZY) | set(_MODULES) | set(_FLEET_METHODS))


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _FLEET_METHODS:
        return getattr(importlib.import_module(".base", __name__).fleet,
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
