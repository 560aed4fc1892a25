"""``distributed`` of the port: the process group and its collectives
(``env``, ``communication``, ``spawn``), the hybrid topology and
``fleet``, the tensor-parallel layers (``parallel_layers``) and sequence
parallelism, ``DataParallel``, ZeRO sharding (``sharding``),
``parallelize``, the sharded checkpoints with their commit protocol
across ranks and resharding on load (``checkpoint``), the elastic
manager (``fleet.elastic``) and the launcher (``launch``).

Names load at first use, so the launcher's imports stay free of torch.
The pipeline, context and expert parallelism, the auto-parallel API and
RPC are not ported yet (ROADMAP A.7)."""

import importlib

_NAMES = {
    ".env": ("init_parallel_env", "get_rank", "get_world_size",
             "is_initialized", "ParallelEnv"),
    ".communication": (
        "all_reduce", "all_gather", "all_gather_object", "reduce_scatter",
        "alltoall", "alltoall_single", "broadcast", "broadcast_object_list",
        "reduce", "scatter", "send", "recv", "isend", "irecv", "barrier",
        "new_group", "get_group", "wait", "ReduceOp", "P2POp",
        "batch_isend_irecv", "stream", "gather", "scatter_object_list",
        "destroy_process_group", "get_backend", "is_available"),
    ".parallel": ("DataParallel",),
    ".parallel_layers": ("ColumnParallelLinear", "RowParallelLinear",
                         "VocabParallelEmbedding", "ParallelCrossEntropy",
                         "split"),
    ".spawn_api": ("spawn",),
    ".parallelize": ("parallelize", "ColWiseParallel", "RowWiseParallel",
                     "PrepareLayerInput", "PrepareLayerOutput"),
}
_MODULES = ("checkpoint", "fleet", "launch", "sharding", "utils", "env",
            "communication", "parallel", "parallel_layers", "spawn_api")
_LAZY = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(set(_LAZY) | set(_MODULES) | {"gloo_barrier"})


def gloo_barrier():
    """A barrier over the world group."""
    from .communication import barrier
    barrier()


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(_LAZY[name], __name__)
        # bind every name of the module: ``parallelize`` the function
        # shadows its module, as in the JAX package (the import set the
        # package's attribute to the module)
        for other in _NAMES[_LAZY[name]]:
            globals()[other] = getattr(mod, other)
        return globals()[name]
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
