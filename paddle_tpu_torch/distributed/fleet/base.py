"""The ``fleet`` singleton and ``DistributedStrategy``: the port of
``paddle_tpu/distributed/fleet/base.py``.

``fleet.init`` joins the process group (``env.init_parallel_env``),
counts the hybrid degrees against the world size (the JAX package counts
devices; each rank here is one process) and builds the topology and its
groups (``HybridCommunicateGroup``). ``dp_degree`` -1 (or 0) fills what
the other degrees leave; degrees whose product is not the world size
raise. Expert parallelism (``ep_degree``) is taken, its ``expert`` group
built as every other axis's; ep with ZeRO (``sharding_degree > 1``)
raises, naming the ROADMAP item that would port it. The
``fleet/init`` event goes through the profiler's tracer, names every
degree and the backend (``env.backend_rule``).

``distributed_model`` returns ``meta_parallel.PipelineParallel`` for a
``PipelineLayer`` at ``pp_degree > 1`` (``accumulate_steps``,
``schedule_mode`` and ``num_virtual_pipeline_stages`` from the strategy's
``pipeline_configs``; the strategy's ``amp`` is not applied to it, with
the JAX package's warning). Any other model it wraps in ``DataParallel``
over the ``data`` group when ``dp_degree > 1``, over the data x sep ranks
(``get_dp_sep_parallel_group``) when ``sep_degree > 1``: the parameters
are replicated over both, and the context-parallel loss's backward seeds
each sep rank's part with the group's count (``context_parallel.
sep_sum``), so the average is the unpartitioned gradient. The ranks of an
``expert`` group hold the same batch and the same replicated parameters,
so nothing is averaged over ``expert``: a MoE layer's collectives sum the
router's gradient there and leave each rank its own bank block's. It runs
its
forward under ``amp.auto_cast`` when the strategy's ``amp`` is on;
tensor-parallel layers need no wrapper (their collectives are in their
forward).
``distributed_optimizer`` wraps the optimizer in
``DygraphShardingOptimizer`` when ``sharding_degree > 1``, then in
``HybridParallelOptimizer`` (the global-norm clip across groups).
"""

from __future__ import annotations

from torch import nn

from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["DistributedStrategy", "Fleet", "fleet", "init", "worker_num",
           "worker_index", "is_first_worker", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "UtilBase"]

class DistributedStrategy:
    """Parallelism knobs (the JAX package's fields). ``hybrid_configs``:
    dp_degree / mp_degree / pp_degree / sharding_degree / sep_degree /
    ep_degree, dp_degree -1 filling the ranks the others leave;
    ``sharding_configs["stage"]`` picks ZeRO stage 1 (default) or 2 for
    ``distributed_optimizer``; ``pipeline_configs`` holds the pipeline's
    ``accumulate_steps`` (microbatches a step), ``schedule_mode``
    (``FThenB``, ``1F1B``, ``ZB-H1`` or ``interleaved``) and
    ``num_virtual_pipeline_stages``."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": -1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "schedule_mode": "FThenB",
                                 "num_virtual_pipeline_stages": None}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    pass


def hybrid_degrees(hybrid_configs, world):
    """``(dp, sharding, pp, sep, mp, ep)`` for ``world`` ranks: the JAX
    package's arithmetic (``dp`` -1 or 0 fills), counted against the
    world size; raises if the product is not the world size, or for ep
    with ZeRO (not ported)."""
    hc = hybrid_configs
    deg = {k: max(int(hc.get(k, 1)), 1) for k in
           ("mp_degree", "pp_degree", "sharding_degree", "sep_degree",
            "ep_degree")}
    if deg["ep_degree"] > 1 and deg["sharding_degree"] > 1:
        raise NotImplementedError(
            f"ep_degree={deg['ep_degree']} with sharding_degree="
            f"{deg['sharding_degree']} (ZeRO over expert-split banks) is "
            "not ported (ROADMAP A.7, expert parallelism x ZeRO); build "
            "the strategy with one of them at 1")
    mp, pp, sh = deg["mp_degree"], deg["pp_degree"], deg["sharding_degree"]
    sep, ep = deg["sep_degree"], deg["ep_degree"]
    dp = int(hc.get("dp_degree", -1))
    if dp in (-1, 0):
        dp = max(world // (mp * pp * sh * sep * ep), 1)
    total = dp * sh * pp * sep * mp * ep
    if total != world:
        raise ValueError(
            f"hybrid degrees {dp}x{sh}x{pp}x{sep}x{mp}x{ep}={total} "
            f"{'exceed' if total > world else 'do not use'} the world "
            f"size {world}: each rank is one process, and every rank "
            "must have a place in the topology")
    return dp, sh, pp, sep, mp, ep


class Fleet:
    def __init__(self):
        self._reset()

    def _reset(self):
        self._strategy = None
        self._hcg: HybridCommunicateGroup | None = None
        self._topology: CommunicateTopology | None = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO", backend=None, device=None):
        """Join the process group (``backend``/``device`` as
        ``init_parallel_env`` takes them) and build the hybrid topology;
        a second call rebuilds the topology over the same group."""
        from ..communication import get_backend
        from ..env import current_device, get_world_size, init_parallel_env
        init_parallel_env(backend=backend, device=device)
        self._strategy = strategy or DistributedStrategy()
        n = get_world_size()
        dims = hybrid_degrees(self._strategy.hybrid_configs, n)
        names = ("data", "sharding", "pipe", "sep", "model", "expert")
        self._topology = CommunicateTopology(names, dims)
        self._hcg = HybridCommunicateGroup(self._topology)
        self._is_initialized = True
        from ...profiler.trace import log_perf_event
        dp, sh, pp, sep, mp, ep = dims
        log_perf_event(
            "fleet/init",
            f"hybrid topology dp{dp} x sharding{sh} x pp{pp} x sep{sep} "
            f"x mp{mp} x ep{ep} over {n} ranks, backend "
            f"{get_backend()} on {current_device()}")
        return self

    def is_first_worker(self):
        from ..env import get_rank
        return get_rank() == 0

    def worker_index(self):
        from ..env import get_rank
        return get_rank()

    def worker_num(self):
        from ..env import get_world_size
        return get_world_size()

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    @property
    def strategy(self):
        return self._strategy

    def distributed_model(self, model):
        if self._hcg is None:
            self.init()
        from .meta_parallel.pp_layers import PipelineLayer
        if isinstance(model, PipelineLayer) and \
                self._hcg.get_pipe_parallel_world_size() > 1:
            from .meta_parallel.pipeline_parallel import PipelineParallel
            if self._strategy.amp:
                import warnings
                warnings.warn(
                    "strategy.amp is not applied to pipeline models: the "
                    "pipeline engine runs each stage's layers itself. Cast "
                    "the model (build it with dtype=torch.bfloat16) or use "
                    "auto_cast inside the loss/layers instead.", UserWarning)
            return PipelineParallel(
                model, self._hcg,
                self._strategy.pipeline_configs.get("accumulate_steps", 1),
                strategy=self._strategy)
        if self._hcg.get_dp_sep_parallel_world_size() > 1:
            from ..parallel import DataParallel
            model = DataParallel(
                model, group=self._hcg.get_dp_sep_parallel_group(),
                find_unused_parameters=self._strategy.find_unused_parameters)
        if self._strategy.amp:
            model = AmpModelWrapper(model, self._strategy.amp_configs)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .hybrid_optimizer import HybridParallelOptimizer
        if self._hcg is None:
            self.init()
        if self._hcg.get_sharding_parallel_world_size() > 1:
            from .sharding import DygraphShardingOptimizer
            stage = int((self._strategy.sharding_configs or {})
                        .get("stage", 1))
            optimizer = DygraphShardingOptimizer(optimizer, self._hcg,
                                                 stage=stage)
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       self._strategy)

    @property
    def util(self):
        return _util_singleton

    def barrier_worker(self):
        from ..communication import barrier
        barrier()

    def stop_worker(self):
        pass


class AmpModelWrapper(nn.Module):
    """The fleet AMP meta-optimizer's role: the wrapped model's forward
    under ``amp.auto_cast`` with the strategy's amp_configs; attributes
    fall through to the model."""

    def __init__(self, model, amp_configs):
        super().__init__()
        self.model = model
        cfg = dict(amp_configs or {})
        self._amp_kw = {
            "level": cfg.get("level", "O1"),
            "dtype": cfg.get("dtype", "bfloat16"),
            "custom_white_list": cfg.get("custom_white_list"),
            "custom_black_list": cfg.get("custom_black_list"),
        }

    def forward(self, *args, **kwargs):
        from ...amp import auto_cast
        with auto_cast(True, **self._amp_kw):
            return self.model(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["model"], name)


fleet = Fleet()


def init(role_maker=None, is_collective=True, strategy=None, **kwargs):
    return fleet.init(role_maker, is_collective, strategy, **kwargs)


def worker_num():
    return fleet.worker_num()


def worker_index():
    return fleet.worker_index()


def is_first_worker():
    return fleet.is_first_worker()


def current_hcg():
    """The initialised fleet's ``HybridCommunicateGroup``, or None."""
    return fleet._hcg


class UtilBase:
    """``fleet.util``: host-side collectives over objects, and a file
    list sharded over the workers."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np

        from ..communication import all_gather_object
        if mode not in ("sum", "min", "max"):  # before the collective
            raise ValueError(f"util.all_reduce: unknown mode {mode!r}")
        parts: list = []
        all_gather_object(parts, input)
        return getattr(np.asarray(parts), mode)(0)

    def barrier(self, comm_world="worker"):
        from ..communication import barrier as _barrier
        _barrier()

    def all_gather(self, input, comm_world="worker"):
        from ..communication import all_gather_object
        out: list = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Split a file list contiguously across workers (earlier workers
        get the remainder)."""
        from ..env import get_rank, get_world_size
        n, rank = get_world_size(), get_rank()
        total = len(files)
        base, rem = divmod(total, n)
        start = rank * base + min(rank, rem)
        return list(files[start:start + base + (1 if rank < rem else 0)])

    def print_on_rank(self, message, rank_id=0):
        from ..env import get_rank
        if get_rank() == rank_id:
            print(message)


_util_singleton = UtilBase()

