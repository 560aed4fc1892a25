"""The process group of a multi-rank run: the port of
``paddle_tpu/distributed/env.py``.

The JAX package runs one controller over every device of a mesh; the
port runs one process per rank, as Paddle does. ``init_parallel_env``
joins the ranks through ``torch.distributed.init_process_group`` from the
launcher's environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER`` or ``MASTER_ADDR``/``MASTER_PORT``; ``PADDLE_LOCAL_RANK``
and ``PADDLE_LOCAL_SIZE`` where the launcher sets them, else the rank and
the world size of one host).

Each rank's device is ``cuda:<local_rank % device_count>`` unless the
caller passes ``device="cpu"``; with no GPU and no device it raises. The
backend follows one rule (:func:`backend_rule`): ``nccl`` when every rank
of the host has a card of its own, ``gloo`` when ranks share a card (NCCL
refuses two ranks of one communicator on one device) or run on the CPU.
Under ``gloo`` a collective over CUDA tensors goes through host buffers
(``communication``). ``backend="nccl"`` with more ranks than cards raises.

At world size 1 no process group is made: every collective is the
identity, as in the JAX package's eager mode.
"""

from __future__ import annotations

import os
from datetime import timedelta

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "parallel_device_count",
           "backend_rule", "current_device"]

#: seconds a rank waits for the others at init (and in a collective)
DEFAULT_TIMEOUT_S = 120.0


class _State:
    initialized = False
    device = None
    backend = None
    local_rank = 0
    local_size = 1


def _env_int(names, default):
    for name in names:
        val = os.environ.get(name)
        if val not in (None, ""):
            return int(val)
    return default


def _env_rank():
    return _env_int(("PADDLE_TRAINER_ID", "PADDLE_RANK", "RANK"), 0)


def _env_world():
    return _env_int(("PADDLE_TRAINERS_NUM", "PADDLE_WORLD_SIZE",
                     "WORLD_SIZE"), 1)


def backend_rule(device, local_size, requested=None) -> str:
    """The collective backend for ranks on ``device``: ``gloo`` on the
    CPU or when the host's ``local_size`` ranks outnumber its cards,
    ``nccl`` when each rank has a card. ``requested`` overrides it, except
    that ``nccl`` on the CPU or over shared cards raises."""
    import torch
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"backend={requested!r} is not 'gloo' or 'nccl'")
    if device.type != "cuda":
        if requested == "nccl":
            raise ValueError("backend='nccl' needs CUDA devices; these "
                             "ranks run on the CPU")
        return "gloo"
    cards = torch.cuda.device_count()
    shared = local_size > cards
    if requested == "nccl" and shared:
        raise ValueError(
            f"backend='nccl' with {local_size} ranks on {cards} card(s): "
            "NCCL refuses two ranks of one communicator on one device; "
            "run one rank per card, or leave the backend to the rule "
            "(gloo through host buffers)")
    if requested is not None:
        return requested
    return "gloo" if shared else "nccl"


def _master():
    addr = os.environ.get("PADDLE_MASTER")
    if addr:
        host, _, port = addr.rpartition(":")
        if host and port:
            return host, port
        return addr, os.environ.get("MASTER_PORT")
    return os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")


def init_parallel_env(backend=None, device=None, timeout=None):
    """Join this rank to the job's process group (once; later calls
    return the same :class:`ParallelEnv`) and pick its device. At world
    size 1 nothing is joined."""
    import torch
    import torch.distributed as dist
    if _State.initialized:
        return ParallelEnv()
    world, rank = _env_world(), _env_rank()
    local_rank = _env_int(("PADDLE_LOCAL_RANK", "LOCAL_RANK"), rank)
    local_size = _env_int(("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE"), world)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to "
                "init_parallel_env to run the ranks on the CPU")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    chosen = backend_rule(device, local_size, backend)
    if world > 1 and not dist.is_initialized():
        host, port = _master()
        if not host or not port:
            raise RuntimeError(
                f"rank {rank} of {world}: no rendezvous address; set "
                "PADDLE_MASTER=host:port (the launcher does) or "
                "MASTER_ADDR and MASTER_PORT")
        kw = {}
        if chosen == "nccl":
            kw["device_id"] = device
        dist.init_process_group(
            chosen, init_method=f"tcp://{host}:{port}", world_size=world,
            rank=rank, timeout=timedelta(seconds=float(
                timeout or DEFAULT_TIMEOUT_S)), **kw)
    _State.initialized = True
    _State.device, _State.backend = device, chosen
    _State.local_rank, _State.local_size = local_rank, local_size
    return ParallelEnv()


def _reset():
    """Forget the environment (``destroy_process_group``)."""
    _State.initialized = False
    _State.device = _State.backend = None
    _State.local_rank, _State.local_size = 0, 1


def is_initialized() -> bool:
    return _State.initialized


def current_device():
    """This rank's device once :func:`init_parallel_env` ran, else None."""
    return _State.device


def _dist_ready():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` (its index there) when given,
    else in the world (the launcher's ``PADDLE_TRAINER_ID`` before
    init)."""
    if group is not None:
        return group.rank
    if _dist_ready():
        import torch.distributed as dist
        return dist.get_rank()
    return _env_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if _dist_ready():
        import torch.distributed as dist
        return dist.get_world_size()
    return _env_world()


def parallel_device_count() -> int:
    """Ranks of the job (the JAX package counts devices of one process)."""
    return get_world_size()


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        return _State.local_rank if _State.initialized else get_rank()

    @property
    def device(self):
        return _State.device

    @property
    def device_id(self):
        dev = _State.device
        return dev.index if dev is not None and dev.index is not None else 0

    @property
    def backend(self):
        return _State.backend

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []
