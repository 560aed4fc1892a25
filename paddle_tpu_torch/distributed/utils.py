"""``paddle.distributed.utils``: the port of
``paddle_tpu/distributed/utils.py``."""

from __future__ import annotations

__all__ = ["get_available_device", "global_scatter", "global_gather"]


def get_available_device():
    """Ids of the CUDA devices this process sees (none without CUDA)."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [str(i) for i in range(n)]


def global_scatter(x, local_count, global_count, group=None):
    raise NotImplementedError(
        "utils.global_scatter is the GPU MoE dispatch primitive of "
        "Paddle's count-based expert parallelism, which neither this "
        "package nor the JAX one has; use MoELayer under fleet "
        "ep_degree > 1 (or ops.moe.moe_forward_ep over an expert group): "
        "its capacity all-to-all dispatches the tokens")


def global_gather(x, local_count, global_count, group=None):
    raise NotImplementedError(
        "utils.global_gather is the GPU MoE combine primitive of Paddle's "
        "count-based expert parallelism, which neither this package nor "
        "the JAX one has; use MoELayer under fleet ep_degree > 1 (or "
        "ops.moe.moe_forward_ep over an expert group)")
