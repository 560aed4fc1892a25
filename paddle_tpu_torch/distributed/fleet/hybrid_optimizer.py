"""``HybridParallelOptimizer`` and the global-norm clip across groups:
the port of ``paddle_tpu/distributed/fleet/hybrid_optimizer.py``.

In the JAX package GSPMD makes the norms of sharded gradients global.
Here each rank holds parts, so :class:`HybridParallelClipGrad` sums the
squares itself: those of parameters split over the ``model`` group
(``is_distributed``) are summed over that group, those of replicated
parameters count once, and where the optimizer steps only this rank's
partition (ZeRO, ``sharding_group``) the total is summed over the
sharding group. Under the pipeline each stage holds other parameters,
so the total is summed over the ``pipe`` group too (``pp_group``); a
shared weight's later holder (``pipe_duplicate``) leaves its copy out.
Context parallelism splits the sequence, not the weights: every
parameter is replicated over the ``sep`` group and holds the same
gradient there once ``distributed_model`` (or the pipeline) has averaged
it over the data x sep ranks, so nothing is summed over ``sep`` and a
parameter counts once, not once a sep rank; the ``pipe`` and ``model``
groups hold ranks of one sep index. Expert parallelism splits the MoE
banks over the ``expert`` group (``_ep_shard_dim``): their squares are
summed over that group; every other parameter is replicated over it with
the same gradient on each rank, and counts once.
The global norm, and so the scale, equals ``ClipGradByGlobalNorm``'s on
the unsplit model (up to the order of the f32 sums).
"""

from __future__ import annotations

import torch

from ...optimizer.clip import ClipGradByGlobalNorm, _scaled, _sq_sum

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "base_optimizer"]


def base_optimizer(opt):
    """The port optimizer under any number of wrappers."""
    while hasattr(opt, "_inner"):
        opt = opt._inner
    return opt


class HybridParallelClipGrad:
    """``clip`` (a ``ClipGradByGlobalNorm``) with its norm summed over
    ``mp_group`` for split parameters, over ``ep_group`` for expert banks,
    over ``sharding_group`` for a partition and over ``pp_group`` for a
    pipeline stage."""

    def __init__(self, clip, mp_group=None, sharding_group=None,
                 pp_group=None, ep_group=None):
        self._clip = clip
        self.clip_norm = clip.clip_norm
        self.mp_group = mp_group
        self.sharding_group = sharding_group
        self.pp_group = pp_group
        self.ep_group = ep_group

    @torch.no_grad()
    def global_norm(self, params_grads, device=None):
        from ..communication import all_reduce
        grads = [(p, g) for p, g in params_grads if g is not None]
        if device is None:
            from ..env import current_device
            device = grads[0][1].device if grads else \
                (current_device() or torch.device("cpu"))
        split = torch.zeros((), dtype=torch.float32, device=device)
        expert = torch.zeros((), dtype=torch.float32, device=device)
        whole = torch.zeros((), dtype=torch.float32, device=device)
        for p, g in grads:
            if getattr(p, "pipe_duplicate", False):
                continue        # its first holder counts it
            # a flag the parallel layers set: torch's own
            # ``Tensor.is_distributed`` is a method, truthy on every
            # parameter they did not mark
            if getattr(p, "is_distributed", False) is True:
                split = split + _sq_sum(g)
            elif getattr(p, "_ep_shard_dim", None) is not None:
                expert = expert + _sq_sum(g)
            else:
                whole = whole + _sq_sum(g)
        if self.mp_group is not None and self.mp_group.nranks > 1:
            all_reduce(split, group=self.mp_group)
        if self.ep_group is not None and self.ep_group.nranks > 1:
            all_reduce(expert, group=self.ep_group)
        total = split + expert + whole
        if self.sharding_group is not None and \
                self.sharding_group.nranks > 1:
            all_reduce(total, group=self.sharding_group)
        if self.pp_group is not None and self.pp_group.nranks > 1:
            all_reduce(total, group=self.pp_group)
        return torch.sqrt(total)

    @torch.no_grad()
    def __call__(self, params_grads):
        norm = self.global_norm(params_grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return [(p, g if g is None else _scaled(g, scale.to(g.device)))
                for p, g in params_grads]


def hybrid_clip(opt, mp_group=None, sharding_group=None, pp_group=None,
                ep_group=None):
    """Make ``opt``'s global-norm clip (if any) span the groups given;
    a clip already made hybrid gains the groups it lacked."""
    base = base_optimizer(opt)
    clip = base._grad_clip
    if isinstance(clip, HybridParallelClipGrad):
        clip.mp_group = clip.mp_group or mp_group
        clip.sharding_group = clip.sharding_group or sharding_group
        clip.pp_group = clip.pp_group or pp_group
        clip.ep_group = clip.ep_group or ep_group
    elif isinstance(clip, ClipGradByGlobalNorm):
        base._grad_clip = HybridParallelClipGrad(clip, mp_group,
                                                 sharding_group, pp_group,
                                                 ep_group)


def pipe_group(hcg):
    """The ``pipe`` group of ``hcg`` when it has more than one stage."""
    if hcg is not None and hcg.get_pipe_parallel_world_size() > 1:
        return hcg.get_pipe_parallel_group()
    return None


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if hcg is not None and (hcg.get_model_parallel_world_size() > 1
                                or pipe_group(hcg) is not None
                                or hcg.get_expert_parallel_world_size() > 1):
            hybrid_clip(optimizer, mp_group=hcg.get_model_parallel_group(),
                        pp_group=pipe_group(hcg),
                        ep_group=hcg.get_expert_parallel_group())

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def _parameter_list(self):
        return self._inner._parameter_list

    def step(self):
        self._inner.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner.minimize(loss, startup_program, parameters,
                                    no_grad_set)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, state):
        self._inner.set_state_dict(state)
