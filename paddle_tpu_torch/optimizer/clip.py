"""Gradient clipping: a port of ``paddle_tpu/optimizer/clip.py``.

The clip objects take and return ``[(param, grad), ...]`` as the
optimizer's ``step`` hands them over; the grads they return are new
tensors in each grad's own dtype, the parameters' ``.grad`` untouched.
Norms are taken in f32 over the grads, as the JAX package takes them.
``clip_grad_norm_`` and ``clip_grad_value_`` scale ``p.grad`` in place.
No host read is made: the scale stays a device scalar.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_"]


def _sq_sum(g):
    gf = g.float()
    return (gf * gf).sum()


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad times ``clip_norm / max(global_norm, clip_norm)``, the
    global norm over all the grads."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    @torch.no_grad()
    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        sq = _sq_sum(grads[0])
        for g in grads[1:]:
            sq = sq + _sq_sum(g)
        global_norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        return [(p, g if g is None else _scaled(g, scale))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad on its own: times ``clip_norm / max(norm, clip_norm)``."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                norm = torch.sqrt(_sq_sum(g))
                g = _scaled(g, self.clip_norm / torch.clamp(
                    norm, min=self.clip_norm))
            out.append((p, g))
        return out


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max=1.0, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by ``min(max_norm / (total +
    1e-6), 1)``; returns the total norm (a 0-d f32 tensor)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([(g.float().abs() ** norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad.copy_(_scaled(p.grad, coef))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` into ``[-clip_value, clip_value]`` in
    place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
