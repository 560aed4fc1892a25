"""MoELayer: a sparse SwiGLU FFN block with top-k routing over a stacked
expert bank.

Port of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``:
``MoELayer`` with its single-device branches (dropless over the
grouped-matmul kernels, and the capacity path), the gate specs
``GShardGate``/``SwitchGate`` and the dict form, and the ``aux_loss``/
``z_loss`` attributes of the last forward. Expert parallelism is not
ported: ``ep_degree > 1`` raises.

The router and the banks are plain parameters with the JAX shapes
(``router_weight`` [d, E], ``w_gate``/``w_up`` [E, d, h], ``w_down``
[E, h, d]), so the weight bridge takes them untransposed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .....device import resolve_device
from .....ops import moe as moe_ops

__all__ = ["MoELayer", "GShardGate", "SwitchGate"]


class _GateSpec:
    def __init__(self, top_k, capacity_factor, norm_topk_prob,
                 dropless=False):
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.norm_topk_prob = norm_topk_prob
        self.dropless = dropless


def GShardGate(top_k=2, capacity_factor=1.25):
    return _GateSpec(top_k, capacity_factor, True)


def SwitchGate(capacity_factor=1.25):
    return _GateSpec(1, capacity_factor, False)


def xavier_normal_std(shape) -> float:
    """The JAX package's XavierNormal over ``nn/initializer._fans``: a
    2-D [in, out] weight has fans (in, out); a bank [E, a, b] has fans
    (a * b, E * b)."""
    shape = tuple(shape)
    if len(shape) == 2:
        fan_in, fan_out = shape
    else:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(2.0 / (fan_in + fan_out))


class MoELayer(nn.Module):
    """d_model/d_hidden: token and expert widths; num_experts: E. gate: a
    gate spec (``GShardGate()``, ``SwitchGate()``) or a dict with
    ``top_k``, ``capacity_factor``, ``norm_topk_prob`` and ``dropless``.
    Input [B, S, d] or [T, d]; the same shape out. Built on ``device``
    (``cuda`` unless given; raises with no GPU and no device)."""

    def __init__(self, d_model, d_hidden, num_experts, gate=None,
                 ep_degree=1, device=None, dtype=None):
        super().__init__()
        if ep_degree > 1:
            raise NotImplementedError(
                f"MoELayer: expert parallelism (ep_degree={ep_degree}) is "
                "not ported yet; run with ep_degree=1")
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        if gate is None:
            gate = GShardGate()
        if isinstance(gate, dict):
            gate = _GateSpec(gate.get("top_k", 2),
                             gate.get("capacity_factor", 1.25),
                             gate.get("norm_topk_prob", True),
                             gate.get("dropless", False))
        self.gate = gate
        kw = dict(device=resolve_device(device), dtype=dtype)
        E, d, h = num_experts, d_model, d_hidden
        self.router_weight = nn.Parameter(torch.empty(d, E, **kw))
        self.w_gate = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_up = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_down = nn.Parameter(torch.empty(E, h, d, **kw))
        self.aux_loss: torch.Tensor | None = None
        self.z_loss: torch.Tensor | None = None
        if self.w_gate.device.type != "meta":
            self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal on the router and the banks, as the JAX layer."""
        for p in (self.router_weight, self.w_gate, self.w_up, self.w_down):
            p.normal_(0.0, xavier_normal_std(p.shape), generator=generator)

    def forward(self, x):
        d = x.shape[-1]
        flat = x.reshape(-1, d)
        g = self.gate
        if g.dropless:
            y, aux, z = moe_ops.moe_forward_dropless(
                flat, self.router_weight, self.w_gate, self.w_up,
                self.w_down, k=g.top_k, norm_topk_prob=g.norm_topk_prob)
        else:
            wg, wu, wd = self.w_gate, self.w_up, self.w_down
            y, aux, z = moe_ops.moe_forward(
                flat, self.router_weight,
                lambda t: moe_ops.moe_ffn_grouped(t, wg, wu, wd),
                k=g.top_k, capacity_factor=g.capacity_factor,
                norm_topk_prob=g.norm_topk_prob)
        self.aux_loss = aux
        self.z_loss = z
        return y.reshape(x.shape)
