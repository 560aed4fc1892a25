"""MoELayer: a sparse SwiGLU FFN block with top-k routing over a stacked
expert bank.

Port of ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``:
``MoELayer`` with its single-device branches (dropless over the
grouped-matmul kernels, and the capacity path), its expert-parallel
branch, the gate specs ``GShardGate``/``SwitchGate`` and the dict form,
and the ``aux_loss``/``z_loss`` attributes of the last forward.

The router and the banks are plain parameters with the JAX shapes
(``router_weight`` [d, E], ``w_gate``/``w_up`` [E, d, h], ``w_down``
[E, h, d]), so the weight bridge takes them untransposed.

Expert parallelism (a fleet whose ``expert`` group has ep > 1 ranks, read
when the layer is built, as the JAX layer reads its mesh): rank ``r`` of
the group holds experts ``[r*E/ep, (r+1)*E/ep)`` of each bank (drawn
whole from the generator, then its block kept), marked with
``_ep_shard_dim = 0`` and the checkpoint layout ``Layout(split=(0, r,
ep), axes=("expert",))``. Activations arrive replicated over ``expert``:
each rank takes the contiguous ``T/ep`` tokens at its index (backward: an
all-gather), runs ``ops.moe.moe_forward_ep`` over the group with the
router weight through ``c_identity`` (its gradient, from the rank's own
tokens, summed over the group) and its own bank block, and the full
token set is put back together by an all-gather (backward: the rank's
slice), as the JAX manual path's masked psum does. A ``dropless`` gate
takes the capacity path then, with the JAX package's warning and perf
event. ep with ``sep_degree > 1`` raises, as in the JAX package.
"""

from __future__ import annotations

import math
import warnings

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


def ep_info():
    """``(group, ep, rank)`` of the initialised fleet's ``expert`` group;
    ``(None, 1, 0)`` without one of more than one rank."""
    from .....distributed.fleet.base import current_hcg
    hcg = current_hcg()
    if hcg is None or hcg.get_expert_parallel_world_size() <= 1:
        return None, 1, 0
    group = hcg.get_expert_parallel_group()
    if hcg.get_sep_parallel_world_size() > 1:
        raise ValueError(
            "ep_degree > 1 with sep_degree > 1 is not supported: the JAX "
            "package refuses it outside its pipeline engine and runs it "
            "only as ep x pp x sep, which is not ported (ROADMAP A.7); "
            "drop one axis")
    return group, group.nranks, group.rank


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
    (``cuda`` unless given; raises with no GPU and no device). Under a
    fleet's ``expert`` group the banks hold this rank's ``E/ep`` experts
    (module docstring)."""

    def __init__(self, d_model, d_hidden, num_experts, gate=None,
                 device=None, dtype=None):
        super().__init__()
        self.ep_group, self.ep, self.ep_rank = ep_info()
        if num_experts % self.ep:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"ep degree {self.ep}")
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
        if self.ep > 1 and gate.dropless:
            # every ep > 1 forward takes the capacity all-to-all, which
            # drops tokens past capacity_factor: say so
            warnings.warn(
                f"MoELayer: gate dropless=True requested but expert "
                f"parallelism is active (ep_degree={self.ep}); the EP "
                f"capacity dispatch path is taken instead and tokens "
                f"beyond capacity_factor={gate.capacity_factor} "
                f"are dropped (numerics differ from dropless). Use "
                f"ep_degree=1 for dropless, or raise capacity_factor.",
                UserWarning, stacklevel=2)
            from .....profiler.trace import log_perf_event
            log_perf_event(
                "moe/dropless_downgraded",
                f"dropless=True ignored under ep_degree={self.ep}: capacity "
                f"path (cf={gate.capacity_factor}) dispatches this layer",
                once_key=("moe/dropless_downgraded", self.ep))
        kw = dict(device=resolve_device(device), dtype=dtype)
        E, d, h = num_experts // self.ep, d_model, d_hidden
        self.router_weight = nn.Parameter(torch.empty(d, num_experts, **kw))
        self.w_gate = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_up = nn.Parameter(torch.empty(E, d, h, **kw))
        self.w_down = nn.Parameter(torch.empty(E, h, d, **kw))
        self.aux_loss: torch.Tensor | None = None
        self.z_loss: torch.Tensor | None = None
        self._mark_banks()
        from .....distributed.parallel_layers import _carry_layouts
        self._register_state_dict_hook(_carry_layouts)
        if self.w_gate.device.type != "meta":
            self.reset_parameters()

    def _banks(self):
        return self.w_gate, self.w_up, self.w_down

    def _mark_banks(self):
        """Each bank's expert dim and checkpoint layout under ep > 1."""
        from .....distributed.checkpoint.metadata import Layout
        for p in self._banks():
            p._ep_shard_dim = 0 if self.ep > 1 else None
            p.dist_layout = Layout(split=(0, self.ep_rank, self.ep),
                                   axes=("expert",)) if self.ep > 1 \
                else None

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._mark_banks()      # to_empty makes new parameters
        return out

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal on the router and the banks, as the JAX layer;
        under ep > 1 each bank is drawn whole and this rank keeps its
        block, so the generator advances as for the unsplit layer."""
        r = self.router_weight
        r.normal_(0.0, xavier_normal_std(r.shape), generator=generator)
        for p in self._banks():
            full = p.new_empty((p.shape[0] * self.ep,) + p.shape[1:])
            full.normal_(0.0, xavier_normal_std(full.shape),
                         generator=generator)
            p.copy_(full.chunk(self.ep)[self.ep_rank])

    def forward(self, x):
        d = x.shape[-1]
        flat = x.reshape(-1, d)
        g = self.gate
        if self.ep > 1:
            y, aux, z = self._forward_ep(flat)
        elif g.dropless:
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

    def _forward_ep(self, flat):
        """The rank's ``T/ep`` tokens through ``moe_forward_ep`` over the
        expert group, then every rank's outputs put back together."""
        from .....distributed.parallel_layers import (c_identity, gather_dim,
                                                      split_dim)
        T, group, g = flat.shape[0], self.ep_group, self.gate
        if T % self.ep:
            raise ValueError(f"token count {T} not divisible by ep "
                             f"{self.ep}")
        wg, wu, wd = self._banks()
        y, aux, z = moe_ops.moe_forward_ep(
            split_dim(flat, 0, group), c_identity(self.router_weight, group),
            lambda t: moe_ops.moe_ffn_grouped(t, wg, wu, wd), group,
            k=g.top_k, capacity_factor=g.capacity_factor,
            norm_topk_prob=g.norm_topk_prob)
        return gather_dim(y, 0, group), aux, z

