"""Mixture-of-Experts core: top-k routing, the capacity path and the
dropless path over the grouped-matmul kernels.

Port of ``paddle_tpu/ops/moe.py``: ``top_k_gating``, ``top_k_gating_idx``,
``_dispatch_gather``, ``_combine_gather``, ``moe_dispatch_combine``,
``moe_ffn_grouped``, ``moe_forward`` (the capacity path),
``sort_rows_by_expert`` and ``moe_forward_dropless``. The expert-parallel
``moe_forward_ep`` and the ablation harness (``moe_ablation``) are not
ported.

The semantics are the JAX package's: the router runs in f32; the queue
priority of an expert is row-major over (token, rank); capacity is
``max(int(cf * k * T / E), 1)`` in Python floats; the sort is stable;
``P = (ceil(R / bm) + E) * bm`` is static. Every shape is static and the
routing is tensor work on the device: nothing here copies to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.grouped_matmul import GroupedMatmulFunction

__all__ = ["top_k_gating", "top_k_gating_idx", "moe_dispatch_combine",
           "moe_ffn_grouped", "moe_forward", "sort_rows_by_expert",
           "moe_forward_dropless"]


def _router_stats(logits, probs, gate_idx, k):
    """(top-k gate values before any normalisation, one-hot assignments
    [T, k, E], aux, z): the Switch load-balance loss
    ``E * sum_e(mean prob_e * assigned fraction_e)`` and the router z-loss
    ``mean(logsumexp(logits)^2)``."""
    T, E = logits.shape
    assign = F.one_hot(gate_idx, E).to(torch.float32)      # [T, k, E]
    me = probs.mean(0)
    ce = assign.sum((0, 1)) / (T * k)
    aux = E * (me * ce).sum()
    z = torch.logsumexp(logits, -1).square().mean()
    return assign, aux, z


def _top_k(logits, k, norm_topk_prob):
    logits = logits.float()
    probs = torch.softmax(logits, -1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)    # [T, k]
    if norm_topk_prob:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
    return logits, probs, gate_vals, gate_idx


def top_k_gating(logits, k, capacity, norm_topk_prob=True):
    """Top-k softmax gating with capacity-bounded one-hot tensors.

    logits [T, E]. Returns (dispatch [T, E, C] f32 0/1, combine [T, E, C]
    f32, aux, z)."""
    logits, probs, gate_vals, gate_idx = _top_k(logits, k, norm_topk_prob)
    T, E = logits.shape
    assign, aux, z = _router_stats(logits, probs, gate_idx, k)
    flat = assign.reshape(T * k, E)                        # row-major (t, k)
    pos = (torch.cumsum(flat, 0) - flat).reshape(T, k, E)
    keep = assign * (pos < capacity)
    C = capacity
    pos_cap = pos.clamp(0, C - 1).long()
    disp_k = keep[..., None] * F.one_hot(pos_cap, C).to(torch.float32)
    dispatch = disp_k.sum(1)                               # [T, E, C]
    combine = (disp_k * gate_vals[:, :, None, None]).sum(1)
    return dispatch, combine, aux, z


def top_k_gating_idx(logits, k, capacity, norm_topk_prob=True):
    """Index form of :func:`top_k_gating`, the same routing and drops.

    Returns (gate_idx [T, k] int32, gate_vals [T, k] f32, pos [T, k] int32
    queue position, keep [T, k] bool, aux, z)."""
    logits, probs, gate_vals, gate_idx = _top_k(logits, k, norm_topk_prob)
    T, E = logits.shape
    _, aux, z = _router_stats(logits, probs, gate_idx, k)
    # queue position: the running count of each expert down the row-major
    # (t, k) assignments, scanned along contiguous memory as [E, T * k]
    # (int64, exact; a scan down the outer dim is slow on the GPU)
    e_flat = gate_idx.reshape(1, T * k)
    counts = F.one_hot(e_flat[0], E).t().contiguous().cumsum(1)
    pos = (counts.gather(0, e_flat) - 1).reshape(T, k).to(torch.int32)
    return gate_idx.to(torch.int32), gate_vals, pos, pos < capacity, aux, z


def _dispatch_gather(x, gate_idx, pos, keep, E, C):
    """The [E, C, d] expert input bank by a scatter of token indices and a
    gather of x: each kept assignment owns slot ``e * C + pos``; dropped
    ones point at the trash slot E * C (a zero row). Returns (xd, slot)."""
    T, k = gate_idx.shape
    d = x.shape[-1]
    slot = gate_idx.long() * C + pos.long().clamp(max=C - 1)
    slot = torch.where(keep, slot, E * C)
    token_of = torch.arange(T, device=x.device)[:, None].expand(T, k)
    token_idx = torch.full((E * C + 1,), T, dtype=torch.long,
                           device=x.device)
    token_idx.scatter_(0, slot.reshape(-1), token_of.reshape(-1))
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    return x_pad[token_idx[:E * C]].reshape(E, C, d), slot


def _combine_gather(out, slot, gate_vals, keep, x_dtype):
    """Inverse of :func:`_dispatch_gather`: each assignment's expert output
    by slot, weighted by its gate value (0 when dropped), summed over k."""
    d = out.shape[-1]
    out_pad = torch.cat([out.reshape(-1, d), out.new_zeros(1, d)])
    y_k = out_pad[slot]                                    # [T, k, d]
    w = (gate_vals * keep).to(y_k.dtype)[..., None]
    return (y_k * w).sum(1).to(x_dtype)


def moe_dispatch_combine(x, dispatch, combine, expert_fn):
    """Dense capacity dispatch over the one-hot tensors: x [T, d] ->
    [T, d]."""
    xd = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    out = expert_fn(xd)                                    # [E, C, d]
    return torch.einsum("tec,ecd->td", combine.to(out.dtype), out)


def moe_ffn_grouped(xd, w_gate, w_up, w_down, act=F.silu):
    """SwiGLU FFN over the expert dim: xd [E, C, d], w_gate/w_up [E, d,
    h], w_down [E, h, d] (batched matmuls, as the JAX einsums)."""
    g = torch.bmm(xd, w_gate)
    u = torch.bmm(xd, w_up)
    return torch.bmm(act(g) * u, w_down)


def moe_forward(x, router_w, expert_fn, k=2, capacity_factor=1.25,
                norm_topk_prob=True):
    """Single-device capacity MoE block: x [T, d], router_w [d, E].
    Returns (out [T, d], aux, z)."""
    T = x.shape[0]
    E = router_w.shape[1]
    capacity = max(int(capacity_factor * k * T / E), 1)
    logits = x.float() @ router_w.float()
    gate_idx, gate_vals, pos, keep, aux, z = top_k_gating_idx(
        logits, k, capacity, norm_topk_prob)
    xd, slot = _dispatch_gather(x, gate_idx, pos, keep, E, capacity)
    y = _combine_gather(expert_fn(xd), slot, gate_vals, keep, x.dtype)
    return y, aux, z


def sort_rows_by_expert(gate_idx, n_experts, bm=128):
    """The expert-sorted, group-padded row layout of the grouped matmul.

    gate_idx [T, k]. Returns (perm [R] int32, tile_gid [P // bm] int32, P)
    with R = T * k and P = (ceil(R / bm) + E) * bm (static): ``perm[r]``
    is the padded position of assignment row r; the rows of expert e
    occupy a contiguous, bm-aligned span; every expert owns at least one
    tile; the tail tiles belong to expert E - 1."""
    T, k = gate_idx.shape
    R, E = T * k, n_experts
    dev = gate_idx.device
    e_flat = gate_idx.reshape(-1).long()
    order = torch.argsort(e_flat, stable=True)             # sorted -> row
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, e_flat, torch.ones_like(e_flat))
    padded = torch.clamp((counts + bm - 1) // bm * bm, min=bm)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    offs = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    offs_p = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    pos_p = offs_p[e_sorted] + (torch.arange(R, device=dev)
                                - offs[e_sorted])
    perm = torch.zeros(R, dtype=torch.long, device=dev).scatter_(0, order,
                                                                 pos_p)
    P = (-(-R // bm) + E) * bm
    nr = P // bm
    ends = torch.cumsum(padded, 0)
    tile_gid = torch.searchsorted(ends, torch.arange(nr, device=dev) * bm,
                                  right=True)
    tile_gid = tile_gid.clamp(max=E - 1).to(torch.int32)
    return perm.to(torch.int32), tile_gid, P


class _Dispatch(torch.autograd.Function):
    """x [T, d] -> x_p [P, d] whose row ``perm[r]`` is ``x[r // k]`` and
    whose padding rows are zero (the JAX gather from a zero-padded x).
    The backward sums each token's k rows in f32 and rounds once: a
    gather, where the gather's own backward would scatter-add every
    padding row's gradient into one sentinel row."""

    @staticmethod
    def forward(ctx, x, perm, k, P):
        ctx.save_for_backward(perm)
        ctx.k = k
        T, d = x.shape
        rows = x[:, None].expand(T, k, d).reshape(T * k, d)
        return x.new_zeros(P, d).index_copy_(0, perm, rows)

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        gx = g.index_select(0, perm).view(-1, ctx.k, g.shape[1])
        return gx.float().sum(1).to(g.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """``y_p[perm]``: the rows of each assignment back from the padded
    layout. ``perm`` maps onto distinct rows, so the backward is a plain
    scatter into zeros."""

    @staticmethod
    def forward(ctx, y_p, perm):
        ctx.save_for_backward(perm)
        ctx.rows = y_p.shape[0]
        return y_p.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        out = g.new_zeros(ctx.rows, g.shape[1])
        return out.index_copy_(0, perm, g), None


def moe_forward_dropless(x, router_w, w_gate, w_up, w_down, k=2,
                         norm_topk_prob=True, bm=128, act=F.silu):
    """Dropless MoE block over the grouped-matmul kernels (K14 forward,
    K14 transposed and K15 in the backward): x [T, d]. No capacity and no
    drops; the routed rows are sorted into the group-padded layout.
    Returns (out [T, d], aux, z) like :func:`moe_forward`."""
    T, d = x.shape
    E = router_w.shape[1]
    logits = x.float() @ router_w.float()
    # capacity T * k keeps every assignment: the capacity path's router
    gate_idx, gate_vals, _, _, aux, z = top_k_gating_idx(
        logits, k, capacity=T * k, norm_topk_prob=norm_topk_prob)
    perm, tile_gid, P = sort_rows_by_expert(gate_idx, E, bm=bm)
    perm = perm.long()
    x_p = _Dispatch.apply(x, perm, k, P)                   # [P, d]
    g = GroupedMatmulFunction.apply(x_p, w_gate, tile_gid)
    u = GroupedMatmulFunction.apply(x_p, w_up, tile_gid)
    y_p = GroupedMatmulFunction.apply((act(g) * u).to(x.dtype), w_down,
                                      tile_gid)
    y_k = _Combine.apply(y_p, perm).reshape(T, k, d)
    w = gate_vals.to(y_k.dtype)[..., None]
    return (y_k * w).sum(1).to(x.dtype), aux, z
