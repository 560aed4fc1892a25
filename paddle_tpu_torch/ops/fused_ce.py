"""Fused linear + cross entropy: the mean CE of ``h @ w`` without the
[N, V] logits.

Port of ``paddle_tpu/ops/fused_ce.py``. The vocab is walked in chunks of
``cv`` columns (``_chunk_grid``). The forward keeps an online log-sum-exp
and the target logit over the chunks, as [N] vectors; the backward
recomputes each chunk's logits and accumulates ``dh`` in f32 while each
chunk writes its own columns of ``dw``. Per chunk, the elementwise work
is the kernels of :mod:`ops.kernels.ce_chunk` (K10 in the forward, K11 in
the backward; their plain versions with ``FLAGS_fused_ce_pallas_inner``
off); the matmuls are ``torch.matmul``, as the JAX package
leaves them to XLA, and keep its rounding: ``h @ wc`` comes out in h's
dtype and is widened inside K10/K11 (exactly, as the JAX op's f32 copy
is), ``dlogits @ wc.T`` is rounded to h's dtype before it joins the f32
``dh``.

``dw`` of a chunk is ``(h_f32.T @ dlogits_f32).to(w.dtype)`` in the JAX
op. h, dlogits and w share their dtype here (``torch.matmul`` takes no
mixed dtypes), and a matmul in that dtype computes the same function:
bf16 products are exact in f32, the sum is taken in f32 (with
``allow_bf16_reduced_precision_reduction`` off) and the result is
rounded once; f32 is f32.

The weight is ``[D, V]``, the JAX package's layout; the model passes the
transpose of its ``[V, D]`` ``lm_head.weight``, a view, and ``dw`` is
built ``[V, D]`` and handed back transposed, so no [D, V] copy is made.

**Vocab-parallel** (``group`` of more than one rank): the weight is this
rank's columns ``[vocab_start, vocab_start + V_local)`` of the full
vocab, as a tensor-parallel ``lm_head`` holds them (the JAX package runs
the op on the full logical weight and lets GSPMD split it). K10 walks the
rank's chunks; the per-row max is all-reduced (MAX), the exp-sums
rescaled to it and all-reduced, and the target logit, which one rank
owns, all-reduced (SUM), so every rank has the global log-sum-exp. The
backward's K11 builds each chunk's dlogits from it, ``dw`` is the rank's
columns, and ``dh`` (f32) is all-reduced over the group before it is
rounded: the loss and the gradients are the unsplit op's.
"""

from __future__ import annotations

import threading

import torch

from ..framework import flags
from .kernels import ce_chunk

__all__ = ["fused_linear_cross_entropy", "force_chunk_v"]

#: vocab columns per chunk, the JAX package's default
_CHUNK_V = 1024

_forced_tls = threading.local()


class force_chunk_v:
    """Context manager pinning the vocab-chunk width (this thread only);
    it wins over ``FLAGS_fused_ce_chunk_v``."""

    def __init__(self, chunk_v):
        self._val = int(chunk_v)

    def __enter__(self):
        self._prev = getattr(_forced_tls, "chunk_v", None)
        _forced_tls.chunk_v = self._val
        return self

    def __exit__(self, *exc):
        _forced_tls.chunk_v = self._prev
        return False


def _resolve_chunk_v() -> int:
    """Forced > an explicit ``FLAGS_fused_ce_chunk_v`` (env or
    ``set_flags``) > the module default. The port has no tuner cache."""
    forced = getattr(_forced_tls, "chunk_v", None)
    if forced is not None:
        return int(forced)
    if flags.flag_source("FLAGS_fused_ce_chunk_v") != "default":
        val = int(flags.flag("FLAGS_fused_ce_chunk_v"))
        if val > 0:
            return val
    return _CHUNK_V


def _stats():
    """K10, or its plain version with ``FLAGS_fused_ce_pallas_inner`` off
    (the JAX package's jnp scan body)."""
    return ce_chunk.chunk_stats if flags.flag("FLAGS_fused_ce_pallas_inner") \
        else ce_chunk.chunk_stats_reference


def _dlogits():
    """K11, or its plain version with ``FLAGS_fused_ce_pallas_inner``
    off."""
    return ce_chunk.chunk_dlogits \
        if flags.flag("FLAGS_fused_ce_pallas_inner") \
        else ce_chunk.chunk_dlogits_reference


def _chunk_grid(v, chunk_v):
    """``(cv, c)``: the chunk width (at most the vocab) and the chunk
    count. Chunk ``ci`` covers columns ``[start, start + cv)`` with
    ``start = min(ci * cv, v - cv)``: the last chunk's start is clamped
    back so every slice stays inside the weight, which is never padded,
    and its first ``lo = ci * cv - start`` columns overlap the previous
    chunk and are masked."""
    cv = min(int(chunk_v), int(v))
    return cv, -(-int(v) // cv)


def _chunks(v, cv, c):
    for ci in range(c):
        start = min(ci * cv, v - cv)
        yield start, ci * cv - start


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, group, vocab_start):
        n, v = h.shape[0], w.shape[1]
        cv, c = _chunk_grid(v, _resolve_chunk_v())
        valid = labels != ignore_index
        safe = (torch.where(valid, labels, 0) - vocab_start).to(torch.int32)
        f32 = dict(dtype=torch.float32, device=h.device)
        m = torch.full((n,), float("-inf"), **f32)
        s = torch.zeros(n, **f32)
        tgt = torch.zeros(n, **f32)
        for start, lo in _chunks(v, cv, c):
            logits = h @ w[:, start:start + cv]
            m_c, s_c, t_c = _stats()(logits, safe - start, lo)
            m_new = torch.maximum(m, m_c)
            s = s * torch.exp(m - m_new) + s_c * torch.exp(m_c - m_new)
            tgt = tgt + t_c
            m = m_new
        if group is not None:
            m, s, tgt = _combine(m, s, tgt, group)
        lse = m + torch.log(s)
        count = valid.sum().float()
        loss = torch.where(valid, lse - tgt, 0.0).sum() / count.clamp(min=1.0)
        ctx.save_for_backward(h, w, safe, valid, lse, count)
        ctx.grid = (cv, c)
        ctx.group = group
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, safe, valid, lse, count = ctx.saved_tensors
        v = w.shape[1]
        cv, c = ctx.grid
        vmask = valid.float() * (g / count.clamp(min=1.0)).float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        need_w = ctx.needs_input_grad[1]
        # [V, D], the transpose of dw: each chunk writes rows, contiguous
        dw_t = torch.empty(v, w.shape[0], dtype=w.dtype, device=w.device) \
            if need_w else None
        for start, lo in _chunks(v, cv, c):
            wc = w[:, start:start + cv]
            logits = h @ wc
            dlogits = _dlogits()(logits, lse, safe - start,
                                             vmask, lo)
            dh += dlogits @ wc.t()
            if need_w:
                # the overlap prefix (columns < lo) belongs to the chunk
                # before; K11 zeroed it here, and it is not written
                torch.matmul(dlogits[:, lo:].t(), h,
                             out=dw_t[start + lo:start + cv])
        dw = dw_t.t() if need_w else None
        if ctx.group is not None:
            _all_reduce(dh, ctx.group)
        return dh.to(h.dtype), dw, None, None, None, None


def _all_reduce(t, group, op="sum"):
    from ..distributed.communication import all_reduce
    all_reduce(t, op, group)
    return t


def _combine(m, s, tgt, group):
    """The global (max, exp-sum, target) of per-rank ones over ``group``:
    the exp-sums rescaled to the global max before they are summed."""
    m_g = _all_reduce(m.clone(), group, "max")
    s = _all_reduce(s * torch.exp(m - m_g), group)
    return m_g, s, _all_reduce(tgt, group)


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               ignore_index: int = -100, group=None,
                               vocab_start: int = 0) -> torch.Tensor:
    """Mean cross entropy of ``h @ w`` against ``labels`` without the
    logits. ``h [N, D]`` (any float dtype), ``w [D, V]``, ``labels [N]``
    int; rows labelled ``ignore_index`` contribute nothing (an all-ignored
    batch gives a loss of 0 and zero gradients, not NaN). The loss is
    f32. With a ``group`` of more than one rank, ``w`` is this rank's
    vocab columns from ``vocab_start`` (module docstring)."""
    if group is not None and group.nranks <= 1:
        group = None
    return _FusedLinearCE.apply(h, w, labels, ignore_index, group,
                                int(vocab_start))
