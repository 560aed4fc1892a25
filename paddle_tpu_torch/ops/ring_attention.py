"""Blockwise attention with an online softmax, on one device and over a
sequence split across the ranks of a ``sep`` group.

Port of ``paddle_tpu/ops/ring_attention.py``. The JAX package runs its
collectives over a named mesh axis inside ``shard_map``; here each rank
is one process holding its local chunk [B, S_local, H, D], and the
collectives run over a ``distributed.communication.Group`` (the fleet's
``sep`` group), as ``torch.autograd.Function`` pairs whose backward is
the collective the JAX package's transpose gives:

- :func:`ring_attention`: ``n`` steps over a K/V ring. Rank ``r`` sends
  its current chunk to ``(r + 1) % n`` and receives from ``(r - 1) %
  n`` (``isend``/``irecv``, never a blocking send facing a blocking
  send); the backward shifts the gradient the other way. The ring
  carries the compact kv heads in f32 (the JAX package's f32 copies, so
  the gradient sums in f32 across the ring) and repeats them up to the
  query heads after each shift: the same numbers with 1/rep of the
  traffic. The key positions are not sent: at step ``j`` rank ``r``
  holds rank ``(r - j) % n``'s chunk, whose global positions follow from
  the placement (``contiguous`` or ``zigzag``), so causal masking is by
  global position.
- :func:`allgather_attention`: the compact kv heads all-gathered on the
  sequence (backward: a reduce-scatter), then the same merge over
  chunks of the local length.
- :func:`ulysses_attention`: an all-to-all from sequence shards to head
  shards (backward: the reverse all-to-all), full-sequence attention on
  H/n heads, and the reverse all-to-all. The local attention defaults to
  ``ops.kernels.flash_attention.flash_attention``: the flash kernels
  (forward K7, backward K8/K9) on a CUDA tensor, which raise for a shape
  they do not take, and their plain versions on a CPU tensor.

The ring and the all-gather paths compute in f32 plain PyTorch, as the
JAX package computes them outside any Pallas kernel. Each chunk's (row
max, row sum of exp, accumulator) merge online in :func:`_merge_partials`
for every variant, ``chunked_attention`` (one device, keys in chunks)
included, so no [B, H, S, S_global] tensor exists.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["chunked_attention", "ring_attention", "allgather_attention",
           "ulysses_attention", "zigzag_reorder", "zigzag_restore",
           "zigzag_positions"]

_NEG_INF = -1e30


def _repeat_kv(q, k, v):
    """GQA/MQA: repeat kv heads up to the query head count."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _chunk_partials(qf, k_c, v_c, q_pos, k_pos, scale, causal):
    """Partial attention of the queries against one key chunk: (row max
    [B, H, Sq], row sum of exp [B, H, Sq], unnormalised accumulator [B, H,
    Sq, Dv]), all f32. Masked entries contribute nothing; a row with no
    visible key keeps max -1e30 and sums 0."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float()) * scale
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, _NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return m, p.sum(-1), torch.einsum("bhqk,bkhd->bhqd", p, v_c.float())


def _merge_partials(carry, partials):
    """Online-softmax merge of one chunk's partials into the running
    (acc, m, l): the numerically delicate rescale, in one place for the
    chunked, ring and all-gather variants."""
    acc, m, l = carry
    m_j, l_j, acc_j = partials
    m_new = torch.maximum(m, m_j)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_j - m_new)
    return (acc * alpha[..., None] + acc_j * beta[..., None], m_new,
            l * alpha + l_j * beta)


def _start(q, dv):
    """The empty (acc, m, l) carry of ``q``'s rows."""
    b, sq, h, _ = q.shape
    dev = q.device
    return (torch.zeros(b, h, sq, dv, device=dev),
            torch.full((b, h, sq), _NEG_INF, device=dev),
            torch.zeros(b, h, sq, device=dev))


def _finish(carry, dtype):
    acc, _, l = carry
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def _scale_of(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def chunked_attention(q, k, v, causal=True, scale=None, chunk=256):
    """Exact attention in O(Sq * chunk) score memory: the keys in chunks of
    ``chunk``, each chunk's partials merged online in f32, so no [B, H,
    Sq, Sk] tensor exists. q/k [B, Sq, H, Dqk] / [B, Sk, H, Dqk] and v
    [B, Sk, H, Dv] (Dv may differ from Dqk: MLA's heads); kv heads are
    repeated up to q's. Query i sits at position i (``causal`` masks keys
    past it). Returns [B, Sq, H, Dv] in q's dtype; differentiable through
    torch autograd."""
    sq = q.shape[1]
    k, v = _repeat_kv(q, k, v)
    sk = k.shape[1]
    s = _scale_of(q, scale)
    c = min(int(chunk), sk)
    n = -(-sk // c)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    qf = q.float()
    carry = _start(q, v.shape[-1])
    for j in range(n):
        lo, hi = j * c, min((j + 1) * c, sk)
        carry = _merge_partials(carry, _chunk_partials(
            qf, k[:, lo:hi], v[:, lo:hi], q_pos,
            torch.arange(lo, hi, device=dev), s, causal))
    return _finish(carry, q.dtype)


# ---- the collectives, with their transposes ---------------------------------

def _shift(t, group, step):
    """``t`` sent to the rank ``step`` places on around the ring and the
    tensor received from the rank ``step`` places back."""
    from ..distributed.communication import irecv, isend
    n, r = group.nranks, group.rank
    dst = group.ranks[(r + step) % n]
    src = group.ranks[(r - step) % n]
    t = t.contiguous()
    out = torch.empty_like(t)
    works = [irecv(out, src, group), isend(t, dst, group)]
    for w in works:
        w.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: the K/V chunk (k and v stacked) one step on around the
    ring; backward: its gradient one step back."""

    @staticmethod
    def forward(ctx, kv, group):
        ctx.group = group
        return _shift(kv, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _zigzag_local_positions(idx, seq_local, degree, device):
    """Global positions of rank ``idx``'s tokens under zigzag placement:
    rank r holds chunks r and 2n-1-r of 2n equal chunks."""
    c = seq_local // 2
    ar = torch.arange(c, device=device)
    return torch.cat([idx * c + ar, (2 * degree - 1 - idx) * c + ar])


def _positions(idx, length, degree, placement, device):
    if placement == "zigzag":
        return _zigzag_local_positions(idx, length, degree, device)
    return idx * length + torch.arange(length, device=device)


def ring_attention(q, k, v, group, causal=False, scale=None,
                   placement="contiguous"):
    """Exact attention over a sequence split across ``group``'s ranks.

    q [B, S_local, H, D] and k/v [B, S_local, H_kv, D] are this rank's
    chunks (GQA kv heads are repeated after each shift). ``placement``:
    ``contiguous``, rank r holds tokens [r*S, (r+1)*S); ``zigzag``, rank
    r holds chunks (r, 2n-1-r) of 2n chunks, the causal load-balanced
    layout (:func:`zigzag_reorder` makes it from the whole sequence).
    Returns [B, S_local, H, D] in q's dtype; the backward is the reverse
    ring through autograd."""
    if placement not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown placement {placement!r}")
    n = group.nranks if group is not None else 1
    idx = max(group.rank, 0) if group is not None else 0
    sq, sk = q.shape[1], k.shape[1]
    if placement == "zigzag" and (sq % 2 or sk % 2):
        raise ValueError("zigzag placement needs an even local length")
    dev = q.device
    s = _scale_of(q, scale)
    q_pos = _positions(idx, sq, n, placement, dev)
    qf = q.float()
    kv = torch.stack([k.float(), v.float()])
    carry = _start(q, v.shape[-1])
    for j in range(n):
        k_c, v_c = _repeat_kv(q, kv[0], kv[1])
        k_pos = _positions((idx - j) % n, sk, n, placement, dev)
        carry = _merge_partials(carry, _chunk_partials(
            qf, k_c, v_c, q_pos, k_pos, s, causal))
        if j < n - 1:
            kv = _RingShift.apply(kv, group)
    return _finish(carry, q.dtype)


def allgather_attention(q, k, v, group, causal=False, scale=None):
    """Context parallelism by a K/V all-gather (the Llama-3 style): this
    rank's queries (contiguous placement) against the whole gathered
    sequence of compact kv heads, merged over chunks of the local length
    (kv heads repeated a chunk at a time, never on the gathered arrays).
    The gather's backward is a reduce-scatter of the gradient. K/V memory
    is the global sequence's (the ring keeps S_local)."""
    from ..distributed.parallel_layers import all_gather_dim
    n = group.nranks if group is not None else 1
    idx = max(group.rank, 0) if group is not None else 0
    sq, sk = q.shape[1], k.shape[1]
    dev = q.device
    s = _scale_of(q, scale)
    if n > 1:
        k = all_gather_dim(k, 1, group)
        v = all_gather_dim(v, 1, group)
    q_pos = idx * sq + torch.arange(sq, device=dev)
    qf = q.float()
    carry = _start(q, v.shape[-1])
    for j in range(n):
        lo, hi = j * sk, (j + 1) * sk
        k_c, v_c = _repeat_kv(q, k[:, lo:hi], v[:, lo:hi])
        carry = _merge_partials(carry, _chunk_partials(
            qf, k_c.float(), v_c.float(), q_pos,
            torch.arange(lo, hi, device=dev), s, causal))
    return _finish(carry, q.dtype)


def _flash(qs, ks, vs, causal, scale):
    from .kernels.flash_attention import flash_attention
    return flash_attention(qs.contiguous(), ks.contiguous(), vs.contiguous(),
                           causal=causal, scale=scale)


def ulysses_attention(q, k, v, group, causal=False, scale=None,
                      attn_fn=None):
    """Ulysses (DeepSpeed-style) context parallelism: an all-to-all swaps
    the sequence shard for a head shard ([B, S/n, H, D] -> [B, S, H/n,
    D], kv heads repeated first), ``attn_fn(q, k, v, causal, scale)``
    attends over the whole sequence on the local heads, and a second
    all-to-all swaps back. Raises unless the degree divides the heads.
    ``attn_fn`` defaults to the flash kernels (K7, K8/K9) on a CUDA
    tensor, their plain versions on a CPU one."""
    n = group.nranks if group is not None else 1
    k, v = _repeat_kv(q, k, v)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[2]}) divisible by the sep "
            f"degree ({n})")
    attn_fn = attn_fn or _flash
    if n == 1:
        return attn_fn(q, k, v, causal, scale)
    from ..distributed.parallel_layers import all_to_all_dim
    qs, ks, vs = (all_to_all_dim(t, 2, 1, group) for t in (q, k, v))
    out = attn_fn(qs, ks, vs, causal, scale)
    return all_to_all_dim(out, 1, 2, group)


# ---- the zigzag layout (host side) --------------------------------------------

def _reorder(x, parts, order, axis):
    if isinstance(x, torch.Tensor):
        chunks = torch.tensor_split(x, parts, dim=axis)
        return torch.cat([chunks[i] for i in order], dim=axis)
    chunks = np.split(np.asarray(x), parts, axis=axis)
    return np.concatenate([chunks[i] for i in order], axis=axis)


def _zigzag_order(degree):
    order = []
    for r in range(degree):
        order += [r, 2 * degree - 1 - r]
    return order


def zigzag_reorder(x, degree, axis=1):
    """Reorder a whole sequence (a tensor or an array) so that contiguous
    equal shards over ``degree`` ranks are the load-balanced causal
    placement: the sequence cut into 2n chunks, rank r's shard chunks (r,
    2n-1-r)."""
    seq = x.shape[axis]
    if seq % (2 * degree):
        raise ValueError(f"seq {seq} not divisible by 2*degree {2 * degree}")
    return _reorder(x, 2 * degree, _zigzag_order(degree), axis)


def zigzag_restore(x, degree, axis=1):
    """Inverse of :func:`zigzag_reorder`."""
    order = _zigzag_order(degree)
    inverse = [order.index(c) for c in range(2 * degree)]
    return _reorder(x, 2 * degree, inverse, axis)


def zigzag_positions(seq_len, degree):
    """Global position of each token of the zigzag-reordered sequence
    (int32 numpy)."""
    return zigzag_reorder(np.arange(seq_len, dtype=np.int32)[None], degree,
                          axis=1)[0]
