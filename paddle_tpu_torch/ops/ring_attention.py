"""Blockwise attention with an online softmax on one device.

Port of the single-device half of ``paddle_tpu/ops/ring_attention.py``:
``chunked_attention`` with its ``_chunk_partials``/``_merge_partials``
rule, in plain PyTorch (the JAX package computes it outside any Pallas
kernel too). The ring and Ulysses collectives of that file are not
ported.
"""

from __future__ import annotations

import math

import torch

__all__ = ["chunked_attention"]

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
    (acc, m, l)."""
    acc, m, l = carry
    m_j, l_j, acc_j = partials
    m_new = torch.maximum(m, m_j)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_j - m_new)
    return (acc * alpha[..., None] + acc_j * beta[..., None], m_new,
            l * alpha + l_j * beta)


def chunked_attention(q, k, v, causal=True, scale=None, chunk=256):
    """Exact attention in O(Sq * chunk) score memory: the keys in chunks of
    ``chunk``, each chunk's partials merged online in f32, so no [B, H,
    Sq, Sk] tensor exists. q/k [B, Sq, H, Dqk] / [B, Sk, H, Dqk] and v
    [B, Sk, H, Dv] (Dv may differ from Dqk: MLA's heads); kv heads are
    repeated up to q's. Query i sits at position i (``causal`` masks keys
    past it). Returns [B, Sq, H, Dv] in q's dtype; differentiable through
    torch autograd."""
    orig = q.dtype
    b, sq, h, dqk = q.shape
    k, v = _repeat_kv(q, k, v)
    sk = k.shape[1]
    s = scale if scale is not None else 1.0 / math.sqrt(dqk)
    c = min(int(chunk), sk)
    n = -(-sk // c)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    qf = q.float()
    carry = (torch.zeros(b, h, sq, v.shape[-1], device=dev),
             torch.full((b, h, sq), _NEG_INF, device=dev),
             torch.zeros(b, h, sq, device=dev))
    for j in range(n):
        lo, hi = j * c, min((j + 1) * c, sk)
        carry = _merge_partials(carry, _chunk_partials(
            qf, k[:, lo:hi], v[:, lo:hi], q_pos,
            torch.arange(lo, hi, device=dev), s, causal))
    acc, _, l = carry
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(orig)
