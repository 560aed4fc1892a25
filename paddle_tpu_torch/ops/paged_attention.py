"""Paged KV pools for the serving engine: the pool write with trash-page
routing, and the ragged attention entry point.

Port of ``paddle_tpu/ops/paged_attention.py`` (``paged_prefill_write``,
``paged_prefill_attention_reference``, ``ragged_paged_attention_reference``
and the dispatch ``ragged_paged_attention``).

Pools are ``[KVH, num_pages, page_size, D]``; page 0 is the reserved trash
page that padding and idle slots write to, so a real page is never
clobbered. Unlike the JAX package, whose arrays are immutable and whose
writes return new pools, :func:`paged_prefill_write` writes into the pools
IN PLACE (``index_put_``): that saves a copy of both pools per layer per
step.
"""

from __future__ import annotations

import torch

from .kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference)

__all__ = ["paged_prefill_write", "paged_prefill_attention_reference",
           "ragged_paged_attention", "ragged_paged_attention_reference"]


def paged_prefill_write(kp: torch.Tensor, vp: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, block_tables: torch.Tensor,
                        ctx: torch.Tensor, valid: torch.Tensor) -> None:
    """Write one chunk's k/v [B, C, KVH, D] into the pools, in place.

    Token j of slot b lands at position ``ctx[b] + j`` of its block-table
    row; tokens with ``j >= valid[b]`` (chunk padding, idle slots) go to
    trash page 0. Positions past the row are clamped onto its last page
    before the lookup (their write is trash-routed anyway)."""
    c = k.shape[1]
    page = kp.shape[2]
    j = torch.arange(c, device=k.device, dtype=torch.int64)
    pos = ctx.long()[:, None] + j[None, :]                         # [B, C]
    pidx = torch.clamp(pos // page, max=block_tables.shape[1] - 1)
    pid = torch.gather(block_tables.long(), 1, pidx)
    pid = torch.where(j[None, :] < valid.long()[:, None], pid, 0)
    off = pos % page
    kp[:, pid, off] = k.permute(2, 0, 1, 3)      # index_put_ under the hood
    vp[:, pid, off] = v.permute(2, 0, 1, 3)


def paged_prefill_attention_reference(q, key_pages, value_pages,
                                      block_tables, context_lens,
                                      scale=None):
    """Chunked-prefill oracle: every chunk token valid (the ragged oracle
    at ``lengths == C``)."""
    b, c = q.shape[0], q.shape[1]
    lengths = torch.full((b,), c, dtype=torch.int32, device=q.device)
    return ragged_paged_attention_reference(
        q, key_pages, value_pages, block_tables, context_lens, lengths,
        scale)
