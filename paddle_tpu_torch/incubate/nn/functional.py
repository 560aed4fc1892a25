"""Functional forms of ``incubate.nn``: decode attention over a paged KV
cache.

Port of ``paddle_tpu/incubate/nn/functional.py``: ``paged_attention``
and its alias ``block_multihead_attention``, through
``ops.kernels.paged_attention`` (K16 on a CUDA tensor, its plain version
on a CPU tensor).
"""

from __future__ import annotations

import torch

from ...ops.kernels import paged_attention as _kpa

__all__ = ["paged_attention", "block_multihead_attention"]


def paged_attention(q, key_pages, value_pages, block_tables, context_lens,
                    scale=None, name=None):
    """Decode-step attention over a paged KV cache: q [B, H, D], pools
    [KVH, num_pages, page_size, D], block_tables [B, pages_per_seq],
    context_lens [B] (tokens in the cache: positions below it attend).
    Int64 tables and lengths (Paddle's default int dtype) are cast to
    int32. Returns [B, H, D] in q's dtype."""
    return _kpa.paged_attention(q, key_pages, value_pages,
                                block_tables.to(torch.int32).contiguous(),
                                context_lens.to(torch.int32).contiguous(),
                                scale)


def block_multihead_attention(q, key_pages, value_pages, block_tables,
                              context_lens, scale=None, name=None,
                              **kwargs):
    """Block (paged) decode attention: the alias of
    :func:`paged_attention` under the reference's name."""
    return paged_attention(q, key_pages, value_pages, block_tables,
                           context_lens, scale=scale)
