"""Paged KV pools for the serving engine: the pool writes with trash-page
routing (full precision and quantize-at-write), the KV codec, and the
ragged and decode attention entry points.

Port of ``paddle_tpu/ops/paged_attention.py`` (``paged_prefill_write``,
``paged_prefill_write_quant``, ``paged_verify_write``,
``paged_verify_write_quant``, ``kv_quant_range``, ``quantize_kv``,
``dequantize_pages``, ``paged_prefill_attention_reference``,
``ragged_paged_attention_reference``, ``paged_attention_reference`` and
the dispatches ``ragged_paged_attention`` and ``paged_attention``).

Pools are ``[KVH, num_pages, page_size, D]``; page 0 is the reserved trash
page that padding and idle slots write to, so a real page is never
clobbered. Unlike the JAX package, whose arrays are immutable and whose
writes return new pools, :func:`paged_prefill_write` writes into the pools
IN PLACE (``index_put_``): that saves a copy of both pools per layer per
step.

Quantized pools (int8 or ``float8_e4m3fn``) carry one f32 scale per
(token, kv head) in a page-parallel scales pool ``[KVH, num_pages,
page_size]``, written at the same (page, offset) as the data, so the
scales ride the block-table indirection unchanged. fp8 pools are written
and gathered through a ``uint8`` view of the same storage (the bits are
the same), so no fp8 indexing kernel is needed on either device.
"""

from __future__ import annotations

import torch

from .kernels.paged_attention import (paged_attention,
                                     paged_attention_reference)
from .kernels.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference)

__all__ = ["paged_prefill_write", "paged_prefill_write_quant",
           "paged_verify_write", "paged_verify_write_quant",
           "paged_prefill_attention_reference", "kv_quant_range",
           "quantize_kv", "dequantize_pages", "paged_attention",
           "paged_attention_reference", "ragged_paged_attention",
           "ragged_paged_attention_reference"]


def kv_quant_range(dtype) -> float:
    """Symmetric range of a quantized KV pool dtype: the largest magnitude
    a code carries, so ``scale = absmax / range``. int8 skips -128."""
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return 448.0       # e4m3 finite max
    raise ValueError(f"not a quantized KV pool dtype: {dtype}")


def quantize_kv(x: torch.Tensor, dtype):
    """Per-vector absmax quantization: x [..., D] float -> (codes [..., D]
    ``dtype``, scales [...] f32) with ``dequant = codes.float() * scale``.
    int8 codes are ``clip(round(y), -127, 127)`` (``torch.round`` rounds
    half to even, as ``jnp.round``). The f32 -> e4m3fn cast saturates at
    448 here where JAX's gives NaN past 464; ``|y| <= 448`` up to the
    rounding of ``x / scale``, so the codes agree."""
    r = kv_quant_range(dtype)
    xf = x.float()
    amax = xf.abs().amax(-1)
    scales = torch.where(amax > 0, amax, 1.0) / r
    y = xf / scales[..., None]
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -127.0, 127.0).to(
            torch.int8), scales
    return y.to(dtype), scales


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor):
    """Quantized pages [..., page, D] x scales [..., page] -> f32."""
    return pages.float() * scales.float()[..., None]


def _bits(pool: torch.Tensor) -> torch.Tensor:
    """The pool itself, or an fp8 pool as ``uint8`` (same storage)."""
    return pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn \
        else pool


def _write_slots(block_tables, ctx, valid, c, page, device):
    """(page id, offset) [B, C] of each chunk token: token j of slot b at
    position ``ctx[b] + j``; ``j >= valid[b]`` goes to trash page 0;
    positions past the row are clamped onto its last page first."""
    j = torch.arange(c, device=device, dtype=torch.int64)
    pos = ctx.long()[:, None] + j[None, :]                         # [B, C]
    pidx = torch.clamp(pos // page, max=block_tables.shape[1] - 1)
    pid = torch.gather(block_tables.long(), 1, pidx)
    pid = torch.where(j[None, :] < valid.long()[:, None], pid, 0)
    return pid, pos % page


def paged_prefill_write(kp: torch.Tensor, vp: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, block_tables: torch.Tensor,
                        ctx: torch.Tensor, valid: torch.Tensor) -> None:
    """Write one chunk's k/v [B, C, KVH, D] into the pools, in place.

    Token j of slot b lands at position ``ctx[b] + j`` of its block-table
    row; tokens with ``j >= valid[b]`` (chunk padding, idle slots) go to
    trash page 0. Positions past the row are clamped onto its last page
    before the lookup (their write is trash-routed anyway)."""
    pid, off = _write_slots(block_tables, ctx, valid, k.shape[1],
                            kp.shape[2], k.device)
    kp[:, pid, off] = k.permute(2, 0, 1, 3)      # index_put_ under the hood
    vp[:, pid, off] = v.permute(2, 0, 1, 3)


def paged_prefill_write_quant(kp, vp, ks, vs, k, v, block_tables, ctx,
                              valid) -> None:
    """Quantize-at-write chunk write into int8/fp8 pools, in place.

    kp, vp [KVH, P, page, D] int8 or ``float8_e4m3fn``, one dtype (the
    mode rides the pool dtype); ks, vs [KVH, P, page] f32 scales pools;
    k, v [B, C, KVH, D] float. Each token's per-kv-head scale lands at the
    (page, offset) its codes do, trash-routed with them
    (:func:`paged_prefill_write`). k and v are quantized in one pass (the
    codec is per vector, so stacking them changes no code)."""
    if vp.dtype != kp.dtype:
        raise TypeError("paged_prefill_write_quant: the k and v pools must "
                        "share a dtype")
    codes, scales = quantize_kv(torch.stack((k, v)), kp.dtype)
    codes = _bits(codes).permute(0, 3, 1, 2, 4)     # [2, KVH, B, C, D]
    scales = scales.permute(0, 3, 1, 2)             # [2, KVH, B, C]
    pid, off = _write_slots(block_tables, ctx, valid, k.shape[1],
                            kp.shape[2], k.device)
    _bits(kp)[:, pid, off] = codes[0]
    _bits(vp)[:, pid, off] = codes[1]
    ks[:, pid, off] = scales[0].to(ks.dtype)
    vs[:, pid, off] = scales[1].to(vs.dtype)


def paged_verify_write(kp, vp, k, v, block_tables, ctx, valid) -> None:
    """Speculative verify write: a ``1 + K``-token verification chunk
    (the pending token and ``K`` drafts) written at positions ``ctx ..
    ctx + K`` of each slot's row, in place, before the target has
    accepted any draft. The routing is :func:`paged_prefill_write`'s: to
    the pool, a verification chunk is a short prefill chunk.

    Rolling back a rejected draft needs no undo, for three reasons:

    - reads are fenced by ctx: query token ``j`` attends positions up to
      ``ctx + j``, and the engine advances ctx by the emitted length
      only, so KV written past it is never read;
    - writes overwrite in place: the slot's next chunk starts at the
      committed ctx and rewrites those offsets before reading them;
    - sharing is prompt-only: the prefix cache publishes full pages of
      prompt tokens, and verify positions lie past the prompt in the
      slot's private pages.

    The serving models route the verification chunk through their own
    prefill write, which is the same routing; this is the public entry
    point under the verify name."""
    paged_prefill_write(kp, vp, k, v, block_tables, ctx, valid)


def paged_verify_write_quant(kp, vp, ks, vs, k, v, block_tables, ctx,
                             valid) -> None:
    """Speculative verify write into int8/fp8 pools with their scales:
    :func:`paged_prefill_write_quant`'s routing, under the rollback
    argument of :func:`paged_verify_write` (a scale is only read with the
    codes it was written with)."""
    paged_prefill_write_quant(kp, vp, ks, vs, k, v, block_tables, ctx,
                              valid)


def paged_prefill_attention_reference(q, key_pages, value_pages,
                                      block_tables, context_lens,
                                      scale=None, k_scales=None,
                                      v_scales=None):
    """Chunked-prefill oracle: every chunk token valid (the ragged oracle
    at ``lengths == C``)."""
    b, c = q.shape[0], q.shape[1]
    lengths = torch.full((b,), c, dtype=torch.int32, device=q.device)
    return ragged_paged_attention_reference(
        q, key_pages, value_pages, block_tables, context_lens, lengths,
        scale, k_scales=k_scales, v_scales=v_scales)
