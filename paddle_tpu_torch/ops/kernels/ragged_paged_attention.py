"""Ragged paged attention: the CUDA kernels K12 (bf16/f32 pools) and K13
(int8/fp8 pools) of ``csrc/ragged_paged_attention.cu`` and their plain
PyTorch version.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py`` (the bf16/f32
``_ragged_kernel``, the quantized ``_ragged_quant_kernel`` and their
wrapper) with the jnp oracle
``paddle_tpu/ops/paged_attention.py::ragged_paged_attention_reference``
as the plain version.

Layouts (as in the JAX package):
  q            [B, C, H, D]; slot b's valid tokens are rows [0, lengths[b])
  key_pages /  [KVH, num_pages, page_size, D]; the chunk's k/v were already
  value_pages  written at cache positions ctx .. ctx + length - 1
  block_tables [B, pages_per_seq] int32
  ctx_lens     [B] int32, cache length BEFORE the chunk
  lengths      [B] int32: 0 idle, 1 decode step, > 1 prefill chunk
  k_scales /   optional [KVH, num_pages, page_size] f32: when given, the
  v_scales     pools are int8 or float8_e4m3fn codes and a key's value is
               ``code * scale`` of its (page, offset)
Query token j attends positions <= ctx + j; rows j >= length are zero.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_quant",
           "ragged_paged_attention_reference", "split_plan"]

_NEG_INF = -1e30
# query rows a CTA holds (csrc/ragged_paged_attention.cu: kRows)
_CTA_ROWS = 64
_HEAD_DIMS = (32, 64, 128, 256)
_QUANT_POOLS = (torch.int8, torch.float8_e4m3fn)
# the tensor-core kernel (bf16 q at these D; tc::ragged_mma): keys a tile,
# the most keys a split takes, the least it takes to fill the card, the
# CTAs that fill it (about two an SM of an H100), and the most bytes of
# f32 partials a call may hold
_TC_HEAD_DIMS = (64, 128)
_TILE_KEYS = 64
_MAX_SPLIT_KEYS = 512
_FILL_SPLIT_KEYS = 256
_TARGET_CTAS = 256
_PARTIAL_BYTES = 256 * 2 ** 20


def _gather_pages(pool, tables):
    """``pool[:, tables]``; an fp8 pool is gathered through a ``uint8``
    view of its storage (the same bits) and viewed back."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[:, tables].view(pool.dtype)
    return pool[:, tables]


def ragged_paged_attention_reference(q, key_pages, value_pages,
                                     block_tables, ctx_lens, lengths,
                                     scale=None, k_scales=None,
                                     v_scales=None):
    """Plain version, the jnp oracle's math: gather every slot's pages,
    mask ``k_pos <= ctx + j``, softmax in f32, probabilities cast to the
    value dtype before P.V, rows past ``lengths`` zeroed. Quantized pools
    are dequantized to f32 right after the gather, so their probabilities
    stay f32; the output is cast back to q's dtype.

    One addition: value rows at or past ``ctx + length`` are replaced by
    zeros before the product. No valid row gives them weight, but the
    trash page 0 and table padding may hold anything (NaN included) and
    ``0 * NaN`` is NaN, so they are masked by ``where`` instead."""
    b, c, h, d = q.shape
    kvh, _, page, _ = key_pages.shape
    rep = h // kvh
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    max_len = block_tables.shape[1] * page
    tables = block_tables.long()
    # [KVH, B, pages, page, D] -> [B, H, max_len, D]
    k = _gather_pages(key_pages, tables)
    v = _gather_pages(value_pages, tables)
    if k_scales is not None:
        k = k.float() * k_scales[:, tables].float()[..., None]
        v = v.float() * v_scales[:, tables].float()[..., None]
    k = k.reshape(kvh, b, max_len, d).transpose(0, 1)
    v = v.reshape(kvh, b, max_len, d).transpose(0, 1)
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bchd,bhkd->bchk", q.float(), k.float()) * s
    k_pos = torch.arange(max_len, device=q.device)
    ctx = ctx_lens.long()
    allow = k_pos[None, None, :] <= (
        ctx[:, None] + torch.arange(c, device=q.device)[None, :])[:, :, None]
    logits = torch.where(allow[:, :, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    written = k_pos[None, :] < (ctx + lengths.long())[:, None]   # [B, L]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(written[:, None, :, None], v, zero)
    out = torch.einsum("bchk,bhkd->bchd", probs, v)
    valid = torch.arange(c, device=q.device)[None, :] < lengths[:, None]
    return torch.where(valid[:, :, None, None], out,
                       zero.to(out.dtype)).to(q.dtype)


def split_plan(batch, chunk, kv_heads, rep, head_dim, max_keys):
    """``(n_splits, split_len)``: how the bf16 kernel at D 64/128 splits
    a slot's keys ``[0, max_keys)`` (``max_keys = pages_per_seq *
    page_size``) over CTAs, from the shapes alone (ctx and lengths stay on
    the device). Without a split the grid is one CTA per (q block, slot,
    kv head). A split takes at most ``_MAX_SPLIT_KEYS`` keys (the longest
    walk a CTA makes) while the f32 partials of all splits fit in
    ``_PARTIAL_BYTES``, and where that leaves fewer than ``_TARGET_CTAS``
    CTAs (a decode step), more splits of at least ``_FILL_SPLIT_KEYS``
    keys; whole tiles. Split ``s`` takes keys ``[s * split_len, min((s +
    1) * split_len, max_keys))``: every key once. (On an H100 this was the
    fastest of the plans tried at the served shapes: 4 splits of 512 keys
    at Llama-3-8B's decode step and mixed step, 8 of 256 at Qwen2's
    decode step; PERF.md.)"""
    q_blocks = -(-chunk // (_CTA_ROWS // rep))
    base = q_blocks * batch * kv_heads
    per_split = batch * chunk * kv_heads * rep * (head_dim + 2) * 4
    walk = min(-(-max_keys // _MAX_SPLIT_KEYS),
               max(1, _PARTIAL_BYTES // per_split))
    fill = min(-(-_TARGET_CTAS // base), -(-max_keys // _FILL_SPLIT_KEYS))
    n = max(1, walk, fill)
    tiles = max(1, -(-max_keys // _TILE_KEYS))
    split_len = -(-tiles // n) * _TILE_KEYS
    return max(1, -(-max_keys // split_len)), split_len


def ragged_paged_attention(q, key_pages, value_pages, block_tables,
                           ctx_lens, lengths, scale=None, k_scales=None,
                           v_scales=None):
    """Mixed prefill + decode paged attention. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises: K12 for
    bf16/f32 pools, K13 (:func:`ragged_paged_attention_quant`) for
    int8/fp8 pools with their scales. bf16 q at D 64/128 runs the
    tensor-core kernel, its keys split over CTAs by :func:`split_plan`
    (then a second launch merges the f32 partials); other cases one CTA
    per q block, slot and kv head. Returns [B, C, H, D] in q's dtype;
    every row is written."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("ragged_paged_attention: k_scales and v_scales "
                         "come together")
    if k_scales is not None:
        return ragged_paged_attention_quant(
            q, key_pages, value_pages, k_scales, v_scales, block_tables,
            ctx_lens, lengths, scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, key_pages, value_pages, block_tables, ctx_lens, lengths,
            scale)
    if key_pages.dtype != q.dtype or value_pages.dtype != q.dtype:
        raise TypeError("ragged_paged_attention: q and the pools must share "
                        "a dtype")
    out = _launch("ragged_paged_attention", q, key_pages, value_pages, (),
                  block_tables, ctx_lens, lengths, scale)
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention_quant(q, key_pages, value_pages, k_scales,
                                 v_scales, block_tables, ctx_lens, lengths,
                                 scale=None):
    """K13: :func:`ragged_paged_attention` over int8 or float8_e4m3fn
    pools with f32 scales pools [KVH, num_pages, page_size]; q bf16 or
    f32. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, key_pages, value_pages, block_tables, ctx_lens, lengths,
            scale, k_scales=k_scales, v_scales=v_scales)
    kvh, num_pages, page, _ = key_pages.shape
    if key_pages.dtype not in _QUANT_POOLS \
            or value_pages.dtype != key_pages.dtype:
        raise TypeError("ragged_paged_attention: quantized pools are int8 "
                        "or float8_e4m3fn, both of one dtype")
    if any(t.dtype != torch.float32 or t.shape != (kvh, num_pages, page)
           for t in (k_scales, v_scales)):
        raise TypeError(f"ragged_paged_attention: the scales must be f32 "
                        f"[{kvh}, {num_pages}, {page}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("ragged_paged_attention: q must be float32 or "
                        "bfloat16")
    out = _launch("ragged_paged_attention_quant", q, key_pages, value_pages,
                  (k_scales, v_scales), block_tables, ctx_lens, lengths,
                  scale)
    ragged_paged_attention_quant.launches += 1
    return out


def _launch(name, q, key_pages, value_pages, scales, block_tables,
            ctx_lens, lengths, scale):
    """Checks shared by K12 and K13, then the launch; ``scales`` is () or
    (k_scales, v_scales)."""
    if q.device.type != "cuda":
        raise _build.KernelError(f"{name}: no kernel for device {q.device}")
    b, c, h, d = q.shape
    kvh, num_pages, page, dk = key_pages.shape
    if value_pages.shape != key_pages.shape or dk != d:
        raise ValueError(f"{name}: pools {tuple(key_pages.shape)} / "
                         f"{tuple(value_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % kvh or h // kvh > _CTA_ROWS or d not in _HEAD_DIMS:
        raise ValueError(f"{name}: H={h}, KVH={kvh}, D={d} not taken (H/KVH "
                         f"must be at most {_CTA_ROWS}, D in {_HEAD_DIMS})")
    ints = (block_tables, ctx_lens, lengths)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: tables, ctx and lengths must be int32")
    if block_tables.shape[0] != b or ctx_lens.shape != (b,) \
            or lengths.shape != (b,):
        raise ValueError(f"{name}: tables/ctx/lengths do not match the "
                         "batch")
    tensors = (q, key_pages, value_pages) + tuple(scales) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    # 16-byte vector loads: D elements of the pool (D bytes for int8/fp8
    # pools, a multiple of 16 for every D taken) from aligned pools
    if key_pages.data_ptr() % 16 or value_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads the pools in 16-byte "
                         "vectors; they must be aligned")
    code = _build.dtype_code(q.dtype)
    lib = _build.build()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, key_pages, value_pages) + tuple(scales)
            + ints + (out,)]
    dims = (b, c, h, kvh, d, num_pages, page, block_tables.shape[1],
            float(s), code)
    # the tensor-core kernel's key split, and its partials' scratch
    n_splits, split_len, part = 1, block_tables.shape[1] * page, (None, None)
    if q.dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        n_splits, split_len = split_plan(b, c, kvh, h // kvh, d, split_len)
    if n_splits > 1:
        rows = n_splits * b * c * h
        o_part = torch.empty(rows * d, dtype=torch.float32, device=q.device)
        ml_part = torch.empty(rows * 2, dtype=torch.float32,
                              device=q.device)
        part = (o_part.data_ptr(), ml_part.data_ptr())
    plan = (n_splits, split_len, *part, _build.stream_ptr(q.device))
    if scales:
        rc = lib.ragged_paged_attention_quant_fwd(
            *ptrs, *dims, _build.pool_code(key_pages.dtype), *plan)
    else:
        rc = lib.ragged_paged_attention_fwd(*ptrs, *dims, *plan)
    _build.check(rc, name)
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
ragged_paged_attention.launches = 0
ragged_paged_attention_quant.launches = 0
