"""Ragged paged attention: the CUDA kernel
``csrc/ragged_paged_attention.cu`` and its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py`` (the bf16/f32
``_ragged_kernel`` and its wrapper) with the jnp oracle
``paddle_tpu/ops/paged_attention.py::ragged_paged_attention_reference``
as the plain version. The int8/fp8 pool variant is not ported yet.

Layouts (as in the JAX package):
  q            [B, C, H, D]; slot b's valid tokens are rows [0, lengths[b])
  key_pages /  [KVH, num_pages, page_size, D]; the chunk's k/v were already
  value_pages  written at cache positions ctx .. ctx + length - 1
  block_tables [B, pages_per_seq] int32
  ctx_lens     [B] int32, cache length BEFORE the chunk
  lengths      [B] int32: 0 idle, 1 decode step, > 1 prefill chunk
Query token j attends positions <= ctx + j; rows j >= length are zero.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference"]

_NEG_INF = -1e30
# query rows a CTA holds (csrc/ragged_paged_attention.cu: kRows)
_CTA_ROWS = 64
_HEAD_DIMS = (32, 64, 128, 256)


def ragged_paged_attention_reference(q, key_pages, value_pages,
                                     block_tables, ctx_lens, lengths,
                                     scale=None):
    """Plain version, the jnp oracle's math: gather every slot's pages,
    mask ``k_pos <= ctx + j``, softmax in f32, probabilities cast to the
    value dtype before P.V, rows past ``lengths`` zeroed.

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
    k = key_pages[:, tables].reshape(kvh, b, max_len, d).transpose(0, 1)
    v = value_pages[:, tables].reshape(kvh, b, max_len, d).transpose(0, 1)
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


def ragged_paged_attention(q, key_pages, value_pages, block_tables,
                           ctx_lens, lengths, scale=None):
    """Mixed prefill + decode paged attention. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (one CTA per q
    block, slot and kv head) or raises. Returns [B, C, H, D] in q's
    dtype; every row is written."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, key_pages, value_pages, block_tables, ctx_lens, lengths,
            scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"ragged_paged_attention: no kernel for device "
                           f"{q.device}")
    b, c, h, d = q.shape
    kvh, num_pages, page, dk = key_pages.shape
    if value_pages.shape != key_pages.shape or dk != d:
        raise ValueError(f"ragged_paged_attention: pools "
                         f"{tuple(key_pages.shape)} / "
                         f"{tuple(value_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % kvh or h // kvh > _CTA_ROWS or d not in _HEAD_DIMS:
        raise ValueError(f"ragged_paged_attention: H={h}, KVH={kvh}, D={d} "
                         f"not taken (H/KVH must be at most {_CTA_ROWS}, D "
                         f"in {_HEAD_DIMS})")
    if key_pages.dtype != q.dtype or value_pages.dtype != q.dtype:
        raise TypeError("ragged_paged_attention: q and the pools must share "
                        "a dtype")
    ints = (block_tables, ctx_lens, lengths)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("ragged_paged_attention: tables, ctx and lengths "
                        "must be int32")
    if block_tables.shape[0] != b or ctx_lens.shape != (b,) \
            or lengths.shape != (b,):
        raise ValueError("ragged_paged_attention: tables/ctx/lengths do not "
                         "match the batch")
    tensors = (q, key_pages, value_pages) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: all inputs must be on "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention: the kernel takes "
                         "contiguous tensors")
    if key_pages.data_ptr() % 16 or value_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention: the kernel reads the "
                         "pools in 16-byte vectors; they must be aligned")
    code = _build.dtype_code(q.dtype)
    lib = _build.build()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = lib.ragged_paged_attention_fwd(
        q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(),
        block_tables.data_ptr(), ctx_lens.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, c, h, kvh, d, num_pages, page,
        block_tables.shape[1], float(s), code,
        _build.stream_ptr(q.device))
    _build.check(rc, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
ragged_paged_attention.launches = 0
