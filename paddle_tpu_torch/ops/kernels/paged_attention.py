"""Decode-step paged attention: the CUDA kernel K16
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Port of ``paddle_tpu/ops/paged_attention.py::paged_attention``, which on a
TPU reaches the decode kernel jax bundles
(``jax.experimental.pallas.ops.tpu.paged_attention``), with the jnp oracle
``paged_attention_reference`` (what the JAX package runs off the TPU) as
the plain version.

Layouts (as in the JAX package):
  q            [B, H, D], one query token a sequence
  key_pages /  [KVH, num_pages, page_size, D]
  value_pages
  block_tables [B, pages_per_seq] int32
  context_lens [B] int32: tokens in the cache; position < ctx attends
Query head i reads kv head i / (H / KVH).
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference",
           "decode_split_plan"]

_NEG_INF = -1e30
# query heads a kv head and head dims the kernel takes
# (csrc/paged_attention.cu: kMaxRep, launch_d)
_MAX_REP = 8
_HEAD_DIMS = (64, 128)
# the split body (bf16 at these D, pages of a power of two up to 64;
# csrc/paged_attention.cu, split::): splits a (sequence, kv head) at most
# (the portable cluster size), the unit of split_len (whole pages), the
# largest page it takes, the most table entries a split reads into shared
# memory, an H100's SMs, and the CTAs an SM holds at once
# (paged_split's launch bounds: four at rep <= 4, two above)
_MAX_SPLITS = 8
_SPLIT_UNIT = 64
_MAX_PAGE = 64
_MAX_TABLE_PAGES = 4096
_SMS = 132


def decode_split_plan(batch, kv_heads, rep, head_dim, max_keys):
    """``(n_splits, split_len)``: how the split body cuts a sequence's
    keys ``[0, max_keys)`` (``max_keys = pages_per_seq * page_size``)
    over the CTAs of one cluster, from the shapes alone (context_lens
    stays on the device). As many splits as the card holds CTAs at once
    beside the ``batch * kv_heads`` (sequence, kv head) pairs; at most
    ``_MAX_SPLITS``, and no more than there are 64-key units.
    ``split_len`` is a multiple of 64 keys, so every split is whole pages
    of each page size the body takes. Split ``s`` takes keys ``[s *
    split_len, min((s + 1) * split_len, max_keys))``: every key once, no
    split empty. (On an H100, against half or twice the splits: the
    fastest at B 64, where the pairs alone fill the card and there is no
    split, and at Qwen2's 28/4 heads at B 8 (8 splits of 256 keys); at
    Llama-3-8B's 32/8 heads at B 8 four splits ran 5% faster than its
    eight; PERF.md.) ``head_dim`` does not change the plan."""
    del head_dim
    units = max(1, -(-max_keys // _SPLIT_UNIT))
    resident = _SMS * (4 if rep <= 4 else 2)
    n = max(1, min(_MAX_SPLITS, units,
                   resident // max(1, batch * kv_heads)))
    split_len = -(-units // n) * _SPLIT_UNIT
    return max(1, -(-max_keys // split_len)), split_len


def _takes_split(dtype, head_dim, page):
    """Whether the split body runs: bf16 at D 64/128, pages of a power of
    two up to 64 (the first version's body takes the rest)."""
    return (dtype == torch.bfloat16 and head_dim in _HEAD_DIMS
            and 0 < page <= _MAX_PAGE and page & (page - 1) == 0)


def paged_attention_reference(q, key_pages, value_pages, block_tables,
                              context_lens, scale=None):
    """Plain version, the jnp oracle's math: gather every sequence's
    pages, mask ``k_pos < ctx``, the scale on the f32 logits, softmax in
    f32, probabilities cast to the value dtype before P.V.

    Two departures, both where the oracle's output is not meaningful:
    value rows at or past ``ctx`` are replaced by zeros with ``where``
    (they get no weight, but the trash page may hold NaN and ``0 * NaN``
    is NaN), and a sequence with ``ctx == 0`` gets zeros (the oracle's
    softmax is uniform over -1e30 there and averages every gathered
    row)."""
    b, h, d = q.shape
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
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * s
    ctx = context_lens.long()
    seen = torch.arange(max_len, device=q.device)[None, :] < ctx[:, None]
    logits = torch.where(seen[:, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(seen[:, None, :, None], v, zero)
    out = torch.einsum("bhk,bhkd->bhd", probs, v)
    return torch.where((ctx > 0)[:, None, None], out,
                       zero.to(out.dtype)).to(q.dtype)


def paged_attention(q, key_pages, value_pages, block_tables, context_lens,
                    scale=None):
    """Decode-step paged attention. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises: in bf16 at D 64/128 with
    pages of a power of two up to 64, its keys split over the CTAs of a
    cluster by :func:`decode_split_plan` and merged inside it; otherwise
    one CTA per sequence and kv head. One launch either way. Returns
    [B, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, key_pages, value_pages,
                                         block_tables, context_lens, scale)
    if q.device.type != "cuda":
        raise _build.KernelError(f"paged_attention: no kernel for device "
                           f"{q.device}")
    b, h, d = q.shape
    kvh, num_pages, page, dk = key_pages.shape
    if value_pages.shape != key_pages.shape or dk != d:
        raise ValueError(f"paged_attention: pools {tuple(key_pages.shape)} "
                         f"/ {tuple(value_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % kvh or h // kvh > _MAX_REP or d not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: H={h}, KVH={kvh}, D={d} not "
                         f"taken (H/KVH must be at most {_MAX_REP}, D in "
                         f"{_HEAD_DIMS})")
    if key_pages.dtype != q.dtype or value_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q and the pools must share a "
                        "dtype")
    ints = (block_tables, context_lens)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("paged_attention: tables and context_lens must be "
                        "int32")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("paged_attention: tables/context_lens do not match "
                         "the batch")
    tensors = (q, key_pages, value_pages) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"paged_attention: all inputs must be on "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: the kernel takes contiguous "
                         "tensors")
    if key_pages.data_ptr() % 16 or value_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the kernel reads the pools in "
                         "16-byte vectors; they must be aligned")
    code = _build.dtype_code(q.dtype)
    lib = _build.build()
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    n_splits, split_len = 0, 0
    if _takes_split(q.dtype, d, page):
        n_splits, split_len = decode_split_plan(
            b, kvh, h // kvh, d, block_tables.shape[1] * page)
        if split_len // page > _MAX_TABLE_PAGES:  # the first body takes it
            n_splits, split_len = 0, 0
    rc = lib.paged_attention_fwd(
        q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, h, kvh, d, num_pages, page, block_tables.shape[1], float(s), code,
        n_splits, split_len, _build.stream_ptr(q.device))
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
paged_attention.launches = 0
