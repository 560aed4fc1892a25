"""The split body of the decode paged-attention kernel (K16 in bf16 at D
64/128) and the two-pass formulation of the CE-stats kernel (K10), on
the CPU.

K16: the plan is a function of the shapes alone, cuts whole pages, covers
every key once and makes at most 8 splits (one cluster); the merge rule
(written here in plain torch, as the kernel applies it: each split's
four warps take 8 keys of every 32-key stage, the warps' f32 states are
merged in warp order into the split's partial, and rank 0 merges the
partials in rank order, skipping a split at the floor) gives the unsplit
attention of the port's plain version and of the JAX package's jnp
oracle. K10: the slab-wise two passes (the max, then a sum of exp2
against it, merged once a slab) give the statistics of the JAX Pallas
body run in interpret mode and of the port's plain version.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu.ops.pallas import ce_chunk as jce
from paddle_tpu_torch.ops.kernels import ce_chunk as tce
from paddle_tpu_torch.ops.kernels import paged_attention as kpa

# the floor of a state's max where it has seen no key
NEG_INF = -1e30
# the kernel's ring stage and the keys a warp takes of it
STAGE_KEYS, WARP_KEYS, WARPS = 32, 8, 4
LOG2E = 1.4426950408889634

# (batch, kv heads, rep, head dim, keys a sequence): the decode phase
# (B 8/64, Llama-3-8B's 32/8 heads, 129 pages of 16) and the kernel
# phase's 128 pages, Qwen2's 28/4 heads, pages of 4, 8 and 32 (129 of
# each), and tiny tables
PLAN_SHAPES = [(8, 8, 4, 128, 2064), (64, 8, 4, 128, 2064),
               (8, 8, 4, 128, 2048), (64, 8, 4, 128, 2048),
               (8, 4, 7, 128, 2048), (64, 4, 7, 128, 2064),
               (8, 8, 4, 128, 129 * 4), (8, 8, 4, 128, 129 * 8),
               (8, 8, 4, 128, 129 * 32), (1, 8, 4, 128, 2048),
               (1, 1, 1, 64, 4), (2, 2, 2, 64, 16), (3, 2, 8, 64, 100),
               (512, 8, 1, 64, 32768)]


@pytest.mark.parametrize("b,kvh,rep,d,max_keys", PLAN_SHAPES)
def test_decode_split_plan_covers_every_key_once(b, kvh, rep, d, max_keys):
    n, length = kpa.decode_split_plan(b, kvh, rep, d, max_keys)
    # shapes alone: the same plan every time, from Python ints
    assert (n, length) == kpa.decode_split_plan(b, kvh, rep, d, max_keys)
    # one cluster of at most 8 CTAs; whole pages of every page size the
    # split body takes (powers of two up to 64)
    assert 1 <= n <= 8
    assert all(length % page == 0 for page in (1, 2, 4, 8, 16, 32, 64))
    # splits [s * length, min((s + 1) * length, max_keys)) partition the
    # keys, and none is empty
    seen = np.zeros(max_keys, np.int64)
    for s in range(n):
        lo, hi = s * length, min((s + 1) * length, max_keys)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()


def test_decode_split_plan_at_the_decode_shapes():
    """Llama-3-8B's decode at B 8 (2048 keys a sequence) takes 8 splits
    of 256 keys, 512 CTAs; at B 64 the 512 (sequence, kv head) pairs
    fill the card alone, so none; the decode phase's 129 pages of 16
    take 7 of 320; Qwen2's 28/4 heads (two CTAs an SM at rep 7) 8 at B 8
    and none at B 64."""
    assert kpa.decode_split_plan(8, 8, 4, 128, 2048) == (8, 256)
    assert kpa.decode_split_plan(64, 8, 4, 128, 2048) == (1, 2048)
    assert kpa.decode_split_plan(8, 8, 4, 128, 2064) == (7, 320)
    assert kpa.decode_split_plan(8, 4, 7, 128, 2048) == (8, 256)
    assert kpa.decode_split_plan(64, 4, 7, 128, 2064) == (1, 2112)
    # a table of one 64-key unit is not split
    assert kpa.decode_split_plan(8, 8, 4, 128, 16) == (1, 64)


def _states(x, v, sees):
    """f32 softmax states over the keys each row ``sees``: ``m`` the
    largest score (log2 units, scale applied) at the floor where it sees
    none, ``l = sum 2^(x - m)`` and ``o = sum 2^(x - m) v`` over them.
    x [B, H, K], v [B, H, K, D], sees [B, 1 or H, K]."""
    xs = torch.where(sees, x, NEG_INF)
    m = xs.amax(-1).clamp(min=NEG_INF)
    p = torch.where(sees, torch.exp2(xs - m[..., None]), 0.0)
    vz = torch.where(sees[..., None], v, 0.0)
    return torch.einsum("bhk,bhkd->bhd", p, vz), m, p.sum(-1)


def _merge(o, m, l):
    """States merged in order (the list's): ``M`` the largest ``m``, each
    state's (o, l) weighted by ``2^(m - M)``; a state at the floor is
    skipped, its o never read. Returns the merged (o, m, l)."""
    big = torch.stack(m).amax(0)
    o_sum, l_sum = torch.zeros_like(o[0]), torch.zeros_like(l[0])
    for oi, mi, li in zip(o, m, l):
        w = torch.where(mi > NEG_INF, torch.exp2(mi - big), 0.0)
        o_sum = o_sum + torch.where((mi > NEG_INF)[..., None], oi, 0.0) \
            * w[..., None]
        l_sum = l_sum + w * li
    return o_sum, big, l_sum


def _split_decode(q, key_pages, value_pages, block_tables, context_lens,
                  n_splits, split_len, scale=None):
    """The split body's arithmetic in plain torch, in f32: split ``s``
    takes keys ``[s * split_len, (s + 1) * split_len)`` below the
    context; in it, warp ``w`` takes keys ``8w .. 8w + 7`` of each
    32-key stage; the warps' states merge in warp order into the split's
    partial, the partials in rank order into the output, and a row that
    saw no key (ctx 0) gets zeros. Returns [B, H, D] f32."""
    b, h, d = q.shape
    kvh, _, page, _ = key_pages.shape
    rep = h // kvh
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    max_len = block_tables.shape[1] * page
    tables = block_tables.long()
    k = key_pages[:, tables].float().reshape(kvh, b, max_len, d)
    v = value_pages[:, tables].float().reshape(kvh, b, max_len, d)
    k = k.transpose(0, 1).repeat_interleave(rep, dim=1)
    v = v.transpose(0, 1).repeat_interleave(rep, dim=1)
    x = torch.einsum("bhd,bhkd->bhk", q.float(), k) * (s / math.log(2))
    pos = torch.arange(max_len)
    below = (pos[None, :] < context_lens.long()[:, None])[:, None, :]
    parts = []
    for i in range(n_splits):
        inside = (pos >= i * split_len) & (pos < (i + 1) * split_len)
        warp = (pos - i * split_len) % STAGE_KEYS // WARP_KEYS
        states = [_states(x, v, below & (inside & (warp == w))[None, None])
                  for w in range(WARPS)]
        parts.append(_merge(*zip(*states)))
    o, _, l = _merge(*zip(*parts))
    return o / torch.where(l > 0, l, 1.0)[..., None]


def _decode_batch(rep, kvh, d, page, trash, seed, ctx):
    """Sequences of contexts ``ctx`` over a shuffled pool; table entries
    past a context point at the trash page 0."""
    rng = np.random.RandomState(seed)
    ctx = np.asarray(ctx, np.int32)
    b, h = len(ctx), rep * kvh
    pages = -(-int(ctx.max()) // page) + 1
    n_pages = b * pages + 1
    tables = (rng.permutation(n_pages - 1) + 1).reshape(b, pages)
    for i in range(b):
        tables[i, -(-int(ctx[i]) // page):] = 0
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    kp[:, 0] = vp[:, 0] = trash
    q = rng.randn(b, h, d).astype(np.float32)
    return q, kp, vp, tables.astype(np.int32), ctx


def _contexts(split_len):
    """ctx 0 and 1, on a split's first and last key and past it, a
    context that leaves later splits empty, and the longest."""
    return [0, 1, split_len, split_len - 1, split_len + 1, 2 * split_len,
            3 * split_len + 5, 150]


@pytest.mark.parametrize("split_len", [24, 64, 100])
@pytest.mark.parametrize("rep", [1, 4, 7, 8])
@pytest.mark.parametrize("page", [8, 16])
def test_split_merge_matches_the_reference(split_len, rep, page):
    """Splits that cut pages (24 and 100 keys at pages of 8 and 16), rep
    1 to 8: the merged splits give the port's plain version within 1e-5
    of sum p|v| + 1e-6 in f32; the NaN trash page reaches no row, and a
    sequence at ctx 0 gets zeros."""
    arrays = _decode_batch(rep, 2, 16, page, np.nan, rep + page,
                           _contexts(split_len))
    q, kp, vp, tb, ct = (torch.from_numpy(a) for a in arrays)
    n = -(-tb.shape[1] * page // split_len)
    out = _split_decode(q, kp, vp, tb, ct, n, split_len)
    ref = kpa.paged_attention_reference(q, kp, vp, tb, ct)
    a = kpa.paged_attention_reference(q, kp, vp.abs(), tb, ct)
    assert torch.isfinite(out).all() and not out[0].any()
    assert ((out - ref).abs() <= 1e-5 * a + 1e-6).all()


@pytest.mark.parametrize("rep", [1, 4, 7, 8])
def test_split_merge_matches_the_jax_oracle(rep):
    """The same merge, at the plan the kernel takes for these shapes,
    against the JAX package's jnp oracle (a finite trash page: the oracle
    computes 0 * trash; rows with ctx > 0: at ctx 0 the oracle averages
    its gathered rows, where both ports write zeros)."""
    ctx = [1, 63, 64, 65, 128, 200, 7, 256]
    q, kp, vp, tb, ct = _decode_batch(rep, 2, 64, 16, 0.5, rep, ctx)
    n, length = kpa.decode_split_plan(len(ctx), 2, rep, 64,
                                      tb.shape[1] * 16)
    assert n > 1
    t = [torch.from_numpy(x) for x in (q, kp, vp, tb, ct)]
    out = _split_decode(*t, n, length)
    ref = np.asarray(JPA.paged_attention_reference(
        *(jnp.asarray(x) for x in (q, kp, vp, tb, ct))))
    a = kpa.paged_attention_reference(t[0], t[1], t[2].abs(), t[3], t[4])
    assert (np.abs(out.numpy() - ref) <= 1e-5 * a.numpy() + 1e-6).all()


def test_an_empty_split_leaves_the_floor():
    """A split at or past a row's context sees no key: its state is at
    the floor with l = 0 and o = 0, and the merge skips it."""
    x = torch.randn(1, 2, 64)
    v = torch.randn(1, 2, 64, 4)
    none = torch.zeros(1, 1, 64, dtype=torch.bool)
    o, m, l = _states(x, v, none)
    assert (m == NEG_INF).all() and not l.any() and not o.any()
    some = torch.arange(64)[None, None] < 10
    o1, m1, l1 = _states(x, v, some)
    merged = _merge([o1, o, o], [m1, m, m], [l1, l, l])
    for got, want in zip(merged, (o1, m1, l1)):
        assert torch.equal(got, want)


# ---- K10: two passes over a slab held in registers -------------------------

def _two_pass_stats(logits, local, lo):
    """K10's slab-wise formulation in plain torch, in f32: per slab (1024
    columns of bf16, 512 of f32: 32 lanes x 4 vectors of 16 bytes), the
    max over the columns >= lo, then the sum of ``exp2((x - m) *
    log2e)`` against the running max, the running sum rescaled once a
    slab; the target is the label's column where it lies in [lo, vc).
    A row with no column left gives m = -inf, s = 0."""
    x = logits.float()
    n, vc = x.shape
    slab = 32 * 4 * (16 // logits.element_size())
    col = torch.arange(vc)
    m = torch.full((n,), -math.inf)
    s = torch.zeros(n)
    for base in range(0, vc, slab):
        cols = (col >= max(lo, base)) & (col < base + slab)
        xs = torch.where(cols, x, -math.inf)
        m_new = torch.maximum(m, xs.amax(-1))
        live = m_new > -math.inf
        mn = torch.where(live, m_new, 0.0)
        p = torch.where(cols, torch.exp2((x - mn[:, None]) * LOG2E), 0.0)
        alpha = torch.where(m > -math.inf, torch.exp2((m - mn) * LOG2E), 0.0)
        s = torch.where(live, s * alpha + p.sum(-1), s)
        m = m_new
    local = local.long()
    hit = (local >= lo) & (local < vc)
    t = torch.where(hit, x.gather(1, local.clamp(0, vc - 1)[:, None])[:, 0],
                    0.0)
    return m, s, t


def _stats_data(n, vc, lo, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, vc) * 3).astype(np.float32)
    local = rng.randint(min(lo, vc - 1), vc, n).astype(np.int32)
    # labels below 0 and at or past vc (another chunk's), in the overlap
    # prefix (< lo), at lo and on the last column
    local[:6] = [-5, vc, vc + 7, max(lo - 1, 0), min(lo, vc - 1), vc - 1]
    return logits, local


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,vc,lo", [(16, 1024, 0), (16, 1024, 768),
                                     (9, 1024, 1024), (9, 40, 13),
                                     (9, 40, 0), (8, 4096, 0),
                                     (8, 4096, 3000)])
def test_two_pass_stats_match_jax_and_the_plain_version(dtype, n, vc, lo):
    """The two passes against the JAX ``_stats_kernel`` (interpret mode)
    and the port's plain version: m and t exact, s within 2e-5 of s, at
    lo 0, the tail chunk's overlap and lo = vc (no column left), labels
    out of the chunk, vc 40, 1024 and 4096 (one slab and several)."""
    logits_np, local_np = _stats_data(n, vc, lo, n + vc + lo)
    logits = torch.from_numpy(logits_np).to(dtype)
    local = torch.from_numpy(local_np)
    m, s, t = _two_pass_stats(logits, local, lo)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm, js, jt = jce.chunk_stats(jnp.asarray(logits_np).astype(jdt),
                                 jnp.asarray(local_np), lo)
    rm, rs, rt = tce.chunk_stats_reference(logits, local, lo)
    for ref_m, ref_s, ref_t in ((np.asarray(jm), np.asarray(js),
                                 np.asarray(jt)),
                                (rm.numpy(), rs.numpy(), rt.numpy())):
        np.testing.assert_array_equal(m.numpy(), ref_m)
        np.testing.assert_array_equal(t.numpy(), ref_t)
        assert (np.abs(s.numpy() - ref_s) <= 2e-5 * ref_s).all()
    if lo == vc:
        assert (m == -math.inf).all() and not s.any() and not t.any()
