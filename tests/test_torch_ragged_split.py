"""The key split of the bf16 ragged paged-attention kernel (K12/K13 at D
64 and 128), on the CPU: the plan is a function of the shapes alone and
covers every key once, and the merge rule of the split's f32 partials
(written here in plain torch, as the kernel's two launches apply it)
gives the attention of the unsplit reference, the port's and the JAX
package's jnp oracle, at splits that cut pages."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as JPA
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa

# (batch, chunk, kv heads, rep, keys a slot): decode and mixed steps of
# the served models (Llama-3-8B 32/8, Qwen2 28/4), B 64 decode, the
# decode entry point's table (129 pages of 16), small test shapes
PLAN_SHAPES = [(8, 1, 8, 4, 2048), (8, 256, 8, 4, 2048), (8, 1, 4, 7, 2048),
               (8, 256, 4, 7, 2048), (64, 1, 8, 4, 2048), (8, 1, 8, 4, 2064),
               (2, 1, 2, 2, 1024), (6, 24, 8, 4, 96), (1, 1, 1, 64, 4),
               (3, 5, 2, 7, 2100), (8, 1, 8, 4, 16)]
# the floor of a row's largest score where it sees no key of a split
NEG_INF = -1e30


@pytest.mark.parametrize("b,c,kvh,rep,max_keys", PLAN_SHAPES)
def test_split_plan_covers_every_key_once(b, c, kvh, rep, max_keys):
    n, length = krpa.split_plan(b, c, kvh, rep, 128, max_keys)
    # shapes alone: the same plan every time, from Python ints
    assert (n, length) == krpa.split_plan(b, c, kvh, rep, 128, max_keys)
    assert n >= 1 and length % 64 == 0
    # no CTA walks more than 512 keys of a slot
    assert length <= 512
    # splits [s * length, min((s + 1) * length, max_keys)) partition the
    # keys, and none is empty
    seen = np.zeros(max_keys, np.int64)
    for s in range(n):
        lo, hi = s * length, min((s + 1) * length, max_keys)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()


def test_split_plan_at_the_served_steps():
    """The plans of the served steps (2048 keys a slot): Llama-3-8B's
    decode and mixed steps take 4 splits of 512 keys; Qwen2's decode step
    (4 kv heads) 8 of 256, which fill the card with 256 CTAs; a short
    table is not split."""
    assert krpa.split_plan(8, 1, 8, 4, 128, 2048) == (4, 512)
    assert krpa.split_plan(8, 256, 8, 4, 128, 2048) == (4, 512)
    assert krpa.split_plan(64, 1, 8, 4, 128, 2048) == (4, 512)
    assert krpa.split_plan(8, 1, 4, 7, 128, 2048) == (8, 256)
    assert krpa.split_plan(6, 24, 8, 4, 128, 96) == (1, 128)


@pytest.mark.parametrize("c", [1, 256])
def test_split_plan_bounds_the_partials(c):
    """At a long table (32768 keys a slot) a decode step still walks 512
    keys a CTA, while a mixed step's f32 partials stay within 256 MiB:
    longer splits, every key once."""
    b, kvh, rep, d, max_keys = 8, 8, 4, 128, 32768
    n, length = krpa.split_plan(b, c, kvh, rep, d, max_keys)
    assert n * b * c * kvh * rep * (d + 2) * 4 <= 256 * 2 ** 20
    assert (n - 1) * length < max_keys <= n * length
    assert length == 512 if c == 1 else n > 1


def _split_partials(q, key_pages, value_pages, block_tables, ctx_lens,
                    lengths, n_splits, split_len, scale=None):
    """The split kernel's partials in plain torch, in f32: for split
    ``s`` and each row, ``m`` the largest score (in log2 units, scale
    applied) among the keys of ``[s * split_len, (s + 1) * split_len)``
    that the row sees, ``l = sum 2^(score - m)`` and ``o = sum 2^(score -
    m) v`` over them; a split that sees none has ``m = -1e30``, ``l = 0``,
    ``o = 0``. Returns o [S, B, C, H, D], m and l [S, B, C, H]."""
    b, c, h, d = q.shape
    kvh, _, page, _ = key_pages.shape
    rep = h // kvh
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    max_len = block_tables.shape[1] * page
    tables = block_tables.long()
    k = key_pages[:, tables].float().reshape(kvh, b, max_len, d)
    v = value_pages[:, tables].float().reshape(kvh, b, max_len, d)
    k = k.transpose(0, 1).repeat_interleave(rep, dim=1)
    v = v.transpose(0, 1).repeat_interleave(rep, dim=1)
    x = torch.einsum("bchd,bhkd->bchk", q.float(), k) * (s / math.log(2))
    k_pos = torch.arange(max_len, device=q.device)
    sees = k_pos[None, None, :] <= (
        ctx_lens.long()[:, None]
        + torch.arange(c, device=q.device)[None, :])[:, :, None]
    # keys the kernel never loads (at or past ctx + length) are zeros
    written = k_pos[None, :] < (ctx_lens.long() + lengths.long())[:, None]
    o, m, l = [], [], []
    for i in range(n_splits):
        inside = (k_pos >= i * split_len) & (k_pos < (i + 1) * split_len)
        ok = (sees & inside[None, None, :])[:, :, None, :]
        xi = torch.where(ok, x, NEG_INF)
        mi = xi.amax(-1)
        p = torch.where(ok, torch.exp2(xi - mi[..., None]), 0.0)
        vi = torch.where((written & inside[None, :])[:, None, :, None], v,
                         0.0)
        o.append(torch.einsum("bchk,bhkd->bchd", p, vi))
        m.append(mi)
        l.append(p.sum(-1))
    return torch.stack(o), torch.stack(m), torch.stack(l)


def _merge_partials(o, m, l, lengths, dtype):
    """The merge launch (``ragged_merge``) in plain torch: splits in
    order, ``out = sum_s o_s 2^(m_s - M) / sum_s l_s 2^(m_s - M)`` with M
    the largest ``m_s``, a split at the floor ``m_s = -1e30`` skipped;
    rows past a slot's length are zeros. Returns [B, C, H, D] in
    ``dtype``."""
    big = m.amax(0)
    seen = m > NEG_INF
    w = torch.where(seen, torch.exp2(m - big), 0.0)
    num = torch.where(seen[..., None], o, 0.0) * w[..., None]
    out = num.sum(0) / (w * l).sum(0).clamp(min=1e-30)[..., None]
    c = out.shape[1]
    valid = torch.arange(c, device=o.device)[None, :] < lengths[:, None]
    return torch.where(valid[:, :, None, None], out, 0.0).to(dtype)


def _batch(rep, kvh, d, page, trash, seed):
    """A mixed batch (idle, decode, prefill slots) whose contexts end on
    and beside page and split edges; page 0 is the trash page."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, 1, 7, 1, 5], np.int32)
    ctx = np.array([0, 63, 64, 120, 191, 0], np.int32)
    b, c, h = len(ctx), 8, rep * kvh
    pages = -(-int((ctx + lengths).max()) // page) + 1
    n_pages = b * pages + 1
    tables = (rng.permutation(n_pages - 1) + 1).reshape(b, pages)
    for i in range(b):
        tables[i, -(-int(ctx[i] + lengths[i]) // page):] = 0
    kp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    vp = rng.randn(kvh, n_pages, page, d).astype(np.float32)
    kp[:, 0] = vp[:, 0] = trash
    q = rng.randn(b, c, h, d).astype(np.float32)
    return q, kp, vp, tables.astype(np.int32), ctx, lengths


@pytest.mark.parametrize("split_len", [24, 40, 64, 100])
@pytest.mark.parametrize("rep,page", [(4, 16), (7, 8), (2, 48)])
def test_merge_rule_matches_the_reference(split_len, rep, page):
    """Partials over splits that cut pages, merged in split order, give
    the unsplit reference within 1e-6 in f32; the NaN trash page never
    reaches a row."""
    arrays = _batch(rep, 2, 16, page, np.nan, seed=rep + page)
    q, kp, vp, tb, ct, ln = (torch.from_numpy(a) for a in arrays)
    max_keys = tb.shape[1] * page
    n = -(-max_keys // split_len)
    o, m, l = _split_partials(q, kp, vp, tb, ct, ln, n,
                                            split_len)
    assert o.shape == (n, *q.shape) and m.shape == l.shape == (n, *q.shape[:3])
    out = _merge_partials(o, m, l, ln, torch.float32)
    ref = krpa.ragged_paged_attention_reference(q, kp, vp, tb, ct, ln)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rep", [4, 7])
def test_merge_rule_matches_the_jax_oracle(rep):
    """The same merge against the JAX package's jnp oracle (a finite
    trash page: the oracle computes 0 * trash)."""
    q, kp, vp, tb, ct, ln = _batch(rep, 2, 16, 16, 0.5, seed=rep)
    length = 64                       # a split every 64 keys
    n = -(-tb.shape[1] * 16 // length)
    t = [torch.from_numpy(a) for a in (q, kp, vp, tb, ct, ln)]
    o, m, l = _split_partials(*t, n, length)
    out = _merge_partials(o, m, l, t[-1], torch.float32)
    ref = np.asarray(JPA.ragged_paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, tb, ct, ln))))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_partials_of_a_split_past_the_keys_are_empty():
    """A split that starts past a row's keys sees none: m at the floor, l
    and o zero, and the merge skips it."""
    q, kp, vp, tb, ct, ln = (torch.from_numpy(a) for a in _batch(
        4, 2, 16, 16, np.nan, seed=1))
    o, m, l = _split_partials(q, kp, vp, tb, ct, ln, 4, 64)
    # slot 1 (ctx 63, one token) sees keys 0..63: splits 1.. are empty
    assert (m[1:, 1, 0] == -1e30).all() and not l[1:, 1, 0].any()
    assert not o[1:, 1, 0].any()
    assert math.isfinite(float(m[0, 1, 0].max()))
