"""The port's kernel modules (paddle_tpu_torch.ops) against the JAX
package: RMSNorm, SwiGLU, RoPE, the paged pool write and ragged paged
attention. Inputs are made with numpy from a seed and handed to both.

On the CPU every kernel wrapper takes its plain PyTorch version; the
CUDA kernels are held against those plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu.ops.pallas import swiglu as jsw

from paddle_tpu_torch.ops import paged_attention as tpa, rope
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa
from paddle_tpu_torch.ops.kernels import rms_norm as trms
from paddle_tpu_torch.ops.kernels import swiglu as tsw

torch.set_num_threads(1)

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


def _jbf16(a):
    return jnp.asarray(a, jnp.bfloat16)


# ---- RMSNorm ---------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(1, 64), (7, 96), (33, 256)])
def test_rms_norm_plain_matches_jax_f32(n, d):
    rng = np.random.RandomState(n)
    x = rng.randn(n, d).astype(np.float32) * 3
    w = rng.randn(d).astype(np.float32)
    ours = _np(trms.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                             1e-5))
    ref = np.asarray(jrms.rms_norm_reference(jnp.asarray(x),
                                             jnp.asarray(w), 1e-5))
    pallas = np.asarray(jrms.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                      1e-5))
    # f32 throughout; only the order of the row sum differs
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-6)


def test_rms_norm_plain_matches_jax_bf16():
    rng = np.random.RandomState(3)
    x = rng.randn(16, 128).astype(np.float32)
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    ours = _np(trms.rms_norm(_bf16(x), _bf16(w), 1e-6))
    ref = np.asarray(jrms.rms_norm_reference(_jbf16(x), _jbf16(w), 1e-6)
                     .astype(jnp.float32))
    pallas = np.asarray(jrms.rms_norm(_jbf16(x), _jbf16(w), 1e-6)
                        .astype(jnp.float32))
    # per element. Same rounding points as the plain oracle: the f32
    # statistics' summation order may move x*inv by one ulp, which the
    # product with w and its rounding carry to at most three ulps
    assert (np.abs(ours - ref) <= 3 * BF16_ULP * np.abs(ref)).all()
    # the Pallas kernel multiplies by w in f32 before its one rounding:
    # two roundings against one, so up to two ulps
    assert (np.abs(ours - pallas) <= 2 * BF16_ULP * np.abs(pallas)).all()


def test_rms_norm_wrapper_on_cpu_takes_plain_version():
    x = torch.randn(4, 32)
    w = torch.randn(32)
    before = trms.rms_norm.launches
    torch.testing.assert_close(trms.rms_norm(x, w, 1e-6),
                               trms.rms_norm_reference(x, w, 1e-6),
                               rtol=0, atol=0)
    assert trms.rms_norm.launches == before


# ---- SwiGLU ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 128), (3, 7, 96)])
def test_swiglu_plain_matches_jax_f32(shape):
    rng = np.random.RandomState(len(shape))
    g = (rng.randn(*shape) * 4).astype(np.float32)
    u = rng.randn(*shape).astype(np.float32)
    ours = _np(tsw.swiglu(torch.from_numpy(g), torch.from_numpy(u)))
    ref = np.asarray(jsw.swiglu_reference(jnp.asarray(g), jnp.asarray(u)))
    pallas = np.asarray(jsw.swiglu_fused(jnp.asarray(g), jnp.asarray(u)))
    # f32 elementwise: exp/sigmoid implementations differ in the last ulp
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-6)


def test_swiglu_plain_matches_jax_bf16():
    rng = np.random.RandomState(9)
    g = (rng.randn(8, 256) * 3).astype(np.float32)
    u = rng.randn(8, 256).astype(np.float32)
    ours = _np(tsw.swiglu(_bf16(g), _bf16(u)))
    ref = np.asarray(jsw.swiglu_reference(_jbf16(g), _jbf16(u))
                     .astype(jnp.float32))
    pallas = np.asarray(jsw.swiglu_fused(_jbf16(g), _jbf16(u))
                        .astype(jnp.float32))
    # per element. Both round silu to bf16 and then the product; the exp
    # implementations may move silu by one ulp: two ulps of the output
    assert (np.abs(ours - ref) <= 2 * BF16_ULP * np.abs(ref)).all()
    # the Pallas kernel rounds once, from f32: two ulps
    assert (np.abs(ours - pallas) <= 2 * BF16_ULP * np.abs(pallas)).all()


# ---- RoPE ------------------------------------------------------------------

def test_rope_tables_and_rotation_match_jax():
    s_j, c_j = jrope.build_sin_cos(40, 16, 500000.0)
    s_t, c_t = rope.build_sin_cos(40, 16, 500000.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pid = np.array([[0, 1, 2, 3, 4], [30, 31, 32, 33, 34]], np.int32)
    ours = rope.apply_rope(torch.from_numpy(x), s_t, c_t,
                           torch.from_numpy(pid).long()).numpy()
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), s_j, c_j,
                                      jnp.asarray(pid)))
    # the same f32 products and sums in the same order
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    no_pid = rope.apply_rope(torch.from_numpy(x), s_t, c_t).numpy()
    ref0 = np.asarray(jrope.apply_rope(jnp.asarray(x), s_j[:5], c_j[:5]))
    np.testing.assert_allclose(no_pid, ref0, rtol=1e-6, atol=1e-6)


# ---- paged pool write -------------------------------------------------------

def test_paged_prefill_write_matches_jax_bit_for_bit():
    rng = np.random.RandomState(5)
    KVH, P, page, D, B, C = 2, 12, 4, 8, 3, 6
    kp = rng.randn(KVH, P, page, D).astype(np.float32)
    vp = rng.randn(KVH, P, page, D).astype(np.float32)
    k = rng.randn(B, C, KVH, D).astype(np.float32)
    v = rng.randn(B, C, KVH, D).astype(np.float32)
    # slot 0 straddles a page, slot 1 writes past its row (clamped,
    # trash-routed), slot 2 is idle
    tables = np.array([[3, 7, 1], [5, 2, 9], [4, 6, 8]], np.int32)
    ctx = np.array([2, 10, 0], np.int32)
    valid = np.array([6, 2, 0], np.int32)
    jk, jv = jpa.paged_prefill_write(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(valid))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tpa.paged_prefill_write(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(tables), torch.from_numpy(ctx),
                            torch.from_numpy(valid))
    # real pages bit-identical; padding reached no page but trash page 0
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    # slot 0 fills pages 3 and 7, slot 1 page 9; the rest went to page 0
    changed = np.any(tk.numpy() != kp, axis=(0, 2, 3))
    assert set(np.flatnonzero(changed)) == {0, 3, 7, 9}


# ---- ragged paged attention -------------------------------------------------

def _ragged_case(seed, B=4, C=8, H=8, KVH=2, D=16, page=4, pages=6):
    """Scattered pages (page 0 is trash), mixed lengths: idle, decode,
    a prefill chunk that straddles pages, a full chunk."""
    rng = np.random.RandomState(seed)
    P = B * pages + 1
    kp = rng.randn(KVH, P, page, D).astype(np.float32)
    vp = rng.randn(KVH, P, page, D).astype(np.float32)
    tables = (rng.permutation(P - 1) + 1)[:B * pages].reshape(
        B, pages).astype(np.int32)
    q = rng.randn(B, C, H, D).astype(np.float32)
    ctx = np.array([5, 9, 2, 13][:B], np.int32)
    lengths = np.array([0, 1, 5, C][:B], np.int32)
    # table padding past each slot's last page points at trash page 0
    for b in range(B):
        used = -(-(int(ctx[b]) + int(lengths[b])) // page)
        tables[b, max(used, 1):] = 0
    return q, kp, vp, tables, ctx, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed,H,KVH", [(0, 8, 2), (1, 4, 4), (2, 8, 1)])
def test_ragged_attention_plain_matches_jax_oracle(seed, H, KVH):
    q, kp, vp, tables, ctx, lengths = _ragged_case(seed, H=H, KVH=KVH)
    ours = trpa.ragged_paged_attention(*_t(q, kp, vp, tables, ctx,
                                           lengths)).numpy()
    ref = np.asarray(jpa.ragged_paged_attention_reference(
        *[jnp.asarray(a) for a in (q, kp, vp, tables, ctx, lengths)]))
    # f32 on both sides; softmax and the contractions sum in another order
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    assert not ours[0].any()                      # idle slot: zeros
    assert not ours[1, 1:].any()                  # decode: one row
    assert ours[2, :5].any() and not ours[2, 5:].any()


def test_ragged_attention_nan_trash_page_never_reaches_output():
    q, kp, vp, tables, ctx, lengths = _ragged_case(7)
    clean = trpa.ragged_paged_attention_reference(
        *_t(q, kp, vp, tables, ctx, lengths)).numpy()
    kp[:, 0] = np.nan
    vp[:, 0] = np.nan
    poisoned = trpa.ragged_paged_attention_reference(
        *_t(q, kp, vp, tables, ctx, lengths)).numpy()
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(poisoned, clean)


def test_prefill_oracle_is_ragged_oracle_at_full_length():
    q, kp, vp, tables, ctx, _ = _ragged_case(3)
    lengths = np.full((q.shape[0],), q.shape[1], np.int32)
    tables = np.where(tables == 0, 1, tables).astype(np.int32)
    ours = tpa.paged_prefill_attention_reference(
        *_t(q, kp, vp, tables, ctx)).numpy()
    ref = np.asarray(jpa.paged_prefill_attention_reference(
        *[jnp.asarray(a) for a in (q, kp, vp, tables, ctx)]))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    full = trpa.ragged_paged_attention_reference(
        *_t(q, kp, vp, tables, ctx, lengths)).numpy()
    np.testing.assert_array_equal(ours, full)
