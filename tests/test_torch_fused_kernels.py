"""The port's fused training kernels against the JAX package, on the CPU:
the residual-fused RMSNorm (K3 forward, K4 backward), the fused linear+CE
chunk kernels (K10 statistics, K11 dlogits) and the fused linear+CE op
around them.

The port's side runs its plain versions (CPU tensors), through the
autograd Functions the model uses. The JAX side runs the Pallas kernels
in interpret mode, as the JAX package's own tests do on the CPU:
``ops.pallas.rms_norm.rms_norm_residual`` and its vjp (K3/K4),
``ops.pallas.ce_chunk.chunk_stats``/``chunk_dlogits`` (K10/K11), and
``ops.fused_ce.fused_linear_cross_entropy`` under ``force_pallas_inner``
and through its jnp scan body. Inputs are numpy from a seed. The CUDA
kernels are held against the same plain versions on the card by
tests/test_torch_cuda.py.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import fused_ce as jfce
from paddle_tpu.ops.pallas import ce_chunk as jce
from paddle_tpu.ops.pallas import rms_norm as jrms

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.ops import fused_ce as tfce
from paddle_tpu_torch.ops.kernels import ce_chunk as tce
from paddle_tpu_torch.ops.kernels import rms_norm as trms

torch.set_num_threads(1)

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype, grad=False):
    """The same numpy values as a torch and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return (t.requires_grad_() if grad else t,
            jnp.asarray(a, jnp.float32).astype(jdt))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(ours, ref, tol):
    """Element by element: ``tol`` holds each element's limit."""
    err = np.abs(_np(ours) - _np(ref))
    assert (err <= tol).all(), float((err / tol).max())


# ---- K3/K4: RMSNorm + residual ---------------------------------------------

def _res_data(n, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32) * 2,
            rng.randn(n, d).astype(np.float32),
            (1 + 0.2 * rng.randn(d)).astype(np.float32),
            rng.randn(n, d).astype(np.float32),
            rng.randn(n, d).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(37, 24), (9, 96)])
def test_rms_norm_residual_forward_matches_jax_kernel(dtype, n, d):
    """37 and 9 rows: no multiple of the Pallas row block (8)."""
    x_np, r_np, w_np, _, _ = _res_data(n, d, n + d)
    (tx, jx), (tr, jr), (tw, jw) = (_pair(a, dtype)
                                    for a in (x_np, r_np, w_np))
    y, r = trms.RMSNormResidualFunction.apply(tx, tr, tw, 1e-5)
    jy, jrr = jrms.rms_norm_residual(jx, jr, jw, 1e-5)
    ry, rr = jrms.rms_norm_residual_reference(jx, jr, jw, 1e-5)
    # r is the sum in the input dtype on every side: exact
    np.testing.assert_array_equal(_np(r), _np(jrr))
    if dtype == "float32":
        # the same f32 formula; the Pallas body multiplies by w before
        # its one rounding, the plain versions after: a few f32 ulps
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(y), _np(ry), rtol=1e-6, atol=1e-7)
    else:
        # the port rounds where the JAX plain version does ((r*inv) to
        # bf16, then times w): the row sum's order may move r*inv by one
        # ulp, which the product carries to three ulps of |y|
        _within(y, ry, 3 * BF16_ULP * np.abs(_np(ry)) + 1e-6)
        # the Pallas body rounds once, the plain version twice: one more
        # ulp for the first rounding
        _within(y, jy, 4 * BF16_ULP * np.abs(_np(jy)) + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(37, 24), (9, 96)])
def test_rms_norm_residual_backward_matches_jax_kernel(dtype, n, d):
    x_np, r_np, w_np, gy_np, gr_np = _res_data(n, d, 3 * n + d)
    (tx, jx), (tr, jr), (tw, jw) = (_pair(a, dtype, grad=True)
                                    for a in (x_np, r_np, w_np))
    (tgy, jgy), (tgr, jgr) = _pair(gy_np, dtype), _pair(gr_np, dtype)
    y, r = trms.RMSNormResidualFunction.apply(tx, tr, tw, 1e-5)
    torch.autograd.backward((y, r), (tgy, tgr))
    _, vjp = jax.vjp(lambda a, b, c: jrms.rms_norm_residual(a, b, c, 1e-5),
                     jx, jr, jw)
    jdx, jdres, jdw = vjp((jgy, jgr))
    # dx and dres are one tensor on both sides
    np.testing.assert_array_equal(_np(tx.grad), _np(tr.grad))
    np.testing.assert_array_equal(_np(jdx), _np(jdres))
    if dtype == "float32":
        # the same f32 formula rounded once; row sums in another order
        np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=1e-5,
                                   atol=1e-5)
    else:
        # dh's terms may cancel, so limits scale with their magnitude
        # mag = inv*|gy*w| + |r|*c + |gr| (c from |gy*w*r|)
        rs = _np(r).astype(np.float64)
        gw = _np(tgy) * _np(tw)
        inv = 1 / np.sqrt((rs ** 2).mean(-1, keepdims=True) + 1e-5)
        c = inv ** 3 * np.abs(gw * rs).mean(-1, keepdims=True)
        mag = inv * np.abs(gw) + np.abs(rs) * c + np.abs(_np(tgr))
        # the port: f32 inside and one rounding, so against the exact
        # value (f64) half an ulp, plus f32 noise of the terms
        exact = inv * gw - rs * inv ** 3 * (gw * rs).mean(-1, keepdims=True) \
            + _np(tgr)
        _within(tx.grad, exact, 0.5 * BF16_ULP * np.abs(exact) + 1e-5 * mag
                + 1e-9)
        # the JAX kernel: XLA on the CPU compiles its f32 chain with bf16
        # roundings of the terms (jit of the same jnp formula gives its
        # numbers; the eager formula gives the port's), 2^-8 of each
        # term's magnitude, then rounds the result
        _within(tx.grad, jdx, BF16_ULP * np.abs(_np(jdx)) + 2 ** -7 * mag
                + 1e-6)
        # dw: f32 column sums over the same bf16 r on both sides, then
        # one rounding to bf16: one ulp, plus f32 noise of the terms
        tot = (np.abs(_np(tgy)) * np.abs(rs) * inv).sum(0)
        _within(tw.grad, jdw, BF16_ULP * np.abs(_np(jdw)) + 1e-5 * tot
                + 1e-6)


def test_rms_norm_residual_dh_reference_is_the_jax_kernel_formula():
    """K4's plain version from r alone (the port saves r, not x and res)
    against the JAX vjp from x and res, in f32."""
    x_np, r_np, w_np, gy_np, gr_np = _res_data(17, 40, 5)
    x, res, w = map(torch.from_numpy, (x_np, r_np, w_np))
    dh = trms.rms_norm_residual_dh_reference(
        x + res, w, torch.from_numpy(gy_np), torch.from_numpy(gr_np), 1e-6)
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm_residual(a, b, w_np, 1e-6),
                     jnp.asarray(x_np), jnp.asarray(r_np))
    jdh, _ = vjp((jnp.asarray(gy_np), jnp.asarray(gr_np)))
    # the same f32 formula; row sums in another order
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-5)


# ---- K10/K11: the fused CE's chunk kernels ---------------------------------

def _chunk_data(n, vc, lo, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, vc) * 3).astype(np.float32)
    # labels inside the chunk, in the overlap prefix (< lo), below 0 and
    # at or above vc (the label is in another chunk)
    local = rng.randint(lo, vc, n).astype(np.int32)
    local[0], local[1], local[2], local[3] = -5, vc, vc + 7, vc - 1
    if lo:
        local[4] = lo - 1
        local[5] = lo
    return logits, local


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,vc,lo", [(20, 64, 0), (20, 64, 24), (9, 40, 13)])
def test_chunk_stats_matches_jax_kernel(dtype, n, vc, lo):
    logits_np, local_np = _chunk_data(n, vc, lo, n + vc + lo)
    tl, jl = _pair(logits_np, dtype)
    m, s, t = tce.chunk_stats(tl, torch.from_numpy(local_np), lo)
    jm, js, jt = jce.chunk_stats(jl, jnp.asarray(local_np), lo)
    # the max and the gathered target are exact on both sides
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    # a sum of exps in f32 in another order
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    # labels outside the chunk gather nothing; the last column does
    assert (t[:3] == 0).all() and t[3] == tl[3, vc - 1].float()
    if lo:
        assert t[4] == 0 and t[5] == tl[5, lo].float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,vc,lo", [(20, 64, 0), (20, 64, 24), (9, 40, 13)])
def test_chunk_dlogits_matches_jax_kernel(dtype, n, vc, lo):
    logits_np, local_np = _chunk_data(n, vc, lo, 2 * n + vc + lo)
    rng = np.random.RandomState(lo)
    x = logits_np.astype(np.float64)
    lse_np = (np.log(np.exp(x).sum(-1)) + rng.rand(n)).astype(np.float32)
    scale_np = (rng.rand(n) / n).astype(np.float32)
    scale_np[7] = 0.0                                  # an ignored row
    tl, jl = _pair(logits_np, dtype)
    out = tce.chunk_dlogits(tl, torch.from_numpy(lse_np),
                            torch.from_numpy(local_np),
                            torch.from_numpy(scale_np), lo)
    ref = jce.chunk_dlogits(jl, jnp.asarray(lse_np), jnp.asarray(local_np),
                            jnp.asarray(scale_np), lo)
    assert out.dtype == tl.dtype
    assert (out[:, :lo] == 0).all() and (out[7] == 0).all()
    # the same f32 formula rounded once to the logits' dtype; the exps
    # may differ in their last f32 bits, which may flip a bf16 rounding
    tol = (BF16_ULP if dtype == "bfloat16" else 1e-6) * np.abs(_np(ref)) \
        + 1e-9
    _within(out, ref, tol)


# ---- the fused linear + cross entropy ---------------------------------------

def _ce_data(n=24, d=16, v=50, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.1).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int64)
    return h, w, labels


def _plain_ce(h, w, labels):
    """The unfused CE of h @ w: the JAX package's test oracle."""
    lp = jax.nn.log_softmax(h @ w, axis=-1)
    valid = labels != -100
    safe = jnp.where(valid, labels, 0)
    per = -jnp.take_along_axis(lp, safe[:, None], -1)[:, 0]
    return jnp.sum(jnp.where(valid, per, 0.0)) / jnp.maximum(jnp.sum(valid),
                                                             1)


def _port_ce(h, w, labels, cv):
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    with tfce.force_chunk_v(cv):
        loss = tfce.fused_linear_cross_entropy(th, tw,
                                               torch.from_numpy(labels))
        loss.backward()
    return loss.item(), th.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("inner", ["jnp", "pallas"])
@pytest.mark.parametrize("v,cv", [(50, 8), (48, 8), (50, 64)])
def test_fused_linear_ce_matches_jax_op(inner, v, cv):
    """(50, 8): the clamped tail chunk overlaps its predecessor; (48, 8)
    divides; (50, 64): one chunk wider than the vocab. A target in the
    tail's overlap region and one ignored row."""
    h, w, labels = _ce_data(v=v)
    labels[3], labels[0], labels[5] = -100, v - 1, v - 4
    loss, dh, dw = _port_ce(h, w, labels, cv)
    ctx = jfce.force_pallas_inner() if inner == "pallas" \
        else contextlib.nullcontext()
    jl = jnp.asarray(labels)
    with ctx, jfce.force_chunk_v(cv):
        jloss = float(jfce.fused_linear_cross_entropy(
            jnp.asarray(h), jnp.asarray(w), jl))
        jdh, jdw = jax.grad(
            lambda a, b: jfce.fused_linear_cross_entropy(a, b, jl),
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    # f32 throughout; the online log-sum-exp and the matmuls sum in
    # another order
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(dh, np.asarray(jdh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dw, np.asarray(jdw), rtol=1e-5, atol=1e-7)
    # and against the plain CE over full logits (the JAX tests' oracle)
    ref = float(_plain_ce(jnp.asarray(h), jnp.asarray(w), jl))
    g_ref = jax.grad(lambda a, b: _plain_ce(a, b, jl),
                     argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    np.testing.assert_allclose(dh, np.asarray(g_ref[0]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dw, np.asarray(g_ref[1]), rtol=1e-4,
                               atol=1e-6)


def test_fused_linear_ce_all_ignored_gives_zero_loss_and_zero_grads():
    h, w, _ = _ce_data()
    labels = np.full(h.shape[0], -100, np.int64)
    loss, dh, dw = _port_ce(h, w, labels, 8)
    assert loss == 0.0
    for g in (dh, dw):
        assert not np.isnan(g).any() and np.abs(g).max() == 0.0


def test_fused_linear_ce_bf16_matches_the_f32_op_within_rounding():
    """bf16 h and w: each chunk's logits are rounded to bf16 (as the JAX
    op's ``h @ wc`` is), dlogits to bf16, dh to bf16 per chunk before the
    f32 sum, dw rounded once: the loss and gradients stay within a few
    bf16 roundings of the f32 op on the same (bf16-representable)
    values."""
    h, w, labels = _ce_data(n=40, d=32, v=100, seed=2)
    hb = torch.from_numpy(h).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    l32, dh32, dw32 = _port_ce(hb.float().numpy(), wb.float().numpy(),
                               labels, 16)
    th, tw = hb.clone().requires_grad_(), wb.clone().requires_grad_()
    with tfce.force_chunk_v(16):
        loss = tfce.fused_linear_cross_entropy(th, tw,
                                               torch.from_numpy(labels))
        loss.backward()
    assert loss.dtype == torch.float32 and th.grad.dtype == torch.bfloat16
    # logits rounded to bf16 move each logit by 2^-8 of it (|logit| < 4)
    assert abs(loss.item() - l32) <= 2 ** -8 * 4
    for g, ref in ((th.grad, dh32), (tw.grad, dw32)):
        err = np.abs(g.float().numpy() - ref)
        assert err.max() <= 0.05 * np.abs(ref).max(), err.max()


def test_chunk_grid_and_chunk_width_precedence():
    assert tfce._chunk_grid(32000, 1024) == (1024, 32)
    starts = list(tfce._chunks(32000, 1024, 32))
    # the tail starts at V - vc; its overlap with the chunk before is lo
    assert starts[-1] == (32000 - 1024, 768) and starts[0] == (0, 0)
    assert list(tfce._chunks(128256, 1024, 126))[-1] == (128256 - 1024, 768)
    assert tfce._chunk_grid(50, 64) == (50, 1)
    name = "FLAGS_fused_ce_chunk_v"
    saved = dict(tflags._registry[name])
    try:
        assert tfce._resolve_chunk_v() == 1024
        tflags.set_flags({name: 256})
        assert tfce._resolve_chunk_v() == 256
        with tfce.force_chunk_v(64):
            assert tfce._resolve_chunk_v() == 64
        assert tfce._resolve_chunk_v() == 256
    finally:
        tflags._registry[name] = saved
