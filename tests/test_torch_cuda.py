"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the engine and a training step on the
card against the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere (the kernels
have no CPU mode). The file imports neither JAX nor the JAX package, so
it runs on a GPU host with PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models import (LlamaPretrainingCriterion,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops import moe
from paddle_tpu_torch.ops import paged_attention as PA
from paddle_tpu_torch.ops.kernels import ce_chunk as kce
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.ops.kernels import grouped_matmul as kgmm
from paddle_tpu_torch.ops.kernels import paged_attention as kpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
from paddle_tpu_torch.ops.kernels import rms_norm as krms
from paddle_tpu_torch.ops.kernels import swiglu as ksw
from paddle_tpu_torch.optimizer import SGD, AdamW

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import adam_first_step_limit, attention_scales  # noqa

pytestmark = pytest.mark.cuda

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _assert_close(out, ref, tol):
    """Element by element: ``tol`` holds each element's limit."""
    err = (out.float() - ref.float()).abs()
    assert (err <= tol).all(), (err / tol).max().item()


def _tol(ref, dtype, ulps):
    """Per element. f32: summation order and the last bits of exp;
    bf16: ``ulps`` ulps of each |ref|."""
    mag = ref.float().abs()
    return (1e-5 if dtype == torch.float32 else ulps * BF16_ULP) * mag + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 4096), (37, 4096), (5, 100)])
def test_rms_norm_kernel(cuda, dtype, n, d):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    before = krms.rms_norm.launches
    y = krms.rms_norm(x, w, 1e-5)
    ref = krms.rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    assert krms.rms_norm.launches == before + 1
    # bf16: the same rounding points; the statistics' summation order may
    # move x*inv by one ulp, which the product carries to three
    _assert_close(y, ref, _tol(ref, dtype, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 14336), (3, 7, 13)])
def test_swiglu_kernel(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    gate = (2 * torch.randn(*shape, device=cuda, generator=g)).to(dtype)
    up = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    out = ksw.swiglu(gate, up)
    ref = ksw.swiglu_reference(gate, up)
    torch.cuda.synchronize()
    # bf16: the kernel rounds once from f32, the plain version twice
    _assert_close(out, ref, _tol(ref, dtype, 2))
    # against silu(g)*u in f32 rounded once, as the kernel computes it
    once = (torch.nn.functional.silu(gate.float()) * up.float()).to(dtype)
    _assert_close(out, once, _tol(once, dtype, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(37, 4096), (5, 100)])
def test_rms_norm_dx_kernel(cuda, dtype, n, d):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(dtype)
    gy = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    before = krms.rms_norm_dx.launches
    dx = krms.rms_norm_dx(x, w, gy, 1e-5)
    ref = krms.rms_norm_dx_reference(x, w, gy, 1e-5)
    torch.cuda.synchronize()
    assert krms.rms_norm_dx.launches == before + 1
    # both f32 and rounded once; the two row sums and the difference
    # inv*g*w - x*c are taken in another order: scale the limit by the
    # magnitudes summed, |inv*g*w| + |x| * inv^3 * mean|g*w*x|
    xf, gw = x.float(), gy.float() * w.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    c = inv ** 3 * (gw * xf).abs().mean(-1, keepdim=True)
    mag = (inv * gw).abs() + xf.abs() * c
    ulp = 1e-5 if dtype == torch.float32 else BF16_ULP
    _assert_close(dx, ref, ulp * ref.float().abs() + 1e-5 * mag + 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(37, 4096), (5, 100)])
def test_rms_norm_residual_kernels(cuda, dtype, n, d):
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    x, res, gy, gr = (torch.randn(n, d, device=cuda, generator=g).to(dtype)
                      for _ in range(4))
    w = (1 + 0.1 * torch.randn(d, device=cuda, generator=g)).to(dtype)
    before = (krms.rms_norm_residual.launches,
              krms.rms_norm_residual_dh.launches)
    y, r = krms.rms_norm_residual(x, res, w, 1e-5)
    ry, rr = krms.rms_norm_residual_reference(x, res, w, 1e-5)
    dh = krms.rms_norm_residual_dh(r, w, gy, gr, 1e-5)
    ref = krms.rms_norm_residual_dh_reference(r, w, gy, gr, 1e-5)
    torch.cuda.synchronize()
    assert (krms.rms_norm_residual.launches,
            krms.rms_norm_residual_dh.launches) == (before[0] + 1,
                                                    before[1] + 1)
    # K3: the add rounds once in the input dtype on both sides: exact;
    # y as K1 (the statistics' order may move r*inv by an ulp, which the
    # product carries to three)
    assert torch.equal(r, rr)
    _assert_close(y, ry, _tol(ry, dtype, 3))
    # K4: both f32 and rounded once; the terms may cancel, so 1e-5 of
    # their magnitudes |inv*gy*w| + |r|*c + |gr| besides one ulp
    rf, gw = r.float(), gy.float() * w.float()
    inv = torch.rsqrt(rf.square().mean(-1, keepdim=True) + 1e-5)
    c = inv ** 3 * (gw * rf).abs().mean(-1, keepdim=True)
    mag = (inv * gw).abs() + rf.abs() * c + gr.float().abs()
    ulp = 1e-5 if dtype == torch.float32 else BF16_ULP
    _assert_close(dh, ref, ulp * ref.float().abs() + 1e-5 * mag + 1e-6)


def _chunk_inputs(cuda, dtype, n, vc, lo, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    logits = (3 * torch.randn(n, vc, device=cuda, generator=g)).to(dtype)
    local = torch.randint(lo, vc, (n,), device=cuda, generator=g,
                          dtype=torch.int32)
    # labels in another chunk (below 0, at or past vc), in the overlap
    # prefix (below lo) and at both ends of the chunk's own columns
    local[:6] = torch.tensor([-3, vc, vc + 5, max(lo - 1, 0), lo, vc - 1],
                             dtype=torch.int32)
    return logits, local


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,vc,lo", [(37, 1024, 0), (37, 1024, 768),
                                     (9, 40, 13)])
def test_chunk_stats_kernel(cuda, dtype, n, vc, lo):
    logits, local = _chunk_inputs(cuda, dtype, n, vc, lo)
    before = kce.chunk_stats.launches
    m, s, t = kce.chunk_stats(logits, local, lo)
    rm, rs, rt = kce.chunk_stats_reference(logits, local, lo)
    torch.cuda.synchronize()
    assert kce.chunk_stats.launches == before + 1
    # the max and the gathered target are exact
    assert torch.equal(m, rm) and torch.equal(t, rt)
    # an online f32 sum of exps (a lane's sum rescaled when its max
    # grows) against the plain one; leaving out or adding one column
    # moves s by some 1/vc of itself, 50 times this limit
    _assert_close(s, rs, 2e-5 * rs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,vc,lo", [(37, 1024, 0), (37, 1024, 768),
                                     (9, 40, 13)])
def test_chunk_dlogits_kernel(cuda, dtype, n, vc, lo):
    logits, local = _chunk_inputs(cuda, dtype, n, vc, lo, seed=1)
    lse = torch.logsumexp(logits.float(), -1) + 0.5
    scale = torch.rand(n, device=cuda) / n
    scale[7] = 0.0                                      # an ignored row
    before = kce.chunk_dlogits.launches
    out = kce.chunk_dlogits(logits, lse, local, scale, lo)
    ref = kce.chunk_dlogits_reference(logits, lse, local, scale, lo)
    torch.cuda.synchronize()
    assert kce.chunk_dlogits.launches == before + 1
    assert out.dtype == dtype and not out[:, :lo].any() and not out[7].any()
    # the same f32 formula rounded once; the exps differ in their last
    # f32 bits (1e-6 of p, times the row's scale), which may flip a bf16
    # rounding
    ulp = 1e-6 if dtype == torch.float32 else BF16_ULP
    _assert_close(out, ref, ulp * ref.float().abs() + 1e-6 * scale[:, None])


def test_fused_linear_ce_on_the_card_matches_the_cpu(cuda):
    rng = np.random.RandomState(2)
    h = rng.randn(37, 64).astype(np.float32)
    w = (0.1 * rng.randn(64, 3000)).astype(np.float32)
    labels = rng.randint(0, 3000, 37)
    labels[[0, 1, 2]] = [-100, 2999, 2000]    # ignored; in the tail chunk
    out = []
    for dev in ("cpu", cuda):
        th = torch.from_numpy(h).to(dev).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        launches = kce.chunk_stats.launches
        loss = fused_ce.fused_linear_cross_entropy(
            th, tw, torch.from_numpy(labels).to(dev))
        loss.backward()
        out.append((loss.item(), th.grad.cpu().numpy(),
                    tw.grad.cpu().numpy(),
                    kce.chunk_stats.launches - launches))
    (l0, dh0, dw0, n0), (l1, dh1, dw1, n1) = out
    assert (n0, n1) == (0, 3)                 # 3 chunks of 1024 columns
    # f32: cuBLAS, the kernels and the CPU sum in another order
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    np.testing.assert_allclose(dh1, dh0, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(dw1, dw0, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 14336), (3, 7, 13)])
def test_swiglu_bwd_kernel(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    gate = (2 * torch.randn(*shape, device=cuda, generator=g)).to(dtype)
    up = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    go = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    dg, du = ksw.swiglu_bwd(gate, up, go)
    rg, ru = ksw.swiglu_bwd_reference(gate, up, go)
    torch.cuda.synchronize()
    # the same f32 formula rounded once on both sides; exp differs in
    # the last f32 bits: one ulp in bf16
    _assert_close(dg, rg, _tol(rg, dtype, 1))
    _assert_close(du, ru, _tol(ru, dtype, 1))


def _attention_inputs(cuda, dtype, B, Sq, Sk, H, KVH, D, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, H, D, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, Sk, KVH, D, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, Sk, KVH, D, device=cuda, generator=g).to(dtype)
    go = torch.randn(B, Sq, H, D, device=cuda, generator=g).to(dtype)
    return q, k, v, go


ATTENTION_CASES = [  # B, Sq, Sk, H, KVH, D, causal
    (2, 128, 128, 4, 4, 128, True), (1, 100, 100, 8, 2, 64, True),
    (2, 77, 77, 4, 1, 16, True), (1, 65, 130, 4, 2, 32, True),
    (1, 130, 65, 2, 2, 64, True), (2, 96, 80, 4, 2, 128, False),
    # the edges of the wgmma backward's tiles (128 keys or queries a CTA,
    # 64 a warpgroup and a stage): rep 7, S straddling 64 and 128, D 64,
    # Sq < Sk and Sq > Sk (rows that see no key), non-causal D 64
    (1, 300, 300, 28, 4, 128, True), (2, 129, 129, 8, 2, 128, True),
    (1, 200, 200, 4, 4, 64, True), (1, 100, 260, 8, 2, 128, True),
    (1, 260, 100, 4, 2, 128, True), (2, 190, 70, 4, 1, 64, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_flash_attention_kernels(cuda, dtype, case):
    B, Sq, Sk, H, KVH, D, causal = case
    q, k, v, go = _attention_inputs(cuda, dtype, B, Sq, Sk, H, KVH, D)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = kfa.flash_attention_fwd_reference(q, k, v, causal)
    f32 = [t.float() for t in (q, k, v)]
    a = kfa.flash_attention_fwd_reference(f32[0], f32[1], f32[2].abs(),
                                          causal)[0]
    if dtype == torch.float32:
        # summation order and exp only
        _assert_close(out, ref, 1e-5 * a + 1e-6)
    else:
        # both sides round each probability to bf16 (2^-8 * a each, the
        # unit roundoff) and their outputs (half an ulp each)
        _assert_close(out, ref, 1.01 * (2 ** -7 * a + BF16_ULP
                                        * ref.float().abs()) + 1e-6)
    _assert_close(lse, ref_lse, 1e-6 * ref_lse.abs() + 1e-5)
    if causal and Sq > Sk:     # rows that see no key: 0
        assert not out[:, :Sq - Sk].any()
    # backward from the same saved lse and delta
    delta = kfa._delta(ref, go)
    dk, dv = kfa.flash_attention_dkv(q, k, v, go, ref_lse, delta, causal)
    dq = kfa.flash_attention_dq(q, k, v, go, ref_lse, delta, causal)
    rq, rk, rv = kfa.flash_attention_bwd_reference(q, k, v, ref, ref_lse,
                                                   go, causal)
    torch.cuda.synchronize()
    scales = attention_scales(q, k, v, go, ref_lse, delta, causal)
    for name, got, want, sc in zip("qkv", (dq, dk, dv), (rq, rk, rv),
                                   scales):
        if dtype == torch.float32:
            tol = 1e-5 * sc + 1e-6
        else:
            # the kernel rounds p and ds to bf16 before their products
            # (2^-8 of the scale), each side rounds its output
            tol = (2 ** -8 + 1e-5) * sc + BF16_ULP * want.float().abs() \
                + 1e-6
        _assert_close(got, want, tol)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_is_deterministic(cuda, d):
    """dk/dv and dq are written once by one CTA each, with no atomics:
    two launches on the same inputs give the same bits."""
    q, k, v, go = _attention_inputs(cuda, torch.bfloat16, 2, 300, 300, 8,
                                    2, d, seed=7)
    lse = kfa.flash_attention_fwd(q, k, v, True)[1]
    delta = kfa._delta(kfa.flash_attention_fwd(q, k, v, True)[0], go)
    runs = [(*kfa.flash_attention_dkv(q, k, v, go, lse, delta, True),
             kfa.flash_attention_dq(q, k, v, go, lse, delta, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_attention_fully_masked_rows_have_zero_grads(cuda):
    q, k, v, go = _attention_inputs(cuda, torch.float32, 1, 256, 128, 2,
                                    2, 32, seed=5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = kfa.flash_attention(q, k, v, causal=True)
    out[:, :128].sum().backward()     # reads only rows that see no key
    torch.cuda.synchronize()
    assert not out[:, :128].any()
    for t in (q, k, v):
        assert not t.grad.any()


def test_tiny_training_step_on_the_card_matches_the_cpu(cuda):
    cfg = LlamaConfig.tiny()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 77)))
    lr, results = 1e-3, []
    weights = LlamaForCausalLM(cfg, device="cpu", seed=4).state_dict()
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        opt = AdamW(learning_rate=lr, parameters=model.parameters())
        _, loss = model(ids.to(dev), labels=ids.to(dev))
        loss.backward()
        grads = convert.grads_to_numpy(model)
        opt.step()
        results.append((loss.item(), grads,
                        convert.to_numpy_state_dict(model)))
    (l0, g0, w0), (l1, g1, w1) = results
    # f32 on both sides; kernels and cuBLAS sum in another order
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for key in g0:
        err = np.linalg.norm(g1[key] - g0[key]) / np.linalg.norm(g0[key])
        assert err <= 1e-4, (key, err)
        # the step's sensitivity to the gradients' difference
        lim = adam_first_step_limit(g0[key], g1[key], w0[key], lr)
        assert (np.abs(w1[key] - w0[key]) <= lim).all(), key


@pytest.mark.parametrize("gran", ["full", "core_attn"])
def test_fused_recompute_step_on_the_card_matches_the_cpu(cuda, gran):
    """The fused residual carry (the default) with recompute: loss and
    every gradient, card against CPU."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), use_recompute=True,
                              recompute_granularity=gran)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 77)))
    weights = LlamaForCausalLM(cfg, device="cpu", seed=6).state_dict()
    results = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        _, loss = model(ids.to(dev), labels=ids.to(dev))
        loss.backward()
        results.append((loss.item(), convert.grads_to_numpy(model)))
    (l0, g0), (l1, g1) = results
    # f32 on both sides; kernels and cuBLAS sum in another order
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for key in g0:
        err = np.linalg.norm(g1[key] - g0[key]) / np.linalg.norm(g0[key])
        assert err <= 1e-4, (key, err)


def test_compiled_fit_on_the_card_matches_the_cpu(cuda):
    """hapi fit(compiled=True): the fused linear+CE (K10/K11) and SGD."""
    cfg = LlamaConfig.tiny()
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (8, 65)))
    weights = LlamaForCausalLM(cfg, device="cpu", seed=8).state_dict()
    results = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        m = Model(model)
        m.prepare(SGD(1e-2, parameters=model.parameters()),
                  LlamaPretrainingCriterion(cfg))
        t = ids.to(dev)
        launches = kce.chunk_dlogits.launches
        m.fit(TensorDataset([t, t]), batch_size=4, epochs=1, shuffle=False,
              verbose=0)
        results.append((m._last_epoch_summary["mean_loss"],
                        convert.to_numpy_state_dict(model),
                        kce.chunk_dlogits.launches - launches))
    (l0, w0, n0), (l1, w1, n1) = results
    assert (n0, n1) == (0, 2)                 # one chunk a step, 2 steps
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    for key in w0:
        # lr 1e-2 times gradients within 1e-4 of each other
        np.testing.assert_allclose(w1[key], w0[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def _ragged(cuda, dtype, H, KVH, D, page, C=24, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, 5, C, 1, 17][:6], np.int32)
    lengths = np.minimum(lengths, C)
    ctx = np.array([3, 40, 0, 7, 0, 61], np.int32)
    B = len(lengths)
    pages = -(-int((ctx + lengths).max()) // page) + 1
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1)[:B * pages].reshape(
        B, pages).astype(np.int32)
    for b in range(B):
        tables[b, -(-(int(ctx[b]) + int(lengths[b])) // page):] = 0
    g = torch.Generator(device=cuda).manual_seed(seed)
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn(B, C, H, D, device=cuda, generator=g).to(dtype)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx, lengths)]
    return (q, kp, vp, *ints), lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,page", [(32, 8, 128, 16), (8, 8, 64, 8),
                                          (16, 2, 32, 16), (4, 1, 256, 4),
                                          (28, 4, 128, 16), (6, 2, 64, 16)])
def test_ragged_paged_attention_kernel(cuda, dtype, H, KVH, D, page):
    args, lengths = _ragged(cuda, dtype, H, KVH, D, page)
    out = krpa.ragged_paged_attention(*args)
    ref = krpa.ragged_paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()       # NaN trash page never read
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()        # rows past the length: zero
    # per element; a = sum_i p_i |v_i| scales an output's rounding error
    q, kp, vp, *ints = args
    f32 = [t.float() for t in (q, kp, vp)]
    a = krpa.ragged_paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                              *ints).float()
    ref32 = krpa.ragged_paged_attention_reference(*f32, *ints)
    if dtype == torch.float32:
        # summation order and exp only
        _assert_close(out, ref, 1e-5 * a + 1e-6)
    else:
        # the plain version rounds each probability to bf16 before P.V
        # (2^-8 * a at most), and each side rounds its output
        _assert_close(out, ref, 1.01 * (2 ** -8 * a + BF16_ULP
                                        * ref.float().abs()) + 1e-6)
        # the kernel keeps f32 up to its output's rounding: one ulp
        _assert_close(out, ref32, BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("H,KVH,D,page", [(32, 8, 128, 16), (28, 4, 128, 16),
                                          (16, 2, 32, 16), (8, 8, 64, 8)])
def test_ragged_paged_attention_quant_kernel(cuda, dtype, pool, H, KVH, D,
                                             page):
    """K13 against the plain version over the same codes and scales; the
    trash page holds non-finite scales (and fp8 NaN codes)."""
    args, lengths = _ragged(cuda, torch.float32, H, KVH, D, page)
    q, kp, vp, *ints = args
    kp[:, 0] = vp[:, 0] = 0.0
    kc, ks = PA.quantize_kv(kp, pool)
    vc, vs = PA.quantize_kv(vp, pool)
    ks[:, 0] = vs[:, 0] = float("nan")
    if pool == torch.float8_e4m3fn:
        kc.view(torch.uint8)[:, 0] = vc.view(torch.uint8)[:, 0] = 0x7F
    q = q.to(dtype)
    before = krpa.ragged_paged_attention_quant.launches
    out = krpa.ragged_paged_attention(q, kc, vc, *ints, k_scales=ks,
                                      v_scales=vs)
    torch.cuda.synchronize()
    assert krpa.ragged_paged_attention_quant.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()
    ref = krpa.ragged_paged_attention_reference(q, kc, vc, *ints,
                                                k_scales=ks, v_scales=vs)
    # both dequantize to the same f32 values and keep f32 probabilities:
    # summation order and exp (1e-5 of a = sum p|v|), and for bf16 q one
    # rounding of each output (one ulp of |ref|)
    a = krpa.ragged_paged_attention_reference(
        q.float(), PA.dequantize_pages(kc, ks),
        PA.dequantize_pages(vc, vs).abs(), *ints).float()
    ulps = 0 if dtype == torch.float32 else BF16_ULP
    _assert_close(out, ref, 1e-5 * a + ulps * ref.float().abs() + 1e-6)


def _decode(cuda, dtype, H, KVH, D, page, seed=0):
    rng = np.random.RandomState(seed)
    ctx = np.array([0, 1, 15, 16, 17, 100, 257, 40], np.int32)
    B = len(ctx)
    pages = -(-int(ctx.max()) // page) + 1
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1)[:B * pages].reshape(
        B, pages).astype(np.int32)
    for b in range(B):
        tables[b, -(-int(ctx[b]) // page):] = 0
    g = torch.Generator(device=cuda).manual_seed(seed)
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn(B, H, D, device=cuda, generator=g).to(dtype)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx)]
    return (q, kp, vp, *ints), ctx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,page", [(32, 8, 128, 16), (28, 4, 128, 16),
                                          (8, 8, 64, 8), (16, 2, 64, 4),
                                          (12, 4, 128, 32)])
def test_paged_attention_kernel(cuda, dtype, H, KVH, D, page):
    """K16 against its plain version; the trash page holds NaN, and a
    sequence with an empty cache gets zeros."""
    args, ctx = _decode(cuda, dtype, H, KVH, D, page)
    out = kpa.paged_attention(*args)
    ref = kpa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert not out[torch.from_numpy(ctx == 0).to(cuda)].any()
    q, kp, vp, *ints = args
    f32 = [t.float() for t in (q, kp, vp)]
    a = kpa.paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                      *ints).float()
    ref32 = kpa.paged_attention_reference(*f32, *ints)
    if dtype == torch.float32:
        _assert_close(out, ref, 1e-5 * a + 1e-6)
    else:
        # the plain version rounds each probability to bf16 before P.V
        _assert_close(out, ref, 1.01 * (2 ** -8 * a + BF16_ULP
                                        * ref.float().abs()) + 1e-6)
        _assert_close(out, ref32, BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)


def test_paged_attention_equals_ragged_at_one_token(cuda):
    """K16 computes K12's function at lengths == 1 (ctx - 1 cached)."""
    args, ctx = _decode(cuda, torch.float32, 32, 8, 128, 16)
    q, kp, vp, tables, ctx_t = args
    live = ctx > 0
    out = kpa.paged_attention(*args)
    rag = krpa.ragged_paged_attention(
        q[:, None].contiguous(), kp, vp, tables, (ctx_t - 1).clamp(min=0),
        torch.from_numpy(live.astype(np.int32)).to(cuda))[:, 0]
    a = kpa.paged_attention_reference(q, kp, vp.abs(), tables, ctx_t)
    _assert_close(out, rag, 2e-5 * a + 1e-6)


def test_quantized_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu_model = LlamaForCausalLM(cfg, device=cuda, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(1)
    specs = [(rng.randint(0, cfg.vocab_size, p), n)
             for p, n in [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]]
    for mode in ("int8", "fp8"):
        streams = []
        for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
            eng = ContinuousBatchingEngine(model, num_slots=2, page_size=8,
                                           max_len=64, decode_chunk=4,
                                           prefill_chunk=16, kv_quant=mode,
                                           device=dev)
            for prompt, n in specs:
                eng.add_request(prompt, n)
            streams.append([r.tokens for r in sorted(
                eng.run(), key=lambda r: r.request_id)])
        assert streams[0] == streams[1], mode


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        krms.rms_norm(x.t(), torch.ones(8, device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ksw.swiglu(x.half(), x.half())
    args, _ = _ragged(cuda, torch.float32, 65, 1, 32, 16)  # rep 65 > 64
    with pytest.raises(ValueError, match="at most"):
        krpa.ragged_paged_attention(*args)
    q, kp, vp, *ints = _ragged(cuda, torch.float32, 8, 2, 64, 16)[0]
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        krpa.ragged_paged_attention(q, kp, vp, *ints, k_scales=kp[..., 0],
                                    v_scales=vp[..., 0])
    kc = kp.to(torch.int8)
    with pytest.raises(TypeError, match="scales must be f32"):
        krpa.ragged_paged_attention(q, kc, kc, *ints,
                                    k_scales=kp[..., 0].half(),
                                    v_scales=kp[..., 0].half())
    args, _ = _decode(cuda, torch.float32, 36, 4, 128, 16)  # rep 9 > 8
    with pytest.raises(ValueError, match="at most"):
        kpa.paged_attention(*args)
    args, _ = _decode(cuda, torch.float32, 8, 2, 32, 16)    # D 32
    with pytest.raises(ValueError, match="D in"):
        kpa.paged_attention(*args)
    q, k, v, _ = _attention_inputs(cuda, torch.float32, 1, 8, 8, 2, 2, 48)
    with pytest.raises(ValueError, match="D in"):
        kfa.flash_attention_fwd(q, k, v, True)
    q, k, v, _ = _attention_inputs(cuda, torch.float32, 1, 8, 8, 2, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention_fwd(q.transpose(1, 2), k, v, True)


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu_model = LlamaForCausalLM(cfg, device=cuda, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(1)
    specs = [(rng.randint(0, cfg.vocab_size, p), n)
             for p, n in [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]]
    streams = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        eng = ContinuousBatchingEngine(model, num_slots=2, page_size=8,
                                       max_len=64, decode_chunk=4,
                                       prefill_chunk=16, device=dev)
        for prompt, n in specs:
            eng.add_request(prompt, n)
        streams.append([r.tokens for r in sorted(
            eng.run(), key=lambda r: r.request_id)])
        assert len(eng._free_pages) == eng.num_pages - 1
    assert streams[0] == streams[1]


# ---- the grouped matmul (K14, K14 transposed, K15) ---------------------------

def _grouped_inputs(dev, dtype, E, d, h, bm, T=300, k=2, seed=0):
    """A skewed routing of T tokens where expert 1 gets no rows, laid out
    by sort_rows_by_expert; x random on every row but the empty expert's
    tile (so the trailing tiles, which belong to expert E - 1, carry
    data), w and dy random."""
    rng = np.random.RandomState(seed)
    experts = [e for e in range(E) if e != 1]
    p = np.linspace(3.0, 1.0, len(experts))
    gate_idx = torch.from_numpy(rng.choice(
        experts, (T, k), p=p / p.sum()).astype(np.int32)).to(dev)
    _, gid, P = moe.sort_rows_by_expert(gate_idx, E, bm=bm)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(P, d, device=dev, generator=g)
    x[(gid == 1).repeat_interleave(bm)] = 0
    w = 0.1 * torch.randn(E, d, h, device=dev, generator=g)
    dy = torch.randn(P, h, device=dev, generator=g)
    return x.to(dtype), w.to(dtype), dy.to(dtype), gid


def _grouped_tol(ref, mag, dtype):
    """Per element: both sides take f32 products and round once; the
    sums come in another order (1e-5 of the sum of |terms|), which in
    bf16 may flip the output's rounding (one ulp of |ref|)."""
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    return ulp * ref.float().abs() + 1e-5 * mag + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,d,h,bm", [(6, 96, 200, 128),
                                      (16, 1024, 1408, 128),
                                      (4, 64, 32, 256)])
def test_grouped_matmul_kernels(cuda, dtype, E, d, h, bm):
    x, w, dy, gid = _grouped_inputs(cuda, dtype, E, d, h, bm)
    wrappers = (kgmm.grouped_matmul, kgmm.grouped_matmul_t, kgmm.grouped_dw)
    before = [f.launches for f in wrappers]
    y = kgmm.grouped_matmul(x, w, gid)
    dx = kgmm.grouped_matmul_t(dy, w, gid)
    dw = kgmm.grouped_dw(x, dy, gid, E)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [b + 1 for b in before]
    ax, aw, ady = x.float().abs(), w.float().abs(), dy.float().abs()
    for name, out, ref, mag in (
            ("y", y, kgmm.grouped_matmul_reference(x, w, gid),
             kgmm.grouped_matmul_reference(ax, aw, gid)),
            ("dx", dx, kgmm.grouped_matmul_reference(dy, w, gid, True),
             kgmm.grouped_matmul_reference(ady, aw, gid, True)),
            ("dw", dw, kgmm.grouped_dw_reference(x, dy, gid, E),
             kgmm.grouped_dw_reference(ax, ady, gid, E))):
        assert out.dtype == dtype and out.shape == ref.shape, name
        _assert_close(out, ref, _grouped_tol(ref, mag, dtype))
    # the empty expert's block is written, and zero
    assert not dw[1].any()
    # the trailing tiles belong to expert E - 1 and count in its dw
    assert int(gid[-1]) == E - 1 and x[-bm:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_function_grads_on_the_card(cuda, dtype):
    E, d, h, bm = 6, 96, 200, 128
    x, w, dy, gid = _grouped_inputs(cuda, dtype, E, d, h, bm, seed=3)
    grads = []
    for dev in ("cpu", cuda):
        xg = x.detach().to(dev).requires_grad_()
        wg = w.detach().to(dev).requires_grad_()
        y = kgmm.GroupedMatmulFunction.apply(xg, wg, gid.to(dev))
        (y.float() * dy.to(dev).float()).sum().backward()
        grads.append((xg.grad.cpu(), wg.grad.cpu()))
    (gx0, gw0), (gx1, gw1) = grads
    assert gw1.dtype == w.dtype
    ax, aw, ady = (t.float().abs().cpu() for t in (x, w, dy))
    g = gid.cpu()
    _assert_close(gx1, gx0, _grouped_tol(
        gx0, kgmm.grouped_matmul_reference(ady, aw, g, True), dtype))
    _assert_close(gw1, gw0, _grouped_tol(
        gw0, kgmm.grouped_dw_reference(ax, ady, g, E), dtype))


def test_grouped_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(256, 64, device=cuda)
    w = torch.randn(2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        kgmm.grouped_matmul(x, w, torch.zeros(4, dtype=torch.int32,
                                              device=cuda))
    with pytest.raises(ValueError, match="int32"):
        kgmm.grouped_matmul(x, w, torch.zeros(2, dtype=torch.int64,
                                              device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        kgmm.grouped_matmul(x[:, :60].contiguous(), w[:, :60].contiguous(),
                            torch.zeros(2, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("recompute", [False, True])
def test_tiny_qwen2_moe_step_on_the_card_matches_the_cpu(cuda, recompute):
    """Dropless Qwen2-MoE tiny, f32: a labelled forward and backward on
    the card (K1-K9, K14, K15) against the CPU (plain versions)."""
    cfg = dataclasses.replace(
        Qwen2MoeConfig.tiny(), moe_dropless=True, use_recompute=recompute,
        router_aux_loss_coef=0.0 if recompute else 0.001)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 77)))
    weights = Qwen2MoeForCausalLM(cfg, device="cpu", seed=5).state_dict()
    results = []
    for dev in ("cpu", cuda):
        model = Qwen2MoeForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        _, loss = model(ids.to(dev), labels=ids.to(dev))
        loss.backward()
        results.append((loss.item(), convert.grads_to_numpy(model)))
    (l0, g0), (l1, g1) = results
    # f32 on both sides; kernels and cuBLAS sum in another order
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for key in g0:
        err = np.linalg.norm(g1[key] - g0[key]) / np.linalg.norm(g0[key])
        assert err <= 1e-4, (key, err)


def test_moe_block_runs_without_host_synchronisation(cuda):
    """The dropless MoE block (routing, gathers, the grouped matmuls and
    their backward) copies nothing to the host: under sync debug mode
    'error' any synchronising call raises."""
    cfg = dataclasses.replace(Qwen2MoeConfig.tiny(), moe_dropless=True)
    model = Qwen2MoeForCausalLM(cfg, device=cuda, seed=1)
    x = torch.randn(2, 77, cfg.hidden_size, device=cuda, requires_grad=True)
    model.layers[0].mlp(x).sum().backward()     # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.layers[0].mlp(x).square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()
