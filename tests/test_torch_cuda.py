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
from paddle_tpu_torch.nn.quant import WeightOnlyLinear
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
from paddle_tpu_torch.testing import OracleDraftSource

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
    local = torch.randint(min(lo, vc - 1), vc, (n,), device=cuda,
                          generator=g, dtype=torch.int32)
    # labels in another chunk (below 0, at or past vc), in the overlap
    # prefix (below lo) and at both ends of the chunk's own columns
    local[:6] = torch.tensor([-3, vc, vc + 5, max(lo - 1, 0), lo, vc - 1],
                             dtype=torch.int32)
    return logits, local


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,vc,lo", [(37, 1024, 0), (37, 1024, 768),
                                     (9, 40, 13), (33, 4096, 0),
                                     (17, 32000, 1000), (9, 1024, 1024),
                                     (9, 37, 3)])
def test_chunk_stats_kernel(cuda, dtype, n, vc, lo):
    """K10 against its plain version: a row of one slab (vc 1024 bf16),
    rows of several (f32, vc 4096, a 32000-column chunk), a row with no
    column left (lo = vc: m = -inf, s = 0), and a row that is not 16-byte
    vectors (vc 37); a second launch repeats the bits."""
    logits, local = _chunk_inputs(cuda, dtype, n, vc, lo)
    before = kce.chunk_stats.launches
    m, s, t = kce.chunk_stats(logits, local, lo)
    rm, rs, rt = kce.chunk_stats_reference(logits, local, lo)
    torch.cuda.synchronize()
    assert kce.chunk_stats.launches == before + 1
    # the max and the gathered target are exact
    assert torch.equal(m, rm) and torch.equal(t, rt)
    # an f32 sum of exps in another order, with ex2.approx, against the
    # plain one; leaving out or adding one column moves s by some 1/vc of
    # itself, 50 times this limit at vc 1024
    _assert_close(s, rs, 2e-5 * rs)
    again = kce.chunk_stats(logits, local, lo)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((m, s, t), again))


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
    # the edges of the wgmma forward's tiles (128 queries a CTA, 64 a
    # warpgroup, 128-key stages): S around 128 and 256 at D 128, rep 7,
    # D 64 non-causal, Sq < Sk and Sq > Sk (rows that see no key)
    (1, 127, 127, 4, 2, 128, True), (1, 255, 255, 4, 2, 128, True),
    (1, 257, 257, 28, 4, 128, True), (1, 200, 200, 4, 2, 64, False),
    (1, 127, 300, 4, 2, 128, True), (1, 300, 127, 4, 2, 128, True),
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


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_is_deterministic(cuda, d):
    """out and lse are written once by one CTA each: two launches on the
    same inputs give the same bits."""
    q, k, v, _ = _attention_inputs(cuda, torch.bfloat16, 2, 300, 300, 8, 2,
                                   d, seed=8)
    runs = [kfa.flash_attention_fwd(q, k, v, True) for _ in range(2)]
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
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
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


def _recompute_step_card_and_cpu(cuda, cfg, seed):
    """Loss and every gradient of one labelled step, card against CPU
    (f32 on both sides; kernels and cuBLAS sum in another order), and the
    card run's launches of K1 and K3."""
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 77)))
    weights = LlamaForCausalLM(cfg, device="cpu", seed=seed).state_dict()
    results = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        before = (krms.rms_norm.launches, krms.rms_norm_residual.launches)
        _, loss = model(ids.to(dev), labels=ids.to(dev))
        loss.backward()
        launches = (krms.rms_norm.launches - before[0],
                    krms.rms_norm_residual.launches - before[1])
        results.append((loss.item(), convert.grads_to_numpy(model)))
    (l0, g0), (l1, g1) = results
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for key in g0:
        err = np.linalg.norm(g1[key] - g0[key]) / np.linalg.norm(g0[key])
        assert err <= 1e-4, (key, err)
    return launches


@pytest.mark.parametrize("gran", ["full", "core_attn"])
def test_fused_recompute_step_on_the_card_matches_the_cpu(cuda, gran):
    """The unrolled stack's fused residual carry (K3/K4) with selective
    recompute: loss and every gradient, card against CPU."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False,
                              use_recompute=True,
                              recompute_granularity=gran)
    _, k3 = _recompute_step_card_and_cpu(cuda, cfg, seed=6)
    assert k3 > 0


def test_scanned_recompute_step_on_the_card_matches_the_cpu(cuda):
    """The scanned stack (the single-tensor carry, K1/K2) with whole
    layers recomputed in full_save_interval groups: loss and every
    gradient, card against CPU; no fused carry launched."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=4,
                              use_recompute=True, full_save_interval=2)
    k1, k3 = _recompute_step_card_and_cpu(cuda, cfg, seed=6)
    assert k1 > 0 and k3 == 0


def test_compiled_fit_on_the_card_matches_the_cpu(cuda):
    """hapi fit(compiled=True): the fused linear+CE (K10/K11) and SGD."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
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



def test_preempted_fit_with_workers_resumes_bit_for_bit(cuda, tmp_path):
    """A tiny Llama in bf16 with AdamW, fit on the card over a general
    Dataset shuffled through two loader workers: preempted after step 1
    of epoch 1 (the emergency checkpoint), resumed by a Model built from
    other weights, its final weights equal the uninterrupted fit's bit
    for bit."""
    from paddle_tpu_torch.distributed.fleet.elastic import (
        Preempted, PreemptionGuard)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_io_data import ArrayDataset
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    ids = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (16, 65)).astype(np.int64)
    data = ArrayDataset(ids, ids)
    kw = dict(batch_size=4, epochs=2, shuffle=True, num_workers=2,
              verbose=0)

    def make(seed):
        net = LlamaForCausalLM(cfg, device=cuda, dtype=torch.bfloat16,
                               seed=seed)
        m = Model(net)
        m.prepare(AdamW(1e-3, parameters=net.parameters()),
                  LlamaPretrainingCriterion(cfg))
        return net, m

    net, m = make(2)
    m.fit(data, **kw)
    want = {k: v.clone() for k, v in net.state_dict().items()}
    net, m = make(2)
    guard = PreemptionGuard()
    real_step = m._optimizer.step

    def step():
        real_step()
        if m._optimizer._step_count == 6:     # step 1 of epoch 1
            guard.request()

    m._optimizer.step = step
    with pytest.raises(Preempted) as ei:
        m.fit(data, save_dir=str(tmp_path), preemptible=guard, **kw)
    assert (ei.value.epoch, ei.value.step) == (1, 1)
    net, m = make(3)
    m.fit(data, save_dir=str(tmp_path), resume=True, **kw)
    assert [s["steps"] for s in m._epoch_summaries] == [2]
    assert m._optimizer._step_count == 8
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k

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


def _split_batch(cuda, H, KVH, D, page, C=1, seed=0, keys=2100):
    """bf16 K12 inputs where the key split engages: 8 slots of one token
    (C 1), or a prefill chunk beside decode slots (C > 1, 3 slots), with
    contexts up to about ``keys`` keys that end on and beside the plan's
    split edges, tile (64-key) and page edges; NaN trash page 0. Returns
    the arguments, lengths and the plan."""
    rep = H // KVH
    pages = -(-keys // page)
    max_keys = pages * page
    if C == 1:
        B = 8
        n, L = krpa.split_plan(B, C, KVH, rep, D, max_keys)
        ctx = [L - 1, L, L - 2, 2 * L + 63, max_keys - 1, 64, 63, 0]
        lengths = [1, 1, 1, 1, 1, 1, 1, 0]
    else:
        B = 3
        n, L = krpa.split_plan(B, C, KVH, rep, D, max_keys)
        ctx = [max_keys - C, L - 3, 0]
        lengths = [C, 1, 0]
    assert n > 1, "the split must engage"
    ctx, lengths = (np.array(a, np.int32) for a in (ctx, lengths))
    rng = np.random.RandomState(seed)
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1).reshape(B, pages).astype(np.int32)
    for b in range(B):
        tables[b, -(-int(ctx[b] + lengths[b]) // page):] = 0
    g = torch.Generator(device=cuda).manual_seed(seed)
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn(B, C, H, D, device=cuda, generator=g)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx, lengths)]
    return (q, kp, vp, *ints), lengths, (n, L)


SPLIT_CASES = [(32, 8, 128, 16, 1), (28, 4, 128, 8, 1), (8, 2, 64, 4, 1),
               (14, 2, 64, 16, 1), (32, 8, 128, 16, 20), (28, 4, 128, 4, 9),
               (8, 2, 64, 8, 33)]


@pytest.mark.parametrize("H,KVH,D,page,C", SPLIT_CASES)
def test_ragged_split_kernel(cuda, H, KVH, D, page, C):
    """bf16 K12 with its keys split over CTAs (rep 4 and 7, pages of 4, 8
    and 16, D 64 and 128): the limits of the unsplit kernel, the NaN
    trash page never read, rows past the length zero."""
    args, lengths, _ = _split_batch(cuda, H, KVH, D, page, C)
    _check_split(args, lengths)


def _check_split(args, lengths):
    """bf16 K12 on f32 inputs cast to bf16, held to the unsplit kernel's
    limits; returns its arguments and output."""
    q, kp, vp, *ints = args
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    out = krpa.ragged_paged_attention(q, kp, vp, *ints)
    ref = krpa.ragged_paged_attention_reference(q, kp, vp, *ints)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()
    f32 = [t.float() for t in (q, kp, vp)]
    a = krpa.ragged_paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                              *ints).float()
    ref32 = krpa.ragged_paged_attention_reference(*f32, *ints)
    _assert_close(out, ref, 1.01 * (2 ** -8 * a + BF16_ULP
                                    * ref.float().abs()) + 1e-6)
    _assert_close(out, ref32, BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)
    return (q, kp, vp, *ints), out


@pytest.mark.parametrize("pool", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("H,KVH,D,page,C", [SPLIT_CASES[0], SPLIT_CASES[1],
                                            SPLIT_CASES[2], SPLIT_CASES[5]])
def test_ragged_split_quant_kernel(cuda, pool, H, KVH, D, page, C):
    """bf16 K13 with its keys split: NaN trash scales (and fp8 NaN codes)
    never read, the unsplit kernel's limit."""
    args, lengths, _ = _split_batch(cuda, H, KVH, D, page, C, seed=1)
    _check_split_quant(args, lengths, pool)


def _check_split_quant(args, lengths, pool):
    """bf16 K13 over the inputs' pools quantized to ``pool``, NaN trash
    scales (and fp8 NaN codes), held to the unsplit kernel's limit;
    returns its arguments and output."""
    q, kp, vp, *ints = args
    kp[:, 0] = vp[:, 0] = 0.0
    kc, ks = PA.quantize_kv(kp, pool)
    vc, vs = PA.quantize_kv(vp, pool)
    ks[:, 0] = vs[:, 0] = float("nan")
    if pool == torch.float8_e4m3fn:
        kc.view(torch.uint8)[:, 0] = vc.view(torch.uint8)[:, 0] = 0x7F
    q = q.to(torch.bfloat16)
    out = krpa.ragged_paged_attention(q, kc, vc, *ints, k_scales=ks,
                                      v_scales=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()
    ref = krpa.ragged_paged_attention_reference(q, kc, vc, *ints,
                                                k_scales=ks, v_scales=vs)
    a = krpa.ragged_paged_attention_reference(
        q.float(), PA.dequantize_pages(kc, ks),
        PA.dequantize_pages(vc, vs).abs(), *ints).float()
    _assert_close(out, ref, 1e-5 * a + BF16_ULP * ref.float().abs() + 1e-6)
    return (q, kc, vc, ks, vs, *ints), out


@pytest.mark.parametrize("pool", [None, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("H,KVH,plan", [(32, 8, (4, 512)),
                                        (28, 4, (8, 256))])
def test_ragged_split_at_the_served_decode_plan(cuda, pool, H, KVH, plan):
    """The decode step of the served models (one token in each of 8
    slots, tables of 2048 keys in pages of 16, D 128) runs the plan the
    engine runs: Llama-3-8B's 4 splits of 512 keys and Qwen2's 8 of 256.
    K12 (pool None) and K13 hold their limits there, and a second launch
    repeats the bits."""
    args, lengths, got = _split_batch(cuda, H, KVH, 128, 16, 1, seed=4,
                                      keys=2048)
    assert got == plan
    if pool is None:
        a, out = _check_split(args, lengths)
        fn = krpa.ragged_paged_attention
    else:
        a, out = _check_split_quant(args, lengths, pool)
        fn = krpa.ragged_paged_attention_quant
    again = fn(*a)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("pool", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("C", [1, 20])
def test_quant_codes_reach_the_products_exactly(cuda, pool, C):
    """bf16 K13 turns every code into bf16 exactly: int8 codes over the
    whole range -128..127, and e4m3 values that are all subnormal (a
    flush to zero would leave the outputs near 0), through the split and
    the unsplit kernel."""
    args, lengths, _ = _split_batch(cuda, 32, 8, 128, 16, C, seed=3)
    q, kp, _, *ints = args
    g = torch.Generator(device=cuda).manual_seed(9)
    bits = torch.randint(0, 256, kp.shape, generator=g, device=cuda,
                         dtype=torch.int32).to(torch.uint8)
    if pool == torch.int8:
        kc, vc = bits.view(torch.int8), bits.flip(-1).view(torch.int8)
    else:
        # e4m3 codes below 2^-6: exponent bits 0, any sign and mantissa
        kc = (bits & 0x87).view(torch.float8_e4m3fn)
        vc = (bits.flip(-1) & 0x87).view(torch.float8_e4m3fn)
    # unit value scales; key scales that keep the scores near 1 (int8
    # codes up to 128 would otherwise give scores in the hundreds)
    vs = torch.ones(kp.shape[:3], device=cuda)
    ks = vs / (64.0 if pool == torch.int8 else 1.0)
    ks[:, 0] = vs[:, 0] = float("nan")
    q = q.to(torch.bfloat16)
    out = krpa.ragged_paged_attention(q, kc, vc, *ints, k_scales=ks,
                                      v_scales=vs)
    ref = krpa.ragged_paged_attention_reference(
        q, kc, vc, *ints, k_scales=ks, v_scales=vs)
    a = krpa.ragged_paged_attention_reference(
        q.float(), PA.dequantize_pages(kc, ks),
        PA.dequantize_pages(vc, vs).abs(), *ints).float()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _assert_close(out, ref, 1e-5 * a + BF16_ULP * ref.float().abs() + 1e-6)
    if pool != torch.int8:
        assert ref.float().abs().max() > 1e-3    # not all zeros


@pytest.mark.parametrize("C", [1, 20])
def test_ragged_kernels_are_deterministic(cuda, C):
    """bf16 K12 and K13 with the split engaged, and K12 unsplit: two
    launches on the same inputs give the same bits (partials merged in
    split order, no atomics)."""
    args, _, _ = _split_batch(cuda, 32, 8, 128, 16, C, seed=2)
    q, kp, vp, *ints = args
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, kp, vp))
    kc, ks = PA.quantize_kv(torch.nan_to_num(kp), torch.int8)
    vc, vs = PA.quantize_kv(torch.nan_to_num(vp), torch.int8)
    unsplit, _ = _ragged(cuda, torch.bfloat16, 32, 8, 128, 16)
    for fn, a in ((krpa.ragged_paged_attention, (q16, k16, v16, *ints)),
                  (krpa.ragged_paged_attention_quant,
                   (q16, kc, vc, ks, vs, *ints)),
                  (krpa.ragged_paged_attention, unsplit)):
        first, second = fn(*a), fn(*a)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _decode(cuda, dtype, H, KVH, D, page, ctx=None, seed=0):
    rng = np.random.RandomState(seed)
    if ctx is None:
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


def _decode_contexts(case, H, KVH, D, page):
    """The contexts of a decode case. The split body's plan depends on
    the table's length alone, so it is taken at the table the case ends
    with (the longest context, rounded up to a page, plus one page)."""
    if case == "mixed":
        return None
    if case == "empty":                     # every sequence at ctx 0
        return np.zeros(8, np.int32)
    if case == "b1":
        return np.array([300], np.int32)
    if case == "b64":
        return np.linspace(1, 700, 64).astype(np.int32)
    top = 600                               # "splits": split edges
    max_keys = (-(-top // page) + 1) * page
    n, length = kpa.decode_split_plan(8, KVH, H // KVH, D, max_keys)
    assert n > 2, (n, length)
    # on a split's first and last key, past one, and contexts that leave
    # the later splits (or all but the first) empty
    return np.array([length, 2 * length, length - 1, length + 1,
                     2 * length + 1, 1, min(3 * length, top), top],
                    np.int32)


@pytest.mark.parametrize("case", ["mixed", "splits", "empty", "b1", "b64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,page", [(32, 8, 128, 16), (28, 4, 128, 16),
                                          (8, 8, 64, 8), (16, 2, 64, 4),
                                          (12, 4, 128, 32)])
def test_paged_attention_kernel(cuda, dtype, H, KVH, D, page, case):
    """K16 against its plain version; the trash page holds NaN, and a
    sequence with an empty cache gets zeros. In bf16 (the split body)
    contexts on and beside split edges, splits left empty (their CTAs
    still reach the cluster's barriers), every sequence at ctx 0, B 1
    and B 64, rep 1 to 8; a second launch repeats the bits."""
    args, ctx = _decode(cuda, dtype, H, KVH, D, page,
                        ctx=_decode_contexts(case, H, KVH, D, page))
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
    again = kpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


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
        assert len(eng._free_pages) + eng.prefix_cache_pages \
            == eng.num_pages - 1
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
                                      (4, 64, 32, 256),
                                      # widths that straddle the wgmma
                                      # kernel's 256-column tile and its
                                      # 64-wide contraction step
                                      (5, 200, 264, 128),
                                      (3, 72, 1408, 256)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_at_the_decode_layout(cuda, dtype):
    """A decode forward's layout: fewer routed rows than experts (2 tokens,
    top-2, 8 experts), so every expert owns one tile and most tiles are
    all padding; padding rows of x and dy are zero, and so must their
    outputs be."""
    E, d, h = 8, 200, 264
    gate_idx = torch.tensor([[0, 5], [5, 7]], dtype=torch.int32,
                            device=cuda)
    perm, gid, P = moe.sort_rows_by_expert(gate_idx, E)
    assert P == (1 + E) * 128 and gid.shape[0] == 1 + E
    real = torch.zeros(P, dtype=torch.bool, device=cuda)
    real[perm.long()] = True
    g = torch.Generator(device=cuda).manual_seed(13)
    x = (torch.randn(P, d, device=cuda, generator=g) * real[:, None])
    dy = (torch.randn(P, h, device=cuda, generator=g) * real[:, None])
    w = 0.1 * torch.randn(E, d, h, device=cuda, generator=g)
    x, dy, w = x.to(dtype), dy.to(dtype), w.to(dtype)
    y = kgmm.grouped_matmul(x, w, gid)
    dx = kgmm.grouped_matmul_t(dy, w, gid)
    torch.cuda.synchronize()
    ax, aw, ady = x.float().abs(), w.float().abs(), dy.float().abs()
    for out, ref, mag in (
            (y, kgmm.grouped_matmul_reference(x, w, gid),
             kgmm.grouped_matmul_reference(ax, aw, gid)),
            (dx, kgmm.grouped_matmul_reference(dy, w, gid, True),
             kgmm.grouped_matmul_reference(ady, aw, gid, True))):
        _assert_close(out, ref, _grouped_tol(ref, mag, dtype))
        assert not out[~real].any()


def test_grouped_matmul_is_deterministic(cuda):
    """K14 in both modes writes every output element once, in one order:
    two launches on the same inputs give the same bits."""
    x, w, dy, gid = _grouped_inputs(cuda, torch.bfloat16, 6, 1024, 1408,
                                    128, T=700, seed=5)
    for fn, a in ((kgmm.grouped_matmul, x), (kgmm.grouped_matmul_t, dy)):
        first, second = fn(a, w, gid), fn(a, w, gid)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("E,d,h,bm,T", [
    (7, 136, 264, 128, 40),     # d past a 128-row tile, h past 256
    (5, 64, 8, 128, 30),        # d of one warpgroup, h of one box
    (4, 392, 1400, 256, 300),   # bm 256, h's last tile partial
    (9, 200, 520, 128, 9)])     # one-tile runs
def test_grouped_dw_at_the_tile_edges(cuda, E, d, h, bm, T):
    """bf16 K15 at widths that straddle its 128 x 256 output tile and
    its 64-row step, with one-tile expert runs; expert 1 has no rows."""
    x, _, dy, gid = _grouped_inputs(cuda, torch.bfloat16, E, d, h, bm, T=T)
    dw = kgmm.grouped_dw(x, dy, gid, E)
    ref = kgmm.grouped_dw_reference(x, dy, gid, E)
    mag = kgmm.grouped_dw_reference(x.float().abs(), dy.float().abs(), gid,
                                    E)
    torch.cuda.synchronize()
    _assert_close(dw, ref, _grouped_tol(ref, mag, torch.bfloat16))
    assert not dw[1].any()


def test_grouped_dw_writes_zeros_for_experts_without_a_tile(cuda):
    """Experts 1, 4 and the last one own no row tile at all (a layout
    sort_rows_by_expert never makes, but the kernel's contract): their
    blocks of dw are zeros, written through the same stores."""
    E, d, h, bm = 7, 136, 264, 128
    gid = torch.tensor([0, 0, 2, 3, 3, 3, 5], dtype=torch.int32,
                       device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(gid.shape[0] * bm, d, device=cuda, generator=g)
    dy = torch.randn(gid.shape[0] * bm, h, device=cuda, generator=g)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    dw = kgmm.grouped_dw(x, dy, gid, E)
    ref = kgmm.grouped_dw_reference(x, dy, gid, E)
    mag = kgmm.grouped_dw_reference(x.float().abs(), dy.float().abs(), gid,
                                    E)
    torch.cuda.synchronize()
    _assert_close(dw, ref, _grouped_tol(ref, mag, torch.bfloat16))
    assert not dw[[1, 4, 6]].any()


def test_grouped_dw_is_deterministic(cuda):
    """K15 writes every element of dw once, in one order: two launches
    give the same bits."""
    x, _, dy, gid = _grouped_inputs(cuda, torch.bfloat16, 6, 1024, 1408,
                                    128, T=700, seed=6)
    first, second = (kgmm.grouped_dw(x, dy, gid, 6) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


def test_engine_step_runs_without_host_synchronisation(cuda):
    """One batching step of the engine on the card (a mixed forward, then
    decode forwards through the split K12) copies nothing to the host:
    under sync debug mode 'error' any synchronising call raises. bf16 at
    head_dim 64, a table of 1024 keys a slot, so the split engages."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=256,
                              intermediate_size=256,
                              max_position_embeddings=1024)
    model = LlamaForCausalLM(cfg, device=cuda, dtype=torch.bfloat16, seed=3)
    eng = ContinuousBatchingEngine(model, num_slots=2, page_size=16,
                                   max_len=1024, decode_chunk=4,
                                   prefill_chunk=16, device=cuda)
    assert krpa.split_plan(2, 1, cfg.num_key_value_heads,
                           cfg.num_attention_heads // cfg.num_key_value_heads,
                           cfg.head_dim, 1024)[0] > 1
    rng = np.random.RandomState(3)
    for n in (40, 9):
        eng.add_request(rng.randint(0, cfg.vocab_size, n), 6)
    eng.step()                                  # builds the kernels
    inputs = torch.zeros(2, eng._in_width, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    before = krpa.ragged_paged_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = eng._device_step(inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert krpa.ragged_paged_attention.launches == before + 4 * L
    assert packed.shape[0] == 2


# ---- the scheduler's conditions: shared prefixes, COW, the pipeline -----------

def _shared_prefix_batch(cuda, H, KVH, D, page, C, seed=0):
    """A batch as the prefix cache leaves it: rows whose block tables
    point at the SAME physical pages s0-s2 (a published 3-page prefix).
    Row 0 owns the prefix and decodes past it; row 1 is a prefix hit, a
    full prefill chunk starting at ctx 2 * page (a page multiple, not a
    chunk multiple); row 2 is a copy-on-write hit, a one-token prefill at
    ctx 3 * page - 1 into f, a fork of s2; row 3 decodes over s0 and a
    page of its own. Trash page 0 holds NaN."""
    assert (2 * page) % C
    rng = np.random.RandomState(seed)
    ctx = np.array([3 * page + 5, 2 * page, 3 * page - 1, page + 3],
                   np.int32)
    lengths = np.array([1, C, 1, 1], np.int32)
    width = -(-int((ctx + lengths).max()) // page) + 1
    P = 4 * width + 4
    free = list(rng.permutation(np.arange(1, P)))
    s, fork = [int(free.pop()) for _ in range(3)], int(free.pop())
    tables = np.zeros((4, width), np.int32)
    for b, head in enumerate((s, s[:2], s[:2] + [fork], s[:1])):
        n = -(-int(ctx[b] + lengths[b]) // page)
        tables[b, :len(head)] = head
        tables[b, len(head):n] = [int(free.pop())
                                  for _ in range(n - len(head))]
    g = torch.Generator(device=cuda).manual_seed(seed)
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    kp[:, fork] = kp[:, s[2]]
    vp[:, fork] = vp[:, s[2]]
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn(4, C, H, D, device=cuda, generator=g)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx, lengths)]
    return (q, kp, vp, *ints), lengths


@pytest.mark.parametrize("pool", [None, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("H,KVH,D,page,C", [(32, 8, 128, 16, 24),
                                            (16, 8, 128, 32, 256),
                                            (8, 2, 64, 8, 12)])
def test_ragged_kernels_over_shared_prefix_pages(cuda, pool, H, KVH, D,
                                                 page, C):
    """K12 (f32 and bf16 q) and K13 (int8, fp8) over the prefix cache's
    tables (shared pages, a prefill chunk from a page multiple, a
    one-token prefill at ctx L - 1 in a forked page) against their plain
    versions; the rows that read the same keys through the shared and
    the forked page agree."""
    args, lengths = _shared_prefix_batch(cuda, H, KVH, D, page, C)
    if pool is not None:
        _check_split_quant(args, lengths, pool)
        return
    _, out = _check_split(args, lengths)
    q, kp, vp, *ints = args
    out32 = krpa.ragged_paged_attention(*args)
    ref32 = krpa.ragged_paged_attention_reference(*args)
    a = krpa.ragged_paged_attention_reference(q, kp, vp.abs(), *ints)
    torch.cuda.synchronize()
    assert torch.isfinite(out32).all()
    _assert_close(out32, ref32, 1e-5 * a + 1e-6)
    # the same query through s2 and through its fork f sees the same keys
    q2 = q.clone()
    q2[0, 0] = q2[2, 0]
    ctx = ints[1].clone()
    ctx[0] = ctx[2]
    same = krpa.ragged_paged_attention(q2, kp, vp, ints[0], ctx, ints[2])
    torch.cuda.synchronize()
    assert torch.equal(same[0, 0], same[2, 0])


@pytest.mark.parametrize("pool", [None, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("H,KVH,D,page,C", [(32, 8, 128, 16, 256),
                                            (16, 8, 128, 32, 256),
                                            (28, 4, 128, 16, 256),
                                            (8, 2, 64, 8, 12)])
def test_one_token_prefill_equals_its_row_in_a_chunk(cuda, pool, H, KVH,
                                                     D, page, C):
    """A fully cached prompt's last token is re-prefilled alone (ctx
    L - 1, one token) where an engine without the cache computed it as
    the last row of a full chunk at ctx L - C: bf16 K12 and K13 give the
    two the same bits (the warps' layout follows the shapes, never the
    lengths), beside a decode row in the same step."""
    L = 2 * C
    pages = L // page + 1
    rng = np.random.RandomState(2)
    row = (rng.permutation(3 * pages) + 1)[:pages].astype(np.int32)
    tables = np.stack([row, row, np.roll(row, 1)])
    ctx = np.array([L - C, L - 1, L - 7], np.int32)
    lengths = np.array([C, 1, 1], np.int32)
    g = torch.Generator(device=cuda).manual_seed(2)
    P = 3 * pages + 1
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g)
    q = torch.randn(3, C, H, D, device=cuda, generator=g)
    q[1, 0] = q[0, C - 1]
    q = q.to(torch.bfloat16)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx, lengths)]
    if pool is None:
        out = krpa.ragged_paged_attention(q, kp.to(torch.bfloat16),
                                          vp.to(torch.bfloat16), *ints)
    else:
        kc, ks = PA.quantize_kv(kp, pool)
        vc, vs = PA.quantize_kv(vp, pool)
        out = krpa.ragged_paged_attention(q, kc, vc, *ints, k_scales=ks,
                                          v_scales=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out[1, 0], out[0, C - 1])


def _card_engine(cuda, kv_quant="none", dtype=torch.bfloat16, layers=2,
                 heads=4, **kw):
    """A 2-layer Llama of hidden 256 (head dim 64 at 4 heads, 128 at 2;
    rep 2) on the card, and an engine over it."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=256,
                              intermediate_size=256, num_hidden_layers=layers,
                              num_attention_heads=heads,
                              num_key_value_heads=heads // 2,
                              max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, device=cuda, dtype=dtype, seed=3)
    kw = {**dict(num_slots=4, page_size=16, max_len=256, decode_chunk=4,
                 prefill_chunk=32, audit=True), **kw}
    return ContinuousBatchingEngine(model, kv_quant=kv_quant, device=cuda,
                                    **kw)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
def test_cow_fork_copies_a_page_in_every_pool(cuda, kv_quant):
    """The copy-on-write fork makes page dst a bit-for-bit copy of page
    src in all 2L (4L quantized: codes and f32 scales) pools, fp8 codes
    included, and leaves every other page as it was."""
    eng = _card_engine(cuda, kv_quant, layers=3)
    assert len(eng.pools) == (2 if kv_quant == "none" else 4) * 3
    g = torch.Generator(device=cuda).manual_seed(1)
    for p in eng.pools:
        bits = p.view(torch.uint8)
        bits.copy_(torch.randint(0, 256, bits.shape, generator=g,
                                 device=cuda, dtype=torch.int32))
    before = [p.view(torch.uint8).clone() for p in eng.pools]
    src, dst = 5, 11
    eng._pc_cow(src, dst)
    torch.cuda.synchronize()
    for p, old in zip(eng.pools, before):
        bits = p.view(torch.uint8)
        assert torch.equal(bits[:, dst], old[:, src])
        keep = torch.ones(bits.shape[1], dtype=torch.bool, device=cuda)
        keep[dst] = False
        assert torch.equal(bits[:, keep], old[:, keep])
    assert eng.gauges()["prefix_cache_cow_forks"] == 1


def _storm(eng, specs, serial=False):
    ids = [eng.add_request(p, n) for p, n in specs]
    if serial:
        done = []
        while eng.queue or any(r is not None for r in eng.slot_req):
            done += eng.step()
    else:
        done = eng.run()
    by = {r.request_id: r.tokens for r in done}
    return [by[i] for i in ids]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_pipelined_run_matches_serial_steps(cuda, kv_quant):
    """run() dispatches a step before it harvests the last one; the
    greedy streams equal those of serial step() turns, with the prefix
    cache off and on (shared prefixes, COW forks, evictions in a small
    pool), and the page audit balances."""
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, 256, 48)
    specs = [(np.concatenate([prefix, rng.randint(0, 256, t)]), int(n))
             for t, n in zip(rng.randint(0, 20, 10), rng.randint(2, 12, 10))]
    specs += [(prefix, 6), (rng.randint(0, 256, 70), 9)]
    streams = {}
    for cache in (False, True):
        for serial in (False, True):
            eng = _card_engine(cuda, kv_quant, prefix_cache=cache,
                               num_pages=40)
            streams[cache, serial] = _storm(eng, specs, serial)
            assert len(eng._free_pages) + eng.prefix_cache_pages \
                == eng.num_pages - 1
            eng._audit_pages("test")
            if cache and not serial:
                g = eng.gauges()
                assert g["prefix_cache_hits"] and g["prefix_cache_cow_forks"]
                assert g["prefill_overlap_frac"] > 0
    assert streams[False, False] == streams[False, True]
    assert streams[True, False] == streams[True, True]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("heads", [4, 2])
def test_prefix_cache_streams_equal_cache_off(cuda, kv_quant, heads):
    """bf16 greedy streams with the prefix cache on equal those with it
    off, bit for bit: prefixes of a page multiple that is not a chunk
    multiple (the cached suffix streams from another chunk offset) and
    whole cached prompts (a copy-on-write fork and a one-token prefill),
    at head dims 64 and 128."""
    rng = np.random.RandomState(8)
    prefix = rng.randint(0, 256, 48)      # 3 pages of 16; chunks of 32
    specs = [(prefix, 7)]
    specs += [(np.concatenate([prefix, rng.randint(0, 256, t)]), 9)
              for t in (1, 5, 16, 23, 40)]
    specs += [(prefix, 5), (prefix[:32], 6), (prefix[:32], 4)]
    streams, forks = [], 0
    for cache in (False, True):
        eng = _card_engine(cuda, kv_quant, heads=heads, prefix_cache=cache)
        streams.append(_storm(eng, specs[:1]) + _storm(eng, specs[1:]))
        forks += eng.gauges()["prefix_cache_cow_forks"]
    assert forks >= 2
    assert streams[0] == streams[1]


def test_dispatch_runs_without_host_synchronisation(cuda):
    """A dispatch (the upload of the step's inputs from pinned memory,
    the step, the copy of its packed output back into pinned memory)
    and a pipelined successor's dispatch synchronise nothing: under sync
    debug mode 'error' any synchronising call raises. The harvest then
    waits on each step's event alone and the streams come out whole."""
    eng = _card_engine(cuda, prefix_cache=True)
    rng = np.random.RandomState(3)
    _storm(eng, [(rng.randint(0, 256, 40), 4)])      # builds the kernels
    prompt = rng.randint(0, 256, 64)
    for n in (40, 9):
        eng.add_request(prompt[:n], 6)
    eng._admit()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = eng._dispatch_step()
        second = eng._dispatch_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._harvest_step(first)
    eng._harvest_step(second)
    done = eng.run()
    assert sorted(len(r.tokens) for r in done) == [6, 6]


# ---- speculative decoding and weight-only quantization -----------------

def _spec_specs(rng, n=6):
    """Prompts of a random span tiled three times (the n-gram source
    drafts from them), 12-40 new tokens each."""
    return [(np.tile(rng.randint(0, 256, int(rng.randint(4, 12))), 3),
             int(rng.randint(12, 40))) for _ in range(n)]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("draft", ["ngram", "self", "oracle"])
def test_spec_streams_equal_plain_at_one_token_steps(cuda, kv_quant, draft):
    """bf16 greedy spec streams equal the plain engine's at decode_chunk
    1, whose every forward is, like the verify step's, a [B,
    prefill_chunk] ragged pass (K12's warps' layout follows the step's
    width, so a [B, 1] decode tail would sum in another order). Oracle
    drafts (the plain streams) are all accepted."""
    rng = np.random.RandomState(12)
    specs = _spec_specs(rng)
    plain = _storm(_card_engine(cuda, kv_quant, decode_chunk=1), specs)
    source = OracleDraftSource(dict(enumerate(plain)), 256) \
        if draft == "oracle" else draft
    eng = _card_engine(cuda, kv_quant, decode_chunk=1, spec_k=4,
                       spec_draft=source)
    assert _storm(eng, specs) == plain
    g = eng.gauges()
    assert g["spec_tokens_drafted"] > 0
    if draft == "oracle":
        assert g["spec_accept_rate"] == 1.0
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1
    eng._audit_pages("test")


def test_self_spec_draft_leaves_committed_kv_untouched(cuda):
    """On the card: a slot at ctx 250 of a 256-position row drafting K 8
    would reach past the row (the clamp lands on its last page, over
    committed positions); the draft must leave every committed position
    of every pool bit for bit as it was."""
    eng = _card_engine(cuda, num_slots=1, spec_k=8, spec_draft="self",
                       prefix_cache=False, prefill_chunk=64)
    rng = np.random.RandomState(4)
    eng.add_request(rng.randint(0, 256, 250), 4)
    eng.step()
    while eng._prefilling.any():
        eng.step()
    ctx = int(eng._pred_ctx[0])
    assert ctx == 250 and eng.active[0]
    assert ctx + eng._spec_k - 1 >= eng.pages_per_slot * eng.page_size
    pos = torch.arange(ctx)
    row = torch.from_numpy(eng.tables[0]).long()
    pages, offs = row[pos // eng.page_size].to(cuda), (pos % eng.page_size
                                                        ).to(cuda)
    before = [p[:, pages, offs].clone() for p in eng.pools]
    eng._spec_source.propose(eng, [0], eng._spec_k)
    torch.cuda.synchronize()
    for p, was in zip(eng.pools, before):
        assert torch.equal(p[:, pages, offs].view(torch.uint8),
                           was.view(torch.uint8))


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
@pytest.mark.parametrize("shape", [(3, 256, 512), (5, 4096, 14336)])
def test_weight_only_linear_on_the_card(cuda, algo, shape):
    """WeightOnlyLinear in bf16 against its plain version, the same codes
    dequantized in f32 and multiplied in f64: per element within 2 bf16
    ulps of |ref| (the product and the scaled result are each rounded
    to bf16 once) plus the f32 accumulation over the inputs."""
    rows, n_out, n_in = shape
    g = torch.Generator(device=cuda).manual_seed(rows)
    w = (torch.randn(n_out, n_in, device=cuda, generator=g) * 0.02).bfloat16()
    x = torch.randn(rows, n_in, device=cuda, generator=g).bfloat16()
    lin = WeightOnlyLinear(w, algo=algo)
    out = lin(x)
    codes = lin.codes().double()
    ref = (x.double() @ codes.t()) * lin.weight_scale.double()
    mag = (x.double().abs() @ codes.abs().t()) * lin.weight_scale.double()
    tol = 2 * BF16_ULP * ref.abs() + 2 ** -22 * mag + 1e-6
    _assert_close(out, ref, tol)
    assert out.dtype == torch.bfloat16


# ---- generate over dense caches, and the legacy engine -----------------------

def test_generate_without_eos_runs_without_host_synchronisation(cuda):
    """The eos-less ``generate`` (the prefill and every decode step, the
    RMSNorm and SwiGLU kernels, the dense-cache attention, the pick)
    copies nothing to the host, greedy or sampled: under sync debug mode
    'error' any synchronising call raises."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=256,
                              intermediate_size=256)
    model = LlamaForCausalLM(cfg, device=cuda, dtype=torch.bfloat16, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (3, 9), device=cuda,
                        generator=gen)
    sample = dict(decode_strategy="sampling", top_k=20, top_p=0.9,
                  temperature=0.7, seed=5, repetition_penalty=1.2)
    model.generate(ids, max_new_tokens=4, **sample)     # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        greedy = model.generate(ids, max_new_tokens=12,
                                decode_strategy="greedy_search")
        sampled = model.generate(ids, max_new_tokens=12, **sample)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for out, scores in (greedy, sampled):
        assert out.shape == (3, 12) and out.device.type == "cuda"
        assert torch.isfinite(scores).all()


def test_generate_on_the_card_matches_the_cpu(cuda):
    """f32: greedy tokens of both drivers (no eos; an eos that stops a
    row) equal the CPU's, scores within 1e-4; seeded sampling repeats
    on the card."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu_model = LlamaForCausalLM(cfg, device=cuda, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, (3, 11))
    first, _ = cpu_model.generate(ids, max_new_tokens=3,
                                  decode_strategy="greedy_search")
    for kw in (dict(), dict(eos_token_id=int(first[0, 2]))):
        outs = [m.generate(ids, max_new_tokens=10,
                           decode_strategy="greedy_search", **kw)
                for m in (cpu_model, gpu_model)]
        assert torch.equal(outs[0][0], outs[1][0].cpu())
        torch.testing.assert_close(outs[1][1].cpu(), outs[0][1], rtol=0,
                                   atol=1e-4)
    sample = dict(decode_strategy="sampling", top_p=0.9, temperature=0.8,
                  seed=7)
    a, _ = gpu_model.generate(ids, max_new_tokens=10, **sample)
    b, _ = gpu_model.generate(ids, max_new_tokens=10, **sample)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_legacy_engine_on_the_card_matches_the_cpu(cuda, kv_quant):
    """f32: the legacy engine's greedy streams on the card equal the
    CPU's and the unified engine's on the card, and the dense
    ``generate``'s (f32 pools)."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu_model = LlamaForCausalLM(cfg, device=cuda, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(1)
    specs = [(rng.randint(0, cfg.vocab_size, p), n)
             for p, n in [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]]
    streams = {}
    for model, dev, unified in ((cpu_model, "cpu", False),
                                (gpu_model, cuda, False),
                                (gpu_model, cuda, True)):
        eng = ContinuousBatchingEngine(model, num_slots=2, page_size=8,
                                       max_len=64, decode_chunk=4,
                                       prefill_chunk=16, kv_quant=kv_quant,
                                       unified=unified, audit=True,
                                       device=dev)
        streams[str(dev), unified] = _storm(eng, specs)
        assert len(eng._free_pages) + eng.prefix_cache_pages \
            == eng.num_pages - 1
    legacy = streams["cuda", False]
    assert legacy == streams["cpu", False]
    assert legacy == streams["cuda", True]
    if kv_quant == "none":
        for (p, n), s in zip(specs, legacy):
            out, _ = gpu_model.generate(p[None], max_new_tokens=n,
                                        decode_strategy="greedy_search")
            assert out[0].tolist() == s


def test_legacy_launch_counts(cuda):
    """A prefill wave is one [S, C] forward and a decode chunk of n steps
    n [S, 1] forwards: each forward launches 2L + 1 RMSNorms, L SwiGLUs
    and L ragged attentions (K12)."""
    eng = _card_engine(cuda, unified=False, decode_chunk=8)
    rng = np.random.RandomState(4)
    eng.add_request(rng.randint(0, 256, 40), 12)
    eng.add_request(rng.randint(0, 256, 9), 12)
    eng._admit()
    L = eng.cfg.num_hidden_layers
    kernels = (krms.rms_norm, ksw.swiglu, krpa.ragged_paged_attention)
    before = [k.launches for k in kernels]
    eng._pump_prefill(max_waves=1)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] \
        == [2 * L + 1, L, L]
    eng._pump_prefill()
    before = [k.launches for k in kernels]
    rec = eng._dispatch_chunk()
    n = rec[3]
    eng._harvest_chunk(rec)
    assert n == 8      # both slots have 11 tokens of budget left
    assert [k.launches - b for k, b in zip(kernels, before)] \
        == [(2 * L + 1) * n, L * n, L * n]
    assert ("chunk", 8) in eng._compiled
    done = eng.run()
    assert sorted(len(r.tokens) for r in done) == [12, 12]


# ---- the training loop users run (optimizers, clip, schedule, AMP, scaler,
# checkpoints) -------------------------------------------------------------

def _clipped_numpy(model, opt):
    """The clipped grads ``opt.step`` would apply, by state-dict key in the
    JAX package's layout."""
    names = [n for n, _ in model.named_parameters()]
    pgs = opt._clipped()
    return pgs, convert._to_numpy({n: g for n, (_, g) in zip(names, pgs)},
                                  convert._linear_keys(model))


def test_adamw_clip_schedule_on_the_card_match_the_cpu(cuda):
    """AdamW under a warm-up-cosine schedule with global-norm clipping,
    f32, 3 steps: the rates are equal, the clipped first step within
    the Adam first-step limit, the losses within 1e-4 of each other
    (Adam carries the grads' f32 noise into the later steps)."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, lr
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    weights = LlamaForCausalLM(cfg, device="cpu", seed=5).state_dict()
    rows = [torch.from_numpy(np.random.RandomState(20 + i).randint(
        0, cfg.vocab_size, (2, 65))) for i in range(3)]
    out = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, T_max=10), 2,
                                1e-3, 1e-2)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(0.5))
        losses, rates = [], []
        for i, ids in enumerate(rows):
            t = ids.to(dev)
            _, loss = model(t, labels=t)
            loss.backward()
            rates.append(opt.get_lr())
            if i == 0:
                pgs, clipped = _clipped_numpy(model, opt)
                opt._apply(pgs)
                # copies: on the CPU the arrays share the weights
                first = (clipped, {k: v.copy() for k, v in
                                   convert.to_numpy_state_dict(
                                       model).items()})
            else:
                opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(loss.item())
        out.append((losses, rates, first))
    (l0, r0, (g0, w0)), (l1, r1, (g1, w1)) = out
    assert r0 == r1 and r0[0] == 1e-3
    for key in g0:
        lim = adam_first_step_limit(g0[key], g1[key], w0[key], r0[0])
        assert (np.abs(w1[key] - w0[key]) <= lim).all(), key
    for a, b in zip(l0, l1):
        assert abs(a - b) <= 1e-4 * abs(a)


def test_grad_scaler_skip_on_the_card(cuda):
    from paddle_tpu_torch.amp import GradScaler
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    model = LlamaForCausalLM(cfg, device=cuda, seed=6)
    opt = AdamW(1e-3, parameters=model.parameters())
    scaler = GradScaler(init_loss_scaling=256.0)
    t = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 33))).to(cuda)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, loss = model(t, labels=t)
    scaler.scale(loss).backward()
    model.lm_head.weight.grad[1, 2] = float("nan")
    scaler.step(opt)
    opt.clear_grad()
    assert scaler.get_loss_scaling() == 128.0
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    assert opt._step_count == 0 and opt._accumulators == {}
    _, loss = model(t, labels=t)
    scaler.scale(loss).backward()
    scaler.step(opt)
    assert opt._step_count == 1
    assert not torch.equal(before["lm_head.weight"], model.lm_head.weight)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_train_batch_on_the_card_matches_the_cpu(cuda, level):
    """bf16 matmuls on both sides (and bf16 parameters at O2): the loss
    within 2e-3 of itself, each gradient within 5e-2 of its norm."""
    from paddle_tpu_torch.hapi import Model
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    weights = LlamaForCausalLM(cfg, device="cpu", seed=7).state_dict()
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 65)))
    out = []
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device=dev)
        model.load_state_dict(weights)
        m = Model(model)
        m.prepare(SGD(1e-2, parameters=model.parameters()),
                  LlamaPretrainingCriterion(cfg), amp_configs=level)
        t = ids.to(dev)
        loss = m.train_batch([t], t, update=False)[0]
        out.append((loss, convert.grads_to_numpy(model),
                    {p.dtype for p in model.parameters()}))
    (l0, g0, d0), (l1, g1, d1) = out
    want = torch.float32 if level == "O1" else torch.bfloat16
    assert d0 == d1 == {want}
    assert abs(l1 - l0) <= 2e-3 * abs(l0)
    for key in g0:
        err = np.linalg.norm(g1[key] - g0[key]) / np.linalg.norm(g0[key])
        assert err <= 5e-2, (key, err)


def test_checkpoint_written_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    """Model.save_checkpoint from the card (bf16 weights, f32 slots and
    masters) and load_checkpoint into a CPU model and optimizer: every
    tensor equal bit for bit, and the next step equal within f32 noise."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import lr
    cfg = dataclasses.replace(LlamaConfig.tiny(), scan_layers=False)
    ids = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (2, 33)))

    def make(dev, seed):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=seed)
        sched = lr.StepDecay(1e-3, 2)
        m = Model(model)
        m.prepare(AdamW(sched, parameters=model.parameters()),
                  LlamaPretrainingCriterion(cfg))
        return m, sched

    card, sched = make(cuda, 1)
    t = ids.to(cuda)
    for _ in range(2):
        card.train_batch([t], t)
        sched.step()
    path = str(tmp_path / "step_0")
    card.save_checkpoint(path, epoch=0)
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    stored = dckpt.read_state_dict(path, prefix="optimizer")
    for k, v in card._optimizer.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(stored[k], v.cpu()), k
    cpu, cpu_sched = make("cpu", 2)
    assert cpu.load_checkpoint(path) == 0
    for k, v in card.network.state_dict().items():
        assert torch.equal(cpu.network.state_dict()[k], v.cpu()), k
    assert cpu_sched.state_dict() == sched.state_dict()
    assert cpu._optimizer._step_count == 2
    l_card = card.train_batch([t], t)[0]
    l_cpu = cpu.train_batch([ids], ids)[0]
    # bf16 on both sides, kernels against plain versions
    assert abs(l_card - l_cpu) <= 1e-2 * abs(l_card)
    a = card._optimizer.state_dict()
    b = cpu._optimizer.state_dict()
    assert set(a) == set(b)
    rate = card._optimizer.get_lr()
    assert rate == cpu._optimizer.get_lr() and abs(rate - 1e-4) < 1e-12
    for k in a:
        if k.endswith("_master"):
            # from equal masters and moments the third step moves each copy
            # by rate * m_hat / (sqrt(v_hat) + eps); with betas 0.9/0.999
            # at step 3, |m_hat| / sqrt(v_hat) <= 1.004 (Cauchy-Schwarz
            # over the three grads), so the copies part by at most 2.01
            # rates, and only where a grad's sign differs: most elements
            # stay equal (masters rebuilt from the bf16 weights would
            # differ by their rounding, about 3e-5, everywhere)
            err = (b[k] - a[k].cpu()).abs()
            assert err.max().item() <= 2.01 * rate, k
            assert err.median().item() <= 1e-6, k


# ---- the model families: GPT-2, ERNIE, DeepSeek-V2, Llama-3-70B ------------

@pytest.mark.parametrize("case", [(16, 512, 512, 12, 12, 64, False),
                                  (8, 1024, 1024, 12, 12, 64, True)],
                         ids=["ernie", "gpt2"])
def test_flash_attention_at_the_model_shapes(cuda, case):
    """K7-K9 in bf16 at ERNIE's non-causal [16, 512] and GPT-2's causal
    [8, 1024] (12 heads, D 64), with the limits of
    test_flash_attention_kernels, and a second launch's bits."""
    test_flash_attention_kernels(cuda, torch.bfloat16, case)
    B, S, _, H, _, D, causal = case
    q, k, v, go = _attention_inputs(cuda, torch.bfloat16, B, S, S, H, H, D,
                                    seed=5)
    out, lse = kfa.flash_attention_fwd(q, k, v, causal)
    delta = kfa._delta(out, go)
    runs = [(*kfa.flash_attention_fwd(q, k, v, causal),
             *kfa.flash_attention_dkv(q, k, v, go, lse, delta, causal),
             kfa.flash_attention_dq(q, k, v, go, lse, delta, causal))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("H,KVH,D", [(12, 12, 64), (64, 8, 128)],
                         ids=["gpt2_rep1", "llama70_rep8"])
@pytest.mark.parametrize("C", [24, 1], ids=["mixed", "decode"])
def test_ragged_paged_attention_at_the_model_heads(cuda, H, KVH, D, C):
    """K12 at GPT-2's 12/12 heads (rep 1, D 64) and Llama-3-70B's 64/8
    (rep 8, D 128): a mixed batch in bf16 and f32, and a decode step with
    its keys split, each held to the kernel's limits."""
    if C > 1:
        for dtype in (torch.float32, torch.bfloat16):
            test_ragged_paged_attention_kernel(cuda, dtype, H, KVH, D, 16)
        return
    args, lengths, _ = _split_batch(cuda, H, KVH, D, 16, C)
    args, out = _check_split(args, lengths)
    assert torch.equal(krpa.ragged_paged_attention(*args), out)


@pytest.mark.parametrize("d", [512, 1536, 5120])
def test_rms_norm_kernels_at_deepseek_widths(cuda, d):
    """K1 and K2 at DeepSeek-V2's kv and q latent widths and its hidden."""
    for dtype in (torch.float32, torch.bfloat16):
        test_rms_norm_kernel(cuda, dtype, 37, d)
        test_rms_norm_dx_kernel(cuda, dtype, 37, d)


def test_grouped_matmul_at_deepseek_layout(cuda):
    """K14 (both modes) and K15 in bf16 at DeepSeek-V2's expert layout:
    160 experts, top-6 of 300 tokens, d 5120, h 1536 (most experts own
    one or two tiles), against the plain versions per element."""
    E, d, h = 160, 5120, 1536
    x, w, dy, gid = _grouped_inputs(cuda, torch.bfloat16, E, d, h, 128,
                                    T=300, k=6, seed=2)
    ax, aw, ady = x.float().abs(), w.float().abs(), dy.float().abs()
    for out, ref, mag in (
            (kgmm.grouped_matmul(x, w, gid),
             kgmm.grouped_matmul_reference(x, w, gid),
             kgmm.grouped_matmul_reference(ax, aw, gid)),
            (kgmm.grouped_matmul_t(dy, w, gid),
             kgmm.grouped_matmul_reference(dy, w, gid, True),
             kgmm.grouped_matmul_reference(ady, aw, gid, True)),
            (kgmm.grouped_dw(x, dy, gid, E),
             kgmm.grouped_dw_reference(x, dy, gid, E),
             kgmm.grouped_dw_reference(ax, ady, gid, E))):
        _assert_close(out, ref, _grouped_tol(ref, mag, torch.bfloat16))


def test_deepseek_latent_norm_takes_a_contiguous_copy(cuda):
    """K1 refuses the strided slice ``ckv[..., :kv_lora_rank]``; the model
    normalises a contiguous copy of it (one K1 launch) and gives the
    plain version's values on the slice itself."""
    from paddle_tpu_torch.models import (DeepseekV2Config,
                                         DeepseekV2ForCausalLM)
    cfg = dataclasses.replace(DeepseekV2Config.tiny(), num_hidden_layers=1)
    m = DeepseekV2ForCausalLM(cfg, device=cuda, dtype=torch.bfloat16)
    attn = m.layers[0].self_attn
    x = torch.randn(2, 9, cfg.hidden_size, device=cuda).bfloat16()
    ckv = attn.kv_a_proj_with_mqa(x)
    strided = ckv[..., :cfg.kv_lora_rank]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        krms.rms_norm(strided, attn.kv_a_layernorm.weight, cfg.rms_norm_eps)
    rope = (m.rope_sin[None, :9], m.rope_cos[None, :9])
    before = krms.rms_norm.launches
    with torch.no_grad():
        latent, _ = attn._latent(x, rope)
    assert krms.rms_norm.launches == before + 1
    ref = krms.rms_norm_reference(strided, attn.kv_a_layernorm.weight,
                                  cfg.rms_norm_eps)
    _assert_close(latent, ref, _tol(ref, torch.bfloat16, 3))


def test_dropout_on_the_card_keeps_its_share_and_scale(cuda):
    """Dropout draws from a seeded generator on the card: the same seed
    repeats its mask, the kept share is 1 - p within 4 standard
    deviations, the kept values are x / (1 - p)."""
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(2048, 1024, device=cuda)
    p = 0.1
    runs = [F.dropout(x, p, generator=torch.Generator(
        device=cuda).manual_seed(7)) for _ in range(2)]
    assert torch.equal(*runs)
    kept = (runs[0] != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 4 * (p * (1 - p) / x.numel()) ** 0.5
    vals = runs[0][runs[0] != 0]
    assert torch.equal(vals, torch.full_like(vals, 1 / (1 - p)))


@pytest.mark.parametrize("family", ["gpt2", "ernie", "deepseek",
                                    "deepseek_dropless"])
def test_tiny_model_step_on_the_card_matches_the_cpu(cuda, family):
    """The new families at their tiny widths in f32, card (kernels)
    against CPU (plain versions) from the same weights: the labelled loss
    within 1e-5 relative, each gradient within 1e-4 of its norm; greedy
    ``generate`` streams equal (GPT-2 and DeepSeek), and GPT-2's engine
    streams equal its ``generate``'s on the card."""
    from paddle_tpu_torch.models import (DeepseekV2Config,
                                         DeepseekV2ForCausalLM, ErnieConfig,
                                         ErnieForPretraining, GPT2Config,
                                         GPT2ForCausalLM)
    cls, cfg = {
        # two heads of 32: K12 takes head dims of 32-256, not tiny's 16
        "gpt2": (GPT2ForCausalLM, dataclasses.replace(
            GPT2Config.tiny(), num_attention_heads=2)),
        "ernie": (ErnieForPretraining, ErnieConfig.tiny()),
        "deepseek": (DeepseekV2ForCausalLM, DeepseekV2Config.tiny()),
        "deepseek_dropless": (DeepseekV2ForCausalLM, dataclasses.replace(
            DeepseekV2Config.tiny(), moe_dropless=True))}[family]
    cfg = dataclasses.replace(cfg, initializer_range=0.2)
    weights = cls(cfg, device="cpu", seed=3).state_dict()
    rng = np.random.RandomState(1)
    ids = rng.randint(5, cfg.vocab_size, (2, 40))
    labels = np.where(rng.rand(2, 40) < 0.2, ids, -100)
    prompts = rng.randint(0, cfg.vocab_size, (2, 7))
    out = {}
    for dev in ("cpu", cuda):
        m = cls(cfg, device=dev)
        m.load_state_dict(weights)
        t = torch.from_numpy(ids).to(dev)
        if family == "ernie":
            loss = m(t, masked_lm_labels=torch.from_numpy(labels).to(dev),
                     sop_labels=torch.tensor([0, 1], device=dev))
        else:
            loss = m(t, labels=t)[1]
        loss.backward()
        streams = []
        if family != "ernie":
            m.eval()
            streams.append(m.generate(prompts, max_new_tokens=10,
                                      decode_strategy="greedy_search")[
                                          0].tolist())
        if family == "gpt2":
            eng = ContinuousBatchingEngine(m, num_slots=2, page_size=8,
                                           max_len=32, decode_chunk=4,
                                           prompt_buckets=(16,), device=dev)
            for p in prompts:
                eng.add_request(p, 10)
            streams.append([r.tokens for r in sorted(
                eng.run(), key=lambda r: r.request_id)])
        out[str(dev)] = (loss.item(), convert.grads_to_numpy(m), streams)
    (l0, g0, s0), (l1, g1, s1) = out["cpu"], out[str(cuda)]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert set(g0) == set(g1)
    for k in g0:
        assert np.linalg.norm(g1[k] - g0[k]) <= 1e-4 * max(
            np.linalg.norm(g0[k]), 1e-30), k
    assert s1 == s0
    if family == "gpt2":
        assert s1[1] == s1[0] and all(len(t) == 10 for t in s1[1])


# ---- the serving front door: fleet, API server, tracing ----------------

def test_two_replica_fleet_on_the_card_survives_a_kill(cuda):
    """Two replicas over card engines (tiny width, f32), replica 1
    killed past its restart budget: every fleet id is delivered once
    and its stream equals a single card engine's; the breaker is open
    and the survivor's pages balance."""
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.testing import FaultInjector
    eng = _card_engine(cuda, dtype=torch.float32)
    model = eng.model
    rng = np.random.RandomState(5)
    specs = [(rng.randint(0, 256, int(rng.randint(3, 40))),
              int(rng.randint(2, 12))) for _ in range(10)]
    want = _storm(eng, specs)
    fleet = ServingFleet(lambda: ContinuousBatchingEngine(
        model, num_slots=4, page_size=16, max_len=256, decode_chunk=4,
        prefill_chunk=32, audit=True, device=cuda), num_replicas=2,
        max_restarts=1, retry_backoff_s=0.01)
    fids = [fleet.submit(p, n) for p, n in specs]
    with FaultInjector() as fi:
        fi.kill_replica(1, times=10_000, after_steps=1)
        done = fleet.run()
    by = {r.request_id: r for r in done}
    assert sorted(by) == sorted(fids) and len(done) == len(fids)
    assert [by[f].tokens for f in fids] == want
    assert all(by[f].error is None for f in fids)
    g = fleet.gauges()
    assert g["breaker_open"] == 1 and fleet.replicas[1].state == "ejected"
    survivor = fleet.replicas[0].engine
    assert len(survivor._free_pages) + survivor.prefix_cache_pages \
        == survivor.num_pages - 1


def test_api_server_pump_drives_a_card_engine(cuda):
    """The API server's pump thread drives a card engine: an SSE stream
    and a unary completion return ``engine.run()``'s greedy tokens for
    the same request."""
    import json
    import urllib.request
    from paddle_tpu_torch.inference import ApiServer
    rng = np.random.RandomState(6)
    prompt = [int(t) for t in rng.randint(0, 256, 11)]
    ref = _card_engine(cuda)
    ref.add_request(np.asarray(prompt, np.int32), 12)
    want = " ".join(str(t) for t in ref.run()[-1].tokens)
    srv = ApiServer(_card_engine(cuda)).start()
    try:
        assert srv._pump_stream is not None
        got = []
        for stream in (True, False):
            req = urllib.request.Request(
                srv.url + "/v1/completions",
                data=json.dumps({"prompt": prompt, "max_tokens": 12,
                                 "stream": stream}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            if stream:
                frames = [f for f in raw.split("\n\n") if f]
                assert frames[-1] == "data: [DONE]"
                got.append("".join(
                    json.loads(f[len("data: "):])["choices"][0]["text"]
                    for f in frames[:-1]))
            else:
                got.append(json.loads(raw)["choices"][0]["text"])
    finally:
        srv.stop()
    assert got == [want, want]


# ---- the recompute policies, check_numerics and the kernel-route flags -------

def _flash_block(lin, heads, d):
    def block(x):
        b, s, _ = x.shape
        q = lin(x).view(b, s, heads, d)
        return kfa.flash_attention(q, q, q, causal=True).float().square()
    return block


@pytest.mark.parametrize("policy,reruns", [("dots_saveable", 1),
                                           ("dots_and_flash_saveable", 0)])
def test_dots_and_flash_saveable_keeps_the_k7_output(cuda, policy, reruns):
    """Under ``dots_and_flash_saveable`` the recompute replays K7's saved
    output: no K7 launch in the backward (``dots_saveable`` launches it
    again); the gradients are the same bits either way."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.incubate.recompute import recompute
    g = torch.Generator(device=cuda).manual_seed(17)
    lin = torch.nn.Linear(256, 256, bias=False, device=cuda,
                          dtype=torch.bfloat16)
    x = torch.randn(2, 129, 256, device=cuda, generator=g).to(
        torch.bfloat16).requires_grad_()
    block = _flash_block(lin, 4, 64)
    ref = block(x).sum()
    gref = torch.autograd.grad(ref, (x, lin.weight))
    flags.set_flags({"FLAGS_recompute_policy": policy})
    try:
        before = kfa.flash_attention_fwd.launches
        loss = recompute(block, x).sum()
        assert kfa.flash_attention_fwd.launches == before + 1
        grads = torch.autograd.grad(loss, (x, lin.weight))
        assert kfa.flash_attention_fwd.launches == before + 1 + reruns
    finally:
        flags.set_flags({"FLAGS_recompute_policy": "dots_saveable"})
    assert torch.equal(loss, ref)
    assert all(torch.equal(a, b) for a, b in zip(grads, gref))


def test_check_numerics_costs_one_host_read(cuda):
    """``amp.debugging.check_numerics`` reduces on the card and reads one
    count: one synchronising call (sync debug mode's warnings)."""
    import warnings
    from paddle_tpu_torch.amp import debugging
    t = torch.randn(1024, 1024, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert debugging.check_numerics(t, "mm", "out") is t
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]
    t[3, 5] = float("nan")
    with pytest.raises(RuntimeError, match="1 non-finite element"):
        debugging.check_numerics(t, "mm", "out")


def _route_calls(cuda):
    """Each flag-routed op on CUDA tensors: name -> (call, its kernels)."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device=cuda).manual_seed(23)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=cuda, generator=g).to(dtype)
    x, w = rand(64, 256), 1 + 0.1 * rand(256)
    gate, up = rand(64, 512), rand(64, 512)
    q, k = rand(2, 64, 4, 64), rand(2, 64, 2, 64)
    h, wv = rand(48, 64), rand(64, 300)
    labels = torch.randint(0, 300, (48,), device=cuda, generator=g)
    pools = [rand(2, 9, 16, 64), rand(2, 9, 16, 64)]
    tables = torch.arange(1, 9, dtype=torch.int32, device=cuda).view(2, 4)
    ctx = torch.tensor([40, 17], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([8, 3], dtype=torch.int32, device=cuda)

    def with_grad(fn, *ts):
        ts = [t.detach().requires_grad_() for t in ts]
        out = fn(*ts)
        out = out[0] if isinstance(out, tuple) else out
        out.float().sum().backward()
        return [out] + [t.grad for t in ts]
    return {
        "FLAGS_enable_pallas_kernels": [
            (lambda: with_grad(lambda a: F.rms_norm(a, w), x),
             (krms.rms_norm, krms.rms_norm_dx)),
            (lambda: with_grad(lambda a, b: F.fused_rms_norm_residual(
                a, b, w), x, x.flip(0)),
             (krms.rms_norm_residual, krms.rms_norm_residual_dh)),
            (lambda: with_grad(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True), q, k, k),
             (kfa.flash_attention_fwd, kfa.flash_attention_dkv,
              kfa.flash_attention_dq))],
        "FLAGS_fused_swiglu": [
            (lambda: with_grad(F.swiglu, gate, up),
             (ksw.swiglu, ksw.swiglu_bwd))],
        "FLAGS_flash_attn_pallas_bwd": [
            (lambda: with_grad(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True), q, k, k),
             (kfa.flash_attention_dkv, kfa.flash_attention_dq))],
        "FLAGS_fused_ce_pallas_inner": [
            (lambda: with_grad(lambda a: fused_ce.fused_linear_cross_entropy(
                a, wv, labels), h), (kce.chunk_stats, kce.chunk_dlogits))],
        "FLAGS_use_pallas_paged_attention": [
            (lambda: [PA.paged_attention(q[:, 0].contiguous(), *pools, tables,
                                         ctx)],
             (kpa.paged_attention,))],
        "FLAGS_use_pallas_ragged_attention": [
            (lambda: [PA.ragged_paged_attention(
                q[:, :8].contiguous(), *pools, tables, ctx, lengths)],
             (krpa.ragged_paged_attention,))],
    }


@pytest.mark.parametrize("flag", [
    "FLAGS_enable_pallas_kernels", "FLAGS_fused_swiglu",
    "FLAGS_flash_attn_pallas_bwd", "FLAGS_fused_ce_pallas_inner",
    "FLAGS_use_pallas_paged_attention", "FLAGS_use_pallas_ragged_attention"])
def test_kernel_route_flags(cuda, flag):
    """At its default (on) each route flag's op launches its kernels on
    CUDA tensors; set off, the same op takes the plain version (no
    launch) and gives the kernels' results within bf16 rounding."""
    from paddle_tpu_torch.framework import flags
    assert flags.flag(flag)
    for call, kernels in _route_calls(cuda)[flag]:
        before = [kern.launches for kern in kernels]
        on = call()
        assert all(kern.launches > b for kern, b in zip(kernels, before))
        flags.set_flags({flag: False})
        try:
            before = [kern.launches for kern in kernels]
            off = call()
            assert [kern.launches for kern in kernels] == before
        finally:
            flags.set_flags({flag: True})
        for a, b in zip(on, off):
            _assert_close(a, b, 4 * BF16_ULP * b.float().abs()
                          + 4 * BF16_ULP * b.float().abs().max() + 1e-6)


# ---- the process half of serving on the card --------------------------------

def test_proc_replica_on_the_card_serves_and_reports_its_kernels(cuda):
    """A ProcReplica whose worker runs on the card (a Llama-1B-wide
    layer in bf16): the worker loads the kernel library this process
    built (it compiles nothing), its init names the card, it serves
    greedy streams equal to an in-process engine's over a model from the
    same seed, and its audit reports K1, K5 and K12 at 3, 1 and 1
    launches a forward."""
    import os
    import time

    from paddle_tpu_torch.inference import ProcReplica
    from paddle_tpu_torch.inference.serving import ServedRequest
    from paddle_tpu_torch.inference.worker import llama_engine
    from paddle_tpu_torch.ops.kernels import _build
    _build.build()
    torch.cuda.empty_cache()
    kw = dict(model="llama_1b", num_hidden_layers=1, seed=0,
              dtype="bfloat16", num_slots=4, page_size=16, max_len=128,
              decode_chunk=4, prefill_chunk=32, audit=True)
    rng = np.random.RandomState(7)
    specs = [(rng.randint(0, 32000, (int(n),)).astype(np.int32), 6)
             for n in (5, 40, 17)]
    ref = llama_engine(**kw)
    ids = [ref.add_request(p, n) for p, n in specs]
    by = {r.request_id: r for r in ref.run()}
    want = [by[i].tokens for i in ids]
    del ref
    rep = ProcReplica(0, {"factory": "paddle_tpu_torch.inference.worker:"
                          "llama_engine", "kwargs": kw},
                      init_deadline_s=300.0, hb_timeout_s=10.0)
    try:
        reqs = []
        for i, (p, n) in enumerate(specs):
            req = ServedRequest(i, p, n, None)
            req.t_arrive = time.perf_counter()
            rep.admission.admit(req)
            reqs.append(req)
        for _ in range(200):
            rep.step()
            if all(r.finished for r in reqs):
                break
        assert rep.worker_device == torch.cuda.get_device_name(0)
        assert rep.worker_pid != os.getpid()
        assert [r.tokens for r in reqs] == want
        a = rep.audit()
    finally:
        rep.close()
    assert a["clean"] and not a["kernels_compiled"] and a["forwards"] > 0
    assert a["launches"] == {
        "rms_norm": 3 * a["forwards"], "swiglu": a["forwards"],
        "ragged_paged_attention": a["forwards"],
        "ragged_paged_attention_quant": 0}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kv_pages_migrate_on_the_card_bit_for_bit(cuda, kv_quant):
    """A prefill-role engine on the card exports bf16 (or int8 + f32
    scales) pages whose crc32s equal those computed on the CPU over the
    same bytes of its pools; a decode-role engine on the card imports
    them through the wire codec and holds the same bits in its pools;
    the request completes with its budget."""
    import json
    import zlib

    from paddle_tpu_torch.inference.disagg import (kv_payload_from_wire,
                                                   kv_payload_to_wire)
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, 256, (53,)).astype(np.int32)
    pre = _card_engine(cuda, kv_quant, role="prefill")
    dec = _card_engine(cuda, kv_quant, role="decode")
    rid = pre.add_request(prompt, 8)
    for _ in range(64):
        pre.step()
        if pre.migrations_out:
            break
    (req, payload), = pre.take_migrations()
    assert payload["dtype"] == ("bfloat16" if kv_quant == "none"
                                else "int8")
    chain = pre._pc_match(prompt)
    assert len(chain) == len(payload["blocks"]) == 53 // 16
    for node, blk in zip(chain, payload["blocks"]):
        cpu = [p[:, node.page].cpu().contiguous() for p in pre.pools]
        raw = [t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               for t in cpu]
        assert blk["crc"] == [zlib.crc32(t.numpy().tobytes()) for t in raw]
    res = dec.import_migration(req, kv_payload_from_wire(
        json.loads(json.dumps(kv_payload_to_wire(payload)))))
    assert res == {"imported": 3, "dedup": 0, "rejected": 0}
    cur = dec._pc_root
    for blk in payload["blocks"]:
        cur = cur.children[blk["tokens"].tobytes()]
        got = [p[:, cur.page].cpu().contiguous() for p in dec.pools]
        got = [t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               for t in got]
        assert [t.numpy().tobytes() for t in got] \
            == [np.ascontiguousarray(d).tobytes() for d in blk["data"]]
    assert pre.release_exported(rid)
    done = {r.request_id: r for r in dec.run()}
    assert len(done[rid].tokens) == 8
    dec._audit_pages("test")


def _tp_inputs():
    rng = np.random.RandomState(0)
    f = np.float32
    a = {"x": rng.randn(2, 5, 8).astype(f),
         "h": rng.randn(2, 5, 12).astype(f),
         "w1": (rng.randn(8, 12) * 0.3).astype(f),
         "b1": rng.randn(12).astype(f),
         "w2": (rng.randn(12, 8) * 0.3).astype(f),
         "b2": rng.randn(8).astype(f),
         "dy1": rng.randn(2, 5, 12).astype(f),
         "dy2": rng.randn(2, 5, 8).astype(f),
         "emb": rng.randn(16, 8).astype(f),
         "ids": rng.randint(0, 16, (2, 5)).astype(np.int64),
         "logits": rng.randn(2, 5, 16).astype(f),
         "labels": rng.randint(0, 16, (2, 5)).astype(np.int64)}
    a["labels"][0, 1] = -100
    return a


def _two_ranks(device, path, *args):
    from torch_dist_pool import RankPool
    pool = RankPool(2, device=device)
    try:
        return pool.run(path, *args)
    finally:
        pool.close()


def test_low_precision_gloo_collectives_on_two_ranks_sharing_the_card(cuda):
    """bf16/f16 sums and means of two ranks sharing the card (their bytes
    swapped, added in f32 on the card) equal the f32 sum of the widened
    values rounded once, bit for bit; a broadcast and an all-to-all move
    the bytes."""
    res = _two_ranks("cuda", "torch_dist_cases:low_precision_collectives",
                     "cuda")
    for r in range(2):
        for key, (got, want) in res[r].items():
            np.testing.assert_array_equal(got, want, err_msg=f"{r}: {key}")


def test_tensor_parallel_layers_on_two_ranks_sharing_the_card(cuda):
    """Two ranks share the card (the backend rule takes gloo through host
    buffers): every TP layer's forward and backward in f32 on the card
    equals the same two ranks' run on the CPU (the plain versions), to
    f32 summation order."""
    from paddle_tpu_torch.ops.kernels import _build
    _build.build()
    a = _tp_inputs()
    card = _two_ranks("cuda", "torch_dist_cases:tp_layers", a, "cuda")
    cpu = _two_ranks("cpu", "torch_dist_cases:tp_layers", a, "cpu")
    for r in range(2):
        for key, ref in cpu[r].items():
            if key == "split_shape":
                assert card[r][key] == ref
                continue
            np.testing.assert_allclose(card[r][key], ref, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{r}: {key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_parallel_fused_ce_on_two_ranks_sharing_the_card(cuda, dtype):
    """The vocab-parallel fused CE with K10/K11 launched over each rank's
    4096-column shard (chunks of 1024 and a clamped tail) against the
    same ranks' plain versions on the CPU in f32: the loss, dh and dW
    (f32 to summation order; bf16 inputs are bf16-representable, so only
    the logits' and the dlogits' roundings part them)."""
    from paddle_tpu_torch.ops.kernels import _build
    _build.build()
    rng = np.random.RandomState(3)
    n, d, v = 300, 64, 8000
    a = {"h": rng.randn(n, d).astype(np.float32),
         "w": (rng.randn(d, v) * 0.1).astype(np.float32),
         "labels": rng.randint(0, v, n).astype(np.int64)}
    a["labels"][:3] = (-100, v - 1, v // 2)
    if dtype == "bfloat16":
        for k in ("h", "w"):
            a[k] = torch.from_numpy(a[k]).bfloat16().float().numpy()
    card = _two_ranks("cuda", "torch_dist_cases:vocab_parallel_ce", a,
                      1000, "cuda", dtype)
    cpu = _two_ranks("cpu", "torch_dist_cases:vocab_parallel_ce", a, 1000)
    rtol = 1e-5 if dtype == "float32" else 4 * BF16_ULP
    for r in range(2):
        assert card[r]["launches"][0] > 0 and card[r]["launches"][1] > 0
        np.testing.assert_allclose(card[r]["loss"], cpu[r]["loss"],
                                   rtol=rtol)
        for key in ("dh", "dw"):
            ref = cpu[r][key]
            atol = rtol * np.abs(ref).max()
            np.testing.assert_allclose(card[r][key], ref, rtol=rtol,
                                       atol=atol, err_msg=f"{r}: {key}")


def test_mp2_bf16_async_checkpoint_of_two_ranks_resumes_in_one_process(
        cuda, tmp_path):
    """Two ranks sharing the card train Llama at mp 2 in bf16, save model
    and optimizer with ``async_save=True`` after three AdamW steps and
    take the fourth while the writer runs; this process loads the
    checkpoint into the unsharded model (mp 1) and takes the fourth step:
    its loss is within ``chip_smoke.TP_BF16_RTOL`` of the ranks' own (the
    same weights; the bf16 sums of one rank and of two round apart)."""
    from chip_smoke import TP_BF16_RTOL
    from paddle_tpu_torch.ops.kernels import _build
    _build.build()
    fields = dict(vocab_size=1024, hidden_size=256, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=512,
                  max_position_embeddings=256, scan_layers=False)
    rng = np.random.RandomState(4)
    batches = [rng.randint(0, 1024, (2, 129)).astype(np.int64)
               for _ in range(4)]
    path = str(tmp_path / "step_0")
    ranks = _two_ranks("cuda", "torch_ckpt_cases:card_async_save", fields,
                       batches, path)
    assert ranks[0] == ranks[1]
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    model = LlamaForCausalLM(cfg, device=cuda, dtype=torch.bfloat16, seed=5)
    m = Model(model)
    m.prepare(AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    weight_decay=0.01))
    assert m.load_checkpoint(path) == 0
    assert m._optimizer._step_count == 3
    t = torch.from_numpy(batches[3]).to(cuda)
    _, loss = model(t, labels=t)
    loss.backward()
    m._optimizer.step()
    want = ranks[0][3]
    assert abs(loss.item() - want) <= TP_BF16_RTOL * abs(want), (
        loss.item(), want)


@pytest.mark.parametrize("schedule", ["1F1B", "ZB-H1"])
def test_pp2_on_two_ranks_sharing_the_card_equals_the_pp1_run(cuda,
                                                              schedule):
    """Two ranks share the card as the stages of a pp 2 f32 tiny Llama
    (4 layers, the fused carry crossing the stages as the ``(hidden,
    residual)`` pair, 2 microbatches) through three AdamW steps: the
    losses and the first step's gradients, gathered over the stages,
    equal the same model's pp 1 run on the card (``LlamaForCausalLM`` on
    the whole batch): losses rtol 1e-5 at the first step and 1e-4 after
    (the microbatches' sums run in another order), gradients rtol 1e-4,
    atol 1e-6."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models.llama import pipe_key
    from paddle_tpu_torch.ops.kernels import _build
    _build.build()
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    model = LlamaForCausalLM(cfg, device=cuda, seed=0)
    arrays = {k: v.copy() for k, v in
              convert.to_numpy_state_dict(model).items()}
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    rng = np.random.RandomState(6)
    batches = [rng.randint(0, 256, (4, 16)).astype(np.int64)
               for _ in range(3)]
    losses, grads0 = [], None
    for step, ids in enumerate(batches):
        t = torch.from_numpy(ids).to(cuda)
        _, loss = model(t, labels=t)
        loss.backward()
        if step == 0:
            grads0 = convert.grads_to_numpy(model)
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    ranks = _two_ranks("cuda", "torch_pipe_cases:card_pipe", fields, arrays,
                       batches, {"pp_degree": 2, "dp_degree": 1},
                       {"schedule_mode": schedule, "accumulate_steps": 2})
    n = cfg.num_hidden_layers
    for res in ranks:
        assert res["device"].startswith("cuda")
        np.testing.assert_allclose(res["losses"][0], losses[0], rtol=1e-5)
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
        for k, g in grads0.items():
            np.testing.assert_allclose(res["grads0"][pipe_key(n, "llama.",
                                                              k)],
                                       g, rtol=1e-4, atol=1e-6, err_msg=k)


# ---- context parallelism: Ulysses' local attention ---------------------------

def _flash_counts():
    return (kfa.flash_attention_fwd.launches,
            kfa.flash_attention_dkv.launches,
            kfa.flash_attention_dq.launches)


def test_ulysses_local_attention_at_the_8b_sep2_shard_shape(cuda):
    """Ulysses' local attention on Llama-3-8B at sep 2, the shape after
    its all-to-all: q, k, v [1, 4096, 16, 128] bf16 (32 heads over 2
    ranks, the 8 kv heads repeated first), causal. Through
    ``ring_attention.ulysses_attention`` (a group of one: the all-to-all
    is the identity) it launches K7 once and K8/K9 once each in the
    backward, with the bits of the kernels called directly; the kernels
    match the plain versions within ``test_flash_attention_kernels``'
    bf16 limits (the backward from the same saved lse and delta)."""
    from paddle_tpu_torch.ops import ring_attention as ra
    q, k, v, go = _attention_inputs(cuda, torch.bfloat16, 1, 4096, 4096, 16,
                                    16, 128)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = _flash_counts()
    out = ra.ulysses_attention(*leaves, None, causal=True)
    out.backward(go)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_flash_counts(), before)] == [1, 1, 1]
    out_k, lse_k = kfa.flash_attention_fwd(q, k, v, True)
    assert torch.equal(out, out_k)
    for leaf, g in zip(leaves, kfa.flash_attention_bwd(q, k, v, out_k,
                                                       lse_k, go, True)):
        assert torch.equal(leaf.grad, g)
    ref, ref_lse = kfa.flash_attention_fwd_reference(q, k, v, True)
    a = kfa.flash_attention_fwd_reference(q.float(), k.float(),
                                          v.float().abs(), True)[0]
    _assert_close(out, ref, 1.01 * (2 ** -7 * a + BF16_ULP
                                    * ref.float().abs()) + 1e-6)
    delta = kfa._delta(ref, go)
    dk, dv = kfa.flash_attention_dkv(q, k, v, go, ref_lse, delta, True)
    dq = kfa.flash_attention_dq(q, k, v, go, ref_lse, delta, True)
    want = kfa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, go, True)
    scales = attention_scales(q, k, v, go, ref_lse, delta, True)
    for got, w, sc in zip((dq, dk, dv), want, scales):
        _assert_close(got, w, (2 ** -8 + 1e-5) * sc
                      + BF16_ULP * w.float().abs() + 1e-6)


def test_ulysses_raises_where_k7_refuses_the_shape(cuda):
    """A head dim K7 does not take (48) raises on the card: Ulysses never
    falls back to the plain attention for a CUDA tensor."""
    from paddle_tpu_torch.ops import ring_attention as ra
    q = torch.randn(1, 64, 4, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not taken"):
        ra.ulysses_attention(q, q, q, None, causal=True)


def test_sep2_llama_on_two_ranks_sharing_the_card(cuda):
    """Tiny Llama (f32) at sep 2 on two ranks sharing the card, under
    Ulysses (the flash kernels on the card) and the ring: three AdamW
    steps' losses equal the same ranks' CPU run within 1e-5 at the first
    step and 1e-4 after."""
    arrays = convert.to_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0))
    rng = np.random.RandomState(8)
    batches = [rng.randint(0, 256, (2, 32)).astype(np.int64)
               for _ in range(3)]
    for impl in ("ulysses", "ring"):
        fields = {"sep_parallel": impl}
        args = ("llama", fields, arrays, batches,
                {"sep_degree": 2, "dp_degree": 1}, "adamw", 1e-3, 0.01,
                None, None, None)
        card = _two_ranks("cuda", "torch_cp_cases:sep_train", *args, None)
        cpu = _two_ranks("cpu", "torch_cp_cases:sep_train", *args, "cpu")
        for c, h in zip(card, cpu):
            np.testing.assert_allclose(c["losses"][0], h["losses"][0],
                                       rtol=1e-5)
            np.testing.assert_allclose(c["losses"], h["losses"], rtol=1e-4)


@pytest.mark.parametrize("family,cf,aux", [("qwen2_moe", 4.0, 0.0),
                                           ("qwen2_moe", 1.25, 0.001),
                                           ("deepseek", 4.0, 0.0)])
def test_ep2_moe_models_on_two_ranks_sharing_the_card(cuda, family, cf,
                                                      aux):
    """Tiny Qwen2-MoE and DeepSeek-V2 (f32) at ep 2 on two ranks sharing
    the card (E/2 experts a rank, the all-to-alls through gloo's host
    buffers, K1-K9 on the card), at a capacity that keeps every token
    (E/k) and at one that drops with the aux loss on: three AdamW steps'
    losses equal the same ranks' CPU run within 1e-5 at the first step
    and 1e-4 after, and both ranks hold 4 of the 8 experts."""
    from paddle_tpu_torch.models import (DeepseekV2Config,
                                         DeepseekV2ForCausalLM,
                                         Qwen2MoeConfig, Qwen2MoeForCausalLM)
    make = {"qwen2_moe": (Qwen2MoeConfig, Qwen2MoeForCausalLM),
            "deepseek": (DeepseekV2Config, DeepseekV2ForCausalLM)}[family]
    arrays = convert.to_numpy_state_dict(
        make[1](make[0].tiny(), device="cpu", seed=0))
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, 256, (2, 32)).astype(np.int64)
               for _ in range(3)]
    args = (family, {"router_aux_loss_coef": aux}, arrays, batches,
            {"ep_degree": 2, "dp_degree": 1}, "adamw", 1e-3, 0.01, None, cf,
            None, None)
    card = _two_ranks("cuda", "torch_ep_cases:ep_train", *args, None)
    cpu = _two_ranks("cpu", "torch_ep_cases:ep_train", *args, "cpu")
    for c, h in zip(card, cpu):
        np.testing.assert_allclose(c["losses"][0], h["losses"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(c["losses"], h["losses"], rtol=1e-4)
        assert all(shape[0] == 4 for shape, _ in c["banks"].values())
