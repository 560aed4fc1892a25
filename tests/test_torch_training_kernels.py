"""The port's training kernels (RMSNorm dx, SwiGLU backward, flash
attention forward and backward) against the JAX package, on the CPU.

The port's side runs its plain versions (CPU tensors), through the
autograd Functions the model uses. The JAX side runs the Pallas kernels
in interpret mode, as the JAX package's own tests do on the CPU: the
RMSNorm and SwiGLU backward through ``jax.vjp`` of
``ops.pallas.rms_norm.rms_norm`` and ``ops.pallas.swiglu.swiglu_fused``
(K2, K6); flash attention through ``flash_attention`` and ``_flash_fwd``
(K7) and ``jax.vjp`` of ``flash_attention`` (K8/K9), plus the scan
backward ``_bwd_rule_scan``. Inputs are numpy from a seed; shapes are
small because interpret-mode Pallas is slow. The CUDA kernels are held
against the same plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu.ops.pallas import swiglu as jsw

from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import rms_norm as trms
from paddle_tpu_torch.ops.kernels import swiglu as tsw

torch.set_num_threads(1)

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    """The same numpy values as a torch and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return (torch.from_numpy(a).to(tdt).requires_grad_(),
            jnp.asarray(a, jnp.float32).astype(jdt))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within(ours, ref, tol):
    """Element by element: ``tol`` holds each element's limit."""
    err = np.abs(_np(ours) - _np(ref))
    assert (err <= tol).all(), float((err / tol).max())


# ---- RMSNorm backward (K2) ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(7, 64), (33, 96)])
def test_rms_norm_backward_matches_jax_kernel(dtype, n, d):
    rng = np.random.RandomState(n + d)
    x_np = (rng.randn(n, d) * 2).astype(np.float32)
    w_np = (1 + 0.2 * rng.randn(d)).astype(np.float32)
    g_np = rng.randn(n, d).astype(np.float32)
    (tx, jx), (tw, jw) = _pair(x_np, dtype), _pair(w_np, dtype)
    tg, jg = _pair(g_np, dtype)
    y = trms.RMSNormFunction.apply(tx, tw, 1e-5)
    y.backward(tg.detach())
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b, 1e-5), jx, jw)
    jdx, jdw = vjp(jg)
    if dtype == "float32":
        # the same f32 formula; row sums in another order
        np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=1e-5,
                                   atol=1e-5)
    else:
        # both f32 inside and rounded once to bf16; the f32 sums' order
        # may flip a rounding: one ulp, plus f32 noise on the
        # difference inv*g*w - x*c
        _within(tx.grad, jdx, BF16_ULP * np.abs(_np(jdx)) + 1e-4)
        _within(tw.grad, jdw, BF16_ULP * np.abs(_np(jdw)) + 1e-4)
    # the plain dx is the wrapper's CPU path
    dx = trms.rms_norm_dx(tx.detach(), tw.detach(), tg.detach(), 1e-5)
    assert torch.equal(dx, tx.grad)


# ---- SwiGLU backward (K6) ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 128), (3, 7, 96)])
def test_swiglu_backward_matches_jax_kernel(dtype, shape):
    rng = np.random.RandomState(len(shape))
    g_np = (rng.randn(*shape) * 3).astype(np.float32)
    u_np = rng.randn(*shape).astype(np.float32)
    go_np = rng.randn(*shape).astype(np.float32)
    (tg, jg), (tu, ju) = _pair(g_np, dtype), _pair(u_np, dtype)
    tgo, jgo = _pair(go_np, dtype)
    tsw.SwiGLUFunction.apply(tg, tu).backward(tgo.detach())
    _, vjp = jax.vjp(jsw.swiglu_fused, jg, ju)
    jdg, jdu = vjp(jgo)
    if dtype == "float32":
        # the same f32 formula; sigmoid implementations differ in the
        # last bits
        np.testing.assert_allclose(_np(tg.grad), _np(jdg), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tu.grad), _np(jdu), rtol=1e-5,
                                   atol=1e-6)
    else:
        # f32 inside, rounded once on both sides: one ulp
        _within(tg.grad, jdg, BF16_ULP * np.abs(_np(jdg)) + 1e-6)
        _within(tu.grad, jdu, BF16_ULP * np.abs(_np(jdu)) + 1e-6)


# ---- flash attention (K7, K8, K9) -------------------------------------------

# B, Sq, Sk, H, KVH, D, causal. Sq > Sk causal leaves rows that see no
# key, where the JAX forward averages (its masked probabilities are
# exp(0)); those cases are compared on the other rows only.
FLASH_CASES = [
    (1, 40, 40, 2, 2, 16, True),       # rep 1, S not a block multiple
    (2, 24, 24, 4, 2, 32, True),       # rep 2
    (1, 33, 33, 4, 1, 16, False),      # rep 4 (MQA), non-causal
    (1, 24, 40, 4, 2, 16, True),       # Sq < Sk, bottom-right causal
    (1, 40, 24, 2, 1, 16, False),      # Sq > Sk, non-causal
    # the shapes the card's wgmma backward tiles care about (64-row
    # warpgroups, 64-query stages, 128-query dq tiles)
    (1, 70, 70, 7, 1, 64, True),       # rep 7
    (1, 130, 130, 2, 1, 128, True),    # D 128, S straddling 64 and 128
    (1, 60, 140, 4, 2, 64, True),      # Sq < Sk at D 64
]


def _flash_inputs(case, seed=0):
    b, sq, sk, h, kvh, d, _ = case
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                      (b, sq, h, d))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_matches_jax_kernel(case):
    b, sq, sk, h, kvh, d, causal = case
    q, k, v, _ = _flash_inputs(case)
    out, lse = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                       causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = jfa.flash_attention(jq, jk, jv, causal)
    _, jlse = jfa._flash_fwd(jq, jk, jv, causal, None)
    # f32 throughout; softmax and products sum in another order
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), _np(jlse).reshape(b, h, sq),
                               rtol=1e-5, atol=1e-5)


def test_flash_forward_bf16_matches_jax_reference():
    case = (1, 40, 40, 4, 2, 32, True)
    q, k, v, _ = _flash_inputs(case, seed=3)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out, _ = tfa.flash_attention_fwd(*t, True)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = jfa.flash_attention_reference(j[0], jnp.repeat(j[1], 2, axis=2),
                                        jnp.repeat(j[2], 2, axis=2),
                                        causal=True)
    a = tfa.flash_attention_fwd_reference(
        *[x.float() for x in t[:2]], t[2].float().abs(), True)[0].numpy()
    # both round the probabilities to bf16 before P.V (at most 2^-8 of
    # a = sum p|v| each, bf16's unit roundoff) and round their outputs:
    # 2^-7 * a + 1 ulp
    _within(out, ref, 2 ** -7 * a + BF16_ULP * np.abs(_np(ref)) + 1e-6)


def _port_grads(case, q, k, v, go):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention(*t, causal=case[-1]).backward(torch.from_numpy(go))
    return [x.grad.numpy() for x in t]


def _jax_grads(case, q, k, v, go):
    f = lambda a, b, c: jfa.flash_attention(a, b, c, case[-1])  # noqa
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [_np(g) for g in vjp(jnp.asarray(go))]


@pytest.fixture
def flash_bwd_flag():
    name = "FLAGS_flash_attn_pallas_bwd"
    saved = dict(flags._registry[name])
    yield lambda on: flags.set_flags({name: on})
    flags._registry[name] = saved


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_jax_kernels(case, flash_bwd_flag):
    flash_bwd_flag(True)              # the Pallas dkv/dq kernels
    q, k, v, go = _flash_inputs(case, seed=1)
    ours = _port_grads(case, q, k, v, go)
    theirs = _jax_grads(case, q, k, v, go)
    for name, a, b in zip("qkv", ours, theirs):
        # f32 throughout, products summed in another order
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", FLASH_CASES[:2])
def test_flash_backward_matches_jax_scan(case, flash_bwd_flag):
    flash_bwd_flag(False)             # _bwd_rule_scan, the plain backward
    q, k, v, go = _flash_inputs(case, seed=2)
    ours = _port_grads(case, q, k, v, go)
    theirs = _jax_grads(case, q, k, v, go)
    for name, a, b in zip("qkv", ours, theirs):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_flash_plain_backward_is_the_port_of_the_scan():
    case = (1, 40, 40, 4, 2, 16, True)
    q, k, v, go = _flash_inputs(case, seed=4)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, go))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, True, None)
    jgrads = jfa._bwd_rule_scan(True, None, (jq, jk, jv, jout, jlse), jg)
    ours = tfa.flash_attention_bwd_reference(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(_np(jout)),
        torch.tensor(_np(jlse).reshape(1, 4, 40)), torch.from_numpy(go),
        True)
    for name, a, b in zip("qkv", ours, jgrads):
        # the same f32 blockwise math from the same out and lse
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_flash_fully_masked_rows_give_zero_output_and_grads():
    # Sq > Sk causal: query rows 0 .. Sq-Sk-1 see no key at all
    sq, sk = 64, 32
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, sq, 2, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, sk, 2, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, sk, 2, 16).astype(np.float32))
    for t in (q, k, v):
        t.requires_grad_()
    out = tfa.flash_attention(q, k, v, causal=True)
    assert not out[:, :sq - sk].any()
    out[:, :sq - sk].sum().backward()
    for t in (q, k, v):
        assert not t.grad.any()
    # the JAX kernels agree on the gradients
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    grads = jax.grad(lambda a, b, c: jnp.sum(
        jfa.flash_attention(a, b, c, True)[:, :sq - sk]),
        argnums=(0, 1, 2))(jq, jk, jv)
    for g in grads:
        np.testing.assert_allclose(_np(g), 0.0, atol=1e-6)


def test_flash_rows_with_keys_match_jax_when_some_rows_see_none():
    case = (1, 40, 24, 2, 1, 16, True)
    q, k, v, _ = _flash_inputs(case, seed=6)
    out, _ = tfa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                     True)
    jout = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), True)
    # rows 16.. see keys; rows 0..15 are 0 here and averaged there
    np.testing.assert_allclose(out.numpy()[:, 16:], _np(jout)[:, 16:],
                               rtol=1e-5, atol=2e-5)
    assert not out[:, :16].any()
