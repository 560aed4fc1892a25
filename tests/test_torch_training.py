"""The port's training slice against the JAX package on
LlamaConfig.tiny(), f32, tied and untied: the labeled forward's loss,
every parameter's gradient, the weights after one and three AdamW steps,
bf16 parameters with f32 master copies, the pretraining criterion, the
cross entropy and the attention routing; and the plain ops the GPT-2,
ERNIE and DeepSeek-V2 ports add (``layer_norm`` to the bit in bf16,
``gelu`` in both forms, ``tanh``, seeded ``dropout``, and
``ops.ring_attention.chunked_attention`` forward, gradients and memory).

Both sides run the unfused configuration: ``tensor_parallel=False``,
``scan_layers=False``, ``train()`` mode and ``FLAGS_fused_rmsnorm_residual``
off, set with each package's own ``set_flags`` for each test that
compares them and restored after (the fused carry, on by default, has
its own tests in tests/test_torch_fused_training.py). Weights are bridged
with ``convert.from_numpy_state_dict``; inputs are numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JCriterion
from paddle_tpu.nn import functional as JF

from chip_smoke import adam_first_step_limit
from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

LR, WD = 1e-3, 0.01


@pytest.fixture
def unfused():
    name = "FLAGS_fused_rmsnorm_residual"
    saved = [(reg, dict(reg._registry[name])) for reg in (flags, tflags)]
    for reg, _ in saved:
        reg.set_flags({name: False})
    yield
    for reg, ent in saved:
        reg._registry[name] = ent


def _models(tie):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.tie_word_embeddings = tie
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = LlamaConfig.tiny()
    tcfg.tie_word_embeddings = tie
    tm = convert.from_numpy_state_dict(LlamaForCausalLM(tcfg, device="cpu"),
                                       arrays)
    tm.train()
    return jm, tm


def _ids(seed, shape=(2, 33)):
    # 33 tokens: the attention sees a length that is no block multiple
    return np.random.RandomState(seed).randint(0, 256, shape)


def _jax_step(jm, ids):
    t = paddle.to_tensor(ids)
    logits, loss = jm(t, labels=t)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
             if p.grad is not None}
    return np.asarray(logits.numpy()), float(loss.numpy()), grads


def _port_step(tm, ids):
    t = torch.from_numpy(ids)
    logits, loss = tm(t, labels=t)
    loss.backward()
    return logits.detach().numpy(), loss.item(), convert.grads_to_numpy(tm)


def _jax_weights(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("tie", [False, True])
def test_labeled_forward_and_every_grad_match_jax(tie, unfused):
    jm, tm = _models(tie)
    ids = _ids(1)
    jl, jloss, jg = _jax_step(jm, ids)
    tl, tloss, tg = _port_step(tm, ids)
    # f32 through two layers; matmuls and softmax sum in another order
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("tie", [False, True])
def test_adamw_steps_match_jax(tie, unfused):
    jm, tm = _models(tie)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters(),
                                  weight_decay=WD)
    topt = AdamW(learning_rate=LR, parameters=tm.parameters(),
                 weight_decay=WD)
    w0 = _jax_weights(jm)
    near_zero = {}     # elements whose grad came near 0 at some step
    for step in range(3):
        ids = _ids(10 + step)
        _, jloss, jg = _jax_step(jm, ids)
        jopt.step()
        jopt.clear_grad()
        _, tloss, tg = _port_step(tm, ids)
        topt.step()
        topt.clear_grad()
        assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
        assert all(p.grad is None for p in tm.parameters())
        jw, tw = _jax_weights(jm), convert.to_numpy_state_dict(tm)
        for key in jw:
            lo = np.minimum(np.abs(jg[key]), np.abs(tg[key]))
            hi = np.maximum(np.abs(jg[key]), np.abs(tg[key]))
            small = (lo < 1e-5 * hi.max()) & (hi > 0)
            near_zero[key] = near_zero.get(key, False) | small
            if step == 0:
                # the first step moves a weight by lr*g/(|g| + eps): its
                # sensitivity to the grads' f32 noise, per element
                lim = adam_first_step_limit(jg[key], tg[key], w0[key], LR)
                assert (np.abs(tw[key] - jw[key]) <= lim).all(), key
            elif step == 2:
                # Adam divides each element's step by its own gradient
                # scale, so f32 noise on a grad near 0 may move that
                # element by up to 2 lr a step. The later grads are taken
                # at weights that already differ by the first steps'
                # noise, which that normalisation carries to about 1e-4
                # of lr (seen): every other element within 1e-3 of lr
                lim = np.where(near_zero[key], 2 * LR * 3,
                               1e-5 * np.abs(jw[key]) + 1e-3 * LR)
                assert (np.abs(tw[key] - jw[key]) <= lim).all(), key
                assert near_zero[key].mean() < 1e-2, key


def test_adamw_bf16_parameters_keep_f32_master_copies_like_jax():
    rng = np.random.RandomState(7)
    w0 = (0.1 * rng.randn(16, 8)).astype(np.float32)
    jp = paddle.create_parameter([16, 8], dtype="bfloat16")
    jp.set_data(jnp.asarray(w0, jnp.bfloat16))
    tp = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    jopt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=[jp],
                                  weight_decay=0.1, multi_precision=True)
    topt = AdamW(learning_rate=1e-2, parameters=[tp], weight_decay=0.1)
    for _ in range(3):
        g = rng.randn(16, 8).astype(np.float32)
        jp.grad = paddle.to_tensor(jnp.asarray(g, jnp.bfloat16))
        tp.grad = torch.from_numpy(g).to(torch.bfloat16)
        jopt.step()
        topt.step()
        jmaster = np.asarray(jopt._master_weights[id(jp)].numpy())
        tmaster = topt._master_weights[id(tp)]
        assert tmaster.dtype == torch.float32 and tp.dtype == torch.bfloat16
        # the same f32 update from the same bf16 grads
        np.testing.assert_allclose(tmaster.numpy(), jmaster, rtol=1e-6,
                                   atol=1e-8)
        # each parameter is its master rounded to bf16 (nearest even)
        assert torch.equal(tp.detach(), tmaster.to(torch.bfloat16))
        jw = np.asarray(jnp.asarray(jp.numpy(), jnp.float32))
        # f32 noise between the masters can flip a rounding: one ulp
        assert (np.abs(tp.detach().float().numpy() - jw)
                <= 2 ** -7 * np.abs(jw)).all()


def test_optimizer_needs_parameters():
    with pytest.raises(ValueError, match="parameters"):
        AdamW()


def test_pretraining_criterion_equals_the_labeled_loss():
    jm, tm = _models(False)
    ids = _ids(2)
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    crit = LlamaPretrainingCriterion(tm.config)
    assert torch.equal(crit(logits, torch.from_numpy(ids)), loss)
    jloss = JCriterion(jm.config)(paddle.to_tensor(logits.detach().numpy()),
                                  paddle.to_tensor(ids))
    # the same f32 log-softmax of the same logits
    assert abs(float(jloss.numpy()) - loss.item()) <= 1e-6 * loss.item()


def test_cross_entropy_with_ignored_rows_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(12, 50).astype(np.float32) * 3
    labels = rng.randint(0, 50, 12)
    labels[[2, 7]] = -100
    ours = TF.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    ref = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(labels))
    # f32 log-softmax on both sides
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref.numpy()),
                               rtol=1e-6, atol=1e-6)
    all_ignored = TF.cross_entropy(torch.from_numpy(logits),
                                   torch.full((12,), -100))
    assert all_ignored.item() == 0.0


@pytest.mark.parametrize("mask,sk", [(None, 20), ("bool", 20), (None, 28),
                                     ("add", 20)])
def test_attention_routing_matches_jax_functional(mask, sk):
    """Flash attention with no mask and equal lengths, the plain
    reference otherwise; both against the JAX functional (on the CPU its
    reference path)."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 20, 4, 16).astype(np.float32)
    k = rng.randn(2, sk, 2, 16).astype(np.float32)
    v = rng.randn(2, sk, 2, 16).astype(np.float32)
    m = None
    if mask == "bool":
        m = rng.rand(20, sk) > 0.3
        m[:, 0] = True
    elif mask == "add":
        m = rng.randn(20, sk).astype(np.float32)
    ours = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        attn_mask=None if m is None else torch.from_numpy(m),
        is_causal=True)
    ref = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)),
        attn_mask=None if m is None else paddle.to_tensor(m),
        is_causal=True)
    # f32; the softmax and products sum in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref.numpy()),
                               rtol=1e-5, atol=1e-5)


# ---- the plain ops of GPT-2, ERNIE and DeepSeek-V2 ---------------------------

@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax_to_the_bit_in_bf16(affine):
    """The JAX rule: f32 statistics, the normalised value rounded to bf16,
    then the affine (torch's layer_norm rounds once, after it: other
    bits). Same bf16 inputs give the JAX package's bits; f32 within
    1e-6."""
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 7, 64) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        args = [torch.from_numpy(a).to(dt) for a in (x, w, b)]
        jargs = [paddle.to_tensor(jnp.asarray(a, jdt)) for a in (x, w, b)]
        if not affine:
            args[1:] = jargs[1:] = [None, None]
        got = TF.layer_norm(args[0], 64, args[1], args[2], 1e-5)
        ref = JF.layer_norm(jargs[0], 64, jargs[1], jargs[2], 1e-5)
        assert got.dtype == dt
        ref = np.asarray(ref.numpy(), np.float32)
        if dt == torch.bfloat16:
            np.testing.assert_array_equal(got.float().numpy(), ref)
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6)


def test_layer_norm_layer_and_normalised_shape_of_two_dims():
    from paddle_tpu_torch.nn import LayerNorm
    x = np.random.RandomState(7).randn(3, 4, 5).astype(np.float32)
    ln = LayerNorm([4, 5], 1e-5, device="cpu")
    assert ln.weight.shape == (4, 5) and (ln.bias == 0).all()
    ref = JF.layer_norm(paddle.to_tensor(x), [4, 5], None, None, 1e-5)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref.numpy()), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_tanh_match_jax(approximate):
    """GELU's erf form (ERNIE) and tanh form (GPT-2) and tanh (ERNIE's
    pooler) in f32 against the JAX functions: within 1e-6 (two
    libraries' erf and tanh)."""
    x = np.random.RandomState(8).randn(257).astype(np.float32) * 4
    got = TF.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    ref = np.asarray(JF.gelu(paddle.to_tensor(x),
                             approximate=approximate).numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TF.tanh(torch.from_numpy(x)).numpy(),
                               np.tanh(x), rtol=1e-6, atol=1e-7)


def test_dropout_keeps_its_share_scales_and_follows_its_generator():
    """Dropout draws from the generator it is given (the JAX package's
    jax.random streams differ by design): a seeded generator repeats
    its mask; the kept share is 1 - p within 4 standard deviations and
    the kept values are x / (1 - p); eval mode and p = 0 are the
    identity."""
    from paddle_tpu_torch.nn import Dropout
    x = torch.ones(200, 500)
    p = 0.1
    a = TF.dropout(x, p, generator=torch.Generator().manual_seed(3))
    b = TF.dropout(x, p, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    sd = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(kept - (1 - p)) < 4 * sd
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / (1 - p)))
    layer = Dropout(p, torch.Generator().manual_seed(3))
    assert torch.equal(layer(x), a)
    layer.eval()
    assert layer(x) is x and TF.dropout(x, 0.0) is x


def _exact_mla(q, k, v, causal):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        logits = torch.where(mask, logits, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@pytest.mark.parametrize("causal,sk", [(True, 64), (True, 96),
                                       (False, 96), (True, 100),
                                       (False, 100), (False, 33)])
def test_chunked_attention_matches_jax_forward_and_grads(causal, sk):
    """tests/test_deepseek.py:106 on the port: blockwise online-softmax
    attention on MLA-shaped heads (Dqk 24, Dv 16), chunks of 32 with a
    ragged tail, against the JAX package's ``chunked_attention`` (f32,
    2e-5) and the port's own exact einsum; gradients against the JAX
    package's (2e-4, as the JAX test holds them)."""
    import jax
    from paddle_tpu.ops.ring_attention import \
        chunked_attention as jchunked
    from paddle_tpu_torch.ops.ring_attention import chunked_attention
    rng = np.random.RandomState(0)
    q = rng.randn(2, 64, 2, 24).astype(np.float32)
    k = rng.randn(2, sk, 2, 24).astype(np.float32)
    v = rng.randn(2, sk, 2, 16).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, causal=causal, chunk=32)
    ref = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, chunk=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    if sk >= 64:       # query i at position i, keys past the queries
        exact = _exact_mla(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal)
        np.testing.assert_allclose(out.detach().numpy(), exact.numpy(),
                                   rtol=2e-5, atol=2e-5)
    out.sum().backward()
    jg = jax.grad(lambda a, b, c: jchunked(a, b, c, causal=causal,
                                           chunk=32).sum(),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_chunked_attention_holds_no_full_score_tensor():
    """tests/test_deepseek.py:156 on the port: at S = 4096 a forward under
    no_grad never makes a [B, H, S, S] tensor (every op's output is
    recorded through a dispatch mode), while the exact einsum does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.ops.ring_attention import chunked_attention

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    S, H = 4096, 2
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, S, H, 24, generator=g)
    k = torch.randn(1, S, H, 24, generator=g)
    v = torch.randn(1, S, H, 16, generator=g)
    with torch.no_grad():
        with Largest() as chunked:
            chunked_attention(q, k, v, causal=True, chunk=256)
        with Largest() as exact:
            _exact_mla(q[:, :1024], k[:, :1024], v[:, :1024], True)
    assert exact.numel >= 1024 * 1024 * H
    assert chunked.numel <= S * 256 * H, chunked.numel
