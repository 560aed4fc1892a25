"""The port's AMP against the JAX package's, on the CPU: ``auto_cast`` at
O1 (matmul operands in bf16, every other op in the dtype it is given),
``decorate`` at O2, and the ``GradScaler``'s scale, skip and grow/shrink
sequence.

O1 runs the tiny Llama (f32 parameters, bf16 matmuls) from the same
weights on both sides, with the fused residual carry and without. XLA
and torch round a bf16 product's f32 sum in their own order and the
activations differ by about one bf16 ulp, which the layers carry: the
loss is held within 1e-4 relative and each gradient within 2e-2 of its
norm (seen: 1.2e-5 and 8.2e-3). On random weights that is about what
running the matmuls in f32 changes, so the logits must also lie nearer
JAX's O1 logits than the port's f32 logits do (seen: a mean gap of
3.3e-4 against 5.3e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)

torch.set_num_threads(1)


@pytest.fixture(params=[False, True], ids=["unfused", "fused_carry"])
def carry(request):
    name = "FLAGS_fused_rmsnorm_residual"
    saved = [(reg, dict(reg._registry[name])) for reg in (flags, tflags)]
    for reg, _ in saved:
        reg.set_flags({name: request.param})
    yield request.param
    for reg, ent in saved:
        reg._registry[name] = ent


def _models(tie=False):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.tie_word_embeddings = tie
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = LlamaConfig.tiny()
    tcfg.scan_layers = False
    tcfg.tie_word_embeddings = tie
    tm = convert.from_numpy_state_dict(LlamaForCausalLM(tcfg, device="cpu"),
                                       arrays)
    tm.train()
    return jm, tm


IDS = np.random.RandomState(3).randint(0, 256, (2, 33))


def _jax_o1(jm):
    t = paddle.to_tensor(IDS)
    with paddle.amp.auto_cast(enable=True, level="O1"):
        logits, loss = jm(t, labels=t)
    loss.backward()
    grads = {n: np.asarray(jnp.asarray(p.grad.numpy(), jnp.float32))
             for n, p in jm.named_parameters() if p.grad is not None}
    return logits, float(loss.numpy()), grads


def _port_o1(tm, enable=True):
    t = torch.from_numpy(IDS)
    with tamp.auto_cast(enable=enable, level="O1"):
        logits, loss = tm(t, labels=t)
    loss.backward()
    return logits, loss.item(), convert.grads_to_numpy(tm)


@pytest.mark.parametrize("tie", [False, True])
def test_o1_loss_and_grads_match_jax(carry, tie):
    jm, tm = _models(tie)
    jlogits, jloss, jg = _jax_o1(jm)
    tlogits, tloss, tg = _port_o1(tm)
    # the matmul outputs are bf16 on both sides; the params stay f32
    assert str(jlogits.dtype) == "bfloat16"
    assert tlogits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss)
    assert set(tg) == set(jg)
    for k in jg:
        err = np.linalg.norm(tg[k] - jg[k])
        assert err <= 2e-2 * np.linalg.norm(jg[k]) + 1e-6, (k, err)
    # the port's O1 logits lie nearer JAX's O1 logits than its f32 ones
    _, tm32 = _models(tie)
    f32_logits, _, _ = _port_o1(tm32, enable=False)
    j = np.asarray(jnp.asarray(jlogits.numpy(), jnp.float32))
    gap_o1 = np.abs(tlogits.detach().float().numpy() - j).mean()
    gap_f32 = np.abs(f32_logits.detach().numpy() - j).mean()
    assert gap_o1 < 0.8 * gap_f32, (gap_o1, gap_f32)


def test_o1_casts_only_the_matmul_operands():
    lin = torch.nn.Linear(4, 3)
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn import functional as F
    layer = Linear(4, 3)
    layer.load_state_dict(lin.state_dict())
    with tamp.auto_cast():
        y = layer(x)
        soft = torch.softmax(x, -1)
        q = torch.randn(1, 5, 2, 8)
        out = F.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert y.dtype == torch.bfloat16 and soft.dtype == torch.float32
    assert out.dtype == torch.bfloat16
    want = torch.nn.functional.linear(x.bfloat16(), lin.weight.bfloat16(),
                                      lin.bias.bfloat16())
    assert torch.equal(y, want)
    assert layer(x).dtype == torch.float32       # off outside the scope
    assert not tamp.is_auto_cast_enabled()
    with tamp.amp_guard(enable=True, dtype="float16"):
        assert layer(x).dtype == torch.float16


def test_o2_decorate_keeps_the_parameter_objects():
    jm, tm = _models()
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    before = list(tm.parameters())
    m = Model(tm)
    m.prepare(opt, LlamaPretrainingCriterion(tm.config), amp_configs="O2")
    assert m.network is tm
    assert all(a is b for a, b in zip(tm.parameters(), before))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(p is q for p, q in zip(opt._parameter_list, before))
    assert tm.llama.rope_sin.dtype == torch.float32     # buffers stay
    # the JAX package's O2 casts its parameters the same way
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    jmodel = paddle.Model(jm)
    jmodel.prepare(jopt, None, amp_configs="O2")
    assert all(str(p.dtype) == "bfloat16" for p in jm.parameters())
    ids = torch.from_numpy(IDS)
    loss = m.train_batch([ids], ids)[0]
    assert np.isfinite(loss)
    assert len(opt._master_weights) == len(before)
    assert all(w.dtype == torch.float32
               for w in opt._master_weights.values())


def test_train_batch_o1_matches_jax(carry):
    jm, tm = _models()
    jmodel = paddle.Model(jm)
    jmodel.prepare(paddle.optimizer.SGD(0.1, parameters=jm.parameters()),
                   paddle.models.llama.LlamaPretrainingCriterion(jm.config),
                   amp_configs="O1")
    tmodel = Model(tm)
    tmodel.prepare(topt.SGD(0.1, parameters=tm.parameters()),
                   LlamaPretrainingCriterion(tm.config), amp_configs="O1")
    for _ in range(2):
        jl = jmodel.train_batch([paddle.to_tensor(IDS)],
                                paddle.to_tensor(IDS))[0]
        tl = tmodel.train_batch([torch.from_numpy(IDS)],
                                torch.from_numpy(IDS))[0]
        assert abs(tl - jl) <= 1e-4 * abs(jl)


def test_bad_level_is_refused():
    m = Model(torch.nn.Linear(2, 1))
    with pytest.raises(ValueError, match="O0/O1/O2"):
        m.prepare(amp_configs="O7")


def test_support_queries():
    assert tamp.is_bfloat16_supported()
    assert tamp.is_float16_supported("cuda")
    assert not tamp.is_float16_supported("cpu")


# ---- GradScaler -------------------------------------------------------------

# per step: the grad of parameter 0 holds an inf (True) or not
PATTERN = [False, False, False, True, False, True, True, False, False, False,
           False, True]


def _scaler_run(mod_opt, mod_amp, make_param, set_grad, read):
    p = make_param()
    opt = mod_opt.SGD(0.1, parameters=[p])
    scaler = mod_amp.GradScaler(init_loss_scaling=1024.0,
                                incr_every_n_steps=3,
                                decr_every_n_nan_or_inf=2)
    trace = []
    for i, bad in enumerate(PATTERN):
        before = read(p).copy()
        g = np.full((4,), 1024.0 * (i + 1), np.float32)
        if bad:
            g[1] = np.inf
        set_grad(p, g)
        scaler.step(opt)
        after = read(p)
        skipped = np.array_equal(before, after)
        trace.append((scaler.get_loss_scaling(), skipped,
                      scaler.state_dict()["incr_count"],
                      scaler.state_dict()["decr_count"]))
        opt.clear_grad()
    return trace, read(p)


def test_grad_scaler_sequence_equals_jax():
    def jparam():
        p = paddle.create_parameter([4], dtype="float32")
        p.set_data(jnp.zeros((4,), jnp.float32))
        return p

    def jset(p, g):
        p.grad = paddle.to_tensor(g)

    jtrace, jw = _scaler_run(paddle.optimizer, paddle.amp, jparam, jset,
                             lambda p: np.asarray(p.numpy()))

    def tset(p, g):
        p.grad = torch.from_numpy(g)

    ttrace, tw = _scaler_run(topt, tamp,
                             lambda: torch.nn.Parameter(torch.zeros(4)),
                             tset, lambda p: p.detach().numpy())
    assert ttrace == jtrace
    assert [s for _, s, _, _ in ttrace] == PATTERN   # skipped iff an inf
    np.testing.assert_array_equal(tw, jw)


def test_grad_scaler_scales_and_unscales_once():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(1.0, parameters=[p])
    scaler = tamp.GradScaler(init_loss_scaling=8.0)
    loss = (p * torch.tensor([1.0, 2.0, 3.0])).sum()
    scaler.scale(loss).backward()
    assert torch.equal(p.grad, torch.tensor([8.0, 16.0, 24.0]))
    scaler.unscale_(opt)
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    with pytest.raises(RuntimeError, match="double-unscale"):
        scaler.unscale_(opt)
    scaler.step(opt)          # must not unscale a second time
    assert torch.equal(p.detach(), torch.tensor([0.0, -1.0, -2.0]))
    state = scaler.state_dict()
    fresh = tamp.AmpScaler()
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state


def test_model_steps_through_the_scaler():
    net = torch.nn.Linear(4, 1)
    m = Model(net)
    scaler = tamp.GradScaler(init_loss_scaling=4.0)
    m.prepare(topt.SGD(0.1, parameters=net.parameters()),
              torch.nn.MSELoss(), scaler=scaler)
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    y = torch.randn(8, 1, generator=torch.Generator().manual_seed(1))
    w0 = net.weight.detach().clone()
    m.train_batch([x], y)
    assert not torch.equal(net.weight, w0)
    assert scaler.state_dict()["incr_count"] == 1
