"""The port's optimizers against the JAX package's, on the CPU.

Each optimizer takes k steps from the same f32 weights with the same
grads (numpy, seeded) on both sides; the weights and every state-dict
value must agree within rtol 1e-5 / atol 1e-6 (f32 arithmetic in
another order: the port's Adam moves the bias corrections onto the
scalars), the state-dict keys exactly. Then the decays, AdamW's
``apply_decay_param_fun``/``lr_ratio``, ``multi_precision=False``,
parameter groups, ``set_state_dict`` before the first step, and a run
that JAX starts and both packages continue through ``convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

SHAPES = [(6, 4), (4,), (3, 5)]
RTOL, ATOL = 1e-5, 1e-6


def _params(seed=0, dtype="float32"):
    rng = np.random.RandomState(seed)
    w0 = [(0.5 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    jps = []
    for w in w0:
        p = paddle.create_parameter(list(w.shape), dtype=dtype)
        p.set_data(jnp.asarray(w, getattr(jnp, dtype)))
        jps.append(p)
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(
        getattr(torch, dtype))) for w in w0]
    return jps, tps


def _set_grads(jps, tps, seed):
    rng = np.random.RandomState(100 + seed)
    for jp, tp in zip(jps, tps):
        g = rng.randn(*tp.shape).astype(np.float32)
        jp.grad = paddle.to_tensor(jnp.asarray(g, jp.dtype))
        tp.grad = torch.from_numpy(g).to(tp.dtype)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v.numpy(), jnp.float32))


def _assert_states_equal(jstate, tstate):
    assert set(tstate) == set(jstate)
    for k, jv in jstate.items():
        tv = tstate[k]
        if k in ("@step", "LR_Scheduler"):
            assert tv == jv, k
        else:
            np.testing.assert_allclose(_np(tv), _np(jv), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def _steps(jopt, topt_, jps, tps, k, closure=False):
    for i in range(k):
        _set_grads(jps, tps, i)
        if closure:
            jopt.step(lambda: None)
            topt_.step(lambda: None)
        else:
            jopt.step()
            topt_.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(_np(tp), _np(jp), rtol=RTOL, atol=ATOL)
    _assert_states_equal(jopt.state_dict(), topt_.state_dict())


OPTIMIZERS = [
    ("SGD", dict(learning_rate=0.1), 3),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9), 3),
    ("Momentum", dict(learning_rate=0.1, momentum=0.8, use_nesterov=True,
                      weight_decay=0.01), 3),
    ("Adam", dict(learning_rate=0.01), 3),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.1, beta1=0.8,
                  epsilon=1e-6), 3),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.05), 3),
    ("Adamax", dict(learning_rate=0.01, weight_decay=0.01), 3),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1), 3),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9), 3),
    ("RMSProp", dict(learning_rate=0.01), 3),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.9, centered=True), 3),
    ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01), 3),
    ("LBFGS", dict(learning_rate=0.1), 3),
    ("Rprop", dict(learning_rate=0.01), 4),
    ("ASGD", dict(learning_rate=0.1, batch_num=2), 3),
    ("NAdam", dict(learning_rate=0.01), 3),
    ("RAdam", dict(learning_rate=0.01), 8),     # past rho_t > 5 at step 6
]


@pytest.mark.parametrize("name,kw,k", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(OPTIMIZERS)])
def test_steps_and_state_equal_jax(name, kw, k):
    jps, tps = _params()
    jopt = getattr(paddle.optimizer, name)(parameters=jps, **kw)
    topt_ = getattr(topt, name)(parameters=tps, **kw)
    _steps(jopt, topt_, jps, tps, k, closure=name == "LBFGS")


@pytest.mark.parametrize("decay", ["float", "l1", "l2", "per_param"])
def test_sgd_weight_decay_equals_jax(decay):
    jps, tps = _params(1)
    if decay == "float":
        jwd = twd = 0.1
    elif decay == "l1":
        jwd, twd = paddle.regularizer.L1Decay(0.2), treg.L1Decay(0.2)
    elif decay == "l2":
        jwd, twd = paddle.regularizer.L2Decay(0.3), treg.L2Decay(0.3)
    else:
        # a parameter's own regularizer takes precedence over the float
        jwd = twd = 0.1
        jps[0].regularizer = paddle.regularizer.L1Decay(0.5)
        tps[0].regularizer = treg.L1Decay(0.5)
    jopt = paddle.optimizer.SGD(0.1, parameters=jps, weight_decay=jwd)
    topt_ = topt.SGD(0.1, parameters=tps, weight_decay=twd)
    _steps(jopt, topt_, jps, tps, 3)


def test_adamw_decay_selection_and_lr_ratio_equal_jax():
    jps, tps = _params(2)
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        name = f"w{i}_norm" if len(tp.shape) == 1 else f"w{i}"
        jp.name = tp.param_name = name

    def decay_fn(name):
        return not name.endswith("_norm")

    def ratio(p):
        return 0.5 if len(p.shape) == 1 else 1.0
    kw = dict(learning_rate=0.02, weight_decay=0.3,
              apply_decay_param_fun=decay_fn, lr_ratio=ratio)
    jopt = paddle.optimizer.AdamW(parameters=jps, **kw)
    topt_ = topt.AdamW(parameters=tps, **kw)
    _steps(jopt, topt_, jps, tps, 3)
    assert "w1_norm_moment1" in topt_.state_dict()


def test_adamw_decays_every_unnamed_parameter_like_jax():
    """A parameter without a name gives ``""`` to the function."""
    seen = []
    jps, tps = _params(3)
    opt = topt.AdamW(0.01, parameters=tps,
                     apply_decay_param_fun=lambda n: seen.append(n) or True)
    _set_grads(jps, tps, 0)
    opt.step()
    assert seen == ["", "", ""]


@pytest.mark.parametrize("name", ["AdamW", "Adam", "Momentum", "SGD"])
def test_bf16_without_multi_precision_equals_jax(name):
    """No master copy: the update in f32, rounded once into the bf16
    parameter; one bf16 ulp for f32 noise across a rounding."""
    jps, tps = _params(4, "bfloat16")
    kw = dict(learning_rate=0.05)
    jopt = getattr(paddle.optimizer, name)(parameters=jps, **kw)
    topt_ = getattr(topt, name)(parameters=tps, **kw)
    topt_._multi_precision = jopt._multi_precision = False
    for i in range(3):
        _set_grads(jps, tps, i)
        jopt.step()
        topt_.step()
    assert topt_._master_weights == {}
    for jp, tp in zip(jps, tps):
        assert tp.dtype == torch.bfloat16
        jw = _np(jp)
        assert (np.abs(_np(tp) - jw) <= 2 ** -7 * np.abs(jw) + 1e-6).all()


def test_adamw_multi_precision_flag_is_honoured():
    _, tps = _params(5, "bfloat16")
    opt = topt.AdamW(0.01, parameters=tps, multi_precision=False)
    for p in tps:
        p.grad = torch.ones_like(p)
    opt.step()
    assert opt._master_weights == {}
    _, tps = _params(5, "bfloat16")
    opt = topt.AdamW(0.01, parameters=tps)
    for p in tps:
        p.grad = torch.ones_like(p)
    opt.step()
    assert len(opt._master_weights) == 3
    assert all(k.endswith("_master") for k in opt.state_dict()
               if k.startswith("param_") and "moment" not in k
               and "pow" not in k)


def test_parameter_groups_flatten_like_jax():
    jps, tps = _params(6)
    jopt = paddle.optimizer.Adam(0.01, parameters=[
        {"params": jps[:2]}, {"params": jps[2:], "learning_rate": 0.5}])
    topt_ = topt.Adam(0.01, parameters=[
        {"params": tps[:2]}, {"params": tps[2:], "learning_rate": 0.5}])
    assert topt_._parameter_list == tps
    _steps(jopt, topt_, jps, tps, 2)


def test_set_state_dict_before_the_first_step():
    """A fresh optimizer restored before any step continues bit for bit,
    the scheduler and the count included."""
    _, a = _params(7)
    sched = topt.lr.StepDecay(0.01, 2, gamma=0.5)
    first = topt.AdamW(sched, parameters=a, weight_decay=0.1)
    rng = np.random.RandomState(0)
    grads = [[torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in SHAPES] for _ in range(4)]

    def step(opt, params, sched, g):
        for p, gi in zip(params, g):
            p.grad = gi.clone()
        opt.step()
        sched.step()

    for g in grads[:2]:
        step(first, a, sched, g)
    state = first.state_dict()
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    sched_b = topt.lr.StepDecay(0.01, 2, gamma=0.5)
    second = topt.AdamW(sched_b, parameters=b, weight_decay=0.1)
    second.set_state_dict(state)
    assert second._step_count == 2 and sched_b() == sched()
    for g in grads[2:]:
        step(first, a, sched, g)     # the source keeps stepping: the
        step(second, b, sched_b, g)  # restored copy must not follow it
    for pa, pb in zip(a, b):
        assert torch.equal(pa, pb)
    assert set(second.state_dict()) == set(first.state_dict())


def test_set_state_dict_after_steps_overwrites_the_slots():
    _, a = _params(8)
    _, b = _params(9)
    oa, ob = topt.Momentum(0.1, parameters=a), topt.Momentum(0.1,
                                                            parameters=b)
    for opt, ps in ((oa, a), (ob, b)):
        for p in ps:
            p.grad = torch.ones_like(p)
        opt.step()
    oa.state_dict()["param_0_velocity"].fill_(3.0)
    ob.set_state_dict(oa.state_dict())
    assert torch.equal(ob.state_dict()["param_0_velocity"],
                       torch.full(SHAPES[0], 3.0))


# ---- a Llama run across packages -------------------------------------------

@pytest.fixture
def unfused():
    name = "FLAGS_fused_rmsnorm_residual"
    saved = [(reg, dict(reg._registry[name])) for reg in (flags, tflags)]
    for reg, _ in saved:
        reg.set_flags({name: False})
    yield
    for reg, ent in saved:
        reg._registry[name] = ent


def _jax_llama():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    return jm


def _ids(step):
    return np.random.RandomState(50 + step).randint(0, 256, (2, 17))


def _jax_opt(jm):
    sched = paddle.optimizer.lr.LinearWarmup(1e-2, 2, 0.0, 1e-2)
    return paddle.optimizer.AdamW(
        learning_rate=sched, parameters=jm.parameters(), weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)), sched


def _port_opt(tm):
    sched = topt.lr.LinearWarmup(1e-2, 2, 0.0, 1e-2)
    return topt.AdamW(learning_rate=sched, parameters=tm.parameters(),
                      weight_decay=0.01,
                      grad_clip=topt.ClipGradByGlobalNorm(1.0)), sched


def _jax_step(jm, opt, sched, ids):
    t = paddle.to_tensor(ids)
    _, loss = jm(t, labels=t)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return float(loss.numpy())


def _port_step(tm, opt, sched, ids):
    t = torch.from_numpy(ids)
    _, loss = tm(t, labels=t)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss.item()


def test_llama_state_dict_keys_equal_jax(unfused):
    jm = _jax_llama()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    jopt, jsched = _jax_opt(jm)
    tpt, tsched = _port_opt(tm)
    _jax_step(jm, jopt, jsched, _ids(0))
    _port_step(tm, tpt, tsched, _ids(0))
    js, ts = jopt.state_dict(), tpt.state_dict()
    assert set(ts) == set(js)
    assert ts["LR_Scheduler"] == js["LR_Scheduler"]
    assert ts["@step"] == js["@step"] == 1
    names = [n for n, _ in jm.named_parameters()]
    assert names == [n for n, _ in tm.named_parameters()]


def test_cross_package_resume_through_convert(unfused):
    """JAX trains 3 steps; its weights and optimizer state (scheduler
    included) cross through ``convert``; both continue 3 steps on the
    same batches. f32 on both sides: losses within 1e-5 relative."""
    jm = _jax_llama()
    jopt, jsched = _jax_opt(jm)
    for s in range(3):
        _jax_step(jm, jopt, jsched, _ids(s))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jstate = {k: (v if k in ("@step", "LR_Scheduler")
                  else np.asarray(v.numpy()))
              for k, v in jopt.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    tm.train()
    tpt, tsched = _port_opt(tm)
    state = convert.from_numpy_optimizer_state(tm, jstate)
    tpt.set_state_dict(state)
    assert tsched() == jsched() and tpt._step_count == 3
    # the bridge inverts: back to the JAX layout
    back = convert.to_numpy_optimizer_state(tm, state)
    assert set(back) == set(jstate)
    for k, v in jstate.items():
        if k not in ("@step", "LR_Scheduler"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    for s in range(3, 6):
        jl = _jax_step(jm, jopt, jsched, _ids(s))
        tl = _port_step(tm, tpt, tsched, _ids(s))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (s, tl, jl)
    tw = convert.to_numpy_state_dict(tm)
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(tw[k], np.asarray(v.numpy()), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
