"""The port's LR schedulers and gradient clips against the JAX package's.

Every scheduler's sequence over 50 steps must equal the JAX package's to
the bit (both are the same Python arithmetic), its state dict too, and a
fresh scheduler restored from the state dict at step 20 must continue
the uninterrupted sequence. The clips take the same f32 grads (numpy,
seeded) and must give the JAX package's within 1e-6 relative (the norms
sum in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.optimizer import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr


def _lam(e):
    return 0.95 ** e


def _mult(e):
    return 0.9 if e % 3 else 1.0


def _cycle_scale(x):
    return 1.0 / (1.0 + x)


# (class name, args, kwargs): all 17 schedulers, LinearWarmup twice
SCHEDULERS = [
    ("NoamDecay", (64, 10), dict(learning_rate=2.0)),
    ("ExponentialDecay", (0.5, 0.9), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.5, 20), dict(end_lr=0.01, power=2.0)),
    ("PolynomialDecay", (0.5, 7), dict(cycle=True)),
    ("LinearWarmup", (0.3, 10, 0.0, 0.3), {}),
    ("PiecewiseDecay", ([5, 15, 30], [1.0, 0.5, 0.1, 0.01]), {}),
    ("CosineAnnealingDecay", (0.3, 40), dict(eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", (0.3, 5), dict(T_mult=2,
                                                   eta_min=0.001)),
    ("StepDecay", (0.5, 7), dict(gamma=0.5)),
    ("MultiStepDecay", (0.5, [3, 10, 30]), dict(gamma=0.3)),
    ("LambdaDecay", (0.5, _lam), {}),
    ("MultiplicativeDecay", (0.5, _mult), {}),
    ("LinearLR", (0.5, 30), dict(start_factor=0.1, end_factor=0.9)),
    ("ReduceOnPlateau", (0.5,), dict(patience=2, factor=0.5, cooldown=1)),
    ("OneCycleLR", (0.5, 45), dict(phase_pct=0.25)),
    ("OneCycleLR", (0.5, 45), dict(anneal_strategy="linear")),
    ("CyclicLR", (0.01, 0.2), dict(step_size_up=6, step_size_down=4,
                                   mode="triangular2")),
    ("CyclicLR", (0.01, 0.2), dict(step_size_up=5, mode="exp_range",
                                   exp_gamma=0.97)),
    ("CyclicLR", (0.01, 0.2), dict(step_size_up=5, scale_fn=_cycle_scale)),
]

ALL_17 = {"NoamDecay", "ExponentialDecay", "NaturalExpDecay",
          "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
          "PiecewiseDecay", "CosineAnnealingDecay",
          "CosineAnnealingWarmRestarts", "StepDecay", "MultiStepDecay",
          "LambdaDecay", "MultiplicativeDecay", "LinearLR",
          "ReduceOnPlateau", "OneCycleLR", "CyclicLR"}

# ReduceOnPlateau's metric: falls, then plateaus, then falls again
METRICS = [1.0 / (1 + i) if i < 8 or i > 30 else 0.11 for i in range(50)]


def _make(mod, name, args, kw):
    return getattr(mod, name)(*args, **kw)


def _run(s, steps=50, start=0):
    out = []
    for i in range(start, start + steps):
        if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            s.step(METRICS[i])
        else:
            s.step()
        out.append(s())
    return out


def test_the_list_names_all_seventeen():
    assert {n for n, _, _ in SCHEDULERS} == ALL_17
    assert set(tlr.__all__) - {"LRScheduler"} == ALL_17


@pytest.mark.parametrize("name,args,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SCHEDULERS)])
def test_sequence_and_state_dict_equal_jax(name, args, kw):
    js, ts = _make(jlr, name, args, kw), _make(tlr, name, args, kw)
    assert ts() == js()
    jseq, tseq = _run(js), _run(ts)
    assert tseq == jseq      # the same Python arithmetic: to the bit
    assert ts.state_dict() == js.state_dict()


@pytest.mark.parametrize("name,args,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SCHEDULERS)])
def test_state_dict_round_trip_continues_the_sequence(name, args, kw):
    whole = _run(_make(tlr, name, args, kw))
    first = _make(tlr, name, args, kw)
    _run(first, 20)
    state = first.state_dict()
    fresh = _make(tlr, name, args, kw)
    fresh.set_state_dict(dict(state))
    assert _run(fresh, 30, start=20) == whole[20:]


def test_warmup_over_a_scheduler_equals_jax_and_resumes():
    """LinearWarmup(CosineAnnealingDecay): the sequence is the JAX
    package's; restored at step 20 (past the warm-up) the port continues
    it, where the JAX package restarts the inner schedule (its state
    dict holds the outer scheduler's plain values only)."""
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, T_max=40),
                                warmup_steps=10, start_lr=0.0, end_lr=3e-4)
    js, ts = make(jlr), make(tlr)
    jseq, tseq = _run(js), _run(ts)
    assert tseq == jseq
    first = make(tlr)
    _run(first, 20)
    fresh = make(tlr)
    fresh.set_state_dict(first.state_dict())
    assert _run(fresh, 30, start=20) == tseq[20:]
    jfirst = make(jlr)
    _run(jfirst, 20)
    jfresh = make(jlr)
    jfresh.set_state_dict(jfirst.state_dict())
    assert _run(jfresh, 30, start=20) != jseq[20:]


@pytest.mark.parametrize("at", [5, 10, 20])
def test_warmup_state_written_by_jax_resumes_in_the_port(at):
    """A LinearWarmup(CosineAnnealingDecay) state the JAX package wrote
    (before, at and past the end of the warm-up), restored in the port,
    alone and as an optimizer's ``LR_Scheduler``, continues the
    uninterrupted sequence to the bit."""
    from paddle_tpu_torch.optimizer import AdamW

    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, T_max=40),
                                warmup_steps=10, start_lr=0.0, end_lr=3e-4)
    whole = _run(make(jlr))
    jfirst = make(jlr)
    _run(jfirst, at)
    state = jfirst.state_dict()
    fresh = make(tlr)
    fresh.set_state_dict(dict(state))
    assert _run(fresh, 50 - at, start=at) == whole[at:]
    sched = make(tlr)
    opt = AdamW(learning_rate=sched,
                parameters=[torch.nn.Parameter(torch.zeros(2))])
    opt.set_state_dict({"LR_Scheduler": dict(state)})
    rates = []
    for _ in range(50 - at):
        sched.step()
        rates.append(opt.get_lr())
    assert rates == whole[at:]


def test_reduce_on_plateau_takes_a_tensor_metric():
    s = tlr.ReduceOnPlateau(0.5, patience=0)
    s.step(torch.tensor(1.0))
    s.step(torch.tensor(2.0))
    assert s() == 0.05


# ---- clips -----------------------------------------------------------------

SHAPES = [(16, 8), (8,), (4, 4, 3), (1,)]


def _grads(seed, scale):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


def _jax_clip(clip, grads):
    pgs = [(None, paddle.to_tensor(g)) for g in grads] + [(None, None)]
    return [None if g is None else np.asarray(g.numpy())
            for _, g in clip(pgs)]


def _port_clip(clip, grads):
    pgs = [(None, torch.from_numpy(g.copy())) for g in grads] + \
        [(None, None)]
    return [None if g is None else g.numpy() for _, g in clip(pgs)]


CLIPS = [("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (50.0,)),
         ("ClipGradByNorm", (0.5,)), ("ClipGradByValue", (0.3,)),
         ("ClipGradByValue", (0.3, -0.1))]


@pytest.mark.parametrize("scale", [0.1, 3.0])
@pytest.mark.parametrize("name,args", CLIPS)
def test_clips_equal_jax(name, args, scale):
    grads = _grads(1, scale)
    jout = _jax_clip(getattr(jclip, name)(*args), grads)
    tout = _port_clip(getattr(tclip, name)(*args), grads)
    assert tout[-1] is None and jout[-1] is None
    for t, j in zip(tout[:-1], jout[:-1]):
        assert t.dtype == np.float32
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)


def test_global_norm_clip_keeps_a_bf16_grad_bf16():
    g = torch.randn(8, 8).to(torch.bfloat16)
    (_, out), = tclip.ClipGradByGlobalNorm(0.1)([(None, g)])
    assert out.dtype == torch.bfloat16
    want = (g.float() * (0.1 / g.float().norm())).to(torch.bfloat16)
    assert torch.equal(out, want)


def test_nn_reexports_the_clips():
    assert tnn.ClipGradByGlobalNorm is tclip.ClipGradByGlobalNorm
    assert tnn.ClipGradByNorm is tclip.ClipGradByNorm
    assert tnn.ClipGradByValue is tclip.ClipGradByValue


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm_in_place_equals_jax(norm_type, max_norm):
    grads = _grads(2, 1.0)
    jps, tps = [], []
    for g in grads:
        jp = paddle.create_parameter(list(g.shape), dtype="float32")
        jp.grad = paddle.to_tensor(g)
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g.copy())
        tps.append(tp)
    jt = jclip.clip_grad_norm_(jps, max_norm, norm_type)
    tt = tclip.clip_grad_norm_(tps, max_norm, norm_type)
    np.testing.assert_allclose(tt.item(), float(jt.numpy()), rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad.numpy()), rtol=1e-6,
                                   atol=1e-9)


def test_clip_grad_value_in_place_equals_jax():
    g = _grads(3, 1.0)[0]
    jp = paddle.create_parameter(list(g.shape), dtype="float32")
    jp.grad = paddle.to_tensor(jnp.asarray(g))
    tp = torch.nn.Parameter(torch.zeros(g.shape))
    tp.grad = torch.from_numpy(g.copy())
    jclip.clip_grad_value_([jp], 0.25)
    tclip.clip_grad_value_([tp], 0.25)
    np.testing.assert_array_equal(tp.grad.numpy(),
                                  np.asarray(jp.grad.numpy()))
