"""The port's fused training path against the JAX package, on the CPU:
the fused residual carry, recompute (``full`` and ``core_attn``, the
``dots_saveable`` and ``nothing_saveable`` policies), the fused
linear+CE branch of the labelled forward, ``hapi.Model.fit`` with the
port's SGD and DataLoader, and the flags they read.

Both sides run ``LlamaConfig.tiny()`` in f32 with the same weights
(bridged with ``convert.from_numpy_state_dict``) on numpy inputs from a
seed. The JAX side runs ``tensor_parallel=False``, ``scan_layers=False``
(the port's stack is always unrolled), ``train()`` mode, with
``FLAGS_fused_rmsnorm_residual`` on, its default. Each test that sets a
flag on either side restores it.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JCriterion

from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(1)

FLAG_NAMES = ("FLAGS_fused_rmsnorm_residual",
              "FLAGS_fused_linear_cross_entropy", "FLAGS_fused_ce_chunk_v",
              "FLAGS_recompute_policy")


@pytest.fixture
def flag_guard():
    """Snapshot and restore the flags (value and source) of both
    packages."""
    saved = [(reg, n, dict(reg._registry[n])) for reg in (jflags, tflags)
             for n in FLAG_NAMES]
    yield
    for reg, n, ent in saved:
        reg._registry[n] = ent


def _set(**values):
    """Set flags on both sides (names without the FLAGS_ prefix)."""
    for reg in (jflags, tflags):
        reg.set_flags({f"FLAGS_{k}": v for k, v in values.items()})


def _models(tie=False, **cfg_kw):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.tie_word_embeddings = tie
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.train()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = LlamaConfig.tiny()
    tcfg.tie_word_embeddings = tie
    for k, v in cfg_kw.items():
        setattr(tcfg, k, v)
    tm = convert.from_numpy_state_dict(LlamaForCausalLM(tcfg, device="cpu"),
                                       arrays)
    tm.train()
    return jm, tm


def _ids(seed, shape=(2, 33)):
    # 33 tokens: the attention sees a length that is no block multiple
    return np.random.RandomState(seed).randint(0, 256, shape)


def _jax_step(jm, ids):
    t = paddle.to_tensor(ids)
    _, loss = jm(t, labels=t)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
             if p.grad is not None}
    return float(loss.numpy()), grads


def _port_step(tm, ids):
    t = torch.from_numpy(ids)
    _, loss = tm(t, labels=t)
    loss.backward()
    grads = convert.grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads


def _match(tm, tloss, tg, jloss, jg):
    # f32 through two layers; matmuls and softmax sum in another order
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


# ---- the fused residual carry -----------------------------------------------

@pytest.mark.parametrize("tie", [False, True])
def test_fused_carry_matches_jax_and_the_unfused_stack(tie, flag_guard):
    _set(fused_rmsnorm_residual=True)
    jm, tm = _models(tie)
    ids = _ids(1)
    jloss, jg = _jax_step(jm, ids)
    tloss, tg = _port_step(tm, ids)
    _match(tm, tloss, tg, jloss, jg)
    # the carry adds where the unfused stack adds, in the same dtype:
    # the same loss bit for bit
    tflags.set_flags({"FLAGS_fused_rmsnorm_residual": False})
    uloss, ug = _port_step(tm, ids)
    assert uloss == tloss
    for key in tg:
        np.testing.assert_allclose(ug[key], tg[key], rtol=1e-6, atol=1e-9)


def test_fused_carry_runs_the_residual_function_per_pair(flag_guard,
                                                         monkeypatch):
    """2 layers: layer 0's input norm is plain, then 3 fused pairs (the
    post-attention norms and layer 1's input norm) and the final norm."""
    _, tm = _models()
    calls = []
    real = tllama.F.fused_rms_norm_residual
    monkeypatch.setattr(tllama.F, "fused_rms_norm_residual",
                        lambda *a: calls.append(1) or real(*a))
    t = torch.from_numpy(_ids(2))
    tm(t, labels=t)
    assert len(calls) == 2 * tm.config.num_hidden_layers


# ---- recompute --------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("gran", ["full", "core_attn"])
def test_recompute_matches_jax(gran, fused, flag_guard):
    _set(fused_rmsnorm_residual=fused)
    jm, tm = _models(use_recompute=True, recompute_granularity=gran)
    ids = _ids(3)
    jloss, jg = _jax_step(jm, ids)
    tloss, tg = _port_step(tm, ids)
    _match(tm, tloss, tg, jloss, jg)
    # recompute changes no number of the port's own step
    tm.config.use_recompute = False
    assert _port_step(tm, ids)[0] == tloss


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(tm, ids):
    t = torch.from_numpy(ids)
    _, loss = tm(t, labels=t)
    with _CountMatmuls() as mode:
        loss.backward()
    tm.zero_grad(set_to_none=True)
    return mode.n


@pytest.mark.parametrize("gran", ["full", "core_attn"])
def test_dots_saveable_reruns_no_forward_matmul(gran, flag_guard):
    """Under dots_saveable the backward runs the matmuls a step without
    recompute runs; under nothing_saveable it also re-runs the forward's
    projections of each recomputed layer: six of its seven, since torch's
    checkpoint stops a recompute once the last saved tensor is packed,
    and autograd packs the down projection's inputs before the product
    runs (with ``full``, the attention's products too, which on the CPU
    are its plain version's)."""
    _, tm = _models()
    ids = _ids(4)
    base = _backward_matmuls(tm, ids)
    tm.config.use_recompute = True
    tm.config.recompute_granularity = gran
    assert _backward_matmuls(tm, ids) == base
    tflags.set_flags({"FLAGS_recompute_policy": "nothing_saveable"})
    rerun = _backward_matmuls(tm, ids) - base
    layers = tm.config.num_hidden_layers
    if gran == "core_attn":
        assert rerun == 6 * layers
    else:
        assert rerun > 6 * layers


def test_unknown_policy_and_granularity_raise(flag_guard):
    with pytest.raises(ValueError, match="recompute_granularity"):
        LlamaConfig(recompute_granularity="layers")
    _, tm = _models(use_recompute=True)
    tflags.set_flags({"FLAGS_recompute_policy": "everything"})
    t = torch.from_numpy(_ids(5))
    with pytest.raises(ValueError, match="FLAGS_recompute_policy"):
        tm(t, labels=t)


# ---- the fused linear + CE branch of the labelled forward -------------------

def test_fused_ce_branch_matches_jax_labelled_forward(flag_guard):
    _set(fused_linear_cross_entropy=True, fused_ce_chunk_v=96)
    jm, tm = _models()
    ids = _ids(6)
    jloss, jg = _jax_step(jm, ids)
    t = torch.from_numpy(ids)
    out, loss = tm(t, labels=t)
    assert out is None
    loss.backward()
    _match(tm, loss.item(), convert.grads_to_numpy(tm), jloss, jg)
    # the same loss as over full logits, in f32
    tm.zero_grad(set_to_none=True)
    tflags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    logits, full = tm(t, labels=t)
    assert logits is not None
    assert abs(full.item() - loss.item()) <= 1e-6 * full.item()


def test_tied_embeddings_keep_the_logits_path(flag_guard):
    tflags.set_flags({"FLAGS_fused_linear_cross_entropy": True})
    _, tm = _models(tie=True)
    t = torch.from_numpy(_ids(7))
    logits, loss = tm(t, labels=t)
    assert logits is not None and torch.isfinite(loss)


# ---- hapi.Model.fit ---------------------------------------------------------

def _fit_data(vocab, rows=8, s=32):
    return np.random.RandomState(0).randint(0, vocab, (rows, s + 1))


def _jax_fit(jm, ids, compiled=True):
    m = JModel(jm)
    m.prepare(paddle.optimizer.SGD(1e-4, parameters=jm.parameters()),
              JCriterion(jm.config))
    t = paddle.to_tensor(ids.astype(np.int64))
    m.fit(paddle.io.TensorDataset([t, t]), batch_size=4, epochs=1,
          verbose=0, shuffle=False, log_freq=1_000_000, compiled=compiled)
    return m._last_epoch_summary


def _port_fit(tm, ids, compiled=True, epochs=1):
    m = Model(tm)
    m.prepare(SGD(1e-4, parameters=tm.parameters()),
              LlamaPretrainingCriterion(tm.config))
    t = torch.from_numpy(ids)
    m.fit(TensorDataset([t, t]), batch_size=4, epochs=epochs, verbose=0,
          shuffle=False, log_freq=1_000_000, compiled=compiled)
    return m._last_epoch_summary


def test_compiled_fit_matches_jax_fit(flag_guard, monkeypatch):
    jm, tm = _models()
    calls = []
    real = tllama.fused_linear_cross_entropy
    monkeypatch.setattr(tllama, "fused_linear_cross_entropy",
                        lambda *a: calls.append(1) or real(*a))
    ids = _fit_data(256)
    js = _jax_fit(jm, ids)
    ts = _port_fit(tm, ids)
    assert len(calls) == ts["steps"] == js["steps"] == 2
    assert tflags.flag("FLAGS_fused_linear_cross_entropy") is False
    assert tflags.flag_source("FLAGS_fused_linear_cross_entropy") == \
        "default"
    # f32 (the JAX summary rounds its mean to 6 decimals)
    np.testing.assert_allclose(ts["mean_loss"], js["mean_loss"], rtol=1e-5)
    assert ts["avg_step_ms"] > 0 and ts["seconds"] > 0
    # the weights after the epoch: lr 1e-4 times gradients that agree to
    # 1e-4 relative, added to the same weights
    jw = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tw = convert.to_numpy_state_dict(tm)
    for key in jw:
        np.testing.assert_allclose(tw[key], jw[key], rtol=1e-6, atol=1e-8,
                                   err_msg=key)


def test_compiled_fit_matches_the_eager_unfused_oracle(flag_guard):
    _, tm = _models()
    _, tm2 = _models()
    ids = _fit_data(256)
    fused = _port_fit(tm, ids)
    eager = _port_fit(tm2, ids, compiled=False)
    np.testing.assert_allclose(fused["mean_loss"], eager["mean_loss"],
                               rtol=1e-5)


def test_explicit_flag_off_beats_fits_default(flag_guard, monkeypatch):
    tflags.set_flags({"FLAGS_fused_linear_cross_entropy": False})
    _, tm = _models()
    monkeypatch.setattr(tllama, "fused_linear_cross_entropy", None)
    _port_fit(tm, _fit_data(256))
    assert tflags.flag_source("FLAGS_fused_linear_cross_entropy") == "set"


def test_sgd_bf16_parameters_keep_f32_master_copies_like_jax():
    rng = np.random.RandomState(8)
    w0 = (0.1 * rng.randn(16, 8)).astype(np.float32)
    jp = paddle.create_parameter([16, 8], dtype="bfloat16")
    jp.set_data(jnp.asarray(w0, jnp.bfloat16))
    tp = torch.nn.Parameter(torch.from_numpy(w0).to(torch.bfloat16))
    jopt = paddle.optimizer.SGD(learning_rate=1e-2, parameters=[jp])
    topt = SGD(learning_rate=1e-2, parameters=[tp])
    for _ in range(3):
        g = rng.randn(16, 8).astype(np.float32)
        jp.grad = paddle.to_tensor(jnp.asarray(g, jnp.bfloat16))
        tp.grad = torch.from_numpy(g).to(torch.bfloat16)
        jopt.step()
        topt.step()
        jmaster = np.asarray(jopt._master_weights[id(jp)].numpy())
        tmaster = topt._master_weights[id(tp)]
        assert tmaster.dtype == torch.float32 and tp.dtype == torch.bfloat16
        # the same two f32 roundings (lr * g, then the subtraction)
        np.testing.assert_array_equal(tmaster.numpy(), jmaster)
        assert torch.equal(tp.detach(), tmaster.to(torch.bfloat16))


def test_sgd_f32_parameters_update_in_place_like_jax():
    rng = np.random.RandomState(9)
    w0 = rng.randn(6, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)
    jp = paddle.create_parameter([6, 5], dtype="float32")
    jp.set_data(jnp.asarray(w0))
    jp.grad = paddle.to_tensor(g)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tp.grad = torch.from_numpy(g)
    jopt = paddle.optimizer.SGD(0.1, parameters=[jp])
    topt = SGD(0.1, parameters=[tp])
    jopt.step()
    topt.step()
    # no master copy for f32; lr * g, then the subtraction, in f32
    assert not topt._master_weights
    np.testing.assert_array_equal(tp.detach().numpy(), np.asarray(jp.numpy()))


# ---- the DataLoader and the flags -------------------------------------------

def test_dataloader_batches_shuffles_and_drops_like_the_jax_loader():
    data = torch.arange(10)[:, None] * torch.ones(1, 3, dtype=torch.long)
    ds = TensorDataset([data, data[:, 0]])
    jds = paddle.io.TensorDataset([paddle.to_tensor(data.numpy())])
    for drop in (False, True):
        batches = list(DataLoader(ds, batch_size=4, drop_last=drop))
        jbatches = list(paddle.io.DataLoader(jds, batch_size=4,
                                             drop_last=drop))
        assert len(batches) == len(jbatches) == (2 if drop else 3)
        for (x, y), (jx,) in zip(batches, jbatches):
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx.numpy()))
            assert torch.equal(x[:, 0], y)
    gen = torch.Generator().manual_seed(3)
    order = torch.cat([y for _, y in DataLoader(ds, batch_size=3,
                                                shuffle=True,
                                                generator=gen)])
    assert sorted(order.tolist()) == list(range(10))
    again = torch.cat([y for _, y in DataLoader(
        ds, batch_size=3, shuffle=True,
        generator=torch.Generator().manual_seed(3))])
    assert torch.equal(order, again)


def test_scoped_default_yields_to_an_explicit_value(flag_guard):
    name = "FLAGS_fused_linear_cross_entropy"
    with tflags.scoped_default(name, True):
        assert tflags.flag(name) is True
        assert tflags.flag_source(name) == "default"
    assert tflags.flag(name) is False
    tflags.set_flags({name: False})
    with tflags.scoped_default(name, True):
        assert tflags.flag(name) is False
    with tflags.scoped_default(name, True):
        tflags.set_flags({name: True})
    assert tflags.flag(name) is True
    with pytest.raises(KeyError):
        tflags.set_flags({"FLAGS_no_such_flag": 1})
