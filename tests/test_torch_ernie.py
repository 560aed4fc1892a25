"""The port's ERNIE family (``paddle_tpu_torch.models.ernie``) against the
JAX package's, on the CPU: every head's outputs, loss and every gradient
at dropout 0 (pretraining with masked-LM and SOP labels, masked LM,
sequence classification, the bare encoder with its pooler); the padding
mask, ``ignore_index`` and the classification head's training
(tests/test_ernie.py:35-102); ``hapi.Model``'s steps; the non-causal
flash route; live dropout's generator; the weight bridge (``mlm_bias``
first, ``ErnieForMaskedLM``'s encoder once under ``_pre``).

Weights go from the JAX models into the port's through
``convert.from_numpy_state_dict``; inputs come from numpy seeds;
everything runs in f32. A forward is held within rtol 1e-4 / atol 1e-5
(two layers of f32 matmuls and softmax summed in another order), a loss
within 1e-5 relative, a gradient within rtol 1e-4 / atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JErnieConfig
from paddle_tpu.models import ErnieForMaskedLM as JErnieForMaskedLM
from paddle_tpu.models import ErnieForPretraining as JErnieForPretraining
from paddle_tpu.models import ErnieForSequenceClassification as JErnieCls
from paddle_tpu.models import ErnieModel as JErnieModel

from paddle_tpu_torch import convert
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (ErnieConfig, ErnieForMaskedLM,
                                     ErnieForPretraining,
                                     ErnieForSequenceClassification,
                                     ErnieModel)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

FAMILIES = {
    # name: (JAX class, port class, constructor kwargs)
    "pretraining": (JErnieForPretraining, ErnieForPretraining, {}),
    "masked_lm": (JErnieForMaskedLM, ErnieForMaskedLM, {}),
    "classification": (JErnieCls, ErnieForSequenceClassification,
                       {"num_classes": 3}),
    "encoder": (JErnieModel, ErnieModel, {}),
}

_MODELS = {}


def _models(name):
    """The JAX model (tiny, seed 0) and the port's with its weights, built
    once a module."""
    if name not in _MODELS:
        jcls, tcls, kw = FAMILIES[name]
        paddle.seed(0)
        jm = jcls(JErnieConfig.tiny(), **kw)
        _MODELS[name] = (jm, _port(jm, tcls, **kw))
    return _MODELS[name]


def _port(jm, tcls, **kw):
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return convert.from_numpy_state_dict(
        tcls(ErnieConfig.tiny(), device="cpu", **kw), arrays)


def _batch(seed, b=3, s=19, vocab=512):
    """Masked ids ([MASK] = 3), MLM labels (-100 where unmasked), SOP
    labels, token types, as tests/test_ernie.py builds them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, (b, s))
    labels = np.full((b, s), -100)
    masked = rng.rand(b, s) < 0.15
    masked[:, 0] = False
    masked[0, 3] = True                 # at least one masked position
    labels[masked] = ids[masked]
    ids[masked] = 3
    return ids, labels, rng.randint(0, 2, b), rng.randint(0, 2, (b, s))


def _grads_jax(jm):
    g = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
         if p.grad is not None}
    for p in jm.parameters():
        p.clear_gradient()
    return g


def _grads_port(tm):
    g = convert.grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    return g


def _same_grads(tg, jg, tm):
    """Every gradient of both sides (the masked LM leaves the pooler and
    the SOP head without one on both)."""
    assert set(tg) == set(jg) and len(jg) >= len(list(tm.parameters())) - 4
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref.numpy()),
                               rtol=1e-4, atol=1e-5)


def _same_loss(tl, jl):
    assert abs(tl.item() - float(jl.numpy())) <= 1e-5 * abs(
        float(jl.numpy()))


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_outputs_loss_and_every_grad_match_jax(masked):
    """Both heads' logits, the summed MLM + SOP loss and every gradient,
    with and without a padding mask (the masked rows take the plain
    attention, the others flash's plain version)."""
    jm, tm = _models("pretraining")
    ids, labels, sop, types = _batch(1)
    mask = np.ones_like(ids)
    if masked:
        mask[1, 12:] = 0
        mask[2, 5:] = 0
    jm_mask = paddle.to_tensor(mask) if masked else None
    tm_mask = torch.from_numpy(mask) if masked else None
    jmlm, jsop = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
                    attention_mask=jm_mask)
    tmlm, tsop = tm(torch.from_numpy(ids), torch.from_numpy(types),
                    attention_mask=tm_mask)
    _close(tmlm, jmlm)
    _close(tsop, jsop)
    jl = jm(paddle.to_tensor(ids), paddle.to_tensor(types),
            attention_mask=jm_mask, masked_lm_labels=paddle.to_tensor(labels),
            sop_labels=paddle.to_tensor(sop))
    jl.backward()
    tl = tm(torch.from_numpy(ids), torch.from_numpy(types),
            attention_mask=tm_mask, masked_lm_labels=torch.from_numpy(labels),
            sop_labels=torch.from_numpy(sop))
    tl.backward()
    _same_loss(tl, jl)
    _same_grads(_grads_port(tm), _grads_jax(jm), tm)


def test_masked_lm_and_encoder_match_jax():
    jm, tm = _models("masked_lm")
    ids, labels, _, _ = _batch(2)
    _close(tm(torch.from_numpy(ids)), jm(paddle.to_tensor(ids)))
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jl.backward()
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    _same_loss(tl, jl)
    _same_grads(_grads_port(tm), _grads_jax(jm), tm)
    jm, tm = _models("encoder")
    for got, ref in zip(tm(torch.from_numpy(ids)),
                        jm(paddle.to_tensor(ids))):
        _close(got, ref)


def test_classification_matches_jax_over_adamw_steps():
    """tests/test_ernie.py:102 on both sides: 3 classes, AdamW(3e-3) on one
    batch; logits and every gradient at step 0, then the port's losses
    follow the JAX package's (rtol 1e-4: steps of two libraries'
    rounding) and fall."""
    paddle.seed(4)
    jm = JErnieCls(JErnieConfig.tiny(), num_classes=3)
    tm = _port(jm, ErnieForSequenceClassification, num_classes=3)
    rng = np.random.RandomState(4)
    ids = rng.randint(5, 512, (6, 16))
    y = rng.randint(0, 3, (6,))
    _close(tm(torch.from_numpy(ids)), jm(paddle.to_tensor(ids)))
    jopt = paddle.optimizer.AdamW(3e-3, parameters=jm.parameters())
    topt = AdamW(3e-3, parameters=tm.parameters())
    jlosses, tlosses = [], []
    for step in range(8):
        jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(y))
        jl.backward()
        tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(y))
        tl.backward()
        if step == 0:
            jg = {n: np.asarray(p.grad.numpy())
                  for n, p in jm.named_parameters() if p.grad is not None}
            _same_grads(convert.grads_to_numpy(tm), jg, tm)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(jl.numpy()))
        tlosses.append(tl.item())
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_pretraining_loss_drops_as_jax_does():
    """tests/test_ernie.py:35: 12 AdamW steps of pretraining lower the loss
    by 30%, on both sides, the port's losses within rtol 1e-4 of JAX's."""
    paddle.seed(0)
    jm = JErnieForPretraining(JErnieConfig.tiny())
    tm = _port(jm, ErnieForPretraining)
    ids, labels, sop, _ = _batch(0, b=4, s=24)
    jopt = paddle.optimizer.AdamW(3e-3, parameters=jm.parameters())
    topt = AdamW(3e-3, parameters=tm.parameters())
    jlosses, tlosses = [], []
    for _ in range(12):
        jl = jm(paddle.to_tensor(ids), masked_lm_labels=paddle.to_tensor(
            labels), sop_labels=paddle.to_tensor(sop))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tm(torch.from_numpy(ids), masked_lm_labels=torch.from_numpy(
            labels), sop_labels=torch.from_numpy(sop))
        tl.backward()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(jl.numpy()))
        tlosses.append(tl.item())
    assert tlosses[-1] < tlosses[0] * 0.7, tlosses
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_attention_mask_ignores_padding():
    """tests/test_ernie.py:63 on the port: four pad tokens behind an
    attention mask leave the first 8 positions as the unpadded run gives
    them (rtol 1e-4, atol 1e-5, as the JAX test), and match the JAX
    package's padded run."""
    jm, tm = _models("encoder")
    tm.eval()
    rng = np.random.RandomState(2)
    ids = rng.randint(5, 512, (1, 8))
    padded = np.concatenate([ids, np.zeros((1, 4), np.int64)], axis=1)
    mask = np.concatenate([np.ones((1, 8)), np.zeros((1, 4))],
                          axis=1).astype(np.int64)
    short, _ = tm(torch.from_numpy(ids))
    long_, _ = tm(torch.from_numpy(padded),
                  attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(long_[:, :8].detach().numpy(),
                               short.detach().numpy(), rtol=1e-4, atol=1e-5)
    jlong, _ = jm(paddle.to_tensor(padded),
                  attention_mask=paddle.to_tensor(mask))
    _close(long_, jlong)


def test_mlm_ignore_index():
    """tests/test_ernie.py:82: only masked positions count; the ignored
    positions' ids do not change the loss, and it equals the CE of the
    one labelled position."""
    _, tm = _models("masked_lm")
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(5, 512, (2, 12)))
    labels = torch.full((2, 12), -100)
    labels[0, 3] = ids[0, 3]
    loss = tm(ids, labels=labels)
    logits = tm(ids)
    one = torch.nn.functional.cross_entropy(logits[0, 3:4], ids[0, 3:4])
    assert abs(loss.item() - one.item()) <= 1e-6 * abs(one.item())
    labels2 = labels.clone()
    labels2[1, 5] = -100
    assert tm(ids, labels=labels2).item() == loss.item()


def test_encoder_routes_to_flash_without_a_mask(monkeypatch):
    """No mask and dropout 0: the non-causal flash kernels (K7-K9's plain
    versions on the CPU), once a layer; a padding mask or live attention
    dropout: the plain path, never flash, as the JAX package routes."""
    _, tm = _models("encoder")
    calls = []
    real = kfa.flash_attention

    def counting(q, k, v, causal=False, scale=None):
        calls.append(causal)
        return real(q, k, v, causal, scale)
    monkeypatch.setattr(kfa, "flash_attention", counting)
    ids = torch.from_numpy(np.random.RandomState(5).randint(5, 512, (2, 9)))
    tm(ids)
    assert calls == [False] * tm.config.num_hidden_layers
    calls.clear()
    tm(ids, attention_mask=torch.ones_like(ids))
    drop = ErnieModel(dataclasses.replace(ErnieConfig.tiny(),
                                          attention_dropout_prob=0.1),
                      device="cpu").train()
    drop(ids)
    assert calls == []


def test_live_dropout_draws_from_the_models_generator():
    cfg = dataclasses.replace(ErnieConfig.tiny(), hidden_dropout_prob=0.1,
                              attention_dropout_prob=0.1)
    ids, labels, sop, _ = _batch(6)
    t = [torch.from_numpy(a) for a in (ids, labels, sop)]

    def loss(dropout_seed, train=True):
        m = ErnieForPretraining(cfg, device="cpu", seed=0,
                                dropout_seed=dropout_seed).train(train)
        return m(t[0], masked_lm_labels=t[1], sop_labels=t[2]).item()
    assert loss(1) == loss(1) != loss(2)
    assert loss(1, train=False) == loss(2, train=False)


def test_hapi_train_batch_matches_jax():
    """``hapi.Model`` over the classifier with a cross-entropy criterion:
    two AdamW ``train_batch`` steps, losses within 1e-5 relative."""
    paddle.seed(0)
    jm = JErnieCls(JErnieConfig.tiny(), num_classes=3)
    tm = _port(jm, ErnieForSequenceClassification, num_classes=3)
    jmodel = paddle.Model(jm)
    jmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()),
                   paddle.nn.CrossEntropyLoss())
    tmodel = Model(tm)
    tmodel.prepare(AdamW(1e-3, parameters=tm.parameters()), F.cross_entropy)
    rng = np.random.RandomState(9)
    ids, y = rng.randint(5, 512, (4, 11)), rng.randint(0, 3, (4,))
    for _ in range(2):
        jl = jmodel.train_batch([paddle.to_tensor(ids)],
                                paddle.to_tensor(y))[0]
        tl = tmodel.train_batch([torch.from_numpy(ids)],
                                torch.from_numpy(y))[0]
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_weight_bridge_round_trips_the_jax_keys(name):
    """The state dicts have the JAX package's keys in its order
    (``mlm_bias`` first; the masked LM's encoder once, under ``_pre``),
    and to_numpy_state_dict gives the JAX arrays back."""
    jm, tm = _models(name)
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    back = convert.to_numpy_state_dict(tm)
    assert list(back) == list(arrays)
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_config_presets_match_jax():
    for name in ("base", "tiny"):
        assert dataclasses.asdict(getattr(ErnieConfig, name)()) == \
            dataclasses.asdict(getattr(JErnieConfig, name)())
