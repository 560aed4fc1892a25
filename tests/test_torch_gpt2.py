"""The port's GPT-2 (``paddle_tpu_torch.models.gpt2``) against the JAX
package's, on the CPU: the training forward's logits, loss and every
gradient at dropout 0; a few AdamW steps (tests/test_models.py:33) and
``hapi.Model``'s steps; the logits shape (:158); ``generate``'s greedy
tokens and scores; the dense and paged caches; the engine's stream
against ``generate``'s and the JAX package's (tests/test_serving.py:188),
over bf16/f32, int8 and fp8 pools and under weight-only int8; live
dropout's route and its generator; the weight bridge.

Weights go from the JAX model into the port's through
``convert.from_numpy_state_dict``; inputs come from numpy seeds;
everything runs in f32. Streams use an initialiser range of 0.2 on both
sides, so the tiny model's greedy streams are not one repeated token.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import GPT2Config as JGPT2Config
from paddle_tpu.models import GPT2ForCausalLM as JGPT2ForCausalLM
from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCriterion

from paddle_tpu_torch import convert
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (GPT2Config, GPT2ForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn.quant import WeightOnlyLinear
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(1)

VOCAB = 512
#: scores are means of f32 logprobs computed by two libraries
SCORE_TOL = 1e-5

_MODELS = {}


def _models(init=0.02):
    """The JAX GPT-2 tiny (seed 0) and the port's with its weights, built
    once a module for each initialiser range."""
    if init not in _MODELS:
        paddle.seed(0)
        jm = JGPT2ForCausalLM(dataclasses.replace(JGPT2Config.tiny(),
                                                  initializer_range=init))
        tm = _port(jm)
        _MODELS[init] = (jm, tm)
    return _MODELS[init]


def _port(jm, **fields):
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = dataclasses.replace(GPT2Config.tiny(), **fields)
    return convert.from_numpy_state_dict(GPT2ForCausalLM(cfg, device="cpu"),
                                         arrays)


def _ids(seed, shape=(2, 33)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


def test_labeled_forward_and_every_grad_match_jax():
    jm, tm = _models()
    jm.train()
    tm.train()
    ids = _ids(1)
    t = paddle.to_tensor(ids)
    jl, jloss = jm(t, labels=t)
    jloss.backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
          if p.grad is not None}
    for p in jm.parameters():
        p.clear_gradient()
    tt = torch.from_numpy(ids)
    tl, tloss = tm(tt, labels=tt)
    tloss.backward()
    tg = convert.grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    # f32 through two layers; matmuls and softmax sum in another order
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl.numpy()),
                               rtol=1e-4, atol=1e-5)
    assert abs(tloss.item() - float(jloss.numpy())) <= 1e-5 * abs(
        float(jloss.numpy()))
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_tiny_trains_as_jax_does():
    """tests/test_models.py:33: 12 AdamW steps on one batch lower the loss
    by 30%; the port's losses follow the JAX package's (f32, rtol 1e-4:
    twelve steps of two libraries' rounding)."""
    paddle.seed(0)
    jm = JGPT2ForCausalLM(JGPT2Config.tiny())
    tm = _port(jm)
    data = np.random.RandomState(0).randint(0, VOCAB, (4, 33))
    jopt = paddle.optimizer.AdamW(3e-3, parameters=jm.parameters())
    topt = AdamW(3e-3, parameters=tm.parameters())
    jt, tt = paddle.to_tensor(data), torch.from_numpy(data)
    jlosses, tlosses = [], []
    for _ in range(12):
        _, loss = jm(jt, labels=jt)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(loss.numpy()))
        _, loss = tm(tt, labels=tt)
        loss.backward()
        topt.step()
        topt.clear_grad()
        tlosses.append(loss.item())
    assert tlosses[-1] < tlosses[0] * 0.7, tlosses
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_hapi_train_batch_matches_jax():
    """``hapi.Model`` over GPT-2 with the shifted-CE criterion (whose
    labels go into the network, as the criterion certifies): two AdamW
    ``train_batch`` steps, losses within 1e-5 relative."""
    paddle.seed(0)
    jm = JGPT2ForCausalLM(JGPT2Config.tiny())
    tm = _port(jm)
    jmodel = paddle.Model(jm)
    jmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()),
                   JCriterion(jm.config))
    tmodel = Model(tm)
    tmodel.prepare(AdamW(1e-3, parameters=tm.parameters()),
                   LlamaPretrainingCriterion(tm.config))
    ids = _ids(5, (3, 17))
    for _ in range(2):
        jl = jmodel.train_batch([paddle.to_tensor(ids)],
                                paddle.to_tensor(ids))[0]
        tl = tmodel.train_batch([torch.from_numpy(ids)],
                                torch.from_numpy(ids))[0]
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


def test_logits_shape():
    """tests/test_models.py:158."""
    _, tm = _models()
    tm.eval()
    logits = tm(torch.ones(2, 10, dtype=torch.long))
    assert tuple(logits.shape) == (2, 10, VOCAB)


@pytest.mark.parametrize("driver", ["static", "eos"])
def test_greedy_generate_matches_jax(driver):
    jm, tm = _models(0.2)
    jm.eval()
    tm.eval()
    ids = _ids(2, (2, 7))
    kw = dict(max_new_tokens=8, decode_strategy="greedy_search")
    if driver == "eos":
        kw.update(eos_token_id=VOCAB)      # never emitted: every step runs
    jout, jscores = jm.generate(paddle.to_tensor(ids), **kw)
    tout, tscores = tm.generate(ids, **kw)
    assert len(set(tout[0].tolist())) > 1        # not one repeated token
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores.numpy()),
                               rtol=0, atol=SCORE_TOL)


def test_dense_cache_steps_match_jax():
    """init_kv_cache's [B, T, H, D] caches, a prefill at pos 0 and a decode
    step at pos 6: logits within the forward's tolerance, caches
    written alike."""
    jm, tm = _models(0.2)
    jm.eval()
    tm.eval()
    ids = _ids(3, (2, 7))
    jc = jm.init_kv_cache(2, 12)
    tc = tm.init_kv_cache(2, 12)
    assert [tuple(c.shape) for c in tc] == [tuple(c.shape) for c in jc]
    jl, jc = jm(paddle.to_tensor(ids[:, :6]), caches=jc,
                pos=paddle.to_tensor(np.int32(0)))
    tl, _ = tm(torch.from_numpy(ids[:, :6]), caches=tc, pos=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               rtol=1e-4, atol=1e-5)
    jl, jc = jm(paddle.to_tensor(ids[:, 6:]), caches=jc,
                pos=paddle.to_tensor(np.int32(6)))
    tl, _ = tm(torch.from_numpy(ids[:, 6:]), caches=tc,
               pos=torch.tensor(6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(tc, jc):      # layer 1's k/v come through layer 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-4, atol=1e-5)


def _run(eng, prompts, n_new):
    for p in prompts:
        eng.add_request(p, n_new)
    return [r.tokens for r in sorted(eng.run(), key=lambda r: r.request_id)]


def _geometry():
    return dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
                prompt_buckets=(16,))


def test_engine_stream_equals_generate_and_jax():
    """tests/test_serving.py:188 on the port: GPT-2 (learned positions, no
    RoPE) through the engine equals its dense ``generate`` stream, and
    both equal the JAX package's ``generate``."""
    jm, tm = _models(0.2)
    jm.eval()
    tm.eval()
    prompts = [np.random.RandomState(7).randint(0, VOCAB, n).astype(np.int32)
               for n in (10, 21, 3)]
    streams = _run(ContinuousBatchingEngine(tm, device="cpu", **_geometry()),
                   prompts, 8)
    for p, got in zip(prompts, streams):
        ref = tm.generate(p[None], max_new_tokens=8,
                          decode_strategy="greedy_search")[0][0].tolist()
        jref = np.asarray(jm.generate(
            paddle.to_tensor(p[None].astype(np.int64)), max_new_tokens=8,
            decode_strategy="greedy_search", eos_token_id=None,
            pad_token_id=0)[0].numpy())[0].tolist()
        assert got == ref == jref, (got, ref, jref)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_engine_over_quantized_pools_matches_jax_engine(kv_quant):
    """GPT-2 over int8/fp8 pools (K13's plain version): the port's streams
    equal the JAX engine's, and the pools hold two kv heads' worth of
    scales per layer (the MHA fallback of the pool geometry)."""
    jm, tm = _models(0.2)
    jm.eval()
    tm.eval()
    prompts = [np.random.RandomState(8).randint(0, VOCAB, n).astype(np.int32)
               for n in (12, 5)]
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant=kv_quant,
                                   **_geometry())
    cfg = tm.config
    assert eng._pool_shape == (cfg.num_attention_heads, eng.num_pages, 8,
                               cfg.hidden_size // cfg.num_attention_heads)
    assert len(eng.pools) == 4 * cfg.num_hidden_layers
    got = _run(eng, prompts, 6)
    ref = _run(JEngine(jm, kv_quant=kv_quant, **_geometry()), prompts, 6)
    assert got == ref


def test_weight_only_int8_engine_matches_jax_engine():
    """``weight_quant="weight_only_int8"``: the engine converts c_attn,
    c_proj and c_fc (the tied head stays) and serves the JAX engine's
    streams."""
    paddle.seed(0)
    jcfg = dataclasses.replace(JGPT2Config.tiny(), initializer_range=0.2)
    jm = JGPT2ForCausalLM(jcfg)
    jm.eval()
    tm = _port(jm, initializer_range=0.2, weight_quant="weight_only_int8")
    tm.eval()
    jm.config.weight_quant = "weight_only_int8"
    prompts = [np.random.RandomState(9).randint(0, VOCAB, n).astype(np.int32)
               for n in (14, 6)]
    got = _run(ContinuousBatchingEngine(tm, device="cpu", **_geometry()),
               prompts, 6)
    ref = _run(JEngine(jm, **_geometry()), prompts, 6)
    n_quant = sum(isinstance(m, WeightOnlyLinear) for m in tm.modules())
    assert n_quant == 4 * tm.config.num_hidden_layers
    assert got == ref


def test_paged_positions_past_the_table_are_clamped():
    """A chunk whose padding runs past max_position_embeddings (a slot at
    ctx 126 of 128 with a chunk of 8) looks its positions up clamped: no
    index past the table (on the device that faults)."""
    _, tm = _models()
    cfg = tm.config
    page, pages = 16, cfg.max_position_embeddings // 16 + 1
    d = cfg.hidden_size // cfg.num_attention_heads
    pools = [torch.zeros(cfg.num_attention_heads, pages + 1, page, d)
             for _ in range(2 * cfg.num_hidden_layers)]
    tables = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    logits, _ = tm(torch.randint(0, VOCAB, (1, 8)), caches=pools,
                   pos=torch.tensor([cfg.max_position_embeddings - 2],
                                    dtype=torch.int32),
                   tables=(tables, torch.tensor([2])))
    assert torch.isfinite(logits).all()


def test_live_dropout_takes_the_plain_path_and_its_generator(monkeypatch):
    """With dropout live the attention takes the plain path (never flash,
    as the JAX package routes) and the masks come from the model's
    generator: the same ``dropout_seed`` gives the same loss, another
    seed another, eval mode none."""
    cfg = dataclasses.replace(GPT2Config.tiny(), hidden_dropout_prob=0.1,
                              attention_dropout_prob=0.1)
    ids = torch.from_numpy(_ids(4, (2, 17)))

    def flash(*a, **k):
        raise AssertionError("flash attention under live dropout")
    monkeypatch.setattr(kfa, "flash_attention", flash)

    def loss(dropout_seed, train=True):
        m = GPT2ForCausalLM(cfg, device="cpu", seed=0,
                            dropout_seed=dropout_seed)
        m.train(train)
        return m(ids, labels=ids)[1].item()
    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    monkeypatch.undo()
    assert loss(1, train=False) == loss(2, train=False)


def test_weight_bridge_round_trips_the_jax_keys():
    """The state dict has the JAX package's keys (the tied head adds
    none); to_numpy_state_dict gives the JAX arrays back."""
    jm, tm = _models()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    back = convert.to_numpy_state_dict(tm)
    assert list(back) == list(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_config_presets_match_jax():
    for name in ("small", "tiny"):
        assert dataclasses.asdict(getattr(GPT2Config, name)()) == \
            dataclasses.asdict(getattr(JGPT2Config, name)())
    with pytest.raises(ValueError, match="weight_quant"):
        GPT2Config(weight_quant="int3")
