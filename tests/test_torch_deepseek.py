"""The port's DeepSeek-V2 (``paddle_tpu_torch.models.deepseek``) against
the JAX package's, on the CPU: the training forward's logits, loss (with
the router aux loss) and every gradient on the capacity path and
dropless, the fused residual carry on and off, whole-layer recompute and
the ``q_proj`` branch; the latent-sized cache, cached generation equal
to the rollout and to the JAX package's ``generate``
(tests/test_deepseek.py:35, :47); the chunked MLA core's dispatch at
``2 * _MLA_CHUNK`` (:160); the refusals (aux loss with recompute,
``tables``, ``tensor_parallel``, the serving engine); the weight bridge.

Weights go from the JAX models into the port's through
``convert.from_numpy_state_dict``; inputs come from numpy seeds;
everything runs in f32; the JAX package's grouped matmul runs its Pallas
kernels in interpret mode. A forward is held within rtol 1e-4 / atol
1e-5, a loss within 1e-5 relative, a gradient within rtol 1e-4 / atol
1e-6 (three layers of f32 work summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import DeepseekV2Config as JConfig
from paddle_tpu.models import DeepseekV2ForCausalLM as JModel

from paddle_tpu_torch import convert
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import DeepseekV2Config, DeepseekV2ForCausalLM
from paddle_tpu_torch.models import deepseek as tds

torch.set_num_threads(1)

VOCAB = 256
SCORE_TOL = 1e-5

_MODELS = {}


def _models(**fields):
    """The JAX model (tiny, seed 0, ``fields`` on both configs) and the
    port's with its weights, built once a module for each ``fields``."""
    key = tuple(sorted(fields.items()))
    if key not in _MODELS:
        paddle.seed(0)
        jm = JModel(dataclasses.replace(JConfig.tiny(), **fields))
        arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        tm = convert.from_numpy_state_dict(DeepseekV2ForCausalLM(
            dataclasses.replace(DeepseekV2Config.tiny(), **fields),
            device="cpu"), arrays)
        _MODELS[key] = (jm, tm)
    return _MODELS[key]


@pytest.fixture(params=[True, False], ids=["fused", "unfused"])
def carry(request):
    """FLAGS_fused_rmsnorm_residual on both packages, restored after."""
    name = "FLAGS_fused_rmsnorm_residual"
    saved = [(reg, dict(reg._registry[name])) for reg in (jflags, tflags)]
    for reg, _ in saved:
        reg.set_flags({name: request.param})
    yield request.param
    for reg, ent in saved:
        reg._registry[name] = ent


def _ids(seed, shape=(2, 17)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


def _step_jax(jm, ids):
    t = paddle.to_tensor(ids)
    logits, loss = jm(t, labels=t)
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
             if p.grad is not None}
    for p in jm.parameters():
        p.clear_gradient()
    return np.asarray(logits.numpy()), float(loss.numpy()), grads


def _step_port(tm, ids):
    t = torch.from_numpy(ids)
    logits, loss = tm(t, labels=t)
    loss.backward()
    grads = convert.grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    return logits.detach().numpy(), loss.item(), grads


def _hold(port, ref, tm):
    (tl, tloss, tg), (jl, jloss, jg) = port, ref
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    assert set(tg) == set(jg) and len(tg) == len(list(tm.parameters()))
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_training_step_matches_jax(dropless, carry):
    """Logits, the loss with the router aux loss (coef 0.001) and every
    gradient, both MoE paths, the fused carry on and off."""
    jm, tm = _models(moe_dropless=dropless)
    jm.train()
    tm.train()
    ids = _ids(1)
    _hold(_step_port(tm, ids), _step_jax(jm, ids), tm)
    assert tm.layers[1].mlp.aux_loss is not None


def test_recompute_and_the_q_proj_branch_match_jax():
    """Whole-layer recompute (aux coef 0, as JAX requires) and a model
    without q_lora_rank (the plain q_proj)."""
    for fields in (dict(use_recompute=True, router_aux_loss_coef=0.0),
                   dict(q_lora_rank=None)):
        jm, tm = _models(**fields)
        jm.train()
        tm.train()
        ids = _ids(2)
        _hold(_step_port(tm, ids), _step_jax(jm, ids), tm)
    assert not hasattr(tm.layers[0].self_attn, "q_a_proj")


def test_mla_cache_is_latent_sized():
    """tests/test_deepseek.py:35: per layer a [B, T, R] latent and a [B, T,
    1, rope] key, the JAX package's shapes; R + rope values a token."""
    jm, tm = _models()
    cfg = tm.config
    caches = tm.init_kv_cache(2, 32)
    jc = jm.init_kv_cache(2, 32)
    assert [tuple(c.shape) for c in caches] == [tuple(c.shape) for c in jc]
    assert len(caches) == 2 * cfg.num_hidden_layers
    per_tok = caches[0].shape[-1] + caches[1].shape[-1]
    assert per_tok == cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert per_tok < 2 * cfg.num_attention_heads * cfg.qk_head_dim


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_cached_generation_matches_rollout_and_jax(dropless):
    """tests/test_deepseek.py:47 on the port: greedy ``generate`` over the
    latent caches equals the argmax rollout of the cache-less forward,
    and equals the JAX package's tokens (scores within 1e-5)."""
    jm, tm = _models(moe_dropless=dropless)
    jm.eval()
    tm.eval()
    prompt = _ids(1, (2, 6))
    out, scores = tm.generate(prompt, max_new_tokens=6,
                              decode_strategy="greedy_search")
    ids = torch.from_numpy(prompt)
    for _ in range(6):
        nxt = tm(ids)[:, -1].argmax(-1)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), ids[:, 6:].numpy())
    jout, jscores = jm.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                                decode_strategy="greedy_search",
                                eos_token_id=None, pad_token_id=0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores.numpy()),
                               rtol=0, atol=SCORE_TOL)


def test_decode_step_writes_the_latents_in_place_as_jax():
    """A prefill at pos 0 then a step at pos 5: logits and both caches of
    every layer as the JAX package's step gives them."""
    jm, tm = _models()
    jm.eval()
    tm.eval()
    ids = _ids(4, (2, 6))
    jc = jm.init_kv_cache(2, 9)
    tc = tm.init_kv_cache(2, 9)
    for lo, hi in ((0, 5), (5, 6)):
        jl, jc = jm(paddle.to_tensor(ids[:, lo:hi]), caches=jc,
                    pos=paddle.to_tensor(np.int32(lo)))
        tl, _ = tm(torch.from_numpy(ids[:, lo:hi]), caches=tc,
                   pos=torch.tensor(lo))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                                   rtol=1e-4, atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-4, atol=1e-5)


def test_train_path_dispatches_chunked_at_two_chunks(monkeypatch):
    """tests/test_deepseek.py:160 on the port: at Sq = 2 * _MLA_CHUNK the
    training forward takes ``chunked_attention`` and matches the exact
    einsum core's logits (2e-4, as the JAX test) and the JAX package's."""
    jm, tm = _models(max_position_embeddings=1024)
    jm.eval()
    tm.eval()
    ids = _ids(3, (1, 2 * tds._MLA_CHUNK))
    calls = []
    real = tds.chunked_attention

    def counting(*a, **k):
        calls.append(a[0].shape[1])
        return real(*a, **k)
    monkeypatch.setattr(tds, "chunked_attention", counting)
    with torch.no_grad():
        chunked = tm(torch.from_numpy(ids))
        assert calls == [2 * tds._MLA_CHUNK] * tm.config.num_hidden_layers
        monkeypatch.setattr(tds, "_MLA_CHUNK", 10 ** 9)
        exact = tm(torch.from_numpy(ids))
    assert len(calls) == tm.config.num_hidden_layers
    np.testing.assert_allclose(chunked.numpy(), exact.numpy(), rtol=2e-4,
                               atol=2e-4)
    with paddle.no_grad():
        ref = jm(paddle.to_tensor(ids))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref.numpy()),
                               rtol=2e-4, atol=2e-4)


def test_aux_loss_with_recompute_raises():
    """As the JAX model (deepseek.py:400-406): the per-layer aux attribute
    cannot cross the recompute boundary."""
    cfg = dataclasses.replace(DeepseekV2Config.tiny(), use_recompute=True)
    tm = DeepseekV2ForCausalLM(cfg, device="cpu").train()
    ids = torch.from_numpy(_ids(5))
    with pytest.raises(ValueError, match="router_aux_loss_coef"):
        tm(ids, labels=ids)
    tm.eval()
    assert tm(ids).shape == (2, 17, VOCAB)      # inference is fine


def test_tables_tensor_parallel_and_the_engine_are_refused():
    """No paged path: ``tables`` is a TypeError (the JAX forward has no such
    parameter either); the port's engine refuses the model when built,
    where the JAX engine quarantines each request on that TypeError;
    tensor parallelism raises and names ROADMAP A.7."""
    jm, tm = _models()
    caches = tm.init_kv_cache(1, 8)
    with pytest.raises(TypeError, match="tables"):
        tm(torch.zeros(1, 2, dtype=torch.long), caches=caches, pos=0,
           tables=(torch.zeros(1, 1, dtype=torch.int32), torch.ones(1)))
    with pytest.raises(TypeError, match="no paged serving path"):
        ContinuousBatchingEngine(tm, num_slots=2, page_size=8, max_len=32,
                                 device="cpu")
    eng = JEngine(jm, num_slots=2, page_size=8, max_len=32)
    eng.add_request(np.arange(5, dtype=np.int32), 3)
    (req,) = eng.run()
    assert req.tokens == [] and "tables" in str(req.error)
    with pytest.raises(NotImplementedError, match="A.7"):
        DeepseekV2ForCausalLM(dataclasses.replace(
            DeepseekV2Config.tiny(), tensor_parallel=True), device="cpu")


def test_weight_bridge_round_trips_the_jax_keys():
    """The JAX package's keys in its order (expert stacks untransposed, as
    for Qwen2-MoE); to_numpy_state_dict gives the JAX arrays back."""
    jm, tm = _models()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    back = convert.to_numpy_state_dict(tm)
    assert list(back) == list(arrays)
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_config_matches_jax():
    for make in (lambda c: c(), lambda c: c.tiny()):
        assert dataclasses.asdict(make(DeepseekV2Config)) == \
            dataclasses.asdict(make(JConfig))
    assert DeepseekV2Config().qk_head_dim == 192


def test_hapi_train_batch_matches_jax():
    """``hapi.Model`` over DeepSeek-V2 with the shifted-CE criterion (its
    labels go into the network, whose loss adds the aux term): two
    AdamW ``train_batch`` steps, losses within 1e-5 relative."""
    from paddle_tpu.models.llama import LlamaPretrainingCriterion as JCrit

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    paddle.seed(0)
    jm = JModel(JConfig.tiny())
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        DeepseekV2ForCausalLM(DeepseekV2Config.tiny(), device="cpu"), arrays)
    jmodel = paddle.Model(jm)
    jmodel.prepare(paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()),
                   JCrit(jm.config))
    tmodel = Model(tm)
    tmodel.prepare(AdamW(1e-3, parameters=tm.parameters()),
                   LlamaPretrainingCriterion(tm.config))
    ids = _ids(8, (2, 13))
    for _ in range(2):
        jl = jmodel.train_batch([paddle.to_tensor(ids)],
                                paddle.to_tensor(ids))[0]
        tl = tmodel.train_batch([torch.from_numpy(ids)],
                                torch.from_numpy(ids))[0]
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
