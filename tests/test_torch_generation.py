"""The port's ``generate`` (paddle_tpu_torch.generation) against the JAX
package's, on the CPU: greedy tokens exactly and scores within
``SCORE_TOL`` for tiny Llama, Qwen2 and Qwen2-MoE (dropless and capacity
routing) through both drivers (no eos; an eos the model cannot emit);
the eos stop and its padding; the repetition penalty; ``max_length``;
the logits pipeline (``_process_and_sample``: penalty, temperature,
top-k, top-p, the logprob of the pick, eos and pad) on the JAX
function's own picks; ``sdpa_with_cache`` at prefill and decode; seeded
sampling; and both of the port's engines (unified and legacy) against
its dense ``generate`` stream by stream.

Weights go from the JAX models into the port's through
``convert.from_numpy_state_dict``; inputs come from numpy seeds;
everything runs in f32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models import Qwen2Config as JQwen2Config
from paddle_tpu.models import Qwen2ForCausalLM as JQwen2ForCausalLM
from paddle_tpu.models import Qwen2MoeConfig as JQwen2MoeConfig
from paddle_tpu.models import Qwen2MoeForCausalLM as JQwen2MoeForCausalLM
from paddle_tpu.nn.functional.attention import \
    sdpa_with_cache as jsdpa_with_cache

from paddle_tpu_torch import convert
from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2Config, Qwen2ForCausalLM,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.nn import functional as F

torch.set_num_threads(1)

VOCAB = 256
#: scores are means of f32 logprobs computed by two libraries
SCORE_TOL = 1e-5

FAMILIES = {
    # name: (JAX config, JAX model, port config, port model, fields)
    "llama": (JLlamaConfig, JLlamaForCausalLM, LlamaConfig,
              LlamaForCausalLM, {}),
    "qwen2": (JQwen2Config, JQwen2ForCausalLM, Qwen2Config,
              Qwen2ForCausalLM, {}),
    "qwen2_moe": (JQwen2MoeConfig, JQwen2MoeForCausalLM, Qwen2MoeConfig,
                  Qwen2MoeForCausalLM, {"moe_dropless": True}),
    "qwen2_moe_capacity": (JQwen2MoeConfig, JQwen2MoeForCausalLM,
                           Qwen2MoeConfig, Qwen2MoeForCausalLM, {}),
}

_MODELS = {}


def _models(family):
    """The JAX model (tiny, seed 0) and the port's with its weights,
    built once a module."""
    if family not in _MODELS:
        jc, jm_cls, tc, tm_cls, fields = FAMILIES[family]
        jcfg, tcfg = jc.tiny(), tc.tiny()
        jcfg.tensor_parallel = False
        jcfg.scan_layers = False
        for k, v in fields.items():
            setattr(jcfg, k, v)
            setattr(tcfg, k, v)
        paddle.seed(0)
        jm = jm_cls(jcfg)
        jm.eval()
        arrays = {k: np.asarray(v.numpy())
                  for k, v in jm.state_dict().items()}
        tm = convert.from_numpy_state_dict(tm_cls(tcfg, device="cpu"),
                                           arrays)
        tm.eval()
        _MODELS[family] = (jm, tm)
    return _MODELS[family]


def _ids(seed, shape=(2, 7)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


def _jax_generate(jm, ids, **kw):
    out, scores = jm.generate(paddle.to_tensor(ids.astype(np.int64)), **kw)
    return np.asarray(out.numpy()), np.asarray(scores.numpy())


def _port_generate(tm, ids, **kw):
    out, scores = tm.generate(ids, **kw)
    assert out.dtype == torch.int32 and scores.dtype == torch.float32
    return out.numpy(), scores.numpy()


def _assert_same(port, ref):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=SCORE_TOL)


# ---- generate against the JAX package ---------------------------------------

@pytest.mark.parametrize("driver", ["static", "eos"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_matches_jax_generate(family, driver):
    """Greedy tokens exactly, scores within SCORE_TOL. ``eos``: the
    polling driver, under an eos the vocabulary cannot emit, so it runs
    every step (tests/test_generation.py:168)."""
    jm, tm = _models(family)
    ids = _ids(0)
    kw = dict(max_new_tokens=6, decode_strategy="greedy_search")
    if driver == "eos":
        kw.update(eos_token_id=VOCAB)
    port = _port_generate(tm, ids, **kw)
    assert port[0].shape == (2, 6)
    assert np.isfinite(port[1]).all()
    _assert_same(port, _jax_generate(jm, ids, **kw))


def test_eos_stop_and_padding_match_jax():
    """Row 0 stops on its first token: everything after it is the pad,
    its score is that token's logprob alone; the loop stops once both
    rows finished (tests/test_generation.py:73)."""
    jm, tm = _models("llama")
    ids = _ids(2, (2, 4))
    first, _ = _port_generate(tm, ids, max_new_tokens=1,
                              decode_strategy="greedy_search")
    kw = dict(max_new_tokens=8, decode_strategy="greedy_search",
              eos_token_id=int(first[0, 0]), pad_token_id=0)
    port = _port_generate(tm, ids, **kw)
    assert port[0][0, 0] == first[0, 0] and (port[0][0, 1:] == 0).all()
    _assert_same(port, _jax_generate(jm, ids, **kw))
    # the score of row 0 is the logprob of its one token
    _, lp1 = _port_generate(tm, ids, max_new_tokens=1,
                            decode_strategy="greedy_search")
    np.testing.assert_allclose(port[1][0], lp1[0], rtol=0, atol=SCORE_TOL)


def test_eos_stops_early_when_every_row_finishes():
    jm, tm = _models("llama")
    ids = _ids(3, (1, 5))
    ref, _ = _port_generate(tm, ids, max_new_tokens=6,
                            decode_strategy="greedy_search")
    eos = int(ref[0, 2])
    kw = dict(max_new_tokens=6, decode_strategy="greedy_search",
              eos_token_id=eos)
    port = _port_generate(tm, ids, **kw)
    stop = list(ref[0]).index(eos) + 1
    assert port[0].shape == (1, stop)
    np.testing.assert_array_equal(port[0][0], ref[0, :stop])
    _assert_same(port, _jax_generate(jm, ids, **kw))


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_repetition_penalty_matches_jax(family):
    jm, tm = _models(family)
    ids = _ids(4, (1, 6))
    kw = dict(max_new_tokens=8, decode_strategy="greedy_search",
              repetition_penalty=1.3)
    _assert_same(_port_generate(tm, ids, **kw), _jax_generate(jm, ids, **kw))
    # an extreme penalty: no token of the prompt or of the stream repeats
    # (tests/test_generation.py:105)
    out, _ = _port_generate(tm, ids, max_new_tokens=8,
                            decode_strategy="greedy_search",
                            repetition_penalty=1e6)
    seen = set(ids[0].tolist())
    for t in out[0]:
        assert int(t) not in seen
        seen.add(int(t))


def test_max_length_and_nonpositive_budgets():
    jm, tm = _models("llama")
    ids = _ids(5, (2, 4))
    a = _port_generate(tm, ids, max_length=7,
                       decode_strategy="greedy_search")
    b = _port_generate(tm, ids, max_new_tokens=3,
                       decode_strategy="greedy_search")
    assert a[0].shape == (2, 3)
    _assert_same(a, b)
    _assert_same(a, _jax_generate(jm, ids, max_length=7,
                                  decode_strategy="greedy_search"))
    for kw in (dict(max_new_tokens=0), dict(max_length=4),
               dict(max_new_tokens=-2)):
        with pytest.raises(ValueError, match="max_new_tokens must be"):
            tm.generate(ids, decode_strategy="greedy_search", **kw)


# ---- sampling ---------------------------------------------------------------

def test_sampling_follows_the_seed():
    """The same seed gives the same ids, another seed others
    (tests/test_generation.py:58); ``seed=None`` draws from torch's
    default generator."""
    _, tm = _models("llama")
    ids = _ids(1, (2, 4))
    kw = dict(max_new_tokens=6, decode_strategy="sampling", top_k=20,
              top_p=0.9, temperature=0.7)
    a = _port_generate(tm, ids, seed=42, **kw)
    b = _port_generate(tm, ids, seed=42, **kw)
    c = _port_generate(tm, ids, seed=43, **kw)
    _assert_same(a, b)
    assert not np.array_equal(a[0], c[0])
    assert a[0].max() < VOCAB and np.isfinite(a[1]).all()
    torch.manual_seed(7)
    d = _port_generate(tm, ids, **kw)
    torch.manual_seed(7)
    _assert_same(_port_generate(tm, ids, **kw), d)
    # the eos driver draws the same stream when no row finishes
    _assert_same(_port_generate(tm, ids, seed=42, eos_token_id=VOCAB, **kw),
                 a)


def test_top_k_1_sampling_is_greedy():
    """tests/test_generation.py:92."""
    _, tm = _models("llama")
    ids = _ids(3, (1, 5))
    k1, _ = _port_generate(tm, ids, max_new_tokens=4,
                           decode_strategy="sampling", top_k=1, seed=0)
    greedy, _ = _port_generate(tm, ids, max_new_tokens=4,
                               decode_strategy="greedy_search")
    np.testing.assert_array_equal(k1, greedy)


# ---- the logits pipeline ----------------------------------------------------

PROC_CASES = {
    # name: (temperature, top_k, top_p, repetition penalty, greedy)
    "greedy": (1.0, 0, 1.0, 1.0, True),
    "greedy_penalty": (0.7, 5, 0.5, 1.5, True),
    "temperature": (0.6, 0, 1.0, 1.0, False),
    "top_k": (1.0, 7, 1.0, 1.0, False),
    "top_p": (1.0, 0, 0.8, 1.0, False),
    "all": (0.8, 12, 0.9, 1.3, False),
}


@pytest.mark.parametrize("case", list(PROC_CASES))
def test_process_and_sample_matches_jax(case):
    """The JAX function picks a token; the port's processed logits give
    it the same logprob, and every token the JAX function may pick
    stays in the port's support (so the masks agree on it). Greedy
    picks are equal."""
    temperature, top_k, top_p, rep, greedy = PROC_CASES[case]
    rng = np.random.RandomState(11)
    b, vocab, L, wp = 6, 40, 10, 7
    logits = (2.0 * rng.randn(b, vocab)).astype(np.float32)
    # ties at some row's k-th value, and positive and negative seen ids
    logits[0, :4] = logits[0].max()
    buf = rng.randint(0, vocab, (b, L)).astype(np.int32)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, rep=rep,
              greedy=greedy)
    lg = tgen._process_logits(torch.from_numpy(logits),
                              torch.from_numpy(buf), wp, **kw)
    logp = torch.log_softmax(lg, -1).numpy()
    for seed in range(8):
        tok, lp, _, _, _ = jgen._process_and_sample(
            jnp.asarray(logits), jax.random.PRNGKey(seed), jnp.asarray(buf),
            jnp.asarray(wp, jnp.int32), jnp.zeros((b,), bool),
            eos_id=-1, pad_id=0, **kw)
        tok = np.asarray(tok)
        assert np.isfinite(logp[np.arange(b), tok]).all(), (seed, tok)
        np.testing.assert_allclose(logp[np.arange(b), tok], np.asarray(lp),
                                   rtol=0, atol=1e-5)
    if greedy:
        ttok, tlp, _ = tgen._process_and_sample(
            torch.from_numpy(logits), None, torch.from_numpy(buf.copy()), wp,
            torch.zeros(b, dtype=torch.bool), eos_id=-1, pad_id=0, **kw)
        np.testing.assert_array_equal(ttok.numpy(), tok)


def test_eos_and_pad_rules_match_jax():
    """A finished row picks the pad with logprob 0; a row that picks the
    eos finishes; the pick lands in the buffer at write_pos."""
    rng = np.random.RandomState(12)
    b, vocab, L, wp = 4, 30, 9, 5
    logits = rng.randn(b, vocab).astype(np.float32)
    eos = int(logits[1].argmax())
    buf = rng.randint(0, vocab, (b, L)).astype(np.int32)
    fin = np.array([True, False, False, True])
    kw = dict(temperature=1.0, top_k=0, top_p=1.0, rep=1.2, greedy=True,
              eos_id=eos, pad_id=3)
    jtok, jlp, _, jbuf, jfin = jgen._process_and_sample(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(buf),
        jnp.asarray(wp, jnp.int32), jnp.asarray(fin), **kw)
    tbuf = torch.from_numpy(buf.copy())
    ttok, tlp, tfin = tgen._process_and_sample(
        torch.from_numpy(logits), None, tbuf, wp, torch.from_numpy(fin), **kw)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=1e-6)
    assert tfin.numpy().tolist() == [True, True, False, True]
    assert ttok.numpy()[[0, 3]].tolist() == [3, 3]


def test_top_k_and_top_p_edge_rules():
    """Ties at the k-th logit stay; top-p keeps the first token whose
    cumulative mass crosses the threshold."""
    buf = torch.zeros(1, 1, dtype=torch.int32)
    lg = torch.tensor([[3.0, 3.0, 3.0, 1.0, 0.0]])
    out = tgen._process_logits(lg, buf, 0, temperature=1.0, top_k=2,
                               top_p=1.0, rep=1.0, greedy=False)
    assert torch.isfinite(out).tolist() == [[True, True, True, False,
                                             False]]
    p = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    for top_p, keep in ((0.4, 1), (0.6, 2), (0.85, 3), (0.97, 4)):
        out = tgen._process_logits(p.log(), buf, 0, temperature=1.0,
                                   top_k=0, top_p=top_p, rep=1.0,
                                   greedy=False)
        assert int(torch.isfinite(out).sum()) == keep, (top_p, out)


# ---- the dense cache --------------------------------------------------------

def test_sdpa_with_cache_matches_jax_at_prefill_and_decode():
    """GQA (4 query heads on 2 kv heads): a 7-token prefill at pos 0,
    then a 1-token decode at pos 7, both against the JAX function on
    the caches each produced."""
    rng = np.random.RandomState(13)
    B, H, KV, D, max_len = 2, 4, 2, 16, 12
    kc = np.zeros((B, max_len, KV, D), np.float32)
    vc = np.zeros_like(kc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    jk, jv = paddle.to_tensor(kc), paddle.to_tensor(vc)
    for pos, S in ((0, 7), (7, 1)):
        q, k, v = (rng.randn(B, S, h, D).astype(np.float32)
                   for h in (H, KV, KV))
        jout, jk, jv = jsdpa_with_cache(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            jk, jv, paddle.to_tensor(np.int32(pos)))
        tout, tk, tv = F.sdpa_with_cache(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tk, tv, pos)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout.numpy()),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk.numpy()))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
    # a 0-d tensor position writes and masks the same way
    q = torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32))
    kv = torch.from_numpy(rng.randn(B, 1, KV, D).astype(np.float32))
    a = F.sdpa_with_cache(q, kv, kv, tk.clone(), tv.clone(), 8)
    b = F.sdpa_with_cache(q, kv, kv, tk.clone(), tv.clone(),
                          torch.tensor(8, dtype=torch.int32))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_init_kv_cache_follows_the_weights():
    """Dense caches on the weights' device, in the first floating
    parameter's dtype (bf16 for a bf16 model), and ``generate`` leaves
    the weights where they are."""
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    caches = m.init_kv_cache(3, 11)
    assert len(caches) == 2 * cfg.num_hidden_layers
    assert {(tuple(c.shape), c.dtype, c.device.type) for c in caches} == {
        ((3, 11, cfg.num_key_value_heads, cfg.head_dim), torch.bfloat16,
         "cpu")}
    out, scores = m.generate([[1, 2, 3]], max_new_tokens=2,
                             decode_strategy="greedy_search")
    assert out.device.type == "cpu" and out.shape == (1, 2)
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert torch.isfinite(scores).all()


# ---- the engines against dense generate -------------------------------------

SPECS = [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]   # (prompt, new)


@pytest.mark.parametrize("unified", [True, False])
def test_engine_streams_equal_dense_generate(unified):
    """tests/test_serving.py:33/:160 on the port: 5 mixed-length
    requests through 2 slots (drains and re-admissions); every greedy
    stream equals the dense ``generate`` of its prompt alone."""
    _, tm = _models("llama")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, (p,)).astype(np.int32)
               for p, _ in SPECS]
    eng = ContinuousBatchingEngine(tm, num_slots=2, page_size=8, max_len=64,
                                   decode_chunk=4, prefill_chunk=16,
                                   unified=unified, device="cpu")
    ids = [eng.add_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    by = {r.request_id: r.tokens for r in eng.run()}
    for rid, p, (_, n) in zip(ids, prompts, SPECS):
        ref, _ = tm.generate(p[None], max_new_tokens=n,
                             decode_strategy="greedy_search")
        assert by[rid] == ref[0].tolist(), (rid, by[rid], ref)
