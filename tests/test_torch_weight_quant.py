"""The port's weight-only serving quantization (paddle_tpu_torch.nn.quant)
against the JAX package's (paddle_tpu.nn.quant), on the CPU:

- ``weight_quantize``'s int8 and int4 codes equal the JAX ones and its
  scales are the same f32 quotients;
- the int4 nibble packing round-trips, in the port's own layout, with the
  JAX package's byte count;
- ``WeightOnlyLinear`` against the JAX layer on the same weights and
  input, and against the plain product within the JAX tests' bounds
  (tests/test_quant_serving.py:390-461);
- ``quantize_for_serving``: the targets, idempotence, a tied embedding,
  the ``quant/*`` gauges, and bytes equal to the JAX function's;
- the ``weight_quant`` config check;
- an engine over a ``weight_only_int8`` (and ``_int4``) tiny Llama gives
  the JAX engine's greedy streams, with full-precision pools.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.nn import quant as jquant
from paddle_tpu.profiler import metrics as jmetrics

from paddle_tpu_torch import convert
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2Config)
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.profiler.metrics import get_registry

torch.set_num_threads(1)

ALGOS = ("weight_only_int8", "weight_only_int4")


def _weights(seed, shape=(24, 10)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    w[:, 3] = 0.0                   # an all-zero channel: scale 0
    w[5, 7] = 9.0                   # one large element in a channel
    return w


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_matches_jax(algo):
    w = _weights(0)
    jq, js = jquant.weight_quantize(Tensor(jnp.asarray(w)), algo=algo)
    tq, ts = tquant.weight_quantize(torch.from_numpy(w), algo)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()))
    # absmax / range: the same f32 division on both sides
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=2 ** -22, atol=0)
    lo = -127 if algo == "weight_only_int8" else -8
    hi = 127 if algo == "weight_only_int8" else 7
    assert tq.min() >= lo and tq.max() <= hi


def test_int4_pack_roundtrip():
    rng = np.random.RandomState(5)
    for cols in (6, 7):                      # even and odd in_features
        codes = torch.from_numpy(
            rng.randint(-8, 8, (5, cols)).astype(np.int8))
        packed = tquant.pack_int4(codes)
        assert packed.dtype == torch.int8
        assert packed.shape == (5, (cols + 1) // 2)
        # the JAX package packs [in, out] along in: the same byte count
        assert jquant._pack_int4(codes.numpy().T).shape == \
            packed.shape[::-1]
        assert torch.equal(tquant.unpack_int4(packed, cols), codes)
    every = torch.arange(-8, 8, dtype=torch.int8)[None].repeat(2, 1)
    assert torch.equal(tquant.unpack_int4(tquant.pack_int4(every), 16),
                       every)


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_matches_jax(algo):
    """The JAX layer takes w [in, out], the port's the Linear layout [out,
    in]. The codes and scales are the same; the products differ only in
    the order of their f32 sums."""
    rng = np.random.RandomState(9)
    w = rng.randn(16, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    x = rng.randn(3, 16).astype(np.float32)
    jl = jquant.WeightOnlyLinear(Tensor(jnp.asarray(w)),
                                 bias=Tensor(jnp.asarray(b)), algo=algo)
    tl = tquant.WeightOnlyLinear(torch.from_numpy(w.T.copy()),
                                 bias=torch.from_numpy(b), algo=algo)
    assert tl.weight_q.numel() == int(np.prod(jl.weight_q._data.shape))
    np.testing.assert_array_equal(
        tl.codes().numpy().T,
        np.asarray(jquant.weight_quantize(Tensor(jnp.asarray(w)),
                                          algo=algo)[0].numpy()))
    got = tl(torch.from_numpy(x)).numpy()
    want = np.asarray(jl(Tensor(jnp.asarray(x)))._data)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the JAX test's bounds against the plain product: a per-weight error
    # of at most absmax / (2 r), summed over 16 terms
    plain = x @ w + b
    assert np.abs(got - plain).max() < (0.05 if algo == "weight_only_int8"
                                        else 2.0)
    # buffers, not parameters; a 3-D input and a bf16 one run too
    assert not list(tl.parameters())
    assert tl(torch.from_numpy(x).reshape(1, 3, 16)).shape == (1, 3, 12)
    assert tl(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="weight_quant algo"):
        tquant.WeightOnlyLinear(torch.from_numpy(w.T.copy()),
                                algo="weight_only_fp4")


def _models(tie=False, seed=1):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.tie_word_embeddings = tie
    paddle.seed(seed)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = dataclasses.replace(LlamaConfig.tiny(), tie_word_embeddings=tie)
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(tcfg, device="cpu"), arrays)
    return jm, tm


@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_for_serving_matches_jax(algo):
    jm, tm = _models()
    want = jquant.quantize_for_serving(jm, algo=algo)
    got = tquant.quantize_for_serving(tm, algo=algo)
    n = tm.config.num_hidden_layers
    assert got == want
    assert got["layers"] == 7 * n + 1 and got["bytes_saved"] > 0
    assert isinstance(tm.lm_head, tquant.WeightOnlyLinear)
    assert isinstance(tm.llama.layers[0].mlp.down_proj,
                      tquant.WeightOnlyLinear)
    reg, jreg = get_registry(), jmetrics.get_registry()
    for name in ("quant/weight_layers", "quant/weight_bytes",
                 "quant/weight_bytes_saved"):
        assert reg.get(name).value == jreg.get(name).value
    # idempotent; the converted model still runs a cacheless forward
    assert tquant.quantize_for_serving(tm, algo=algo)["layers"] == 0
    ids = np.arange(6, dtype=np.int32).reshape(1, 6)
    out = tm(torch.from_numpy(ids))
    assert out.shape == (1, 6, tm.config.vocab_size)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm(Tensor(jnp.asarray(ids)))._data),
                               rtol=1e-4, atol=1e-4)


def test_quantize_for_serving_skips_tied_embeddings():
    jm, tm = _models(tie=True, seed=2)
    assert tm.lm_head is None
    got = tquant.quantize_for_serving(tm, algo="weight_only_int8")
    assert got == jquant.quantize_for_serving(jm, algo="weight_only_int8")
    assert got["layers"] == 7 * tm.config.num_hidden_layers
    # a config without weight_quant: nothing to do
    plain = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert tquant.quantize_for_serving(plain)["layers"] == 0
    assert isinstance(plain.lm_head, torch.nn.Linear)


def test_config_rejects_unknown_weight_quant():
    for cls in (LlamaConfig, Qwen2Config):
        with pytest.raises(ValueError, match="weight_quant"):
            dataclasses.replace(cls.tiny(), weight_quant="int5")
        assert cls(weight_quant="weight_only_int4").weight_quant \
            == "weight_only_int4"


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_engine_matches_jax(algo):
    """The engine converts a model whose config sets weight_quant (the
    JAX engine's ctor does the same) and serves the JAX engine's greedy
    streams; its pools keep the model's float dtype."""
    jm, tm = _models(seed=0)
    jm.config.weight_quant = algo
    tm.config.weight_quant = algo
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 256, (int(rng.randint(5, 14)),)).astype(
        np.int32) for _ in range(5)]
    kw = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(16,), greedy=True, audit=True)
    streams = {}
    for side, eng in (("jax", JEngine(jm, **kw)),
                      ("torch", ContinuousBatchingEngine(tm, device="cpu",
                                                         **kw))):
        ids = [eng.add_request(p, 8) for p in prompts]
        by = {r.request_id: r for r in eng.run()}
        streams[side] = [by[i].tokens for i in ids]
    assert isinstance(tm.lm_head, tquant.WeightOnlyLinear)
    assert eng.pools[0].dtype == torch.float32
    assert streams["torch"] == streams["jax"]
    assert all(len(t) == 8 for t in streams["torch"])
