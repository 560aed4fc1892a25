"""Quantized-KV serving and the decode paged-attention entry point of the
port (paddle_tpu_torch) against the JAX package, on the CPU at tiny sizes:

- the KV codec (``quantize_kv``) for int8 and fp8: int8 codes equal,
  fp8 codes equal as bit patterns, scales within two f32 ulps;
- ``paged_prefill_write_quant``'s trash routing against JAX's, on the
  case of ``tests/test_quant_serving.py``;
- the plain K13 (the ragged reference over int8/fp8 pools with their
  scales) against JAX's jnp oracle, which is what the JAX package holds
  its Pallas kernel against (that kernel does not trace under the
  installed jax, ROADMAP §C); and within the JAX bar (< 0.1) of the
  full-precision attention;
- the engine with ``kv_quant="int8"`` and ``"fp8"`` on the tiny Llama and
  the tiny Qwen2-MoE: greedy streams token-identical to the JAX engine's
  with the same weights and ``kv_quant``; the ``kv_quant_*`` gauges; an
  unknown mode; a pool too small for every slot at once;
- ``incubate.nn.functional.paged_attention`` and
  ``block_multihead_attention`` (the plain K16) against JAX's.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.models import Qwen2MoeConfig as JQwen2MoeConfig
from paddle_tpu.models import Qwen2MoeForCausalLM as JQwen2MoeForCausalLM
from paddle_tpu.ops import paged_attention as JPA

from paddle_tpu_torch import convert
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Qwen2MoeConfig, Qwen2MoeForCausalLM)
from paddle_tpu_torch.ops import paged_attention as TPA

torch.set_num_threads(1)

MODES = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7


def _codes(a):
    """Codes of either package as integers: fp8 as its bit pattern."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
             else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _to_torch_codes(a, tdtype):
    """JAX codes -> a torch tensor of ``tdtype`` with the same bits."""
    a = np.asarray(a)
    if tdtype == torch.int8:
        return torch.from_numpy(a.astype(np.int8))
    return torch.from_numpy(a.view(np.uint8).copy()).view(tdtype)


# ---- the codec and the quantized write -----------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(mode, dtype):
    tq, jq = MODES[mode]
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 2, 16) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero vector: scale 1/range
    x[1, 2, 1, 3] = 40.0                 # one large element in a vector
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jc, js = JPA.quantize_kv(jx, jq)
    tc, ts = TPA.quantize_kv(tx, tq)
    assert tc.dtype == tq and ts.dtype == torch.float32
    assert tc.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(_codes(tc), _codes(jc))
    # an f32 quotient a / range: the same division on both sides
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 ** -22,
                               atol=0)
    assert TPA.kv_quant_range(tq) == JPA.kv_quant_range(jq)
    # dequantize: codes times scale, f32 products
    np.testing.assert_allclose(
        TPA.dequantize_pages(tc, ts).numpy(),
        np.asarray(JPA.dequantize_pages(jc, js)), rtol=2 ** -21, atol=0)


def test_kv_quant_range_refuses_a_float_pool():
    with pytest.raises(ValueError, match="quantized KV pool dtype"):
        TPA.kv_quant_range(torch.bfloat16)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_write_trash_routing_matches_jax(mode):
    """The case of tests/test_quant_serving.py: slot 0 writes 3 valid
    tokens, slot 1 two; padding goes to trash page 0, codes and scales
    alike, and the two packages write the same pools."""
    tq, jq = MODES[mode]
    kvh, P, page, d = 2, 6, 4, 8
    B, C = 2, 4
    rng = np.random.RandomState(1)
    k = rng.randn(B, C, kvh, d).astype(np.float32)
    v = rng.randn(B, C, kvh, d).astype(np.float32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    ctx = np.array([0, 0], np.int32)
    valid = np.array([3, 2], np.int32)
    jpools = JPA.paged_prefill_write_quant(
        jnp.zeros((kvh, P, page, d), jq), jnp.zeros((kvh, P, page, d), jq),
        jnp.zeros((kvh, P, page), jnp.float32),
        jnp.zeros((kvh, P, page), jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(ctx), jnp.asarray(valid))
    tpools = [torch.zeros(kvh, P, page, d, dtype=tq),
              torch.zeros(kvh, P, page, d, dtype=tq),
              torch.zeros(kvh, P, page), torch.zeros(kvh, P, page)]
    TPA.paged_prefill_write_quant(*tpools, torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(ctx),
                                  torch.from_numpy(valid))
    for i in (0, 1):
        np.testing.assert_array_equal(_codes(tpools[i]), _codes(jpools[i]))
    for i in (2, 3):
        np.testing.assert_allclose(tpools[i].numpy(), np.asarray(jpools[i]),
                                   rtol=2 ** -22, atol=0)
    codes = _codes(tpools[0])
    assert not codes[:, 2].any() and not codes[:, 4].any()
    assert codes[:, 0].any() and tpools[2][:, 0].any()


# ---- the plain K13 ---------------------------------------------------------

def _mixed_batch(rep, kvh=2, d=16, page=4, seed=3):
    """A ragged batch with idle, one-token, decode and prefill slots."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, 4, 1, 6, 2], np.int32)
    ctx = np.array([5, 0, 9, 13, 2, 0], np.int32)
    B, C, H = len(lengths), 6, rep * kvh
    pages = -(-int((ctx + lengths).max()) // page)
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1).reshape(B, pages).astype(np.int32)
    for b in range(B):      # table padding points at the trash page
        tables[b, -(-(int(ctx[b]) + int(lengths[b])) // page):] = 0
    q = rng.randn(B, C, H, d).astype(np.float32)
    kp = rng.randn(kvh, P, page, d).astype(np.float32)
    vp = rng.randn(kvh, P, page, d).astype(np.float32)
    return q, kp, vp, tables, ctx, lengths


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("rep", [1, 2, 7])
def test_quant_ragged_reference_matches_jax(mode, rep):
    tq, jq = MODES[mode]
    q, kp, vp, tables, ctx, lengths = _mixed_batch(rep)
    (jk, jks), (jv, jvs) = (JPA.quantize_kv(jnp.asarray(kp), jq),
                            JPA.quantize_kv(jnp.asarray(vp), jq))
    ints = [jnp.asarray(a) for a in (tables, ctx, lengths)]
    ref = np.asarray(JPA.ragged_paged_attention_reference(
        jnp.asarray(q), jk, jv, *ints, k_scales=jks, v_scales=jvs))
    tints = [torch.from_numpy(a) for a in (tables, ctx, lengths)]
    tk, tv = _to_torch_codes(jk, tq), _to_torch_codes(jv, tq)
    tks, tvs = (torch.from_numpy(np.array(a)) for a in (jks, jvs))
    out = TPA.ragged_paged_attention(torch.from_numpy(q), tk, tv, *tints,
                                     k_scales=tks, v_scales=tvs)
    assert out.dtype == torch.float32
    # the same f32 dequantized values; summation order and exp only
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()
    # quantization error against the full-precision attention: the JAX
    # package's bar (tests/test_quant_serving.py)
    full = TPA.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        *tints)
    assert (out - full).abs().max().item() < 0.1
    # bf16 q: the output comes back in q's dtype, within a bf16 rounding
    out16 = TPA.ragged_paged_attention(
        torch.from_numpy(q).bfloat16(), tk, tv, *tints, k_scales=tks,
        v_scales=tvs)
    assert out16.dtype == torch.bfloat16
    ref16 = np.asarray(JPA.ragged_paged_attention_reference(
        jnp.asarray(q, jnp.bfloat16), jk, jv, *ints, k_scales=jks,
        v_scales=jvs).astype(jnp.float32))
    np.testing.assert_allclose(out16.float().numpy(), ref16,
                               rtol=BF16_ULP, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_ragged_reference_never_reads_the_trash_page(mode):
    """Non-finite codes (fp8) or scales on trash page 0, which the tables'
    padding names, change no output."""
    tq, _ = MODES[mode]
    q, kp, vp, tables, ctx, lengths = _mixed_batch(2)
    tints = [torch.from_numpy(a) for a in (tables, ctx, lengths)]
    tk, tks = TPA.quantize_kv(torch.from_numpy(kp), tq)
    tv, tvs = TPA.quantize_kv(torch.from_numpy(vp), tq)
    args = (torch.from_numpy(q), tk, tv, *tints)
    clean = TPA.ragged_paged_attention(*args, k_scales=tks, v_scales=tvs)
    for t in (tks, tvs):
        t[:, 0] = float("nan")
    if mode == "fp8":
        for t in (tk, tv):
            t.view(torch.uint8)[:, 0] = 0x7F           # e4m3 NaN
    dirty = TPA.ragged_paged_attention(*args, k_scales=tks, v_scales=tvs)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)


# ---- the engine ---------------------------------------------------------------

SPECS = [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]   # (prompt, new)
ENGINE = dict(num_slots=2, page_size=8, max_len=64, decode_chunk=4)
KV_GAUGES = ("kv_quant_bits", "kv_quant_pool_bytes",
             "kv_quant_scale_pool_bytes")


def _prompts(specs=SPECS, seed=1, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (p,)).astype(np.int32) for p, _ in specs]


@pytest.fixture(scope="module")
def llamas():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"), arrays)
    return jm, tm


@pytest.fixture(scope="module")
def qwen2_moes():
    jcfg, tcfg = JQwen2MoeConfig.tiny(), Qwen2MoeConfig.tiny()
    jcfg.moe_dropless = tcfg.moe_dropless = True
    paddle.seed(0)
    jm = JQwen2MoeForCausalLM(jcfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = convert.from_numpy_state_dict(
        Qwen2MoeForCausalLM(tcfg, device="cpu"), arrays)
    tm.eval()
    return jm, tm


def _jax_run(jm, kv_quant, specs=SPECS, **kw):
    eng = JEngine(jm, prompt_buckets=(8, 16, 32), greedy=True,
                  prefix_cache=False, kv_quant=kv_quant, **{**ENGINE, **kw})
    ids = [eng.add_request(p, n) for p, (_, n) in zip(_prompts(specs), specs)]
    by = {r.request_id: r.tokens for r in eng.run()}
    return [by[i] for i in ids], eng


def _port_run(tm, kv_quant, specs=SPECS, **kw):
    eng = ContinuousBatchingEngine(tm, prefill_chunk=32, device="cpu",
                                   kv_quant=kv_quant, **{**ENGINE, **kw})
    ids = [eng.add_request(p, n) for p, (_, n) in zip(_prompts(specs), specs)]
    by = {r.request_id: r for r in eng.run()}
    assert len(eng._free_pages) + eng.prefix_cache_pages \
        == eng.num_pages - 1
    return [by[i].tokens for i in ids], eng


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("model", ["llama", "qwen2_moe"])
def test_quant_engine_streams_match_jax_engine(mode, model, request):
    jm, tm = request.getfixturevalue(
        "llamas" if model == "llama" else "qwen2_moes")
    ref, jeng = _jax_run(jm, mode)
    got, teng = _port_run(tm, mode)
    for (_, n), a, b in zip(SPECS, got, ref):
        assert len(b) == n
        assert a == b, (a, b)
    # four pools a layer: the codes and their f32 scales
    L = tm.config.num_hidden_layers
    assert len(teng.pools) == 4 * L
    assert teng.pools[0].dtype == MODES[mode][0]
    assert teng.pools[2].dtype == torch.float32
    assert teng.pools[2].shape == teng.pools[0].shape[:3]
    jg, tg = jeng.gauges(), teng.gauges()
    assert {k: tg[k] for k in KV_GAUGES} == {k: jg[k] for k in KV_GAUGES}


def test_unquantized_engine_gauges_match_jax(llamas):
    jm, tm = llamas
    jg = JEngine(jm, prompt_buckets=(32,), prefix_cache=False,
                 **ENGINE).gauges()
    tg = ContinuousBatchingEngine(tm, device="cpu", **ENGINE).gauges()
    assert tg == {k: jg[k] for k in tg}
    assert tg["kv_quant_bits"] == 32 and tg["kv_quant_scale_pool_bytes"] == 0


def test_engine_refuses_an_unknown_kv_quant(llamas):
    _, tm = llamas
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatchingEngine(tm, device="cpu", kv_quant="int4", **ENGINE)


def test_small_pool_makes_admission_wait(llamas):
    """Six pages (five usable) hold one or two of the five requests at a
    time: admission waits for pages, and the streams are those of a pool
    that holds every slot."""
    jm, tm = llamas
    ref, _ = _jax_run(jm, "int8")
    eng = ContinuousBatchingEngine(tm, prefill_chunk=32, device="cpu",
                                   kv_quant="int8", num_pages=6, **ENGINE)
    assert eng.pools[0].shape[1] == 6 and eng.pools[2].shape[1] == 6
    ids = [eng.add_request(p, n) for p, (_, n) in zip(_prompts(), SPECS)]
    waited = False
    done = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        done += eng.step()
        free_slot = any(r is None for r in eng.slot_req)
        waited |= bool(eng.queue) and free_slot
    by = {r.request_id: r.tokens for r in done}
    assert waited
    assert [by[i] for i in ids] == ref
    assert len(eng._free_pages) + eng.prefix_cache_pages == 5
    with pytest.raises(ValueError, match="pages"):
        eng.add_request(np.arange(40), 20)      # 8 pages, 5 allocatable


# ---- incubate.nn.functional.paged_attention (the plain K16) ------------------

def _decode_batch(rep, dtype, kvh=2, d=16, page=4, seed=5):
    rng = np.random.RandomState(seed)
    ctx = np.array([7, 1, 0, 16, 12], np.int64)    # one sequence empty
    B, H, pages = len(ctx), rep * kvh, 5
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1).reshape(B, pages).astype(np.int64)
    for b in range(B):      # table padding points at the trash page
        tables[b, -(-int(ctx[b]) // page):] = 0
    q = rng.randn(B, H, d).astype(np.float32)
    kp = rng.randn(kvh, P, page, d).astype(np.float32)
    vp = rng.randn(kvh, P, page, d).astype(np.float32)
    kp[:, 0] = vp[:, 0] = 0.0
    return q, kp, vp, tables, ctx


@pytest.mark.parametrize("fn", ["paged_attention",
                                "block_multihead_attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_incubate_paged_attention_matches_jax(fn, dtype, rep):
    q, kp, vp, tables, ctx = _decode_batch(rep, dtype)
    jargs = [paddle.to_tensor(jnp.asarray(a, jnp.dtype(dtype)))
             for a in (q, kp, vp)]
    ref = getattr(JIF, fn)(*jargs, paddle.to_tensor(tables),
                           paddle.to_tensor(ctx))
    ref = np.asarray(ref.numpy(), np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kp, vp))
    # the port's pools get a NaN trash page: masked, never read
    tk[:, 0] = float("nan")
    tv[:, 0] = float("nan")
    out = getattr(TIF, fn)(tq, tk, tv, torch.from_numpy(tables),
                           torch.from_numpy(ctx))
    assert out.dtype == tdt and out.shape == tq.shape
    assert torch.isfinite(out).all()
    seen = ctx > 0
    # context_len == 0: zeros (the jnp oracle averages every gathered row
    # there, ROADMAP §C), so that row is left out of the comparison
    assert not out[~torch.from_numpy(seen)].any()
    out = out.float().numpy()[seen]
    ref = ref[seen]
    if dtype == "float32":
        # the same f32 math; summation order and exp only
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    else:
        # both round each probability to bf16 before P.V, from f32 logits
        # that may differ in their last bit (2^-8 of sum p|v| at most),
        # and each rounds its output (one ulp of |ref|)
        kq = torch.from_numpy(kp).bfloat16().float()
        vq = torch.from_numpy(vp).bfloat16().float().abs()
        a = TIF.paged_attention(torch.from_numpy(q).bfloat16().float(), kq,
                                vq, torch.from_numpy(tables),
                                torch.from_numpy(ctx)).numpy()[seen]
        tol = 2 ** -8 * a + BF16_ULP * np.abs(ref) + 1e-6
        assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()
