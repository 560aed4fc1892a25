"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the engine on the card against the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere (the kernels
have no CPU mode). The file imports neither JAX nor the JAX package, so
it runs on a GPU host with PyTorch alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as krpa
from paddle_tpu_torch.ops.kernels import rms_norm as krms
from paddle_tpu_torch.ops.kernels import swiglu as ksw

pytestmark = pytest.mark.cuda

# bf16 keeps 8 significant bits: one ulp is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _assert_close(out, ref, tol):
    """Element by element: ``tol`` holds each element's limit."""
    err = (out.float() - ref.float()).abs()
    assert (err <= tol).all(), (err / tol).max().item()


def _tol(ref, dtype, ulps):
    """Per element. f32: summation order and the last bits of exp;
    bf16: ``ulps`` ulps of each |ref|."""
    mag = ref.float().abs()
    return (1e-5 if dtype == torch.float32 else ulps * BF16_ULP) * mag + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 4096), (37, 4096), (5, 100)])
def test_rms_norm_kernel(cuda, dtype, n, d):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, device=cuda, generator=g).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    before = krms.rms_norm.launches
    y = krms.rms_norm(x, w, 1e-5)
    ref = krms.rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    assert krms.rms_norm.launches == before + 1
    # bf16: the same rounding points; the statistics' summation order may
    # move x*inv by one ulp, which the product carries to three
    _assert_close(y, ref, _tol(ref, dtype, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 14336), (3, 7, 13)])
def test_swiglu_kernel(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    gate = (2 * torch.randn(*shape, device=cuda, generator=g)).to(dtype)
    up = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    out = ksw.swiglu(gate, up)
    ref = ksw.swiglu_reference(gate, up)
    torch.cuda.synchronize()
    # bf16: the kernel rounds once from f32, the plain version twice
    _assert_close(out, ref, _tol(ref, dtype, 2))
    # against silu(g)*u in f32 rounded once, as the kernel computes it
    once = (torch.nn.functional.silu(gate.float()) * up.float()).to(dtype)
    _assert_close(out, once, _tol(once, dtype, 1))


def _ragged(cuda, dtype, H, KVH, D, page, C=24, seed=0):
    rng = np.random.RandomState(seed)
    lengths = np.array([0, 1, 5, C, 1, 17][:6], np.int32)
    lengths = np.minimum(lengths, C)
    ctx = np.array([3, 40, 0, 7, 0, 61], np.int32)
    B = len(lengths)
    pages = -(-int((ctx + lengths).max()) // page) + 1
    P = B * pages + 1
    tables = (rng.permutation(P - 1) + 1)[:B * pages].reshape(
        B, pages).astype(np.int32)
    for b in range(B):
        tables[b, -(-(int(ctx[b]) + int(lengths[b])) // page):] = 0
    g = torch.Generator(device=cuda).manual_seed(seed)
    kp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(KVH, P, page, D, device=cuda, generator=g).to(dtype)
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn(B, C, H, D, device=cuda, generator=g).to(dtype)
    ints = [torch.from_numpy(a).to(cuda) for a in (tables, ctx, lengths)]
    return (q, kp, vp, *ints), lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,D,page", [(32, 8, 128, 16), (8, 8, 64, 8),
                                          (16, 2, 32, 16), (4, 1, 256, 4)])
def test_ragged_paged_attention_kernel(cuda, dtype, H, KVH, D, page):
    args, lengths = _ragged(cuda, dtype, H, KVH, D, page)
    out = krpa.ragged_paged_attention(*args)
    ref = krpa.ragged_paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()       # NaN trash page never read
    for b, n in enumerate(lengths):
        assert not out[b, n:].any()        # rows past the length: zero
    # per element; a = sum_i p_i |v_i| scales an output's rounding error
    q, kp, vp, *ints = args
    f32 = [t.float() for t in (q, kp, vp)]
    a = krpa.ragged_paged_attention_reference(f32[0], f32[1], f32[2].abs(),
                                              *ints).float()
    ref32 = krpa.ragged_paged_attention_reference(*f32, *ints)
    if dtype == torch.float32:
        # summation order and exp only
        _assert_close(out, ref, 1e-5 * a + 1e-6)
    else:
        # the plain version rounds each probability to bf16 before P.V
        # (2^-8 * a at most), and each side rounds its output
        _assert_close(out, ref, 1.01 * (2 ** -8 * a + BF16_ULP
                                        * ref.float().abs()) + 1e-6)
        # the kernel keeps f32 up to its output's rounding: one ulp
        _assert_close(out, ref32, BF16_ULP * ref32.abs() + 1e-5 * a + 1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        krms.rms_norm(x.t(), torch.ones(8, device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ksw.swiglu(x.half(), x.half())
    args, _ = _ragged(cuda, torch.float32, 6, 2, 64, 16)   # rep 3
    with pytest.raises(ValueError, match="must divide"):
        krpa.ragged_paged_attention(*args)


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(LlamaConfig.tiny(), hidden_size=128,
                              intermediate_size=256)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu_model = LlamaForCausalLM(cfg, device=cuda, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(1)
    specs = [(rng.randint(0, cfg.vocab_size, p), n)
             for p, n in [(5, 7), (13, 4), (9, 11), (21, 6), (3, 8)]]
    streams = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
        eng = ContinuousBatchingEngine(model, num_slots=2, page_size=8,
                                       max_len=64, decode_chunk=4,
                                       prefill_chunk=16, device=dev)
        for prompt, n in specs:
            eng.add_request(prompt, n)
        streams.append([r.tokens for r in sorted(
            eng.run(), key=lambda r: r.request_id)])
        assert len(eng._free_pages) == eng.num_pages - 1
    assert streams[0] == streams[1]
