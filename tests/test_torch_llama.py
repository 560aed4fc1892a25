"""The port's Llama (paddle_tpu_torch.models.llama) against the JAX
package's on LlamaConfig.tiny(): the weight bridge, and paged forward
steps over the same pools (logits and updated pools). Also the port's
import hygiene and device rule."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_model(tie=False):
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.tie_word_embeddings = tie
    paddle.seed(0)
    m = JLlamaForCausalLM(cfg)
    m.eval()
    return m


def _arrays(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(jm, tie=False):
    cfg = LlamaConfig.tiny()
    cfg.tie_word_embeddings = tie
    return convert.from_numpy_state_dict(
        LlamaForCausalLM(cfg, device="cpu"), _arrays(jm))


def test_bridge_transposes_linear_weights_only():
    jm = _jax_model()
    arrays = _arrays(jm)
    tm = _port_model(jm)
    sd = tm.state_dict()
    assert set(sd) == set(arrays)
    q = "llama.layers.0.self_attn.q_proj.weight"
    k = "llama.layers.1.self_attn.k_proj.weight"
    np.testing.assert_array_equal(sd[q].numpy(), arrays[q].T)
    np.testing.assert_array_equal(sd[k].numpy(), arrays[k].T)
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy(),
                                  arrays["lm_head.weight"].T)
    for key in ("llama.embed_tokens.weight", "llama.norm.weight",
                "llama.layers.0.input_layernorm.weight"):
        np.testing.assert_array_equal(sd[key].numpy(), arrays[key])
    with pytest.raises(KeyError, match="missing"):
        convert.from_numpy_state_dict(
            tm, {k: v for k, v in arrays.items() if k != q})
    with pytest.raises(KeyError, match="unexpected"):
        convert.from_numpy_state_dict(tm, {**arrays, "extra.weight":
                                           arrays[q]})


def _jax_step(jm, ids, pools, ctx, tables, lengths):
    caches = [paddle.to_tensor(p) for p in pools]
    logits, new = jm(paddle.to_tensor(ids), caches=caches,
                     pos=paddle.to_tensor(ctx[:, None]),
                     tables=(paddle.to_tensor(tables),
                             paddle.to_tensor(lengths)))
    return np.asarray(logits.numpy()), [np.asarray(t.numpy()) for t in new]


@pytest.mark.parametrize("tie", [False, True])
def test_paged_forward_steps_match_jax(tie):
    jm = _jax_model(tie)
    tm = _port_model(jm, tie)
    cfg = LlamaConfig.tiny()
    rng = np.random.RandomState(11)
    B, C, page, pages = 3, 8, 4, 5
    P = B * pages + 1
    shape = (cfg.num_key_value_heads, P, page, cfg.head_dim)
    pools = [np.zeros(shape, np.float32)
             for _ in range(2 * cfg.num_hidden_layers)]
    tables = (rng.permutation(P - 1) + 1)[:B * pages].reshape(
        B, pages).astype(np.int32)
    tpools = [torch.from_numpy(p.copy()) for p in pools]
    # step 1: two prefill chunks (8 and 5 tokens) and an idle slot;
    # step 2: slot 0 streams 6 more tokens across a page boundary,
    # slot 1 decodes one token, slot 2 stays idle
    steps = [(np.array([0, 0, 0], np.int32), np.array([8, 5, 0], np.int32)),
             (np.array([8, 5, 0], np.int32), np.array([6, 1, 0], np.int32))]
    for ctx, lengths in steps:
        ids = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
        jl, pools = _jax_step(jm, ids, pools, ctx, tables, lengths)
        tl, _ = tm(torch.from_numpy(ids), caches=tpools,
                   pos=torch.from_numpy(ctx[:, None]),
                   tables=(torch.from_numpy(tables),
                           torch.from_numpy(lengths)))
        # f32 on both sides through two layers; matmul and softmax sum
        # in another order
        np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-4,
                                   atol=1e-4)
        for tp, jp in zip(tpools, pools):
            # real pages (page 0 is the trash page)
            np.testing.assert_allclose(tp.numpy()[:, 1:], jp[:, 1:],
                                       rtol=1e-5, atol=1e-5)
        assert all(torch.isfinite(p).all() for p in tpools)


def test_rope_positions_past_the_table_are_clamped():
    """A chunk whose padding runs past max_position_embeddings must not
    index past the RoPE table (on the device that faults)."""
    cfg = LlamaConfig.tiny()
    tm = LlamaForCausalLM(cfg, device="cpu", seed=1)
    page, pages = 16, cfg.max_position_embeddings // 16 + 1
    shape = (cfg.num_key_value_heads, pages + 1, page, cfg.head_dim)
    pools = [torch.zeros(shape) for _ in range(2 * cfg.num_hidden_layers)]
    tables = torch.arange(1, pages + 1, dtype=torch.int32)[None]
    ids = torch.randint(0, cfg.vocab_size, (1, 8))
    ctx = torch.tensor([cfg.max_position_embeddings - 2], dtype=torch.int32)
    logits, _ = tm(ids, caches=pools, pos=ctx,
                   tables=(tables, torch.tensor([2])))
    assert torch.isfinite(logits).all()


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import chip_smoke\n"
            "import paddle_tpu_torch, paddle_tpu_torch.convert\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.ops.paged_attention\n"
            "import paddle_tpu_torch.ops.kernels._build\n"
            "import paddle_tpu_torch.ops.kernels.flash_attention\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.nn\n"
            "import paddle_tpu_torch.framework.flags\n"
            "import paddle_tpu_torch.incubate.recompute\n"
            "import paddle_tpu_torch.io, paddle_tpu_torch.hapi\n"
            "import paddle_tpu_torch.ops.fused_ce\n"
            "import paddle_tpu_torch.ops.kernels.ce_chunk\n"
            "import paddle_tpu_torch.ops.moe\n"
            "import paddle_tpu_torch.ops.kernels.grouped_matmul\n"
            "import paddle_tpu_torch.incubate.distributed.models.moe\n"
            "import paddle_tpu_torch.models.qwen2\n"
            "import paddle_tpu_torch.incubate.nn.functional\n"
            "import paddle_tpu_torch.ops.kernels.paged_attention\n"
            "import paddle_tpu_torch.inference.reliability\n"
            "import paddle_tpu_torch.profiler.metrics\n"
            "import paddle_tpu_torch.testing.fault_injection\n"
            "import paddle_tpu_torch.testing.drafts\n"
            "import paddle_tpu_torch.inference.spec_decode\n"
            "import paddle_tpu_torch.nn.quant\n"
            "import paddle_tpu_torch.generation\n"
            "import paddle_tpu_torch.optimizer.lr\n"
            "import paddle_tpu_torch.optimizer.clip\n"
            "import paddle_tpu_torch.regularizer\n"
            "import paddle_tpu_torch.amp, paddle_tpu_torch.amp.auto_cast\n"
            "import paddle_tpu_torch.amp.grad_scaler\n"
            "import paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.framework.io\n"
            "import paddle_tpu_torch.utils.retry\n"
            "import paddle_tpu_torch.utils.monitor\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.distributed.checkpoint.validation\n"
            "import paddle_tpu_torch.distributed.checkpoint.save_load\n"
            "import paddle_tpu_torch.distributed.checkpoint.metadata\n"
            "import paddle_tpu_torch.hapi.callbacks\n"
            "import paddle_tpu_torch.nn.layer\n"
            "import paddle_tpu_torch.models.gpt2\n"
            "import paddle_tpu_torch.models.ernie\n"
            "import paddle_tpu_torch.models.deepseek\n"
            "import paddle_tpu_torch.ops.ring_attention\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_names_jax_or_paddle_tpu_in_an_import():
    """Imports inside functions too (the kernels import lazily)."""
    files = [REPO / "chip_smoke.py",
             *sorted((REPO / "paddle_tpu_torch").rglob("*.py"))]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert len(files) > 10 and not bad, bad


def test_model_without_device_raises_where_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())


@pytest.mark.parametrize("preset", ["llama3_8b", "llama3_70b", "llama_1b",
                                    "tiny"])
def test_presets_match_jax(preset):
    """Every preset the port has is the JAX package's, field for field
    (``llama3_70b``: 8192 wide, 80 layers, 64/8 heads, I 28672)."""
    import dataclasses
    port = dataclasses.asdict(getattr(LlamaConfig, preset)())
    ref = dataclasses.asdict(getattr(JLlamaConfig, preset)())
    assert port == {k: ref[k] for k in port}
