"""Tensor and sequence parallelism of the port (``distributed.
parallel_layers``, ``fleet.utils.sequence_parallel_utils``, the models'
parallel branches, the vocab-parallel fused CE) over 2 and 4 gloo ranks
on the CPU, against the JAX package on one device.

Each rank holds only its shard; the JAX oracle is the single-device run
on the full weights (the oracle of ``tests/test_sharding.py:148`` and
``tests/test_sequence_parallel.py:73``): the JAX parallel layers without
a mesh are the plain ones. The ranks are started once a module
(``torch_dist_pool.RankPool``) and run ``torch_dist_cases``; inputs are
numpy from a seed. Tolerances: f32 outputs and gradients of one layer
``rtol=1e-5`` (the same products summed in another order), losses of the
tiny models ``rtol=1e-5`` at the first step and ``1e-4`` after AdamW
steps, their gradients ``rtol=1e-4``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import (ColumnParallelLinear, ParallelCrossEntropy,
                                    RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import deepseek as jdeepseek
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import qwen2 as jqwen2
from paddle_tpu.ops import fused_ce as jfce

from torch_dist_pool import RankPool

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        # a pool killed by a failed call is started again
        if n not in made or not made[n].alive():
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


# ---- the layers --------------------------------------------------------------

def _layer_inputs():
    rng = np.random.RandomState(0)
    f = np.float32
    a = {"x": rng.randn(2, 5, 8).astype(f),
         "h": rng.randn(2, 5, 12).astype(f),
         "w1": (rng.randn(8, 12) * 0.3).astype(f),
         "b1": rng.randn(12).astype(f),
         "w2": (rng.randn(12, 8) * 0.3).astype(f),
         "b2": rng.randn(8).astype(f),
         "dy1": rng.randn(2, 5, 12).astype(f),
         "dy2": rng.randn(2, 5, 8).astype(f),
         "emb": rng.randn(16, 8).astype(f),
         "ids": rng.randint(0, 16, (2, 5)).astype(np.int64),
         "logits": rng.randn(2, 5, 16).astype(f),
         "labels": rng.randint(0, 16, (2, 5)).astype(np.int64)}
    a["labels"][0, 1] = -100
    return a


def _set(param, value):
    param.set_value(np.asarray(value, np.float32))


def _jax_layers(a):
    """The JAX package's parallel layers without a mesh (the plain ones)
    on the full weights: outputs and gradients."""
    out = {}
    x = paddle.to_tensor(a["x"], stop_gradient=False)
    col = ColumnParallelLinear(8, 12, gather_output=True)
    _set(col.weight, a["w1"])
    _set(col.bias, a["b1"])
    y = col(x)
    (y * paddle.to_tensor(a["dy1"])).sum().backward()
    out.update(col_y=y.numpy(), col_dx=x.grad.numpy(),
               col_dw=col.weight.grad.numpy(), col_db=col.bias.grad.numpy())
    x = paddle.to_tensor(a["x"], stop_gradient=False)
    colp = ColumnParallelLinear(8, 12, gather_output=False)
    _set(colp.weight, a["w1"])
    _set(colp.bias, a["b1"])
    rowp = RowParallelLinear(12, 8, input_is_parallel=True)
    _set(rowp.weight, a["w2"])
    _set(rowp.bias, a["b2"])
    y = rowp(colp(x))
    (y * paddle.to_tensor(a["dy2"])).sum().backward()
    out.update(mlp_y=y.numpy(), mlp_dx=x.grad.numpy(),
               mlp_dw1=colp.weight.grad.numpy(),
               mlp_db1=colp.bias.grad.numpy(),
               mlp_dw2=rowp.weight.grad.numpy(),
               mlp_db2=rowp.bias.grad.numpy())
    h = paddle.to_tensor(a["h"], stop_gradient=False)
    row = RowParallelLinear(12, 8, has_bias=False)
    _set(row.weight, a["w2"])
    y = row(h)
    (y * paddle.to_tensor(a["dy2"])).sum().backward()
    out.update(row_y=y.numpy(), row_dh=h.grad.numpy(),
               row_dw=row.weight.grad.numpy())
    emb = VocabParallelEmbedding(16, 8)
    _set(emb.weight, a["emb"])
    e = emb(paddle.to_tensor(a["ids"]))
    (e * paddle.to_tensor(a["dy1"][..., :8])).sum().backward()
    out.update(emb_y=e.numpy(), emb_dw=emb.weight.grad.numpy())
    logits = paddle.to_tensor(a["logits"], stop_gradient=False)
    loss = ParallelCrossEntropy()(logits, paddle.to_tensor(a["labels"]))
    loss.sum().backward()
    out.update(pce_loss=loss.numpy(), pce_dlogits=logits.grad.numpy())
    return out


@pytest.mark.parametrize("mp", [2, 4])
def test_parallel_layers_forward_and_backward_match_jax(pools, mp):
    """Column (gathered and split output), column into row, row over a
    whole input, the vocab-parallel embedding and the parallel cross
    entropy: outputs, input gradients and the weight gradients gathered
    from the shards, against the JAX layers on the full weights."""
    a = _layer_inputs()
    want = _jax_layers(a)
    got = pools(mp).run("torch_dist_cases:tp_layers", a)
    for r, res in enumerate(got):
        for key, ref in want.items():
            np.testing.assert_allclose(res[key], ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r}: {key}")
        assert res["split_shape"] == (2, 5, 12)


@pytest.mark.parametrize("mp,chunk_v", [(2, 5), (4, 4), (2, 64)])
def test_vocab_parallel_fused_ce_matches_jax(pools, mp, chunk_v):
    """K10/K11's plain versions over each rank's vocab columns, the
    per-row max / exp-sum / target combined over the group: the loss, dh
    (whole on every rank) and dW gathered from the shards against the
    JAX ``fused_linear_cross_entropy`` on the full weight. Chunks of 5
    leave a clamped tail in each 12-column shard; 64 is one chunk wider
    than the shard. One row is ignored, one label sits in the last
    shard's last column."""
    rng = np.random.RandomState(3)
    n, d, v = 14, 8, 48
    a = {"h": rng.randn(n, d).astype(np.float32),
         "w": (rng.randn(d, v) * 0.3).astype(np.float32),
         "labels": rng.randint(0, v, n).astype(np.int64)}
    a["labels"][2], a["labels"][4] = -100, v - 1
    jl = jnp.asarray(a["labels"])
    with jfce.force_chunk_v(chunk_v):
        loss = float(jfce.fused_linear_cross_entropy(
            jnp.asarray(a["h"]), jnp.asarray(a["w"]), jl))
        dh, dw = jax.grad(
            lambda h, w: jfce.fused_linear_cross_entropy(h, w, jl),
            argnums=(0, 1))(jnp.asarray(a["h"]), jnp.asarray(a["w"]))
    got = pools(mp).run("torch_dist_cases:vocab_parallel_ce", a, chunk_v)
    for r, res in enumerate(got):
        # f32: the online log-sum-exp sums in another grouping
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(res["dh"], np.asarray(dh), rtol=1e-5,
                                   atol=1e-7, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["dw"], np.asarray(dw), rtol=1e-5,
                                   atol=1e-7, err_msg=f"rank {r}")


# ---- the models -----------------------------------------------------------------

JAX_FAMILY = {"llama": (jllama.LlamaConfig, jllama.LlamaForCausalLM),
              "qwen2": (jqwen2.Qwen2Config, jqwen2.Qwen2ForCausalLM),
              "deepseek": (jdeepseek.DeepseekV2Config,
                           jdeepseek.DeepseekV2ForCausalLM)}

LR, WD = 1e-3, 0.01


def _batches(steps=3, shape=(4, 16), vocab=256):
    return [np.random.RandomState(20 + s).randint(0, vocab, shape)
            .astype(np.int64) for s in range(steps)]


def jax_train(family, fields, batches, clip=None, jax_flags=None,
              lr=LR, wd=WD):
    """The JAX single-device eager run: the tiny model from seed 0,
    AdamW, one step a batch. Returns (weights before, losses, the first
    step's gradients, the weights after)."""
    cfg_cls, model_cls = JAX_FAMILY[family]
    cfg = dataclasses.replace(cfg_cls.tiny(), **fields)
    if hasattr(cfg, "tensor_parallel"):
        cfg.tensor_parallel = False
    saved = {}
    for name, val in (jax_flags or {}).items():
        saved[name] = dict(jflags._registry[name])
        jflags.set_flags({name: val})
    try:
        paddle.seed(0)
        jm = model_cls(cfg)
        jm.train()
        arrays = {k: np.asarray(v.numpy()) for k, v in
                  jm.state_dict().items()}
        opt = paddle.optimizer.AdamW(
            learning_rate=lr, parameters=jm.parameters(), weight_decay=wd,
            grad_clip=None if clip is None else
            paddle.nn.ClipGradByGlobalNorm(clip))
        losses, grads0 = [], None
        for step, ids in enumerate(batches):
            t = paddle.to_tensor(ids)
            _, loss = jm(t, labels=t)
            loss.backward()
            if step == 0:
                grads0 = {n: np.asarray(p.grad.numpy())
                          for n, p in jm.named_parameters()
                          if p.grad is not None}
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        after = {k: np.asarray(v.numpy()) for k, v in
                 jm.state_dict().items()}
    finally:
        for name, ent in saved.items():
            jflags._registry[name] = ent
    return arrays, losses, grads0, after


def replica_mean(results):
    """Each step's loss averaged over the data replicas (one rank each)."""
    by_rep = {}
    for res in results:
        by_rep.setdefault(res["rep"], res["losses"])
    return np.mean([by_rep[r] for r in sorted(by_rep)], axis=0)


def check_losses(got, want, first=1e-5, later=1e-4):
    # f32: step 0 differs by the sums' order; AdamW's normalised
    # updates carry some 1e-6 of it into the next steps' losses
    np.testing.assert_allclose(got[0], want[0], rtol=first)
    np.testing.assert_allclose(got, want, rtol=later)


def check_weights(got, want):
    # three AdamW steps of lr 1e-3: an element whose gradient is near 0
    # takes an update that the sums' order moves by a share of lr; 1e-4
    # is a tenth of one step, far below what a wrong shard would move
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def check_grads(got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("family,fields,mp", [
    ("llama", {"scan_layers": False}, 2),
    ("llama", {"num_key_value_heads": 4}, 4),
    ("qwen2", {}, 2),
    ("deepseek", {}, 2)])
def test_tiny_models_at_mp_match_the_single_device_jax_run(pools, family,
                                                           fields, mp):
    """Tiny Llama (the unrolled stack with the fused carry at mp 2, the
    scanned one at mp 4), Qwen2 and DeepSeek-V2 (MLA, shared-expert MoE)
    split over the model group: three AdamW steps' losses, the first
    step's gradients gathered from the shards and the final weights
    against the JAX single-device run on the same weights."""
    batches = _batches()
    arrays, losses, grads0, after = jax_train(family, fields, batches)
    got = pools(mp).run("torch_dist_cases:train_steps", family, fields,
                        arrays, batches, {"mp_degree": mp}, LR, WD)
    for res in got:
        check_losses(res["losses"], losses)
        check_grads(res["grads0"], grads0)
    check_weights(got[0]["weights"], after)


def test_fused_ce_through_the_model_at_mp2_matches_jax(pools):
    """Llama at mp 2 with FLAGS_fused_linear_cross_entropy: the labelled
    loss through the vocab-parallel fused CE, against the JAX model with
    the fused CE on one device."""
    flags = {"FLAGS_fused_linear_cross_entropy": True}
    fields = {"scan_layers": False}
    batches = _batches()
    arrays, losses, grads0, _ = jax_train("llama", fields, batches,
                                          jax_flags=flags)
    got = pools(2).run("torch_dist_cases:train_steps", "llama", fields,
                       arrays, batches, {"mp_degree": 2}, LR, WD, None,
                       None, flags)
    for res in got:
        check_losses(res["losses"], losses)
        check_grads(res["grads0"], grads0)


@pytest.mark.parametrize("mp,scan", [(2, True), (2, False), (4, False)])
def test_sequence_parallel_matches_the_plain_jax_run(pools, mp, scan):
    """Megatron SP over the model group: the residual stream split on the
    sequence, the sequence-parallel linears, the norms' gradients
    all-reduced by their hooks; the losses, every gradient and the final
    weights equal the JAX single-device run's (its oracle,
    ``tests/test_sequence_parallel.py:73``)."""
    batches = _batches()
    fields = {"scan_layers": scan, "num_key_value_heads": 4}
    arrays, losses, grads0, after = jax_train("llama", fields, batches)
    got = pools(mp).run("torch_dist_cases:train_steps", "llama",
                        dict(fields, sequence_parallel=True), arrays,
                        batches, {"mp_degree": mp}, LR, WD)
    for res in got:
        check_losses(res["losses"], losses)
        check_grads(res["grads0"], grads0)
    check_weights(got[0]["weights"], after)


def test_hybrid_clip_at_mp_matches_the_jax_global_norm_clip(pools):
    """ClipGradByGlobalNorm under TP (HybridParallelClipGrad: split
    parameters' squares summed over the model group, replicated ones
    once) at a norm that clips every step, against the JAX clip on one
    device."""
    batches = _batches()
    arrays, losses, _, after = jax_train("llama", {}, batches, clip=0.05)
    got = pools(2).run("torch_dist_cases:train_steps", "llama", {}, arrays,
                       batches, {"mp_degree": 2}, LR, WD, 0.05)
    for res in got:
        check_losses(res["losses"], losses)
    check_weights(got[0]["weights"], after)
