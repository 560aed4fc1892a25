"""The JAX oracle and the rank pools of the port's model-level context
parallelism tests (``tests/test_torch_context_parallel_{models,qwen2,
pipe}.py``): the JAX single-device
eager model (the oracle of ``tests/test_sep_e2e.py`` and
``tests/test_pipeline_parallel.py``) takes one step a batch on the
weights the ranks (``torch_cp_cases``) start from."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import deepseek as jdeepseek
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import qwen2 as jqwen2

from paddle_tpu_torch.models.llama import pipe_key

from torch_dist_pool import RankPool

LR, WD = 1e-3, 0.01


@pytest.fixture(scope="module")
def pools():
    """One pool alive at a time (the tests are ordered by world size)."""
    made = {}

    def get(n):
        if n not in made or not made[n].alive():
            for m in [m for m in made if m != n]:
                made.pop(m).close()
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def batches_of(steps=3, shape=(2, 32), vocab=256, seed=40):
    return [np.random.RandomState(seed + s).randint(0, vocab, shape)
            .astype(np.int64) for s in range(steps)]


_JAX = {}


def jax_oracle(family, fields, batches, opt_name="adamw", lr=LR, clip=None,
               cf=None):
    """The JAX single-device eager run from seed 0, one step a batch:
    (weights before, losses, first gradients, global norms, weights
    after). ``cf`` sets every MoE layer's capacity factor."""
    # the oracle runs the whole sequence with sep off: one run serves
    # every implementation
    fields = {k: v for k, v in fields.items() if k != "sep_parallel"}
    key = (family, tuple(sorted(fields.items())), opt_name, lr, clip, cf,
           tuple(b.tobytes() for b in batches))
    if key in _JAX:
        return _JAX[key]
    cfg_cls, make = {"llama": (jllama.LlamaConfig, jllama.LlamaForCausalLM),
                     "qwen2": (jqwen2.Qwen2Config, jqwen2.Qwen2ForCausalLM),
                     "qwen2_moe": (jqwen2.Qwen2MoeConfig,
                                   jqwen2.Qwen2MoeForCausalLM),
                     "deepseek": (jdeepseek.DeepseekV2Config,
                                  jdeepseek.DeepseekV2ForCausalLM)}[family]
    cfg = dataclasses.replace(cfg_cls.tiny(), **fields)
    cfg.tensor_parallel = False
    paddle.seed(0)
    jm = make(cfg)
    jm.train()
    if cf is not None:
        from paddle_tpu.incubate.distributed.models.moe import MoELayer
        for layer in jm.sublayers(include_self=True):
            if isinstance(layer, MoELayer):
                layer.gate.capacity_factor = cf
    before = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    grad_clip = None if clip is None else paddle.nn.ClipGradByGlobalNorm(clip)
    if opt_name == "sgd":
        opt = paddle.optimizer.SGD(learning_rate=lr,
                                   parameters=jm.parameters(),
                                   grad_clip=grad_clip)
    else:
        opt = paddle.optimizer.AdamW(learning_rate=lr,
                                     parameters=jm.parameters(),
                                     weight_decay=WD, grad_clip=grad_clip)
    losses, grads0, norms = [], None, []
    for step, ids in enumerate(batches):
        t = paddle.to_tensor(ids)
        _, loss = jm(t, labels=t)
        loss.backward()
        grads = {n: np.asarray(p.grad.numpy())
                 for n, p in jm.named_parameters() if p.grad is not None}
        if step == 0:
            grads0 = grads
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                       for g in grads.values()))))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    after = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    _JAX[key] = before, losses, grads0, norms, after
    return _JAX[key]


def check_losses(got, want, first=1e-5, later=1e-4):
    np.testing.assert_allclose(got[0], want[0], rtol=first)
    np.testing.assert_allclose(got, want, rtol=later)


def check_arrays(got, want, rtol, atol):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def sep_run(pools, n, family, fields, hybrid, steps=3, opt_name="adamw",
             lr=LR, clip=None, **kw):
    batches = batches_of(steps)
    before, losses, grads0, norms, after = jax_oracle(
        family, fields, batches, opt_name, lr, clip)
    got = pools(n).run("torch_cp_cases:sep_train", family, fields, before,
                       batches, hybrid, opt_name, lr, WD, clip,
                       kw.get("save"), kw.get("load"))
    return got, (losses, grads0, norms, after)


def piped(arrays, n_layers):
    return {pipe_key(n_layers, "llama.", k): v for k, v in arrays.items()}


def pipe_run(pools, n, fields, hybrid, schedule, V=None, opt_name="adamw",
              lr=LR):
    # the pipeline tests' batches (tests/test_torch_pipeline.py:_batches)
    batches = batches_of(3, shape=(4, 16))
    before, losses, grads0, _, after = jax_oracle("llama", fields, batches,
                                                  opt_name, lr)
    pipeline = {"schedule_mode": schedule, "accumulate_steps": 2}
    if V:
        pipeline["num_virtual_pipeline_stages"] = V
    L = fields["num_hidden_layers"]
    got = pools(n).run("torch_cp_cases:sep_pipe_train", "llama", fields,
                       before, batches, hybrid, pipeline, opt_name, lr, WD)
    for res in got:
        check_losses(res["losses"], losses)
    check_arrays(got[0]["grads0"], piped(grads0, L), rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], piped(after, L), rtol=1e-4, atol=1e-4)
    return got
