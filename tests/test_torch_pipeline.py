"""Pipeline parallelism of the port (``distributed.zero_bubble``,
``distributed.pipeline``, ``fleet.meta_parallel``'s ``PipelineLayer`` and
``PipelineParallel``, the ``*Pipe`` models, pp with mp, ZeRO, dp, the
clip and checkpoints) over 2 and 4 gloo ranks on the CPU, against the
JAX package.

The schedule tables and the segments are compared with the JAX
package's element for element. The models are the JAX single-device
eager oracle (``LlamaForCausalLM`` / ``Qwen2MoeForCausalLM`` with AdamW,
``tests/test_pipeline_parallel.py:313-330``) on the same weights, made
from a seed; the ranks are started once a module
(``torch_dist_pool.RankPool``) and run ``torch_pipe_cases``; inputs are
numpy from a seed. Tolerances, tighter than the JAX pipeline tests'
``rtol=2e-4, atol=2e-4``: f32 losses ``rtol=1e-5`` at the first step
and ``1e-4`` after AdamW steps (the microbatches' sums run in another
order), the first step's gradients ``rtol=1e-4, atol=1e-6``, final
weights ``rtol=atol=1e-4``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import zero_bubble as jzb
from paddle_tpu.distributed.fleet.meta_parallel import (LayerDesc as JDesc,
                                                        PipelineLayer as JPipe,
                                                        SharedLayerDesc as
                                                        JShared)
from paddle_tpu.models import llama as jllama
from paddle_tpu.models import qwen2 as jqwen2

from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import zero_bubble as tzb
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer)
from paddle_tpu_torch.models.llama import pipe_key

from torch_dist_pool import RankPool

torch.set_num_threads(1)

LR, WD = 1e-3, 0.01


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made or not made[n].alive():
            made[n] = RankPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


# ---- the tables ----------------------------------------------------------

@pytest.mark.parametrize("S,M", [(2, 2), (4, 8), (4, 5), (8, 16)])
@pytest.mark.parametrize("kind", ["fthenb", "1f1b", "zb_h1"])
def test_schedule_tables_equal_the_jax_package(S, M, kind):
    """``make_schedule`` and ``_buffer_slots``: the port's tables and slot
    counts equal the JAX package's element for element."""
    jop, jmb = jzb.make_schedule(S, M, kind)
    op, mb = tzb.make_schedule(S, M, kind)
    np.testing.assert_array_equal(op, jop)
    np.testing.assert_array_equal(mb, jmb)
    split = kind == "zb_h1"
    assert tzb._buffer_slots(op, mb, S, M, split) == \
        jzb._buffer_slots(jop, jmb, S, M, split)
    assert (tzb.NOP, tzb.F, tzb.B, tzb.W) == (jzb.NOP, jzb.F, jzb.B, jzb.W)


@pytest.mark.parametrize("S,M,V", [(2, 2, 2), (2, 5, 3), (4, 8, 2),
                                   (4, 6, 2), (3, 7, 4)])
def test_interleaved_table_is_the_closed_form(S, M, V):
    """Every forward unit ``(m, c)`` sits on stage ``c % S`` at ``t(m, c)
    = (m // S)·S·V + (c // S)·S + (m % S) + (c % S)`` as local chunk
    ``c // S``; the backward is the mirror, each ``B(m, c)`` after
    ``B(m, c + 1)``; every unit appears once."""
    op, mb, ch = tpipe.interleaved_schedule(S, M, V)
    L = S * V
    t_f = max((m // S) * S * V + (c // S) * S + m % S + c % S
              for m in range(M) for c in range(L)) + 1
    b_at = {}
    for m in range(M):
        for c in range(L):
            t = (m // S) * S * V + (c // S) * S + (m % S) + (c % S)
            assert (op[c % S, t], mb[c % S, t], ch[c % S, t]) == \
                (tpipe.F, m, c // S)
            tb = t_f + (m // S) * S * V + ((L - 1 - c) // S) * S + m % S + \
                (L - 1 - c) % S
            assert (op[c % S, tb], mb[c % S, tb], ch[c % S, tb]) == \
                (tzb.B, m, c // S)
            b_at[(m, c)] = tb
    for (m, c), t in b_at.items():
        if c + 1 < L:
            assert b_at[(m, c + 1)] < t
    assert (op == tzb.F).sum() == (op == tzb.B).sum() == M * L
    fop, fmb = tpipe.fthenb_forward_table(S, M)
    assert fop.shape == (S, M + S - 1)
    for d in range(S):
        assert list(fmb[d, d:d + M]) == list(range(M))


def _jax_layer_cls(name):
    return type(name, (jnn.Layer,), {"forward": lambda self, x: x})


def _port_layer_cls(name):
    return type(name, (torch.nn.Module,), {"forward": lambda self, x: x})


@pytest.mark.parametrize("seg_method", ["uniform", "layer:Block"])
def test_partition_equals_the_jax_segments(seg_method):
    """``_partition`` over an embedding, ``k`` blocks and a head, for
    every count of blocks and stages (also past the count of blocks,
    where ``layer:`` falls back to uniform): the JAX segments."""
    names = ("Embed", "Block", "Head")
    for k in range(1, 9):
        for stages in range(1, 7):
            seq = ["Embed"] + ["Block"] * k + ["Head"]
            jl = JPipe([JDesc(_jax_layer_cls(n)) for n in seq],
                       num_stages=stages, seg_method=seg_method)
            port_cls = {n: _port_layer_cls(n) for n in names}
            tl = PipelineLayer([LayerDesc(port_cls[n]) for n in seq],
                               num_stages=stages, seg_method=seg_method,
                               device="cpu")
            assert tl._segments == jl._segments, (k, stages)


# ---- the models ------------------------------------------------------------

def _batches(steps=3, shape=(4, 16), vocab=256):
    return [np.random.RandomState(40 + s).randint(0, vocab, shape)
            .astype(np.int64) for s in range(steps)]


def jax_oracle(family, fields, batches, clip=None):
    """The JAX single-device eager run from seed 0 with AdamW, one step a
    batch: (weights before, losses, first gradients, weights after)."""
    if family == "llama":
        cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **fields)
        make = jllama.LlamaForCausalLM
    else:
        cfg = dataclasses.replace(jqwen2.Qwen2MoeConfig.tiny(), **fields)
        make = jqwen2.Qwen2MoeForCausalLM
    cfg.tensor_parallel = False
    paddle.seed(0)
    jm = make(cfg)
    jm.train()
    before = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    opt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=jm.parameters(), weight_decay=WD,
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
    after = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return before, losses, grads0, after


def _piped(arrays, family, n_layers):
    prefix = "llama." if family == "llama" else ""
    return {pipe_key(n_layers, prefix, k): v for k, v in arrays.items()}


def check_losses(got, want, first=1e-5, later=1e-4):
    np.testing.assert_allclose(got[0], want[0], rtol=first)
    np.testing.assert_allclose(got, want, rtol=later)


def check_arrays(got, want, rtol, atol):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def replica_mean(results):
    by_rep = {}
    for res in results:
        by_rep.setdefault(res["rep"], res["losses"])
    return np.mean([by_rep[r] for r in sorted(by_rep)], axis=0)


def _pipeline(schedule, M, V=None):
    cfg = {"schedule_mode": schedule, "accumulate_steps": M}
    if V:
        cfg["num_virtual_pipeline_stages"] = V
    return cfg


def _run(pools, n, family, fields, hybrid, pipeline, clip=None,
         sharding_stage=None, grads=True, weights=True):
    batches = _batches()
    before, losses, grads0, after = jax_oracle(family, fields, batches, clip)
    L = fields["num_hidden_layers"]
    got = pools(n).run("torch_pipe_cases:pipe_train", family, fields,
                       before, batches, hybrid, pipeline, LR, WD, clip,
                       sharding_stage)
    check_losses(replica_mean(got), losses)
    one_replica = len({r["rep"] for r in got}) == 1
    for res in got:
        if one_replica:
            # eval_batch before the first step: the first step's loss
            np.testing.assert_allclose(res["eval"], losses[0], rtol=1e-5)
        assert res["peak_live"] <= res["bound"]
        if grads:
            check_arrays(res["grads0"], _piped(grads0, family, L),
                         rtol=1e-4, atol=1e-6)
    if weights:
        check_arrays(got[0]["weights"], _piped(after, family, L),
                     rtol=1e-4, atol=1e-4)
    return got


SCHEDULES = [("FThenB", None), ("1F1B", None), ("ZB-H1", None),
             ("interleaved", 2)]


@pytest.mark.parametrize("schedule,V", SCHEDULES)
def test_pp2_llama_matches_the_jax_run_under_each_schedule(pools, schedule,
                                                           V):
    """Tiny Llama (4 layers, the unrolled stack with the fused carry: the
    ``(hidden, residual)`` pair crosses the stages) at pp 2, 2
    microbatches: ``eval_batch``, three AdamW steps' losses, the first
    step's gradients and the final weights, gathered over the stages,
    against the JAX run. Each rank holds its own layers only, and the
    1F1B/ZB-H1 rank keeps no more microbatch graphs than the table's
    ``_buffer_slots`` peak."""
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    got = _run(pools, 2, "llama", fields, {"pp_degree": 2, "dp_degree": 1},
               _pipeline(schedule, 2, V))
    for res in got:
        assert res["param_numel"] == res["by_stage"][res["stage"]]
        assert res["n_layers_held"] == 3     # of the 6 layers


@pytest.mark.parametrize("schedule,V", SCHEDULES)
def test_pp4_llama_matches_the_jax_run_under_each_schedule(pools, schedule,
                                                           V):
    """Tiny Llama at pp 4 over 4 ranks (8 layers: 2 a stage, 1 a chunk
    under interleaving with V 2), 4 microbatches, the scanned stack's
    unfused layers: losses, first gradients and weights against the JAX
    run. 1F1B keeps at most ``S - d`` microbatches alive on stage
    ``d``, fewer than FThenB's ``M``."""
    fields = {"num_hidden_layers": 8}
    got = _run(pools, 4, "llama", fields, {"pp_degree": 4, "dp_degree": 1},
               _pipeline(schedule, 4, V))
    for res in got:
        assert res["param_numel"] == res["by_stage"][res["stage"]]
        if schedule == "1F1B":
            assert res["peak_live"] <= 4 - res["stage"]
        if schedule == "FThenB":
            assert res["peak_live"] == 4


def test_pp2_with_core_attn_recompute_under_zb_h1(pools):
    """ZB-H1 over stages that recompute (``core_attn``: selective
    checkpointing takes one backward, so ``W`` runs the chunk again from
    its kept input) against the JAX run without recompute."""
    fields = {"num_hidden_layers": 4, "scan_layers": False,
              "use_recompute": True, "recompute_granularity": "core_attn"}
    _run(pools, 2, "llama", fields, {"pp_degree": 2, "dp_degree": 1},
         _pipeline("ZB-H1", 2))


@pytest.mark.parametrize("hybrid,stage", [
    ({"pp_degree": 2, "mp_degree": 2, "dp_degree": 1}, None),
    ({"pp_degree": 2, "sharding_degree": 2, "dp_degree": 1}, 1),
    ({"pp_degree": 2, "sharding_degree": 2, "dp_degree": 1}, 2),
    ({"pp_degree": 2, "dp_degree": 2}, None)])
def test_pp2_composes_with_mp_zero_and_dp(pools, hybrid, stage):
    """pp 2 with mp 2 (each stage's layers split over its model group),
    with ZeRO 1 and 2 over sharding 2 (each stage's own parameters
    partitioned) and with dp 2 (gradients averaged over the data group),
    4 ranks, 1F1B: losses (averaged over the data replicas), first
    gradients (where no ZeRO reduction is pending) and final weights
    against the JAX run on the whole batch."""
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    _run(pools, 4, "llama", fields, hybrid, _pipeline("1F1B", 2),
         sharding_stage=stage, grads=stage is None)


def test_qwen2_moe_pipe_at_pp2_matches_the_jax_run(pools):
    """Tiny ``Qwen2MoeForCausalLMPipe`` at pp 2 (the router's aux loss
    folded out) against the JAX ``Qwen2MoeForCausalLM`` with
    ``router_aux_loss_coef=0``: losses, first gradients, weights. The
    dispatch is dropless: a capacity per forward would depend on the
    microbatch's token count, so capacity dispatch differs from the
    whole batch's by construction."""
    fields = {"num_hidden_layers": 4, "router_aux_loss_coef": 0.0,
              "moe_dropless": True}
    _run(pools, 2, "qwen2_moe", fields, {"pp_degree": 2, "dp_degree": 1},
         _pipeline("1F1B", 2))


def test_the_clip_spans_the_stages(pools):
    """``ClipGradByGlobalNorm(0.05)`` (it clips every step) under pp 2 x
    mp 2: the global norm summed over the model and the pipe groups, so
    the losses and weights equal the JAX clip's on one device."""
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    _run(pools, 4, "llama", fields,
         {"pp_degree": 2, "mp_degree": 2, "dp_degree": 1},
         _pipeline("FThenB", 2), clip=0.05, grads=False)


@pytest.mark.parametrize("pp,fields", [
    (2, {"num_hidden_layers": 4, "scan_layers": False}),
    (4, {"num_hidden_layers": 8})])
def test_the_seed_draws_the_unpartitioned_weights(pools, pp, fields):
    """Each stage rank holds only its layers (its parameter count is
    ``parameters_by_stage``'s, the counts summing to the whole model's),
    and the stages' weights from seed 7, gathered, are
    ``LlamaForCausalLM(seed=7)``'s bit for bit: a rank draws the layers
    it lacks into scratch buffers."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch import convert
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    ref = convert.to_numpy_state_dict(LlamaForCausalLM(cfg, device="cpu",
                                                       seed=7))
    n = fields["num_hidden_layers"]
    got = pools(pp).run("torch_pipe_cases:pipe_seed", "llama", fields, 7,
                        {"pp_degree": pp, "dp_degree": 1})
    want = _piped(ref, "llama", n)
    assert set(got[0]["weights"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[0]["weights"][k], v, err_msg=k)
    total = sum(v.size for v in ref.values())
    for res in got:
        assert res["param_numel"] == res["by_stage"][res["stage"]]
        assert sum(res["by_stage"]) == total
    held = [res["held"] for res in got]
    assert sorted(i for h in held for i in h) == list(range(n + 2))


class _JTied(jnn.Layer):
    def __init__(self, vocab, dim):
        super().__init__()
        self.weight = self.create_parameter([vocab, dim])

    def forward(self, ids):
        return paddle.nn.functional.embedding(ids, self.weight)


class _JBlock(jnn.Layer):
    def __init__(self, dim):
        super().__init__()
        self.fc = jnn.Linear(dim, dim)

    def forward(self, x):
        return x + paddle.tanh(self.fc(x))


def test_shared_layer_desc_ties_the_first_and_last_stage(pools):
    """A ``SharedLayerDesc`` embedding at layer 0 and again as the head
    (``forward_func``: logits through the embedding's transpose) around
    4 blocks, pp 2: both end stages hold the tied weight (the later
    holder's copy marked ``pipe_duplicate``), its gradient is summed
    between them, and the losses and weights equal the JAX
    ``PipelineLayer`` run sequentially on one device."""
    vocab, dim, n_blocks = 32, 8, 4
    paddle.seed(0)
    descs = [JShared("emb", _JTied, None, "weight", vocab, dim)] + \
        [JDesc(_JBlock, dim) for _ in range(n_blocks)] + \
        [JShared("emb", _JTied,
                 lambda layer, x: paddle.matmul(x, layer.weight,
                                                transpose_y=True),
                 "weight", vocab, dim)]
    jl = JPipe(descs, loss_fn=lambda logits, y: paddle.nn.functional
               .cross_entropy(logits.reshape([-1, vocab]), y.reshape([-1])))
    with paddle.no_grad():
        jl.run_function[0].weight.set_value(
            np.random.RandomState(1).randn(vocab, dim).astype(np.float32))
    arrays = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    batches = _batches(shape=(4, 6), vocab=vocab)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=jl.parameters())
    losses = []
    for ids in batches:
        t = paddle.to_tensor(ids)
        loss = jl._loss_fn(jl(t), t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    after = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    got = pools(2).run("torch_pipe_cases:shared_train", arrays, batches,
                       {"pp_degree": 2, "dp_degree": 1},
                       _pipeline("1F1B", 2), vocab, dim, n_blocks)
    for res in got:
        check_losses(res["losses"], losses)
        check_arrays(res["weights"], after, rtol=1e-4, atol=1e-5)
        assert res["holds_tied"]
    assert not any(got[0]["dup"]) and got[1]["dup"].count(True) == 1


# ---- checkpoints ------------------------------------------------------------

def _port_model(fields, seed=3):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=WD)
    return model, opt


def _port_step(model, opt, ids):
    t = torch.from_numpy(ids)
    _, loss = model(t, labels=t)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.item()


def _resume_unpartitioned(path, fields, batch):
    """The checkpoint of a pipe model loaded into ``LlamaForCausalLM``
    (its keys through the pipe's key map; the optimizer's are the same
    at every pp degree), then one step: the loss and the step count."""
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    model, opt = _port_model(fields, seed=11)
    n = fields["num_hidden_layers"]
    state = {pipe_key(n, "llama.", k): v
             for k, v in model.state_dict().items()}
    dckpt.load_state_dict({"model": state}, path)
    opt.set_state_dict(dckpt.read_state_dict(path, prefix="optimizer"))
    step0 = opt._step_count
    return _port_step(model, opt, batch), step0


@pytest.mark.parametrize("hybrid", [
    {"pp_degree": 2, "dp_degree": 1},
    {"pp_degree": 2, "mp_degree": 2, "dp_degree": 1}])
def test_a_pp_checkpoint_resumes_unpartitioned(pools, tmp_path, hybrid):
    """pp 2 (and pp 2 x mp 2) saves after two steps through
    ``hapi.Model.save_checkpoint`` on the ``PipelineLayer``: each stage
    writes its own layers (at pp 2 x mp 2 the mp ranks of a stage split
    its tensors' bytes), and ``LlamaForCausalLM`` at mp 1 pp 1 loads the
    model and the optimizer state and takes the third step: its loss
    equals the ranks' third step."""
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    batches = _batches()
    before, _, _, _ = jax_oracle("llama", fields, batches)
    path = str(tmp_path / "ck")
    got = pools(4 if "mp_degree" in hybrid else 2).run(
        "torch_pipe_cases:pipe_ckpt_save", before, batches, hybrid,
        _pipeline("1F1B", 2), path, fields)
    assert all(res["bytes"] > 0 for res in got)
    loss, step0 = _resume_unpartitioned(path, fields, batches[2])
    assert step0 == 2
    np.testing.assert_allclose(loss, got[0]["losses"][2], rtol=1e-5)


def test_an_unpartitioned_checkpoint_resumes_at_pp2(pools, tmp_path):
    """``LlamaForCausalLM`` saves after two steps under the pipe keys (the
    optimizer's keys are the same at every pp degree); the pp 2 ranks
    load it through ``hapi.Model.load_checkpoint`` on their
    ``PipelineLayer``s and take the third step, equal to the
    unpartitioned model's own third step."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    batches = _batches()
    before, _, _, _ = jax_oracle("llama", fields, batches)
    model, opt = _port_model(fields)
    convert.from_numpy_state_dict(model, before)
    for ids in batches[:2]:
        _port_step(model, opt, ids)
    n = fields["num_hidden_layers"]
    path = str(tmp_path / "ck")
    dckpt.save_state_dict({"model": {pipe_key(n, "llama.", k): v for k, v
                                     in model.state_dict().items()},
                           "optimizer": opt.state_dict(), "epoch": 0}, path)
    want = _port_step(model, opt, batches[2])
    got = pools(2).run("torch_pipe_cases:pipe_ckpt_resume", batches[2:],
                       {"pp_degree": 2, "dp_degree": 1},
                       _pipeline("1F1B", 2), path, fields)
    for res in got:
        assert res["step0"] == 2
        np.testing.assert_allclose(res["losses"][0], want, rtol=1e-5)


def test_model_save_writes_every_stage_and_loads_at_pp2(pools, tmp_path):
    """``hapi.Model.save`` under pp 2 writes the whole model (the stages'
    tensors gathered to the first rank) with the optimizer state: a
    fresh pp 2 model loads it (each rank its own stage's keys) and takes
    the next step as the saving run does, and the ``.pdparams`` holds the
    gathered weights under the ``PipelineLayer``'s keys."""
    from paddle_tpu_torch.framework import io as tio
    fields = {"num_hidden_layers": 4, "scan_layers": False}
    batches = _batches()
    before, _, _, _ = jax_oracle("llama", fields, batches)
    path = str(tmp_path / "model")
    got = pools(2).run("torch_pipe_cases:pipe_model_save", before, batches,
                       {"pp_degree": 2, "dp_degree": 1},
                       _pipeline("1F1B", 2), path, fields)
    for res in got:
        np.testing.assert_allclose(res[9], res[1], rtol=1e-6)
    saved = tio.load(path + ".pdparams", device="cpu")
    weights = got[0]["weights"]
    assert set(saved) == set(weights)
    for k, v in saved.items():
        # the port's files hold torch's [out, in] Linear layout; the
        # gathered weights Paddle's [in, out]
        linear = k.endswith(("proj.weight", "lm_head.weight"))
        np.testing.assert_array_equal(v.numpy().T if linear else v.numpy(),
                                      weights[k], err_msg=k)


# ---- refusals -------------------------------------------------------------

def test_the_refusals(pools):
    """An unknown schedule, interleaved without virtual stages, an
    explicit schedule with them, a virtual count that conflicts with the
    layer's, degrees that do not make the world (pp 2 x sep 2 and pp 2 x
    ep 2 over 2 ranks: pp x sep and pp x ep themselves are taken, in
    ``tests/test_torch_context_parallel_pipe.py`` and
    ``tests/test_torch_expert_parallel_pipe.py``) and ZeRO 3 under pp
    each raise, with the JAX package's meaning."""
    got = pools(2).run("torch_pipe_cases:pipe_errors")
    for res in got:
        assert res["unknown"][0] == "ValueError"
        assert "unknown pipeline schedule_mode" in res["unknown"][1]
        assert res["interleaved_no_v"][0] == "ValueError"
        assert "virtual" in res["interleaved_no_v"][1]
        assert res["explicit_with_v"][0] == "ValueError"
        assert "do not support virtual" in res["explicit_with_v"][1]
        assert res["conflicting_v"][0] == "ValueError"
        assert "conflicts" in res["conflicting_v"][1]
        assert res["sep"][0] == "ValueError"
        assert "exceed the world size 2" in res["sep"][1]
        assert res["ep"][0] == "ValueError"
        assert "exceed the world size 2" in res["ep"][1]
        assert res["degrees"][0] == "ValueError"
        assert "world size" in res["degrees"][1]
        assert res["zero3"][0] == "NotImplementedError"
        assert "A.7" in res["zero3"][1]

