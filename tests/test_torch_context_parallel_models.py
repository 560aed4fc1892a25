"""Context parallelism of the port at the model level: Llama with
``sep_parallel`` (ring, Ulysses, all-gather) at sep 2 and 4, with dp and
mp, the clip, a checkpoint across sep degrees and the refused cache
step, over 2 and 4 gloo ranks on the CPU, against the JAX single-device
eager model on the same weights (``torch_cp_oracle``), each rank on its
slice of the sequence. Qwen2 and the MoE are in
``tests/test_torch_context_parallel_qwen2.py``, pp x sep in
``tests/test_torch_context_parallel_pipe.py``, the ops in
``tests/test_torch_context_parallel.py``.

Tolerances: f32 losses ``rtol=1e-5`` at the first step and ``1e-4``
after AdamW steps (the pipeline tests'), SGD losses ``rtol=1e-4``;
first-step gradients ``rtol=1e-4, atol=1e-6``, final weights and the
clip's global norm ``rtol=atol=1e-4``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_cp_oracle import (LR, WD, batches_of, check_arrays, check_losses,
                             jax_oracle, sep_run)
from torch_cp_oracle import pools  # noqa: F401  (the fixture)

torch.set_num_threads(1)


# ---- the models at degree 2 ----------------------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ulysses", "allgather"])
@pytest.mark.parametrize("scan", [True, False])
def test_llama_at_sep2_matches_the_jax_run(pools, impl, scan):
    """Tiny Llama at sep 2 (each rank 16 of the 32 tokens) under each
    implementation, the scanned and the unrolled stack (the unfused one
    either way): three AdamW steps' losses on every rank, the first
    step's gradients (averaged over the sep ranks) and the final weights
    against the JAX eager run on the whole sequence."""
    fields = {"sep_parallel": impl, "scan_layers": scan}
    got, (losses, grads0, _, after) = sep_run(
        pools, 2, "llama", fields, {"sep_degree": 2, "dp_degree": 1})
    for res in got:
        check_losses(res["losses"], losses)
    check_arrays(got[0]["grads0"], grads0, rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_a_4_step_adamw_run_at_sep2(pools):
    """Four AdamW steps at sep 2 with the ring: the losses, within 1e-5
    at the first step and 1e-4 after, and the weights."""
    fields = {"sep_parallel": "ring"}
    got, (losses, _, _, after) = sep_run(
        pools, 2, "llama", fields, {"sep_degree": 2, "dp_degree": 1},
        steps=4)
    for res in got:
        check_losses(res["losses"], losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_sgd_shows_no_mis_scaled_sep_gradient(pools):
    """Plain SGD at lr 0.1 (AdamW's update hides a uniform factor), sep 2
    under Ulysses: the losses within 1e-4 of the JAX run, so the
    gradients of the replicated weights are neither summed nor halved
    over the sep ranks."""
    fields = {"sep_parallel": "ulysses"}
    got, (losses, grads0, _, after) = sep_run(
        pools, 2, "llama", fields, {"sep_degree": 2, "dp_degree": 1},
        opt_name="sgd", lr=0.1)
    for res in got:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    check_arrays(got[0]["grads0"], grads0, rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_the_clip_at_sep2_is_the_unpartitioned_clip(pools):
    """``ClipGradByGlobalNorm(0.05)`` (it clips every step) at sep 2: each
    replicated parameter counts once, so the global norm each step and
    the losses and weights equal the JAX clip's on one device."""
    fields = {"sep_parallel": "ring"}
    got, (losses, _, norms, after) = sep_run(
        pools, 2, "llama", fields, {"sep_degree": 2, "dp_degree": 1},
        clip=0.05)
    for res in got:
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-4,
                                   atol=1e-4)
        check_losses(res["losses"], losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_a_sep2_checkpoint_resumes_at_sep1_and_back(pools, tmp_path):
    """The ranks at sep 2 save (``hapi.Model.save_checkpoint``) after two
    steps: the sep ranks are replicas, so each writes part of every
    tensor once; ``LlamaForCausalLM`` at sep 1 loads it and takes the
    third step, equal to the ranks' third. Then the unpartitioned model's
    checkpoint after two steps resumes at sep 2 for the third."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    fields = {"sep_parallel": "ulysses"}
    batches = batches_of()
    before, losses, _, _, _ = jax_oracle("llama", fields, batches)
    path = str(tmp_path / "sep2")
    got = pools(2).run("torch_cp_cases:sep_train", "llama", fields, before,
                       batches, {"sep_degree": 2, "dp_degree": 1}, "adamw",
                       LR, WD, None, path, None)
    assert dckpt.validate_checkpoint(path)["world_size"] == 2
    cfg = dataclasses.replace(LlamaConfig.tiny(), **fields)
    model = LlamaForCausalLM(cfg, device="cpu", seed=11)
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=WD)
    m = Model(model)
    m.prepare(opt)
    m.load_checkpoint(path)
    assert opt._step_count == 2
    t = torch.from_numpy(batches[2])
    _, loss = model(t, labels=t)
    np.testing.assert_allclose(loss.item(), got[0]["losses"][2], rtol=1e-5)
    check_losses(got[0]["losses"], losses)
    # the reverse: sep 1 saves, sep 2 resumes
    model = LlamaForCausalLM(cfg, device="cpu", seed=3)
    convert.from_numpy_state_dict(model, before)
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                weight_decay=WD)
    for ids in batches[:2]:
        t = torch.from_numpy(ids)
        _, loss = model(t, labels=t)
        loss.backward()
        opt.step()
        opt.clear_grad()
    m = Model(model)
    m.prepare(opt)
    path1 = str(tmp_path / "sep1")
    m.save_checkpoint(path1, epoch=0)
    t = torch.from_numpy(batches[2])
    _, want = model(t, labels=t)
    res = pools(2).run("torch_cp_cases:sep_train", "llama", fields, before,
                       batches[2:], {"sep_degree": 2, "dp_degree": 1},
                       "adamw", LR, WD, None, None, path1)
    for r in res:
        assert r["step0"] == 2
        np.testing.assert_allclose(r["losses"][0], want.item(), rtol=1e-5)


def test_a_cache_step_under_sep_raises(pools):
    """``generate`` (a cache step) of a sep model under a sep group raises
    ``NotImplementedError`` naming ROADMAP A.7: the JAX package has no
    such path."""
    for res in pools(2).run("torch_cp_cases:cache_step_refused",
                            {"sep_parallel": "ring"}):
        assert res[0] == "NotImplementedError" and "A.7" in res[1]


# ---- the models at degree 4 --------------------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ulysses", "allgather"])
def test_llama_at_sep4_matches_the_jax_run(pools, impl):
    """Tiny Llama at sep 4 (8 tokens a rank; Ulysses at its bound, 4
    heads over 4 ranks): losses and weights against the JAX run."""
    fields = {"sep_parallel": impl}
    got, (losses, _, _, after) = sep_run(
        pools, 4, "llama", fields, {"sep_degree": 4, "dp_degree": 1})
    for res in got:
        check_losses(res["losses"], losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_sep2_with_dp2_and_with_mp2(pools):
    """sep 2 composed with dp 2 (the gradients averaged over the data x sep
    ranks, each data replica on its rows) and with mp 2 (Ulysses over the
    rank's 2 heads; the clip over the model group), 4 ranks: losses and
    weights against the JAX run on the whole batch."""
    fields = {"sep_parallel": "ulysses"}
    for hybrid, clip in (({"sep_degree": 2, "dp_degree": 2}, None),
                         ({"sep_degree": 2, "mp_degree": 2,
                           "dp_degree": 1}, 0.05)):
        got, (losses, _, norms, after) = sep_run(
            pools, 4, "llama", fields, hybrid, clip=clip)
        by_rep = {}
        for res in got:
            by_rep.setdefault(res["rep"], res["losses"])
            if clip is not None:
                np.testing.assert_allclose(res["norms"], norms, rtol=1e-4,
                                           atol=1e-4)
        check_losses(np.mean([by_rep[r] for r in sorted(by_rep)], axis=0),
                     losses)
        check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)
