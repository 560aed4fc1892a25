"""Expert parallelism of the port in the models: the tiny Qwen2-MoE and
DeepSeek-V2 at ep 2 (2 gloo ranks on the CPU), at ep 2 x mp 2 and ep 2 x
dp 2 (4 ranks), the clip across the expert group, the optimizer state of
a bank, checkpoints across ep degrees and ``fit(resume=)`` under ep 2,
against the JAX single-device eager model on the same weights
(``torch_cp_oracle.jax_oracle``; the ranks run ``torch_ep_cases``).

The capacity factor is E/k (4 at the tiny configs' 8 experts, top-2), so
no rank drops a token and the capacity path computes what one device
does. The router's aux loss is folded out (``router_aux_loss_coef`` 0):
each rank's aux is over its own tokens, averaged over the group, which
is not the one-device aux of all of them; the aux mean and its gradient
are held against the JAX ``moe_forward_ep`` and ``MoELayer`` in
``tests/test_torch_expert_parallel.py``.

Tolerances: f32 losses ``rtol=1e-5`` at the first step and ``1e-4``
after AdamW steps, the first gradients ``rtol=1e-4, atol=1e-6``, final
weights ``rtol=atol=1e-4``, global norms ``rtol=1e-4`` (the context
parallelism tests').
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from torch_cp_oracle import (LR, WD, batches_of, check_arrays, check_losses,
                             jax_oracle)
from torch_cp_oracle import pools  # noqa: F401  (the fixture)

torch.set_num_threads(1)

CF = 4.0            # E / k at the tiny configs: no token drops
FIELDS = {"qwen2_moe": {"capacity_factor": CF, "router_aux_loss_coef": 0.0},
          "deepseek": {"router_aux_loss_coef": 0.0}}


def ep_run(pools, n, family, hybrid, steps=3, opt_name="adamw", lr=LR,
           clip=None, shape=(2, 32), **kw):
    fields = FIELDS[family]
    batches = batches_of(steps, shape)
    oracle = jax_oracle(family, fields, batches, opt_name, lr, clip, cf=CF)
    got = pools(n).run("torch_ep_cases:ep_train", family, fields, oracle[0],
                       batches, hybrid, opt_name, lr, WD, clip, CF,
                       kw.get("save"), kw.get("load"))
    return got, oracle


def _check_banks(got, family, ep):
    """Each rank holds E/ep experts of every bank, and AdamW's moments of
    a bank are of the rank's block."""
    E = 8
    for res in got:
        assert res["banks"], family
        for name, (shape, slots) in res["banks"].items():
            assert shape[0] == E // ep, (name, shape)
            assert slots and all(s == shape for s in slots.values()), \
                (name, slots)


# ---- ep 2 ----------------------------------------------------------------------

@pytest.mark.parametrize("family", ["qwen2_moe", "deepseek"])
def test_the_moe_models_at_ep2_match_the_jax_run(pools, family):
    """Three AdamW steps at ep 2: the losses (the same on both ranks),
    the first gradients gathered over the group and the weights after
    the steps against the JAX run; the replicated parameters' gradients
    are the same bits on both ranks (nothing reduces them over
    ``expert``); each rank holds E/2 experts and their optimizer
    state."""
    got, (_, losses, grads0, _, after) = ep_run(
        pools, 2, family, {"ep_degree": 2, "dp_degree": 1})
    for res in got:
        check_losses(res["losses"], losses)
    assert got[0]["losses"] == got[1]["losses"]
    for key, g in got[0]["grads0"].items():
        np.testing.assert_array_equal(got[1]["grads0"][key], g,
                                      err_msg=key)
    check_arrays(got[0]["grads0"], grads0, rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)
    _check_banks(got, family, 2)


@pytest.mark.parametrize("family", ["qwen2_moe", "deepseek"])
def test_sgd_shows_no_mis_scaled_expert_gradient(pools, family):
    """Plain SGD at lr 0.1 (AdamW's update hides a uniform factor) at ep
    2: the router's gradient summed over the group, the replicated
    weights' not reduced, each bank block's whole; the losses, first
    gradients and weights after the step against the JAX run."""
    got, (_, losses, grads0, _, after) = ep_run(
        pools, 2, family, {"ep_degree": 2, "dp_degree": 1}, steps=2,
        opt_name="sgd", lr=0.1)
    for res in got:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    check_arrays(got[0]["grads0"], grads0, rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_the_clip_at_ep2_is_the_unpartitioned_clip(pools):
    """``ClipGradByGlobalNorm(0.05)`` (it clips every step) at ep 2: each
    bank's squares summed over the expert group, every replicated
    parameter once; the global norm each step, the losses and the
    weights equal the JAX clip's on one device."""
    got, (_, losses, _, norms, after) = ep_run(
        pools, 2, "qwen2_moe", {"ep_degree": 2, "dp_degree": 1}, clip=0.05)
    for res in got:
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-4)
        check_losses(res["losses"], losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)


def test_an_ep2_checkpoint_resumes_at_ep1_and_back(pools, tmp_path):
    """The ranks at ep 2 save (``hapi.Model.save_checkpoint``) after two
    steps, each writing its block of every bank; the unpartitioned model
    loads it (its banks whole, equal to the ranks' gathered weights
    then) and takes the third step, equal to the ranks' third. Then the
    unpartitioned model's checkpoint after two steps resumes at ep 2,
    each rank reading its block, for the third."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import Qwen2MoeConfig, Qwen2MoeForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    fields = FIELDS["qwen2_moe"]
    batches = batches_of()
    before, losses, _, _, _ = jax_oracle("qwen2_moe", fields, batches,
                                         cf=CF)
    path = str(tmp_path / "ep2")
    hybrid = {"ep_degree": 2, "dp_degree": 1}
    got = pools(2).run("torch_ep_cases:ep_train", "qwen2_moe", fields,
                       before, batches, hybrid, "adamw", LR, WD, None, CF,
                       path, None)
    assert dckpt.validate_checkpoint(path)["world_size"] == 2
    cfg = dataclasses.replace(Qwen2MoeConfig.tiny(), **fields)
    model = Qwen2MoeForCausalLM(cfg, device="cpu", seed=11)
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
    loss.backward()
    opt.step()
    check_arrays(convert.to_numpy_state_dict(model), got[0]["weights"],
                 rtol=1e-5, atol=1e-6)
    # the reverse: ep 1 saves, ep 2 resumes
    model = Qwen2MoeForCausalLM(cfg, device="cpu", seed=3)
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
    path1 = str(tmp_path / "ep1")
    m.save_checkpoint(path1, epoch=0)
    t = torch.from_numpy(batches[2])
    _, want = model(t, labels=t)
    res = pools(2).run("torch_ep_cases:ep_train", "qwen2_moe", fields,
                       before, batches[2:], hybrid, "adamw", LR, WD, None,
                       CF, None, path1)
    for r in res:
        assert r["step0"] == 2
        np.testing.assert_allclose(r["losses"][0], want.item(), rtol=1e-5)
    _check_banks(res, "qwen2_moe", 2)


def test_fit_resumes_under_ep2_bit_for_bit(pools, tmp_path):
    """``hapi.Model.fit`` under ep 2: one epoch saved (``save_dir``) and
    resumed by a model from another seed (``resume=True``) gives the
    uninterrupted two-epoch run's second epoch to the bit, on both
    ranks."""
    before, _, _, _, _ = jax_oracle("qwen2_moe", FIELDS["qwen2_moe"],
                                    batches_of(1), cf=CF)
    ids = batches_of(1, (4, 32), seed=60)[0]
    got = pools(2).run("torch_ep_cases:ep_fit", before, ids,
                       {"ep_degree": 2, "dp_degree": 1},
                       str(tmp_path / "fit"), CF)
    for res in got:
        assert res["first"] == res["whole"][:1]
        assert res["epochs"] == [1] and res["step"] == 4
        assert res["resumed"] == res["whole"][1:]
    assert got[0]["whole"] == got[1]["whole"]


# ---- 4 ranks -----------------------------------------------------------------------

@pytest.mark.parametrize("family,hybrid", [
    ("qwen2_moe", {"ep_degree": 2, "mp_degree": 2, "dp_degree": 1}),
    ("deepseek", {"ep_degree": 2, "mp_degree": 2, "dp_degree": 1}),
    ("qwen2_moe", {"ep_degree": 2, "dp_degree": 2})],
    ids=["qwen2_moe ep2 mp2", "deepseek ep2 mp2", "qwen2_moe ep2 dp2"])
def test_ep2_with_mp2_and_with_dp2(pools, family, hybrid):
    """ep 2 x mp 2 (the attention, the shared experts, the embedding and
    the head split over ``model``, the banks over ``expert``) and ep 2 x
    dp 2 (each data replica on half the rows, every gradient averaged
    over ``data`` only) with the clip on: the losses (the data replicas'
    mean), the global norms and the weights against the JAX run; each
    rank holds E/2 experts and their optimizer state."""
    got, (_, losses, _, norms, after) = ep_run(
        pools, 4, family, hybrid, clip=1.0)
    by_rep = {}
    for res in got:
        by_rep.setdefault(res["rep"], res["losses"])
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-4)
    check_losses(np.mean([by_rep[r] for r in sorted(by_rep)], axis=0),
                 losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)
    _check_banks(got, family, 2)
