"""pp x ep of the port: the tiny ``Qwen2MoeForCausalLMPipe`` at pp 2 x ep
2 over 4 gloo ranks on the CPU under FThenB, 1F1B and ZB-H1, and under
interleaving (2 virtual stages), against the JAX single-device eager
``Qwen2MoeForCausalLM`` on the same weights (``torch_cp_oracle``; the
ranks run ``torch_pipe_cases.pipe_train``). Each stage rank's MoE layers
dispatch over that stage's expert group; the aux loss stays folded out
(``router_aux_loss_coef`` 0), as in every pipe; the capacity factor E/k
keeps every token of each microbatch.

Tolerances (the pipeline tests'): f32 losses ``rtol=1e-5`` at the first
step and ``1e-4`` after AdamW steps, the first gradients ``rtol=1e-4,
atol=1e-6``, final weights ``rtol=atol=1e-4``.
"""

from __future__ import annotations

import pytest
import torch

from paddle_tpu_torch.models.llama import pipe_key

from torch_cp_oracle import (LR, WD, batches_of, check_arrays, check_losses,
                             jax_oracle)
from torch_cp_oracle import pools  # noqa: F401  (the fixture)

torch.set_num_threads(1)

FIELDS = {"num_hidden_layers": 4, "capacity_factor": 4.0,
          "router_aux_loss_coef": 0.0}


@pytest.mark.parametrize("schedule,V", [("FThenB", None), ("1F1B", None),
                                        ("ZB-H1", None), ("interleaved", 2)])
def test_qwen2_moe_pipe_at_pp2_ep2_matches_the_jax_run(pools, schedule, V):
    """pp 2 x ep 2, 2 microbatches: three steps' losses (every rank), the
    first step's gradients and the final weights gathered over the
    stages and the expert groups, against the JAX run; each rank holds
    E/2 experts of its stage's banks and AdamW's moments of that block
    only."""
    batches = batches_of(3, shape=(4, 16))
    before, losses, grads0, _, after = jax_oracle("qwen2_moe", FIELDS,
                                                  batches)
    pipeline = {"schedule_mode": schedule, "accumulate_steps": 2}
    if V:
        pipeline["num_virtual_pipeline_stages"] = V
    got = pools(4).run("torch_pipe_cases:pipe_train", "qwen2_moe", FIELDS,
                       before, batches,
                       {"pp_degree": 2, "ep_degree": 2, "dp_degree": 1},
                       pipeline, LR, WD)
    L = FIELDS["num_hidden_layers"]

    def piped(arrays):
        return {pipe_key(L, "", k): v for k, v in arrays.items()}

    for res in got:
        check_losses(res["losses"], losses)
        assert res["banks"]
        for name, (shape, slots) in res["banks"].items():
            assert shape[0] == 4, (name, shape)
            assert slots and all(s == shape for s in slots.values())
    check_arrays(got[0]["grads0"], piped(grads0), rtol=1e-4, atol=1e-6)
    check_arrays(got[0]["weights"], piped(after), rtol=1e-4, atol=1e-4)
