"""Context parallelism of the port in Qwen2 and the tiny Qwen2-MoE at
sep 2, over 2 gloo ranks on the CPU, against the JAX single-device
eager model on the same weights (``torch_cp_oracle``), each rank on its
slice of the sequence.

Tolerances: f32 losses ``rtol=1e-5`` at the first step and ``1e-4``
after AdamW steps (the pipeline tests'), final weights
``rtol=atol=1e-4``.
"""

from __future__ import annotations

import pytest
import torch

from torch_cp_oracle import check_arrays, check_losses, sep_run
from torch_cp_oracle import pools  # noqa: F401  (the fixture)

torch.set_num_threads(1)


# ---- Qwen2 and the MoE at degree 2 ------------------------------------------

@pytest.mark.parametrize("family,fields", [
    ("qwen2", {"sep_parallel": "ring"}),
    ("qwen2", {"sep_parallel": "ulysses", "scan_layers": False}),
    ("qwen2_moe", {"sep_parallel": "allgather", "moe_dropless": True,
                   "router_aux_loss_coef": 0.0})])
def test_qwen2_and_the_moe_at_sep2(pools, family, fields):
    """Tiny Qwen2 (QKV bias, the fused post-attention norm) and the tiny
    Qwen2-MoE (the MoE block unchanged on each rank's tokens: dropless,
    the aux loss folded out, as over a pipeline microbatch) at sep 2:
    losses and weights against the JAX run."""
    got, (losses, _, _, after) = sep_run(
        pools, 2, family, fields, {"sep_degree": 2, "dp_degree": 1})
    for res in got:
        check_losses(res["losses"], losses)
    check_arrays(got[0]["weights"], after, rtol=1e-4, atol=1e-4)
